'''
Batched inference: network loading from self-describing .npz checkpoints, the Kubric test
step, the plugin (usage-mode) forward and the streaming evaluation of a whole plugin video,
each with per-example losses and metrics. The port of tcow_tpu/evaluation/inference.py.
'''

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from tcow_tpu_torch import resolve_device
from tcow_tpu_torch.models import streaming
from tcow_tpu_torch.models.mask_tracker import MaskTracker, SeekerConfig, seeker_config_from_args
from tcow_tpu_torch.objectives import metrics as metrics_lib
from tcow_tpu_torch.objectives.losses import LossConfig
from tcow_tpu_torch.train import checkpoint as ckpt_lib
from tcow_tpu_torch.train import step as step_lib
from tcow_tpu_torch.weights import params_from_jax


def load_networks(checkpoint_path: str, logger=None, epoch: int = -1, compute_dtype=None,
                  device='cuda') -> Tuple[Dict, SeekerConfig, Dict, Dict, Dict, int]:
    '''(params, seeker_cfg, train_args, dset_args, seeker_args, epoch) from a .npz
    checkpoint file or experiment directory. params is the JAX-layout tree of numpy
    arrays. `device` is the one the networks will run on: without CUDA it raises unless
    the caller asks for the CPU. There is no kernel switch to turn on (the counterpart of
    :56-58): on CUDA every attention call launches the fused kernel.'''
    print_fn = logger.info if logger is not None else print
    resolve_device(device)
    if checkpoint_path.endswith('.pth'):
        raise NotImplementedError('.pth checkpoints are not ported yet; use .npz')
    checkpoint_path = ckpt_lib.resolve_checkpoint_path(checkpoint_path, epoch)
    print_fn('Loading weights from: ' + checkpoint_path)
    loaded = ckpt_lib.load_checkpoint(checkpoint_path)
    seeker_args = loaded['seeker_args']
    cfg = seeker_config_from_args(seeker_args)
    if compute_dtype is not None:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    epoch = int(loaded['epoch'])
    print_fn('=> Loaded epoch (1-based): ' + str(epoch + 1))
    return loaded['params'], cfg, loaded['train_args'], loaded['dset_args'], seeker_args, epoch


class InferenceEngine:
    '''The seeker on one device, answering batched Kubric test batches and plugin
    requests. loss_cfg and num_queries configure the Kubric test step (losses and query
    count); plugin requests use neither.'''

    def __init__(self, params, cfg: SeekerConfig, loss_cfg: Optional[LossConfig] = None,
                 num_queries: int = 1, device='cuda'):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.model = MaskTracker(cfg, device=self.device)
        self.model.load_state_dict(params_from_jax(params))
        self.model.eval()
        step_cfg = step_lib.StepConfig(seeker=cfg, loss=loss_cfg or LossConfig(),
                                       num_queries=num_queries)
        self._kubric_step = step_lib.make_eval_step(step_cfg, return_outputs=True,
                                                    per_example=True)

    def run_kubric(self, device_batch: Dict[str, Any], progress: float = 1.0,
                   valid: int = -1):
        '''One Kubric test batch of B clips (the loader's device batch), ONE batched
        forward -> a list of B per-clip (model_retval, loss_retval) in the JAX package's
        schema. Each clip's losses and metrics come from its own B = 1 slice of the
        outputs (make_eval_step(per_example=True)), so they are what a forward of that
        clip alone gives. `valid` truncates the list (a padded tail batch).'''
        with torch.inference_mode():
            aux = self._kubric_step(self.model, device_batch, progress)
            host = lambda t: None if t is None else t.float().cpu().numpy()
            aux = {k: ({m: host(v) for m, v in t.items()} if k == 'metric_sums' else host(t))
                   for k, t in aux.items()}
        if 'rgb' in device_batch:
            seeker_input = np.asarray(device_batch['rgb'])
        else:
            seeker_input = np.asarray(device_batch['rgb_u8']).astype(np.float32) / 255.0
        B = seeker_input.shape[0]
        n = B if valid < 0 else min(valid, B)
        results = []
        for b in range(n):
            sl = slice(b, b + 1)
            model_retval = {
                'seeker_input': seeker_input[sl],
                'output_mask': aux['output_mask'][sl],
                'output_flags': (None if aux['output_flags'] is None
                                 else aux['output_flags'][sl]),
                'target_mask': aux['target_mask'][sl],
                'seeker_query_mask': aux['seeker_query_mask'][sl],
                'snitch_weights': (None if aux['snitch_weights'] is None
                                   else aux['snitch_weights'][sl]),
                'sel_query_inds': np.asarray(device_batch['query_inds'])[sl],
            }
            loss_retval = {
                'track': float(aux['track'][b]),
                'occl_mask': float(aux['occl_mask'][b]),
                'cont_mask': float(aux['cont_mask'][b]),
                'total_seeker': float(aux['total_seeker'][b]),
                'metrics': metrics_lib.finalize_metric_sums(
                    {k: v[b] for k, v in aux['metric_sums'].items()}),
            }
            results.append((model_retval, loss_retval))
        return results

    def run_plugin_stream(self, ex: Dict[str, Any], window: int, pinned_frames: int = 1):
        '''Windowed streaming over a whole video of any length (inference.py:128-182 of
        the JAX package): one stream_step per frame, scored at the annotated frames. `ex`
        is PluginVideoDataset.get_streaming_example(). The frames go to the card from
        pinned memory, and the masks of the annotated frames stay there until the video
        ends, so no frame waits for the device. Returns (model_retval, loss_retval) in the
        plugin schema, restricted to the annotated frames.'''
        if self.cfg.causal_attention != 1:
            raise ValueError('streaming evaluation requires a causal_attention=1 '
                             f'checkpoint (got {self.cfg.causal_attention})')
        ann = [int(t) for t in ex['annotated_inds']]
        if not ann:
            raise ValueError('streaming evaluation needs at least one annotated target '
                             'frame (found none after the query frame)')
        rgb, query, target = ex['rgb'], ex['query'], ex['target']
        # (N, C, H, W) on the host, pinned once on the GPU: each frame is a contiguous
        # slice that copies without a staging buffer.
        frames = torch.from_numpy(np.ascontiguousarray(rgb.transpose(1, 0, 2, 3)))
        queries = torch.from_numpy(np.ascontiguousarray(query.transpose(1, 0, 2, 3)))
        if self.device.type == 'cuda':
            frames, queries = frames.pin_memory(), queries.pin_memory()
        ann_set = set(ann)
        outs, flags = [], []
        with torch.inference_mode():
            state = streaming.init_stream(self.model, 1, window=window,
                                          pinned_frames=pinned_frames)
            for t in range(frames.shape[0]):
                f = frames[t:t + 1].to(self.device, non_blocking=True)
                q = queries[t:t + 1].to(self.device, non_blocking=True)
                state, m, fl = streaming.stream_step(self.model, state, f, q, window=window,
                                                     pinned_frames=pinned_frames)
                if t in ann_set:
                    outs.append(m[0])
                    flags.append(None if fl is None else fl[0])
            out_dev = torch.stack(outs, dim=1)[None]                     # (1, C, F, H, W)
            tgt = np.stack([target[:, t] for t in ann], axis=1)[None]    # (1, 3, F, H, W)
            sums = metrics_lib.mask_track_metric_sums(
                out_dev[:, None], torch.as_tensor(tgt, device=self.device)[:, None])
            sums = {k: v.cpu().numpy() for k, v in sums.items()}
            out_mask = out_dev.cpu().numpy()
            out_flags = None if flags[0] is None else torch.stack(flags)[None].cpu().numpy()
        model_retval = {
            'seeker_input': np.stack([rgb[:, t] for t in ann], axis=1)[None],
            'output_mask': out_mask,
            'output_flags': out_flags,
            'target_mask': tgt,
            'seeker_query_mask': np.stack([query[:, t] for t in ann], axis=1)[None],
            'annotated_inds': np.asarray(ann, np.int32),
        }
        loss_retval = {'metrics': metrics_lib.finalize_metric_sums(sums)}
        return model_retval, loss_retval

    def run_plugin(self, rgb: np.ndarray, query: np.ndarray, target: np.ndarray,
                   frame_times: Optional[np.ndarray] = None):
        '''Batched usage modes (B, 3|1|3, T, H, W) -> per-example (model_retval,
        loss_retval) lists in the schema of tcow_tpu InferenceEngine.run_plugin.
        frame_times (B, T): each clip's true source-frame indices, read only by a
        time-calibrated rope checkpoint (cfg.rope_time_coords, :184-196).'''
        ft = None
        if self.cfg.rope_time_coords and frame_times is not None:
            ft = torch.as_tensor(np.asarray(frame_times, np.float32), device=self.device)
        with torch.inference_mode():
            out_mask, out_flags = self.model(torch.as_tensor(rgb, device=self.device),
                                             torch.as_tensor(query, device=self.device),
                                             frame_times=ft)
            tgt = torch.as_tensor(target, device=self.device)
            per_ex = [metrics_lib.mask_track_metric_sums(out_mask[b][None, None],
                                                         tgt[b][None, None])
                      for b in range(rgb.shape[0])]
            keys = list(per_ex[0])
            sums = torch.stack([torch.stack([d[k] for k in keys]) for d in per_ex]).cpu().numpy()
            out_mask = out_mask.cpu().numpy()
            out_flags = out_flags.cpu().numpy() if out_flags is not None else None
        results = []
        for b in range(rgb.shape[0]):
            model_retval = {
                'seeker_input': rgb[b:b + 1],
                'output_mask': out_mask[b:b + 1],
                'output_flags': None if out_flags is None else out_flags[b:b + 1],
                'target_mask': target[b:b + 1],
                'seeker_query_mask': query[b:b + 1],
            }
            loss_retval = {'metrics': metrics_lib.finalize_metric_sums(
                dict(zip(keys, sums[b])))}
            results.append((model_retval, loss_retval))
        return results
