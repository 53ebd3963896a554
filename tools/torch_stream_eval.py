#!/usr/bin/env python3
'''
Far-horizon streaming quality evaluation with the PyTorch port: the counterpart of
tools/stream_eval.py, with its flags, horizon buckets, JSON layout and latency keys.

Scores windowed streaming inference (tcow_tpu_torch/models/streaming.py) against the
offline clip forward on LONG Kubric-format videos (e.g. 160 frames, >5x the trained
horizon) with ground-truth amodal masks, per inference mode and per horizon bucket (within
the trained horizon / 1-4x past it / beyond), for the six reference metric families. The
query is the scene's instance 0 at frame 0. The offline forward (`--joint 1`, named
'joint' as in the JAX tool) is the divided model over the whole video, its time embedding
nearest-resized to T.

Usage:
  python tools/torch_stream_eval.py --resume rich256 --checkpoint_root checkpoints/ \
      --data_path kubrich_long8 --num_frames 160 --windows 0,30,120 [--joint 1] \
      [--device cpu --compute_dtype float32]

Prints one aggregate table (weighted means = global sum / count, the reference's primary
aggregation) and writes <out> (JSON) with per-variant, per-bucket numbers, and the median
per-frame latency of each window (host clock, the frame's mask copied to the host).
'''

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tcow_tpu_torch import config as config_lib  # noqa: E402
from tcow_tpu_torch import resolve_device  # noqa: E402
from tcow_tpu_torch.data import data_utils  # noqa: E402
from tcow_tpu_torch.data.kubric import KubricQueryDataset  # noqa: E402
from tcow_tpu_torch.evaluation import inference as inference_lib  # noqa: E402
from tcow_tpu_torch.models import streaming  # noqa: E402
from tcow_tpu_torch.objectives import metrics as metrics_lib  # noqa: E402
from tcow_tpu_torch.objectives import supervision  # noqa: E402

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
MAX_OBJECTS = 12
TABLE_KEYS = ('mean_snitch_iou', 'mean_snitch_during_vis_iou', 'mean_snitch_during_occl_iou',
              'mean_snitch_during_cont_iou', 'mean_occl_mask_iou', 'mean_cont_mask_iou')


def variant_name(window: int) -> str:
    return f'stream_w{window or "inf"}'


def load_model(resume, checkpoint_root, device, compute_dtype, logger=None):
    '''(model in eval mode on `device`, cfg) from a checkpoint file or experiment name.'''
    if not os.path.isfile(resume):
        resume = config_lib.resolve_resume_path(checkpoint_root, resume)
    params, cfg, *_ = inference_lib.load_networks(resume, logger, compute_dtype=compute_dtype,
                                                  device=device)
    if cfg.causal_attention != 1:
        raise ValueError('streaming requires a causal_attention=1 checkpoint')
    return inference_lib.InferenceEngine(params, cfg, device=device).model, cfg


def make_dataset(data_path, cfg, num_frames, logger=None):
    '''The test split as the JAX tool reads it: no augmentation, no delay, one query.'''
    return KubricQueryDataset(data_path, logger, 'test', num_frames=num_frames, max_delay=0,
                              frame_height=cfg.frame_height, frame_width=cfg.frame_width,
                              num_queries=1, max_objects=MAX_OBJECTS, augs_2d=False,
                              device_color_jitter=False)


def scene_inputs(item, device):
    '''One dataset item -> (rgb (3, T, H, W) f32 numpy, query mask (1, T, H, W) f32 on
    `device`, target (1, 1, 3, T, H, W) f32 on `device`): the supervision of instance 0
    queried at frame 0.'''
    rgb = np.asarray(item['rgb'])
    rgb = rgb.astype(np.float32) / 255.0 if rgb.dtype == np.uint8 else rgb.astype(np.float32)
    div_pad, _ = data_utils.pad_div(item['div_segm'], [0], MAX_OBJECTS)
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)[None]
    sup = supervision.fill_query_target_batch(
        t(item['segm']), t(div_pad), torch.zeros((1, 1), dtype=torch.int64, device=device), 0,
        t(item['occl_fracs']), t(item['occl_cont_dag']))
    return rgb, sup['seeker_query_mask'][0, 0], sup['target_mask']


@torch.inference_mode()
def stream_masks(model, rgb, qmask, window, num_frames, device):
    '''One stream_step per frame (window 0 = the unbounded cache of num_frames slots) ->
    (mask logits (1, 1, C, T, H, W) f32 on `device`, per-frame latency in s).'''
    state = streaming.init_stream(model, 1, window=window or None,
                                  max_frames=None if window else num_frames)
    frames = torch.from_numpy(np.ascontiguousarray(rgb.transpose(1, 0, 2, 3)))
    masks, lat = [], []
    for t in range(rgb.shape[1]):
        f = frames[t:t + 1].to(device)
        q = qmask[:, t][None]
        t0 = time.perf_counter()
        state, m, _ = streaming.stream_step(model, state, f, q, window=window or None)
        m = m[0].float()
        m.cpu()                      # the frame's mask reaches the host, as in JAX
        lat.append(time.perf_counter() - t0)
        masks.append(m)
    return torch.stack(masks, dim=1)[None, None], lat


@torch.inference_mode()
def offline_masks(model, rgb, qmask, device):
    '''The divided model over the whole video at once (time embedding nearest-resized to
    T) -> mask logits (1, 1, C, T, H, W) f32.'''
    out, _ = model(torch.as_tensor(rgb, device=device)[None], qmask[None])
    return out[:, None].float()


def add_bucket_sums(agg, name, out, target, buckets):
    '''Adds each horizon bucket's metric sums of one variant's output to agg.'''
    for b0, b1 in buckets:
        s = metrics_lib.mask_track_metric_sums(out[:, :, :, b0:b1], target[:, :, :, b0:b1])
        dst = agg.setdefault(name, {}).setdefault(f'{b0}-{b1}', {})
        for k, v in s.items():
            dst[k] = dst.get(k, 0.0) + float(v)


def finalize(agg, lat):
    '''Per variant: every bucket's and the whole video's means and counts; the median
    latency of each window after its first frame.'''
    results = {}
    for name, per_bucket in agg.items():
        results[name] = {}
        total = {}
        for bucket, s in per_bucket.items():
            results[name][bucket] = metrics_lib.finalize_metric_sums(
                {k: np.float32(v) for k, v in s.items()})
            for k, v in s.items():
                total[k] = total.get(k, 0.0) + v
        results[name]['all'] = metrics_lib.finalize_metric_sums(
            {k: np.float32(v) for k, v in total.items()})
    for w, xs in lat.items():
        if len(xs) > 1:
            results[f'latency_ms_w{w or "inf"}'] = float(np.median(xs[1:]) * 1e3)
    return results


def evaluate(model, ds, windows, buckets, joint, n_scenes, device, logger=None):
    '''Every scene through each window's stream (and the offline forward) -> the results
    of `finalize`.'''
    agg = {}
    lat = {w: [] for w in windows}
    T = ds.num_frames_clip
    for idx in range(n_scenes):
        rgb, qmask, target = scene_inputs(ds[idx], device)
        occ = int((target[0, 0, 1] > 0.5).any(dim=-1).any(dim=-1).sum())
        con = int((target[0, 0, 2] > 0.5).any(dim=-1).any(dim=-1).sum())
        if logger is not None:
            logger.info(f'scene {idx}: {occ} occluded / {con} contained frames of {T}')
        outputs = {}
        for w in windows:
            outputs[variant_name(w)], ms = stream_masks(model, rgb, qmask, w, T, device)
            lat[w].extend(ms)
        if joint:
            outputs['joint'] = offline_masks(model, rgb, qmask, device)
        for name, out in outputs.items():
            add_bucket_sums(agg, name, out, target, buckets)
    return finalize(agg, lat)


def log_table(logger, results):
    hdr = 'variant/bucket'.ljust(24) + ' '.join(k.replace('mean_', '')[:16].rjust(17)
                                                for k in TABLE_KEYS)
    logger.info(hdr)
    for name in sorted(k for k, v in results.items() if isinstance(v, dict)):
        for bucket, row in results[name].items():
            logger.info(f'{name}/{bucket}'.ljust(24) + ' '.join(
                (f'{row[k]:.3f}' if row.get(k, -1.0) >= 0 else 'n/a').rjust(17)
                for k in TABLE_KEYS))


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--resume', required=True)
    p.add_argument('--checkpoint_root', default='checkpoints/')
    p.add_argument('--data_path', required=True)
    p.add_argument('--num_frames', type=int, default=160)
    p.add_argument('--windows', default='30,120',
                   help='comma-separated streaming window sizes; 0 = unbounded cache')
    p.add_argument('--joint', type=int, default=1,
                   help='also run the offline forward over the full video (time '
                        'embedding nearest-resized to T)')
    p.add_argument('--buckets', default='30,120',
                   help='horizon bucket boundaries (frames); metrics reported per bucket')
    p.add_argument('--max_scenes', type=int, default=0)
    p.add_argument('--out', default='stream_eval.json')
    p.add_argument('--device', default='cuda')
    p.add_argument('--compute_dtype', default='bfloat16', choices=sorted(DTYPES))
    a = p.parse_args(argv)

    from tcow_tpu_torch.utils.logvis import Logger
    logger = Logger(context='stream_eval')
    device = resolve_device(a.device)
    model, cfg = load_model(a.resume, a.checkpoint_root, device, DTYPES[a.compute_dtype],
                            logger)
    T = a.num_frames
    ds = make_dataset(a.data_path, cfg, T, logger)
    n_scenes = len(ds) if a.max_scenes <= 0 else min(a.max_scenes, len(ds))
    windows = [int(w) for w in a.windows.split(',') if w != '']
    edges = [0] + [int(b) for b in a.buckets.split(',') if b != ''] + [T]
    buckets = list(zip(edges[:-1], edges[1:]))
    results = evaluate(model, ds, windows, buckets, a.joint, n_scenes, device, logger)
    with open(a.out, 'w') as f:
        json.dump(results, f, indent=1)
    log_table(logger, results)
    logger.info(f'wrote {a.out}')


if __name__ == '__main__':
    main()
