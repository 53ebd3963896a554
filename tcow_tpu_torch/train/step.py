'''
The training and evaluation steps: the port of tcow_tpu/train/step.py (:39-275). One step
builds the per-query supervision on the device, runs the seeker on the folded (B*Q) batch,
computes the losses and metric sums, backpropagates (every attention backward through
FusedAttention: K4 on the card) and applies one optimizer update, skipped when the loss
is not finite.

Batch schema (numpy arrays or tensors; the step moves them to the model's device):
  rgb           (B, 3, T, H, W) float32  (or uint8 'rgb_u8', scaled by 1/255 on device)
  segm          (B, T, H, W)    int32    1-based visible instance IDs (or uint8 'segm_u8')
  div_segm      (B, M, T, H, W) uint8    amodal masks (or bit-packed 'div_segm_packed'
                                         (B, M, T, H, W//8), np.packbits big-endian order)
  query_inds    (B, Q)          int32
  query_time    ()              int32    shared query frame index
  occl_fracs    (B, M, T, 3)    float32
  occl_cont_dag (B, T, M, M, 3) float32
  frame_times   (B, T)          float32  optional: true source timestamps, read when
                                         seeker.rope_time_coords is set
'''

import dataclasses
from typing import Any, Dict, Optional

import torch

from tcow_tpu_torch import resolve_device
from tcow_tpu_torch.models.mask_tracker import MaskTracker, SeekerConfig
from tcow_tpu_torch.objectives import losses as losses_lib
from tcow_tpu_torch.objectives import metrics as metrics_lib
from tcow_tpu_torch.objectives import supervision
from tcow_tpu_torch.objectives.losses import LossConfig
from tcow_tpu_torch.train.optim import Optimizer, OptimizerSpec, global_norm
from tcow_tpu_torch.weights import params_from_jax


@dataclasses.dataclass(frozen=True)
class StepConfig:
    seeker: SeekerConfig  # set seeker.remat=True for training at full size
    loss: LossConfig
    num_queries: int = 3


@dataclasses.dataclass
class TrainState:
    '''What a JAX TrainState holds, as mutable torch objects: the model (its parameters),
    the optimizer (its state and count of applied updates), the generator that draws the
    drop-path masks, and the number of steps taken, skipped ones included.'''
    model: MaskTracker
    optimizer: Optimizer
    generator: torch.Generator
    step: int = 0


def init_train_state(seed: int, cfg: StepConfig, tx: OptimizerSpec,
                     params: Optional[Dict[str, Any]] = None, device='cuda') -> TrainState:
    '''A model on `device` initialised from `seed` (or from the JAX-layout tree `params`),
    its optimizer, and a drop-path generator; the two generators are split from `seed`.'''
    device = resolve_device(device)
    root = torch.Generator().manual_seed(seed)
    init_seed, drop_seed = torch.randint(0, 2 ** 62, (2,), generator=root).tolist()
    model = MaskTracker(cfg.seeker, device=device)
    if params is None:
        model.init_params_(torch.Generator().manual_seed(init_seed))
    else:
        model.load_state_dict(params_from_jax(params))
    return TrainState(model, tx.init(model.parameters()),
                      torch.Generator().manual_seed(drop_seed))


def unpack_batch(batch, device) -> Dict[str, torch.Tensor]:
    '''Moves the batch to `device` and expands the compact transfer forms there:
    bit-packed amodal masks, uint8 rgb and uint8 segm (step.py:88-113).'''
    deferred = {'jitter_factors', 'jitter_order', 'blur_gray'} & set(batch)
    if deferred:
        raise NotImplementedError(f'on-device colour augmentation ({sorted(deferred)}) is '
                                  'not ported yet')
    out = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    if 'div_segm_packed' in out:
        packed = out.pop('div_segm_packed')                     # (B, M, T, H, W//8) uint8
        shifts = 7 - torch.arange(8, dtype=torch.uint8, device=device)   # big-endian bits
        bits = (packed[..., None] >> shifts) & 1
        out['div_segm'] = bits.reshape(*packed.shape[:-1], packed.shape[-1] * 8)
    if 'rgb_u8' in out:
        out['rgb'] = out.pop('rgb_u8').float() / 255.0
    if 'segm_u8' in out:
        out['segm'] = out.pop('segm_u8').to(torch.int32)
    return out


def build_supervision(cfg: StepConfig, batch) -> Dict[str, torch.Tensor]:
    return supervision.fill_query_target_batch(
        batch['segm'], batch['div_segm'], batch['query_inds'], batch['query_time'],
        batch['occl_fracs'], batch['occl_cont_dag'],
        front_occl_thres=cfg.loss.front_occl_thres,
        outer_cont_thres=cfg.loss.outer_cont_thres)


def _forward_queries(model: MaskTracker, cfg: StepConfig, batch, sup, train: bool,
                     generator: Optional[torch.Generator]):
    '''The seeker on all (example, query) pairs as one folded batch (step.py:63-85), every
    query of an example on its clock when rope_time_coords is set (:73-77). Returns
    output_mask (B, Q, C, T, H, W) and output_flags (B, Q, T, F) or None.'''
    B, Q = batch['query_inds'].shape
    rgb = batch['rgb']
    _, _, T, H, W = rgb.shape
    rgb_q = rgb[:, None].expand((B, Q) + rgb.shape[1:]).reshape(B * Q, 3, T, H, W)
    qmask = sup['seeker_query_mask'].reshape(B * Q, 1, T, H, W)
    frame_times = None
    if cfg.seeker.rope_time_coords and 'frame_times' in batch:
        frame_times = batch['frame_times'][:, None].expand(B, Q, T).reshape(B * Q, T)
    out_mask, out_flags = model(rgb_q, qmask, train=train, generator=generator,
                                frame_times=frame_times)
    out_mask = out_mask.reshape(B, Q, cfg.seeker.output_channels, T, H, W)
    if out_flags is not None:
        out_flags = out_flags.reshape(B, Q, T, -1)
    return out_mask, out_flags


def _outputs_and_losses(model, cfg: StepConfig, batch, generator, progress, train: bool):
    device = next(model.parameters()).device
    batch = unpack_batch(batch, device)
    sup = build_supervision(cfg, batch)
    out_mask, out_flags = _forward_queries(model, cfg, batch, sup, train, generator)
    # (B, Q, T, 3) occlusion fractions of the selected queries.
    B = batch['query_inds'].shape[0]
    sel_occl_fracs = batch['occl_fracs'][torch.arange(B, device=device)[:, None],
                                         batch['query_inds'].long()]
    loss_retval = losses_lib.compute_losses(
        cfg.loss, out_mask, sup['target_mask'], sel_occl_fracs, sup['snitch_occl_by_ptr'],
        batch['query_time'], progress)
    msums = metrics_lib.mask_track_metric_sums(out_mask.detach(), sup['target_mask'])
    return loss_retval, msums, out_mask, out_flags, sup


def loss_and_aux(model, cfg: StepConfig, batch, generator, progress, train: bool):
    '''(total loss, aux of losses and metric sums) of one batch, differentiable in the
    model's parameters; `generator` draws the drop-path masks when training.'''
    loss_retval, msums, *_ = _outputs_and_losses(model, cfg, batch, generator, progress,
                                                 train)
    aux = {k: loss_retval[k] for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker')}
    aux['metric_sums'] = msums
    return loss_retval['total_seeker'], aux


def make_train_step(cfg: StepConfig, grad_accum: int = 1):
    '''Returns train_step(state, batch, progress) -> (state, aux). The state is updated in
    place. aux holds the losses and metric sums of step.py:137-143 (0-d tensors, the
    losses detached), skipped_nonfinite (1.0 when the update was skipped) and grad_norm,
    the global norm of the gradients before clipping. One host read per step: whether the
    loss is finite.'''
    if grad_accum != 1:
        raise NotImplementedError('grad_accum > 1 is not ported yet')

    def train_step(state: TrainState, batch, progress):
        model = state.model
        model.zero_grad(set_to_none=True)
        loss, aux = loss_and_aux(model, cfg, batch, state.generator, progress, True)
        loss.backward()
        grad_norm = global_norm(p.grad for p in model.parameters() if p.grad is not None)
        ok = bool(torch.isfinite(loss))
        if ok:
            state.optimizer.step(grad_norm)
        state.step += 1
        aux = {k: (v.detach() if torch.is_tensor(v) else v) for k, v in aux.items()}
        aux['skipped_nonfinite'] = torch.tensor(0.0 if ok else 1.0)
        aux['grad_norm'] = grad_norm.detach()
        return state, aux

    return train_step


def make_eval_step(cfg: StepConfig, return_outputs: bool = False):
    '''Returns eval_step(model, batch, progress) -> dict of losses and metric sums, with no
    gradients and no drop-path. With return_outputs the dict also carries output_mask,
    output_flags, target_mask, seeker_query_mask and snitch_weights.'''

    def eval_step(model, batch, progress):
        with torch.no_grad():
            loss_retval, msums, out_mask, out_flags, sup = _outputs_and_losses(
                model, cfg, batch, None, progress, False)
        out = {k: loss_retval[k] for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker')}
        out['metric_sums'] = msums
        if return_outputs:
            out.update(output_mask=out_mask, output_flags=out_flags,
                       target_mask=sup['target_mask'],
                       seeker_query_mask=sup['seeker_query_mask'],
                       snitch_weights=loss_retval.get('snitch_weights'))
        return out

    return eval_step
