'''
The training and evaluation steps: the port of tcow_tpu/train/step.py (:39-275). One step
builds the per-query supervision on the device, runs the seeker on the folded (B*Q) batch,
computes the losses and metric sums, backpropagates (every attention backward through
FusedAttention: K4 on the card) and applies one optimizer update, skipped when the loss
is not finite.

Under data parallelism (a DataMesh from parallel/mesh.py, `mesh=`) each rank runs the step
on its rows of the global batch (mesh.shard_batch): the losses and metric sums reduce over
the group, each rank draws the global batch's drop-path masks and keeps its rows, the
gradients are summed over the ranks after the backward, and the clip and the non-finite
skip follow from the global loss and norm, so every rank keeps the same replica.

Under tensor parallelism (a mesh with n_model > 1) the model ranks of one data row hold
the same rows and draw the same drop-path masks; the model is built with the mesh
(init_train_state shards the full model's parameters), its blocks make the model-axis
sums inside the backward, so after it only the data group's sum is left, and the
gradient norm is the logical tensors' (optim.Optimizer.grad_norm).

Under sequence parallelism (a mesh with n_seq > 1) the seq ranks of one data row hold the
same rows and the whole model, and the blocks split the tokens (parallel/sequence.py).
What every seq rank computes alike (the embedding, the heads, the losses) must enter the
gradient sum once: the loss's backward is seeded with 1 on seq rank 0 and 0 on the others
(backward_loss), every replicated tensor then carries a partial cotangent, and the
gradients are summed over the (data x seq) ranks (mesh.all_reduce_grads).

Under pipeline parallelism (a mesh with n_pipe > 1) the stages of one data row hold the
same rows and their own blocks (models/timesformer.py), and a step is a GPipe flush per
accumulation microbatch (_pipeline_pass, parallel/pipeline.py): the first stage embeds the
whole batch, its rows go through the stages in M microbatches, the last stage gathers the
M outputs and runs the norm, the heads, the losses and the metric sums on the whole batch
(the global batch's, over the data group of the last stage's ranks), then its backward,
then every stage's microbatch backward in a fixed order. Every rank draws the whole batch's
drop-path masks and keeps its blocks' rows of each microbatch, so the step equals the
one-process step. The losses and metric sums are broadcast from the last stage over the
pipe group, so every rank logs, clips and skips alike; a block parameter's gradient is
summed over its stage's data rows, any other over every stage (mesh.all_reduce_grads).
Beside sequence parallelism each (data, seq, model) line is such a pipe: the first stage
splits the embedded tokens (TimeSformer.seq_split), each hop carries one seq rank's chunk
of a microbatch to the same seq rank of the next stage, the stages' blocks make the seq
collectives, the last stage gathers the tokens (seq_gather) and seeds the replicated loss
on seq rank 0 alone (backward_loss), and the gradients are summed over the (data x seq)
ranks of a stage, or over every stage.

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
  jitter_factors (B, 5) float32, jitter_order (B, 4) int32, blur_gray (B, 3) float32:
                optional on-device colour augmentation (ops/device_augs.py)
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
from tcow_tpu_torch.ops import device_augs
from tcow_tpu_torch.parallel import mesh as mesh_lib
from tcow_tpu_torch.parallel import pipeline
from tcow_tpu_torch.train.optim import Optimizer, OptimizerSpec
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
                     params: Optional[Dict[str, Any]] = None, device='cuda',
                     mesh=None) -> TrainState:
    '''A model on `device` initialised from `seed` (or from the JAX-layout tree `params`),
    its optimizer, and a drop-path generator; the two generators are split from `seed`.
    Under a tensor-parallel mesh the full model is initialised on the CPU (the init draws
    there in any case) and the model on `device` gets this rank's shards of it before the
    optimizer sees its parameters; so under a pipeline-parallel one, whose model gets this
    stage's blocks; under a sequence-parallel one every rank holds the whole model, built
    with the mesh.'''
    device = resolve_device(device)
    root = torch.Generator().manual_seed(seed)
    init_seed, drop_seed = torch.randint(0, 2 ** 62, (2,), generator=root).tolist()
    part = (mesh if mesh_lib.tp_mesh(mesh) is not None or mesh_lib.pp_mesh(mesh) is not None
            else None)
    model = (MaskTracker(cfg.seeker, device='cpu') if part is not None
             else MaskTracker(cfg.seeker, device=device, mesh=mesh))
    if params is None:
        model.init_params_(torch.Generator().manual_seed(init_seed))
    else:
        model.load_state_dict(params_from_jax(params))
    if part is not None:
        full = model.state_dict()
        model = MaskTracker(cfg.seeker, device=device, mesh=mesh)
        model.load_state_dict(mesh_lib.shard_params(full, part))
    return TrainState(model, tx.init(model.named_parameters(), mesh=part),
                      torch.Generator().manual_seed(drop_seed))


def unpack_batch(batch, device) -> Dict[str, torch.Tensor]:
    '''Moves the batch to `device` and expands the compact transfer forms there:
    bit-packed amodal masks, uint8 rgb and uint8 segm (step.py:88-100); then applies the
    on-device colour augmentations its keys ask for, jitter first, blur and grayscale
    second (:101-112).'''
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
    if 'jitter_factors' in out:
        out['rgb'] = device_augs.apply_color_jitter(out['rgb'], out.pop('jitter_factors'),
                                                    out.pop('jitter_order'))
    if 'blur_gray' in out:
        out['rgb'] = device_augs.apply_blur_gray(out['rgb'], out.pop('blur_gray'))
    return out


def build_supervision(cfg: StepConfig, batch) -> Dict[str, torch.Tensor]:
    return supervision.fill_query_target_batch(
        batch['segm'], batch['div_segm'], batch['query_inds'], batch['query_time'],
        batch['occl_fracs'], batch['occl_cont_dag'],
        front_occl_thres=cfg.loss.front_occl_thres,
        outer_cont_thres=cfg.loss.outer_cont_thres)


def _fold_queries(cfg: StepConfig, batch, sup):
    '''The seeker's inputs for all (example, query) pairs as one folded batch
    (step.py:63-85): rgb (B Q, 3, T, H, W), the query masks (B Q, 1, T, H, W), and every
    query of an example on its clock when rope_time_coords is set (:73-77), else None.'''
    B, Q = batch['query_inds'].shape
    rgb = batch['rgb']
    _, _, T, H, W = rgb.shape
    rgb_q = rgb[:, None].expand((B, Q) + rgb.shape[1:]).reshape(B * Q, 3, T, H, W)
    qmask = sup['seeker_query_mask'].reshape(B * Q, 1, T, H, W)
    frame_times = None
    if cfg.seeker.rope_time_coords and 'frame_times' in batch:
        frame_times = batch['frame_times'][:, None].expand(B, Q, T).reshape(B * Q, T)
    return rgb_q, qmask, frame_times


def _unfold(cfg: StepConfig, B: int, Q: int, out_mask, out_flags):
    '''The folded outputs as output_mask (B, Q, C, T, H, W) and output_flags (B, Q, T, F)
    or None.'''
    out_mask = out_mask.reshape((B, Q, cfg.seeker.output_channels) + out_mask.shape[2:])
    if out_flags is not None:
        out_flags = out_flags.reshape(B, Q, out_flags.shape[1], -1)
    return out_mask, out_flags


def _forward_queries(model: MaskTracker, cfg: StepConfig, batch, sup, train: bool,
                     generator: Optional[torch.Generator], mesh=None):
    '''The seeker on all (example, query) pairs as one folded batch (_fold_queries).
    Returns output_mask (B, Q, C, T, H, W) and output_flags (B, Q, T, F) or None. Under a
    mesh the B x Q folded rows are those of data coordinate d of the n_data rows' (every
    seq and model rank of the row draws the same), whose drop-path masks are drawn.'''
    B, Q = batch['query_inds'].shape
    rgb_q, qmask, frame_times = _fold_queries(cfg, batch, sup)
    rows = None if mesh is None else (mesh.data_rank * B * Q, mesh.n_data * B * Q)
    out_mask, out_flags = model(rgb_q, qmask, train=train, generator=generator,
                                frame_times=frame_times, drop_path_rows=rows)
    return _unfold(cfg, B, Q, out_mask, out_flags)


def _losses(cfg: StepConfig, batch, sup, out_mask, progress, per_example: bool, group):
    '''(losses, metric sums) of the batch's outputs; with per_example those of each
    example on its own (B = 1 slices of the batched outputs, as step.py:262-274 vmaps them)
    stacked with a leading B axis, and the snitch weights without the slice's axis of 1.'''
    device = out_mask.device
    # (B, Q, T, 3) occlusion fractions of the selected queries.
    B = batch['query_inds'].shape[0]
    sel_occl_fracs = batch['occl_fracs'][torch.arange(B, device=device)[:, None],
                                         batch['query_inds'].long()]
    rows = [slice(b, b + 1) for b in range(B)] if per_example else [slice(None)]
    per = [(losses_lib.compute_losses(
        cfg.loss, out_mask[sl], sup['target_mask'][sl], sel_occl_fracs[sl],
        sup['snitch_occl_by_ptr'][sl], batch['query_time'], progress, group),
        metrics_lib.mask_track_metric_sums(out_mask[sl].detach(), sup['target_mask'][sl],
                                           group))
        for sl in rows]
    if not per_example:
        return per[0]
    loss_retval = {k: torch.stack([lr[k] for lr, _ in per]) for k in per[0][0]}
    if 'snitch_weights' in loss_retval:
        loss_retval['snitch_weights'] = loss_retval['snitch_weights'][:, 0]
    msums = {k: torch.stack([ms[k] for _, ms in per]) for k in per[0][1]}
    return loss_retval, msums


def _outputs_and_losses(model, cfg: StepConfig, batch, generator, progress, train: bool,
                        per_example: bool = False, mesh=None):
    '''(losses, metric sums, output_mask, output_flags, supervision) of one batch (with
    per_example, _losses'). Under a mesh the batch is this rank's rows and the losses and
    metric sums are the global batch's. Not under a pipeline-parallel mesh: its stages run
    _pipeline_pass.'''
    if per_example and mesh is not None:
        raise ValueError('per-example losses are per clip: run them without a mesh')
    group = None if mesh is None else mesh.group
    device = next(model.parameters()).device
    batch = unpack_batch(batch, device)
    sup = build_supervision(cfg, batch)
    out_mask, out_flags = _forward_queries(model, cfg, batch, sup, train, generator, mesh)
    loss_retval, msums = _losses(cfg, batch, sup, out_mask, progress, per_example, group)
    return loss_retval, msums, out_mask, out_flags, sup


def _pipeline_pass(model, cfg: StepConfig, batch, generator, progress, train: bool, mesh,
                   backward: bool, group=None, n_micro: Optional[int] = None):
    '''One GPipe flush of this rank's stage over `batch` (module docstring): the first
    stage embeds the folded batch, every stage runs its blocks on each of the microbatches
    (n_micro, or the seeker's pp_microbatches resolved on the global batch's rows), the
    last stage runs the norm, the heads and the losses over `group` on the whole batch;
    with `backward` then the backward of the loss, the microbatches', and the first
    stage's of the embedding (parameter gradients in .grad, not yet summed over ranks).
    Returns what _outputs_and_losses returns on the last stage, None on the others. Beside
    sequence parallelism the stages' microbatches are of this rank's part of the tokens
    (TimeSformer.seq_split: its patches, or its chunk of the padded clips).'''
    bb = model.backbone
    device = next(model.parameters()).device
    batch = unpack_batch(batch, device)
    sup = build_supervision(cfg, batch)
    B, Q = batch['query_inds'].shape
    rgb_q, qmask, frame_times = _fold_queries(cfg, batch, sup)
    R, _, T, H, W = rgb_q.shape
    p, D = bb.cfg.patch_size, bb.cfg.embed_dim
    grid = (H // p, W // p)
    N = grid[0] * grid[1]
    frame_times = bb.block_frame_times(frame_times)
    masks = bb.stage_masks(generator, train, R, N, T, device,
                           (mesh.data_rank * R, mesh.n_data * R))
    if n_micro is None:
        n_micro = pipeline.microbatch_count(cfg.seeker.pp_microbatches, mesh, R)
    rows, n_local = bb.local_shape(R, N)
    parts = pipeline.microbatches(rows, n_micro)
    first, last = mesh.pipe_rank == 0, mesh.pipe_rank == mesh.n_pipe - 1
    emb = bb.seq_split(*bb.embed(model.backbone_input(rgb_q, qmask))) if first else None

    def stage_fn(m, xs, cls):
        r0, r1 = parts[m]
        return bb.run_blocks(xs, cls, [None if k is None else k.rows(r0, r1) for k in masks],
                             None if frame_times is None else frame_times[r0:r1], N)

    inputs, outputs = pipeline.run_stages(
        stage_fn, parts, lambda m: (emb[0][slice(*parts[m])], emb[1][slice(*parts[m])]),
        lambda m: ((parts[m][1] - parts[m][0], n_local, T, D), (parts[m][1] - parts[m][0], D)),
        bb.cfg.compute_dtype, device, mesh, grad=backward)
    result, last_grads = None, None
    if last:
        xs = torch.cat([o[0].detach() for o in outputs])
        if backward:
            xs.requires_grad_()
        feats, _ = bb.finish(*bb.seq_gather(xs, torch.cat([o[1].detach() for o in outputs]),
                                            R, N), grid)
        out_mask, out_flags = _unfold(cfg, B, Q, *model.heads(feats))
        loss_retval, msums = _losses(cfg, batch, sup, out_mask, progress, False, group)
        result = (loss_retval, msums, out_mask, out_flags, sup)
        if backward:
            _seeded_backward(loss_retval['total_seeker'], mesh)
            g = xs.grad if xs.grad is not None else torch.zeros_like(xs)
            last_grads = [g[r0:r1] for r0, r1 in parts]
    if backward:
        grads = pipeline.backward_stages(inputs, outputs, last_grads, mesh)
        if first:
            torch.autograd.backward(list(emb), [torch.cat(g) for g in zip(*grads)])
    return result


def _aux_of(loss_retval, msums):
    aux = {k: loss_retval[k] for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker')}
    aux['metric_sums'] = msums
    return aux


def loss_and_aux(model, cfg: StepConfig, batch, generator, progress, train: bool,
                 mesh=None):
    '''(total loss, aux of losses and metric sums) of one batch, differentiable in the
    model's parameters; `generator` draws the drop-path masks when training. Under a
    mesh, the global batch's loss from this rank's rows.'''
    loss_retval, msums, *_ = _outputs_and_losses(model, cfg, batch, generator, progress,
                                                 train, mesh=mesh)
    return loss_retval['total_seeker'], _aux_of(loss_retval, msums)


def split_microbatches(batch, grad_accum: int):
    '''`grad_accum` microbatches of the batch (step.py:174-182): every leaf with a leading
    batch axis is cut into equal consecutive slices (frame_times too), scalars
    (query_time) are shared. Raises ValueError when the batch does not divide.'''
    parts = [{} for _ in range(grad_accum)]
    for k, v in batch.items():
        if getattr(v, 'ndim', 0) > 0:
            if v.shape[0] % grad_accum:
                raise ValueError(f'grad_accum={grad_accum} does not divide the batch axis of '
                                 f'{k} {tuple(v.shape)}')
            n = v.shape[0] // grad_accum
            for i, part in enumerate(parts):
                part[k] = v[i * n:(i + 1) * n]
        else:
            for part in parts:
                part[k] = v
    return parts


def backward_loss(loss: torch.Tensor, mesh=None):
    '''loss.backward(), seeded under sequence parallelism with 1 on seq rank 0 and 0 on
    the others: every seq rank computes the same replicated loss, whose gradient must
    enter the (data x seq) sum once (module docstring). Not under pipeline parallelism,
    whose backward _pipeline_pass drives.'''
    if mesh_lib.pp_mesh(mesh) is not None:
        raise ValueError('a pipeline stage runs its backward through _pipeline_pass')
    _seeded_backward(loss, mesh)


def _seeded_backward(loss: torch.Tensor, mesh):
    if mesh_lib.sp_mesh(mesh) is None:
        loss.backward()
    else:
        loss.backward(torch.full_like(loss, 1.0 if mesh.seq_rank == 0 else 0.0))


def _loss_and_backward(model, cfg: StepConfig, batch, generator, progress, mesh):
    '''The aux of one (micro)batch after its backward (gradients in .grad): loss_and_aux
    then backward_loss, or under pipeline parallelism one GPipe flush (_pipeline_pass),
    the aux broadcast from the last stage.'''
    if mesh_lib.pp_mesh(mesh) is None:
        loss, aux = loss_and_aux(model, cfg, batch, generator, progress, True, mesh)
        backward_loss(loss, mesh)
        return aux
    res = _pipeline_pass(model, cfg, batch, generator, progress, True, mesh, True,
                         group=mesh.group)
    return pipeline.from_last_stage(None if res is None else _aux_of(*res[:2]), mesh)


def compute_gradients(state: TrainState, cfg: StepConfig, batch, progress,
                      grad_accum: int = 1, mesh=None):
    '''The step up to the update: the gradients of the batch's loss in the parameters'
    .grad and the aux of make_train_step without skipped_nonfinite and grad_norm. Under a
    mesh the gradients are summed over the gradient group and the metric sums over the
    data group, so that every rank holds the global batch's (its shards' under tensor
    parallelism, whose model-axis sums the blocks make in the backward; its stage's
    blocks' under pipeline parallelism, where grad_accum runs one whole flush per
    accumulation microbatch).'''
    A = int(grad_accum)
    model = state.model
    model.zero_grad(set_to_none=True)
    aux_sum = None
    for part in (split_microbatches(batch, A) if A > 1 else (batch,)):
        aux = _loss_and_backward(model, cfg, part, state.generator, progress, mesh)
        aux = {k: ({m: t.detach() for m, t in v.items()} if k == 'metric_sums'
                   else v.detach()) for k, v in aux.items()}
        aux_sum = aux if aux_sum is None else {
            k: ({m: t + v[m] for m, t in aux_sum[k].items()} if k == 'metric_sums'
                else aux_sum[k] + v) for k, v in aux.items()}
    aux = aux_sum
    if A > 1:
        inv = 1.0 / A
        for p in model.parameters():
            if p.grad is not None:
                p.grad.mul_(inv)
        # The metric sums are counts: summed over the microbatches, not averaged.
        aux = {k: (v if k == 'metric_sums' else v * inv) for k, v in aux.items()}
    if mesh is not None:
        mesh_lib.all_reduce_grads(model.named_parameters(), mesh)
    return aux


def make_train_step(cfg: StepConfig, grad_accum: int = 1, mesh=None):
    '''Returns train_step(state, batch, progress) -> (state, aux). The state is updated in
    place. aux holds the losses and metric sums of step.py:137-143 (0-d tensors, the
    losses detached), skipped_nonfinite (1.0 when the update was skipped) and grad_norm,
    the global norm of the gradients before clipping. One host read per step: whether the
    loss is finite.

    grad_accum > 1 (step.py:163-222) runs one forward and backward per microbatch
    (`split_microbatches`), in order, so only one microbatch's graph is live; the
    gradients are summed in the parameters' .grad and scaled by 1/grad_accum, the losses
    averaged and the metric sums summed, then one clip and one update, skipped when the
    averaged loss is not finite. The drop-path masks of each microbatch are drawn from
    the state's generator in turn.

    With a mesh (parallel/mesh.py) `batch` is this rank's rows (mesh.shard_batch with the
    same grad_accum): each microbatch's losses are the global microbatch's, and the
    gradients are summed over the ranks (compute_gradients) before the clip and the
    update, which every rank then takes alike.'''
    A = int(grad_accum)
    if A < 1:
        raise ValueError(f'grad_accum must be >= 1, got {grad_accum}')

    def train_step(state: TrainState, batch, progress):
        aux = compute_gradients(state, cfg, batch, progress, A, mesh)
        loss = aux['total_seeker']
        grad_norm = state.optimizer.grad_norm()
        ok = bool(torch.isfinite(loss))
        if ok:
            state.optimizer.step(grad_norm)
        state.step += 1
        aux['skipped_nonfinite'] = torch.tensor(0.0 if ok else 1.0)
        aux['grad_norm'] = grad_norm.detach()
        return state, aux

    return train_step


def make_eval_step(cfg: StepConfig, return_outputs: bool = False, per_example: bool = False,
                   mesh=None):
    '''Returns eval_step(model, batch, progress) -> dict of losses and metric sums, with no
    gradients and no drop-path. With return_outputs the dict also carries output_mask,
    output_flags, target_mask, seeker_query_mask and snitch_weights.

    per_example (implies return_outputs, step.py:225-289): one batched forward, then the
    losses and metric sums of each example computed on its own B = 1 slice, so that each
    is what a forward of that clip alone gives; every loss and metric sum has a leading
    B axis. Under a mesh (not with per_example) the losses and metric sums are the global
    batch's, from this rank's rows; under a pipeline-parallel one the batch goes through
    the stages as one microbatch and the last stage's dict is broadcast over the pipe
    group.'''
    pp = mesh_lib.pp_mesh(mesh)
    if pp is not None and per_example:
        raise ValueError('per-example losses are per clip: run them without a mesh')
    last_stage = _last_stage_eval(cfg, return_outputs, per_example, mesh, global_losses=True)

    def eval_step(model, batch, progress):
        out = last_stage(model, batch, progress)
        return out if pp is None else pipeline.from_last_stage(out, pp)

    return eval_step


def _last_stage_eval(cfg: StepConfig, return_outputs: bool, per_example: bool, mesh,
                     global_losses: bool):
    '''make_eval_step's step without the broadcast: under a pipeline-parallel mesh the
    dict on the last stage and None on the others, its losses the global batch's (over
    the data group) with global_losses, else the rank's own rows'.'''
    pp = mesh_lib.pp_mesh(mesh)

    def eval_step(model, batch, progress):
        with torch.no_grad():
            if pp is None:
                res = _outputs_and_losses(model, cfg, batch, None, progress, False,
                                          per_example, mesh)
            else:
                res = _pipeline_pass(model, cfg, batch, None, progress, False, pp, False,
                                     group=pp.group if global_losses else None, n_micro=1)
        if res is None:
            return None
        loss_retval, msums, out_mask, out_flags, sup = res
        out = _aux_of(loss_retval, msums)
        if return_outputs or per_example:
            out.update(output_mask=out_mask, output_flags=out_flags,
                       target_mask=sup['target_mask'],
                       seeker_query_mask=sup['seeker_query_mask'],
                       snitch_weights=loss_retval.get('snitch_weights'))
        return out

    return eval_step


def make_vis_step(cfg: StepConfig, max_queries: int = 2, mesh=None):
    '''Returns vis_step(model, batch, progress) -> the compact payload of train-time
    overlays (step.py:292-322): example 0 is sliced before the forward, unpacked (colour
    augmentations included) and evaluated; the payload holds its losses and metric sums,
    the rgb the model saw (seeker_rgb) and the first `max_queries` queries of
    output_mask, target_mask, seeker_query_mask and snitch_weights, all float16. Under a
    pipeline-parallel mesh every stage of the data row runs it (the example through the
    stages as one microbatch, its losses its own) and the last stage's payload is
    broadcast over the pipe group; JAX's vis step runs the sequential forward
    (tcow_tpu/train/step.py:285-299), the same function.'''
    pp = mesh_lib.pp_mesh(mesh)
    eval_step = _last_stage_eval(cfg, True, False, pp, global_losses=False)

    def vis_step(model, batch, progress):
        batch = {k: (v[0:1] if getattr(v, 'ndim', 0) > 0 else v) for k, v in batch.items()}
        batch = unpack_batch(batch, next(model.parameters()).device)
        out = eval_step(model, batch, progress)
        f16 = lambda x: None if x is None else x[0:1, :max_queries].to(torch.float16)
        payload = None if out is None else {
            'track': out['track'], 'occl_mask': out['occl_mask'],
            'cont_mask': out['cont_mask'], 'total_seeker': out['total_seeker'],
            'metric_sums': out['metric_sums'],
            'seeker_rgb': batch['rgb'][0:1].to(torch.float16),
            'output_mask': f16(out['output_mask']),
            'target_mask': f16(out['target_mask']),
            'seeker_query_mask': f16(out['seeker_query_mask']),
            'snitch_weights': f16(out['snitch_weights']),
        }
        return payload if pp is None else pipeline.from_last_stage(payload, pp)

    return vis_step
