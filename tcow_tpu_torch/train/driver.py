'''
Training orchestration: epoch loop, validation phases, checkpointing, resume. The port of
tcow_tpu/train/driver.py (:31-160, :161-451, :453-718) on the port's step
(train/step.py: make_train_step, make_eval_step, make_vis_step) and checkpoints
(train/checkpoint.py: save_train_state's format, load_checkpoint, peek_meta,
find_full_snapshot).

Kept from the JAX driver: seeds; the epoch and validation cadence (val_every, do_val_aug,
do_val_noaug) with the val loaders started ahead; at most 20 tolerated exceptions per
epoch; the '*ba*' save before training; checkpoint writes on a thread that never stacks,
--checkpoint_light with the full-snapshot fallback and --allow_opt_reinit; a reference
.pth as --resume (parameters only, with --allow_opt_reinit) or as --tracker_pretrained (a
TCOW checkpoint, or an ImageNet ViT inflated to the video backbone);
--preempt_save (SIGTERM finishes the step, writes a full mid-epoch checkpoint, and
--resume continues at that step); the one-step-lagged scalar log; the loader-wait
accounting line and loader_wait_frac.

The attention mode is not a flag: on the GPU the driver picks attention_bwd 'kernel_x'
with remat_policy 'dots_nb_out' (24 K1 + 24 K4 launches per step of the configuration of
record), on the CPU 'res' with 'full', as the JAX driver picks its kernel path only on a
TPU. At log level debug every step logs one `step_stats` line of JSON at the end of its
iteration, just after the preemption check (a SIGTERM sent once a step's line is out
stops the run after the next step): its host wall time, its wait for the batch,
the kernel launches it made and, on the GPU, the peak of torch.cuda.max_memory_allocated
so far. A vis step that ran logs a line of its own after its step's (phase 'vis': its
host wall time, the overlay rendering included, and launches); its videos are encoded on
the logger's threads and waited for at the end of the epoch.

Data parallelism (tcow_tpu/train/driver.py:160-199, :329, :357-390, :538-552, :660-675):
with --multihost 1 this process is one rank of the world its launcher describes (RANK,
WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT; train_torch.py --mesh_devices N starts N
such ranks). Each rank loads its rows of every global batch, rank 0's state is broadcast
to all (parallel/mesh.py:shard_state), the train and eval steps reduce over the group,
rank 0 alone writes checkpoints (with every rank's loader state) and renders the vis step
from its own rows, and rank 0's SIGTERM flag is broadcast once per step and at the epoch
boundaries, so every rank leaves at the same step. A step that raises on one rank cannot
be skipped by the others: under a mesh it ends the run. Every step_stats line carries
the rank, the world size, the backend and the rank's data and model coordinates.

Tensor parallelism (--tp_shards, tcow_tpu/train/driver.py:186-199): the world is a (data,
model) mesh of world / tp_shards data rows of tp_shards ranks. The ranks of a data row load
the same rows (the loaders, the query-sampling stream and the drop-path masks go by the
data coordinate) and hold shards of the block weights; the vis step runs on every rank of
data row 0 (its forward makes model-axis collectives) and rank 0 renders it; every rank
gathers the shards for a checkpoint, which rank 0 writes in the one-process layout; the
checkpoint holds one query-sampling stream per data row.

Sequence parallelism (--seq_shards, tcow_tpu/train/driver.py:186-199): the world is a
(data, seq, model) mesh of world / (seq_shards x tp_shards) data rows. The seq ranks of a
data row load the same rows, hold the whole model and split the tokens inside the blocks
(under joint attention the folded clips);
as under tensor parallelism the vis step runs on every rank of data row 0 (its forward
makes the seq collectives) and rank 0 renders it and writes the checkpoints. Every
step_stats line carries the seq coordinate too.

Pipeline parallelism (--pp_stages, --pp_microbatches, --pp_manual;
tcow_tpu/train/driver.py:40-126): validate_pp_args (parallel/pipeline.py) runs before the
mesh is built, and the world is a (data, seq, model, pipe) mesh of world / (seq_shards x
tp_shards x pp_stages) data rows. The stages of a data row load the same rows and hold
their own blocks (beside --seq_shards each stage's seq ranks split its tokens); each step is
a GPipe flush (train/step.py); the vis step runs on every rank of data row 0, the example
through the stages as one microbatch, and the last stage's payload goes to rank 0, which
renders it; every rank gathers the stages for a checkpoint, which rank 0 writes in the
one-process layout. The attention pairing stays the kernel path on the GPU, so K1 and K4
run on every stage: the port's stages are local, as in JAX's manual pipe, where JAX's GSPMD
pipe runs XLA attention with 'res' / 'dots_nb' for the same gradients (:50-90). --pp_manual
1 runs the same schedule on every layout; where JAX's driver would fall back from its
manual pipe for an indivisible microbatch it logs JAX's warning
(pipeline.check_pp_manual). Every step_stats line carries the pipe coordinate too.
'''

import json
import random
import signal
import threading
import time
from typing import Any, Dict

import numpy as np
import torch

from tcow_tpu_torch import config as config_lib
from tcow_tpu_torch import resolve_device
from tcow_tpu_torch.data import factory
from tcow_tpu_torch.models import torch_import
from tcow_tpu_torch.models.mask_tracker import SeekerConfig, seeker_config_from_args
from tcow_tpu_torch.objectives import metrics as metrics_lib
from tcow_tpu_torch.objectives.losses import LossConfig
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.parallel import mesh as mesh_lib
from tcow_tpu_torch.parallel import pipeline
from tcow_tpu_torch.train import checkpoint as ckpt_lib
from tcow_tpu_torch.train import optim, step as step_lib
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

MAX_EXCEPTIONS_PER_EPOCH = 20


def loss_config_from_args(args) -> LossConfig:
    return LossConfig(
        track_lw=args.track_lw, occl_mask_lw=args.occl_mask_lw,
        cont_mask_lw=args.cont_mask_lw, occluded_weight=args.occluded_weight,
        occl_cont_zero_weight=args.occl_cont_zero_weight,
        class_balancing=args.class_balancing, focal_loss=args.focal_loss,
        aot_loss=args.aot_loss, hard_negative_factor=args.hard_negative_factor,
        front_occl_thres=args.front_occl_thres, outer_cont_thres=args.outer_cont_thres)


def build_seeker_config(args, seeker_args: Dict[str, Any],
                        device: torch.device) -> SeekerConfig:
    '''The seeker of seeker_args with the driver's choices: on the GPU the kernel path
    ('kernel_x': the in-kernel attention backward, probabilities recomputed from x, the
    forward never re-run; 'dots_nb_out' keeps the GEMM outputs), on the CPU the plain
    saved-residual backward under full remat. Under --pp_stages too (module docstring),
    with --pp_microbatches.'''
    on_card = device.type == 'cuda'
    return seeker_config_from_args(
        seeker_args,
        compute_dtype=(torch.bfloat16 if args.compute_dtype == 'bfloat16'
                       else torch.float32),
        remat=bool(args.remat), remat_group=int(args.remat_group),
        remat_policy='dots_nb_out' if on_card else 'full',
        attention_bwd='kernel_x' if on_card else 'res',
        pp_microbatches=int(getattr(args, 'pp_microbatches', 0)))


def init_seeker_params(model, cfg: SeekerConfig, seeker_args: Dict[str, Any], logger):
    '''Bootstraps the randomly initialised `model` in place from the local .pth that
    --tracker_pretrained names (tcow_tpu/train/driver.py:130-157): a TCOW checkpoint
    (`net_seeker`) loads whole; any other state dict (or its `model` entry) is an image
    ViT, inflated to the video backbone and applied over the init, which keeps what the
    file lacks. There is no network to fetch ImageNet weights from, so a truthy flag
    without a file keeps the random init. A tensor-parallel model's shards are gathered
    for the inflation (every rank calls it) and sliced again.'''
    path = seeker_args.get('tracker_pretrained', False)
    if not (isinstance(path, str) and len(path) > 5 and path.lower() not in ('false', 'true')):
        if cfg.pretrained:
            logger.warning('tracker_pretrained requested but no local weight file given; '
                           'there is no network to fetch one -> random init. Pass a local '
                           '.pth path via --tracker_pretrained to bootstrap.')
        return
    logger.info(f'Bootstrapping backbone from pretrained weights: {path}')
    sd = torch_import.load_torch_file(path)
    if 'net_seeker' in sd:
        params = torch_import.seeker_params_from_torch(sd['net_seeker'], cfg)
    else:
        if 'model' in sd:
            sd = sd['model']
        bb_cfg = cfg.backbone_config()
        inflated = torch_import.inflate_imagenet_vit_state_dict(
            sd, in_chans=cfg.input_channels, num_patches=bb_cfg.num_patches,
            num_frames=bb_cfg.num_frames, attention_type=cfg.attention_type)
        params = params_to_jax(mesh_lib.gather_state_dict(model.state_dict(), model.mesh))
        params['backbone'] = torch_import.apply_pretrained_to_params(
            params['backbone'], inflated, bb_cfg)
    model.load_state_dict(mesh_lib.shard_params(params_from_jax(params), model.mesh))


def _host_state(state: step_lib.TrainState, full: bool, copy: bool):
    '''What a checkpoint writes, on the host, taken before the next step updates the
    state in place: the JAX-layout parameters and, when full, the optax-layout optimizer
    state, the step and the generator's bytes. copy: CPU tensors share their memory with
    the arrays, so those are copied. A tensor-parallel model's shards are gathered over
    the model group, a pipeline stage's blocks over the pipe group (fetch_global, which
    every rank calls).'''
    mesh = state.model.mesh
    own = (lambda tree: mesh_lib.fetch_global(tree, mesh)) if copy or mesh is not None \
        else (lambda tree: tree)

    params = own(params_to_jax(state.model.state_dict()))
    if not full:
        return params, None, None, None
    return (params, own(ckpt_lib.opt_state_to_jax(state.optimizer)), int(state.step),
            state.generator.get_state().numpy().copy())


class _StopFlag:
    '''The SIGTERM flag as the ranks agree on it: check() returns rank 0's flag on every
    rank (one broadcast under a mesh, none once they have agreed to stop), and `stopped`
    holds the agreed value since. Every rank calls check() at the same points.'''

    def __init__(self, mesh):
        self.event = threading.Event()
        self.mesh = mesh
        self.stopped = False

    def check(self) -> bool:
        if not self.stopped:
            self.stopped = mesh_lib.broadcast_one_to_all(self.event.is_set(), self.mesh)
        return self.stopped


def join_mesh(args, logger):
    '''The DataMesh of a --multihost rank (None for one process): world / (--seq_shards x
    --tp_shards x --pp_stages) data rows of that many ranks, checked against the flags:
    --mesh_devices, when given, must equal the world size, and batch_size / grad_accum
    must divide by the data rows (the world is fixed: no ranks are dropped).'''
    if not args.multihost:
        if args.mesh_devices > 1:
            raise ValueError('--mesh_devices > 1 starts its ranks through train_torch.py; '
                             'each rank runs with --multihost 1')
        return None
    resolve_device(args.device)
    mesh = mesh_lib.make_mesh(args.device, model=int(getattr(args, 'tp_shards', 1)),
                              seq=int(getattr(args, 'seq_shards', 1)),
                              pipe=int(getattr(args, 'pp_stages', 1)))
    logger.info(f'Mesh: rank {mesh.rank} of {mesh.world} on {mesh.device} at (data '
                f'{mesh.data_rank} of {mesh.n_data}, seq {mesh.seq_rank} of {mesh.n_seq}, '
                f'model {mesh.model_rank} of {mesh.n_model}, pipe {mesh.pipe_rank} of '
                f'{mesh.n_pipe}), backend {mesh.backend} ({mesh.reason})')
    try:
        if args.mesh_devices > 0 and args.mesh_devices != mesh.world:
            raise ValueError(f'--mesh_devices {args.mesh_devices} but the world has '
                             f'{mesh.world} ranks')
        mesh_lib.shard_rows(args.batch_size, mesh.data_rank, mesh.n_data,
                            max(1, int(getattr(args, 'grad_accum', 1))))
    except ValueError:
        mesh.close()
        raise
    return mesh


def main(args, logger):
    pipeline.validate_pp_args(args)
    mesh = join_mesh(args, logger)
    pipeline.check_pp_manual(args, 1 if mesh is None else mesh.n_data, logger)
    try:
        return _train(args, logger, mesh)
    finally:
        if mesh is not None:
            mesh.close()


def _train(args, logger, mesh):
    device = mesh.device if mesh is not None else resolve_device(args.device)
    rank = 0 if mesh is None else mesh.rank
    data_rank, n_data = (0, 1) if mesh is None else (mesh.data_rank, mesh.n_data)
    logger.save_args(args, 'train')
    np.random.seed(args.seed)
    random.seed(args.seed)
    torch.manual_seed(args.seed)

    # wandb gradations: 0 = scalars + media online, 1 = scalars only, 2 = fully offline
    # (scalars.jsonl is always written regardless).
    avoid_wandb = int(getattr(args, 'avoid_wandb', 0))
    if avoid_wandb < 2 and rank == 0:
        logger.init_wandb('tcow', args, name=args.name or None,
                          group=getattr(args, 'wandb_group', 'train'))
    logger.log_media_online = (avoid_wandb == 0)
    logger.info(f'Device: {device}'
                + (f' ({torch.cuda.get_device_name(device)})' if device.type == 'cuda'
                   else ''))

    seeker_args = config_lib.build_seeker_args(args)
    cfg = build_seeker_config(args, seeker_args, device)
    logger.info(f'Attention backward {cfg.attention_bwd}, remat policy {cfg.remat_policy}')
    step_cfg = step_lib.StepConfig(seeker=cfg, loss=loss_config_from_args(args),
                                   num_queries=args.num_queries)
    allow_opt_reinit = bool(getattr(args, 'allow_opt_reinit', False))
    if args.resume.endswith('.pth') and not allow_opt_reinit:
        raise ValueError(
            'Resuming training from a torch .pth checkpoint reinitializes the '
            'optimizer/LR-schedule state (cross-framework resume cannot translate '
            'torch optimizer state). Pass --allow_opt_reinit 1 to accept that.')

    start_time = time.time()
    train_loader, val_aug_loader, val_noaug_loader, dset_args = \
        factory.create_train_val_data_loaders(
            args, logger, shard=(data_rank, n_data))
    logger.info(f'Data loaders ready ({time.time() - start_time:.3f}s)')
    steps_per_epoch = len(train_loader)

    tx = optim.make_optimizer(args.optimizer, args.learn_rate, args.lr_decay,
                              args.num_epochs, steps_per_epoch, args.gradient_clip)
    state = step_lib.init_train_state(args.seed, step_cfg, tx, device=device, mesh=mesh)
    init_seeker_params(state.model, cfg, seeker_args, logger)
    n_params = sum(p.numel() for p in state.model.parameters())   # this rank's shards
    logger.info(f'Seeker parameter count: {int(np.round(n_params / 1e6))}M')

    start_epoch = 0
    start_step = 0   # mid-epoch resume point (preemption checkpoints)
    loaded = {}
    if args.resume.endswith('.pth'):
        # A reference checkpoint: its parameters, with a fresh optimizer (checked above).
        logger.info('Loading weights from: ' + args.resume)
        params, _, ckpt = torch_import.load_tcow_checkpoint(args.resume)
        state.model.load_state_dict(mesh_lib.shard_params(params_from_jax(params),
                                                           state.model.mesh))
        start_epoch = int(ckpt.get('epoch', -1)) + 1
        logger.warning('Resuming from a torch .pth checkpoint: parameters restored, '
                       'optimizer/LR-schedule state REINITIALIZED (--allow_opt_reinit).')
    elif args.resume:
        # A --checkpoint_light save carries no optimizer state; training on from it would
        # silently reset the AdamW moments. Fall back to the newest FULL model_{e}.npz in
        # the same directory, or refuse.
        if not ckpt_lib.peek_meta(args.resume).get('opt_restored') and not allow_opt_reinit:
            alt = ckpt_lib.find_full_snapshot(args.resume)
            if alt is None:
                raise ValueError(
                    f'{args.resume} is a params-only (--checkpoint_light) checkpoint '
                    'and no full-state model_{e}.npz snapshot exists beside it. Pass '
                    '--allow_opt_reinit 1 to resume anyway with a fresh optimizer.')
            logger.warning(f'{args.resume} is params-only (--checkpoint_light); '
                           f'resuming from the newest FULL snapshot {alt} instead '
                           '(pass --allow_opt_reinit 1 to use the light one).')
            args.resume = alt
        logger.info('Loading weights from: ' + args.resume)
        loaded = ckpt_lib.load_checkpoint(args.resume, state_template=state)
        state = loaded['state']
        if loaded.get('partial'):
            # Preemption checkpoint: epoch `epoch` is in progress with steps_done
            # complete; continue it at that step (the batch order is deterministic).
            start_epoch = int(loaded['epoch'])
            start_step = int(loaded.get('steps_done_in_epoch', 0))
            if start_step >= steps_per_epoch:   # dataset/batch size changed
                start_epoch, start_step = start_epoch + 1, 0
            logger.info(f'Resuming mid-epoch: epoch {start_epoch} at step '
                        f'{start_step}/{steps_per_epoch} (preemption checkpoint).')
        else:
            start_epoch = int(loaded['epoch']) + 1
        if not loaded.get('opt_restored', True):
            logger.warning('Resuming from a params-only (--checkpoint_light) checkpoint: '
                           'optimizer/LR-schedule state is REINITIALIZED '
                           '(--allow_opt_reinit).')

    if mesh is not None:
        mesh_lib.shard_state(state, mesh)
    grad_accum = max(1, int(getattr(args, 'grad_accum', 1)))
    if grad_accum > 1 and args.batch_size % grad_accum != 0:
        raise ValueError(f'batch_size {args.batch_size} must be divisible by '
                         f'grad_accum {grad_accum}')
    train_step = step_lib.make_train_step(step_cfg, grad_accum=grad_accum, mesh=mesh)
    eval_step = step_lib.make_eval_step(step_cfg, mesh=mesh)
    # Rank 0 renders the vis step from its own rows; the other seq, model and pipe ranks of
    # its data row run its forward beside it (seq and model-axis collectives, the stages'
    # hops and the last stage's payload); no data-group collective.
    vis_step = step_lib.make_vis_step(step_cfg, mesh=mesh) if data_rank == 0 else None

    ckpt_thread = [None]
    # The train loader's query-sampling stream after the last batch a step consumed:
    # saved with each checkpoint, so that a resumed run samples the queries an
    # uninterrupted run would.
    # One stream a data row ('train_collate_rng_by_rank'); a checkpoint written before
    # ranks holds the one process's as 'train_collate_rng'.
    collate_rng = [None]
    if args.resume and loaded.get('loader_state'):
        ls = loaded['loader_state']
        by_rank = ls.get('train_collate_rng_by_rank') or [ls['train_collate_rng']]
        if len(by_rank) == n_data:
            train_loader.collate_fn.restore(by_rank[data_rank])
        elif allow_opt_reinit:
            logger.warning(f'The checkpoint holds the loader state of {len(by_rank)} '
                           f'rank(s), this run has {n_data}: queries are sampled afresh '
                           '(--allow_opt_reinit).')
        else:
            raise ValueError(
                f'{args.resume}: the checkpoint holds the loader state of {len(by_rank)} '
                f'rank(s), this run has {n_data}, so the resume would not sample the '
                'queries an uninterrupted run samples. Resume with the same world size, '
                'or pass --allow_opt_reinit 1 to sample them afresh.')

    def checkpoint_fn(epoch, final: bool = False, steps_done=None):
        if not args.checkpoint_path:
            return
        save_every = max(getattr(args, 'save_every', 1), 1)
        if epoch >= 0 and not final and steps_done is None \
                and epoch % save_every != 0 and epoch % args.checkpoint_every != 0:
            return
        # --checkpoint_light: per-epoch saves write params only; the full resumable state
        # still lands every checkpoint_every epochs and at the end. A mid-epoch
        # (preemption) save is always full: it IS the state to resume from.
        full = (not getattr(args, 'checkpoint_light', False) or final or epoch < 0
                or steps_done is not None or epoch % args.checkpoint_every == 0)
        # Every data row samples its own rows' queries: rank 0 saves every row's stream
        # (the seq and model ranks of a row hold the same one).
        by_rank = ([collate_rng[0]] if mesh is None
                   else mesh_lib.gather_objects(collate_rng[0], mesh)[::mesh.row_ranks])
        loader_state = (None if by_rank[0] is None
                        else {'train_collate_rng_by_rank': by_rank})
        if rank != 0 and mesh_lib.tp_mesh(state.model.mesh) is None \
                and mesh_lib.pp_mesh(state.model.mesh) is None:
            return   # one writer; the state is replicated
        # Taken now, on this thread: the next step updates the state in place. Every rank
        # of a tensor- or pipeline-parallel mesh takes part in the gather, then rank 0
        # writes alone.
        params, opt_state, step, generator_state = _host_state(
            state, full, copy=device.type == 'cpu')
        if rank != 0:
            return

        def write():
            ckpt_lib.save_checkpoint(
                args.checkpoint_path, epoch, args.name, params, opt_state=opt_state,
                step=step, generator_state=generator_state,
                train_args=config_lib.args_to_dict(args), dset_args=dset_args,
                seeker_args=seeker_args, checkpoint_every=args.checkpoint_every,
                is_debug=args.is_debug, steps_done=steps_done, loader_state=loader_state)
            logger.info(f'Saved checkpoint for epoch {epoch}'
                        + ('' if full else ' (light, params only)')
                        + ('' if steps_done is None
                           else f' (mid-epoch, {steps_done} steps)') + '.')

        if ckpt_thread[0] is not None:
            ckpt_thread[0].join()  # never stack writes
        # Disk IO overlaps the next epoch (atomic tmp+rename keeps readers safe).
        ckpt_thread[0] = threading.Thread(target=write, daemon=False)
        ckpt_thread[0].start()
        if final or steps_done is not None:
            ckpt_thread[0].join()

    # start_step == 0 guard: a mid-epoch resume of a '*ba*' run must NOT overwrite its
    # preemption checkpoint with an epoch=-1 save (the state already contains steps).
    if 'ba' in args.name and start_epoch <= 0 and start_step == 0:
        checkpoint_fn(-1)  # save-before-any-training runs

    # Preemption safety (--preempt_save, on by default): SIGTERM finishes the in-flight
    # step, writes a FULL mid-epoch checkpoint, and exits cleanly; --resume continues that
    # epoch at that step. Under a mesh rank 0's flag decides for every rank (_StopFlag).
    stop = _StopFlag(mesh)
    old_sigterm = None
    if getattr(args, 'preempt_save', True) \
            and threading.current_thread() is threading.main_thread():
        def _on_sigterm(signum, frame):
            stop.event.set()
            logger.warning('SIGTERM received: finishing the current step, writing a '
                           'mid-epoch checkpoint, then exiting.')
        old_sigterm = signal.signal(signal.SIGTERM, _on_sigterm)
    else:
        stop = None

    total_steps_all = args.num_epochs * steps_per_epoch
    try:
        for epoch in range(start_epoch, args.num_epochs):
            if stop is not None and stop.check():
                logger.warning(f'Preempted: exiting before epoch {epoch}.')
                break
            ep_start = start_step if epoch == start_epoch else 0
            # Warm the val pipelines during the train epoch, so a val epoch does not
            # start on a cold item pipeline: a deep prefetch stages a whole (small) val
            # epoch concurrently with training.
            if epoch % args.val_every == 0:
                for on, vl in ((args.do_val_aug, val_aug_loader),
                               (args.do_val_noaug, val_noaug_loader)):
                    if on and vl is not None:
                        vl.start_ahead(epoch, prefetch_depth=max(len(vl), 2))
            state, steps_done, rng_after = _run_one_epoch(
                args, logger, device, state, train_step, None, train_loader, 'train',
                epoch, steps_per_epoch, total_steps_all, vis_step=vis_step,
                start_step=ep_start, stop=stop, mesh=mesh)
            collate_rng[0] = rng_after or collate_rng[0]
            if stop is not None and stop.stopped and steps_done < steps_per_epoch:
                checkpoint_fn(epoch, steps_done=steps_done)
                logger.warning(f'Preempted: mid-epoch checkpoint at epoch {epoch}, '
                               f'step {steps_done}/{steps_per_epoch}; exiting.')
                break
            checkpoint_fn(epoch, final=(epoch == args.num_epochs - 1))
            logger.epoch_finished(epoch)
            if stop is not None and stop.check():
                logger.warning(f'Preempted: exiting after completed epoch {epoch}.')
                break
            if epoch % args.val_every == 0:
                for on, vl, phase in ((args.do_val_aug, val_aug_loader, 'val_aug'),
                                      (args.do_val_noaug, val_noaug_loader, 'val_noaug')):
                    if on and vl is not None:
                        _run_one_epoch(args, logger, device, state, None, eval_step, vl,
                                       phase, epoch, steps_per_epoch, total_steps_all,
                                       stop=stop, mesh=mesh)
                logger.epoch_finished(epoch)
    finally:
        if old_sigterm is not None:
            signal.signal(signal.SIGTERM, old_sigterm)
        for vl in (val_aug_loader, val_noaug_loader):
            # A preemption between the ahead-start and the val phase must not leave
            # producer threads loading items while the checkpoint write runs.
            if vl is not None:
                vl.teardown_ahead()
        if ckpt_thread[0] is not None:
            ckpt_thread[0].join()
    logger.info('Training done.')
    return state


def _contiguous(v) -> np.ndarray:
    a = np.asarray(v)   # 0-d stays 0-d (np.ascontiguousarray would make it 1-d)
    return a if a.flags.c_contiguous else a.copy()


class _H2DPrefetcher:
    '''One-deep host->device double buffering for the epoch loop (--h2d_prefetch).

    A worker thread pulls batches from the (already prefetching) host loader, copies each
    array into pinned host memory and issues its copy to the device with non_blocking on
    a side CUDA stream, then records an event there. The consumer makes the step's
    stream wait on that event and marks every tensor as used by the step's stream
    (record_stream), so the caching allocator cannot hand its memory out again before
    the step is done with it. The compact batch is copied as it is: unpack_batch's
    expansion (bits, uint8 -> f32, colour augmentations) runs inside the step, on the
    step's stream, so the numbers are those of an unprefetched batch. On the CPU the
    tensors are made on the thread and no stream is involved.

    The port's step reads one scalar per step (whether the loss is finite), so the
    overlap comes from this thread and the loader's workers, not from asynchronous
    dispatch. A bounded queue of `depth` keeps at most depth + 1 batches on the device
    beyond the step in flight. `t_wait` accumulates the consumer's input-blocked time.
    Loader exceptions re-raise in the consumer. `close()` (always called, via finally)
    unblocks and joins the worker.'''

    _DONE = object()

    def __init__(self, iterator, device, depth: int = 1):
        import queue as queue_mod
        self._device = torch.device(device)
        self._q = queue_mod.Queue(maxsize=max(depth, 1))
        self._stop = threading.Event()
        self._stream = (torch.cuda.Stream(device=self._device)
                        if self._device.type == 'cuda' else None)
        self.t_wait = 0.0
        self._thread = threading.Thread(
            target=self._produce, args=(iter(iterator),), daemon=True)
        self._thread.start()

    def to_device(self, host_batch: Dict[str, Any]):
        '''(device batch, event): the batch's arrays on the device, copied on the side
        stream; the event marks the end of the copies (None on the CPU).'''
        if self._stream is None:
            return {k: torch.as_tensor(np.asarray(v)) for k, v in host_batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(_contiguous(v)).pin_memory().to(
                self._device, non_blocking=True) for k, v in host_batch.items()}
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _put(self, item) -> bool:
        import queue as queue_mod
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue_mod.Full:
                continue
        return False

    def _produce(self, it):
        try:
            for batch in it:
                device_batch, event = self.to_device(batch['device'])
                if not self._put((batch, device_batch, event)):
                    return
            self._put(self._DONE)
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            self._put(e)

    def __iter__(self):
        while True:
            t0 = time.time()
            item = self._q.get()
            self.t_wait += time.time() - t0
            if item is self._DONE:
                return
            if isinstance(item, BaseException):
                raise item
            batch, device_batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(self._device)
                current.wait_event(event)
                for t in device_batch.values():
                    t.record_stream(current)
            yield batch, device_batch

    def close(self):
        self._stop.set()
        while not self._q.empty():
            try:
                self._q.get_nowait()
            except Exception:  # noqa: BLE001 — queue.Empty after a race
                break
        self._thread.join(timeout=10.0)


def _run_one_epoch(args, logger, device, state, train_step, eval_step, loader, phase, epoch,
                   steps_per_epoch, total_steps_all, vis_step=None, start_step=0,
                   stop=None, mesh=None):
    '''Returns (state, steps_done, rng_after) where steps_done counts completed steps of
    this epoch INCLUDING the skipped prefix (start_step, a mid-epoch resume point) and
    rng_after is the collate stream's state after the last completed step's batch (None
    without one). stop.check() true -> leave after the in-flight step completes
    (preemption checkpointing); it runs once per iteration on every rank.'''
    logger.info('=' * 32)
    logger.info(f'Epoch (1-based): {epoch + 1} / {args.num_epochs}  phase: {phase}'
                + (f'  (resuming at step {start_step})' if start_step else ''))
    loader.set_epoch(epoch)
    start_time = time.time()
    num_exceptions = 0
    is_train = (phase == 'train')
    debug = logger.debug_enabled()
    where = ({'rank': 0, 'world': 1, 'backend': None, 'data_rank': 0, 'seq_rank': 0,
              'model_rank': 0, 'pipe_rank': 0}
             if mesh is None else
             {'rank': mesh.rank, 'world': mesh.world, 'backend': mesh.backend,
              'data_rank': mesh.data_rank, 'seq_rank': mesh.seq_rank,
              'model_rank': mesh.model_rank, 'pipe_rank': mesh.pipe_rank})

    profile_dir = getattr(args, 'profile_dir', '')
    profile_start = min(2, max(len(loader) - 1, 0))  # short epochs still get a trace
    profiler = None
    pending_aux, pending_step = None, -1
    rng_after = None
    # Loader-vs-device accounting: t_wait = host blocked on the data iterator; the rest of
    # the epoch wall time is the step (which ends in a host read) + scalar logging.
    t_wait = 0.0
    t_mark = time.time()
    base_iter = loader.iter_batches(start_step) if start_step else loader
    prefetcher = None
    if getattr(args, 'h2d_prefetch', True):
        prefetcher = _H2DPrefetcher(base_iter, device)
        iterator = iter(prefetcher)
    else:
        iterator = ((b, None) for b in base_iter)
    try:
        for cur_step, (batch, device_batch) in enumerate(iterator, start=start_step):
            t_step = time.time()
            wait = t_step - t_mark
            t_wait += wait
            if cur_step == start_step:
                logger.info(f'Enter first data loader iteration took '
                            f'{time.time() - start_time:.3f}s')
            if profile_dir and is_train and epoch == 0 and cur_step == profile_start \
                    and profiler is None:
                profiler = _start_profiler(device)
                logger.info(f'torch.profiler trace started -> {profile_dir}')
            if profiler is not None and cur_step == profile_start + 3:
                _stop_profiler(profiler, profile_dir, logger, where['rank'])
                profiler = None
            total_step = cur_step + steps_per_epoch * epoch
            progress = total_step / max(total_steps_all, 1)
            stats = vis_stats = None
            try:
                if device_batch is None:
                    device_batch = batch['device']
                counts = fa.read_launches() if debug else None
                if is_train:
                    state, aux = train_step(state, device_batch, progress)
                else:
                    aux = eval_step(state.model, device_batch, progress)
                if debug:
                    stats = {'phase': phase, 'epoch': epoch, 'step': cur_step, **where}
                    if device.type == 'cuda':
                        torch.cuda.synchronize(device)
                        stats['max_memory_allocated'] = torch.cuda.max_memory_allocated(device)
                    stats.update(wall_ms=(time.time() - t_step) * 1e3, wait_ms=wait * 1e3,
                                 launches=fa.launches_since(counts))
                # Log with a one-step lag, as the JAX driver does.
                if pending_aux is not None:
                    _log_step_scalars(logger, phase, epoch, pending_step, len(loader),
                                      pending_aux)
                pending_aux, pending_step = aux, cur_step
                rng_after = batch.get('meta', {}).get('collate_rng_after')
                # The vis step every step_interval GLOBAL steps: its losses and metrics
                # on the console and its overlay videos.
                if is_train and vis_step is not None \
                        and total_step % logger.step_interval == 0:
                    counts, t_vis = fa.read_launches() if debug else None, time.time()
                    try:
                        _log_vis_step(logger, args, phase, epoch, cur_step, total_step,
                                      steps_per_epoch, state, vis_step, batch,
                                      device_batch, progress, render=where['rank'] == 0)
                    except Exception as e:  # noqa: BLE001 — must never kill training
                        logger.warning(f'train-step visualization failed: {e}')
                    else:
                        if debug:
                            vis_stats = {'phase': 'vis', 'epoch': epoch, 'step': cur_step,
                                         **where, 'wall_ms': (time.time() - t_vis) * 1e3,
                                         'launches': fa.launches_since(counts)}
            except Exception as e:  # noqa: BLE001 — the tolerated-exception budget
                num_exceptions += 1
                if num_exceptions >= MAX_EXCEPTIONS_PER_EPOCH or mesh is not None:
                    raise
                logger.exception(e)
                if stop is not None and stop.check():
                    logger.warning(f'[{phase}] stopping after failed step {cur_step} '
                                   f'(preemption requested).')
                    break
                t_mark = time.time()
                continue
            stopping = stop is not None and stop.check()
            # Logged last in the iteration, just after the preemption check.
            for record in (stats, vis_stats):
                if record is not None:
                    logger.debug('step_stats ' + json.dumps(record))
            if stopping:
                logger.warning(f'[{phase}] stopping after step {cur_step} '
                               f'(preemption requested).')
                break
            if cur_step >= 100 and args.is_debug:
                logger.warning('Cutting epoch short for debugging...')
                break
            t_mark = time.time()
    finally:
        if prefetcher is not None:
            prefetcher.close()
        if profiler is not None:
            _stop_profiler(profiler, profile_dir, logger, where['rank'])
    if pending_aux is not None:
        _log_step_scalars(logger, phase, epoch, pending_step, len(loader), pending_aux)
    wall = time.time() - start_time
    steps_done = max(pending_step + 1, start_step)
    n_steps = steps_done - start_step
    logger.info(f'[{phase}] epoch {epoch} wall {wall:.1f}s over {n_steps} steps: '
                f'loader wait {t_wait:.1f}s '
                f'({t_wait / max(wall, 1e-9) * 100:.0f}%), step+log '
                f'{wall - t_wait:.1f}s — '
                f'{"loader" if t_wait > wall - t_wait else "device"}-bound')
    logger.report_scalar(f'{phase}/loader_wait_frac', t_wait / max(wall, 1e-9))
    logger.commit_scalars(step=epoch)
    return state, steps_done, rng_after


def _start_profiler(device):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, profile_dir, logger, rank=0):
    import os
    profiler.stop()
    os.makedirs(profile_dir, exist_ok=True)
    path = os.path.join(profile_dir, 'trace.json' if rank == 0 else f'trace_rank{rank}.json')
    profiler.export_chrome_trace(path)
    logger.info(f'torch.profiler trace stopped -> {path}')


def _log_vis_step(logger, args, phase, epoch, cur_step, total_step, steps_per_epoch, state,
                  vis_step, batch, device_batch, progress, render: bool = True):
    '''Runs the compact visualization forward on the current batch and, when `render`,
    hands the result to MyLogger.handle_train_step (tcow_tpu/train/driver.py:
    _render_train_overlays): its losses and metrics on the console, and its float16 slices
    (example 0, the first two queries) as overlay videos. seeker_rgb is the rgb the model
    saw, after the device's colour augmentations.'''
    vis = vis_step(state.model, device_batch, progress)
    if not render:
        return
    host = lambda t: None if t is None else t.cpu().numpy()
    model_retval = {
        'seeker_input': host(vis['seeker_rgb']).astype(np.float32),
        'output_mask': host(vis['output_mask']),
        'target_mask': host(vis['target_mask']),
        'seeker_query_mask': host(vis['seeker_query_mask']),
    }
    if vis.get('snitch_weights') is not None:
        model_retval['snitch_weights'] = host(vis['snitch_weights'])
    loss_retval = {
        'total_seeker': float(vis['total_seeker']),
        'track': float(vis['track']),
        'metrics': metrics_lib.finalize_metric_sums(vis['metric_sums']),
    }
    logger.handle_train_step(epoch, phase, cur_step, total_step, steps_per_epoch,
                             batch.get('meta', {}), model_retval, loss_retval, args)


def _log_step_scalars(logger, phase, epoch, cur_step, steps_total, aux):
    if float(aux.get('skipped_nonfinite', 0.0)) > 0:
        logger.warning('Skipping seeker optimizer step due to loss = NaN.')
    scalars = {k: float(aux[k]) for k in
               ('total_seeker', 'track', 'occl_mask', 'cont_mask')}
    metrics = metrics_lib.finalize_metric_sums(aux['metric_sums'])
    for k, v in scalars.items():
        logger.report_scalar(f'{phase}/loss_{k}', v, remember=True)
    for k in metrics_lib.METRIC_KEYS:
        if metrics[f'count_{k}'] > 0:
            logger.report_scalar(f'{phase}/{k}', metrics[f'mean_{k}'],
                                 remember=True, weight=metrics[f'count_{k}'])
    if cur_step % max(logger.step_interval // 4, 1) == 0:
        logger.info(f'[{phase}] e{epoch} s{cur_step}/{steps_total} '
                    f'total {scalars["total_seeker"]:.4f} '
                    f'track {scalars["track"]:.4f} '
                    f'snitch IoU {metrics["mean_snitch_iou"]:.3f}')
