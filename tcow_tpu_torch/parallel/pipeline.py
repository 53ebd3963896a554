'''
Pipeline parallelism of the backbone's blocks over the pipe axis of a DataMesh
(parallel/mesh.py): the port of the JAX package's GPipe schedule (_gpipe_scan and
_manual_pipe_scan, tcow_tpu/models/timesformer.py:485-710) and of its driver's checks
(validate_pp_args, tcow_tpu/train/driver.py:102-126).

Each rank of a pipe line holds one stage: a contiguous chunk of depth / S blocks
(mesh.stage_blocks), the stage's blocks local to it, as JAX's manual pipe keeps them, so
every stage body calls the attention kernels on its own rows. The embedding runs on the
first stage, the norm, the heads and the losses on the last, on the whole batch: only the
blocks are pipelined. The schedule is GPipe's: the batch's rows are split into M
microbatches (resolve_pp_microbatches; unevenly by tensor_split when the rows this rank
holds do not divide, the blocks being row-independent), every microbatch goes forward
through the stages in turn, then every microbatch backward, the last first.

The hops. gloo's send / recv fail on CUDA tensors, so each hop is a broadcast in the
two-rank group of the stages it joins (mesh.hop_prev / mesh.hop_next): forward from
stage s to s + 1, backward from s + 1 to s, the tokens and the cls token packed into one
buffer. Every hop of one group has the same shape, so both ends must issue them in one
order: forward microbatches 0 .. M-1, backward M-1 .. 0. The backward is therefore driven
explicitly (run_stages / backward_stages): each stage takes its microbatch inputs as leaves
that require grad, keeps its outputs, calls torch.autograd.backward on microbatch m's
outputs with the gradients the next stage sent, and sends the inputs' .grad back, in that
fixed order; no collective hides inside the autograd graph, whose order among independent
microbatch branches is not fixed.

Every hop goes through _hop (looked up at call time, so chip_smoke.py can count it).
'''

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def resolve_pp_microbatches(requested: int, stages: int, rows: int) -> int:
    '''Microbatch count M of the GPipe schedule (timesformer.py:469-483): an explicit
    request as it is, else the largest of 4S, 2S and S that divides the folded rows,
    else S.'''
    if requested:
        return int(requested)
    for m in (4 * stages, 2 * stages, stages):
        if m <= rows and rows % m == 0:
            return m
    return stages


def validate_pp_args(args) -> int:
    '''The pipeline's divisibility checks (tcow_tpu/train/driver.py:102-126): ValueError
    unless network_depth divides by remat_group, the depth / remat_group checkpoint
    regions by pp_stages, and the folded rows of a step (batch_size / grad_accum x
    num_queries) by the microbatch count; returns pp_stages.'''
    pp_stages = int(getattr(args, 'pp_stages', 1))
    if pp_stages > 1:
        depth = int(getattr(args, 'network_depth', 12))
        group = max(int(getattr(args, 'remat_group', 1)), 1)
        n_steps, rem = divmod(depth, group)
        if rem != 0:
            raise ValueError(f'network_depth {depth} must be divisible by '
                             f'remat_group {group}')
        if n_steps % pp_stages != 0:
            raise ValueError(f'network_depth {depth} / remat_group {group} must be '
                             f'divisible by pp_stages {pp_stages}')
        accum = max(1, int(getattr(args, 'grad_accum', 1)))
        rows = (args.batch_size // accum) * args.num_queries
        mbs = resolve_pp_microbatches(int(getattr(args, 'pp_microbatches', 0)), pp_stages,
                                      rows)
        if rows % mbs != 0:
            raise ValueError(f'batch_size/grad_accum*num_queries ({rows}) must be '
                             f'divisible by pp_microbatches {mbs}')
    return pp_stages


def check_pp_manual(args):
    '''--pp_manual 1 keeps the JAX manual pipe's layout rule (timesformer.py:646-648):
    a (pipe x data) mesh only, so ValueError beside --tp_shards or --seq_shards > 1. The
    port has one schedule, whose stages are local either way, so the flag selects nothing
    else.'''
    if int(getattr(args, 'pp_manual', 0)) and int(getattr(args, 'pp_stages', 1)) > 1:
        for flag in ('tp_shards', 'seq_shards'):
            if int(getattr(args, flag, 1)) > 1:
                raise ValueError(f'--pp_manual supports (pipe x data) meshes only; '
                                 f'--{flag} is {getattr(args, flag)}')


def microbatches(rows: int, n: int) -> List[Tuple[int, int]]:
    '''The [start, stop) rows of the n microbatches of `rows` (torch.tensor_split's
    uneven split; fewer than n when there are fewer rows, none of them empty).'''
    parts = torch.tensor_split(torch.arange(rows), max(1, min(n, rows)))
    return [(int(p[0]), int(p[-1]) + 1) for p in parts]


def microbatch_count(requested: int, mesh, local_rows: int) -> int:
    '''M for this rank: resolve_pp_microbatches on the global batch's folded rows
    (local_rows on each of the n_data data rows), as JAX splits the global batch.'''
    return resolve_pp_microbatches(requested, mesh.n_pipe, local_rows * mesh.n_data)


# ---------------------------------------------------------------------------------------
# The hops
# ---------------------------------------------------------------------------------------

def _hop(t: torch.Tensor, mesh, group, src: int) -> torch.Tensor:
    '''One broadcast of `t` from global rank `src` in the two-rank `group`, in place.'''
    moved = t if mesh.backend != 'nccl' or t.device.type == 'cuda' else t.to(mesh.device)
    dist.broadcast(moved, src=src, group=group)
    return moved if moved is t else moved.to(t.device)


def _pack(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def _unpack(flat: torch.Tensor, like: Sequence[Tuple[tuple, torch.dtype]]):
    out, offset = [], 0
    for shape, _ in like:
        n = int(torch.Size(shape).numel())
        out.append(flat[offset:offset + n].view(shape))
        offset += n
    return out


def send(tensors: Sequence[torch.Tensor], mesh, forward: bool):
    '''Sends `tensors` to the next stage (forward) or the previous one (backward).'''
    group = mesh.hop_next if forward else mesh.hop_prev
    _hop(_pack(tensors), mesh, group, mesh.rank)


def recv(like: Sequence[Tuple[tuple, torch.dtype]], device, mesh, forward: bool):
    '''Receives tensors of the (shape, dtype)s `like` from the previous stage (forward) or
    the next one (backward). The dtypes must agree.'''
    group = mesh.hop_prev if forward else mesh.hop_next
    src = mesh.rank - 1 if forward else mesh.rank + 1
    n = sum(int(torch.Size(s).numel()) for s, _ in like)
    flat = torch.empty(n, dtype=like[0][1], device=device)
    return _unpack(_hop(flat, mesh, group, src), like)


# ---------------------------------------------------------------------------------------
# The schedule
# ---------------------------------------------------------------------------------------

def run_stages(stage_fn, parts, first_inputs, shapes, dtype, device, mesh, grad: bool):
    '''The forward of every microbatch through this rank's stage, in order. parts: the
    microbatches' rows; first_inputs(m) (first stage): microbatch m's block inputs (tokens,
    cls), shapes(m): their shapes (every other stage receives them from the previous
    one); stage_fn(m, xs, cls) -> (xs, cls) runs the stage's blocks. With grad the inputs
    are leaves that require grad. Returns (inputs, outputs), one (xs, cls) pair a
    microbatch each; the outputs are sent on unless this is the last stage.'''
    first, last = mesh.pipe_rank == 0, mesh.pipe_rank == mesh.n_pipe - 1
    inputs, outputs = [], []
    for m in range(len(parts)):
        if first:
            xs, cls = (t.detach() for t in first_inputs(m))
        else:
            xs, cls = recv([(s, dtype) for s in shapes(m)], device, mesh, forward=True)
        if grad:
            xs, cls = xs.requires_grad_(), cls.requires_grad_()
        out = stage_fn(m, xs, cls)
        if not last:
            send(out, mesh, forward=True)
        inputs.append((xs, cls))
        outputs.append(out)
    return inputs, outputs


def backward_stages(inputs, outputs, last_grads: Optional[list], mesh) -> list:
    '''The backward of every microbatch through this rank's stage, the last microbatch
    first: the gradients of its outputs (last_grads[m] of the tokens on the last stage,
    whose cls output the heads do not read; else received from the next stage) through
    torch.autograd.backward, then its inputs' gradients sent to the previous stage.
    Returns the inputs' gradients by microbatch (the first stage's, for the embedding).'''
    first, last = mesh.pipe_rank == 0, mesh.pipe_rank == mesh.n_pipe - 1
    grads = [None] * len(outputs)
    for m in reversed(range(len(outputs))):
        (xs_o, cls_o), (xs_i, cls_i) = outputs[m], inputs[m]
        if last:
            torch.autograd.backward([xs_o], [last_grads[m]])
        else:
            g = recv([(tuple(xs_o.shape), xs_o.dtype), (tuple(cls_o.shape), cls_o.dtype)],
                     xs_o.device, mesh, forward=False)
            torch.autograd.backward([xs_o, cls_o], g)
        g_in = [t.grad if t.grad is not None else torch.zeros_like(t) for t in (xs_i, cls_i)]
        if not first:
            send(g_in, mesh, forward=False)
        grads[m] = g_in
    return grads


def from_last_stage(obj, mesh):
    '''The last stage's picklable `obj` (tensors moved to the CPU) on every rank of the
    pipe group, its tensors on this rank's device: one object broadcast.'''
    src = mesh.pipe_ranks[-1]
    to = lambda o, dev: (o.detach().to(dev) if isinstance(o, torch.Tensor) else
                         {k: to(v, dev) for k, v in o.items()} if isinstance(o, dict) else o)
    box = [to(obj, 'cpu') if mesh.rank == src else None]
    dist.broadcast_object_list(box, src=src, group=mesh.pipe_group,
                               device=mesh.device if mesh.backend == 'nccl' else None)
    return to(box[0], mesh.device)
