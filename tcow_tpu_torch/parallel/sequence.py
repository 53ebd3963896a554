'''
Sequence parallelism of the divided space-time blocks over the seq group of a DataMesh
(parallel/mesh.py): the port of the JAX package's 'seq' mesh axis. JAX constrains the patch
axis N to the seq axis before temporal attention and the frame axis T before spatial
attention (_seq_constrain, tcow_tpu/models/timesformer.py:379-386, :404, :418) and XLA
inserts an all-to-all at each swap; on the kernel path every seq shard runs the
single-device kernel on its own rows (fused_attention_rows' row_axes).

Here each seq rank holds a contiguous chunk of the N patches, (B, N_s, T, D), for temporal
attention, temporal_fc and the MLP; one all-to-all over the seq group turns that into a
chunk of the T frames, (B, T_s, N, D), for spatial attention, and a second turns it back.
The chunks are JAX's: contiguous and ceil-sized, the last one shorter (T = 30 over 4 ranks:
8, 8, 8, 6); a split that leaves a rank nothing raises ValueError. Outside the blocks
everything is replicated: the tokens are split after the embedding (split_seq) and gathered
before the norm (gather_seq).

Gradients. The parameter gradients are summed over the (data x seq) ranks
(mesh.all_reduce_grads), so a replicated computation must contribute its gradient once in
that sum: every replicated tensor carries a partial cotangent, and the ranks' partials sum
to the true one. The train step seeds the replicated loss on seq rank 0 only
(train/step.py), and:
  - split_seq (replicated -> local) needs no collective in the backward: the cotangent of
    the other ranks' chunks is this rank's part of zero;
  - gather_seq (local -> replicated, an all-gather) has a reduce-scatter as its backward;
  - each all-to-all's backward is the inverse all-to-all;
  - the cls token (replicated) enters spatial attention in this rank's frames alone, so
    its cotangent from there is a partial too. Under causal_attention 0 the new cls token
    is the mean of the frames' cls outputs, a sum over the seq group (mean_over_frames),
    whose backward sums the partials; under 1 it is frame 0's, which seq rank 0 holds
    (first_frame: a broadcast), whose backward sums the partials on that rank.
Megatron's copy of a replicated input, which gives every rank the whole cotangent and sums
the input's gradient, would count the cls token's MLP once per seq rank.

Joint space-time attention (one call over a clip's 1 + N T tokens) has no axis to swap: as
JAX's fused_attention_rows partitions its rows over (data, seq, model), each seq rank runs
whole joint blocks on its chunk of the folded clips. split_rows zero-pads the rows to a
multiple of n_seq (ceil-sized chunks; 6 rows over 4 ranks leave the last rank padding only)
and takes this rank's; gather_rows joins them (one all-gather) and slices the padding off, so
the padded rows get zero cotangents; its backward is a reduce-scatter, as gather_seq's.

Every collective goes through _gather, _scatter_sum, _exchange, _seq_sum or _from_owner
(looked up at call time, so chip_smoke.py can count them).
'''

import math
from typing import List, Tuple

import torch
import torch.distributed as dist


def chunks(length: int, n: int) -> List[Tuple[int, int]]:
    '''The [start, stop) of each of n contiguous ceil-sized chunks of `length` (the last
    one shorter); raises ValueError when a chunk would be empty.'''
    size = -(-length // n)
    out = [(min(i * size, length), min((i + 1) * size, length)) for i in range(n)]
    if any(lo == hi for lo, hi in out):
        raise ValueError(f'{length} do not split into {n} non-empty seq chunks of {size}')
    return out


def local_range(length: int, mesh) -> Tuple[int, int]:
    '''This rank's [start, stop) of an axis of `length` split over the seq group.'''
    return chunks(length, mesh.n_seq)[mesh.seq_rank]


def check_seq_split(num_patches: int, num_frames: int, n_seq: int):
    '''Raises ValueError unless n_seq seq shards leave every rank patches and frames (the
    divided blocks' rule; the joint blocks split rows, which may leave a rank padding).'''
    chunks(num_patches, n_seq)
    chunks(num_frames, n_seq)


def row_range(rows: int, mesh) -> Tuple[int, int]:
    '''This rank's [start, stop) of `rows` zero-padded to a multiple of n_seq: ceil(rows /
    n_seq) each; the ones from `rows` on are padding.'''
    k = -(-rows // mesh.n_seq)
    return mesh.seq_rank * k, (mesh.seq_rank + 1) * k


# ---------------------------------------------------------------------------------------
# The collectives (dim 0, or the dims named), each over the seq group
# ---------------------------------------------------------------------------------------

def _pad0(t: torch.Tensor, rows: int) -> torch.Tensor:
    if t.shape[0] == rows:
        return t.contiguous()
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


def _gather(t: torch.Tensor, mesh, length: int) -> torch.Tensor:
    '''The seq group's chunks of an axis of `length` (each rank's t on dim 0) joined in rank
    order: one all_gather_into_tensor of the chunks padded to the ceil size.'''
    size = -(-length // mesh.n_seq)
    part = _pad0(t, size)
    full = part.new_empty((size * mesh.n_seq,) + tuple(part.shape[1:]))
    dist.all_gather_into_tensor(full, part, group=mesh.seq_group)
    return full[:length]


def _scatter_sum(t: torch.Tensor, mesh, padded: bool = False) -> torch.Tensor:
    '''This rank's chunk of t's dim 0 summed over the seq group: one reduce_scatter_tensor
    of t padded to n_seq x the ceil size; with `padded` the whole ceil-sized chunk, its
    padding included (split_rows' chunk).'''
    length = t.shape[0]
    size = -(-length // mesh.n_seq)
    y = t.new_empty((size,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(y, _pad0(t, size * mesh.n_seq), group=mesh.seq_group)
    if padded:
        return y
    lo, hi = local_range(length, mesh)
    return y[:hi - lo]


def _exchange(x: torch.Tensor, mesh, split_dim: int, join_dim: int,
              join_len: int) -> torch.Tensor:
    '''The all-to-all: x holds the whole of `split_dim` and this rank's chunk of
    `join_dim` (an axis of join_len); the result holds this rank's chunk of split_dim and
    the whole of join_dim, the dims in the same order. One all_to_all_single with the
    chunks' split sizes (uneven when the rank count does not divide an axis).'''
    n, r = mesh.n_seq, mesh.seq_rank
    send_chunks = chunks(x.shape[split_dim], n)
    join_chunks = chunks(join_len, n)
    lo, hi = send_chunks[r]
    xs = x.movedim(split_dim, 0).contiguous()            # (split, ...) join chunk at jd
    rest = list(xs.shape[1:])
    jd = (join_dim + 1 if join_dim < split_dim else join_dim) - 1
    inner = math.prod(rest)
    per_join = inner // rest[jd]
    send = [(b - a) * inner for a, b in send_chunks]
    recv = [(hi - lo) * per_join * (b - a) for a, b in join_chunks]
    out = xs.new_empty(sum(recv))
    dist.all_to_all_single(out, xs.reshape(-1), output_split_sizes=recv,
                           input_split_sizes=send, group=mesh.seq_group)
    pieces = [p.view([hi - lo] + rest[:jd] + [b - a] + rest[jd + 1:])
              for p, (a, b) in zip(out.split(recv), join_chunks)]
    return torch.cat(pieces, dim=jd + 1).movedim(0, split_dim)


def _seq_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    '''t summed over the seq group (one all_reduce).'''
    y = t.contiguous().clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.seq_group)
    return y


def _from_owner(t: torch.Tensor, mesh) -> torch.Tensor:
    '''Seq rank 0's t on every rank of the seq group (one broadcast).'''
    y = t.contiguous().clone()
    dist.broadcast(y, src=mesh.seq_ranks[0], group=mesh.seq_group)
    return y


# ---------------------------------------------------------------------------------------
# Their autograd functions
# ---------------------------------------------------------------------------------------

class _GatherSeq(torch.autograd.Function):
    '''Every rank's chunk of `dim` joined into the replicated tensor; the backward sums
    the ranks' partial cotangents and keeps this rank's chunk (a reduce-scatter), with
    `padded` its padding too.'''

    @staticmethod
    def forward(ctx, x, mesh, dim, length, padded):
        ctx.mesh, ctx.dim, ctx.padded = mesh, dim, padded
        return _gather(x.movedim(dim, 0), mesh, length).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        part = _scatter_sum(g.movedim(ctx.dim, 0).contiguous(), ctx.mesh, ctx.padded)
        return part.movedim(0, ctx.dim), None, None, None, None


class _Exchange(torch.autograd.Function):
    '''The all-to-all of _exchange; the backward is the inverse all-to-all.'''

    @staticmethod
    def forward(ctx, x, mesh, split_dim, join_dim, join_len):
        ctx.mesh, ctx.dims, ctx.split_len = mesh, (split_dim, join_dim), x.shape[split_dim]
        return _exchange(x, mesh, split_dim, join_dim, join_len)

    @staticmethod
    def backward(ctx, g):
        split_dim, join_dim = ctx.dims
        return _exchange(g, ctx.mesh, join_dim, split_dim, ctx.split_len), None, None, None, \
            None


class _SumOverSeq(torch.autograd.Function):
    '''Sum over the seq group of each rank's part; the backward sums the replicated
    result's partial cotangents.'''

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _seq_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return _seq_sum(g, ctx.mesh), None


class _FromFrame0(torch.autograd.Function):
    '''Seq rank 0's x (frame 0's) on every rank; the backward sums the partial cotangents
    onto seq rank 0, the others' x getting none.'''

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _from_owner(x, mesh)

    @staticmethod
    def backward(ctx, g):
        total = _seq_sum(g, ctx.mesh)
        return (total if ctx.mesh.seq_rank == 0 else torch.zeros_like(total)), None


# ---------------------------------------------------------------------------------------
# What the backbone calls
# ---------------------------------------------------------------------------------------

def split_seq(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    '''This rank's chunk of the replicated x along `dim` (a slice: its backward puts the
    cotangent in place, zero elsewhere).'''
    lo, hi = local_range(x.shape[dim], mesh)
    return x.narrow(dim, lo, hi - lo)


def gather_seq(x: torch.Tensor, mesh, dim: int, length: int) -> torch.Tensor:
    '''The replicated tensor whose `dim` (of `length`) the seq ranks hold in chunks.'''
    return _GatherSeq.apply(x, mesh, dim, length, False)


def split_rows(x: torch.Tensor, mesh) -> torch.Tensor:
    '''This rank's chunk (row_range) of the replicated x's rows (dim 0), zero-padded to a
    multiple of n_seq (differentiable: the padding's cotangent is dropped).'''
    lo, hi = row_range(x.shape[0], mesh)
    return _pad0(x, (hi - lo) * mesh.n_seq)[lo:hi]


def gather_rows(x: torch.Tensor, mesh, rows: int) -> torch.Tensor:
    '''The replicated `rows` rows whose padded chunks (split_rows) the seq ranks hold.'''
    return _GatherSeq.apply(x, mesh, 0, rows, True)


def patches_to_frames(x: torch.Tensor, mesh, num_patches: int) -> torch.Tensor:
    '''(B, N_s, T, D), this rank's patches of every frame -> (B, T_s, N, D), every patch
    of this rank's frames.'''
    return _Exchange.apply(x, mesh, 2, 1, num_patches).transpose(1, 2)


def frames_to_patches(x: torch.Tensor, mesh, num_frames: int) -> torch.Tensor:
    '''(B, T_s, N, D) -> (B, N_s, T, D): the inverse of patches_to_frames.'''
    return _Exchange.apply(x.transpose(1, 2), mesh, 1, 2, num_frames)


def mean_over_frames(cls_out: torch.Tensor, mesh, num_frames: int) -> torch.Tensor:
    '''The mean over all num_frames frames of cls_out (B, T_s, D), this rank's frames'
    cls outputs: their f32 sums added over the seq group, in cls_out's dtype.'''
    total = _SumOverSeq.apply(cls_out.float().sum(dim=1), mesh)
    return (total / num_frames).to(cls_out.dtype)


def first_frame(cls_out: torch.Tensor, mesh) -> torch.Tensor:
    '''Frame 0's cls output (B, D) on every rank, from seq rank 0's cls_out (B, T_s, D).
    Every rank passes its first frame's, so the graph is the same on each.'''
    return _FromFrame0.apply(cls_out[:, 0], mesh)
