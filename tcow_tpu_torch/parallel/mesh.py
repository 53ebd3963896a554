'''
Data, sequence and tensor parallelism on torch.distributed: the counterpart of
tcow_tpu/parallel/mesh.py for its data, seq and model axes (the reference's
torch.nn.DataParallel, its train.py:222-223).

In the JAX package the batch is sharded over the mesh's 'data' axis inside one jitted
program, so every loss reduction covers the global batch. Here each rank is a process that
holds its rows of the global batch, and the global-batch math is written out:
  - make_mesh joins the process group and returns a DataMesh (world size, rank, local
    rank, device, backend and its groups, below);
  - shard_batch / shard_rows pick this rank's rows by its data coordinate, interleaved per
    microbatch under grad_accum so that microbatch i is JAX's global rows [i B/A, (i+1) B/A);
  - the losses and metric sums reduce over the data group with all_sum / all_max / all_min
    (objectives/losses.py), whose gradient is this rank's share of the global gradient;
  - all_reduce_grads sums those shares over the gradient group after the backward;
  - shard_state broadcasts rank 0's state and check_replicas compares digests of it across
    ranks;
  - broadcast_one_to_all carries rank 0's stop flag (the driver's preemption check), and
    gather_objects every rank's loader state into rank 0's checkpoint.

Tensor parallelism (--tp_shards, the 'model' axis of JAX's (data, seq, model, pipe) mesh):
the block weights are sharded as block_pspec shards them (tp_dim: qkv.w, proj.w and fc2.w
by their input rows, fc1.w and fc1.b by their output columns; everything else replicated);
shard_params / gather_state_dict convert between the full one-process state_dict and a
rank's shards, and fetch_global gathers a tree of shards into the one-process layout (a
collective every rank calls). The model-axis collectives (copy_to_model,
reduce_from_model, gather_rows, scatter_rows, gather_weight) carry the activations of
parallel/tensor.py's row-parallel attention and Megatron MLP.

Sequence parallelism (--seq_shards, the 'seq' axis): the ranks of one (data, model) line
hold the same parameters and rows and split the tokens inside the backbone's blocks
(parallel/sequence.py). The layout is JAX's reshape of the device list
(tcow_tpu/parallel/mesh.py:27-41): rank r sits at data coordinate r // (S M), seq
coordinate (r // M) % S and model coordinate r % M (rank_layout). Its groups:
  - group: the ranks that share this rank's (seq, model) coordinates, one a data row: the
    losses and metric sums reduce over it;
  - model_group: the ranks of this rank's (data, seq) line (tensor parallelism);
  - seq_group: the ranks of this rank's (data, model) line (sequence parallelism);
  - grad_group: the ranks that share this rank's model coordinate, (data x seq): the
    gradients are summed over it (all_reduce_grads), and its ranks hold the same shards.

Backend rule, decided once by make_mesh and logged by its caller: gloo on the CPU; on CUDA,
nccl when every rank has a device of its own, gloo when two ranks share one physical GPU
(the ranks publish their device UUIDs through the rendezvous store; NCCL fails on
duplicate GPUs). A backend that fails to start raises: nothing is retried on another one.
Only all_reduce, broadcast, all_gather_into_tensor, reduce_scatter_tensor and (on the seq
axis) all_to_all_single are used: gloo moves all five for CUDA tensors (chip_smoke.py's
phase gloo_probe holds it), but not send / recv, so a pipeline hop is a broadcast in a
two-rank group.

Pipeline parallelism (--pp_stages, the 'pipe' axis, the last of JAX's (data, seq, model,
pipe) reshape, so it varies fastest: rank r sits at pipe coordinate r % P, model (r // P) %
M, seq (r // (M P)) % S and data r // (S M P)): the ranks of one (data, seq, model) line
hold consecutive stages of the blocks, block_pspec's contiguous L / P chunks
(stage_blocks), and everything outside the blocks whole. A stage's state_dict names its
blocks from 0 (shard_params / gather_state_dict renumber them), so a JAX-layout tree of a
stage holds its (L / P, ...) chunk of each stacked block leaf, which fetch_global gathers
over the pipe group on the leading axis, as block_pspec shards it. More groups:
  - pipe_group: the ranks of this rank's (data, seq, model) line, by stage;
  - hop_prev / hop_next: the two-rank groups of this rank and its previous / next stage
    (parallel/pipeline.py moves the activations and their gradients through them);
  - grad_group: the ranks with this rank's (model, pipe) coordinates: a block
    parameter's gradient is summed over it;
  - rep_group: the ranks with this rank's model coordinate, (data x seq x pipe): the
    gradient of a parameter outside the blocks (only the first and the last stage reach
    them) is summed over it.

Not here: _relay_probe / shard_state_staged, which pace uploads over the TPU host's relay
(tcow_tpu/parallel/mesh.py:141-239): the port places the state by broadcast.
'''

import dataclasses
import datetime
import os
import re
import socket
from typing import Any, Dict, Iterable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = 'data'
# How long a rank waits at the rendezvous and at each collective before raising.
TIMEOUT = datetime.timedelta(minutes=10)
_UUID_KEY = 'tcow_device_uuid/{}'
# Digest of the replicated state: bytes weighted by their position modulo this prime, in
# chunks small enough that the int64 sums cannot overflow (255 * 2^20 * 2^24 < 2^63).
_DIGEST_PRIME = 1048573
_DIGEST_CHUNK = 1 << 24


@dataclasses.dataclass
class DataMesh:
    '''This process's place in the mesh: `world` ranks, this one `rank` (its device index
    `local_rank` on its host), the backend, `group` (the ranks with this rank's seq, model
    and pipe coordinates: one a data row), under tensor parallelism (n_model > 1)
    `model_group` (the ranks of this rank's (data, seq, pipe) line), under sequence
    parallelism (n_seq > 1) `seq_group` (the ranks of its (data, model, pipe) line), under
    pipeline parallelism (n_pipe > 1) `pipe_group` (its (data, seq, model) line) and the
    two-rank hop groups `hop_prev` / `hop_next` to its neighbouring stages (None at the
    ends); `grad_group` (the ranks with its model and pipe coordinates; `group` itself
    when n_seq is 1) and `rep_group` (the ranks with its model coordinate; grad_group
    itself when n_pipe is 1). Rank r is at data coordinate r // (n_seq n_model n_pipe), seq
    coordinate (r // (n_model n_pipe)) % n_seq, model coordinate (r // n_pipe) % n_model
    and pipe coordinate r % n_pipe.'''
    world: int
    rank: int
    local_rank: int
    device: torch.device
    backend: str
    reason: str
    group: Any = None
    n_model: int = 1
    model_group: Any = None
    n_seq: int = 1
    seq_group: Any = None
    grad_group: Any = None
    n_pipe: int = 1
    pipe_group: Any = None
    hop_prev: Any = None
    hop_next: Any = None
    rep_group: Any = None

    def __post_init__(self):
        if self.grad_group is None:
            self.grad_group = self.group
        if self.rep_group is None:
            self.rep_group = self.grad_group

    @property
    def n_data(self) -> int:
        return self.world // self.row_ranks

    @property
    def data_rank(self) -> int:
        return self.rank // self.row_ranks

    @property
    def seq_rank(self) -> int:
        return (self.rank // (self.n_model * self.n_pipe)) % self.n_seq

    @property
    def model_rank(self) -> int:
        return (self.rank // self.n_pipe) % self.n_model

    @property
    def pipe_rank(self) -> int:
        return self.rank % self.n_pipe

    @property
    def row_ranks(self) -> int:
        '''How many ranks share one data row's rows (n_seq x n_model x n_pipe).'''
        return self.n_seq * self.n_model * self.n_pipe

    @property
    def seq_ranks(self) -> list:
        '''The global ranks of this rank's seq group, by seq coordinate.'''
        step = self.n_model * self.n_pipe
        base = self.data_rank * self.row_ranks + self.model_rank * self.n_pipe + self.pipe_rank
        return [base + s * step for s in range(self.n_seq)]

    @property
    def pipe_ranks(self) -> list:
        '''The global ranks of this rank's pipe group, by stage.'''
        base = self.rank - self.pipe_rank
        return [base + p for p in range(self.n_pipe)]

    def stage_blocks(self, depth: int) -> range:
        '''The global indices of the blocks this rank's stage holds: block_pspec's
        contiguous chunk of depth / n_pipe (every block without pipeline parallelism).'''
        if depth % self.n_pipe:
            raise ValueError(f'depth {depth} does not split into {self.n_pipe} pipe stages')
        k = depth // self.n_pipe
        return range(self.pipe_rank * k, (self.pipe_rank + 1) * k)

    def close(self):
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_mesh(mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    '''`mesh` when its model axis has more than one rank, else None.'''
    return mesh if mesh is not None and mesh.n_model > 1 else None


def sp_mesh(mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    '''`mesh` when its seq axis has more than one rank, else None.'''
    return mesh if mesh is not None and mesh.n_seq > 1 else None


def pp_mesh(mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    '''`mesh` when its pipe axis has more than one rank, else None.'''
    return mesh if mesh is not None and mesh.n_pipe > 1 else None


def rank_layout(world: int, model: int = 1, seq: int = 1, pipe: int = 1) -> np.ndarray:
    '''The global ranks on the (data, seq, model, pipe) grid: the device list reshaped as
    tcow_tpu/parallel/mesh.py:37 reshapes it.'''
    if world % (seq * model * pipe):
        raise ValueError(f'{world} ranks do not divide into {seq} seq x {model} model x '
                         f'{pipe} pipe shards')
    return np.arange(world).reshape(world // (seq * model * pipe), seq, model, pipe)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def _device_uuid(device: torch.device) -> str:
    return str(torch.cuda.get_device_properties(device).uuid)


def choose_backend(device: torch.device, uuids: Sequence[str]):
    '''(backend, reason) by the module's rule from this rank's device and every rank's
    device UUID (None on the CPU).'''
    if device.type != 'cuda':
        return 'gloo', 'CPU ranks'
    if len(set(uuids)) < len(uuids):
        return 'gloo', f'{len(uuids)} ranks share {len(set(uuids))} GPU(s): NCCL refuses ' \
                       'duplicate GPUs'
    return 'nccl', f'each of {len(uuids)} ranks has a GPU of its own'


def make_mesh(device='cuda', rank: Optional[int] = None, world: Optional[int] = None,
              local_rank: Optional[int] = None, addr: Optional[str] = None,
              port: Optional[int] = None, model: int = 1, seq: int = 1,
              pipe: int = 1) -> DataMesh:
    '''Joins the process group of `world` ranks as `rank` and returns its DataMesh. Every
    argument left None comes from the environment a launcher sets (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT: torchrun's, or train_torch.py --mesh_devices').
    On CUDA the rank runs on cuda:<local_rank>. The backend follows the module's rule.
    seq x model x pipe > 1 splits the world into world / (seq model pipe) data rows of
    seq x model x pipe ranks (rank_layout); every rank creates every group, in the same
    order: the data groups, the model groups, the seq groups, the gradient groups, the pipe
    groups, the hop groups, the replicated parameters' gradient groups.'''
    env = os.environ
    rank = int(env['RANK']) if rank is None else rank
    world = int(env['WORLD_SIZE']) if world is None else world
    local_rank = int(env.get('LOCAL_RANK', 0)) if local_rank is None else local_rank
    addr = env.get('MASTER_ADDR', '127.0.0.1') if addr is None else addr
    port = int(env['MASTER_PORT']) if port is None else port
    if not 0 <= rank < world:
        raise ValueError(f'rank {rank} is not in a world of {world}')
    layout = rank_layout(world, model, seq, pipe)            # (data, seq, model, pipe)
    device = torch.device(device)
    if device.type == 'cuda':
        device = torch.device('cuda', local_rank)
        torch.cuda.set_device(device)
    store = dist.TCPStore(addr, port, world, is_master=rank == 0, timeout=TIMEOUT)
    uuids = []
    if device.type == 'cuda':
        store.set(_UUID_KEY.format(rank), _device_uuid(device))
        uuids = [store.get(_UUID_KEY.format(r)).decode() for r in range(world)]
    backend, reason = choose_backend(device, uuids)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    if model == 1 and seq == 1 and pipe == 1:
        return DataMesh(world, rank, local_rank, device, backend, reason, dist.group.WORLD)
    n_data = world // (seq * model * pipe)
    d, s, m, p = (int(c) for c in np.argwhere(layout == rank)[0])
    new = lambda ranks: dist.new_group(np.asarray(ranks).reshape(-1).tolist())
    data_groups = {(i, j, k): new(layout[:, i, j, k])
                   for i in range(seq) for j in range(model) for k in range(pipe)}
    model_groups = {(a, i, k): new(layout[a, i, :, k]) for a in range(n_data)
                    for i in range(seq) for k in range(pipe)} if model > 1 else {}
    seq_groups = {(a, j, k): new(layout[a, :, j, k]) for a in range(n_data)
                  for j in range(model) for k in range(pipe)} if seq > 1 else {}
    grad_groups = ({(j, k): new(layout[:, :, j, k]) for j in range(model) for k in range(pipe)}
                   if seq > 1 and model * pipe > 1 else {})
    pipe_groups = {(a, i, j): new(layout[a, i, j, :]) for a in range(n_data)
                   for i in range(seq) for j in range(model)} if pipe > 1 else {}
    hop_groups = {(a, i, j, k): new(layout[a, i, j, k:k + 2]) for a in range(n_data)
                  for i in range(seq) for j in range(model)
                  for k in range(pipe - 1)} if pipe > 1 else {}
    rep_groups = ({j: new(layout[:, :, j, :]) for j in range(model)}
                  if pipe > 1 and model > 1 else {})
    grad_group = (None if seq == 1 else grad_groups[m, p] if model * pipe > 1
                  else dist.group.WORLD)
    rep_group = (None if pipe == 1 else rep_groups[m] if model > 1 else dist.group.WORLD)
    return DataMesh(world, rank, local_rank, device, backend, reason, data_groups[s, m, p],
                    model, model_groups.get((d, s, p)), seq, seq_groups.get((d, m, p)),
                    grad_group, pipe, pipe_groups.get((d, s, m)),
                    hop_groups.get((d, s, m, p - 1)), hop_groups.get((d, s, m, p)), rep_group)


# ---------------------------------------------------------------------------------------
# Rows of the global batch
# ---------------------------------------------------------------------------------------

def shard_rows(batch_size: int, rank: int, world: int, grad_accum: int = 1) -> np.ndarray:
    '''The global batch rows rank `rank` of `world` holds: [r B/W, (r+1) B/W), or under
    grad_accum = A > 1 microbatch i's rows [i B/A + r B/(A W), i B/A + (r+1) B/(A W)) for
    each i < A in turn, so that the rank's own A-way split gives its rows of JAX's
    microbatches (tcow_tpu/train/step.py:170-185). Raises ValueError when B/A does not
    divide by W.'''
    A = max(1, int(grad_accum))
    if batch_size % A or (batch_size // A) % world:
        raise ValueError(f'batch_size {batch_size} / grad_accum {A} must divide by the '
                         f'{world} ranks of the data axis')
    per_micro = batch_size // A
    n = per_micro // world
    return np.concatenate([np.arange(i * per_micro + rank * n, i * per_micro + (rank + 1) * n)
                           for i in range(A)])


def batch_sharding(mesh: Optional[DataMesh], leaf, grad_accum: int = 1):
    '''The rows of `leaf` this rank holds: None (all of it) for a scalar or without a
    mesh, else shard_rows of its leading axis by the data coordinate (the seq and model
    ranks of one data row hold the same rows).'''
    if mesh is None or np.ndim(leaf) == 0:
        return None
    return shard_rows(leaf.shape[0], mesh.data_rank, mesh.n_data, grad_accum)


def shard_batch(batch: Dict[str, Any], mesh: Optional[DataMesh], grad_accum: int = 1):
    '''This rank's rows of a global batch (numpy arrays or tensors): every leaf with a
    leading batch axis indexed by batch_sharding, scalars shared.'''
    out = {}
    for k, v in batch.items():
        rows = batch_sharding(mesh, v, grad_accum)
        if rows is not None and isinstance(v, torch.Tensor):
            rows = torch.as_tensor(rows, device=v.device)
        out[k] = v if rows is None else v[rows]
    return out


# ---------------------------------------------------------------------------------------
# Collectives of the global-batch losses
# ---------------------------------------------------------------------------------------

class _AllSum(torch.autograd.Function):
    '''Sum over the ranks. Every rank then computes the same global loss from the sums, so
    the gradient of the loss with respect to this rank's inputs is the incoming gradient
    itself: the backward passes it through, and the ranks' parameter gradients are summed
    after the backward (all_reduce_grads).'''

    @staticmethod
    def forward(ctx, x, group):
        y = x.detach().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllExtremum(torch.autograd.Function):
    '''Max (or min) over the ranks of each rank's local extremum `local`, differentiable as
    jnp.max of the global array: the gradient goes to the elements equal to the result,
    shared equally among all of them on every rank. `count` is how many local elements
    equal `local`; the local reduction's own backward shares its part among them. A vector
    `local` (one extremum a row) is reduced elementwise.'''

    @staticmethod
    def forward(ctx, local, count, op, group):
        y = local.detach().clone()
        dist.all_reduce(y, op=op, group=group)
        here = local.detach() == y
        mine = torch.where(here, count, torch.zeros_like(count)).to(torch.float64)
        total = mine.clone()
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
        ctx.save_for_backward((mine / total).to(local.dtype))
        return y

    @staticmethod
    def backward(ctx, g):
        share, = ctx.saved_tensors
        return g * share, None, None, None


def all_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    '''x summed over the ranks of `group` (x itself when group is None).'''
    return x if group is None else _AllSum.apply(x, group)


def all_sums(group, *xs):
    '''Each 0-d tensor of xs summed over the ranks, in one all_reduce; xs unchanged when
    group is None. The tensors must share a dtype.'''
    if group is None:
        return xs
    return tuple(all_sum(torch.stack(xs), group).unbind(0))


def _extremum(x: torch.Tensor, group, largest: bool, rows: bool) -> torch.Tensor:
    dims = tuple(range(1, x.dim())) if rows else None
    local = (x.amax(dims) if largest else x.amin(dims)) if rows else (
        x.max() if largest else x.min())
    if group is None:
        return local
    here = x.detach() == (local.detach().reshape(-1, *(1,) * (x.dim() - 1)) if rows
                          else local.detach())
    count = here.sum(dims) if rows else here.sum()
    op = dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN
    return _AllExtremum.apply(local, count, op, group)


def all_max(x: torch.Tensor, group=None, rows: bool = False) -> torch.Tensor:
    '''The largest element of x on every rank of `group` (x.max() when group is None);
    with rows, that of each x[i], a vector, in one all_reduce.'''
    return _extremum(x, group, True, rows)


def all_min(x: torch.Tensor, group=None, rows: bool = False) -> torch.Tensor:
    '''The smallest element of x on every rank of `group` (x.min() when group is None);
    with rows, that of each x[i], a vector, in one all_reduce.'''
    return _extremum(x, group, False, rows)


def all_reduce_grads(named_params: Iterable, mesh: DataMesh):
    '''Sums the .grad of the (name, parameter) pairs in place, one all_reduce of a flat
    buffer per dtype and group: over the gradient group (the ranks with this rank's model
    and pipe coordinates: the data rows and, under sequence parallelism, the seq ranks,
    whose gradients are each their tokens' part). Parameters the loss never reaches (no
    .grad) are left out; every rank of a group has the same ones, since the graph does not
    depend on the data. Under pipeline parallelism a block parameter's gradient is summed
    over the gradient group (the ranks of its stage), any other over rep_group (every
    stage): only the first and the last stage reach those, so each gets a zero .grad
    first, and the ranks' flat buffers keep one layout.'''
    pp = pp_mesh(mesh) is not None
    by_group: Dict[Any, list] = {}
    for name, p in named_params:
        block = is_block_param(name)
        if pp and not block and p.grad is None:
            p.grad = torch.zeros_like(p)
        if p.grad is not None:
            key = (pp and not block, p.grad.dtype)
            by_group.setdefault(key, []).append(p.grad)
    for (rep, _), grads in by_group.items():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM,
                        group=mesh.rep_group if rep else mesh.grad_group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


# ---------------------------------------------------------------------------------------
# The model axis: the layout of the sharded parameters
# ---------------------------------------------------------------------------------------

_NAME = re.compile(r'[A-Za-z_][A-Za-z_0-9]*|\d+')


def tp_dim(name: str) -> Optional[int]:
    '''The dim a parameter (or its optimizer moment) is sharded on over the model axis, None
    when it is replicated: block_pspec's rule (tcow_tpu/parallel/mesh.py:67-93) on the
    trailing names of `name`. In a port name ('backbone.blocks.3.attn.qkv.w', a (D, 3D)
    matrix) qkv.w, proj.w and fc2.w are sharded on dim 0 (their input rows), fc1.w on dim
    1 and fc1.b on dim 0 (their output columns). A name of the JAX layout, whose blocks are
    stacked on a leading axis ('backbone.blocks.attn.qkv.w', or an optax key path
    "[1][0].mu['backbone']['blocks']['attn']['qkv']['w']"), has its dim one further.'''
    parts = _NAME.findall(name)
    if len(parts) < 3:
        return None
    gp, parent, leaf = parts[-3:]
    dim = None
    if leaf == 'w' and gp in ('attn', 'temporal_attn') and parent in ('qkv', 'proj'):
        dim = 0
    elif gp == 'mlp' and parent == 'fc1':
        dim = 1 if leaf == 'w' else 0
    elif gp == 'mlp' and parent == 'fc2' and leaf == 'w':
        dim = 0
    if dim is None or 'blocks' not in parts:
        return None
    after = parts[parts.index('blocks') + 1:]
    return dim if after and after[0].isdigit() else dim + 1


_BLOCK = re.compile(r'^(.*\bblocks)\.(\d+)\.(.+)$')


def is_block_param(name: str) -> bool:
    '''Whether `name` (a port name, a JAX stacked name or an optax key path) lies under
    the backbone's blocks: the leaves block_pspec splits over the pipe axis.'''
    return 'blocks' in _NAME.findall(name)


def _stacked_block(name: str) -> bool:
    '''Whether `name` is a block leaf of the JAX layout, its blocks stacked on axis 0.'''
    parts = _NAME.findall(name)
    if 'blocks' not in parts:
        return False
    after = parts[parts.index('blocks') + 1:]
    return bool(after) and not after[0].isdigit()


def check_tp_widths(n_model: int, embed_dim: int, mlp_dim: int):
    '''Raises ValueError unless n_model model shards divide the width and the MLP width.'''
    for what, n in (('embed_dim', embed_dim), ('mlp_dim', mlp_dim)):
        if n % n_model:
            raise ValueError(f'tp_shards {n_model} does not divide {what} {n}')


def shard_params(full: Dict[str, torch.Tensor], mesh: Optional[DataMesh]):
    '''This rank's part of a full (one-process) state_dict: under pipeline parallelism
    its stage's blocks only, renumbered from 0 (mesh.stage_blocks), with the rest whole;
    then each tensor sharded by tp_dim sliced to this rank's model coordinate. `full`
    itself without a tensor- or pipeline-parallel mesh.'''
    tp, pp = tp_mesh(mesh), pp_mesh(mesh)
    if tp is None and pp is None:
        return full
    if pp is not None:
        blocks = [int(_BLOCK.match(n).group(2)) for n in full if _BLOCK.match(n)]
        depth = max(blocks) + 1 if blocks else 0
        stage = pp.stage_blocks(depth)
        kept = {}
        for name, t in full.items():
            m = _BLOCK.match(name)
            if m is None:
                kept[name] = t
            elif int(m.group(2)) in stage:
                kept[f'{m.group(1)}.{int(m.group(2)) - stage.start}.{m.group(3)}'] = t
        full = kept
    if tp is None:
        return full
    out = {}
    for name, t in full.items():
        dim = tp_dim(name)
        out[name] = t if dim is None else _part(t, mesh, dim)
    return out


def gather_state_dict(shards: Dict[str, torch.Tensor], mesh: Optional[DataMesh]):
    '''The full tensors of a state_dict of this rank's part (a collective every rank
    calls, in the same order): the inverse of shard_params; `shards` itself without a
    tensor- or pipeline-parallel mesh.'''
    tp, pp = tp_mesh(mesh), pp_mesh(mesh)
    if tp is not None:
        shards = {name: (t if tp_dim(name) is None else _gather(t.detach(), mesh, tp_dim(name)))
                  for name, t in shards.items()}
    if pp is None:
        return shards
    out = {name: t for name, t in shards.items() if not _BLOCK.match(name)}
    local = sorted((n for n in shards if _BLOCK.match(n)),
                   key=lambda n: (int(_BLOCK.match(n).group(2)), n))
    k = 1 + max((int(_BLOCK.match(n).group(2)) for n in local), default=-1)
    for dtype in sorted({shards[n].dtype for n in local}, key=str):
        names = [n for n in local if shards[n].dtype == dtype]
        flat = torch.cat([shards[n].detach().reshape(-1) for n in names])
        joined = _gather_over(flat, pp, pp.pipe_group, pp.n_pipe, 0).view(pp.n_pipe, -1)
        for stage in range(pp.n_pipe):
            offset = 0
            for n in names:
                t = shards[n]
                m = _BLOCK.match(n)
                out[f'{m.group(1)}.{stage * k + int(m.group(2))}.{m.group(3)}'] = \
                    joined[stage, offset:offset + t.numel()].view_as(t).to(t.device)
                offset += t.numel()
    return out


# ---------------------------------------------------------------------------------------
# The model axis: collectives of the row-parallel attention and the Megatron MLP
# ---------------------------------------------------------------------------------------

def _gather(t: torch.Tensor, mesh: DataMesh, dim: int) -> torch.Tensor:
    '''The model group's parts of `t` joined along `dim`, rank order (one
    all_gather_into_tensor, which moves the bytes as they are).'''
    return _gather_over(t, mesh, mesh.model_group, mesh.n_model, dim)


def _gather_over(t: torch.Tensor, mesh: DataMesh, group, n: int, dim: int) -> torch.Tensor:
    '''The parts of `t` on the n ranks of `group` joined along `dim`, rank order.'''
    part = _on_backend(t, mesh).contiguous()
    shape = list(part.shape)
    full = part.new_empty([n * shape[0]] + shape[1:])     # the parts one after another
    dist.all_gather_into_tensor(full, part, group=group)
    joined = full.view([n] + shape).movedim(0, dim)
    shape[dim] *= n
    return joined.reshape(shape).to(t.device)


def _part(t: torch.Tensor, mesh: DataMesh, dim: int) -> torch.Tensor:
    '''This rank's part of `t` along `dim` (its length / n_model, at the model coordinate).'''
    k = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_rank * k, k).contiguous()


def _model_sum(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    '''`t` summed over the model group (one all_reduce).'''
    y = _on_backend(t.contiguous().clone(), mesh)
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.model_group)
    return y.to(t.device)


def _model_sum_part(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    '''This rank's rows of `t` summed over the model group (one reduce_scatter_tensor,
    which moves 1 / n_model of an all_reduce's bytes out of each rank).'''
    x = _on_backend(t.contiguous(), mesh)
    y = x.new_empty((x.shape[0] // mesh.n_model,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(y, x, group=mesh.model_group)
    return y.to(t.device)


class _CopyToModel(torch.autograd.Function):
    '''Identity forward; the backward sums the gradient over the model group (each rank
    holds the gradient of its share of the computation that follows).'''

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _model_sum(g, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    '''Sum over the model group; the backward passes the (replicated) gradient through.'''

    @staticmethod
    def forward(ctx, x, mesh):
        return _model_sum(x, mesh)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherRows(torch.autograd.Function):
    '''Each rank's rows joined in rank order; the backward takes this rank's rows of the
    (replicated) gradient.'''

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _gather(x.contiguous(), mesh, 0)

    @staticmethod
    def backward(ctx, g):
        return _part(g, ctx.mesh, 0), None


class _ScatterRows(torch.autograd.Function):
    '''This rank's rows of a replicated tensor; the backward joins every rank's rows of
    the gradient.'''

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _part(x, mesh, 0)

    @staticmethod
    def backward(ctx, g):
        return _gather(g.contiguous(), ctx.mesh, 0), None


class _GatherWeight(torch.autograd.Function):
    '''The full weight from the model group's row shards; the backward sums each rank's
    gradient of the full weight over the model group into this rank's shard.'''

    @staticmethod
    def forward(ctx, w, mesh):
        ctx.mesh = mesh
        return _gather(w.detach().contiguous(), mesh, 0)

    @staticmethod
    def backward(ctx, g):
        return _model_sum_part(g, ctx.mesh), None


def copy_to_model(x, mesh: DataMesh):
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x, mesh: DataMesh):
    return _ReduceFromModel.apply(x, mesh)


def gather_rows(x, mesh: DataMesh):
    return _GatherRows.apply(x, mesh)


def scatter_rows(x, mesh: DataMesh):
    '''This rank's rows of x (R, ...); R must divide by n_model.'''
    if x.shape[0] % mesh.n_model:
        raise ValueError(f'{x.shape[0]} rows do not divide into {mesh.n_model} model shards')
    return _ScatterRows.apply(x, mesh)


def gather_weight(w, mesh: DataMesh):
    '''The full weight of the row shards w (rows / n_model, ...).'''
    return _GatherWeight.apply(w, mesh)


# ---------------------------------------------------------------------------------------
# Replicated state
# ---------------------------------------------------------------------------------------

def _on_backend(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    '''t where the backend can move it: nccl moves CUDA tensors only.'''
    return t.to(mesh.device) if mesh.backend == 'nccl' and t.device.type != 'cuda' else t


def replicate_tree(tensors: Iterable[torch.Tensor], mesh: DataMesh, group=None, src: int = 0):
    '''Overwrites every tensor, in order, with global rank `src`'s (a broadcast each over
    `group`, the data group when None).'''
    group = mesh.group if group is None else group
    for t in tensors:
        moved = _on_backend(t.detach(), mesh)
        dist.broadcast(moved, src=src, group=group)
        if moved is not t:
            with torch.no_grad():
                t.copy_(moved)


def _state_tensors(state):
    '''The tensors of a TrainState in a fixed order, each with whether it is a shard
    (its tp_dim slice under tensor parallelism, or its stage's block under pipeline
    parallelism): parameters and buffers, each parameter's optimizer state (its moments
    follow the parameter's layout, its step count is replicated), the drop-path
    generator's state, the counts.'''
    model, opt = state.model, state.optimizer
    mesh = getattr(model, 'mesh', None)
    tp, pp = tp_mesh(mesh) is not None, pp_mesh(mesh) is not None
    part = lambda n: (tp and tp_dim(n) is not None) or (pp and is_block_param(n))
    out = [(part(n), t) for n, t in sorted(model.state_dict(keep_vars=True).items())]
    for n, p in zip(opt.names, opt.params):
        st = opt.torch_opt.state.get(p, {})
        out += [(part(n) and st[k].shape == p.shape, st[k])
                for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    out += [(False, state.generator.get_state()),
            (False, torch.tensor([state.step, state.optimizer.count], dtype=torch.int64))]
    return out


def shard_state(state, mesh: DataMesh):
    '''Places a TrainState on every rank as rank 0 holds it (the JAX package instead has
    every process initialise the same seed, tcow_tpu/parallel/mesh.py:95-119): parameters,
    optimizer moments, the drop-path generator, the step and update counts, the
    replicated tensors from rank 0 over the world and each shard from the first rank of
    its gradient group (its model and pipe coordinates); then checks the replicas
    (check_replicas). Returns the state.'''
    tensors = _state_tensors(state)
    gen, counts = tensors[-2][1], tensors[-1][1]
    replicate_tree([t for s, t in tensors if not s], mesh, group=dist.group.WORLD)
    replicate_tree([t for s, t in tensors if s], mesh, group=mesh.grad_group,
                   src=mesh.model_rank * mesh.n_pipe + mesh.pipe_rank)
    state.generator.set_state(gen)
    state.step, state.optimizer.count = (int(c) for c in counts)
    check_replicas(state, mesh)
    return state


def tensor_digest(t: torch.Tensor) -> int:
    '''A digest of t's bytes: their sum weighted by position, on t's device.'''
    b = t.detach().contiguous().reshape(-1).view(torch.uint8)
    total = 0
    for lo in range(0, b.numel(), _DIGEST_CHUNK):
        part = b[lo:lo + _DIGEST_CHUNK].to(torch.int64)
        w = (torch.arange(lo, lo + part.numel(), device=b.device) % _DIGEST_PRIME) + 1
        total += int((part * w).sum())
    return (total * 1000003 + b.numel()) % (1 << 61)


def _digest(tensors) -> int:
    total = 0
    for i, t in enumerate(tensors):
        total = (total * 31 + tensor_digest(t) + i) % (1 << 61)
    return total


def state_digests(state):
    '''(replicated, shards): the digest of the TrainState's tensors that every rank holds
    alike (all of them without tensor or pipeline parallelism) and of this rank's shards
    (0 when none).'''
    tensors = _state_tensors(state)
    return (_digest([t for s, t in tensors if not s]), _digest([t for s, t in tensors if s]))


def state_digest(state) -> int:
    '''A digest of every tensor of a TrainState, the generator and the counts: that of its
    replicated tensors and of its shards, combined.'''
    return _combine(*state_digests(state))


def _combine(rep: int, shards: int) -> int:
    return (rep * 1000003 + shards) % (1 << 61)


def _same_everywhere(d: int, mesh: DataMesh, group, what: str):
    lo_hi = torch.tensor([d, -d], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(lo_hi, op=dist.ReduceOp.MAX, group=group)
    if int(lo_hi[0]) != d or int(lo_hi[1]) != -d:
        raise RuntimeError(f'rank {mesh.rank}: the {what} differ (digest {d}, largest '
                           f'{int(lo_hi[0])}, smallest {-int(lo_hi[1])})')


def check_replicas(state, mesh: DataMesh) -> int:
    '''Raises unless the replicated tensors of every rank's state have the same digest
    over the world, and the shards over each gradient group (the ranks with one model
    and pipe coordinate); returns state_digest(state).'''
    rep, shards = state_digests(state)
    _same_everywhere(rep, mesh, dist.group.WORLD, 'replicated tensors')
    _same_everywhere(shards, mesh, mesh.grad_group, 'shards')
    return _combine(rep, shards)


def _host(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    return np.array(t, copy=True)


def fetch_global(tree, mesh: Optional[DataMesh] = None):
    '''Host numpy copies of a tree (nested dicts, or flat dicts keyed by path) of tensors
    or arrays. Under tensor parallelism the leaves tp_dim names sharded (by their path)
    are gathered over the model group, under pipeline parallelism the stacked block leaves
    over the pipe group on their leading axis, into the one-process layout, so every rank
    must call it, in the same order (a checkpoint's writer then writes alone); without
    either every rank holds the whole state and no collective is made.'''
    tp, pp = tp_mesh(mesh), pp_mesh(mesh)

    def fetch(node, path):
        if isinstance(node, dict):
            return {k: fetch(v, f'{path}.{k}') for k, v in node.items()}
        dim = None if tp is None else tp_dim(path)
        stage = pp is not None and _stacked_block(path)
        if dim is None and not stage:
            return _host(node)
        t = node if isinstance(node, torch.Tensor) else torch.from_numpy(np.asarray(node))
        t = t.detach().contiguous()
        if dim is not None:
            t = _gather(t, tp, dim)
        if stage:
            t = _gather_over(t, pp, pp.pipe_group, pp.n_pipe, 0)
        return _host(t)
    return fetch(tree, '')


def gather_objects(obj, mesh: DataMesh) -> list:
    '''Every rank's picklable `obj`, in rank order, on every rank (a broadcast from each
    rank in turn, over the world).'''
    out = []
    for src in range(mesh.world):
        box = [obj if src == mesh.rank else None]
        dist.broadcast_object_list(box, src=src,
                                   device=mesh.device if mesh.backend == 'nccl' else None)
        out.append(box[0])
    return out


def broadcast_one_to_all(flag: bool, mesh: Optional[DataMesh]) -> bool:
    '''Rank 0's flag on every rank of the world (the flag itself without a mesh).'''
    if mesh is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh.device)
    dist.broadcast(t, src=0)
    return bool(t.item())
