'''
Data parallelism on torch.distributed: the counterpart of tcow_tpu/parallel/mesh.py for its
data axis (the reference's torch.nn.DataParallel, its train.py:222-223).

In the JAX package the batch is sharded over the mesh's 'data' axis inside one jitted
program, so every loss reduction covers the global batch. Here each rank is a process that
holds its rows of the global batch, and the global-batch math is written out:
  - make_mesh joins the process group and returns a DataMesh (world size, rank, local
    rank, device, backend, group);
  - shard_batch / shard_rows pick this rank's rows, interleaved per microbatch under
    grad_accum so that microbatch i is JAX's global rows [i B/A, (i+1) B/A);
  - the losses and metric sums reduce over mesh.group with all_sum / all_max / all_min
    (objectives/losses.py), whose gradient is this rank's share of the global gradient;
  - all_reduce_grads sums those shares with one all_reduce per dtype after the backward;
  - replicate_tree / shard_state broadcast rank 0's state and check_replicas compares a
    digest of it across ranks;
  - broadcast_one_to_all carries rank 0's stop flag (the driver's preemption check), and
    gather_objects every rank's loader state into rank 0's checkpoint.

Backend rule, decided once by make_mesh and logged by its caller: gloo on the CPU; on CUDA,
nccl when every rank has a device of its own, gloo when two ranks share one physical GPU
(the ranks publish their device UUIDs through the rendezvous store; NCCL fails on
duplicate GPUs). A backend that fails to start raises: nothing is retried on another one.
Only all_reduce and broadcast are used, the collectives gloo moves for CUDA tensors.

Not here: block_pspec / tp_pspec (tensor and pipeline parallelism, ROADMAP.md section 1
item 7), and _relay_probe / shard_state_staged, which pace uploads over the TPU host's
relay (tcow_tpu/parallel/mesh.py:141-239): the port places the state by broadcast.
'''

import dataclasses
import datetime
import os
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
    '''The data axis of this process: `world` ranks, this one `rank` (its device index
    `local_rank` on its host), the backend and the process group.'''
    world: int
    rank: int
    local_rank: int
    device: torch.device
    backend: str
    reason: str
    group: Any = None

    def close(self):
        if dist.is_initialized():
            dist.destroy_process_group()


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
              port: Optional[int] = None) -> DataMesh:
    '''Joins the process group of `world` ranks as `rank` and returns its DataMesh. Every
    argument left None comes from the environment a launcher sets (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT: torchrun's, or train_torch.py --mesh_devices').
    On CUDA the rank runs on cuda:<local_rank>. The backend follows the module's rule.'''
    env = os.environ
    rank = int(env['RANK']) if rank is None else rank
    world = int(env['WORLD_SIZE']) if world is None else world
    local_rank = int(env.get('LOCAL_RANK', 0)) if local_rank is None else local_rank
    addr = env.get('MASTER_ADDR', '127.0.0.1') if addr is None else addr
    port = int(env['MASTER_PORT']) if port is None else port
    if not 0 <= rank < world:
        raise ValueError(f'rank {rank} is not in a world of {world}')
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
    return DataMesh(world, rank, local_rank, device, backend, reason, dist.group.WORLD)


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
    mesh, else shard_rows of its leading axis.'''
    if mesh is None or np.ndim(leaf) == 0:
        return None
    return shard_rows(leaf.shape[0], mesh.rank, mesh.world, grad_accum)


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


def all_reduce_grads(params: Iterable[torch.nn.Parameter], mesh: DataMesh):
    '''Sums the .grad of `params` over the ranks in place: one all_reduce of a flat
    buffer per dtype. Parameters the loss never reaches (no .grad) are left out; every rank
    has the same ones, since the graph does not depend on the data.'''
    by_dtype: Dict[torch.dtype, list] = {}
    for p in params:
        if p.grad is not None:
            by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()


# ---------------------------------------------------------------------------------------
# Replicated state
# ---------------------------------------------------------------------------------------

def _on_backend(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    '''t where the backend can move it: nccl moves CUDA tensors only.'''
    return t.to(mesh.device) if mesh.backend == 'nccl' and t.device.type != 'cuda' else t


def replicate_tree(tensors: Iterable[torch.Tensor], mesh: DataMesh):
    '''Overwrites every tensor, in order, with rank 0's (a broadcast each).'''
    for t in tensors:
        moved = _on_backend(t.detach(), mesh)
        dist.broadcast(moved, src=0, group=mesh.group)
        if moved is not t:
            with torch.no_grad():
                t.copy_(moved)


def _state_tensors(state):
    '''The tensors of a TrainState in a fixed order: parameters and buffers, each
    parameter's optimizer state, the drop-path generator's state, the counts.'''
    model, opt = state.model, state.optimizer
    out = [t for _, t in sorted(model.state_dict(keep_vars=True).items())]
    for p in opt.params:
        st = opt.torch_opt.state.get(p, {})
        out += [st[k] for k in sorted(st) if isinstance(st[k], torch.Tensor)]
    return out


def shard_state(state, mesh: DataMesh):
    '''Places a TrainState on every rank as rank 0 holds it (the JAX package instead has
    every process initialise the same seed, tcow_tpu/parallel/mesh.py:95-119): parameters,
    optimizer moments, the drop-path generator, the step and update counts; then checks
    the replicas (check_replicas). Returns the state.'''
    replicate_tree(_state_tensors(state), mesh)
    gen = state.generator.get_state()
    counts = torch.tensor([state.step, state.optimizer.count], dtype=torch.int64)
    replicate_tree([gen, counts], mesh)
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


def state_digest(state) -> int:
    '''tensor_digest of every tensor of a TrainState, the generator and the counts.'''
    tensors = _state_tensors(state) + [state.generator.get_state(),
                                       torch.tensor([state.step, state.optimizer.count])]
    total = 0
    for i, t in enumerate(tensors):
        total = (total * 31 + tensor_digest(t) + i) % (1 << 61)
    return total


def check_replicas(state, mesh: DataMesh) -> int:
    '''Raises unless every rank's state has the same digest; returns it.'''
    d = state_digest(state)
    lo_hi = torch.tensor([d, -d], dtype=torch.int64, device=mesh.device)
    dist.all_reduce(lo_hi, op=dist.ReduceOp.MAX, group=mesh.group)
    if int(lo_hi[0]) != d or int(lo_hi[1]) != -d:
        raise RuntimeError(f'rank {mesh.rank}: the replicas differ (digest {d}, largest '
                           f'{int(lo_hi[0])}, smallest {-int(lo_hi[1])})')
    return d


def fetch_global(tree):
    '''Host numpy copies of a tree (nested dicts) of tensors. Under data parallelism every
    rank holds the whole state, so no collective is needed; a checkpoint's writer (rank
    0) calls it alone.'''
    if isinstance(tree, dict):
        return {k: fetch_global(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy().copy()
    return np.array(tree, copy=True)


def gather_objects(obj, mesh: DataMesh) -> list:
    '''Every rank's picklable `obj`, in rank order, on every rank (a broadcast from each
    rank in turn).'''
    out = []
    for src in range(mesh.world):
        box = [obj if src == mesh.rank else None]
        dist.broadcast_object_list(box, src=src, group=mesh.group,
                                   device=mesh.device if mesh.backend == 'nccl' else None)
        out.append(box[0])
    return out


def broadcast_one_to_all(flag: bool, mesh: Optional[DataMesh]) -> bool:
    '''Rank 0's flag on every rank (the flag itself without a mesh).'''
    if mesh is None:
        return bool(flag)
    t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=mesh.device)
    dist.broadcast(t, src=0, group=mesh.group)
    return bool(t.item())
