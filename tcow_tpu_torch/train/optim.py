'''
Optimizer and learning-rate schedule: the port of tcow_tpu/train/optim.py.

`make_optimizer` returns an `OptimizerSpec` (what optax's GradientTransformation is to the
JAX package); `spec.init(model.named_parameters())` builds the `Optimizer` that owns the
torch optimizer, the schedule and the count of applied updates. Global-norm clipping is
written as optax.clip_by_global_norm writes it: g * max_norm / norm only when norm >=
max_norm, with no epsilon (torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6). The learning rate of
update n is schedule(n), n counting the updates actually applied, as optax counts them in
its state (an update skipped for a non-finite loss does not advance it).

Under tensor parallelism each rank's optimizer holds the moments of its parameters'
shards (AdamW is elementwise, so its update of a shard is the shard of its update), and
the norms that span a tensor are the logical tensor's: the squares of the sharded
parameters summed over the model group, a replicated parameter counted once (the global
norm of clipping and of grad_norm, LAMB's per-leaf ||p|| and ||u||). Under pipeline
parallelism each rank's optimizer holds the moments of its stage's blocks and of every
parameter outside the blocks (one copy on each rank, updated alike); a norm counts each
stage's block tensors once, by a sum over the pipe group, and the others once.
'''

import dataclasses
from typing import Callable, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

from tcow_tpu_torch.parallel.mesh import is_block_param, pp_mesh, tp_dim, tp_mesh
from tcow_tpu_torch.weights import jax_leaf_name

Schedule = Callable[[int], float]
OPTIMIZERS = ('sgd', 'adam', 'adamw', 'lamb')
# optax.lamb's defaults, which optim.py:38-39 of the JAX package keeps.
LAMB_B1, LAMB_B2, LAMB_EPS = 0.9, 0.999, 1e-6


def multistep_schedule(learn_rate: float, lr_decay: float, num_epochs: int,
                       steps_per_epoch: int) -> Schedule:
    '''MultiStepLR at 2/5, 3/5 and 4/5 of the epochs: the rate of update `count` (from 0)
    is learn_rate times lr_decay for every milestone step <= count. Repeated milestones
    (few epochs) compound, as in torch MultiStepLR and optim.py:15-23.'''
    steps = [m * steps_per_epoch for m in
             ((num_epochs * 2) // 5, (num_epochs * 3) // 5, (num_epochs * 4) // 5)]

    def schedule(count: int) -> float:
        lr = learn_rate
        for step in steps:
            if count >= step:
                lr *= lr_decay
        return lr

    return schedule


def global_norm(tensors: Iterable[torch.Tensor], sharded: Optional[Iterable[bool]] = None,
                group=None, staged: Optional[Iterable[bool]] = None,
                pipe_group=None) -> torch.Tensor:
    '''sqrt of the sum of squares of every element, in f32 (optax.global_norm). With a
    model group, the tensors flagged in `sharded` are this rank's shards of larger ones:
    their squares are summed over the group. With a pipe group, the tensors flagged in
    `staged` are this stage's part of the blocks: their squares (the sharded ones' summed
    over the model group first) are summed over the pipe group. The others are counted
    once.'''
    tensors = list(tensors)
    if group is None and pipe_group is None:
        return torch.linalg.vector_norm(torch.stack(
            torch._foreach_norm([t.float() for t in tensors])))
    sharded = list(sharded) if sharded is not None else [False] * len(tensors)
    staged = list(staged) if staged is not None else [False] * len(tensors)

    def squares(ts):
        if not ts:
            return torch.zeros((), dtype=torch.float32, device=tensors[0].device)
        return torch.stack(torch._foreach_norm([t.float() for t in ts])).square().sum()
    parts = squares([t for t, s in zip(tensors, sharded) if s and group is not None])
    if group is not None:
        dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=group)
    local = [not (s and group is not None) for s in sharded]
    if pipe_group is not None:
        parts = parts + squares([t for t, l, p in zip(tensors, local, staged) if l and p])
        dist.all_reduce(parts, op=dist.ReduceOp.SUM, group=pipe_group)
        local = [l and not p for l, p in zip(local, staged)]
    return torch.sqrt(parts + squares([t for t, l in zip(tensors, local) if l]))


class Lamb(torch.optim.Optimizer):
    '''optax.lamb (optax 0.2.6; optim.py:38-39 of the JAX package builds it with its
    defaults): Adam's bias-corrected moments with b1 LAMB_B1, b2 LAMB_B2, eps LAMB_EPS,
    eps_root 0 and no weight decay, then each leaf's update scaled by its trust ratio
    ||p|| / ||u|| (1 where either norm is 0, as for every bias at init), then by -lr. A
    leaf is one param group: the tensors that JAX stacks into one array (a block parameter
    of every block) share one ratio, from the norms over all of them. Each group is
    updated by foreach ops. The moments and the count sit in each parameter's state under
    torch.optim.Adam's names (exp_avg, exp_avg_sq, step), so checkpoints read both
    optimizers alike. A group flagged 'sharded' holds this rank's shards of its leaf: its
    norms are summed over `group`, the model group; one flagged 'staged' this stage's
    blocks of its leaf: its norms are summed over `pipe_group` too.'''

    def __init__(self, params, lr: float, group=None, pipe_group=None):
        super().__init__(params, dict(lr=lr, sharded=False, staged=False))
        self.model_group = group
        self.pipe_group = pipe_group

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            params = group['params']
            states = [self.state[p] for p in params]
            for p, state in zip(params, states):
                if not state:
                    state['step'] = torch.zeros((), dtype=torch.float32)
                    state['exp_avg'] = torch.zeros_like(p)
                    state['exp_avg_sq'] = torch.zeros_like(p)
                state['step'] += 1
            count = float(states[0]['step'])
            grads = [p.grad for p in params]
            mus = [s['exp_avg'] for s in states]
            nus = [s['exp_avg_sq'] for s in states]
            torch._foreach_mul_(mus, LAMB_B1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - LAMB_B1))
            torch._foreach_mul_(nus, LAMB_B2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads),
                                                        1 - LAMB_B2))
            denom = torch._foreach_div(nus, 1 - LAMB_B2 ** count)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, LAMB_EPS)
            updates = torch._foreach_div(torch._foreach_div(mus, 1 - LAMB_B1 ** count), denom)
            flags = [group['sharded']] * len(params)
            model_group = self.model_group if group['sharded'] else None
            pipe_group = self.pipe_group if group['staged'] else None
            stage = [group['staged']] * len(params)
            p_norm = global_norm(params, flags, model_group, stage, pipe_group)
            u_norm = global_norm(updates, flags, model_group, stage, pipe_group)
            ratio = torch.where((p_norm == 0) | (u_norm == 0), torch.ones_like(p_norm),
                                p_norm / u_norm)
            torch._foreach_mul_(updates, ratio * -group['lr'])
            torch._foreach_add_(params, updates)


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str
    schedule: Schedule
    gradient_clip: float

    def init(self, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
             mesh=None) -> 'Optimizer':
        return Optimizer(self, named_params, mesh)


class Optimizer:
    '''A torch optimizer over the parameters of `named_params` ((name, parameter) pairs,
    model.named_parameters()), its schedule and its clipping. The names place each
    parameter in the JAX package's tree (weights.py): LAMB's trust ratio and the optax
    state of a checkpoint go by them. Under a tensor-parallel `mesh` (parallel/mesh.py)
    the parameters tp_dim names sharded are this rank's shards; under a pipeline-parallel
    one the block parameters are this stage's (`staged`).'''

    def __init__(self, spec: OptimizerSpec, named_params, mesh=None):
        self.spec = spec
        self.names, self.params = map(list, zip(*named_params))
        tp, pp = tp_mesh(mesh), pp_mesh(mesh)
        self.mesh = mesh if tp is not None or pp is not None else None
        self.model_group = None if tp is None else tp.model_group
        self.pipe_group = None if pp is None else pp.pipe_group
        self.sharded = [tp is not None and tp_dim(n) is not None for n in self.names]
        self.staged = [pp is not None and is_block_param(n) for n in self.names]
        params = self.params
        lr = spec.schedule(0)
        if spec.name == 'sgd':
            self.torch_opt = torch.optim.SGD(params, lr=lr)
        elif spec.name == 'adam':
            self.torch_opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
        elif spec.name == 'adamw':
            # Same update as optax.adamw(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01),
            # decay on every parameter.
            self.torch_opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                               weight_decay=0.01)
        elif spec.name == 'lamb':
            leaves = {}
            for n, p in zip(self.names, params):
                leaves.setdefault(jax_leaf_name(n), []).append(p)
            self.torch_opt = Lamb([{'params': ps, 'sharded': tp is not None
                                    and tp_dim(leaf) is not None,
                                    'staged': pp is not None and is_block_param(leaf)}
                                   for leaf, ps in leaves.items()], lr=lr,
                                  group=self.model_group, pipe_group=self.pipe_group)
        else:
            raise ValueError(f'unknown optimizer: {spec.name}')
        self.count = 0   # updates applied

    def clip_(self, grads, norm: torch.Tensor):
        '''Scales grads in place to global norm gradient_clip when norm >= gradient_clip
        (optax.clip_by_global_norm), with no host read.'''
        max_norm = self.spec.gradient_clip
        if max_norm <= 0.0:
            return
        keep = norm < max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, (g / norm) * max_norm))

    def grad_norm(self) -> torch.Tensor:
        '''The global norm of the gradients of self.params that have one (of the logical
        tensors under tensor parallelism, of every stage's blocks under pipeline
        parallelism).'''
        have = [(p.grad, s, t) for p, s, t in zip(self.params, self.sharded, self.staged)
                if p.grad is not None]
        return global_norm([g for g, _, _ in have], [s for _, s, _ in have],
                           self.model_group, [t for _, _, t in have], self.pipe_group)

    def step(self, grad_norm: Optional[torch.Tensor] = None):
        '''Clips the gradients of self.params (grad_norm: their global norm, computed when
        None) and applies one update at the scheduled rate. A parameter the loss does not
        reach gets a zero gradient, so its moments and weight decay move as in optax.'''
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        self.clip_(grads, self.grad_norm() if grad_norm is None else grad_norm)
        for group in self.torch_opt.param_groups:
            group['lr'] = self.spec.schedule(self.count)
        self.torch_opt.step()
        self.count += 1


def make_optimizer(optimizer: str = 'adamw', learn_rate: float = 1e-4, lr_decay: float = 0.3,
                   num_epochs: int = 70, steps_per_epoch: int = 1,
                   gradient_clip: float = 0.3) -> OptimizerSpec:
    '''sgd / adam / adamw / lamb at learn_rate with the multi-step decay and global-norm
    clipping (clipping off when gradient_clip <= 0).'''
    if optimizer not in OPTIMIZERS:
        raise ValueError(f'unknown optimizer: {optimizer}')
    return OptimizerSpec(optimizer,
                         multistep_schedule(learn_rate, lr_decay, num_epochs, steps_per_epoch),
                         gradient_clip)
