'''
Optimizer and learning-rate schedule: the port of tcow_tpu/train/optim.py.

`make_optimizer` returns an `OptimizerSpec` (what optax's GradientTransformation is to the
JAX package); `spec.init(params)` builds the `Optimizer` that owns the torch optimizer,
the schedule and the count of applied updates. Global-norm clipping is written as
optax.clip_by_global_norm writes it: g * max_norm / norm only when norm >= max_norm, with
no epsilon (torch.nn.utils.clip_grad_norm_ divides by norm + 1e-6). The learning rate of
update n is schedule(n), n counting the updates actually applied, as optax counts them in
its state (an update skipped for a non-finite loss does not advance it).
'''

import dataclasses
from typing import Callable, Iterable, Optional

import torch

Schedule = Callable[[int], float]


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


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    '''sqrt of the sum of squares of every element, in f32 (optax.global_norm).'''
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    name: str
    schedule: Schedule
    gradient_clip: float

    def init(self, params: Iterable[torch.nn.Parameter]) -> 'Optimizer':
        return Optimizer(self, list(params))


class Optimizer:
    '''A torch optimizer over `params`, its schedule and its clipping.'''

    def __init__(self, spec: OptimizerSpec, params):
        self.spec = spec
        self.params = params
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

    def step(self, grad_norm: Optional[torch.Tensor] = None):
        '''Clips the gradients of self.params (grad_norm: their global norm, computed when
        None) and applies one update at the scheduled rate. A parameter the loss does not
        reach gets a zero gradient, so its moments and weight decay move as in optax.'''
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        self.clip_(grads, global_norm(grads) if grad_norm is None else grad_norm)
        for group in self.torch_opt.param_groups:
            group['lr'] = self.spec.schedule(self.count)
        self.torch_opt.step()
        self.count += 1


def make_optimizer(optimizer: str = 'adamw', learn_rate: float = 1e-4, lr_decay: float = 0.3,
                   num_epochs: int = 70, steps_per_epoch: int = 1,
                   gradient_clip: float = 0.3) -> OptimizerSpec:
    '''sgd / adam / adamw at learn_rate with the multi-step decay and global-norm clipping
    (clipping off when gradient_clip <= 0). LAMB is not ported yet.'''
    if optimizer == 'lamb':
        raise NotImplementedError('the LAMB optimizer is not ported yet')
    if optimizer not in ('sgd', 'adam', 'adamw'):
        raise ValueError(f'unknown optimizer: {optimizer}')
    return OptimizerSpec(optimizer,
                         multistep_schedule(learn_rate, lr_decay, num_epochs, steps_per_epoch),
                         gradient_clip)
