'''
The driver of 'train' mixes: the port's training step (train/step.py:make_train_step with
its AdamW from train/optim.py) on a pool of seeded batches, steps back to back.

Set-up builds one training state from the benchmark's weights and runs its first three
steps through the window's own call on pool batches 0, 1 and 2 (they build and warm every
kernel); the window then goes on with that same state from batch 3, cycling the pool.
After the window the program's state is freed and the reference runs the same three steps
from the same weights, batches and drop-path draws (core/correct.py says what is compared).
'''

import gc
import sys
import time
from typing import Dict

import torch

from perfbench.core import correct, flops, traffic
from perfbench.core import trace as trace_lib
from perfbench.core.clock import mark, print_sixths, sync
from perfbench.core.program import seeker_config
from perfbench.core.weights import make_weights, sub_seeds
from perfbench.reference import seeker as ref

CHECKED_STEPS = 3


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    '''One run of a training cell: the parts of the result line ('e2e' by quantity,
    'readings', 'attempted', 'failed', 'peak') and the record of the trace.'''
    from tcow_tpu_torch.models.mask_tracker import MaskTracker
    from tcow_tpu_torch.objectives.losses import LossConfig
    from tcow_tpu_torch.train import optim
    from tcow_tpu_torch.train import step as step_lib

    conf, mix = cell.config, cell.traffic
    model_cfg, tr = conf['model'], conf['train']
    dtype = getattr(torch, conf['precision']['compute'])
    seeds = sub_seeds(seed)
    seeker = seeker_config(model_cfg, tr, dtype)
    shapes = ref.param_shapes(model_cfg)
    model = MaskTracker(seeker, device=device)
    model.load_state_dict(make_weights(shapes, seeds['weights'], device, conf['init']))
    if tr['optimizer'] != 'adamw':
        raise ValueError('the reference implements AdamW alone')
    tx = optim.make_optimizer('adamw', learn_rate=tr['learn_rate'], lr_decay=tr['lr_decay'],
                              num_epochs=tr['num_epochs'],
                              steps_per_epoch=tr['steps_per_epoch'],
                              gradient_clip=tr['gradient_clip'])
    mark('weights on the card', t_start)
    state = step_lib.TrainState(model, tx.init(model.named_parameters()),
                                torch.Generator().manual_seed(seeds['drop_path']))
    mark('optimizer built', t_start)
    step_cfg = step_lib.StepConfig(seeker=seeker, loss=LossConfig(**tr['loss']),
                                   num_queries=mix['queries'])
    train_step = step_lib.make_train_step(step_cfg)
    pool = traffic.pool(traffic.train_batch, mix, seeds['traffic'], device)
    mark('traffic on the card', t_start)
    progress = tr['progress']
    skipped = [0]

    def step(batch):
        _, aux = train_step(state, batch, progress)
        skipped[0] += int(aux['skipped_nonfinite'])
        return aux

    # Set-up: the first three steps, which the reference follows.
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    named = list(model.named_parameters())
    losses, grad, gnorm = [], None, None
    for i in range(CHECKED_STEPS):
        aux = step(pool[i % len(pool)])
        losses.append(float(aux['total_seeker']))
        mark(f'checked step {i + 1}', t_start)
        if i == 0:
            gnorm = float(aux['grad_norm'])
            opt_state = state.optimizer.torch_opt.state
            b1 = tr['betas'][0]
            grad = {n: (float(opt_state[p]['exp_avg'].double().norm()) / (1.0 - b1)
                        if p in opt_state and 'exp_avg' in opt_state[p] else 0.0)
                    for n, p in named}
    change = {n: float((p.detach() - params0[n]).double().norm()) for n, p in named}
    del params0
    skipped[0] = 0
    sync(device)
    setup_s = time.perf_counter() - t_start

    # The window: steps back to back, cycling the pool from batch 3.
    n = 0
    ends = []
    t0 = time.perf_counter()
    while True:
        step(pool[(CHECKED_STEPS + n) % len(pool)])
        n += 1
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    sync(device)
    window_s = time.perf_counter() - t0
    print_sixths('ms a step', ends)

    record = None
    if trace:
        k = [0]

        def traced():
            with torch.profiler.record_function('bench.train_step'):
                step(pool[(CHECKED_STEPS + n + k[0]) % len(pool)])
            k[0] += 1

        record = trace_lib.profile(traced, mix['trace_units'], lambda: sync(device))
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == 'cuda' else 0)
    rows = mix['clips'] * mix['queries']
    del state, model, train_step, named, tx
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    readings = reference_readings(cell, seeds, pool, device,
                                  {'losses': losses, 'grad': grad, 'change': change,
                                   'gnorm': gnorm})
    print(f'[perfbench] reference {time.perf_counter() - t_ref:.2f} s', file=sys.stderr)
    e2e = {'train_clips_per_s': n * mix['clips'] / window_s, 'setup_s': setup_s}
    if record is not None:
        attn = flops.attention_core(model_cfg, rows, train=True)
        gemm = flops.gemms(model_cfg, rows, train=True)
        record.update(kind='train', units=mix['trace_units'], peak_bytes=peak,
                      window={'units': n, 'seconds': window_s},
                      needed={'flops': flops.step_flops(model_cfg, rows),
                              'attn_flops': attn[0], 'attn_bytes': attn[1],
                              'gemm_flops': gemm[0], 'gemm_bytes': gemm[1]})
    return {'e2e': e2e, 'readings': readings, 'attempted': n, 'failed': skipped[0],
            'peak': peak, 'record': record}


def reference_run(cell, seeds, pool, device, prec=None) -> Dict:
    '''The reference's three steps from the benchmark's weights, the pool's first three
    batches and the drop-path draws of the seed: {'losses', 'grad', 'change', 'gnorm'} as
    the program's readings are kept. prec: the reference's precision (f32 by default; the
    control's fp8).'''
    conf = cell.config
    ref.f32_matmuls()
    shapes = ref.param_shapes(conf['model'])
    params = ref.as_params(make_weights(shapes, seeds['weights'], device, conf['init']))
    start = {n: p.clone() for n, p in params.items()}
    batches = [pool[i % len(pool)] for i in range(CHECKED_STEPS)]
    gen = torch.Generator().manual_seed(seeds['drop_path'])
    losses, grad, gnorm = ref.train_steps(params, conf['model'], conf['train'], batches, gen,
                                          prec)
    change = {n: float((params[n] - start[n]).double().norm()) for n in params}
    del params, start, batches
    gc.collect()
    return {'losses': losses, 'grad': grad, 'change': change, 'gnorm': gnorm}


def reference_readings(cell, seeds, pool, device, prog: Dict) -> Dict[str, float]:
    '''The gaps of the program's readings `prog` from the reference's.'''
    return correct.train_readings(prog, reference_run(cell, seeds, pool, device))


def control_readings(cell, seed: int, device) -> Dict[str, float]:
    '''The control's readings: the reference in fp8 put in the program's place.'''
    seeds = sub_seeds(seed)
    pool = traffic.pool(traffic.train_batch, cell.traffic, seeds['traffic'], device)
    low = reference_run(cell, seeds, pool, device, ref.Precision('fp8'))
    return correct.train_readings(low, reference_run(cell, seeds, pool, device))
