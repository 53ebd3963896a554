'''
The driver of 'infer' mixes: the port's InferenceEngine.run_plugin (evaluation/inference.py), one
client in a closed loop, each request timed from the call with float32 numpy inputs in
pageable memory to the return of its numpy outputs. Requests cycle a pool of seeded
requests.

A sample of the window's requests, drawn from the seed (a reservoir of
mix['check_requests'] among all of them, the last always added), keeps the program's
answers; after the window the reference answers the same requests and core/correct.py
compares the masks, the flags and the per-clip metric sums.
'''

import gc
import sys
import time
from typing import Dict

import numpy as np
import torch

from perfbench.core import correct, flops, traffic
from perfbench.core import trace as trace_lib
from perfbench.core.clock import mark, print_sixths, sync
from perfbench.core.program import seeker_config
from perfbench.core.weights import make_weights, sub_seeds
from perfbench.reference import seeker as ref


def answer(results):
    '''(masks (B, C, T, H, W), flags (B, T, F), per-clip metric sums) of run_plugin's
    per-clip results.'''
    masks = np.concatenate([m['output_mask'] for m, _ in results])
    flags = np.concatenate([m['output_flags'] for m, _ in results])
    metrics = [{(f'sum_{k[5:]}' if k.startswith('mean_') else k):
                (v * max(lr['metrics'][f'count_{k[5:]}'], 0) if k.startswith('mean_') else v)
                for k, v in lr['metrics'].items()} for _, lr in results]
    return masks, flags, metrics


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Dict:
    '''One run of a request cell, as drivers/train.run returns it.'''
    from tcow_tpu_torch.evaluation.inference import InferenceEngine
    from tcow_tpu_torch.weights import params_to_jax

    conf, mix = cell.config, cell.traffic
    model_cfg = conf['model']
    seeds = sub_seeds(seed)
    seeker = seeker_config(model_cfg, None, getattr(torch, conf['precision']['compute']))
    weights = make_weights(ref.param_shapes(model_cfg), seeds['weights'], device, conf['init'])
    engine = InferenceEngine(params_to_jax(weights), seeker, device=device)
    del weights
    mark('weights on the card', t_start)
    requests = traffic.pool(traffic.infer_request, mix, seeds['traffic'], device)
    mark('traffic made', t_start)

    def call(i):
        return engine.run_plugin(*requests[i % len(requests)])

    for i in range(mix['warmup']):
        call(i)
        mark(f'warm-up request {i + 1}', t_start)
    sync(device)
    setup_s = time.perf_counter() - t_start

    rng = np.random.default_rng(seeds['sample'])
    kept, latencies = [], []
    n = 0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        results = call(mix['warmup'] + n)
        latencies.append(time.perf_counter() - t)
        # Reservoir sample of the answers, drawn from the seed.
        if len(kept) < mix['check_requests']:
            kept.append((mix['warmup'] + n, results))
        else:
            j = int(rng.integers(0, n + 1))
            if j < len(kept):
                kept[j] = (mix['warmup'] + n, results)
        n += 1
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    print_sixths('ms a request', list(np.cumsum(latencies)))
    if kept[-1][0] != mix['warmup'] + n - 1:
        kept.append((mix['warmup'] + n - 1, results))
    del results

    record = None
    if trace:
        k = [0]

        def traced():
            with torch.profiler.record_function('bench.request'):
                call(mix['warmup'] + n + k[0])
            k[0] += 1

        record = trace_lib.profile(traced, mix['trace_units'], lambda: sync(device))
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == 'cuda' else 0)
    del engine
    gc.collect()
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()

    t_ref = time.perf_counter()
    readings = reference_readings(cell, seeds, requests, kept, device)
    print(f'[perfbench] reference {time.perf_counter() - t_ref:.2f} s', file=sys.stderr)
    e2e = {'infer_clips_per_s': n * mix['clips'] / window_s,
           'infer_p95_ms': 1e3 * float(np.percentile(latencies, 95)), 'setup_s': setup_s}
    if record is not None:
        attn = flops.attention_core(model_cfg, mix['clips'], train=False)
        gemm = flops.gemms(model_cfg, mix['clips'], train=False)
        record.update(kind='infer', units=mix['trace_units'], peak_bytes=peak,
                      window={'units': n, 'seconds': window_s},
                      needed={'flops': flops.forward_flops(model_cfg, mix['clips']),
                              'attn_flops': attn[0], 'attn_bytes': attn[1],
                              'gemm_flops': gemm[0], 'gemm_bytes': gemm[1]})
    return {'e2e': e2e, 'readings': readings, 'attempted': n, 'failed': 0, 'peak': peak,
            'record': record}


def reference_answers(cell, seeds, requests, indices, device, prec=None):
    '''The reference's (masks, flags, per-clip metric sums) of requests[i] for i in
    indices, from the benchmark's weights; prec as in drivers/train.reference_run.'''
    conf = cell.config
    ref.f32_matmuls()
    params = ref.as_params(make_weights(ref.param_shapes(conf['model']), seeds['weights'],
                                        device, conf['init']))
    out = []
    with torch.no_grad():
        for i in indices:
            rgb, query, target = requests[i % len(requests)]
            masks, flags = ref.seeker_forward(params, conf['model'],
                                              torch.as_tensor(rgb, device=device),
                                              torch.as_tensor(query, device=device), prec=prec)
            tgt = torch.as_tensor(target, device=device)
            out.append((masks.cpu().numpy(), flags.cpu().numpy(),
                        [ref.metric_sums(masks[b], tgt[b]) for b in range(rgb.shape[0])]))
            del masks, flags, tgt
    del params
    gc.collect()
    return out


def pairs_of(answers, refs):
    '''Per clip {'mask', 'mask_ref', ...} of answers (as `answer` gives them) beside the
    reference's; a clip the answer lacks is compared as missing.'''
    pairs = []
    for (masks, flags, metrics), (rmasks, rflags, rmetrics) in zip(answers, refs):
        for b in range(len(rmasks)):
            pairs.append({'mask': masks[b] if b < len(masks) else None, 'mask_ref': rmasks[b],
                          'flags': flags[b] if b < len(flags) else None,
                          'flags_ref': rflags[b],
                          'metrics': metrics[b] if b < len(metrics) else {},
                          'metrics_ref': rmetrics[b]})
    return pairs


def reference_readings(cell, seeds, requests, kept, device) -> Dict[str, float]:
    '''The gaps of the kept answers of the program from the reference's.'''
    refs = reference_answers(cell, seeds, requests, [i for i, _ in kept], device)
    return correct.request_readings(pairs_of([answer(r) for _, r in kept], refs))


def control_readings(cell, seed: int, device) -> Dict[str, float]:
    '''The control's readings: the reference in fp8 put in the program's place, on as many
    of the seed's pool as a run checks.'''
    n = min(cell.traffic['check_requests'], cell.traffic['pool'])
    seeds = sub_seeds(seed)
    requests = traffic.pool(traffic.infer_request, cell.traffic, seeds['traffic'], device)
    idx = list(range(n))
    low = reference_answers(cell, seeds, requests, idx, device, ref.Precision('fp8'))
    return correct.request_readings(pairs_of(low, reference_answers(cell, seeds, requests,
                                                                    idx, device)))
