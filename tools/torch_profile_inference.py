#!/usr/bin/env python3
'''
Device-time breakdown of the PyTorch port's batched inference on one NVIDIA GPU.

Builds the seeded seeker of chip_smoke.py (ViT-B/16, depth 12, T=30, 240x320,
causal_attention=1, bf16), then, for the fused-kernel path and the plain attention path,
profiles one InferenceEngine.run_plugin request of 2 clips with torch.profiler and prints
one JSON line each: host wall time of the request, device busy time (sum of kernel and
copy times) and its share of the wall time, and device time per kernel group. With
--table_dir DIR the full per-kernel table goes to DIR/torch_profile_<path>.txt.

Run from the repository root: `python3 tools/torch_profile_inference.py [--table_dir DIR]`.
'''

import argparse
import collections
import contextlib
import json
import os
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from tcow_tpu_torch.evaluation.inference import InferenceEngine  # noqa: E402
from tcow_tpu_torch.models.mask_tracker import MaskTracker, seeker_config_from_args  # noqa: E402
from tcow_tpu_torch.weights import params_to_jax  # noqa: E402

# Kernel groups by substring of the kernel's name, the first match wins: the port's
# gemm_bias_sm90 and wgrad_sm90 before the cuBLAS patterns ('gemm', 'sm90_').
GROUPS = (('attn_core', ('attn_core',)),
          ('attn_bwd (K4 core)', ('attn_bwd',)),
          ('gemm_bias (K1-K6 GEMMs)', ('gemm_bias',)),
          ('wgrad / colsum (K6 reductions)', ('wgrad', 'colsum', 'sum_splits')),
          ('cuBLAS/cutlass GEMM', ('gemm', 'sm90_', 'cutlass', 'cublas', 'nvjet')),
          ('softmax', ('softmax',)),
          ('optimizer (foreach)', ('multi_tensor_apply',)),
          ('memcpy', ('memcpy', 'Memcpy')),
          ('elementwise/reduce', ('elementwise', 'reduce', 'vectorized', 'cat', 'Copy')))


# torch.profiler.record_function ranges of the port whose device time is read apart.
NAMED_RANGES = ('gemm_weight_cast',)


def group_of(name):
    for group, keys in GROUPS:
        if any(k in name for k in keys):
            return group
    return 'other'


def summarize(prof, wall_ms, tag, table_dir):
    '''One JSON-able dict of a profiled window: host wall ms, device busy ms (the union of
    the intervals of device-side events: kernels, copies, memsets) and its share of the
    wall time, and device ms per kernel group; the per-kernel table goes to
    table_dir/torch_profile_<tag>.txt when table_dir is set. The device ms of the named
    ranges (the bf16 GEMMs' weight casts, 'gemm_weight_cast') are listed apart; their
    kernels count in their own group too (elementwise).'''
    groups = collections.Counter()
    spans = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            groups[group_of(ev.name)] += ev.time_range.elapsed_us() / 1e3
            spans.append((ev.time_range.start, ev.time_range.end))
    busy_us, end = 0.0, float('-inf')
    for s, e in sorted(spans):
        if e > end:
            busy_us += e - max(s, end)
            end = e
    if table_dir:
        os.makedirs(table_dir, exist_ok=True)
        with open(os.path.join(table_dir, f'torch_profile_{tag}.txt'), 'w') as f:
            f.write(prof.key_averages().table(sort_by='self_device_time_total', row_limit=40))
    ranges = collections.Counter()
    for ev in prof.events():
        if ev.name in NAMED_RANGES:
            ranges[ev.name] += ev.device_time_total / 1e3
    return {'path': tag, 'wall_ms': wall_ms, 'device_busy_ms': busy_us / 1e3,
            'device_busy_share': busy_us / 1e3 / wall_ms,
            'device_ms_by_group': dict(groups.most_common()),
            'device_ms_of_named_ranges': dict(ranges)}


def profile_call(fn, tag, plain, table_dir):
    '''Runs fn once to warm up and once under torch.profiler, the model's attention swapped
    for the plain version when `plain`; prints the summary of the profiled call.'''
    with cs.plain_attention() if plain else contextlib.nullcontext():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
    print(json.dumps(summarize(prof, wall_ms, tag, table_dir)), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument('--table_dir', default=None,
                    help='write the per-kernel profiler tables into this directory')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 2
    cfg = seeker_config_from_args(cs.SEEKER_ARGS, compute_dtype=torch.bfloat16)
    model = MaskTracker(cfg)
    model.init_params_(torch.Generator().manual_seed(cs.SEED))
    params = params_to_jax(model.state_dict())
    del model
    rgb, query, target = cs.plugin_request(cs.SEED)
    engine = InferenceEngine(params, cfg, device='cuda')
    for tag in ('kernel', 'plain'):
        profile_call(lambda: engine.run_plugin(rgb, query, target), tag, tag == 'plain',
                     args.table_dir)
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == '__main__':
    sys.exit(main())
