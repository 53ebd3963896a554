#!/usr/bin/env python3
'''
Streaming-inference throughput of the PyTorch port: the counterpart of
tools/stream_bench.py, with its flags and its result dict.

The JAX tool chains N stream_step calls in one jitted lax.scan with one host sync. Here
the N frames are issued back to back from the host with no sync between them (the frames
already on the card, the masks summed on the card), and the chain is timed by the host
clock around it (one sync at its end) and by CUDA events. Reports ms/frame for the
unbounded cache and for windowed ring caches of several sizes, and with --multi K
stream_step_multi (the serving layer's continuous-batching step) per session-frame.

Usage:  python tools/torch_stream_bench.py [--frames 64] [--windows 30,120] [--multi 4]
            [--device cpu]

Prints one line per variant, one JSON line with each variant's host and device ms, kernel
launches per step and the card, then the dict of the JAX tool (host ms per frame, or per
session-frame for multi).
'''

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tcow_tpu_torch import resolve_device  # noqa: E402
from tcow_tpu_torch.models import streaming  # noqa: E402
from tcow_tpu_torch.models.mask_tracker import MaskTracker, SeekerConfig  # noqa: E402
from tcow_tpu_torch.ops import fused_attention as fa  # noqa: E402

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
SEED = 0


def bench_model(depth, H, W, rope, dtype, device):
    '''The JAX tool's bench seeker (causal 1, no drop-path, seeded random weights).'''
    cfg = SeekerConfig(frame_height=H, frame_width=W, causal_attention=1, drop_path_rate=0.0,
                       network_depth=depth, compute_dtype=dtype, temporal_rope=bool(rope))
    model = MaskTracker(cfg, device=device)
    model.init_params_(torch.Generator().manual_seed(SEED))
    return model.eval()


def bench_inputs(T, B, H, W, device):
    '''(frames (T, B, 3, H, W), queries (T, B, 1, H, W)) on the device, as the JAX tool:
    uniform noise, a query box on frame 0.'''
    rng = np.random.RandomState(0)
    frames = torch.as_tensor(rng.rand(T, B, 3, H, W).astype(np.float32), device=device)
    queries = torch.zeros((T, B, 1, H, W), device=device)
    queries[0, :, :, 64:128, 96:192] = 1.0
    return frames, queries


@torch.inference_mode()
def run_chain(model, frames, queries, window):
    '''init_stream, then one stream_step per frame issued back to back -> the masks'
    checksum (a 0-d tensor on the device; reading it is the chain's one sync).'''
    T, B = frames.shape[:2]
    state = streaming.init_stream(model, B, window=window,
                                  max_frames=None if window else T)
    total = torch.zeros((), device=frames.device)
    for t in range(T):
        state, mask, _ = streaming.stream_step(model, state, frames[t], queries[t],
                                               window=window)
        total += mask.float().sum()
    return total


@torch.inference_mode()
def run_chain_multi(model, frames, queries, window, K):
    '''The same over a K-session state (all active), every step stream_step_multi.'''
    T = frames.shape[0]
    fK = frames.expand(T, K, *frames.shape[2:])
    qK = queries.expand(T, K, *queries.shape[2:])
    active = torch.ones((K,), dtype=torch.bool, device=frames.device)
    state = streaming.init_stream_multi(model, K, max_frames=None if window else T,
                                        window=window)
    total = torch.zeros((), device=frames.device)
    for t in range(T):
        state, mask, _ = streaming.stream_step_multi(model, state, fK[t], qK[t], active,
                                                     window=window)
        total += mask.float().sum()
    return total


def measure(chain, steps, repeats, device):
    '''One warm-up chain, then `repeats` chains: the best host seconds (one sync at the
    end of each chain), its device ms by CUDA events (None on the CPU), the kernel
    launches per step and over every chain, and the checksum.'''
    on_card = device.type == 'cuda'
    start = fa.read_launches()
    t0 = time.perf_counter()
    float(chain())
    first_s = time.perf_counter() - t0
    best, best_dev, launches = float('inf'), None, None
    for _ in range(repeats):
        counts = fa.read_launches()
        if on_card:
            torch.cuda.synchronize(device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        s = float(chain())
        host = time.perf_counter() - t0
        dev = None
        if on_card:
            ev[1].record()
            torch.cuda.synchronize(device)
            dev = ev[0].elapsed_time(ev[1])
        launches = {k: n / steps for k, n in fa.launches_since(counts).items() if n}
        if host < best:
            best, best_dev = host, dev
    total = {k: n for k, n in fa.launches_since(start).items() if n}
    return dict(chain_s=best, chain_device_ms=best_dev, first_chain_s=first_s,
                launches_per_step=launches, launches=total, checksum=s)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--frames', type=int, default=64)
    p.add_argument('--windows', default='30,120')
    p.add_argument('--unbounded', type=int, default=1)
    p.add_argument('--height', type=int, default=240)
    p.add_argument('--width', type=int, default=320)
    p.add_argument('--depth', type=int, default=12)
    p.add_argument('--repeats', type=int, default=3)
    p.add_argument('--rope', type=int, default=0, help='temporal_rope on the bench model')
    p.add_argument('--multi', type=int, default=0,
                   help='>0: ALSO bench stream_step_multi with this many concurrent '
                        'sessions (the serving layer\'s continuous-batching step)')
    p.add_argument('--device', default='cuda')
    p.add_argument('--compute_dtype', default='bfloat16', choices=sorted(DTYPES))
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    model = bench_model(a.depth, a.height, a.width, a.rope, DTYPES[a.compute_dtype], device)
    T = a.frames
    frames, queries = bench_inputs(T, 1, a.height, a.width, device)
    windows = [int(x) for x in a.windows.split(',') if x]

    results, detail = {}, {}

    def report(key, label, r, per):
        ms = r['chain_s'] * 1e3 / per
        dev = r['chain_device_ms']
        results[key] = ms
        detail[key] = dict(r, ms_per_frame=ms,
                           device_ms_per_frame=None if dev is None else dev / per)
        unit = 'ms/frame/session' if per != T else 'ms/frame'
        print(f'{label:>14}: {ms:7.2f} {unit}  ({1e3 / ms:6.0f} fps)   '
              f'[chain {r["chain_s"]:.3f} s, device '
              f'{"n/a" if dev is None else f"{dev / 1e3:.3f} s"}, first chain '
              f'{r["first_chain_s"]:.1f} s, checksum {r["checksum"]:.1f}]', flush=True)

    if a.unbounded:
        report('unbounded', f'unbounded({T})', measure(
            lambda: run_chain(model, frames, queries, None), T, a.repeats, device), T)
    for w in windows:
        report(f'window{w}', f'window={w}', measure(
            lambda: run_chain(model, frames, queries, w), T, a.repeats, device), T)
    if a.multi:
        K = a.multi
        for w in windows:
            report(f'multi{K}_w{w}', f'multi{K} w={w}', measure(
                lambda: run_chain_multi(model, frames, queries, w, K), T, a.repeats,
                device), T * K)
    where = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    print(json.dumps({'stream_bench': detail, 'device': where, 'frames': T,
                      'compute_dtype': a.compute_dtype}), flush=True)
    print(results)


if __name__ == '__main__':
    main()
