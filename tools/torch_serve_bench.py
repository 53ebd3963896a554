#!/usr/bin/env python3
'''
Aggregate-throughput benchmark of the PyTorch port's tracking service
(tcow_tpu_torch/serving.py): the counterpart of tools/serve_bench.py, with its flags and
output lines.

Starts an in-process TrackerServer (seeded random weights by default: throughput does not
depend on weight values; or --resume), opens K concurrent client sessions through
TrackerClient, streams F frames per session, and reports aggregate frames/s and per-frame
latency percentiles. Compares the dedicated-step path (--batch_slots 1: one B=1 step per
frame per session) with continuous batching (--batch_slots K: all pending frames ride ONE
batched step). --reload_midway hot-swaps the weights (a params_loader returning the same
tensors) once a session reaches frames/2 and counts the sessions it kills
(`stale_errors`; 0 with --migrate 1).

  python tools/torch_serve_bench.py --sessions 1,4,8 --frames 60 --window 30 [--batch_slots 8]

Per sweep point: the JAX tool's line, then one JSON line with the server's steps, the
kernel launches over them and the card.
'''

import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from tcow_tpu_torch import resolve_device, serving  # noqa: E402
from tcow_tpu_torch.models.mask_tracker import MaskTracker, SeekerConfig  # noqa: E402
from tcow_tpu_torch.ops import fused_attention as fa  # noqa: E402
from tcow_tpu_torch.weights import params_to_jax  # noqa: E402

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
SEED = 0
TIMEOUT_S = 120.0


def run_clients(host, port, n_sessions, n_frames, window, H, W, reload_at=-1):
    '''n_sessions client threads, each opening a session, one warm-up frame with the query,
    then n_frames timed frames. reload_at >= 0: an admin connection hot-swaps the weights
    once session 0 reaches that frame; a session whose track() errors (stale after the
    reload, non-migrating server) reopens and resends its query, counted in
    `stale_errors`.'''
    rng = np.random.RandomState(0)
    rgb = rng.randint(0, 256, size=(8, H, W, 3), dtype=np.uint8)   # cycled
    qmask = np.zeros((H, W), np.uint8)
    qmask[H // 4: H // 2, W // 4: W // 2] = 255

    lat = [[] for _ in range(n_sessions)]
    errors = []
    stale_errors = [0]
    stale_msgs = set()
    count_lock = threading.Lock()
    reload_evt = threading.Event()
    barrier = threading.Barrier(n_sessions + 1, timeout=TIMEOUT_S)

    def admin():
        if reload_evt.wait(TIMEOUT_S):
            c = serving.TrackerClient(host, port, timeout=TIMEOUT_S)
            c.reload('fresh')
            c.close()

    def worker(k):
        try:
            c = serving.TrackerClient(host, port, timeout=TIMEOUT_S)
            c.open(window=window)
            c.track(rgb[0], query_mask=qmask)   # warm-up frame
            barrier.wait()
            for t in range(n_frames):
                if t == reload_at and k == 0:
                    reload_evt.set()
                t0 = time.time()
                try:
                    c.track(rgb[(t + 1) % len(rgb)])
                except RuntimeError as e:
                    with count_lock:
                        stale_errors[0] += 1
                        stale_msgs.add(str(e)[:120])
                    c.close()
                    c = serving.TrackerClient(host, port, timeout=TIMEOUT_S)
                    c.open(window=window)
                    c.track(rgb[0], query_mask=qmask)   # tracking state lost: requery
                lat[k].append(time.time() - t0)
            c.close()
        except Exception as e:   # noqa: BLE001 — reported by the caller
            errors.append((k, repr(e)))
            barrier.abort()

    if reload_at >= 0:
        threading.Thread(target=admin, daemon=True).start()
    threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_sessions)]
    for t in threads:
        t.start()
    try:
        barrier.wait()       # all sessions warmed: the timed region starts here
    except threading.BrokenBarrierError:
        pass                 # a worker failed during open / warm-up; raised below
    t0 = time.time()
    for t in threads:
        t.join(TIMEOUT_S + n_frames * 10.0)
    wall = time.time() - t0
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f'client sessions failed: {errors}, hung '
                           f'{[t.is_alive() for t in threads]}')
    all_lat = np.concatenate([np.asarray(x) for x in lat])
    return dict(sessions=n_sessions, frames_total=n_sessions * n_frames, wall_s=wall,
                agg_fps=n_sessions * n_frames / wall,
                lat_ms_p50=float(np.percentile(all_lat, 50) * 1e3),
                lat_ms_p95=float(np.percentile(all_lat, 95) * 1e3),
                lat_ms_max=float(all_lat.max() * 1e3),
                stale_errors=stale_errors[0], stale_msgs=sorted(stale_msgs))


def seeded_params(cfg):
    '''Random weights (throughput does not depend on their values), seeded.'''
    model = MaskTracker(cfg)
    model.init_params_(torch.Generator().manual_seed(SEED))
    return params_to_jax(model.state_dict())


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--sessions', default='1,4,8',
                   help='comma list of concurrent session counts to sweep')
    p.add_argument('--frames', type=int, default=60, help='timed frames per session')
    p.add_argument('--window', type=int, default=30)
    p.add_argument('--batch_slots', type=int, default=0,
                   help='0 = max(sessions sweep); 1 = dedicated per-session steps')
    p.add_argument('--height', type=int, default=240)
    p.add_argument('--width', type=int, default=320)
    p.add_argument('--num_frames', type=int, default=30)
    p.add_argument('--resume', default='', help='optional checkpoint (else random init)')
    p.add_argument('--migrate', type=int, default=0,
                   help='1: migrate_sessions=True (zero-downtime reloads)')
    p.add_argument('--reload_midway', action='store_true',
                   help='hot-swap weights once a session reaches frames/2; reports '
                        'stale_errors (sessions killed; 0 with --migrate 1) and the '
                        'max latency (the migration replay spike)')
    p.add_argument('--device', default='cuda')
    p.add_argument('--compute_dtype', default='bfloat16', choices=sorted(DTYPES))
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    dtype = DTYPES[a.compute_dtype]
    sweep = [int(s) for s in a.sessions.split(',')]
    slots = a.batch_slots or max(sweep)

    if a.resume:
        from tcow_tpu_torch.evaluation import inference as inference_lib
        params, cfg, *_ = inference_lib.load_networks(a.resume, None, compute_dtype=dtype,
                                                      device=device)
    else:
        cfg = SeekerConfig(num_total_frames=a.num_frames, frame_height=a.height,
                           frame_width=a.width, causal_attention=1, drop_path_rate=0.0,
                           compute_dtype=dtype)
        params = seeded_params(cfg)
    H, W = cfg.frame_height, cfg.frame_width
    where = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    print(f'device={where} {H}x{W} window={a.window} batch_slots={slots} '
          f'migrate={a.migrate} reload_midway={a.reload_midway}', file=sys.stderr)
    # The same values: a throughput-neutral hot swap.
    loader = (lambda _path: params) if a.reload_midway else None
    server = serving.TrackerServer(params, cfg, port=0, batch_slots=slots,
                                   params_loader=loader, migrate_sessions=bool(a.migrate),
                                   device=device)
    host, port = server.start()
    try:
        for n in sweep:
            served = server._frames_served
            counts = fa.read_launches()
            r = run_clients(host, port, n, a.frames, a.window, H, W,
                            reload_at=a.frames // 2 if a.reload_midway else -1)
            launches = {k: v for k, v in fa.launches_since(counts).items() if v}
            occ = ''
            steps = server._frames_served - served   # dedicated: one step a frame
            for g in server._groups.values():
                if g.steps:
                    occ = (f'  [steps={g.steps} avg_batch={g.frames / g.steps:.1f} '
                           f'avg_step={g.step_ms / g.steps:.0f} ms]')
                    steps = g.steps
                g.steps = g.frames = 0
                g.step_ms = 0.0
            extra = (f'  max={r["lat_ms_max"]:7.1f} ms  stale_errors={r["stale_errors"]}'
                     if a.reload_midway else '')
            if a.reload_midway and r['stale_msgs']:
                print('  stale error kinds: ' + ' | '.join(r['stale_msgs']),
                      file=sys.stderr)
            print(f'sessions={r["sessions"]:3d}  agg_fps={r["agg_fps"]:8.1f}  '
                  f'p50={r["lat_ms_p50"]:7.1f} ms  p95={r["lat_ms_p95"]:7.1f} ms  '
                  f'({r["frames_total"]} frames in {r["wall_s"]:.2f} s){occ}{extra}',
                  flush=True)
            print(json.dumps({'serve_bench': r, 'batch_slots': slots, 'server_steps': steps,
                              'launches': launches, 'device': where}), flush=True)
    finally:
        server.stop()


if __name__ == '__main__':
    main()
