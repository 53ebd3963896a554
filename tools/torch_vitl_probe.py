#!/usr/bin/env python3
'''
ViT-L stretch-configuration TRAINING probe for the PyTorch port on one GPU: the
counterpart of tools/vitl_probe.py, with its ladder and --geoms syntax.

The stretch configuration (BASELINE.json config 5: ViT-L divided space-time,
network_depth=24, D=1024, 16 heads, 431M parameters) is walked over a ladder of
geometries at the training configuration of record (bench.py's step of the JAX package):
bf16 over f32 weights, per-block remat under the rung's policy (default 'dots_nb_out'),
attention_bwd='kernel_x', AdamW 1e-4, synthetic_device_batch(M=12, K=6). Per rung: one
step, one warm-up step, then `--steps` timed steps with one sync, and the ms/step,
clips/s, the peak of torch.cuda.max_memory_allocated and each step's kernel launches; or
OOM, when the rung does not fit on the card (torch.cuda.OutOfMemoryError only: any other
error propagates). grad_accum microbatching (train/step.py) trades step time for
activation memory, so a rung can also be probed at accum > 1.

On the CPU (--device cpu, a wiring test) the step runs in float32 with the plain
attention under 'res' / 'dots_nb', as the JAX tool runs off the TPU.

Usage:
  python tools/torch_vitl_probe.py                       # the default ladder
  python tools/torch_vitl_probe.py --geoms '24,1,1,30,240,320,1;24,1,1,60,480,640,1,full'
      # depth,B,Q,T,H,W,accum[,remat_policy] per rung, ';'-separated

Prints one JSON line per rung (`{"probe": ...}`) and then the markdown table of the JAX
tool.
'''

import argparse
import gc
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tcow_tpu_torch import resolve_device  # noqa: E402
from tcow_tpu_torch.data.synthetic import synthetic_device_batch  # noqa: E402
from tcow_tpu_torch.models.mask_tracker import SeekerConfig  # noqa: E402
from tcow_tpu_torch.objectives.losses import LossConfig  # noqa: E402
from tcow_tpu_torch.ops import fused_attention as fa  # noqa: E402
from tcow_tpu_torch.train import optim, step as step_lib  # noqa: E402

# depth, B, Q, T, H, W, grad_accum: small -> large, so the OOM frontier is the last row;
# each rung is an independent try (a fresh state, freed after).
DEFAULT_LADDER = [
    (24, 1, 1, 30, 240, 320, 1),    # ViT-L at the flagship clip geometry
    (24, 2, 1, 30, 240, 320, 2),    # effective B=2 via microbatching
    (24, 1, 3, 30, 240, 320, 1),    # reference query count
    (24, 1, 1, 60, 240, 320, 1),    # stretch T
    (24, 1, 1, 30, 480, 640, 1),    # stretch resolution (36000 tokens)
    (24, 1, 1, 60, 480, 640, 1),    # FULL stretch config (72000 tokens)
]
SEED = 0
PROGRESS = 0.1


def parse_ladder(spec: str):
    '''"depth,B,Q,T,H,W,accum[,remat_policy];..." -> tuples, as tools/vitl_probe.py.'''
    return [tuple(int(x) if i < 7 else x for i, x in enumerate(g.split(',')))
            for g in spec.split(';') if g]


def rung_config(depth, Q, T, H, W, policy, device):
    '''The step of record's configuration at a rung's geometry: on the card bf16 with the
    kernel_x backward under `policy` (default dots_nb_out); on the CPU float32 with the
    plain attention's 'res' backward under dots_nb.'''
    on_card = device.type == 'cuda'
    seeker = SeekerConfig(num_total_frames=T, frame_height=H, frame_width=W,
                          causal_attention=1, drop_path_rate=0.1, network_depth=depth,
                          compute_dtype=torch.bfloat16 if on_card else torch.float32,
                          remat=True,
                          remat_policy=policy or ('dots_nb_out' if on_card else 'dots_nb'),
                          attention_bwd='kernel_x' if on_card else 'res')
    return step_lib.StepConfig(seeker=seeker, loss=LossConfig(), num_queries=Q)


def _sync(device):
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def try_geom(depth, B, Q, T, H, W, accum, steps=3, policy='', device='cuda'):
    '''One rung: init_train_state -> make_optimizer -> make_train_step(grad_accum), a
    first step, a warm-up step and `steps` timed steps with one sync. Returns
    {ms, clips_per_s, peak_bytes, loss, first_step_s, launches: [per step]}.'''
    device = resolve_device(device)
    cfg = rung_config(depth, Q, T, H, W, policy, device)
    tx = optim.make_optimizer('adamw', 1e-4, num_epochs=70, steps_per_epoch=1000)
    state = step_lib.init_train_state(SEED, cfg, tx, device=device)
    train_step = step_lib.make_train_step(cfg, grad_accum=accum)
    batch = {k: torch.as_tensor(v, device=device) for k, v in synthetic_device_batch(
        0, B=B, Q=Q, T=T, H=H, W=W, M=12, K=6).items()}
    launches = []

    def step():
        nonlocal state
        counts = fa.read_launches()
        state, aux = train_step(state, batch, PROGRESS)
        launches.append({k: n for k, n in fa.launches_since(counts).items() if n})
        return aux

    t0 = time.perf_counter()
    loss = float(step()['total_seeker'])
    first_s = time.perf_counter() - t0
    print(f'  step1 {first_s:.1f}s loss={loss:.3f}', file=sys.stderr)
    step()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(steps):
        aux = step()
    loss = float(aux['total_seeker'])
    _sync(device)
    ms = (time.perf_counter() - t0) / steps * 1e3
    peak = torch.cuda.max_memory_allocated(device) if device.type == 'cuda' else None
    return dict(ms=ms, clips_per_s=B / (ms / 1e3), peak_bytes=peak, loss=loss,
                first_step_s=first_s, launches=launches)


def _free(device):
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument('--geoms', default='',
                   help='semicolon-separated depth,B,Q,T,H,W,accum[,remat_policy] tuples '
                        '(default: the built-in ladder)')
    p.add_argument('--steps', type=int, default=3)
    p.add_argument('--device', default='cuda', help="'cpu' runs the CPU wiring test")
    a = p.parse_args(argv)
    device = resolve_device(a.device)
    ladder = parse_ladder(a.geoms) if a.geoms else DEFAULT_LADDER
    where = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    print(f'device: {where}', file=sys.stderr)
    rows = []
    for geom in ladder:
        depth, B, Q, T, H, W, accum = geom[:7]
        policy = geom[7] if len(geom) > 7 else ''
        tag = f'd{depth} B{B} Q{Q} T{T} {H}x{W} accum{accum}' + \
              (f' {policy}' if policy else '')
        tokens = T * (H // 16) * (W // 16)
        print(f'[probe] {tag} ({tokens} tokens/clip)', file=sys.stderr)
        _free(device)
        rec = dict(probe=tag, depth=depth, B=B, Q=Q, T=T, H=H, W=W, accum=accum,
                   policy=policy or rung_config(depth, Q, T, H, W, '', device)
                   .seeker.remat_policy, tokens=tokens, device=where)
        try:
            rec.update(try_geom(depth, B, Q, T, H, W, accum, steps=a.steps, policy=policy,
                                device=device), fits=True)
        except torch.cuda.OutOfMemoryError as e:
            rec.update(fits=False, error=str(e).splitlines()[0][:200])
        _free(device)
        print(json.dumps(rec), flush=True)
        if rec['fits']:
            peak = ('' if rec['peak_bytes'] is None
                    else f', peak {rec["peak_bytes"] / 1e9:.2f} GB')
            rows.append((tag, tokens, f'{rec["ms"]:.0f} ms/step',
                         f'{rec["clips_per_s"]:.3f} clips/s{peak}'))
            print(f'[probe] {tag}: {rec["ms"]:.0f} ms/step = {rec["clips_per_s"]:.3f} '
                  f'clips/s{peak}', file=sys.stderr)
        else:
            rows.append((tag, tokens, 'OOM', rec['error']))
            print(f'[probe] {tag}: OOM: {rec["error"]}', file=sys.stderr)
    print('\n| geometry | tokens/clip | result | detail |')
    print('|---|---|---|---|')
    for tag, tokens, r, d in rows:
        print(f'| {tag} | {tokens} | {r} | {d} |')


if __name__ == '__main__':
    main()
