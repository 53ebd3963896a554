#!/usr/bin/env python3
'''
Drives the PyTorch port (tcow_tpu_torch) on one NVIDIA GPU and checks it:

  1. device line: the card's name and power limit, torch / CUDA / nvcc versions, and the
     time to build the CUDA source tcow_tpu_torch/ops/csrc/fused_attention.cu;
  2. each kernel against its plain PyTorch version on the card, at the shapes of the
     main path (bf16), plus one float32 case;
  3. the inference slice at full width: a seeded ViT-B/16 seeker (depth 12, T=30,
     240x320, causal_attention=1, bf16) written to an .npz, loaded back through
     load_networks, and 3 InferenceEngine.run_plugin requests of 2 clips each, with the
     kernel launch counts read around them; outputs are checked for shape, finiteness,
     metric schema, and against the same engine with the plain attention swapped in;
  4. times: per request, per forward, and per kernel call beside its plain version, one
     PyTorch library call computing the same function, and its bound on the card.

Run from the repository root: `python3 chip_smoke.py`. Prints one JSON object per phase,
then the `{"kernels": [...]}` line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Exits non-zero, printing no result, when CUDA is not
available or any phase fails. Needs one GPU.
'''

import contextlib
import dataclasses
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from tcow_tpu_torch.evaluation.inference import InferenceEngine, load_networks
from tcow_tpu_torch.models import timesformer as tsf
from tcow_tpu_torch.models.mask_tracker import MaskTracker, seeker_config_from_args
from tcow_tpu_torch.objectives.metrics import METRIC_KEYS
from tcow_tpu_torch.ops import _build
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.train.checkpoint import save_checkpoint
from tcow_tpu_torch.weights import params_to_jax

SEED = 0
DEV = 'cuda'
# H100 SXM dense peaks (NVIDIA data sheet) at the 700 W limit.
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12

# The configuration of record: ViT-B/16 divided space-time, T=30 at 240x320, causal 1.
SEEKER_ARGS = dict(num_total_frames=30, frame_height=240, frame_width=320, patch_size=16,
                   attention_type='divided_space_time', causal_attention=1,
                   norm_embeddings=False, network_depth=12, track_map_stride=4,
                   track_map_resize='bilinear', query_channels=1, output_channels=3,
                   flag_channels=3, tracker_pretrained='0')
BATCH = 2            # clips per request
REQUESTS = 3
D, HEADS = 768, 12
# K1 geometries of the main path: temporal (B*N sequences of T, causal_attention=1)
# and spatial (B*T sequences of N+1, never causal).
GEOMETRIES = {'temporal': (BATCH * 300, 30, 1), 'spatial': (BATCH * 30, 301, 0)}

# Tolerances, relative L2 error ||kernel - plain|| / ||plain||:
# bf16 kernel vs the plain version in float32 from the same bf16-rounded inputs: the
# kernel rounds qkv, p and attn to bf16 (8 bits of mantissa, ~4e-3 per rounding).
TOL_BF16 = 1e-2
# float32 kernel vs float32 plain (TF32 off): only the order of the sums differs.
TOL_F32 = 1e-4
# Full seeker forward, bf16, kernel path vs plain path: both round to bf16 in every one
# of 12 blocks, at different points (the kernel once per GEMM, the plain path twice).
TOL_SEEKER_BF16 = 5e-2
# Full seeker forward in float32, kernel path vs plain path.
TOL_SEEKER_F32 = 1e-3


def fail(msg):
    raise SystemExit(f'chip_smoke: FAILED: {msg}')


def emit(obj):
    print(json.dumps(obj), flush=True)


def rel_l2(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


def cuda_ms(fn, iters=20, warmup=3):
    '''Mean milliseconds per call on the card, with CUDA events after a warm-up.'''
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_flops(B, S, ca):
    '''Operations one fused attention call needs: qkv and proj GEMMs, and scores + P.v
    over the (query, key) pairs the mask keeps.'''
    dh = D // HEADS
    if ca > 0:
        diag = 0 if ca <= 2 else ca - 2
        pairs = sum(min(S, q + diag + 1) for q in range(S))
    else:
        pairs = S * S
    return 2 * B * S * D * 4 * D + 2 * 2 * B * HEADS * pairs * dh


def k1_bytes(B, S, itemsize):
    '''x read once, out written once, the f32 weights and biases read once.'''
    return 2 * B * S * D * itemsize + (4 * D * D + 4 * D) * 4


def k1_bound_ms(B, S, ca):
    '''The least time of one bf16 call on the card: operations or bytes, the larger.'''
    return 1e3 * max(k1_flops(B, S, ca) / PEAK_BF16_FLOPS, k1_bytes(B, S, 2) / PEAK_HBM_BYTES)


def seeker_forward_flops(cfg, B):
    '''Matmul operations of one seeker forward over B clips.'''
    T, p = cfg.num_total_frames, cfg.patch_size
    N = (cfg.frame_height // p) * (cfg.frame_width // p)
    Hm = 4 * D
    block = (k1_flops(B * N, T, cfg.causal_attention) + 2 * B * N * T * D * D
             + k1_flops(B * T, N + 1, 0) + 2 * 2 * (B * N * T + B) * D * Hm)
    heads = 2 * B * T * N * D * (cfg.output_channels * p * p + cfg.flag_channels)
    return 2 * B * T * N * p * p * cfg.input_channels * D + cfg.network_depth * block + heads


def attn_inputs(B, S, dtype, seed):
    '''x and weights from a numpy seed; weight scales give peaked softmax rows.'''
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(DEV, dtype)
    w = [torch.from_numpy(a.astype(np.float32)).to(DEV) for a in (
        rng.randn(D, 3 * D) * 0.06, rng.randn(3 * D) * 0.02,
        rng.randn(D, D) * 0.03, rng.randn(D) * 0.02)]
    return x, w


@contextlib.contextmanager
def plain_attention():
    '''Runs the model's attention through the plain PyTorch version, on the card too, for
    comparisons with the kernel path; restores the kernel on exit.'''
    tsf.fused_attention = fa.attention_ref
    try:
        yield
    finally:
        tsf.fused_attention = fa.fused_attention


def library_attention(x, w16, ca):
    '''One PyTorch call chain computing the same function (yardstick only).'''
    B, S, _ = x.shape
    qkv = torch.addmm(w16[1], x.reshape(B * S, D), w16[0]).reshape(B, S, 3, HEADS, D // HEADS)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, is_causal=ca > 0)
    return torch.addmm(w16[3], o.transpose(1, 2).reshape(B * S, D), w16[2])


def phase_device():
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), '--version'], capture_output=True, text=True,
                          check=True).stdout
    nvcc_line = next((ln for ln in nvcc.splitlines() if 'release' in ln), nvcc.strip())
    t0 = time.perf_counter()
    _build.load('fused_attention')
    build_s = time.perf_counter() - t0
    log = _build.lib_path('fused_attention').with_suffix('.log')
    ptxas = ([ln.strip() for ln in log.read_text().splitlines()
              if 'registers' in ln or 'spill' in ln] if log.exists() else [])
    emit({'phase': 'device', 'nvidia_smi': smi, 'torch': torch.__version__,
          'torch_cuda': torch.version.cuda, 'nvcc': nvcc_line, 'build_s': build_s,
          'ptxas': ptxas})
    return smi


def phase_kernel_vs_plain():
    cases = [(name, B, S, ca, torch.bfloat16) for name, (B, S, ca) in GEOMETRIES.items()]
    cases.append(('f32_causal3', 16, 301, 3, torch.float32))
    errs = {}
    for i, (name, B, S, ca, dtype) in enumerate(cases):
        x, w = attn_inputs(B, S, dtype, SEED + i)
        got = fa.fused_attention(x, *w, HEADS, ca)
        want = fa.attention_ref(x.float(), *w, HEADS, ca)
        torch.cuda.synchronize()
        if got.shape != x.shape or got.dtype != dtype:
            fail(f'{name}: kernel output {tuple(got.shape)} {got.dtype}')
        tol = TOL_BF16 if dtype == torch.bfloat16 else TOL_F32
        errs[name] = dict(B=B, S=S, ca=ca, dtype=str(dtype).replace('torch.', ''),
                          max_abs_err=float((got.float() - want).abs().max()),
                          rel_l2_err=rel_l2(got.float(), want), tol_rel_l2=tol)
        if not errs[name]['rel_l2_err'] <= tol:
            fail(f'{name}: kernel vs plain rel L2 {errs[name]["rel_l2_err"]} > {tol}')
    emit({'phase': 'kernel_vs_plain', 'cases': errs})
    return errs


def plugin_request(seed):
    '''B clips of rgb, a query box on frame 0, and targets with unannotated frames.'''
    rng = np.random.RandomState(seed)
    T, H, W = (SEEKER_ARGS[k] for k in ('num_total_frames', 'frame_height', 'frame_width'))
    rgb = rng.rand(BATCH, 3, T, H, W).astype(np.float32)
    query = np.zeros((BATCH, 1, T, H, W), np.float32)
    query[:, :, 0, H // 3:2 * H // 3, W // 3:2 * W // 3] = 1.0
    target = np.zeros((BATCH, 3, T, H, W), np.float32)
    target[:, 0, :, H // 3:2 * H // 3, W // 3:2 * W // 3] = 1.0
    target[:, 1, ::3, H // 2:2 * H // 3, W // 2:2 * W // 3] = 1.0
    target[:, :, -T // 6:] = -1.0
    return rgb, query, target


def phase_slice(ckpt_dir):
    '''Checkpoint -> load_networks -> InferenceEngine -> 3 requests (the main path).'''
    cfg0 = seeker_config_from_args(SEEKER_ARGS)
    model = MaskTracker(cfg0)
    model.init_params_(torch.Generator().manual_seed(SEED))
    save_checkpoint(str(ckpt_dir), 0, 'chip_smoke', params_to_jax(model.state_dict()),
                    seeker_args=SEEKER_ARGS)
    del model
    params, cfg, *_ = load_networks(str(ckpt_dir), None, compute_dtype=torch.bfloat16,
                                    device=DEV)
    engine = InferenceEngine(params, cfg, device=DEV)
    rgb, query, target = plugin_request(SEED)

    fa.fused_attention.launches = 0
    req_ms, results = [], None
    for _ in range(REQUESTS):
        before = fa.fused_attention.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results = engine.run_plugin(rgb, query, target)
        torch.cuda.synchronize()
        req_ms.append(1e3 * (time.perf_counter() - t0))
        if fa.fused_attention.launches - before != 2 * cfg.network_depth:
            fail(f'request launched the kernel {fa.fused_attention.launches - before} '
                 f'times, expected {2 * cfg.network_depth}')
    launches = fa.fused_attention.launches

    mask = np.concatenate([m['output_mask'] for m, _ in results])
    flags = np.concatenate([m['output_flags'] for m, _ in results])
    if mask.shape != (BATCH, 3) + rgb.shape[2:] or flags.shape != (BATCH, rgb.shape[2], 3):
        fail(f'output shapes {mask.shape} {flags.shape}')
    if not (np.isfinite(mask).all() and np.isfinite(flags).all()):
        fail('non-finite outputs')
    want_keys = {f'{s}_{k}' for k in METRIC_KEYS for s in ('mean', 'count')}
    for _, loss in results:
        if set(loss['metrics']) != want_keys:
            fail(f'metric keys {sorted(loss["metrics"])}')

    # The same weights through the plain attention (bf16), and both paths in float32.
    def outputs(c, plain):
        eng = InferenceEngine(params, c, device=DEV)
        with plain_attention() if plain else contextlib.nullcontext():
            res = eng.run_plugin(rgb, query, target)
        return (np.concatenate([m['output_mask'] for m, _ in res]),
                np.concatenate([m['output_flags'] for m, _ in res]))

    cfg32 = dataclasses.replace(cfg, compute_dtype=torch.float32)
    plain = outputs(cfg, plain=True)
    f32_plain = outputs(cfg32, plain=True)
    f32_kernel = outputs(cfg32, plain=False)
    t = lambda a: torch.from_numpy(a)
    errs = {
        'mask_kernel_vs_plain_bf16': rel_l2(t(mask), t(plain[0])),
        'flags_kernel_vs_plain_bf16': rel_l2(t(flags), t(plain[1])),
        'mask_kernel_bf16_vs_plain_f32': rel_l2(t(mask), t(f32_plain[0])),
        'mask_plain_bf16_vs_plain_f32': rel_l2(t(plain[0]), t(f32_plain[0])),
        'mask_kernel_vs_plain_f32': rel_l2(t(f32_kernel[0]), t(f32_plain[0])),
        'flags_kernel_vs_plain_f32': rel_l2(t(f32_kernel[1]), t(f32_plain[1])),
    }
    for key, tol in (('mask_kernel_vs_plain_bf16', TOL_SEEKER_BF16),
                     ('flags_kernel_vs_plain_bf16', TOL_SEEKER_BF16),
                     ('mask_kernel_vs_plain_f32', TOL_SEEKER_F32),
                     ('flags_kernel_vs_plain_f32', TOL_SEEKER_F32)):
        if not errs[key] <= tol:
            fail(f'{key}: rel L2 {errs[key]} > {tol}')
    if launches != REQUESTS * 2 * cfg.network_depth:
        fail(f'main path launches {launches}')
    steady = sorted(req_ms[1:])[len(req_ms[1:]) // 2]
    emit({'phase': 'slice', 'requests': REQUESTS, 'clips_per_request': BATCH,
          'launches': launches, 'request_ms': req_ms, 'request_ms_steady': steady,
          'clips_per_s': BATCH / (steady / 1e3), 'rel_l2': errs,
          'tol_rel_l2': {'bf16': TOL_SEEKER_BF16, 'f32': TOL_SEEKER_F32},
          'metrics_example0': results[0][1]['metrics']})
    return params, cfg, launches, (rgb, query)


def phase_times(params, cfg, inputs):
    rgb, query = (torch.as_tensor(a, device=DEV) for a in inputs)
    engine = InferenceEngine(params, cfg, device=DEV)

    def forward_ms(path, warmup):
        with torch.inference_mode(), (plain_attention() if path == 'plain'
                                      else contextlib.nullcontext()):
            return path, cuda_ms(lambda: engine.model(rgb, query), iters=5, warmup=warmup)

    # Alternated in one process: plain, kernel, kernel, plain.
    runs = [forward_ms('plain', 2), forward_ms('kernel', 2), forward_ms('kernel', 0),
            forward_ms('plain', 0)]
    fwd_flops = seeker_forward_flops(cfg, BATCH)
    emit({'phase': 'forward_times', 'forward_ms': runs, 'forward_flops': fwd_flops,
          'forward_bound_ms': 1e3 * fwd_flops / PEAK_BF16_FLOPS})

    per_geom = {}
    with torch.inference_mode():
        for i, (name, (B, S, ca)) in enumerate(GEOMETRIES.items()):
            x, w = attn_inputs(B, S, torch.bfloat16, SEED + 100 + i)
            w16 = [a.to(torch.bfloat16) for a in w]
            per_geom[name] = dict(
                B=B, S=S, ca=ca,
                ms=cuda_ms(lambda: fa.fused_attention(x, *w, HEADS, ca)),
                plain_ms=cuda_ms(lambda: fa.attention_ref(x, *w, HEADS, ca)),
                library_ms=cuda_ms(lambda: library_attention(x, w16, ca)),
                bound_ms=k1_bound_ms(B, S, ca),
                bound_by=('operations' if k1_flops(B, S, ca) / PEAK_BF16_FLOPS
                          >= k1_bytes(B, S, 2) / PEAK_HBM_BYTES else 'bytes'),
                flops=k1_flops(B, S, ca), bytes=k1_bytes(B, S, 2))
    emit({'phase': 'kernel_times', 'per_call': per_geom})
    return per_geom


def main():
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; needs an NVIDIA GPU',
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_device()
    errs = phase_kernel_vs_plain()
    ckpt_dir = _build.BUILD_DIR / 'chip_smoke_ckpt'
    try:
        params, cfg, launches, inputs = phase_slice(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    per_geom = phase_times(params, cfg, inputs)

    # The main path calls each geometry once per block: report the mean per call.
    mean = lambda key: sum(g[key] for g in per_geom.values()) / len(per_geom)
    bf16_cases = [e for e in errs.values() if e['dtype'] == 'bfloat16']
    max_abs = max(e['max_abs_err'] for e in bf16_cases)
    emit({'kernels': [{
        'name': 'fused_attention', 'route': 'cuda',
        'source': 'tcow_tpu_torch/ops/csrc/fused_attention.cu',
        'replaces': 'tcow_tpu/ops/pallas_attention.py:87',
        'launches': launches, 'max_abs_err': max_abs,
        'rel_l2_err': max(e['rel_l2_err'] for e in bf16_cases),
        'ms': mean('ms'), 'plain_ms': mean('plain_ms'),
        'bound_ms': mean('bound_ms'),
        'bound_by': ('operations' if all(g['bound_by'] == 'operations'
                                         for g in per_geom.values()) else 'bytes'),
        'library_ms': mean('library_ms'), 'per_geometry': per_geom}]})
    print(smi)
    emit({'ok': True, 'device': {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                                 'count': torch.cuda.device_count()}})
    return 0


if __name__ == '__main__':
    sys.exit(main())
