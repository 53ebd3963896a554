#!/usr/bin/env python3
'''
Times the GEMMs and row reductions of an older source at every shape chip_smoke.py's phase
gemm_times gives the port's kernels (its gemm_cases: gemm_bias for qkv, proj, dattn =
g . proj_w^T and dx = dqkv . qkv_w^T, wgrad for x^T . dqkv and attn^T . g, colsum of dqkv
and g): the wmma GEMMs of an older fused_attention.cu (weights in f32, converted per
tile), or with `--kinds colsum` the colsum of an older gemm_sm90.cu. Run it in the same
call as chip_smoke.py to read the two side by side on one card.

Each shape prints one JSON line: ms, the relative L2 error against the f32 result of the
same bf16 operands, and whether two runs gave the same bits.

Run from the repository root:
`python3 tools/torch_gemm_times.py OLD/tcow_tpu_torch/ops/csrc/fused_attention.cu [--out OUT.json]`
or `python3 tools/torch_gemm_times.py OLD/tcow_tpu_torch/ops/csrc/gemm_sm90.cu --kinds colsum`.
'''

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from tcow_tpu_torch.ops import _build  # noqa: E402
from tcow_tpu_torch.ops import fused_attention as fa  # noqa: E402

P, I = fa._PTR, fa._I32


def load_wmma(source):
    '''The older source's C interface, built here with nvcc.'''
    out = str(_build.BUILD_DIR / 'wmma_reference.so')
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, '-o', out, source], check=True,
                   stdout=subprocess.DEVNULL, stderr=subprocess.STDOUT)
    return fa._bind(ctypes.CDLL(out), {'tcow_gemm_bias': [I, P, P, P, P, I, I, I, I, P],
                                       'tcow_wgrad': [I, P, P, P, P, I, I, I, I, I, P],
                                       'tcow_colsum': [I, P, P, P, I, I, I, I, P]})


def run_wmma(lib, case):
    '''One launch as the older chains made it: W in f32, (K, N) or (N, K) with
    w_transposed; wgrad on 128 x 128 tiles and colsum over runs of 32 rows.'''
    a = case.args[0]
    M, st = a.shape[0], torch.cuda.current_stream().cuda_stream
    if case.kind == 'gemm_bias':
        _, w, bias, wt = case.args
        N, K = (w.shape[0], w.shape[1]) if wt else (w.shape[1], w.shape[0])
        out = torch.empty((M, N), dtype=a.dtype, device=a.device)
        fa._check(lib.tcow_gemm_bias(1, a.data_ptr(), w.data_ptr(), fa._ptr(bias),
                                     out.data_ptr(), M, N, K, int(wt), st), 'wmma')
        return out
    if case.kind == 'wgrad':
        b = case.args[1]
        K, N = a.shape[1], b.shape[1]
        splits, rows = fa._row_splits(M, fa._cdiv(K, 128) * fa._cdiv(N, 128))
        out = torch.empty((K, N), dtype=torch.float32, device=a.device)
        work = torch.empty((splits, K, N), dtype=torch.float32, device=a.device)
        fa._check(lib.tcow_wgrad(1, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                 work.data_ptr(), M, K, N, splits, rows, st), 'wmma')
        return out
    N = a.shape[1]
    splits, rows = fa._row_splits(M, fa._cdiv(N, 256))
    out = torch.empty((N,), dtype=torch.float32, device=a.device)
    work = torch.empty((splits, N), dtype=torch.float32, device=a.device)
    fa._check(lib.tcow_colsum(1, a.data_ptr(), out.data_ptr(), work.data_ptr(), M, N, splits,
                              rows, st), 'wmma')
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument('wmma_source', help='an older fused_attention.cu with the wmma GEMMs, '
                    'or an older gemm_sm90.cu with --kinds colsum')
    ap.add_argument('--out', default=None, help='also write every line into this JSON file')
    ap.add_argument('--kinds', default='gemm_bias,wgrad,colsum',
                    help='comma-separated kinds of launch to time (gemm_bias, wgrad, colsum)')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('needs an NVIDIA GPU', file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit', '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    lib = load_wmma(args.wmma_source)
    lines = [{'device': smi, 'torch': torch.__version__}]
    print(json.dumps(lines[0]), flush=True)
    kinds = set(args.kinds.split(','))
    for case in cs.gemm_cases():
        if case.kind not in kinds:
            continue
        first, second = run_wmma(lib, case), run_wmma(lib, case)
        want = case.want()
        lines.append({'op': case.op, 'geometry': case.geometry, 'kind': case.kind,
                      'M': case.args[0].shape[0], 'rel_l2': cs.rel_l2(first.float(), want),
                      'same_bits': bool(torch.equal(first, second)),
                      'ms': cs.cuda_ms(lambda: run_wmma(lib, case))})
        print(json.dumps(lines[-1]), flush=True)
        del case, first, second, want
        torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, 'w') as f:
            json.dump(lines, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
