#!/usr/bin/env python3
'''
The benchmark of the PyTorch and CUDA port (tcow_tpu_torch) on NVIDIA GPUs.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of BENCHMARK.json in this process: it loads the cell's files by name, makes
the weights and inputs from --seed, warms up the cell's own shapes (set-up), measures for
--seconds, checks what the timed path produced against the plain reference, and prints one
JSON line as the last line of standard output: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics), device (and with
--trace 1 breakdown), then checks, each number compared beside its limit. The same checks
are the last lines of standard error.

It exits non-zero and prints no result without a CUDA card (or with fewer cards than the
cell asks for), and when jax, jaxlib, flax or the JAX package is loaded in this process
once the window has closed. Run from the root of a checkout: every cache of the program
stays inside it (the kernels' libraries in tcow_tpu_torch/_build/, others in
.bench_cache/).
'''

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / '.bench_cache'
# Top-level module names that may not be loaded in a run: JAX and the JAX package (whole
# names: the port's tcow_tpu_torch is not tcow_tpu).
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'tcow_tpu')


def loaded_forbidden():
    return sorted({m.split('.')[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_limit() -> str:
    '''The card's name, power limit and draw, SM clock, temperature and active throttle
    reasons as nvidia-smi reads them, or why not.'''
    try:
        out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit,power.draw,'
                              'clocks.sm,temperature.gpu,clocks_throttle_reasons.active',
                              '--format=csv,noheader'], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f'nvidia-smi: {e}'


def finite(x):
    return x if isinstance(x, (int, float)) and math.isfinite(x) else 1e300


def result_line(cell, out, trace: bool, readings, limits, device_info) -> dict:
    '''The last line of standard output.'''
    from perfbench.core import cell as cell_lib
    from perfbench.core import correct
    from perfbench.core import trace as trace_lib
    metrics = {}
    if not trace:
        for m in cell.end_to_end:
            metrics[m['name']] = {'value': out['e2e'][cell_lib.quantity(m['name'])],
                                  'unit': m['unit']}
    else:
        rec = out['record']
        rec['group_s'] = trace_lib.group_seconds(rec['device'], cell_lib.kernel_groups())
        for m in cell.per_layer:
            value = cell_lib.load_reader(m['name'])(rec)
            if value is not None:
                metrics[m['name']] = {'value': value, 'unit': m['unit']}
    line = {'correct': correct.judge(readings, limits), 'attempted': out['attempted'],
            'failed': out['failed'], 'metrics': metrics, 'device': device_info}
    if trace:
        rec = out['record']
        line['device']['busy_s'] = trace_lib.busy_seconds(rec['device'])
        line['device']['window_s'] = rec['window_s']
        line['breakdown'] = {'device_ops': trace_lib.top_ops(rec['device']),
                             'idle_gaps': trace_lib.idle_gaps(rec['device'], rec['host'])}
    line['checks'] = {k: {'value': finite(v['value']), 'limit': v['limit']}
                      for k, v in correct.checks(readings, limits).items()}
    return line


def run_cell(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    '''One run of `cell` by the driver of its traffic's kind: the window, the comparison
    and the parts of the result.'''
    from perfbench.core import cell as cell_lib
    return cell_lib.driver(cell).run(cell, seed, seconds, trace, device, t_start)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument('--workload', required=True, help='the cell, as BENCHMARK.json names it')
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True, help='length of the window')
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    CACHE.mkdir(exist_ok=True)
    os.environ['TRITON_CACHE_DIR'] = str(CACHE / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(CACHE / 'torch_extensions')
    os.environ['USE_FLAX'] = '0'
    sys.path[0] = str(ROOT)   # the checkout's root, not perfbench/

    import torch
    from perfbench.core import cell as cell_lib
    from perfbench.core import correct

    # One intra-op thread: the load comes from one process with few threads, so that idle
    # worker threads do not contend with the dispatching thread on the host's cores.
    torch.set_num_threads(1)
    cell = cell_lib.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f'{args.workload} needs {cell.chips} CUDA card(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), 'cuda', T_START)
    bad = loaded_forbidden()
    if bad:
        print(f'modules of JAX or the JAX package are loaded: {bad}', file=sys.stderr)
        return 3
    limits = cell.workload['limits']
    device_info = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
                   'count': cell.chips, 'memory_peak_bytes': int(out['peak'])}
    line = result_line(cell, out, bool(args.trace), out['readings'], limits, device_info)
    print(f'card: {card_limit()}; peaks 989 TFLOP/s bf16, 3.35 TB/s', file=sys.stderr)
    print(json.dumps(line), flush=True)
    correct.print_checks(out['readings'], limits)
    return 0


if __name__ == '__main__':
    sys.exit(main())
