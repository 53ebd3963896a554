#!/usr/bin/env python3
'''
The readings that the limits of `correct` are set from, for one cell, in one process on
the card: the program's numbers on each of --seeds (its timed path in a short window:
training needs none, requests a short one), the control's (the reference in fp8 put in the
program's place) on the first --control seeds, and each fault of --faults planted in the
program underneath its timed path (tools/faults.py) on the first --fault_seeds seeds. One
JSON line per reading on standard output and, with --out, all of them in one JSON file.

    python3 perfbench/tools/readings.py --workload train.divst --seeds 101-112 \
        --control 3 --faults half_batch,loss_scale --out readings_train.divst.json

The benchmark's own runs do not run this.
'''

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def seed_list(text: str):
    '''"101-112" or "5,9,2147483701" -> a list of seeds.'''
    out = []
    for part in text.split(','):
        a, _, b = part.partition('-')
        out += list(range(int(a), int(b or a) + 1))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', default='')
    ap.add_argument('--control', type=int, default=0, help='control readings on this many seeds')
    ap.add_argument('--faults', default='',
                    help='comma-separated faults of tools/faults.py, planted in the program')
    ap.add_argument('--fault_seeds', type=int, default=3)
    ap.add_argument('--seconds', type=float, default=None,
                    help="the short window (default: 0.01 s for training, 2 s for requests)")
    ap.add_argument('--out', default=None)
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)
    import torch
    from perfbench.core import cell as cell_lib
    from perfbench.tools import faults as faults_lib
    if not torch.cuda.is_available():
        print('needs a CUDA card', file=sys.stderr)
        return 2
    cell = cell_lib.load_cell(args.workload)
    driver = cell_lib.driver(cell)
    seconds = args.seconds if args.seconds is not None else (
        0.01 if cell.traffic['kind'] == 'train' else 2.0)
    seeds = seed_list(args.seeds) if args.seeds else []
    rows = []

    def emit(row):
        row['t'] = time.perf_counter()
        rows.append(row)
        print(json.dumps(row), flush=True)

    for s in seeds:
        out = driver.run(cell, s, seconds, False, 'cuda', time.perf_counter())
        emit({'what': 'program', 'seed': s, 'readings': out['readings'],
              'peak_gb': out['peak'] / 1e9})
    for s in seeds[:args.control]:
        emit({'what': 'control', 'seed': s,
              'readings': driver.control_readings(cell, s, 'cuda')})
    for fault in [f for f in args.faults.split(',') if f]:
        for s in seeds[:args.fault_seeds]:
            with faults_lib.planted(fault):
                out = driver.run(cell, s, seconds, False, 'cuda', time.perf_counter())
            emit({'what': f'fault:{fault}', 'seed': s, 'readings': out['readings']})
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({'workload': args.workload, 'rows': rows,
                                              'card': torch.cuda.get_device_name(0)}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
