'''
Finds everything a cell needs by name: its entry in BENCHMARK.json (configuration, traffic,
chips, the metrics it reports), the configuration's file under configs/, the traffic mix
under traffic/, the driver of the mix's kind under drivers/, the cell's limits of
correctness under workloads/, the per-layer metric readers under metrics/ and the kernel
groups under kernel_groups/. Adding a cell, a configuration, a traffic mix, a metric or a
kernel group is adding files and entries: nothing here names one.

An end-to-end metric is named after the quantity that the driver measures, the part of
its name before the first dot: 'train_clips_per_s' and 'train_clips_per_s.joint' are both
the training driver's clips per second, each with a bound of its own.
'''

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config: Dict            # configs/<config>.json
    traffic: Dict           # traffic/<traffic>.json
    workload: Dict          # workloads/<cell>.json: the limits of correctness
    chips: int
    end_to_end: List[Dict]  # the BENCHMARK.json end-to-end metrics this cell reports
    per_layer: List[Dict]   # the per-layer metrics this cell reports


def reports(metric: Dict, cell: str, end_to_end_names=None) -> bool:
    '''Whether `cell` reports `metric`: every cell reports a metric without a workloads
    key, except a per-layer metric whose end-to-end metric the cell does not report.'''
    if 'workloads' in metric:
        return cell in metric['workloads']
    return end_to_end_names is None or metric.get('moves') in end_to_end_names


def load_cell(name: str, bench_dir: Path = BENCH_DIR, root: Path = None) -> Cell:
    '''The cell `name` of <root>/BENCHMARK.json with its files under `bench_dir`.'''
    root = root or bench_dir.parent
    bench = read_json(root / 'BENCHMARK.json')
    entry = next((w for w in bench['workloads'] if w['name'] == name), None)
    if entry is None:
        raise KeyError(f'no workload {name!r} in BENCHMARK.json')
    conf = next(c for c in bench['configs'] if c['name'] == entry['config'])
    e2e = [m for m in bench['end_to_end'] if reports(m, name)]
    e2e_names = {m['name'] for m in e2e}
    per_layer = [m for m in bench['per_layer'] if reports(m, name, e2e_names)]
    return Cell(name=name, config=read_json(root / conf['file']),
                traffic=read_json(bench_dir / 'traffic' / f"{entry['traffic']}.json"),
                workload=read_json(bench_dir / 'workloads' / f'{name}.json'),
                chips=int(entry['chips']), end_to_end=e2e, per_layer=per_layer)


def quantity(metric: str) -> str:
    '''The driver's quantity that the end-to-end metric `metric` reports.'''
    return metric.split('.', 1)[0]


def driver(cell: Cell):
    '''The module drivers/<kind>.py of the cell's traffic mix: run(cell, seed, seconds,
    trace, device, t_start) and control_readings(cell, seed, device).'''
    return importlib.import_module(f"perfbench.drivers.{cell.traffic['kind']}")


def load_reader(metric: str, bench_dir: Path = BENCH_DIR) -> Callable:
    '''The `read(record)` function of metrics/<metric>.py.'''
    path = bench_dir / 'metrics' / f'{metric}.py'
    spec = importlib.util.spec_from_file_location(f'perfbench_metric_{metric}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def kernel_groups(bench_dir: Path = BENCH_DIR) -> List[Dict]:
    '''Every kernel_groups/<group>.json as {'name', 'order', 'patterns'}, in the order in
    which a kernel's name is matched (the first group whose pattern it contains wins).'''
    groups = []
    for path in sorted((bench_dir / 'kernel_groups').glob('*.json')):
        g = read_json(path)
        groups.append({'name': path.stem, 'order': g['order'], 'patterns': g['patterns']})
    return sorted(groups, key=lambda g: (g['order'], g['name']))
