'''BENCHMARK.json keeps the contract's shape, and a cell, a configuration, a traffic mix, a
metric or a kernel group is added by adding files and entries: nothing existing is
edited.'''

import json
import re
import shutil
import time

import pytest
import torch

from perfbench import run as run_mod
from perfbench.core import cell as cell_lib
from perfbench.tests.tiny import TINY_MIX, TINY_MODEL, cell_of, preset

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')


def bench():
    return json.loads((cell_lib.ROOT / 'BENCHMARK.json').read_text())


def test_benchmark_json_shape():
    b = bench()
    assert set(b) == {'command', 'paths', 'run_seconds', 'configs', 'workloads',
                      'end_to_end', 'per_layer'}
    assert b['paths'] == ['perfbench'] and 1 <= b['run_seconds'] <= 51
    names = [c['name'] for c in b['configs']] + [w['name'] for w in b['workloads']] \
        + [m['name'] for m in b['end_to_end'] + b['per_layer']]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    e2e = {m['name']: m for m in b['end_to_end']}
    assert 'setup_s' in e2e and all(0.01 <= m['bound'] <= 0.25 for m in e2e.values())
    for m in b['end_to_end'] + b['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in b['per_layer']:
        assert set(m) <= {'name', 'unit', 'better', 'source', 'layer', 'moves', 'workloads'}
        assert m['moves'] in e2e
        for w in m['workloads']:
            cell = cell_lib.load_cell(w)
            assert m['moves'] in {e['name'] for e in cell.end_to_end}
    for w in b['workloads']:
        cell = cell_lib.load_cell(w['name'])
        assert len(w['why']) <= 200 and w['chips'] == 1
        assert any(m['name'] == 'setup_s' for m in cell.end_to_end)
        assert len(cell.end_to_end) >= 2 and cell.per_layer
    for c in b['configs']:
        assert c['file'].startswith('perfbench/configs/')
        assert json.loads((cell_lib.ROOT / c['file']).read_text())['reduced'] == c['reduced']
    assert len(json.dumps(b)) < 64 * 1024


def test_a_new_cell_needs_no_edit(tmp_path, monkeypatch):
    '''Copy the benchmark, add a configuration, a traffic mix, a cell, a kernel group and a
    metric as new files and entries, and run the new cell (tiny, on the CPU): the files
    that were there are left as they were.'''
    root = tmp_path / 'checkout'
    shutil.copytree(cell_lib.BENCH_DIR, root / 'perfbench',
                    ignore=shutil.ignore_patterns('__pycache__'))
    shutil.copy(cell_lib.ROOT / 'BENCHMARK.json', root / 'BENCHMARK.json')
    before = {p: p.read_bytes() for p in root.rglob('*') if p.is_file()}
    bd = root / 'perfbench'
    conf = json.loads((bd / 'configs' / 'tcow_vitb16_divst.json').read_text())
    conf['name'] = 'tiny_divst'
    conf['model'].update(TINY_MODEL)
    (bd / 'configs' / 'tiny_divst.json').write_text(json.dumps(conf))
    mix = json.loads((bd / 'traffic' / 'train_2x3.json').read_text())
    mix.update({k: v for k, v in TINY_MIX.items() if k in mix})
    (bd / 'traffic' / 'tiny_train.json').write_text(json.dumps(mix))
    (bd / 'workloads' / 'train.tiny.json').write_text(json.dumps(
        {'limits': {'loss_gap': 1.0, 'grad_gap': 1.0, 'change_gap': 1.0}}))
    (bd / 'kernel_groups' / 'norms.json').write_text(json.dumps(
        {'order': 25, 'patterns': ['layer_norm']}))
    (bd / 'metrics' / 'steps.train.py').write_text(
        "def read(rec):\n    return None if rec is None else float(rec['window']['units'])\n")
    b = json.loads((root / 'BENCHMARK.json').read_text())
    b['configs'].append({'name': 'tiny_divst', 'source': 'https://example.org/tiny',
                         'file': 'perfbench/configs/tiny_divst.json', 'reduced': [],
                         'why': 'a test'})
    b['workloads'].append({'name': 'train.tiny', 'config': 'tiny_divst',
                           'traffic': 'tiny_train', 'chips': 1, 'why': 'a test'})
    b['end_to_end'][0]['workloads'].append('train.tiny')
    b['per_layer'].append({'name': 'steps.train', 'unit': 'steps', 'better': 'higher',
                           'source': 'host_clock', 'layer': 'train step',
                           'moves': 'train_clips_per_s', 'workloads': ['train.tiny']})
    (root / 'BENCHMARK.json').write_text(json.dumps(b))

    cell = cell_lib.load_cell('train.tiny', bench_dir=bd, root=root)
    assert [m['name'] for m in cell.per_layer] == ['steps.train']
    assert 'norms' in [g['name'] for g in cell_lib.kernel_groups(bd)]
    preset(monkeypatch)
    torch.set_num_threads(2)
    out = run_mod.run_cell(cell, 3, 0.05, False, 'cpu', time.perf_counter())
    assert out['attempted'] >= 1 and out['e2e']['train_clips_per_s'] > 0
    reader = cell_lib.load_reader('steps.train', bd)
    assert reader({'window': {'units': 3}}) == 3.0
    for p, data in before.items():
        if p.name != 'BENCHMARK.json':
            assert p.read_bytes() == data, p


@pytest.mark.parametrize('name', ['train.divst', 'infer.divst', 'train.joint'])
def test_traffic_fits_its_configuration(name):
    cell = cell_of(name)
    m, mix = cell.config['model'], cell.traffic
    assert (mix['frames'], mix['height'], mix['width']) == (
        m['num_total_frames'], m['frame_height'], m['frame_width'])


def test_end_to_end_metrics_name_the_drivers_quantities():
    """An end-to-end metric reads its driver's quantity, the part of its name before the
    first dot, so that a cell can have a bound of its own for the same quantity."""
    b = bench()
    quantities = {'train': {'train_clips_per_s', 'setup_s'},
                  'infer': {'infer_clips_per_s', 'infer_p95_ms', 'setup_s'}}
    for w in b['workloads']:
        cell = cell_lib.load_cell(w['name'])
        kind = cell.traffic['kind']
        assert cell_lib.driver(cell).__name__ == f'perfbench.drivers.{kind}'
        for m in cell.end_to_end:
            assert cell_lib.quantity(m['name']) in quantities[kind], m['name']
    assert cell_lib.quantity('train_clips_per_s.joint') == 'train_clips_per_s'
