'''The reduction of a traced sub-window: kernel groups by the kernel_groups files, the busy
union, the idle gaps named by the host, and every per-layer reader over a recorded
fixture (perfbench/tests/fixtures/trace_record.json).'''

import json
from pathlib import Path

import pytest

from perfbench.core import cell as cell_lib
from perfbench.core import flops
from perfbench.core import trace

FIXTURE = Path(__file__).resolve().parent / 'fixtures' / 'trace_record.json'


def record(kind='train', units=2):
    rec = json.loads(FIXTURE.read_text())
    rec['device'] = [tuple(e) for e in rec['device']]
    rec['host'] = [tuple(e) for e in rec['host']]
    rec['group_s'] = trace.group_seconds(rec['device'], cell_lib.kernel_groups())
    rec.update(kind=kind, units=units, peak_bytes=12.5e9,
               window={'units': 40, 'seconds': 20.0},
               needed={'flops': 41.36e12, 'attn_flops': 1e9, 'attn_bytes': 1.675e6,
                       'gemm_flops': 0.989e9, 'gemm_bytes': 0.0})
    return rec


def test_groups_follow_the_files():
    g = record()['group_s']
    assert g['attn'] == pytest.approx(2500e-6)
    assert g['gemm'] == pytest.approx(2100e-6)
    assert g['copy'] == pytest.approx(1000e-6)
    assert g['optimizer'] == pytest.approx(500e-6)
    assert g['other'] == pytest.approx(2100e-6)     # the elementwise kernel and the memset


def test_busy_union_and_gaps():
    rec = record()
    # [0, 4500] (overlap merged), [5000, 8000], [8500, 9100]
    assert trace.busy_intervals(rec['device']) == [(0, 4500), (5000, 8000), (8500, 9100)]
    assert trace.busy_seconds(rec['device']) == pytest.approx(8100e-6)
    gaps = trace.idle_gaps(rec['device'], rec['host'])
    assert gaps == [['cudaMemcpyAsync', pytest.approx(500e-6)],
                    ['cudaStreamSynchronize', pytest.approx(500e-6)]]
    ops = trace.top_ops(rec['device'], 2)
    assert ops[0][0].startswith('void at::native::vectorized') and ops[0][1] == pytest.approx(2e-3)


def read(name, rec):
    return cell_lib.load_reader(name)(rec)


def test_train_readers():
    rec = record('train', units=2)
    assert read('mfu.train', rec) == pytest.approx(100 * 41.36e12 * 40 / (20 * 989e12))
    assert read('peak_mem_gb.train', rec) == pytest.approx(12.5)
    assert read('elementwise_ms.train', rec) == pytest.approx(1e3 * 2100e-6 / 2)
    # attn: bound 1e9 / 989e12 s = 1.011 us (bytes 0.5 us) over 2500 us / 2 steps
    assert read('attn_roofline.train', rec) == pytest.approx(
        100 * 2 * flops.bound(1e9, 1.675e6)[0] / 2.5)
    assert read("gemm_roofline.train", rec) == pytest.approx(100 * 2 * (1e3 * 1e-6) / 2.1)
    assert read('idle_share.train', rec) == pytest.approx(100 * (1 - 8100e-6 / 0.01))
    for name in ('mfu.infer', 'copy_ms.infer', 'attn_roofline.infer', 'idle_share.infer'):
        assert read(name, rec) is None


def test_infer_readers():
    rec = record('infer', units=4)
    assert read('copy_ms.infer', rec) == pytest.approx(1e3 * 1000e-6 / 4)
    assert read('idle_share.infer', rec) == pytest.approx(100 * (1 - 8100e-6 / 0.01))
    assert read('mfu.infer', rec) > 0
    assert read('mfu.train', rec) is None


def test_readers_find_nothing_to_read():
    '''A reader with nothing to read returns None, never 0 for a share.'''
    rec = record('train')
    rec['group_s'] = {}
    rec['device'] = []
    assert read('attn_roofline.train', rec) is None
    assert read('gemm_roofline.train', rec) is None
    assert read('idle_share.train', rec) is None
    assert read('elementwise_ms.train', rec) is None
    assert read('mfu.train', None) is None


def test_every_per_layer_metric_has_a_reader():
    bench = json.loads((cell_lib.ROOT / 'BENCHMARK.json').read_text())
    for m in bench['per_layer']:
        assert callable(cell_lib.load_reader(m['name']))
