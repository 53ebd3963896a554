'''Cells at a size a CPU test can hold: the configurations' files with every size cut
down (depth 2, D 32, 4 heads, T 4 at 32x48), for the tests of perfbench/tests.'''

import copy

from perfbench.core import cell as cell_lib

TINY_MODEL = dict(embed_dim=32, num_heads=4, mlp_dim=128, network_depth=2, num_total_frames=4,
                  frame_height=32, frame_width=48)
TINY_MIX = dict(clips=2, frames=4, height=32, width=48, instances=3, max_instances=4, pool=3,
                trace_units=1, warmup=1, check_requests=2)
# The request driver (drivers/infer.py) has no cell yet: its tests run it on the record's
# configuration and the request mix, with the limit of its mask logits.
REQUEST = ('tcow_vitb16_divst', 'request_2clip', {'mask_gap': 0.05})


def request_cell() -> cell_lib.Cell:
    config, traffic, limits = REQUEST
    return cell_lib.Cell(
        name='infer.divst', config=cell_lib.read_json(cell_lib.BENCH_DIR / 'configs'
                                                      / f'{config}.json'),
        traffic=cell_lib.read_json(cell_lib.BENCH_DIR / 'traffic' / f'{traffic}.json'),
        workload={'limits': limits}, chips=1, end_to_end=[], per_layer=[])


def cell_of(name: str) -> cell_lib.Cell:
    '''The cell `name` of BENCHMARK.json, or the request cell, 'infer.divst'.'''
    return request_cell() if name == 'infer.divst' else cell_lib.load_cell(name)


def tiny_cell(name: str) -> cell_lib.Cell:
    '''cell_of(name) with its sizes cut down and its own limits.'''
    cell = copy.deepcopy(cell_of(name))
    cell.config['model'].update(TINY_MODEL)
    for k, v in TINY_MIX.items():
        if k in cell.traffic:
            cell.traffic[k] = v
    return cell


def preset(monkeypatch):
    '''The program's depth preset for the tiny width.'''
    from tcow_tpu_torch.models import timesformer as tsf
    monkeypatch.setitem(tsf.DEPTH_PRESETS, TINY_MODEL['network_depth'],
                        (TINY_MODEL['embed_dim'], TINY_MODEL['num_heads']))
