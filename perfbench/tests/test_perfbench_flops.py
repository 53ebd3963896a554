'''The frozen operation counts of perfbench/core/flops.py against chip_smoke.py's own cost
functions at the cells' shapes, and the split of a forward into attention cores and GEMMs.'''

import json

import pytest

from perfbench.core import cell as cell_lib
from perfbench.core import flops
from perfbench.tests.tiny import cell_of

CELLS = ('train.divst', 'infer.divst', 'train.joint')


def model_of(name):
    return cell_of(name).config['model']


@pytest.fixture(scope='module')
def cs():
    return pytest.importorskip('chip_smoke')


@pytest.mark.parametrize('name', CELLS)
def test_forward_and_step_counts_match_chip_smoke(cs, name):
    cell = cell_of(name)
    m = cell.config['model']
    rows = cell.traffic['clips'] * cell.traffic.get('queries', 1)
    if m['attention_type'] == 'divided_space_time':
        from tcow_tpu_torch.models.mask_tracker import seeker_config_from_args
        cfg = seeker_config_from_args(cs.SEEKER_ARGS)
        assert flops.seeker_forward_flops(m, rows) == cs.seeker_forward_flops(cfg, rows)
    else:
        assert flops.joint_forward_flops(m, rows) == cs.joint_forward_flops(rows)
    assert flops.step_flops(m, rows) == 3 * flops.forward_flops(m, rows)


@pytest.mark.parametrize('S,ca', [(30, 1), (301, 0), (9001, 0), (17, 3)])
def test_kernel_counts_match_chip_smoke(cs, S, ca):
    width = (768, 12)
    assert flops.attended_pairs(S, ca) == cs.attended_pairs(S, ca)
    assert flops.k1_flops(6, S, ca, width) == cs.k1_flops(6, S, ca)
    assert flops.k4_flops(6, S, ca, width) == cs.k4_flops(6, S, ca)
    assert flops.bound(1e12, 1e9) == cs.bound(1e12, 1e9)


@pytest.mark.parametrize('name', CELLS)
@pytest.mark.parametrize('train', [False, True])
def test_cores_and_gemms_add_up_to_the_whole(name, train):
    m = model_of(name)
    rows = 6
    whole = flops.step_flops(m, rows) if train else flops.forward_flops(m, rows)
    assert flops.attention_core(m, rows, train)[0] + flops.gemms(m, rows, train)[0] == whole


def test_record_step_bound_is_chip_smokes():
    '''The step of record's matmul bound, 41.82 ms (PERF.md), from the frozen counts.'''
    m = model_of('train.divst')
    assert abs(1e3 * flops.step_flops(m, 6) / flops.PEAK_BF16_FLOPS - 41.82) < 0.01


def test_configs_are_json():
    for path in (cell_lib.BENCH_DIR / 'configs').glob('*.json'):
        json.loads(path.read_text())
