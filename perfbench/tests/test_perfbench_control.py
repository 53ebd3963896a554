'''`correct` comes out false where it should. On the CPU at a tiny size: the control (the
reference in fp8 put in the program's place) reads well above the program, and a run whose
timed path is broken underneath (tools/faults.py: a step that leaves the state unchanged,
half of the batch left out, the loss scaled, an answer altered where it is produced) is
judged not correct under the cell's limits. On the card (marked cuda): the control at the
cell's own size, on three seeds, fails the cell's limits.'''

import json
import time

import pytest
import torch

from perfbench import run as run_mod
from perfbench.core import cell as cell_lib
from perfbench.core import correct
from perfbench.tests.tiny import preset, tiny_cell
from perfbench.tools import faults

FAULTS = {'train.divst': ('unchanged', 'half_batch', 'loss_scale'),
          'train.joint': ('unchanged', 'half_batch', 'loss_scale'),
          'infer.divst': ('altered', 'half_batch')}
CELLS = [w['name'] for w in json.loads((cell_lib.ROOT / 'BENCHMARK.json').read_text())
         ['workloads']]


@pytest.fixture
def tiny(monkeypatch):
    preset(monkeypatch)
    torch.set_num_threads(2)


@pytest.mark.parametrize('name,fault', [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_broken_timed_path_is_not_correct(tiny, name, fault):
    '''The harness's run without its look for a chip, the program broken underneath.'''
    cell = tiny_cell(name)
    with faults.planted(fault):
        out = run_mod.run_cell(cell, 2 ** 31 + 5, 0.05, False, 'cpu', time.perf_counter())
    line = run_mod.result_line(cell, out, False, out['readings'], cell.workload['limits'],
                               {'platform': 'cpu'})
    assert line['correct'] is False, out['readings']


def test_faults_are_lifted_after_the_context(tiny):
    from tcow_tpu_torch.train import step as step_lib
    before = (step_lib.make_train_step, step_lib.backward_loss)
    for fault in faults.FAULTS:
        with faults.planted(fault):
            pass
    assert (step_lib.make_train_step, step_lib.backward_loss) == before


@pytest.mark.parametrize('name', list(FAULTS))
def test_control_reads_far_above_the_program(tiny, name):
    cell = tiny_cell(name)
    drv = cell_lib.driver(cell)
    prog = drv.run(cell, 21, 0.05, False, 'cpu', time.perf_counter())['readings']
    ctl = drv.control_readings(cell, 21, 'cpu')
    assert any(ctl[k] >= 3 * prog[k] for k in cell.workload['limits']), (prog, ctl)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')


@pytest.mark.cuda
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_the_limits_on_the_card(card, name):
    cell = cell_lib.load_cell(name)
    drv = cell_lib.driver(cell)
    for seed in (2 ** 31 + 101, 2 ** 31 + 102, 2 ** 31 + 103):
        readings = drv.control_readings(cell, seed, 'cuda')
        assert not correct.judge(readings, cell.workload['limits']), readings
