'''The plain reference (perfbench/reference/seeker.py) against the port's own path at a
tiny size on the CPU: with the port computing in float32, every number that decides
`correct` agrees to rounding; the reference's parameters are the port's, name for name.'''

import time

import pytest
import torch

from perfbench import run as run_mod
from perfbench.reference import seeker as ref
from perfbench.tests.tiny import preset, tiny_cell

CELLS = ('train.divst', 'train.joint', 'infer.divst')


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    preset(monkeypatch)
    torch.set_num_threads(2)


@pytest.mark.parametrize('name', CELLS)
def test_parameters_are_the_ports(name):
    from perfbench.core.program import seeker_config
    from tcow_tpu_torch.models.mask_tracker import MaskTracker
    cell = tiny_cell(name)
    model = MaskTracker(seeker_config(cell.config['model'], None, torch.float32), device='cpu')
    ours = ref.param_shapes(cell.config['model'])
    theirs = {n: tuple(p.shape) for n, p in model.state_dict().items()}
    assert ours == theirs


@pytest.mark.parametrize('name', CELLS)
def test_reference_matches_the_port_in_f32(name):
    cell = tiny_cell(name)
    cell.config['precision']['compute'] = 'float32'
    out = run_mod.run_cell(cell, 2 ** 31 + 11, 0.05, False, 'cpu', time.perf_counter())
    assert all(v < 2e-6 for v in out['readings'].values()), out['readings']


def test_blocked_attention_matches_softmax():
    '''The blocked attention and its backward against autograd through a plain softmax,
    causal and not, with blocks smaller than the sequence.'''
    g = torch.Generator().manual_seed(0)
    q, k, v, dout = (torch.randn(3, 37, 8, generator=g, dtype=torch.float64) for _ in range(4))
    old = ref.ATTN_BLOCK_ELEMS
    ref.ATTN_BLOCK_ELEMS = 3 * 37 * 5
    try:
        for causal in (False, True):
            leaves = [t.clone().requires_grad_() for t in (q, k, v)]
            out = ref.BlockedAttention.apply(*leaves, causal, ref.Precision('f32'))
            grads = torch.autograd.grad(out, leaves, dout)
            plain = [t.clone().requires_grad_() for t in (q, k, v)]
            s = plain[0] @ plain[1].transpose(1, 2) / 8 ** 0.5
            if causal:
                s = s.masked_fill(torch.ones(37, 37, dtype=torch.bool).triu(1), float('-inf'))
            want = torch.softmax(s, -1) @ plain[2]
            want_grads = torch.autograd.grad(want, plain, dout)
            torch.testing.assert_close(out, want)
            for a, b in zip(grads, want_grads):
                torch.testing.assert_close(a, b)
    finally:
        ref.ATTN_BLOCK_ELEMS = old


def test_fp8_rounds_and_passes_gradients_through():
    x = torch.linspace(-3, 3, 101, requires_grad=True)
    y = ref.Precision('fp8')(x)
    assert (y - x).abs().max() > 0
    assert (y - x).abs().max() < 3 * 2 ** -3
    y.sum().backward()
    assert torch.equal(x.grad, torch.ones_like(x))
