'''
Port attention (tcow_tpu_torch.ops.fused_attention) against the JAX reference: the plain
XLA version and the Pallas kernel in interpret mode, on the CPU in float32.
'''

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.ops import pallas_attention as pa
from tcow_tpu_torch.ops import fused_attention as fa

# fp32 tolerance of tests/test_pallas_attention.py:31.
RTOL, ATOL = 2e-4, 2e-5


def make_inputs(B=5, S=13, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, D).astype(np.float32) * 0.5,
            (rng.randn(D, 3 * D) * 0.05).astype(np.float32),
            (rng.randn(3 * D) * 0.01).astype(np.float32),
            (rng.randn(D, D) * 0.05).astype(np.float32),
            (rng.randn(D) * 0.01).astype(np.float32))


def port(args, num_heads, ca):
    return fa.fused_attention(*map(torch.from_numpy, args), num_heads, ca).numpy()


@pytest.mark.parametrize('ca', [0, 1, 3])
@pytest.mark.parametrize('S', [13, 30])
def test_matches_jax_attention_ref(ca, S):
    args = make_inputs(S=S)
    want = pa.attention_ref(*args, num_heads=4, causal_attention=ca)
    np.testing.assert_allclose(port(args, 4, ca), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('ca', [0, 1, 3])
@pytest.mark.parametrize('S', [13, 30])
def test_matches_pallas_kernel_interpret(ca, S):
    args = make_inputs(S=S, seed=1)
    want = pa._fused_attention_fwd_impl(*args, 4, ca, interpret=True)[0]
    np.testing.assert_allclose(port(args, 4, ca), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_cpu_path_does_not_count_launches():
    before = fa.fused_attention.launches
    port(make_inputs(B=2, S=7), 4, 1)
    assert fa.fused_attention.launches == before


def test_other_devices_raise():
    x, *w = (torch.from_numpy(a).to('meta') for a in make_inputs(B=2, S=7))
    with pytest.raises(ValueError, match='cpu or cuda'):
        fa.fused_attention(x, *w, 4, 0)
