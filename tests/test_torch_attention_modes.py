'''
The port's four attention-backward modes (tcow_tpu_torch.ops.fused_attention with
bwd_mode 'res', 'kernel_qkv', 'kernel_x', 'kernel_x_wg') against the JAX reference on the
CPU in float32: pallas_attention.fused_attention with the same mode, its Pallas kernels in
interpret mode; and the plain versions of K2 (qkv), K3 (probabilities), K5 (backward from
qkv) and K6 (in-kernel weight gradients) against the Pallas calls they replace.
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.ops import pallas_attention as pa
from tcow_tpu_torch.ops import fused_attention as fa

# fp32 tolerance of tests/test_pallas_attention.py:31.
RTOL, ATOL = 2e-4, 2e-5
HEADS = 4
GEOMETRIES = [(ca, S) for ca in (0, 1, 3) for S in (7, 17)]
GRAD_NAMES = ('dx', 'dqkv_w', 'dqkv_b', 'dproj_w', 'dproj_b')
COUNTERS = (fa.fused_attention, fa.fused_attention_fwd_qkv, fa.fused_attention_fwd_res,
            fa.fused_attention_bwd, fa.fused_attention_bwd_qkv, fa.fused_attention_bwd_wg)


@pytest.fixture
def interpret():
    old = pa.INTERPRET
    pa.INTERPRET = True
    yield
    pa.INTERPRET = old


def make_inputs(B=3, S=7, D=32, seed=0):
    '''x, qkv_w, qkv_b, proj_w, proj_b and an incoming gradient g, float32 numpy.'''
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, D).astype(np.float32) * 0.5,
            (rng.randn(D, 3 * D) * 0.1).astype(np.float32),
            (rng.randn(3 * D) * 0.01).astype(np.float32),
            (rng.randn(D, D) * 0.1).astype(np.float32),
            (rng.randn(D) * 0.01).astype(np.float32),
            rng.randn(B, S, D).astype(np.float32))


def assert_close(got, want, name=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=name)


@pytest.mark.parametrize('mode', fa.BWD_MODES)
@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_mode_matches_pallas_fused_attention(interpret, mode, ca, S):
    '''The output and all five gradients of one differentiable call.'''
    *args, g = make_inputs(S=S, seed=S + ca)
    out, vjp = jax.vjp(lambda *a: pa.fused_attention(*a, None, HEADS, ca, mode), *args)
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    got = fa.fused_attention(*leaves, HEADS, ca, mode)
    got.backward(torch.from_numpy(g))
    assert_close(got.detach(), out, 'out')
    for name, leaf, w in zip(GRAD_NAMES, leaves, want):
        assert_close(leaf.grad, w, name)


@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_k2_returns_the_pallas_qkv(ca, S):
    *args, _ = make_inputs(S=S, seed=1)
    out, qkv, _, _ = pa._fused_attention_fwd_impl(*args, HEADS, ca, interpret=True,
                                                  want_residuals='qkv')
    got_out, got_qkv = fa.fused_attention_fwd_qkv(*map(torch.from_numpy, args), HEADS, ca)
    assert got_qkv.shape == (3, S, 96)
    assert_close(got_out, out, 'out')
    assert_close(got_qkv, np.asarray(qkv)[:3, :S], 'qkv')   # the Pallas qkv is padded


@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_k3_probs_are_the_diagonal_blocks_of_the_packed_probs(ca, S):
    '''K3's per-sequence (B, H, S, S) probabilities against the diagonal blocks of the
    Pallas kernel's packed (B_pad/pack, H, SP, SP) probabilities; qkv and attn too.'''
    B = 5
    *args, _ = make_inputs(B=B, S=S, seed=2)
    out, qkv, probs, attn = pa._fused_attention_fwd_impl(*args, HEADS, ca, interpret=True)
    _, _, _, S_pad, pack, _, _ = pa._geometry(jnp.asarray(args[0]), HEADS)
    got = fa.fused_attention_fwd_res(*map(torch.from_numpy, args), HEADS, ca)
    assert got[2].shape == (B, HEADS, S, S)
    probs = np.asarray(probs)
    diag = np.stack([probs[b // pack, :, (b % pack) * S_pad:(b % pack) * S_pad + S,
                           (b % pack) * S_pad:(b % pack) * S_pad + S] for b in range(B)])
    for name, a, w in zip(('out', 'qkv', 'probs', 'attn'), got,
                          (out, np.asarray(qkv)[:B, :S], diag, np.asarray(attn)[:B, :S])):
        assert_close(a, w, name)
    np.testing.assert_allclose(got[2].sum(-1).numpy(), 1.0, rtol=1e-5)


@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_k5_matches_the_pallas_backward_from_qkv(ca, S):
    '''K5's plain version from the saved qkv, with the weight products of the backward,
    against _fused_attention_bwd_impl(qkv=...).'''
    *args, g = make_inputs(S=S, seed=3)
    x, qkv_w, qkv_b, proj_w, proj_b = args
    _, qkv, _, _ = pa._fused_attention_fwd_impl(*args, HEADS, ca, interpret=True,
                                                want_residuals='qkv')
    want = pa._fused_attention_bwd_impl(x, g, qkv_w, qkv_b, proj_w, qkv, HEADS, ca,
                                        interpret=True)
    t = torch.from_numpy
    dqkv, attn = fa.fused_attention_bwd_qkv(t(np.array(qkv)[:3, :S]), t(g), t(proj_w),
                                            HEADS, ca)
    got = fa._weight_grads(t(x), t(g), dqkv, attn, t(qkv_w))
    for name, a, w in zip(GRAD_NAMES, got, want):
        assert_close(a, w, name)


@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_k6_matches_the_pallas_inkernel_weight_gradients(ca, S):
    *args, g = make_inputs(S=S, seed=4)
    x, qkv_w, qkv_b, proj_w, _ = args
    want = pa._fused_attention_bwd_impl(x, g, qkv_w, qkv_b, proj_w, None, HEADS, ca,
                                        interpret=True, inkernel_wgrads=True)
    got = fa.fused_attention_bwd_wg(*map(torch.from_numpy, (x, g, qkv_w, qkv_b, proj_w)),
                                    HEADS, ca)
    assert got[0].dtype == torch.float32 and got[1].shape == (32, 96)
    for name, a, w in zip(GRAD_NAMES, got, want):
        assert_close(a, w, name)


def test_res_backward_rounds_where_jax_rounds():
    '''In bf16 the 'res' backward gives gradients of the parameters' and x's dtypes that
    equal the f32 backward up to bf16 roundings (8 mantissa bits).'''
    *args, g = map(torch.from_numpy, make_inputs(S=17, seed=5))
    xb, gb = args[0].to(torch.bfloat16), g.to(torch.bfloat16)
    _, qkv, probs, attn = fa.attention_res_ref(xb, *args[1:], HEADS, 1)
    got = fa.attention_bwd_res(xb, gb, qkv, probs, attn, args[1], args[3], HEADS)
    _, qkv32, probs32, attn32 = fa.attention_res_ref(xb.float(), *args[1:], HEADS, 1)
    want = fa.attention_bwd_res(xb.float(), gb.float(), qkv32, probs32, attn32, args[1],
                                args[3], HEADS)
    assert [t.dtype for t in got] == [torch.bfloat16] + [torch.float32] * 4
    for a, b in zip(got, want):
        err = float((a.double() - b.double()).norm() / b.double().norm())
        assert err < 2e-2, err


@pytest.mark.parametrize('mode', fa.BWD_MODES)
def test_a_call_without_gradients_runs_k1_in_every_mode(mode, monkeypatch):
    '''No gradient needed (no_grad, or no input that requires one): K1 alone, no
    residuals, and the call is counted under its mode.'''
    ran = []
    k1 = fa.fused_attention_fwd
    monkeypatch.setattr(fa, 'fused_attention_fwd', lambda *a: ran.append(1) or k1(*a))
    *args, _ = map(torch.from_numpy, make_inputs(seed=6))
    before = fa.fused_attention.calls[mode]
    with torch.no_grad():
        out = fa.fused_attention(*[a.requires_grad_() for a in args], HEADS, 1, mode)
    plain = fa.fused_attention(*[a.detach() for a in args], HEADS, 1, mode)
    assert out.grad_fn is None and plain.grad_fn is None and len(ran) == 2
    assert fa.fused_attention.calls[mode] == before + 2
    torch.testing.assert_close(out, fa.attention_ref(*[a.detach() for a in args], HEADS, 1))


def test_cpu_modes_count_no_launches():
    before = [c.launches for c in COUNTERS]
    *args, g = make_inputs(B=2, S=7, seed=7)
    for mode in fa.BWD_MODES:
        leaves = [torch.from_numpy(a).requires_grad_() for a in args]
        fa.fused_attention(*leaves, HEADS, 1, mode).backward(torch.from_numpy(g))
    assert [c.launches for c in COUNTERS] == before


def test_unknown_mode_and_other_devices_raise():
    *args, _ = map(torch.from_numpy, make_inputs(B=2, S=7))
    with pytest.raises(ValueError, match='bwd_mode'):
        fa.fused_attention(*args, HEADS, 0, 'kernel_y')
    meta = [a.to('meta') for a in args]
    for fn in (fa.fused_attention_fwd_qkv, fa.fused_attention_fwd_res):
        with pytest.raises(ValueError, match='cpu or cuda'):
            fn(*meta, HEADS, 0)
    with pytest.raises(ValueError, match='cpu or cuda'):
        fa.fused_attention_bwd_wg(meta[0], meta[0], *meta[1:4], HEADS, 0)
    with pytest.raises(ValueError, match='cpu or cuda'):
        fa.fused_attention_bwd_qkv(meta[1][None].expand(2, 32, 96), meta[0], meta[3],
                                   HEADS, 0)
