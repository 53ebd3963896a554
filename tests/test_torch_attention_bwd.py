'''
The port's attention backward (K4's plain version `attention_bwd_ref`, its core alone
`attention_bwd_core_ref`, and the differentiable `fused_attention` in its 'kernel_x'
mode) against the JAX reference on the
CPU in float32: the Pallas backward kernel in interpret mode (_fused_attention_bwd_impl
with qkv=None, the 'kernel_x' mode) and jax.grad of the plain XLA attention.
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.ops import pallas_attention as pa
from tcow_tpu_torch.ops import fused_attention as fa

# fp32 backward tolerance of tests/test_pallas_attention.py:93-98.
RTOL, ATOL = 2e-4, 2e-5
HEADS = 4
GEOMETRIES = [(ca, S) for ca in (0, 1, 3) for S in (13, 30)]


def make_inputs(B=5, S=13, D=64, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, D).astype(np.float32) * 0.5,
            (rng.randn(D, 3 * D) * 0.05).astype(np.float32),
            (rng.randn(3 * D) * 0.01).astype(np.float32),
            (rng.randn(D, D) * 0.05).astype(np.float32),
            (rng.randn(D) * 0.01).astype(np.float32),
            rng.randn(B, S, D).astype(np.float32))            # incoming gradient g


def port_grads(x, qkv_w, qkv_b, proj_w, proj_b, g, ca):
    '''(out, grads of x and the four weights) of the port's 'kernel_x' mode for
    cotangent g.'''
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, qkv_w, qkv_b, proj_w, proj_b)]
    out = fa.fused_attention(*leaves, HEADS, ca, 'kernel_x')
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [t.grad.numpy() for t in leaves]


def jax_core(qkv, ca):
    '''Pre-projection attention from qkv (B, S, 3D) in JAX (pallas_attention.py:54-84).'''
    B, S, D3 = qkv.shape
    D = D3 // 3
    dh = D // HEADS
    q, k, v = (jnp.moveaxis(a, 2, 1) for a in
               jnp.moveaxis(qkv.reshape(B, S, 3, HEADS, dh), 2, 0))
    logits = jnp.einsum('bhqd,bhkd->bhqk', q, k) * dh ** -0.5
    if ca > 0:
        logits = jnp.where(jnp.tril(jnp.ones((S, S), bool), k=fa._mask_diag(ca)), logits,
                           jnp.float32(-1e10))
    out = jnp.einsum('bhqk,bhkd->bhqd', jax.nn.softmax(logits, axis=-1), v)
    return jnp.moveaxis(out, 1, 2).reshape(B, S, D)


@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_bwd_ref_matches_jax_vjp(ca, S):
    '''dqkv and attn of attention_bwd_ref against jax.vjp of the attention core.'''
    x, qkv_w, qkv_b, proj_w, _, g = make_inputs(S=S, seed=2)
    qkv = jnp.einsum('bsd,de->bse', x, qkv_w) + qkv_b
    attn, vjp = jax.vjp(lambda t: jax_core(t, ca), qkv)
    (dqkv,) = vjp(jnp.einsum('bsd,ed->bse', g, proj_w))
    got_dqkv, got_attn = fa.attention_bwd_ref(
        *map(torch.from_numpy, (x, g, qkv_w, qkv_b, proj_w)), HEADS, ca)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(attn), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_dqkv.numpy(), np.asarray(dqkv), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_bwd_core_ref_matches_jax_vjp(ca, S):
    '''The backward core alone, attention_bwd_core_ref from qkv and dattn (what the bf16
    kernels attn_bwd_q_mma + attn_bwd_kv_mma compute), against jax.vjp of the attention
    core with dattn as the cotangent.'''
    rng = np.random.RandomState(5)
    qkv = (rng.randn(5, S, 3 * 64) * 0.5).astype(np.float32)
    dattn = rng.randn(5, S, 64).astype(np.float32)
    attn, vjp = jax.vjp(lambda t: jax_core(t, ca), qkv)
    (dqkv,) = vjp(jnp.asarray(dattn))
    got_dqkv, got_attn = fa.attention_bwd_core_ref(torch.from_numpy(qkv),
                                                   torch.from_numpy(dattn), HEADS, ca)
    np.testing.assert_allclose(got_attn.numpy(), np.asarray(attn), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_dqkv.numpy(), np.asarray(dqkv), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_function_grads_match_pallas_bwd_interpret(ca, S):
    x, qkv_w, qkv_b, proj_w, proj_b, g = make_inputs(S=S, seed=1)
    want = pa._fused_attention_bwd_impl(x, g, qkv_w, qkv_b, proj_w, None, HEADS, ca,
                                        interpret=True)
    _, got = port_grads(x, qkv_w, qkv_b, proj_w, proj_b, g, ca)
    for name, a, b in zip(('dx', 'dqkv_w', 'dqkv_b', 'dproj_w', 'dproj_b'), got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.mark.parametrize('ca,S', GEOMETRIES)
def test_function_grads_match_jax_grad(ca, S):
    x, qkv_w, qkv_b, proj_w, proj_b, g = make_inputs(S=S, seed=3)
    out, vjp = jax.vjp(lambda *a: pa.attention_ref(*a, HEADS, ca),
                       x, qkv_w, qkv_b, proj_w, proj_b)
    want = vjp(jnp.asarray(g))
    got_out, got = port_grads(x, qkv_w, qkv_b, proj_w, proj_b, g, ca)
    np.testing.assert_allclose(got_out, np.asarray(out), rtol=RTOL, atol=ATOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=ATOL)


def test_bwd_ref_rounds_where_the_kernel_rounds():
    '''In bf16 every output of the plain version is a bf16 value, and it equals the f32
    plain version up to the roundings of bf16 (8 mantissa bits).'''
    x, qkv_w, qkv_b, proj_w, _, g = map(torch.from_numpy, make_inputs(S=30, seed=4))
    xb, gb = x.to(torch.bfloat16), g.to(torch.bfloat16)
    dqkv, attn = fa.attention_bwd_ref(xb, gb, qkv_w, qkv_b, proj_w, HEADS, 1)
    assert dqkv.dtype == attn.dtype == torch.bfloat16
    dqkv32, attn32 = fa.attention_bwd_ref(xb.float(), gb.float(), qkv_w, qkv_b, proj_w,
                                          HEADS, 1)
    for a, b in ((dqkv, dqkv32), (attn, attn32)):
        err = float((a.double() - b.double()).norm() / b.double().norm())
        assert 0 < err < 2e-2, err


def test_cpu_backward_does_not_count_launches():
    before = (fa.fused_attention.launches, fa.fused_attention_bwd.launches)
    port_grads(*make_inputs(B=2, S=7), 1)
    assert (fa.fused_attention.launches, fa.fused_attention_bwd.launches) == before


def test_backward_of_other_devices_raises():
    x, qkv_w, qkv_b, proj_w, _, g = (torch.from_numpy(a).to('meta')
                                     for a in make_inputs(B=2, S=7))
    with pytest.raises(ValueError, match='cpu or cuda'):
        fa.fused_attention_bwd(x, g, qkv_w, qkv_b, proj_w, HEADS, 0)
