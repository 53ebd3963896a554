'''
The plain versions of the port's GEMM kernels (csrc/gemm_sm90.cu) against the JAX
kernel's products on the CPU: the bf16 weight operand the wrapper hands the wgmma kernel
(`gemm_weight`: transpose + one rounding), `gemm_bias_ref` against
jax.lax.dot_general(..., preferred_element_type=f32) + bias + .astype, and `wgrad_ref`
against the dot over rows of pallas_attention.py:655-660, `colsum_ref` against its bias
sums (:657, :660); and the runs of rows of the bf16 weight gradient (`_row_splits` in
multiples of 64). The kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py).
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu_torch.ops import fused_attention as fa

# fp32 tolerance of tests/test_pallas_attention.py:31.
RTOL, ATOL = 2e-4, 2e-5
DTYPES = {'float32': (torch.float32, jnp.float32), 'bfloat16': (torch.bfloat16, jnp.bfloat16)}


def as_f32(t):
    '''A torch or JAX array as float32 numpy (exact for bf16).'''
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t.astype(jnp.float32))


def operands(M, K, N, w_transposed, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(*((N, K) if w_transposed else (K, N))) * K ** -0.5).astype(np.float32)
    bias = (rng.randn(N) * 0.02).astype(np.float32)
    return a, w, bias


@pytest.mark.parametrize('w_transposed', [False, True])
def test_gemm_weight_is_the_jax_cast(w_transposed):
    '''(N, K) bf16, contiguous, the same bits as jnp's .T.astype / .astype.'''
    _, w, _ = operands(4, 40, 24, w_transposed, seed=1)
    got = fa.gemm_weight(torch.from_numpy(w), w_transposed)
    want = jnp.asarray(w).astype(jnp.bfloat16) if w_transposed else \
        jnp.asarray(w).T.astype(jnp.bfloat16)
    assert got.dtype == torch.bfloat16 and got.is_contiguous() and got.shape == (24, 40)
    np.testing.assert_array_equal(as_f32(got), as_f32(want))


@pytest.mark.parametrize('bias', [True, False])
@pytest.mark.parametrize('w_transposed', [False, True])
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_gemm_bias_ref_matches_jax(dtype, w_transposed, bias):
    '''f32: within the tolerance of the Pallas tests (the order of the f32 sums differs);
    bf16: the single rounding of the f32 sum, so the outputs agree bit for bit except
    where the two f32 sums straddle a rounding boundary, and there by one bf16 ulp.'''
    tdt, jdt = DTYPES[dtype]
    a, w, b = operands(37, 48, 40, w_transposed, seed=2)
    b = b if bias else None
    got = fa.gemm_bias_ref(torch.from_numpy(a).to(tdt), torch.from_numpy(w),
                           None if b is None else torch.from_numpy(b), w_transposed)
    ja, jw = jnp.asarray(a).astype(jdt), jnp.asarray(w).astype(jdt)
    dims = (((1,), (1,)), ((), ())) if w_transposed else (((1,), (0,)), ((), ()))
    want = jax.lax.dot_general(ja, jw, dims, preferred_element_type=jnp.float32)
    if b is not None:
        want = want + jnp.asarray(b)
    want = want.astype(jdt)
    assert got.dtype == tdt and tuple(got.shape) == (37, 40)
    if dtype == 'float32':
        np.testing.assert_allclose(as_f32(got), as_f32(want), rtol=RTOL, atol=ATOL)
    else:
        g, x = as_f32(got), as_f32(want)
        ulp = np.abs(x) * 2.0 ** -7
        assert np.all(np.abs(g - x) <= ulp)
        assert np.mean(g != x) <= 0.01


@pytest.mark.parametrize('dtype', list(DTYPES))
def test_wgrad_ref_matches_jax(dtype):
    '''a^T . b over the rows in f32, as dot_general over dimension 0 of both operands with
    f32 accumulation; the products of bf16 operands are exact in f32.'''
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(3)
    a, b = rng.randn(150, 24).astype(np.float32), rng.randn(150, 40).astype(np.float32)
    got = fa.wgrad_ref(torch.from_numpy(a).to(tdt), torch.from_numpy(b).to(tdt))
    want = jax.lax.dot_general(jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt),
                               (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (24, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('M,N', [(1, 8), (150, 40), (1001, 2304)])
@pytest.mark.parametrize('dtype', list(DTYPES))
def test_colsum_ref_matches_jax(dtype, M, N):
    '''The f32 sum of the rows, as the JAX kernel's jnp.sum(x.astype(f32), axis=0) bias
    gradients (pallas_attention.py:657, :660): exact inputs in bf16, the order of the f32
    sums differing only.'''
    tdt, jdt = DTYPES[dtype]
    a = np.random.RandomState(M + N).randn(M, N).astype(np.float32)
    got = fa.colsum_ref(torch.from_numpy(a).to(tdt))
    want = jnp.sum(jnp.asarray(a).astype(jdt), axis=0, dtype=jnp.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (N,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('M,K,N', [(1, 64, 96), (63, 768, 768), (1000, 768, 2304),
                                   (18060, 768, 768), (54000, 768, 2304), (54180, 768, 768)])
def test_wgrad_splits_cover_the_rows(M, K, N):
    '''The bf16 wgrad's runs, as `_wgrad` picks them for its 128 x 256 tiles: a multiple of
    64 rows, the last one ending at M and none empty, so the kernel's stages never mix two
    runs; at the training shapes about two waves of 132 SMs.'''
    tiles = -(-K // 128) * -(-N // 256)
    splits, rows = fa._row_splits(M, tiles, 64)
    assert rows % 64 == 0 and splits * rows >= M > (splits - 1) * rows
    if M >= 54000:
        assert 264 <= tiles * splits < 264 + tiles
