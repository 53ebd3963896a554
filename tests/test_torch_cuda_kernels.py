'''
The CUDA kernels of tcow_tpu_torch against their plain versions, on the GPU only: edge
geometries that the full-width run in chip_smoke.py does not reach (S=1, ragged row,
column and depth tiles, head sizes 32, 40, 64 and 128, every causal mode) for the
forwards K1, K2 and K3 and the backwards K4, K5 and K6, the bf16 attention core's tiles
(K1, K3, K1r at lengths around 16 and 64 and head sizes 4 to 128; K1 and K3 identical
across runs, K3's probabilities) and the bf16 backward core's (K4, K5, K4r and K6 at the
same lengths and head sizes; K4 and K5 identical across runs), K6's weight gradients identical
across runs, the gradients of the differentiable fused_attention on the card, and the
launch counts of the seeker's entry points and of one train step under each pairing of a
backward mode with its remat policy; and the rope variants K1r ... K6r (head sizes 32,
64 and 128, where the rotation's partner element sits in another lane or the same one,
with row positions and per-row frame times), a rope train step per pairing, and
run_plugin of a time-calibrated rope seeker; and the bf16 GEMMs of every chain (gemm_bias
at rows 1-1000, widths 8-2304 and depths 8-2304, W and W^T, with and without bias; wgrad
at the same rows and 54,000; colsum at 1 to 54,181 rows in bf16 and f32, and its refusal of
unaligned rows), each against its f32 result and bit-equal on a rerun; and the device side
of training at a tiny width (the colour augmentations against the CPU, the launches of a
grad_accum=2, LAMB and remat_group=2 step); and the training driver's host side (a Kubric
batch through _H2DPrefetcher bit-equal to unpack_batch, one driver epoch on the card).
Every test carries the `cuda` marker and skips without CUDA. The file imports neither JAX
nor the tests' conftest, so on a GPU machine without JAX it runs as:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py -q
'''

import numpy as np
import pytest
import torch

from tcow_tpu_torch.data.synthetic import (synthetic_color_augs, synthetic_device_batch,
                                           synthetic_frame_times)
from tcow_tpu_torch.evaluation.inference import InferenceEngine
from tcow_tpu_torch.models import timesformer as tsf
from tcow_tpu_torch.models.mask_tracker import MaskTracker, SeekerConfig, seeker_config_from_args
from tcow_tpu_torch.models.seeker import Seeker
from tcow_tpu_torch.objectives.losses import LossConfig
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.train import optim
from tcow_tpu_torch.train import step as step_lib
from tcow_tpu_torch.train.checkpoint import save_checkpoint
from tcow_tpu_torch.weights import params_to_jax

pytestmark = pytest.mark.cuda

# Relative L2 error against the plain version in float32 from the same inputs (as in
# chip_smoke.py): bf16 rounds qkv, p and attn (8 mantissa bits); float32 differs only
# in the order of sums (TF32 off).
TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
# K4, K5, K6 and the gradients of the Function: bf16 also rounds dattn, dlog, dq, dk and
# dv; K6 sums its weight gradients in another order than the plain version.
TOL_BWD = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
# Launches of one train step per attention call (two per block), by counter, for each
# pairing of a backward mode with its remat policy.
PAIRINGS = {
    ('kernel_x', 'dots_nb_out'): {'k1': 1, 'k4': 1},
    ('kernel_qkv', 'dots_nb_out_qkv'): {'k2': 1, 'k5': 1},
    ('res', 'dots_nb'): {'k3': 2},
    ('kernel_x_wg', 'dots_nb_out'): {'k1': 1, 'k6': 1},
}
GEOMETRIES = [
    (3, 1, 64, 2, 1, torch.bfloat16),      # one row per sequence, head 32
    (5, 33, 128, 4, 3, torch.bfloat16),    # two query and key tiles, diag 1
    (7, 45, 256, 2, 0, torch.bfloat16),    # head 128: >48 KB dynamic shared memory
    (2, 70, 200, 5, 2, torch.float32),     # head 40, K and N not tile multiples
    (4, 30, 768, 12, 1, torch.float32),    # temporal geometry in float32
    (2, 301, 96, 3, -1, torch.bfloat16),   # spatial length, ca -1 is not causal
    (3, 40, 128, 2, 4, torch.bfloat16),    # diag 2 across the second key tile
]


def rel_l2(got, want):
    return float((got.double() - want.double()).norm() / want.double().norm())


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA GPU: the kernels have no CPU or interpret mode')
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device('cuda')
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


WRAPPERS = {'k1': fa.fused_attention, 'k2': fa.fused_attention_fwd_qkv,
            'k3': fa.fused_attention_fwd_res, 'k4': fa.fused_attention_bwd,
            'k5': fa.fused_attention_bwd_qkv, 'k6': fa.fused_attention_bwd_wg}


def launches():
    '''Every counter: 'k1' ... 'k6' without rope, 'k1r' ... 'k6r' with it.'''
    out = {k: w.launches for k, w in WRAPPERS.items()}
    out.update({f'{k}r': w.launches_rope for k, w in WRAPPERS.items()})
    return out


def since(before):
    return {k: v - before[k] for k, v in launches().items() if v != before[k]}


def grad_input(B, S, D, dtype, device, seed=2):
    return torch.from_numpy(np.random.RandomState(seed).randn(B, S, D).astype(np.float32)).to(
        device, dtype)


def inputs(B, S, D, dtype, device, seed=0):
    rng = np.random.RandomState(seed)
    x = torch.from_numpy(rng.randn(B, S, D).astype(np.float32)).to(device, dtype)
    w = [torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        rng.randn(D, 3 * D) * 1.6 / np.sqrt(D), rng.randn(3 * D) * 0.02,
        rng.randn(D, D) * 0.8 / np.sqrt(D), rng.randn(D) * 0.02)]
    return x, w


@pytest.mark.parametrize('B,S,D,H,ca,dtype', GEOMETRIES)
def test_kernel_matches_plain(cuda, B, S, D, H, ca, dtype):
    x, w = inputs(B, S, D, dtype, cuda)
    before = fa.fused_attention.launches
    got = fa.fused_attention(x, *w, H, ca)
    torch.cuda.synchronize()
    assert fa.fused_attention.launches == before + 1
    assert got.shape == x.shape and got.dtype == dtype
    want = fa.attention_ref(x.float(), *w, H, ca)
    err = rel_l2(got, want)
    assert err <= TOL[dtype], err


# The bf16 attn_core's tiling (tensor cores): lengths around its 16-row warp tile and its
# 64-key tile, head sizes padded to a multiple of 16 (4, 20, 40, 100) or not, 8-byte
# copies (dh % 8 == 4), and every causal form.
CORE_S = (1, 15, 16, 17, 63, 64, 65, 129, 301)
CORE_DH = (4, 20, 40, 64, 100, 128)


@pytest.mark.parametrize('ca', (0, 1, 3))
@pytest.mark.parametrize('dh', CORE_DH)
@pytest.mark.parametrize('S', CORE_S)
def test_attn_core_tiles_match_plain(cuda, S, dh, ca):
    '''bf16 K1, K3 and K1r (per-row frame times) against their plain versions in f32;
    K3's probabilities exactly 0 past the causal edge and each row summing to 1 within
    bf16 rounding; K1 and K3 giving the same bits on a second run.'''
    B, H = 2, 2
    x, w = inputs(B, S, dh * H, torch.bfloat16, cuda, seed=20)
    p = rope_positions(B, S, 'times', cuda)
    before = launches()
    k1 = fa.fused_attention_fwd(x, *w, H, ca)
    k3 = fa.fused_attention_fwd_res(x, *w, H, ca)
    k1r = fa.fused_attention_fwd(x, *w, H, ca, True, p)
    k1_again = fa.fused_attention_fwd(x, *w, H, ca)
    k3_again = fa.fused_attention_fwd_res(x, *w, H, ca)
    torch.cuda.synchronize()
    assert since(before) == {'k1': 2, 'k3': 2, 'k1r': 1}
    assert torch.equal(k1, k1_again)
    assert all(torch.equal(a, b) for a, b in zip(k3, k3_again))
    want = fa.attention_res_ref(x.float(), *w, H, ca)
    want_r = fa.attention_ref(x.float(), *w, H, ca, True, p)
    for got, ref in zip((k1, k1r) + k3, (want[0], want_r) + want):
        assert got.dtype == torch.bfloat16 and got.shape == ref.shape
        err = rel_l2(got, ref)
        assert err <= TOL[torch.bfloat16], err
    probs = k3[2].float()
    if ca > 0:
        assert (probs[..., ~fa._causal_keep(S, ca, cuda)] == 0).all()
    # Each p rounds to bf16 (relative error <= 2^-9), so a row sums to 1 within 2^-9.
    assert (probs.sum(-1) - 1).abs().max() <= 2 ** -8


@pytest.mark.parametrize('ca', (0, 1, 3))
@pytest.mark.parametrize('dh', CORE_DH)
@pytest.mark.parametrize('S', CORE_S + (30,))
def test_attn_bwd_tiles_match_plain(cuda, S, dh, ca):
    '''The bf16 backward core's tiling (attn_bwd_q_mma, attn_bwd_kv_mma): K4, K5 and K4r
    (per-row frame times) against their plain versions in f32; K4 and K5 giving the same
    bits on a second run; at dh 64, K6, whose weight gradients read the new dqkv.'''
    B, H = 2, 2
    x, w = inputs(B, S, dh * H, torch.bfloat16, cuda, seed=21)
    g = grad_input(B, S, dh * H, torch.bfloat16, cuda, seed=22)
    p = rope_positions(B, S, 'times', cuda)
    _, qkv = fa.fused_attention_fwd_qkv(x, *w, H, ca)
    before = launches()
    k4 = fa.fused_attention_bwd(x, g, *w[:3], H, ca)
    k5 = fa.fused_attention_bwd_qkv(qkv, g, w[2], H, ca)
    k4r = fa.fused_attention_bwd(x, g, *w[:3], H, ca, True, p)
    k4_again = fa.fused_attention_bwd(x, g, *w[:3], H, ca)
    k5_again = fa.fused_attention_bwd_qkv(qkv, g, w[2], H, ca)
    torch.cuda.synchronize()
    assert since(before) == {'k4': 2, 'k5': 2, 'k4r': 1}
    assert all(torch.equal(a, b) for a, b in zip(k4 + k5, k4_again + k5_again))
    want = (fa.attention_bwd_ref(x.float(), g.float(), *w[:3], H, ca)
            + fa.attention_bwd_qkv_ref(qkv.float(), g.float(), w[2], H, ca)
            + fa.attention_bwd_ref(x.float(), g.float(), *w[:3], H, ca, True, p))
    got = k4 + k5 + k4r
    if dh == 64:
        got += fa.fused_attention_bwd_wg(x, g, *w[:3], H, ca)
        want += fa.attention_bwd_wg_ref(x.float(), g.float(), *w[:3], H, ca)
    for a, ref in zip(got, want, strict=True):
        assert a.shape == ref.shape
        err = rel_l2(a, ref)
        assert err <= TOL_BWD[torch.bfloat16], err


# The bf16 GEMMs (gemm_sm90.cu, wgmma fed by TMA): rows around the 64-row warpgroup tile
# and the 128-row block tile, widths and depths from one 16-byte TMA row (8) through
# ragged tiles (40, 96) to the main paths' (768, 2304).
GEMM_M = (1, 63, 64, 65, 129, 1000)


@pytest.mark.parametrize('bias', [True, False])
@pytest.mark.parametrize('w_transposed', [False, True])
@pytest.mark.parametrize('K', (8, 40, 768, 2304))
@pytest.mark.parametrize('N', (8, 96, 768, 2304))
@pytest.mark.parametrize('M', GEMM_M)
def test_gemm_bias_tiles_match_plain(cuda, M, N, K, w_transposed, bias):
    '''bf16 gemm_bias against the f32 product of the same bf16 operands (one rounding of
    the output: ~2e-3 relative L2), the same bits on a second run.'''
    rng = np.random.RandomState(M + 7 * N + 13 * K)
    a = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(cuda, torch.bfloat16)
    w = torch.from_numpy((rng.randn(*((N, K) if w_transposed else (K, N))) * K ** -0.5)
                         .astype(np.float32)).to(cuda)
    b = torch.from_numpy(rng.randn(N).astype(np.float32)).to(cuda) if bias else None
    got = fa._gemm(a, w, b, w_transposed)
    again = fa._gemm(a, w, b, w_transposed)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    assert torch.equal(got, again)
    w16 = w.to(torch.bfloat16).float()
    want = a.float() @ (w16.T if w_transposed else w16)
    if bias:
        want += b
    err = rel_l2(got, want)
    assert err <= TOL[torch.bfloat16], err


@pytest.mark.parametrize('K,N', [(64, 96), (768, 768), (768, 2304)])
@pytest.mark.parametrize('M', GEMM_M + (54000,))
def test_wgrad_matches_plain(cuda, M, K, N):
    '''bf16 wgrad (both operands MN-major) against the f32 a^T . b of the same operands:
    the products are exact, only the order of the f32 sums differs (<= 1e-3); 54,000 rows
    run in several runs; the same bits on a second run.'''
    rng = np.random.RandomState(M + K + N)
    a = torch.from_numpy(rng.randn(M, K).astype(np.float32)).to(cuda, torch.bfloat16)
    b = torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(cuda, torch.bfloat16)
    got = fa._wgrad(a, b)
    again = fa._wgrad(a, b)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (K, N)
    assert torch.equal(got, again)
    err = rel_l2(got, a.float().T @ b.float())
    assert err <= 1e-3, err


@pytest.mark.parametrize('N', (8, 96, 768, 2304))
@pytest.mark.parametrize('dtype', (torch.bfloat16, torch.float32))
@pytest.mark.parametrize('M', (1, 7, 63, 1001, 54000, 54181))
def test_colsum_matches_plain(cuda, M, N, dtype):
    '''colsum (16-byte loads, warps interleaved over a run's rows) against the f32 sum of
    the rows: only the order of the f32 sums differs (<= 1e-4 relative L2), odd and ragged
    row counts included; the same bits on a second run.'''
    rng = np.random.RandomState(M + N)
    a = torch.from_numpy(rng.randn(M, N).astype(np.float32)).to(cuda, dtype)
    got = fa._colsum(a)
    again = fa._colsum(a)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (N,)
    assert torch.equal(got, again)
    err = rel_l2(got, fa.colsum_ref(a))
    assert err <= TOL[torch.float32], err


def test_colsum_refuses_unaligned_rows(cuda):
    '''A width that is not a multiple of 8 columns, or a base that is not 16-byte aligned,
    cannot be read with 16-byte loads: the wrapper raises and launches nothing.'''
    with pytest.raises(ValueError, match='N % 8'):
        fa._colsum(torch.ones((64, 12), dtype=torch.bfloat16, device=cuda))
    buf = torch.ones(64 * 16 + 1, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match='aligned'):
        fa._colsum(buf[1:].view(64, 16))


def test_gemm_rejects_what_it_does_not_take(cuda):
    '''A depth whose rows are not 16-byte multiples cannot be a TMA operand: the launch
    is refused and the wrapper raises.'''
    a = torch.ones((4, 12), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(RuntimeError, match='CUDA error'):
        fa._gemm(a, torch.ones((12, 8), device=cuda), None, False)


@pytest.mark.parametrize('B,S,D,H,ca,dtype', GEOMETRIES)
def test_bwd_kernel_matches_plain(cuda, B, S, D, H, ca, dtype):
    x, w = inputs(B, S, D, dtype, cuda, seed=1)
    g = torch.from_numpy(np.random.RandomState(2).randn(B, S, D).astype(np.float32)).to(
        cuda, dtype)
    before = fa.fused_attention_bwd.launches
    dqkv, attn = fa.fused_attention_bwd(x, g, *w[:3], H, ca)
    torch.cuda.synchronize()
    assert fa.fused_attention_bwd.launches == before + 1
    assert dqkv.shape == (B, S, 3 * D) and attn.shape == x.shape and dqkv.dtype == dtype
    want_dqkv, want_attn = fa.attention_bwd_ref(x.float(), g.float(), *w[:3], H, ca)
    for got, want in ((dqkv, want_dqkv), (attn, want_attn)):
        err = rel_l2(got, want)
        assert err <= TOL_BWD[dtype], err


@pytest.mark.parametrize('B,S,D,H,ca,dtype', GEOMETRIES)
def test_k2_and_k3_match_plain(cuda, B, S, D, H, ca, dtype):
    '''K2 (out, qkv) and K3 (out, qkv, probs (B, H, S, S), attn) against
    attention_res_ref in f32 from the same inputs.'''
    x, w = inputs(B, S, D, dtype, cuda, seed=5)
    before = launches()
    k2 = fa.fused_attention_fwd_qkv(x, *w, H, ca)
    k3 = fa.fused_attention_fwd_res(x, *w, H, ca)
    torch.cuda.synchronize()
    assert since(before) == {'k2': 1, 'k3': 1}
    want = fa.attention_res_ref(x.float(), *w, H, ca)
    assert k3[2].shape == (B, H, S, S) and all(t.dtype == dtype for t in k2 + k3)
    for got, ref in zip(k2 + k3, want[:2] + want):
        err = rel_l2(got, ref)
        assert err <= TOL[dtype], err


@pytest.mark.parametrize('B,S,D,H,ca,dtype', GEOMETRIES)
def test_k5_and_k6_match_plain(cuda, B, S, D, H, ca, dtype):
    '''K5 (dqkv, attn from a saved qkv) and K6 (dx and the f32 weight and bias
    gradients) against their plain versions in f32 from the same inputs.'''
    x, w = inputs(B, S, D, dtype, cuda, seed=6)
    g = grad_input(B, S, D, dtype, cuda, seed=7)
    _, qkv = fa.fused_attention_fwd_qkv(x, *w, H, ca)
    before = launches()
    k5 = fa.fused_attention_bwd_qkv(qkv, g, w[2], H, ca)
    k6 = fa.fused_attention_bwd_wg(x, g, *w[:3], H, ca)
    torch.cuda.synchronize()
    assert since(before) == {'k5': 1, 'k6': 1}
    want5 = fa.attention_bwd_qkv_ref(qkv.float(), g.float(), w[2], H, ca)
    want6 = fa.attention_bwd_wg_ref(x.float(), g.float(), *w[:3], H, ca)
    assert [t.dtype for t in k6] == [dtype] + [torch.float32] * 4
    assert [t.shape for t in k6] == [t.shape for t in want6]
    for got, ref in zip(k5 + k6, want5 + want6):
        err = rel_l2(got, ref)
        assert err <= TOL_BWD[dtype], err


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
def test_k6_weight_gradients_are_deterministic(cuda, dtype):
    '''The row reductions of K6 have a fixed order: two runs give the same bits.'''
    x, w = inputs(64, 301, 256, dtype, cuda, seed=8)
    g = grad_input(64, 301, 256, dtype, cuda, seed=9)
    first = fa.fused_attention_bwd_wg(x, g, *w[:3], 4, 0)
    second = fa.fused_attention_bwd_wg(x, g, *w[:3], 4, 0)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('mode', fa.BWD_MODES)
def test_fused_attention_is_differentiable_on_the_card(cuda, dtype, mode):
    '''In each backward mode, the forward's output carries a grad_fn, and its backward
    gives the gradients of x and the four weights that autograd gives through the plain
    version in f32.'''
    x, w = inputs(4, 30, 256, dtype, cuda, seed=3)
    g = grad_input(4, 30, 256, dtype, cuda, seed=4)
    leaves = [x.clone().requires_grad_()] + [a.clone().requires_grad_() for a in w]
    before = launches()
    out = fa.fused_attention(*leaves, 4, 1, mode)
    assert out.grad_fn is not None
    out.backward(g)
    torch.cuda.synchronize()
    assert since(before) == {'res': {'k3': 1}, 'kernel_qkv': {'k2': 1, 'k5': 1},
                             'kernel_x': {'k1': 1, 'k4': 1},
                             'kernel_x_wg': {'k1': 1, 'k6': 1}}[mode]
    ref = [x.float().requires_grad_()] + [a.clone().requires_grad_() for a in w]
    fa.attention_ref(*ref, 4, 1).backward(g.float())
    for a, b in zip(leaves, ref):
        assert a.grad is not None and a.grad.dtype == a.dtype
        err = rel_l2(a.grad, b.grad)
        assert err <= TOL_BWD[dtype], err


def tiny_train_step(monkeypatch, grad_accum=1, optimizer='adamw', augs=False, **seeker_kw):
    '''Launches and changed parameters of one train step at width 64, depth 2 (with
    frame times in the batch, and with augs colour-augmentation keys).'''
    monkeypatch.setitem(tsf.DEPTH_PRESETS, 2, (64, 4))
    seeker = SeekerConfig(num_total_frames=4, frame_height=32, frame_width=48,
                          causal_attention=1, network_depth=2, drop_path_rate=0.1,
                          compute_dtype=torch.bfloat16, **seeker_kw)
    cfg = step_lib.StepConfig(seeker=seeker, loss=LossConfig(), num_queries=2)
    state = step_lib.init_train_state(0, cfg, optim.make_optimizer(optimizer), device='cuda')
    batch = synthetic_device_batch(0, B=2, Q=2, T=4, H=32, W=48, M=8, K=4)
    batch['frame_times'] = synthetic_frame_times(0, B=2, T=4, frame_stride=2)
    if augs:
        batch.update(synthetic_color_augs(0, 2, jitter=[1, 1], blur=[1, 0], gray=[0, 1]))
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    counts = launches()
    state, aux = step_lib.make_train_step(cfg, grad_accum)(state, batch, 0.1)
    torch.cuda.synchronize()
    assert np.isfinite(float(aux['total_seeker'])) and float(aux['skipped_nonfinite']) == 0
    changed = [k for k, v in state.model.state_dict().items() if not torch.equal(v, before[k])]
    assert 'backbone.blocks.1.attn.qkv.w' in changed
    return since(counts)


@pytest.mark.parametrize('remat', [False, True])
def test_train_step_launches_the_kernels(cuda, monkeypatch, remat):
    '''One train step at a tiny width through make_train_step in the 'kernel_x' mode
    under full remat: K1 once per attention call and once more per recomputed block
    under remat, K4 once per attention call.'''
    got = tiny_train_step(monkeypatch, remat=remat, remat_policy='full',
                          attention_bwd='kernel_x')
    assert got == {'k1': 8 if remat else 4, 'k4': 4}


@pytest.mark.parametrize('mode,policy', list(PAIRINGS))
def test_train_step_pairing_launches(cuda, monkeypatch, mode, policy):
    '''Each pairing of a mode with its remat policy: four attention calls per step, the
    forward kernel re-run in the backward only under 'res' / 'dots_nb'.'''
    got = tiny_train_step(monkeypatch, remat=True, remat_policy=policy, attention_bwd=mode)
    assert got == {k: 4 * n for k, n in PAIRINGS[mode, policy].items()}


@pytest.mark.parametrize('grad_accum,optimizer,remat_group', [(2, 'adamw', 1), (1, 'lamb', 1),
                                                              (1, 'adamw', 2)])
def test_device_side_train_step_launches(cuda, monkeypatch, grad_accum, optimizer,
                                         remat_group):
    '''The step of record's pairing on a batch with colour-augmentation keys: K1 and K4
    once per attention call and microbatch; LAMB and two blocks per checkpoint region
    launch as the plain step does.'''
    got = tiny_train_step(monkeypatch, grad_accum, optimizer, augs=True, remat=True,
                          remat_policy='dots_nb_out', attention_bwd='kernel_x',
                          remat_group=remat_group)
    assert got == {'k1': 4 * grad_accum, 'k4': 4 * grad_accum}


def test_device_augs_on_the_card_match_the_cpu(cuda):
    '''Jitter, blur and grayscale of a uint8 clip unpacked on the card and on the CPU:
    the same f32 operations, the per-frame means summed in another order (<= 1e-5).'''
    rgb = np.random.RandomState(0).randint(0, 256, (2, 3, 4, 32, 48)).astype(np.uint8)
    batch = {'rgb_u8': rgb, **synthetic_color_augs(1, 2, jitter=[1, 1], blur=[1, 0],
                                                   gray=[0, 1])}
    got = step_lib.unpack_batch(batch, cuda)['rgb'].cpu()
    want = step_lib.unpack_batch(batch, 'cpu')['rgb']
    assert float((got - want).abs().max()) <= 1e-5


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w = inputs(2, 8, 64, torch.bfloat16, cuda)
    with pytest.raises(TypeError):
        fa.fused_attention(x.half(), *w, 2, 0)
    with pytest.raises(ValueError, match='contiguous'):
        fa.fused_attention(x.transpose(0, 1), *w, 2, 0)
    with pytest.raises(ValueError, match='qkv_w'):
        fa.fused_attention(x, w[0].to(torch.bfloat16), *w[1:], 2, 0)
    with pytest.raises(ValueError, match='head_dim'):
        fa.fused_attention(x, *w, 32, 0)
    with pytest.raises(ValueError, match='g must match'):
        fa.fused_attention_bwd(x, x.float(), *w[:3], 2, 0)
    with pytest.raises(ValueError, match='qkv_b'):
        fa.fused_attention_bwd(x, x, w[0], w[1][:-1], w[2], 2, 0)


@pytest.mark.parametrize('mode', fa.BWD_MODES)
def test_inference_launches_k1_alone_in_every_mode(cuda, mode):
    '''Without gradients every backward mode runs K1 and no other kernel: 24 launches
    per forward of ViT-B/16.'''
    args = dict(num_total_frames=4, frame_height=32, frame_width=48, network_depth=12,
                causal_attention=1)
    model = MaskTracker(seeker_config_from_args(args))
    model.init_params_(torch.Generator().manual_seed(0))
    engine = InferenceEngine(params_to_jax(model.state_dict()),
                             seeker_config_from_args(args, attention_bwd=mode), device='cuda')
    rng = np.random.RandomState(0)
    before = launches()
    engine.run_plugin(rng.rand(1, 3, 4, 32, 48).astype(np.float32),
                      (rng.rand(1, 1, 4, 32, 48) > 0.5).astype(np.float32),
                      np.zeros((1, 3, 4, 32, 48), np.float32))
    torch.cuda.synchronize()
    assert since(before) == {'k1': 24}


def test_seeker_entry_points_launch_the_kernel(cuda, tmp_path):
    '''ViT-B/16 on small frames: Seeker.from_checkpoint, Seeker.from_seeker_args and
    InferenceEngine each launch the kernel twice per block and forward on CUDA.'''
    args = dict(num_total_frames=4, frame_height=32, frame_width=48, network_depth=12,
                causal_attention=1)
    model = MaskTracker(seeker_config_from_args(args))
    model.init_params_(torch.Generator().manual_seed(0))
    params = params_to_jax(model.state_dict())
    path = save_checkpoint(str(tmp_path), 0, 'k', params, seeker_args=args)
    rng = np.random.RandomState(0)
    rgb = rng.rand(1, 3, 4, 32, 48).astype(np.float32)
    query = (rng.rand(1, 1, 4, 32, 48) > 0.5).astype(np.float32)
    runs = (lambda: Seeker.from_checkpoint(path, device='cuda')(rgb, query),
            lambda: Seeker.from_seeker_args(args, device='cuda')(rgb, query),
            lambda: InferenceEngine(params, seeker_config_from_args(args), device='cuda')
            .run_plugin(rgb, query, np.zeros((1, 3, 4, 32, 48), np.float32)))
    for run in runs:
        before = fa.fused_attention.launches
        run()
        torch.cuda.synchronize()
        assert fa.fused_attention.launches - before == 24


# ---------------------------------------------------------------------------------------
# K1r ... K6r: the kernels with rope
# ---------------------------------------------------------------------------------------

# (head dim, heads): 32 puts the rotation's partner element in another lane, 64 and 128
# in the same lane.
ROPE_HEADS = [(32, 2), (64, 2), (128, 2)]
ROPE_CASES = [(dh, H, S, ca, pos, dtype) for dh, H in ROPE_HEADS for S in (1, 7, 30, 70)
              for ca in (0, 1, 3) for pos in (None, 'times')
              for dtype in (torch.bfloat16, torch.float32)]


def rope_positions(B, S, pos, device):
    return (None if pos is None
            else torch.from_numpy(synthetic_frame_times(S, B, S, frame_stride=2)).to(device))


@pytest.mark.parametrize('dh,H,S,ca,pos,dtype', ROPE_CASES)
def test_rope_forwards_match_plain(cuda, dh, H, S, ca, pos, dtype):
    '''K1r, K2r (out, un-rotated qkv) and K3r (and probabilities and attn) against
    attention_res_ref with rope in f32 from the same inputs and positions.'''
    B, D = 3, dh * H
    x, w = inputs(B, S, D, dtype, cuda, seed=10)
    p = rope_positions(B, S, pos, cuda)
    before = launches()
    k1 = fa.fused_attention_fwd(x, *w, H, ca, True, p)
    k2 = fa.fused_attention_fwd_qkv(x, *w, H, ca, True, p)
    k3 = fa.fused_attention_fwd_res(x, *w, H, ca, True, p)
    torch.cuda.synchronize()
    assert since(before) == {'k1r': 1, 'k2r': 1, 'k3r': 1}
    want = fa.attention_res_ref(x.float(), *w, H, ca, True, p)
    for got, ref in zip((k1,) + k2 + k3, want[:1] + want[:2] + want):
        assert got.dtype == dtype and got.shape == ref.shape
        err = rel_l2(got, ref)
        assert err <= TOL[dtype], err


@pytest.mark.parametrize('dh,H,S,ca,pos,dtype', ROPE_CASES)
def test_rope_backwards_match_plain(cuda, dh, H, S, ca, pos, dtype):
    '''K4r (dqkv, attn), K5r from the un-rotated qkv and K6r (dx and the weight and bias
    gradients) against their plain versions with rope in f32 from the same inputs.'''
    B, D = 3, dh * H
    x, w = inputs(B, S, D, dtype, cuda, seed=11)
    g = grad_input(B, S, D, dtype, cuda, seed=12)
    p = rope_positions(B, S, pos, cuda)
    _, qkv = fa.fused_attention_fwd_qkv(x, *w, H, ca, True, p)
    before = launches()
    k4 = fa.fused_attention_bwd(x, g, *w[:3], H, ca, True, p)
    k5 = fa.fused_attention_bwd_qkv(qkv, g, w[2], H, ca, True, p)
    k6 = fa.fused_attention_bwd_wg(x, g, *w[:3], H, ca, True, p)
    torch.cuda.synchronize()
    assert since(before) == {'k4r': 1, 'k5r': 1, 'k6r': 1}
    want = (fa.attention_bwd_ref(x.float(), g.float(), *w[:3], H, ca, True, p)
            + fa.attention_bwd_qkv_ref(qkv.float(), g.float(), w[2], H, ca, True, p)
            + fa.attention_bwd_wg_ref(x.float(), g.float(), *w[:3], H, ca, True, p))
    for got, ref in zip(k4 + k5 + k6, want):
        assert got.shape == ref.shape
        err = rel_l2(got, ref)
        assert err <= TOL_BWD[dtype], err


@pytest.mark.parametrize('mode', fa.BWD_MODES)
def test_rope_fused_attention_is_differentiable_on_the_card(cuda, mode):
    '''The differentiable call with rope and per-row positions: the rope launches of the
    mode, and the five gradients of autograd through the plain version.'''
    x, w = inputs(4, 30, 256, torch.bfloat16, cuda, seed=13)
    g = grad_input(4, 30, 256, torch.bfloat16, cuda, seed=14)
    p = rope_positions(4, 30, 'times', cuda)
    leaves = [x.clone().requires_grad_()] + [a.clone().requires_grad_() for a in w]
    before = launches()
    fa.fused_attention(*leaves, 4, 1, mode, True, p).backward(g)
    torch.cuda.synchronize()
    assert since(before) == {'res': {'k3r': 1}, 'kernel_qkv': {'k2r': 1, 'k5r': 1},
                             'kernel_x': {'k1r': 1, 'k4r': 1},
                             'kernel_x_wg': {'k1r': 1, 'k6r': 1}}[mode]
    ref = [x.float().requires_grad_()] + [a.clone().requires_grad_() for a in w]
    fa.attention_ref(*ref, 4, 1, True, p).backward(g.float())
    for a, b in zip(leaves, ref):
        err = rel_l2(a.grad, b.grad)
        assert err <= TOL_BWD[torch.bfloat16], err


@pytest.mark.parametrize('mode,policy', list(PAIRINGS))
def test_rope_train_step_pairing_launches(cuda, monkeypatch, mode, policy):
    '''A time-calibrated rope step: the temporal calls (one per block) launch the rope
    kernels, the spatial calls the plain ones.'''
    got = tiny_train_step(monkeypatch, remat=True, remat_policy=policy, attention_bwd=mode,
                          temporal_rope=True, rope_time_coords=True)
    want = {}
    for k, n in PAIRINGS[mode, policy].items():
        want[k] = want[f'{k}r'] = 2 * n
    assert got == want


def test_rope_run_plugin_reads_frame_times(cuda, monkeypatch):
    '''ViT-B/16 with time-calibrated rope on small frames: a request launches K1r for
    each temporal call and K1 for each spatial one, stride-2 frame times change the
    output, and the output stays within the seeker tolerance of the plain path.'''
    args = dict(num_total_frames=4, frame_height=32, frame_width=48, network_depth=12,
                causal_attention=1, temporal_rope=1, rope_time_coords=1)
    model = MaskTracker(seeker_config_from_args(args))
    model.init_params_(torch.Generator().manual_seed(0))
    engine = InferenceEngine(params_to_jax(model.state_dict()), seeker_config_from_args(args),
                             device='cuda')
    rng = np.random.RandomState(0)
    rgb = rng.rand(1, 3, 4, 32, 48).astype(np.float32)
    query = (rng.rand(1, 1, 4, 32, 48) > 0.5).astype(np.float32)
    target = np.zeros((1, 3, 4, 32, 48), np.float32)
    before = launches()
    rows = engine.run_plugin(rgb, query, target)[0][0]['output_mask']
    torch.cuda.synchronize()
    assert since(before) == {'k1r': 12, 'k1': 12}
    times = np.arange(4, dtype=np.float32)[None] * 2.0
    strided = engine.run_plugin(rgb, query, target, frame_times=times)[0][0]['output_mask']
    assert np.abs(strided - rows).max() > 0
    monkeypatch.setattr(tsf, 'fused_attention',
                        lambda *a: fa.attention_ref(*a[:7], *a[8:]))   # drop bwd_mode
    want = engine.run_plugin(rgb, query, target, frame_times=times)[0][0]['output_mask']
    assert rel_l2(torch.from_numpy(strided), torch.from_numpy(want)) <= 1e-3


def test_rope_kernel_rejects_bad_positions(cuda):
    x, w = inputs(2, 8, 64, torch.bfloat16, cuda)
    g = grad_input(2, 8, 64, torch.bfloat16, cuda)
    good = torch.zeros(2, 8, device=cuda)
    for bad in (good[:, :4], good.double(), good[None], good.cpu()):
        with pytest.raises(ValueError, match='pos'):
            fa.fused_attention_fwd(x, *w, 2, 1, True, bad)
        with pytest.raises(ValueError, match='pos'):
            fa.fused_attention_bwd(x, g, *w[:3], 2, 1, True, bad)


def test_h2d_prefetcher_batch_equals_unpack_batch(cuda, tmp_path):
    '''A collated Kubric batch copied by the driver's _H2DPrefetcher (pinned memory, side
    stream, event) and expanded by unpack_batch on the card is the batch unpack_batch
    makes from the host arrays, bit for bit (colour augmentations included).'''
    from tcow_tpu_torch.data import factory
    from tcow_tpu_torch.data import kubric
    from tcow_tpu_torch.data.synthetic import write_synthetic_kubric_dataset
    from tcow_tpu_torch.train import driver
    write_synthetic_kubric_dataset(str(tmp_path / 'train'), num_scenes=2, seed=3, T=8, H=48,
                                   W=64, K=6, rich_events=True)
    ds = kubric.KubricQueryDataset(str(tmp_path), None, 'train', num_frames=6,
                                   frame_height=64, frame_width=96, max_delay=2,
                                   num_queries=2, max_objects=8, seed=1)
    host = factory.make_kubric_collate(2, 'train', 1)([ds[0], ds[1]])
    pf = driver._H2DPrefetcher(iter([host]), 'cuda')
    _, dev = next(iter(pf))
    pf.close()
    got = step_lib.unpack_batch(dev, torch.device('cuda'))
    want = step_lib.unpack_batch(host['device'], torch.device('cuda'))
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def test_driver_step_on_the_card(cuda, tmp_path, monkeypatch):
    '''train_torch's driver on the card at a tiny width: one epoch of one step and one
    val step, kernel_x / dots_nb_out chosen by the driver, 2 K1 + 2 K4 per block a train
    step and 2 K1 per block a val step, a finite loss and a full checkpoint.'''
    from tcow_tpu_torch import config
    from tcow_tpu_torch.data.synthetic import write_synthetic_kubric_dataset
    from tcow_tpu_torch.train import checkpoint, driver
    from tcow_tpu_torch.utils.logvis import MyLogger
    monkeypatch.setitem(tsf.DEPTH_PRESETS, 2, (64, 4))
    for split, seed in (('train', 3), ('val', 9)):
        write_synthetic_kubric_dataset(str(tmp_path / 'kub' / split), num_scenes=2,
                                       seed=seed, T=8, H=48, W=64, K=6, rich_events=True)
    args = config.train_args([
        '--name', 'gpu1', '--data_path', str(tmp_path / 'kub'),
        '--checkpoint_root', str(tmp_path / 'ck'), '--log_root', str(tmp_path / 'logs'),
        '--batch_size', '2', '--num_queries', '2', '--num_frames', '6',
        '--frame_height', '32', '--frame_width', '48', '--kubric_max_delay', '2',
        '--num_epochs', '1', '--val_every', '1', '--network_depth', '2',
        '--tracker_pretrained', '0', '--num_workers', '2', '--avoid_wandb', '2'])
    steps = []
    real = driver._log_step_scalars

    def record(logger, phase, epoch, cur_step, steps_total, aux):
        steps.append((phase, float(aux['total_seeker'])))
        return real(logger, phase, epoch, cur_step, steps_total, aux)

    monkeypatch.setattr(driver, '_log_step_scalars', record)
    counts = fa.read_launches()
    logger = MyLogger(args, context='train')
    try:
        state = driver.main(args, logger)
    finally:
        logger.close()
    torch.cuda.synchronize()
    launches = {k: n - counts[k] for k, n in fa.read_launches().items() if n != counts[k]}
    # One train step (4 K1 + 4 K4), the vis step at step 0 (4 K1), one val step (4 K1).
    assert launches == {'K1': 12, 'K4': 4}
    assert state.step == 1 and [p for p, _ in steps] == ['train', 'val_aug']
    assert all(np.isfinite(loss) for _, loss in steps)
    assert state.model.backbone.blocks[0].attn.bwd_mode == 'kernel_x'
    meta = checkpoint.peek_meta(str(tmp_path / 'ck' / 'gpu1' / 'checkpoint.npz'))
    assert meta['opt_restored'] and meta['epoch'] == 0
