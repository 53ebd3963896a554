'''
Fused multi-head self-attention, forward and backward: the port of
tcow_tpu/ops/pallas_attention.py in its four backward modes.

`fused_attention` keeps the contract of the TPU kernel's differentiable entry point
(:171-199): out = proj(softmax_mask(q k^T dh^-0.5) v) with qkv = x qkv_w + qkv_b, over
(B, S, D). A call that needs no gradient runs K1 and keeps nothing (JAX's primal path,
:197-199). Otherwise `bwd_mode` picks the forward and what it saves for the backward, as
`_fwd` / `_bwd` do (:344-393):
  'res'         K3 saves qkv, probs and attn; the backward is torch ops (`attention_bwd_res`)
  'kernel_qkv'  K2 saves qkv; the backward is K5 plus plain weight products
  'kernel_x'    K1 saves nothing but x; the backward is K4 plus plain weight products
  'kernel_x_wg' K1 as 'kernel_x'; the backward is K6, weight gradients included
With rope=True (temporal attention under `temporal_rope`) q and k are rotated by their
position after the qkv product, as the TPU kernels do under rope=True (:120-136,
:592-628): positions 0..S-1, or per-row f32 `pos` (B, S). The backwards un-rotate dq and
dk. qkv stays un-rotated wherever it is saved.
Each forward is a custom operator (`torch.ops.tcow_torch.attention{,_qkv,_res}`), so a
selective remat policy (models/timesformer.py) can keep its outputs across a checkpoint
and the backward never re-runs it. `fused_attention.calls[mode]` counts the forwards
computed in each mode on every device; a remat recompute counts again.

A CPU tensor goes to the plain PyTorch versions beside each kernel. A CUDA tensor goes to
the hand-written kernels built with nvcc at first use from csrc/fused_attention.cu (the
attention cores) and csrc/gemm_sm90.cu (the GEMMs and row reductions of every chain), or
the call raises: there is no fallback from the card to the plain version. Launch counts, a
launch with rope on `launches_rope` of the same wrapper (K1r ... K6r) and never on
`launches`:
  K1 `fused_attention_fwd`        on `fused_attention.launches`
  K2 `fused_attention_fwd_qkv`    on `fused_attention_fwd_qkv.launches`
  K3 `fused_attention_fwd_res`    on `fused_attention_fwd_res.launches`
  K4 `fused_attention_bwd`        on `fused_attention_bwd.launches`
  K5 `fused_attention_bwd_qkv`    on `fused_attention_bwd_qkv.launches`
  K6 `fused_attention_bwd_wg`     on `fused_attention_bwd_wg.launches`
'''

import ctypes
import functools
from typing import Dict, Optional

import torch

from tcow_tpu_torch.ops import _build
from tcow_tpu_torch.ops import rope as rope_lib

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BWD_MODES = ('res', 'kernel_qkv', 'kernel_x', 'kernel_x_wg')


def _mask_diag(causal_attention: int) -> int:
    return 0 if causal_attention <= 2 else causal_attention - 2


def _causal_keep(S: int, causal_attention: int, device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril(_mask_diag(causal_attention))


def rope_tables_for(S: int, dh: int, pos, device):
    '''The rotation's (cos, sin) in f32: (S, dh/2) for row positions 0..S-1 when pos is
    None, (B, S, dh/2) for per-row positions pos (B, S). The kernels and the plain
    versions rotate by these same tables.'''
    if pos is None:
        return rope_lib.rope_tables(torch.arange(S, device=device), dh)
    return rope_lib.rope_tables(pos, dh)


def _head_tables(S: int, dh: int, pos, device):
    '''rope_tables_for, broadcastable over (B, H, S, dh/2).'''
    cos, sin = rope_tables_for(S, dh, pos, device)
    return (cos, sin) if pos is None else (cos[:, None], sin[:, None])


# ---------------------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------------------

def gemm_bias_ref(a, w, bias=None, w_transposed: bool = False):
    '''Plain version of gemm_bias over a (..., K) in the compute dtype, w (K, N) f32 or
    (N, K) when w_transposed, bias (N,) f32 or None -> (..., N) in a.dtype: the product
    of a and w rounded to a.dtype, summed in f32, plus the bias in f32, rounded once, as
    the JAX kernel's dot_general(preferred_element_type=f32) + bias + .astype (:101-104).'''
    w = w.to(a.dtype).float()
    out = torch.matmul(a.float(), w.T if w_transposed else w)
    return (out if bias is None else out + bias.float()).to(a.dtype)


def wgrad_ref(a, b):
    '''Plain version of wgrad: a^T . b in f32 over the rows of a (M, K) and b (M, N) in the
    compute dtype -> (K, N) f32, the JAX kernel's dot_general over rows (:655-660).'''
    return a.float().T @ b.float()


def colsum_ref(a):
    '''Plain version of colsum: the f32 sum of the rows of a (M, N) in the compute dtype ->
    (N,) f32, the JAX kernel's bias sums (:657, :660).'''
    return a.float().sum(dim=0)


def attention_res_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int,
                      rope: bool = False, pos=None):
    '''Plain version of K3 over (B, S, D) -> (out, qkv (B, S, 3D), probs (B, H, S, S),
    attn (B, S, D)) in x.dtype, the counterpart of pallas_attention.py:54-84 and of the
    model's non-kernel attention (timesformer.py:281-316): logits in f32, fill -1e10 where
    key > query + diag (diag 0 for ca 1 and 2, ca - 2 for ca >= 3), f32 softmax, probs
    cast to the compute dtype before PV. With rope, q and k are rotated after the qkv
    product rounds (:67-74) and rounded again; the returned qkv is un-rotated.'''
    B, S, D = x.shape
    dh = D // num_heads
    scale = dh ** -0.5
    qkv = torch.matmul(x, qkv_w.to(x.dtype)) + qkv_b.to(x.dtype)
    q, k, v = qkv.reshape(B, S, 3, num_heads, dh).permute(2, 0, 3, 1, 4)   # (B, h, S, dh)
    if rope:
        cs = _head_tables(S, dh, pos, x.device)
        q, k = rope_lib.apply_rope(q, *cs), rope_lib.apply_rope(k, *cs)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal_attention > 0:
        logits = logits.masked_fill(~_causal_keep(S, causal_attention, x.device), -1e10)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    attn = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, D)
    out = torch.matmul(attn, proj_w.to(x.dtype)) + proj_b.to(x.dtype)
    return out, qkv, probs, attn


def attention_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int,
                  rope: bool = False, pos=None):
    '''Plain version of K1 (K1r with rope): the output of `attention_res_ref`.'''
    return attention_res_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention,
                             rope, pos)[0]


def attention_qkv_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int,
                      rope: bool = False, pos=None):
    '''Plain version of K2 (K2r): (out, qkv) of `attention_res_ref`, qkv un-rotated.'''
    out, qkv, _, _ = attention_res_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                                       causal_attention, rope, pos)
    return out, qkv


def attention_bwd_qkv_ref(qkv, g, proj_w, num_heads: int, causal_attention: int,
                          rope: bool = False, pos=None):
    '''Plain version of K5 over qkv (B, S, 3D) and g (B, S, D) in one dtype; proj_w (D, D)
    f32 -> (dqkv (B, S, 3D), attn (B, S, D)) in that dtype. Mirrors _bwd_kernel (:568-637)
    rounding point for rounding point: every product runs in f32 on operands rounded to
    the compute dtype, and the result is rounded where the TPU kernel rounds it (dattn,
    p_c, attn, dv, dlog, dq, dk). With rope (K5r), q and k are rotated from the
    un-rotated qkv and rounded (:603-605); dq and dk are rounded, un-rotated in f32 and
    rounded again (:622-628).'''
    cdt = qkv.dtype
    f = lambda t: t.to(cdt).float()                    # round to the compute dtype, then f32
    dattn = torch.matmul(f(g), f(proj_w).T).to(cdt)                              # :587-590
    return attention_bwd_core_ref(qkv, dattn, num_heads, causal_attention, rope, pos)


def attention_bwd_core_ref(qkv, dattn, num_heads: int, causal_attention: int,
                           rope: bool = False, pos=None):
    '''Plain version of the backward core (attn_bwd_q + attn_bwd_kv, _bwd_kernel
    :598-630) over qkv (B, S, 3D) and dattn (B, S, D) in one dtype -> (dqkv (B, S, 3D),
    attn (B, S, D)) in that dtype, with the rounding points of `attention_bwd_qkv_ref`.'''
    B, S, D3 = qkv.shape
    D = D3 // 3
    H = num_heads
    dh = D // H
    scale = dh ** -0.5
    cdt = qkv.dtype
    f = lambda t: t.to(cdt).float()
    q, k, v = qkv.reshape(B, S, 3, H, dh).permute(2, 0, 3, 1, 4)                 # (B, H, S, dh)
    if rope:
        cs = _head_tables(S, dh, pos, qkv.device)
        q, k = rope_lib.apply_rope(q, *cs), rope_lib.apply_rope(k, *cs)
    q, k, v = q.float(), k.float(), v.float()
    da = dattn.float().reshape(B, S, H, dh).transpose(1, 2)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal_attention > 0:
        logits = logits.masked_fill(~_causal_keep(S, causal_attention, qkv.device), -1e10)
    pf = torch.softmax(logits, dim=-1)
    p_c = f(pf)
    attn = torch.matmul(p_c, v)
    dv = torch.matmul(p_c.transpose(-1, -2), da)
    dp = torch.matmul(da, v.transpose(-1, -2))
    dlog = f(pf * (dp - torch.sum(dp * pf, dim=-1, keepdim=True)) * scale)
    dq = torch.matmul(dlog, k).to(cdt)
    dk = torch.matmul(dlog.transpose(-1, -2), q).to(cdt)
    if rope:
        dq = rope_lib.apply_rope(dq, *cs, inverse=True)
        dk = rope_lib.apply_rope(dk, *cs, inverse=True)
    merge = lambda t: t.transpose(1, 2).reshape(B, S, D).to(cdt)
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1), merge(attn)


def attention_bwd_ref(x, g, qkv_w, qkv_b, proj_w, num_heads: int, causal_attention: int,
                      rope: bool = False, pos=None):
    '''Plain version of K4 (K4r) over x, g (B, S, D) -> (dqkv (B, S, 3D), attn (B, S, D))
    in x.dtype: qkv recomputed from x in f32 and rounded after the bias (:573-575), then
    `attention_bwd_qkv_ref`.'''
    cdt = x.dtype
    qkv = (torch.matmul(x.float(), qkv_w.to(cdt).float()) + qkv_b.float()).to(cdt)
    return attention_bwd_qkv_ref(qkv, g, proj_w, num_heads, causal_attention, rope, pos)


def attention_bwd_wg_ref(x, g, qkv_w, qkv_b, proj_w, num_heads: int, causal_attention: int,
                         rope: bool = False, pos=None):
    '''Plain version of K6 (K6r) -> (dx (B, S, D) in x.dtype, dqkv_w (D, 3D), dqkv_b (3D,),
    dproj_w (D, D), dproj_b (D,) in f32): `attention_bwd_ref`, then the five products of
    :643-660 in f32 on its rounded outputs, dx rounded to x.dtype.'''
    dqkv, attn = attention_bwd_ref(x, g, qkv_w, qkv_b, proj_w, num_heads, causal_attention,
                                   rope, pos)
    D = x.shape[-1]
    x2, g2 = x.reshape(-1, D).float(), g.reshape(-1, D).float()
    dqkv2, attn2 = dqkv.reshape(-1, 3 * D).float(), attn.reshape(-1, D).float()
    dx = torch.matmul(dqkv2, qkv_w.to(x.dtype).float().T).to(x.dtype).reshape(x.shape)
    return dx, x2.T @ dqkv2, colsum_ref(dqkv2), attn2.T @ g2, colsum_ref(g2)


def _mm_f32(a, b):
    '''a . b accumulated and returned in f32, as dot_general with preferred_element_type
    f32. On the card a bf16 product keeps bf16 operands and writes f32 (cuBLAS); on the
    CPU the operands are widened, which is exact.'''
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


def _weight_grads(x, g, dqkv, attn, qkv_w):
    '''(dx, dqkv_w, dqkv_b, dproj_w, dproj_b) from dqkv and attn as plain products, as the
    JAX package leaves them to XLA (:765-778 and _bwd_res :413-462): the weight
    gradients accumulated in f32, dx in x.dtype.'''
    D = x.shape[-1]
    g2, x2 = g.reshape(-1, D), x.reshape(-1, D)
    attn2, dqkv2 = attn.reshape(-1, D), dqkv.reshape(-1, 3 * D)
    dx = torch.matmul(dqkv2, qkv_w.to(x.dtype).T).reshape(x.shape)
    return (dx, _mm_f32(x2.T, dqkv2), dqkv2.sum(dim=0, dtype=torch.float32),
            _mm_f32(attn2.T, g2), g2.sum(dim=0, dtype=torch.float32))


def attention_bwd_res(x, g, qkv, probs, attn, qkv_w, proj_w, num_heads: int,
                      rope: bool = False, pos=None):
    '''The 'res' backward (_bwd_res, :396-463), XLA math in JAX and torch ops here on both
    devices: from the saved qkv (B, S, 3D), probs (B, H, S, S) and attn, with no
    recompute and JAX's rounding points (dattn, dv, dlog, dq and dk in x.dtype; dp and
    its row sums in f32). With rope, q and k are rotated from the saved un-rotated qkv,
    and dq and dk un-rotated (:419-449). Returns the five gradients of `_weight_grads`.'''
    B, S, D = x.shape
    H = num_heads
    dh = D // H
    scale = dh ** -0.5
    cdt = x.dtype
    g = g.to(cdt)
    dattn = torch.matmul(g, proj_w.to(cdt).T).reshape(B, S, H, dh).transpose(1, 2)
    q, k, v = qkv.reshape(B, S, 3, H, dh).permute(2, 0, 3, 1, 4)
    if rope:
        cs = _head_tables(S, dh, pos, x.device)
        q, k = rope_lib.apply_rope(q, *cs), rope_lib.apply_rope(k, *cs)
    dv = torch.matmul(probs.transpose(-1, -2), dattn)
    pf = probs.float()
    dp = torch.matmul(dattn.float(), v.float().transpose(-1, -2))
    dlog = ((pf * (dp - torch.sum(dp * pf, dim=-1, keepdim=True))) * scale).to(cdt)
    dq = torch.matmul(dlog, k)
    dk = torch.matmul(dlog.transpose(-1, -2), q)
    if rope:
        dq = rope_lib.apply_rope(dq, *cs, inverse=True)
        dk = rope_lib.apply_rope(dk, *cs, inverse=True)
    merge = lambda t: t.transpose(1, 2).reshape(B, S, D)
    dqkv = torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1)
    return _weight_grads(x, g, dqkv, attn, qkv_w)


# ---------------------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------------------

_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _bind(lib, signatures):
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, _I32
    return lib


@functools.cache
def _lib():
    '''The attention cores (csrc/fused_attention.cu).'''
    return _bind(_build.load('fused_attention'), {
        'tcow_attn_core': [_I32, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32,
                           _I32, _I32, _F32, _PTR],
        'tcow_attn_bwd': [_I32, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32,
                          _I32, _I32, _I32, _I32, _F32, _PTR]})


@functools.cache
def _gemm_lib():
    '''The GEMMs and row reductions (csrc/gemm_sm90.cu).'''
    return _bind(_build.load('gemm_sm90'), {
        'tcow_gemm_bias': [_I32, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _PTR],
        'tcow_wgrad': [_I32, _PTR, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _I32, _PTR],
        'tcow_colsum': [_I32, _PTR, _PTR, _PTR, _I32, _I32, _I32, _I32, _PTR]})


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def _check_kernel_inputs(x, weights, num_heads: int, what: str):
    '''Raises for what the kernels do not take in a CUDA tensor x; returns (B, S, D,
    head_dim). `weights` is a sequence of (name, tensor, shape) of float32 operands.'''
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'{what} kernel takes float32 or bfloat16, not {x.dtype}')
    if x.dim() != 3:
        raise ValueError(f'x must be (B, S, D), got {tuple(x.shape)}')
    B, S, D = x.shape
    if D % num_heads:
        raise ValueError(f'D={D} not divisible by num_heads={num_heads}')
    dh = D // num_heads
    if D % 8 or dh % 4 or dh > 128:
        raise ValueError(f'kernel needs D % 8 == 0 and head_dim % 4 == 0, <= 128 '
                         f'(D={D}, head_dim={dh})')
    for name, t, shape in weights:
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f'{name} must be float32 {shape} on {x.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError('x must be contiguous and 16-byte aligned')
    return B, S, D, dh


def _check_like(name, t, x, shape):
    '''Raises unless t is contiguous, 16-byte aligned, of x's dtype and device, and of
    `shape`.'''
    if t.dtype != x.dtype or tuple(t.shape) != shape or t.device != x.device:
        raise ValueError(f'{name} must match x ({x.dtype} {shape} on {x.device}), got '
                         f'{t.dtype} {tuple(t.shape)} on {t.device}')
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f'{name} must be contiguous and 16-byte aligned')


def _on_cpu(x, what: str) -> bool:
    '''True for a CPU tensor (the plain version runs); raises for devices other than
    cpu and cuda.'''
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'{what} runs on cpu or cuda, not {x.device}')
    return x.device.type == 'cpu'


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


def _kernel_tables(x, S, dh, rope, pos):
    '''(cos, sin, row stride) for attn_core / attn_bwd: null pointers and 0 without rope;
    one (S, dh/2) f32 table shared by every row (stride 0) when pos is None; per-row
    tables (B, S, dh/2) from pos (B, S) f32 on x's device (stride S dh/2).'''
    if not rope:
        return None, None, 0
    if pos is not None and (pos.dtype != torch.float32 or tuple(pos.shape) != (x.shape[0], S)
                            or pos.device != x.device):
        raise ValueError(f'pos must be float32 {(x.shape[0], S)} on {x.device}, got '
                         f'{pos.dtype} {tuple(pos.shape)} on {pos.device}')
    cos, sin = (t.contiguous() for t in rope_tables_for(S, dh, pos, x.device))
    return cos, sin, 0 if pos is None else S * (dh // 2)


def _ptr(t):
    return None if t is None else t.data_ptr()


def gemm_weight(w, w_transposed: bool):
    '''The bf16 GEMM's weight operand from an f32 weight w (K, N), or (N, K) when
    w_transposed: a contiguous (N, K) bf16 tensor, K-major as the kernel's TMA loads it,
    each weight rounded once to nearest even (the bits of the JAX kernel's
    .astype(x.dtype)). One copy, under the profiler range 'gemm_weight_cast'.'''
    with torch.profiler.record_function('gemm_weight_cast'):
        return (w if w_transposed else w.t()).to(torch.bfloat16,
                                                 memory_format=torch.contiguous_format)


def _gemm(a, w, bias, w_transposed: bool, what: str = 'gemm_bias'):
    '''gemm_bias on the card: (..., N) in a.dtype = a (..., K) . w (+ bias), rounded once;
    w f32 (K, N) or (N, K) when w_transposed, bias f32 or None, a contiguous. bf16 runs
    the wgmma kernel on gemm_weight(w), f32 the CUDA-core kernel on w itself.'''
    K = a.shape[-1]
    N = w.shape[0] if w_transposed else w.shape[1]
    out = torch.empty((*a.shape[:-1], N), dtype=a.dtype, device=a.device)
    code = _DTYPE_CODES[a.dtype]
    if code == 1:
        w, w_transposed = gemm_weight(w, w_transposed), True
    _check(_gemm_lib().tcow_gemm_bias(code, a.data_ptr(), w.data_ptr(), _ptr(bias),
                                      out.data_ptr(), a.numel() // K, N, K, int(w_transposed),
                                      _stream(a)), what)
    return out


def _launch_forward(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention, probs,
                    what, rope=False, pos=None):
    '''K1's chain on the card: gemm_bias (qkv) -> attn_core -> gemm_bias (proj); with
    probs, attn_core also stores the probabilities; with rope, attn_core<ROPE> rotates q
    and k as it stages them. Returns (out, qkv (un-rotated), probs or None, attn).'''
    D = x.shape[-1]
    B, S, D, dh = _check_kernel_inputs(
        x, (('qkv_w', qkv_w, (D, 3 * D)), ('qkv_b', qkv_b, (3 * D,)),
            ('proj_w', proj_w, (D, D)), ('proj_b', proj_b, (D,))),
        num_heads, what)
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        stream = _stream(x)
        cos, sin, table_stride = _kernel_tables(x, S, dh, rope, pos)
        attn = torch.empty_like(x)
        p = (torch.empty((B, num_heads, S, S), dtype=x.dtype, device=x.device) if probs
             else None)
        qkv = _gemm(x, qkv_w, qkv_b, False, 'gemm_bias(qkv)')
        _check(lib.tcow_attn_core(code, qkv.data_ptr(), attn.data_ptr(), _ptr(p), _ptr(cos),
                                  _ptr(sin), table_stride, B, S, num_heads, dh,
                                  int(causal_attention > 0), _mask_diag(causal_attention),
                                  dh ** -0.5, stream), 'attn_core')
        out = _gemm(attn, proj_w, proj_b, False, 'gemm_bias(proj)')
    return out, qkv, p, attn


def _count(wrapper, rope: bool):
    '''One launch on the wrapper's counter: `launches_rope` for a rope launch, else
    `launches`.'''
    if rope:
        wrapper.launches_rope += 1
    else:
        wrapper.launches += 1


def fused_attention_fwd(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int,
                        causal_attention: int, rope: bool = False, pos=None):
    '''K1 (K1r with rope): attention forward over x (B, S, D); weights (D, 3D), (3D,),
    (D, D), (D,) f32; pos None or (B, S) f32. CPU tensors run `attention_ref`; CUDA
    tensors launch the kernel chain gemm_bias -> attn_core -> gemm_bias on the current
    stream and add one to `fused_attention.launches` (`launches_rope` with rope).'''
    if _on_cpu(x, 'fused_attention'):
        return attention_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention,
                             rope, pos)
    out = _launch_forward(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention,
                          False, 'fused_attention', rope, pos)[0]
    _count(fused_attention, rope)
    return out


def fused_attention_fwd_qkv(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int,
                            causal_attention: int, rope: bool = False, pos=None):
    '''K2 (K2r): K1 that also returns the un-rotated qkv (B, S, 3D) in x.dtype -> (out,
    qkv). CPU tensors run `attention_qkv_ref`; CUDA tensors launch K1's chain and add one
    to `fused_attention_fwd_qkv.launches` (`launches_rope` with rope).'''
    if _on_cpu(x, 'fused_attention_fwd_qkv'):
        return attention_qkv_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention,
                                 rope, pos)
    out, qkv, _, _ = _launch_forward(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                                     causal_attention, False, 'fused_attention_fwd_qkv',
                                     rope, pos)
    _count(fused_attention_fwd_qkv, rope)
    return out, qkv


def fused_attention_fwd_res(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int,
                            causal_attention: int, rope: bool = False, pos=None):
    '''K3 (K3r): K1 that also returns the un-rotated qkv, the probabilities (B, H, S, S)
    and attn (B, S, D), all in x.dtype -> (out, qkv, probs, attn). CPU tensors run
    `attention_res_ref`; CUDA tensors launch K1's chain with attn_core storing the
    probabilities and add one to `fused_attention_fwd_res.launches` (`launches_rope` with
    rope).'''
    if _on_cpu(x, 'fused_attention_fwd_res'):
        return attention_res_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention,
                                 rope, pos)
    res = _launch_forward(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention,
                          True, 'fused_attention_fwd_res', rope, pos)
    _count(fused_attention_fwd_res, rope)
    return res


def _launch_backward(x, g, qkv_w, qkv_b, proj_w, qkv, num_heads, causal_attention, what,
                     rope=False, pos=None):
    '''K4's chain on the card: gemm_bias (qkv from x; skipped when qkv is given, K5) ->
    gemm_bias (g . proj_w^T) -> attn_bwd_q -> attn_bwd_kv; with rope both attention
    launches rotate q and k as they stage them and un-rotate dq and dk. With qkv given, x
    is only checked for shape. Returns (qkv, dqkv, attn).'''
    D = x.shape[-1]
    weights = [('proj_w', proj_w, (D, D))]
    if qkv is None:
        weights += [('qkv_w', qkv_w, (D, 3 * D)), ('qkv_b', qkv_b, (3 * D,))]
    B, S, D, dh = _check_kernel_inputs(x, weights, num_heads, what)
    _check_like('g', g, x, (B, S, D))
    if qkv is not None:
        _check_like('qkv', qkv, x, (B, S, 3 * D))
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        stream = _stream(x)
        cos, sin, table_stride = _kernel_tables(x, S, dh, rope, pos)
        attn = torch.empty_like(x)
        dqkv = torch.empty((B, S, 3 * D), dtype=x.dtype, device=x.device)
        stats = torch.empty((3, B, num_heads, S), dtype=torch.float32, device=x.device)
        if qkv is None:
            qkv = _gemm(x, qkv_w, qkv_b, False, 'gemm_bias(qkv)')
        dattn = _gemm(g, proj_w, None, True, 'gemm(g proj_w^T)')
        _check(lib.tcow_attn_bwd(code, qkv.data_ptr(), dattn.data_ptr(), attn.data_ptr(),
                                 dqkv.data_ptr(), stats.data_ptr(), _ptr(cos), _ptr(sin),
                                 table_stride, B, S, num_heads, dh, int(causal_attention > 0),
                                 _mask_diag(causal_attention), dh ** -0.5, stream), 'attn_bwd')
    return qkv, dqkv, attn


def fused_attention_bwd(x, g, qkv_w, qkv_b, proj_w, num_heads: int, causal_attention: int,
                        rope: bool = False, pos=None):
    '''K4 (K4r): the in-kernel part of the attention backward over x, g (B, S, D) in one
    dtype; weights (D, 3D), (3D,), (D, D) f32 -> (dqkv (B, S, 3D), attn (B, S, D)) in
    x.dtype. CPU tensors run `attention_bwd_ref`; CUDA tensors launch gemm_bias (qkv) ->
    gemm_bias (g . proj_w^T) -> attn_bwd_q -> attn_bwd_kv on the current stream and add
    one to `fused_attention_bwd.launches` (`launches_rope` with rope).'''
    if _on_cpu(x, 'fused_attention_bwd'):
        return attention_bwd_ref(x, g, qkv_w, qkv_b, proj_w, num_heads, causal_attention,
                                 rope, pos)
    _, dqkv, attn = _launch_backward(x, g, qkv_w, qkv_b, proj_w, None, num_heads,
                                     causal_attention, 'fused_attention_bwd', rope, pos)
    _count(fused_attention_bwd, rope)
    return dqkv, attn


def fused_attention_bwd_qkv(qkv, g, proj_w, num_heads: int, causal_attention: int,
                            rope: bool = False, pos=None):
    '''K5 (K5r): K4 from the saved un-rotated qkv (B, S, 3D) instead of x; g (B, S, D) in
    qkv's dtype, proj_w (D, D) f32 -> (dqkv, attn). CPU tensors run
    `attention_bwd_qkv_ref`; CUDA tensors launch gemm_bias (g . proj_w^T) -> attn_bwd_q ->
    attn_bwd_kv and add one to `fused_attention_bwd_qkv.launches` (`launches_rope` with
    rope).'''
    if _on_cpu(qkv, 'fused_attention_bwd_qkv'):
        return attention_bwd_qkv_ref(qkv, g, proj_w, num_heads, causal_attention, rope, pos)
    _, dqkv, attn = _launch_backward(g, g, None, None, proj_w, qkv, num_heads,
                                     causal_attention, 'fused_attention_bwd_qkv', rope, pos)
    _count(fused_attention_bwd_qkv, rope)
    return dqkv, attn


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _row_splits(M: int, blocks_per_split: int, multiple: int = 32):
    '''(splits, rows) of K6's row reductions: about two waves of 132 SMs, runs of a
    multiple of `multiple` rows (32; 64, one stage, in the bf16 wgrad) that cover M
    exactly. A function of the shapes alone, so the order of every sum is fixed.'''
    want = max(1, min(_cdiv(264, blocks_per_split), _cdiv(M, 256)))
    rows = _cdiv(_cdiv(M, want), multiple) * multiple
    return _cdiv(M, rows), rows


def _wgrad(a, b):
    '''wgrad on the card: f32 (K, N) = a^T . b over the rows of a (M, K) and b (M, N),
    contiguous, in runs of rows fixed by the shape.'''
    M, K = a.shape
    N = b.shape[1]
    code = _DTYPE_CODES[a.dtype]
    splits, rows = (_row_splits(M, _cdiv(K, 128) * _cdiv(N, 256), 64) if code == 1
                    else _row_splits(M, _cdiv(K, 64) * _cdiv(N, 64)))
    out = torch.empty((K, N), dtype=torch.float32, device=a.device)
    work = torch.empty((splits, K, N), dtype=torch.float32, device=a.device)
    _check(_gemm_lib().tcow_wgrad(code, a.data_ptr(), b.data_ptr(), out.data_ptr(),
                                  work.data_ptr(), M, K, N, splits, rows, _stream(a)), 'wgrad')
    return out


def _colsum(a):
    '''colsum on the card: f32 (N,) = the sum of the rows of a (M, N), contiguous, in runs of
    rows fixed by the shape. The kernel reads 8 columns a thread with 16-byte loads, so it
    refuses, by raising, N % 8 != 0 and a base that is not 16-byte aligned.'''
    M, N = a.shape
    if N % 8:
        raise ValueError(f'colsum needs N % 8 == 0 (rows of 16-byte loads), got N={N}')
    if a.data_ptr() % 16 or not a.is_contiguous():
        raise ValueError('colsum needs a contiguous operand with a 16-byte aligned base')
    splits, rows = _row_splits(M, _cdiv(N, 256))
    out = torch.empty((N,), dtype=torch.float32, device=a.device)
    work = torch.empty((splits, N), dtype=torch.float32, device=a.device)
    _check(_gemm_lib().tcow_colsum(_DTYPE_CODES[a.dtype], a.data_ptr(), out.data_ptr(),
                                   work.data_ptr(), M, N, splits, rows, _stream(a)), 'colsum')
    return out


def fused_attention_bwd_wg(x, g, qkv_w, qkv_b, proj_w, num_heads: int, causal_attention: int,
                           rope: bool = False, pos=None):
    '''K6 (K6r): K4 plus dx and the weight and bias gradients -> (dx (B, S, D) in x.dtype,
    dqkv_w (D, 3D), dqkv_b (3D,), dproj_w (D, D), dproj_b (D,) in f32). CPU tensors run
    `attention_bwd_wg_ref`; CUDA tensors launch K4's chain, gemm_bias (dqkv . qkv_w^T),
    wgrad (x^T . dqkv, attn^T . g) and colsum (dqkv, g), and add one to
    `fused_attention_bwd_wg.launches` (`launches_rope` with rope). The reductions over
    rows are deterministic; with rope they read the un-rotated dqkv that K4r writes.'''
    if _on_cpu(x, 'fused_attention_bwd_wg'):
        return attention_bwd_wg_ref(x, g, qkv_w, qkv_b, proj_w, num_heads, causal_attention,
                                    rope, pos)
    _, dqkv, attn = _launch_backward(x, g, qkv_w, qkv_b, proj_w, None, num_heads,
                                     causal_attention, 'fused_attention_bwd_wg', rope, pos)
    B, S, D = x.shape
    with torch.cuda.device(x.device):
        x2, g2 = x.view(B * S, D), g.view(B * S, D)
        dqkv2, attn2 = dqkv.view(B * S, 3 * D), attn.view(B * S, D)
        grads = (_gemm(dqkv, qkv_w, None, True, 'gemm(dqkv qkv_w^T)'), _wgrad(x2, dqkv2),
                 _colsum(dqkv2), _wgrad(attn2, g2), _colsum(g2))
    _count(fused_attention_bwd_wg, rope)
    return grads


# ---------------------------------------------------------------------------------------
# The differentiable entry point: one custom operator per forward
# ---------------------------------------------------------------------------------------

def _count_call(bwd_mode: str):
    fused_attention.calls[bwd_mode] += 1


@torch.library.custom_op('tcow_torch::attention', mutates_args=())
def _attention_op(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                  proj_w: torch.Tensor, proj_b: torch.Tensor, num_heads: int,
                  causal_attention: int, bwd_mode: str, rope: bool,
                  pos: Optional[torch.Tensor]) -> torch.Tensor:
    '''The forward of 'kernel_x' and 'kernel_x_wg': K1, saving x (:344-351).'''
    _count_call(bwd_mode)
    return fused_attention_fwd(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention,
                               rope, pos)


def _setup_x(ctx, inputs, output):
    x, qkv_w, qkv_b, proj_w, _, ctx.num_heads, ctx.ca, ctx.bwd_mode, ctx.rope, pos = inputs
    ctx.save_for_backward(x, qkv_w, qkv_b, proj_w, pos)


def _backward_x(ctx, g):
    x, qkv_w, qkv_b, proj_w, pos = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()                                           # :687
    args = (x, g, qkv_w, qkv_b, proj_w, ctx.num_heads, ctx.ca, ctx.rope, pos)
    if ctx.bwd_mode == 'kernel_x_wg':
        grads = fused_attention_bwd_wg(*args)
    else:
        dqkv, attn = fused_attention_bwd(*args)
        grads = _weight_grads(x, g, dqkv, attn, qkv_w)
    return (*grads, None, None, None, None, None)   # positions have no gradient (:373-375)


@torch.library.custom_op('tcow_torch::attention_qkv', mutates_args=())
def _attention_qkv_op(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                      proj_w: torch.Tensor, proj_b: torch.Tensor, num_heads: int,
                      causal_attention: int, rope: bool, pos: Optional[torch.Tensor]
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    '''The forward of 'kernel_qkv': K2, saving x and the un-rotated qkv, JAX's `attn_qkv`
    (:352-360).'''
    _count_call('kernel_qkv')
    return fused_attention_fwd_qkv(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                                   causal_attention, rope, pos)


def _setup_qkv(ctx, inputs, output):
    x, qkv_w, _, proj_w, _, ctx.num_heads, ctx.ca, ctx.rope, pos = inputs
    ctx.mark_non_differentiable(output[1])
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(x, output[1], qkv_w, proj_w, pos)


def _backward_qkv(ctx, g, _):
    x, qkv, qkv_w, proj_w, pos = ctx.saved_tensors
    g = g.to(x.dtype).contiguous()
    dqkv, attn = fused_attention_bwd_qkv(qkv, g, proj_w, ctx.num_heads, ctx.ca, ctx.rope, pos)
    return (*_weight_grads(x, g, dqkv, attn, qkv_w), None, None, None, None)


@torch.library.custom_op('tcow_torch::attention_res', mutates_args=())
def _attention_res_op(x: torch.Tensor, qkv_w: torch.Tensor, qkv_b: torch.Tensor,
                      proj_w: torch.Tensor, proj_b: torch.Tensor, num_heads: int,
                      causal_attention: int, rope: bool, pos: Optional[torch.Tensor]
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    '''The forward of 'res': K3, saving x, the un-rotated qkv, probs and attn, JAX's
    `attn_res` (:361-370).'''
    _count_call('res')
    return fused_attention_fwd_res(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                                   causal_attention, rope, pos)


def _setup_res(ctx, inputs, output):
    x, qkv_w, _, proj_w, _, ctx.num_heads, _, ctx.rope, pos = inputs
    _, qkv, probs, attn = output
    ctx.mark_non_differentiable(qkv, probs, attn)
    ctx.set_materialize_grads(False)
    ctx.save_for_backward(x, qkv, probs, attn, qkv_w, proj_w, pos)


def _backward_res(ctx, g, *_):
    x, qkv, probs, attn, qkv_w, proj_w, pos = ctx.saved_tensors
    return (*attention_bwd_res(x, g, qkv, probs, attn, qkv_w, proj_w, ctx.num_heads,
                               ctx.rope, pos),
            None, None, None, None)


torch.library.register_autograd('tcow_torch::attention', _backward_x, setup_context=_setup_x)
torch.library.register_autograd('tcow_torch::attention_qkv', _backward_qkv,
                                setup_context=_setup_qkv)
torch.library.register_autograd('tcow_torch::attention_res', _backward_res,
                                setup_context=_setup_res)

# The custom operator of each mode's forward, for remat policies.
FORWARD_OPS = {'res': torch.ops.tcow_torch.attention_res.default,
               'kernel_qkv': torch.ops.tcow_torch.attention_qkv.default,
               'kernel_x': torch.ops.tcow_torch.attention.default,
               'kernel_x_wg': torch.ops.tcow_torch.attention.default}


def fused_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int,
                    bwd_mode: str = 'res', rope: bool = False, pos=None):
    '''Differentiable fused attention over x (B, S, D); weights (D, 3D), (3D,), (D, D),
    (D,) f32; with rope, q and k rotated by positions 0..S-1 or by pos (B, S) f32, which
    gets no gradient. Without gradients it runs K1 and saves nothing; with them the
    forward and backward of `bwd_mode` (module docstring). Kernels on CUDA tensors, the
    plain versions on CPU tensors; every other device raises.'''
    if bwd_mode not in BWD_MODES:
        raise ValueError(f'unknown bwd_mode {bwd_mode!r}; one of {BWD_MODES}')
    _on_cpu(x, 'fused_attention')
    args = (x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention)
    pos = pos if rope else None
    if not (torch.is_grad_enabled() and any(t.requires_grad for t in args[:5])):
        _count_call(bwd_mode)
        return fused_attention_fwd(*args, rope, pos)
    if bwd_mode == 'res':
        return _attention_res_op(*args, rope, pos)[0]
    if bwd_mode == 'kernel_qkv':
        return _attention_qkv_op(*args, rope, pos)[0]
    return _attention_op(*args, bwd_mode, rope, pos)


fused_attention.calls = dict.fromkeys(BWD_MODES, 0)
# Each kernel's counters by its name in the module docstring.
KERNEL_COUNTERS = {'K1': fused_attention, 'K2': fused_attention_fwd_qkv,
                   'K3': fused_attention_fwd_res, 'K4': fused_attention_bwd,
                   'K5': fused_attention_bwd_qkv, 'K6': fused_attention_bwd_wg}
for _wrapper in KERNEL_COUNTERS.values():
    _wrapper.launches = _wrapper.launches_rope = 0
del _wrapper


def read_launches() -> Dict[str, int]:
    '''Every kernel's launch count: K1 ... K6, then K1r ... K6r.'''
    out = {name: c.launches for name, c in KERNEL_COUNTERS.items()}
    out.update({f'{name}r': c.launches_rope for name, c in KERNEL_COUNTERS.items()})
    return out


def launches_since(counts: Dict[str, int]) -> Dict[str, int]:
    '''The launches of each kernel since read_launches() returned `counts`, kernels that
    did not launch left out.'''
    return {k: n - counts[k] for k, n in read_launches().items() if n != counts[k]}
