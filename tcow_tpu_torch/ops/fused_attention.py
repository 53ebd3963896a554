'''
Fused multi-head self-attention, forward and backward: the port of
tcow_tpu/ops/pallas_attention.py in its 'kernel_x' mode.

`fused_attention` keeps the contract of the TPU kernel's differentiable entry point
(:171-199): out = proj(softmax_mask(q k^T dh^-0.5) v) with qkv = x qkv_w + qkv_b, over
(B, S, D). It runs through `FusedAttention`, whose forward saves only x and the weights
(as `_fwd` does for 'kernel_x', :344-351) and whose backward recomputes everything else
(`_bwd`, :378-393). A CPU tensor goes to the plain PyTorch versions, `attention_ref` and
`attention_bwd_ref`. A CUDA tensor goes to the hand-written kernels built with nvcc at
first use from csrc/fused_attention.cu, or the call raises: there is no fallback from the
card to the plain version.
  K1 forward:  `fused_attention_fwd`, count on `fused_attention.launches`
  K4 backward: `fused_attention_bwd`, count on `fused_attention_bwd.launches`
'''

import ctypes
import functools

import torch

from tcow_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _mask_diag(causal_attention: int) -> int:
    return 0 if causal_attention <= 2 else causal_attention - 2


def _causal_keep(S: int, causal_attention: int, device) -> torch.Tensor:
    return torch.ones(S, S, dtype=torch.bool, device=device).tril(_mask_diag(causal_attention))


def attention_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int):
    '''Plain PyTorch version over (B, S, D), the counterpart of pallas_attention.py:54-84
    and of the model's non-kernel attention (timesformer.py:281-316): logits in f32, fill
    -1e10 where key > query + diag (diag 0 for ca 1 and 2, ca - 2 for ca >= 3), f32
    softmax, probs cast to the compute dtype before PV.'''
    B, S, D = x.shape
    dh = D // num_heads
    scale = dh ** -0.5
    qkv = torch.matmul(x, qkv_w.to(x.dtype)) + qkv_b.to(x.dtype)
    q, k, v = qkv.reshape(B, S, 3, num_heads, dh).permute(2, 0, 3, 1, 4)   # (B, h, S, dh)
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if causal_attention > 0:
        logits = logits.masked_fill(~_causal_keep(S, causal_attention, x.device), -1e10)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, D)
    return torch.matmul(out, proj_w.to(x.dtype)) + proj_b.to(x.dtype)


def attention_bwd_ref(x, g, qkv_w, qkv_b, proj_w, num_heads: int, causal_attention: int):
    '''Plain PyTorch version of K4 over (B, S, D) -> (dqkv (B, S, 3D), attn (B, S, D)) in
    x.dtype. Mirrors _bwd_kernel (:568-637) rounding point for rounding point: every
    product runs in f32 on operands rounded to x.dtype, and the result is rounded where
    the TPU kernel rounds it (qkv after the bias, dattn, p_c, attn, dv, dlog, dq, dk).'''
    B, S, D = x.shape
    H = num_heads
    dh = D // H
    scale = dh ** -0.5
    cdt = x.dtype
    f = lambda t: t.to(cdt).float()                    # round to the compute dtype, then f32
    qkv = f(torch.matmul(x.float(), f(qkv_w)) + qkv_b.float())                  # :573-575
    dattn = f(torch.matmul(f(g), f(proj_w).T))                                   # :587-590
    q, k, v = qkv.reshape(B, S, 3, H, dh).permute(2, 0, 3, 1, 4)                 # (B, H, S, dh)
    da = dattn.reshape(B, S, H, dh).transpose(1, 2)
    logits = torch.matmul(q, k.transpose(-1, -2)) * scale
    if causal_attention > 0:
        logits = logits.masked_fill(~_causal_keep(S, causal_attention, x.device), -1e10)
    pf = torch.softmax(logits, dim=-1)
    p_c = f(pf)
    attn = torch.matmul(p_c, v)
    dv = torch.matmul(p_c.transpose(-1, -2), da)
    dp = torch.matmul(da, v.transpose(-1, -2))
    dlog = f(pf * (dp - torch.sum(dp * pf, dim=-1, keepdim=True)) * scale)
    dq = torch.matmul(dlog, k)
    dk = torch.matmul(dlog.transpose(-1, -2), q)
    merge = lambda t: t.transpose(1, 2).reshape(B, S, D).to(cdt)
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1), merge(attn)


@functools.cache
def _lib():
    lib = _build.load('fused_attention')
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.tcow_gemm_bias.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
    lib.tcow_attn_core.argtypes = [i32, ptr, ptr, i32, i32, i32, i32, i32, i32, f32, ptr]
    lib.tcow_attn_bwd.argtypes = [i32, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                  f32, ptr]
    for fn in (lib.tcow_gemm_bias, lib.tcow_attn_core, lib.tcow_attn_bwd):
        fn.restype = i32
    return lib


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def _check_kernel_inputs(x, weights, num_heads: int, what: str):
    '''Raises for what the kernels do not take; returns (B, S, D, head_dim). `weights` is a
    sequence of (name, tensor, shape) of float32 operands.'''
    if x.device.type != 'cuda':
        raise ValueError(f'{what} runs on cpu or cuda, not {x.device}')
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


def fused_attention_fwd(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int,
                        causal_attention: int):
    '''K1: attention forward over x (B, S, D); weights (D, 3D), (3D,), (D, D), (D,) f32.
    CPU tensors run `attention_ref`; CUDA tensors launch the kernel chain gemm_bias ->
    attn_core -> gemm_bias on the current stream and add one to
    `fused_attention.launches`.'''
    if x.device.type == 'cpu':
        return attention_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention)
    D = x.shape[-1]
    B, S, D, dh = _check_kernel_inputs(
        x, (('qkv_w', qkv_w, (D, 3 * D)), ('qkv_b', qkv_b, (3 * D,)),
            ('proj_w', proj_w, (D, D)), ('proj_b', proj_b, (D,))),
        num_heads, 'fused_attention')
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        qkv = torch.empty((B, S, 3 * D), dtype=x.dtype, device=x.device)
        attn = torch.empty_like(x)
        out = torch.empty_like(x)
        _check(lib.tcow_gemm_bias(code, x.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(),
                                  qkv.data_ptr(), B * S, 3 * D, D, 0, stream), 'gemm_bias(qkv)')
        _check(lib.tcow_attn_core(code, qkv.data_ptr(), attn.data_ptr(), B, S, num_heads,
                                  dh, int(causal_attention > 0), _mask_diag(causal_attention),
                                  dh ** -0.5, stream), 'attn_core')
        _check(lib.tcow_gemm_bias(code, attn.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
                                  out.data_ptr(), B * S, D, D, 0, stream), 'gemm_bias(proj)')
    fused_attention.launches += 1
    return out


def fused_attention_bwd(x, g, qkv_w, qkv_b, proj_w, num_heads: int, causal_attention: int):
    '''K4: the in-kernel part of the attention backward over x, g (B, S, D) in one dtype;
    weights (D, 3D), (3D,), (D, D) f32 -> (dqkv (B, S, 3D), attn (B, S, D)) in x.dtype.
    CPU tensors run `attention_bwd_ref`; CUDA tensors launch gemm_bias (qkv) -> gemm_bias
    (g . proj_w^T) -> attn_bwd_q -> attn_bwd_kv on the current stream and add one to
    `fused_attention_bwd.launches`.'''
    if x.device.type == 'cpu':
        return attention_bwd_ref(x, g, qkv_w, qkv_b, proj_w, num_heads, causal_attention)
    D = x.shape[-1]
    B, S, D, dh = _check_kernel_inputs(
        x, (('qkv_w', qkv_w, (D, 3 * D)), ('qkv_b', qkv_b, (3 * D,)),
            ('proj_w', proj_w, (D, D))),
        num_heads, 'fused_attention_bwd')
    if g.dtype != x.dtype or g.shape != x.shape or g.device != x.device:
        raise ValueError(f'g must match x ({x.dtype} {tuple(x.shape)} on {x.device}), got '
                         f'{g.dtype} {tuple(g.shape)} on {g.device}')
    if not g.is_contiguous() or g.data_ptr() % 16:
        raise ValueError('g must be contiguous and 16-byte aligned')
    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        qkv = torch.empty((B, S, 3 * D), dtype=x.dtype, device=x.device)
        dattn = torch.empty_like(x)
        attn = torch.empty_like(x)
        dqkv = torch.empty((B, S, 3 * D), dtype=x.dtype, device=x.device)
        stats = torch.empty((3, B, num_heads, S), dtype=torch.float32, device=x.device)
        _check(lib.tcow_gemm_bias(code, x.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(),
                                  qkv.data_ptr(), B * S, 3 * D, D, 0, stream), 'gemm_bias(qkv)')
        _check(lib.tcow_gemm_bias(code, g.data_ptr(), proj_w.data_ptr(), None,
                                  dattn.data_ptr(), B * S, D, D, 1, stream), 'gemm(g proj_w^T)')
        _check(lib.tcow_attn_bwd(code, qkv.data_ptr(), dattn.data_ptr(), attn.data_ptr(),
                                 dqkv.data_ptr(), stats.data_ptr(), B, S, num_heads, dh,
                                 int(causal_attention > 0), _mask_diag(causal_attention),
                                 dh ** -0.5, stream), 'attn_bwd')
    fused_attention_bwd.launches += 1
    return dqkv, attn


def _mm_f32(a, b):
    '''a . b accumulated and returned in f32, as dot_general with preferred_element_type
    f32. On the card a bf16 product keeps bf16 operands and writes f32 (cuBLAS); on the
    CPU the operands are widened, which is exact.'''
    if a.dtype == torch.float32:
        return torch.mm(a, b)
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return torch.mm(a.float(), b.float())


class FusedAttention(torch.autograd.Function):
    '''The custom VJP of pallas_attention.fused_attention in 'kernel_x' mode.'''

    @staticmethod
    def forward(ctx, x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int):
        ctx.save_for_backward(x, qkv_w, qkv_b, proj_w)
        ctx.num_heads, ctx.causal_attention = num_heads, causal_attention
        return fused_attention_fwd(x, qkv_w, qkv_b, proj_w, proj_b, num_heads,
                                   causal_attention)

    @staticmethod
    def backward(ctx, g):
        x, qkv_w, qkv_b, proj_w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()                                           # :687
        dqkv, attn = fused_attention_bwd(x, g, qkv_w, qkv_b, proj_w, ctx.num_heads,
                                         ctx.causal_attention)
        # Weight, bias and input gradients as plain products (:768-778).
        D = x.shape[-1]
        g2, x2 = g.reshape(-1, D), x.reshape(-1, D)
        attn2, dqkv2 = attn.reshape(-1, D), dqkv.reshape(-1, 3 * D)
        dproj_w = _mm_f32(attn2.T, g2)
        dproj_b = g2.sum(dim=0, dtype=torch.float32)
        dqkv_w = _mm_f32(x2.T, dqkv2)
        dqkv_b = dqkv2.sum(dim=0, dtype=torch.float32)
        dx = torch.matmul(dqkv2, qkv_w.to(x.dtype).T).reshape(x.shape)
        return dx, dqkv_w, dqkv_b, dproj_w, dproj_b, None, None


def fused_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int):
    '''Differentiable fused attention over x (B, S, D); weights (D, 3D), (3D,), (D, D),
    (D,) f32. The forward is K1 and the backward K4 on CUDA tensors, the plain versions on
    CPU tensors; every other device raises.'''
    return FusedAttention.apply(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention)


fused_attention.launches = 0
fused_attention_bwd.launches = 0
