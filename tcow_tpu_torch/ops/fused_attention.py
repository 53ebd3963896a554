'''
Fused multi-head self-attention forward: the port of tcow_tpu/ops/pallas_attention.py.

`fused_attention` keeps the contract of the TPU kernel's entry point (forward only):
out = proj(softmax_mask(q k^T dh^-0.5) v) with qkv = x qkv_w + qkv_b, over (B, S, D).
A CPU tensor goes to `attention_ref`, the plain PyTorch version. A CUDA tensor goes to
the hand-written kernels of csrc/fused_attention.cu (built with nvcc at first use), or
the call raises: there is no fallback from the card to the plain version.
'''

import ctypes
import functools

import torch

from tcow_tpu_torch.ops import _build

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _mask_diag(causal_attention: int) -> int:
    return 0 if causal_attention <= 2 else causal_attention - 2


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
        keep = torch.ones(S, S, dtype=torch.bool, device=x.device).tril(
            _mask_diag(causal_attention))
        logits = logits.masked_fill(~keep, -1e10)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    out = torch.matmul(probs, v).transpose(1, 2).reshape(B, S, D)
    return torch.matmul(out, proj_w.to(x.dtype)) + proj_b.to(x.dtype)


@functools.cache
def _lib():
    lib = _build.load('fused_attention')
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.tcow_gemm_bias.argtypes = [i32, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.tcow_gemm_bias.restype = i32
    lib.tcow_attn_core.argtypes = [i32, ptr, ptr, i32, i32, i32, i32, i32, i32,
                                   ctypes.c_float, ptr]
    lib.tcow_attn_core.restype = i32
    return lib


def _check(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f'{what}: CUDA error {rc} at launch')


def fused_attention(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int):
    '''Fused attention forward over x (B, S, D); weights (D, 3D), (3D,), (D, D), (D,) f32.
    CPU tensors run `attention_ref`; CUDA tensors launch the kernel chain gemm_bias ->
    attn_core -> gemm_bias on the current stream and add one to `fused_attention.launches`.'''
    if x.device.type == 'cpu':
        return attention_ref(x, qkv_w, qkv_b, proj_w, proj_b, num_heads, causal_attention)
    if x.device.type != 'cuda':
        raise ValueError(f'fused_attention runs on cpu or cuda, not {x.device}')
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f'fused_attention kernel takes float32 or bfloat16, not {x.dtype}')
    if x.dim() != 3:
        raise ValueError(f'x must be (B, S, D), got {tuple(x.shape)}')
    B, S, D = x.shape
    if D % num_heads:
        raise ValueError(f'D={D} not divisible by num_heads={num_heads}')
    dh = D // num_heads
    if D % 8 or dh % 4 or dh > 128:
        raise ValueError(f'kernel needs D % 8 == 0 and head_dim % 4 == 0, <= 128 '
                         f'(D={D}, head_dim={dh})')
    for name, t, shape in (('qkv_w', qkv_w, (D, 3 * D)), ('qkv_b', qkv_b, (3 * D,)),
                           ('proj_w', proj_w, (D, D)), ('proj_b', proj_b, (D,))):
        if t.dtype != torch.float32 or tuple(t.shape) != shape or t.device != x.device:
            raise ValueError(f'{name} must be float32 {shape} on {x.device}, got '
                             f'{t.dtype} {tuple(t.shape)} on {t.device}')
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f'{name} must be contiguous and 16-byte aligned')
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError('x must be contiguous and 16-byte aligned')

    lib = _lib()
    code = _DTYPE_CODES[x.dtype]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        qkv = torch.empty((B, S, 3 * D), dtype=x.dtype, device=x.device)
        attn = torch.empty_like(x)
        out = torch.empty_like(x)
        _check(lib.tcow_gemm_bias(code, x.data_ptr(), qkv_w.data_ptr(), qkv_b.data_ptr(),
                                  qkv.data_ptr(), B * S, 3 * D, D, stream), 'gemm_bias(qkv)')
        _check(lib.tcow_attn_core(code, qkv.data_ptr(), attn.data_ptr(), B, S, num_heads,
                                  dh, int(causal_attention > 0), _mask_diag(causal_attention),
                                  dh ** -0.5, stream), 'attn_core')
        _check(lib.tcow_gemm_bias(code, attn.data_ptr(), proj_w.data_ptr(), proj_b.data_ptr(),
                                  out.data_ptr(), B * S, D, D, stream), 'gemm_bias(proj)')
    fused_attention.launches += 1
    return out


fused_attention.launches = 0
