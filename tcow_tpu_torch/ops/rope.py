'''
Rotary position embeddings (rope) for the temporal attention axis: the port of
tcow_tpu/ops/rope.py (`rope_tables` :24-30, `apply_rope` :63-72).

Half-split convention: for x = [x1, x2] along the feature axis,
R_p x = [x1 cos - x2 sin, x1 sin + x2 cos] with angles p * base^(-2j / dh). R_p is
orthogonal and its inverse is R_{-p}, which the attention backwards use to un-rotate the
gradients of q and k.

The JAX module also has `tables_from_positions` and `packed_tables`: the same tables built
from 2-D iotas, because Mosaic rejects 1-D iota and in-kernel reshapes on the TPU. They
have no counterpart here. The port builds every table with `rope_tables`, outside the
kernels, and hands the same tables to a CUDA kernel and to its plain version.
'''

import torch

DEFAULT_BASE = 10000.0


def rope_tables(positions, dh: int, base: float = DEFAULT_BASE):
    '''cos, sin tables (..., dh // 2) in float32 for positions (...) and an even feature
    dim dh: freqs = base ** (-j * 2 / dh), angle = position * freq, as JAX computes them.'''
    if dh % 2:
        raise ValueError(f'rope needs an even head dim, got {dh}')
    positions = torch.as_tensor(positions).to(torch.float32)
    j = torch.arange(dh // 2, dtype=torch.float32, device=positions.device)
    freqs = torch.pow(torch.tensor(base, dtype=torch.float32, device=positions.device),
                      -j * 2.0 / dh)
    ang = positions[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin, inverse: bool = False):
    '''Rotates x (..., S, dh) by tables cos, sin broadcastable to (..., S, dh / 2);
    inverse=True applies R^T (rotation by -p). The math in float32, the result rounded to
    x.dtype.'''
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h].float(), x[..., h:].float()
    c, s = cos.float(), sin.float()
    if inverse:
        s = -s
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)
