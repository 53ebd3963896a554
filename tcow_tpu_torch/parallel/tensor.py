'''
Tensor parallelism of a transformer block over the model group of a DataMesh
(parallel/mesh.py): the port of the JAX package's model axis, under block_pspec's layout.

Attention is row-parallel, as tcow_tpu/ops/pallas_attention.py:fused_attention_rows
(:469-533) runs the kernel path: the flat rows (R, S, D) of every attention call are
independent sequences, so each model rank runs the single-device fused_attention (K1 ... K6
by bwd_mode on the card, the plain versions on the CPU) on its contiguous chunk of the
rows, zero-padded up to a multiple of the shard count, with the weights gathered from
their row shards. The output is gathered over the model group; in the backward each rank
runs the kernel backward on its rows, dx is gathered, and the weight and bias cotangents
are summed over the model group (the replicated qkv.b / proj.b too: each rank's are its
rows' part).

The MLP is Megatron's (timesformer.py:319-322 of the JAX package under the layout): fc1
column-parallel and a local GELU, then fc2 row-parallel, its partial products summed over
the model group in the activation dtype (as JAX's psum), fc2.b added once after the sum;
in the backward the input gradient of fc1 is summed over the model group.
'''

import torch
import torch.nn.functional as F

from tcow_tpu_torch.ops.fused_attention import fused_attention
from tcow_tpu_torch.parallel import mesh as mesh_lib


def _pad_rows(t, rows: int):
    if t.shape[0] == rows:
        return t
    return torch.cat([t, t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))])


def attention_rows(x, qkv_w, qkv_b, proj_w, proj_b, num_heads: int, causal_attention: int,
                   bwd_mode: str, rope: bool, pos, mesh):
    '''fused_attention over x (R, S, D), replicated on the model group, with this rank's
    row shards qkv_w (D / n, 3D) and proj_w (D / n, D) and the replicated biases: each
    rank runs the call on its chunk of ceil(R / n) rows (pos (R, S), when given, split
    with them) and the chunks are gathered into the (R, S, D) output.'''
    R, S, D = x.shape
    n = mesh.n_model
    rows = -(-R // n) * n
    x_part = mesh_lib.scatter_rows(_pad_rows(x, rows), mesh)
    if pos is not None:
        k = rows // n
        pos = _pad_rows(pos, rows)[mesh.model_rank * k:(mesh.model_rank + 1) * k].contiguous()
    out = fused_attention(x_part.contiguous(), mesh_lib.gather_weight(qkv_w, mesh),
                          mesh_lib.copy_to_model(qkv_b, mesh),
                          mesh_lib.gather_weight(proj_w, mesh),
                          mesh_lib.copy_to_model(proj_b, mesh), num_heads, causal_attention,
                          bwd_mode, rope, pos)
    out = mesh_lib.gather_rows(out, mesh)
    return out if rows == R else out[:R]


def megatron_mlp(x, fc1, fc2, mesh):
    '''fc2(gelu(fc1(x))) with fc1 (Dense of this rank's output columns) and fc2 (Dense of
    this rank's input rows, replicated bias): gelu is exact (erf), as the one-process Mlp.'''
    h = F.gelu(fc1(mesh_lib.copy_to_model(x, mesh)))
    y = mesh_lib.reduce_from_model(torch.matmul(h, fc2.w.to(h.dtype)), mesh)
    return y + fc2.b.to(y.dtype)
