'''
TimeSformer backbone in PyTorch: the port of tcow_tpu/models/timesformer.py (forward
:713-862), divided space-time (_divided_block :388-450) or joint space-time
(_joint_block :453-466), with stochastic depth (drop_path :325-337) and per-block
rematerialization under JAX's remat policies (:797-818) for training.

Under temporal_rope the temporal attention rotates q and k by each frame's position
(time-calibrated with `frame_times`, :406-411) and the absolute time embedding is skipped
(:751-757).

Parameters keep the JAX layout and names (linear `w` is (din, dout), LayerNorm `g`/`b`),
with the stacked block axis unrolled into a ModuleList; weights.py converts between the
two. Master weights stay float32 and are cast to the compute dtype at use.

Under tensor parallelism (a DataMesh whose model axis has n > 1 ranks, passed to the
constructor) each block holds this rank's shards of qkv.w and proj.w (D / n input rows),
of fc1 (Hm / n output columns) and of fc2.w (Hm / n input rows), and runs its attention
row-parallel and its MLP as Megatron's (parallel/tensor.py); without a mesh, or with one
model rank, every path is the one-process one.

Under sequence parallelism (a mesh whose seq axis has n > 1 ranks) every rank holds the
whole model; the tokens are split over the seq ranks after the embedding (seq_split) and
gathered before the norm (seq_gather). A divided block runs temporal attention,
temporal_fc and the MLP on this rank's patches and spatial attention on its frames, with an
all-to-all at each swap and the cls token's collectives (parallel/sequence.py). Joint
blocks split the folded clips instead, zero-padded to a multiple of n (the rows of JAX's
fused_attention_rows): each rank runs whole blocks on its rows, with no collective inside
them.

Under pipeline parallelism (a mesh whose pipe axis has n > 1 ranks) the model holds this
stage's blocks only (mesh.stage_blocks: a contiguous chunk of depth / n, numbered from 0
in its state_dict) and the whole embedding and norm; `embed`, `run_blocks` and `finish`
are the forward's three parts, which train/step.py runs on the first stage, on every stage
per microbatch (parallel/pipeline.py) and on the last stage, with seq_split after `embed`
and seq_gather before `finish` under sequence parallelism beside it. The drop-path masks
are drawn for every block (stage_masks) and the stage keeps its blocks', so the generator
advances as in one process; the checkpoint regions group remat_group of the stage's blocks.
'''

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from tcow_tpu_torch.ops.fused_attention import BWD_MODES, FORWARD_OPS, fused_attention
from tcow_tpu_torch.parallel import mesh as mesh_lib
from tcow_tpu_torch.parallel import sequence as seq_lib
from tcow_tpu_torch.parallel import tensor as tensor_lib

# Input normalization constants for pretrained backbones.
TIMESFORMER_MEAN = (0.45, 0.45, 0.45)
TIMESFORMER_STD = (0.225, 0.225, 0.225)

# network_depth -> (embed_dim, num_heads), as in tcow_tpu timesformer.py:39.
DEPTH_PRESETS = {12: (768, 12), 18: (896, 14), 24: (1024, 16)}

REMAT_POLICIES = ('full', 'dots', 'dots_nb', 'dots_nb_attn', 'attn_res', 'dots_nb_out',
                  'dots_nb_out_qkv')
ATTENTION_TYPES = ('divided_space_time', 'joint_space_time')


def check_config(attention_type: str, remat_policy: str, attention_bwd: str):
    '''Raises ValueError for unknown names.'''
    if remat_policy not in REMAT_POLICIES:
        raise ValueError(f'unknown remat_policy {remat_policy!r}; one of {REMAT_POLICIES}')
    if attention_bwd not in BWD_MODES:
        raise ValueError(f'unknown attention_bwd {attention_bwd!r}; one of {BWD_MODES}')
    if attention_type not in ATTENTION_TYPES:
        raise ValueError(f'unknown attention_type {attention_type!r}; one of '
                         f'{ATTENTION_TYPES}')


def check_remat_group(depth: int, remat_group: int):
    '''Raises ValueError unless remat_group blocks per checkpoint region tile the depth
    (timesformer.py:784-785 of the JAX package asserts it).'''
    if remat_group < 1 or depth % remat_group:
        raise ValueError(f'remat_group={remat_group} must be >= 1 and divide the depth '
                         f'{depth}')


def remat_saved_ops(policy: str) -> list:
    '''The operators whose outputs a remat policy keeps across a block's checkpoint; the
    rest is recomputed in the backward. JAX's policies (timesformer.py:797-818) by what
    they name: 'dots_nb' the non-batched products (Dense's mm); 'dots' the batched ones
    too, which a block reaches only through the plain attention; '_out' the attention
    output ('attn_out'); '_qkv' also qkv ('attn_qkv'); 'attn_res' and 'dots_nb_attn' the
    residuals of 'res' ('attn_res'). An attention forward is one operator whose outputs
    are kept together: the output alone for 'kernel_x' / 'kernel_x_wg', with qkv for
    'kernel_qkv', with qkv, probs and attn for 'res'. 'full' keeps nothing.'''
    aten = torch.ops.aten
    ops = []
    if policy.startswith('dots'):
        ops.append(aten.mm.default)
    if policy == 'dots':
        ops.append(aten.bmm.default)
    if policy in ('dots_nb_out', 'dots_nb_out_qkv'):
        ops.append(FORWARD_OPS['kernel_x'])
    if policy == 'dots_nb_out_qkv':
        ops.append(FORWARD_OPS['kernel_qkv'])
    if policy in ('dots_nb_attn', 'attn_res'):
        ops.append(FORWARD_OPS['res'])
    return ops


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig:
    frame_height: int = 240
    frame_width: int = 320
    patch_size: int = 16
    in_channels: int = 4
    num_frames: int = 30
    depth: int = 12
    embed_dim: int = 768
    num_heads: int = 12
    mlp_ratio: float = 4.0
    attention_type: str = 'divided_space_time'
    causal_attention: int = 0  # 0 off; 1/2 tril; >=3 tril(diagonal=ca-2); -1 no-cls variant
    norm_embeddings: bool = False
    drop_path_rate: float = 0.1   # stochastic depth of the last block; used when training
    normalize_inputs: bool = False  # subtract ImageNet-video mean/std on RGB channels
    ln_eps: float = 1e-6
    compute_dtype: torch.dtype = torch.float32
    remat: bool = False  # recompute each block in the backward pass (saves memory)
    remat_policy: str = 'full'  # what a remat block keeps (REMAT_POLICIES)
    remat_group: int = 1  # consecutive blocks per checkpoint region under remat
    attention_bwd: str = 'res'  # 'res' | 'kernel_qkv' | 'kernel_x' | 'kernel_x_wg'
    temporal_rope: bool = False  # rope on temporal attention, no absolute time embedding

    def __post_init__(self):
        check_config(self.attention_type, self.remat_policy, self.attention_bwd)
        check_remat_group(self.depth, self.remat_group)

    @property
    def grid_h(self) -> int:
        return self.frame_height // self.patch_size

    @property
    def grid_w(self) -> int:
        return self.frame_width // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_h * self.grid_w

    @property
    def mlp_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def divided(self) -> bool:
        return self.attention_type == 'divided_space_time'


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------

_TRUNC_LO = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))   # standard normal CDF at -2


def trunc_normal_(t: torch.Tensor, generator: torch.Generator, std: float = 0.02):
    '''Fills t with a normal truncated at +-2 sigma (torch trunc_normal_ semantics), drawn
    by inverse CDF from `generator` (on the generator's device) and copied into t.'''
    u = torch.empty(t.shape, dtype=torch.float64, device=generator.device)
    u.uniform_(_TRUNC_LO, 1.0 - _TRUNC_LO, generator=generator)
    z = torch.erfinv(2.0 * u - 1.0) * math.sqrt(2.0)
    with torch.no_grad():
        t.copy_((z.clamp_(-2.0, 2.0) * std).to(t.dtype))
    return t


# ---------------------------------------------------------------------------
# Core ops
# ---------------------------------------------------------------------------

class Dense(nn.Module):
    '''y = x w + b with w (din, dout), both cast to x's dtype at use (timesformer.py:207).'''

    def __init__(self, din: int, dout: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(din, dout, device=device))
        self.b = nn.Parameter(torch.zeros(dout, device=device))

    def forward(self, x):
        return torch.matmul(x, self.w.to(x.dtype)) + self.b.to(x.dtype)


class LayerNorm(nn.Module):
    '''LayerNorm computed in float32, result in the input dtype (timesformer.py:199-204).'''

    def __init__(self, dim: int, eps: float, device=None):
        super().__init__()
        self.eps = eps
        self.g = nn.Parameter(torch.ones(dim, device=device))
        self.b = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        return (y * self.g + self.b).to(x.dtype)


class Attention(nn.Module):
    '''Multi-head self-attention over the second-to-last axis (timesformer.py:212-316),
    always through ops.fused_attention in the backward mode `bwd_mode`: the plain versions
    on the CPU, the kernels on CUDA. With a tensor-parallel mesh `tp`, qkv.w and proj.w are
    this rank's row shards and the call runs row-parallel (tensor.attention_rows).'''

    def __init__(self, dim: int, num_heads: int, bwd_mode: str, device=None, tp=None):
        super().__init__()
        self.num_heads = num_heads
        self.bwd_mode = bwd_mode
        self.tp = tp
        n = 1 if tp is None else tp.n_model
        self.qkv = Dense(dim // n, 3 * dim, device)
        self.proj = Dense(dim // n, dim, device)

    def forward(self, x, causal_attention: int, rope: bool = False, pos=None):
        '''x (..., S, D); with rope, q and k rotated by positions pos (..., S) f32, or by
        0..S-1 when pos is None (:243).'''
        *lead, S, D = x.shape
        flat_pos = None if pos is None else pos.reshape(-1, S).contiguous()
        args = (x.reshape(-1, S, D).contiguous(), self.qkv.w, self.qkv.b, self.proj.w,
                self.proj.b, self.num_heads, causal_attention, self.bwd_mode, rope, flat_pos)
        out = (fused_attention(*args) if self.tp is None
               else tensor_lib.attention_rows(*args, self.tp))
        return out.reshape(*lead, S, D)


class Mlp(nn.Module):
    '''fc2(gelu(fc1(x))); with a tensor-parallel mesh `tp`, fc1 holds this rank's output
    columns and fc2.w its input rows (tensor.megatron_mlp).'''

    def __init__(self, dim: int, hidden: int, device=None, tp=None):
        super().__init__()
        self.tp = tp
        n = 1 if tp is None else tp.n_model
        self.fc1 = Dense(dim, hidden // n, device)
        self.fc2 = Dense(hidden // n, dim, device)

    def forward(self, x):
        if self.tp is not None:
            return tensor_lib.megatron_mlp(x, self.fc1, self.fc2, self.tp)
        return self.fc2(F.gelu(self.fc1(x)))   # exact (erf) GELU


def drop_path(x, mask, keep):
    '''Stochastic depth with a drawn row mask (timesformer.py:325-337): x * mask / keep in
    x.dtype, where mask (0 or 1) covers the leading axes of x and keep is a scalar tensor.'''
    mask = mask.reshape(mask.shape + (1,) * (x.dim() - mask.dim())).to(x.dtype)
    return x * mask / keep.to(x.dtype)


@dataclasses.dataclass
class DropPathMasks:
    '''One block's drop-path draws for a folded batch of B clips: keep probability (scalar
    f32 tensor) and masks over (B, N) for temporal attention, (B, T) for spatial attention
    and (B,) for the MLP, shared by the tokens and the cls token (:412, :425, :445-449).
    A joint block has no temporal mask, and its spatial mask is (B,): one per clip over
    the whole space-time sequence (:463-465).'''
    keep: torch.Tensor
    temporal: Optional[torch.Tensor]
    spatial: torch.Tensor
    mlp: torch.Tensor

    def rows(self, start: int, stop: int) -> 'DropPathMasks':
        '''The masks of clips [start, stop) (a pipeline microbatch's); rows past the batch
        (a seq rank's zero padding, seq_lib.split_rows) keep theirs.'''
        def part(m):
            if m is None:
                return None
            pad = stop - max(start, m.shape[0])
            return m[start:stop] if pad <= 0 else torch.cat(
                [m[start:stop], m.new_ones((pad,) + tuple(m.shape[1:]))])
        return DropPathMasks(self.keep, part(self.temporal), part(self.spatial),
                             part(self.mlp))


def draw_drop_path_masks(generator: torch.Generator, rate: float, depth: int, B: int, N: int,
                         T: int, device, divided: bool = True,
                         rows: Optional[Tuple[int, int]] = None,
                         cols: Optional[Tuple[Tuple[int, int], Tuple[int, int]]] = None
                         ) -> list:
    '''Every block's masks for one forward, drawn up front from `generator` (as JAX splits
    the block keys before the scan, :769-771) and moved to `device` once. Drawing outside
    the blocks keeps them fixed when a rematerialized block is recomputed in the backward
    pass. Per-block rates are linspace(0, rate, depth) (:767); a row survives when its
    uniform draw is below keep = 1 - rate. divided=False draws a joint block's masks.
    rows = (start, total): the B rows are rows [start, start + B) of a batch of `total`
    (one rank's rows under data parallelism): the masks of all `total` rows are drawn, so
    the generator advances as for the whole batch, and these rows' are kept. cols =
    ((n0, n1), (t0, t1)): the columns of this rank's patches and frames under sequence
    parallelism, kept of the whole (B, N) and (B, T) draws.'''
    start, total = (0, B) if rows is None else rows
    keep = 1.0 - torch.linspace(0.0, rate, depth, dtype=torch.float32)
    draw = lambda *shape: (torch.rand((depth, total) + shape, generator=generator,
                                      device=generator.device)[:, start:start + B]
                           < keep.to(generator.device).reshape((depth,) + (1,) * (len(shape) + 1)))
    if divided:
        temporal, spatial = draw(N), draw(T)
        if cols is not None:
            (n0, n1), (t0, t1) = cols
            temporal, spatial = temporal[..., n0:n1], spatial[..., t0:t1]
        keep, temporal, spatial, mlp = (t.to(device) for t in (keep, temporal, spatial, draw()))
        return [DropPathMasks(keep[i], temporal[i], spatial[i], mlp[i]) for i in range(depth)]
    keep, spatial, mlp = (t.to(device) for t in (keep, draw(), draw()))
    return [DropPathMasks(keep[i], None, spatial[i], mlp[i]) for i in range(depth)]


class DividedBlock(nn.Module):
    '''One divided space-time block (timesformer.py:388-450). With a sequence-parallel mesh
    `sp`, xs holds this rank's patches (parallel/sequence.py).'''

    def __init__(self, cfg: TimeSformerConfig, device=None, tp=None, sp=None):
        super().__init__()
        D = cfg.embed_dim
        self.cfg = cfg
        self.sp = sp
        self.norm1 = LayerNorm(D, cfg.ln_eps, device)
        self.attn = Attention(D, cfg.num_heads, cfg.attention_bwd, device, tp)
        self.norm2 = LayerNorm(D, cfg.ln_eps, device)
        self.mlp = Mlp(D, cfg.mlp_dim, device, tp)
        self.temporal_norm1 = LayerNorm(D, cfg.ln_eps, device)
        self.temporal_attn = Attention(D, cfg.num_heads, cfg.attention_bwd, device, tp)
        self.temporal_fc = Dense(D, D, device)

    def forward(self, xs, cls, masks: DropPathMasks = None, frame_times=None,
                num_patches: Optional[int] = None):
        '''xs (B, N, T, D) patch tokens, cls (B, D), drop-path masks or None, frame_times
        (B, T) f32 or None -> updated (xs, cls). Under sequence parallelism xs holds this
        rank's chunk of the num_patches patches and the masks its columns.'''
        B, N, T, D = xs.shape
        ca = self.cfg.causal_attention
        sp = self.sp

        def dp(x, which):
            return x if masks is None else drop_path(x, getattr(masks, which), masks.keep)

        # Temporal attention over T per patch location, rotated under temporal_rope by the
        # clip's frame times (every patch shares them); drop-path mask per (b, n).
        pos = None if frame_times is None else frame_times[:, None, :].expand(B, N, T)
        res_t = dp(self.temporal_attn(self.temporal_norm1(xs), ca, self.cfg.temporal_rope, pos),
                   'temporal')
        xt = xs + self.temporal_fc(res_t)

        # Spatial attention over patches per frame, with the three cls behaviours; under
        # sequence parallelism over this rank's frames, after the all-to-all.
        xsp = (xt.transpose(1, 2) if sp is None
               else seq_lib.patches_to_frames(xt, sp, num_patches))   # (B, T, N, D)
        if ca in (0, 1):
            seq = torch.cat([cls[:, None, None, :].expand(B, xsp.shape[1], 1, D), xsp], dim=2)
            res_sp = dp(self.attn(self.norm1(seq), 0), 'spatial')  # (B, T, N+1, D), per (b, t)
            cls_out = res_sp[:, :, 0, :]
            # ca 0: mean over frames; ca 1: frame-0 copy.
            if sp is None:
                cls_new = cls_out.mean(dim=1) if ca == 0 else cls_out[:, 0, :]
            else:
                cls_new = (seq_lib.mean_over_frames(cls_out, sp, T) if ca == 0
                           else seq_lib.first_frame(cls_out, sp))
            res_sp = res_sp[:, :, 1:, :]
        else:  # ca >= 2 or ca == -1: no cls token in spatial attention.
            res_sp = dp(self.attn(self.norm1(xsp), 0), 'spatial')
            cls_new = torch.zeros_like(cls)
        res_sp = (res_sp.transpose(1, 2) if sp is None
                  else seq_lib.frames_to_patches(res_sp, sp, T))

        tokens = xt + res_sp
        cls2 = cls + cls_new
        # MLP over the tokens and the cls token, one drop-path mask per clip for both.
        tokens = tokens + dp(self.mlp(self.norm2(tokens)), 'mlp')
        cls2 = cls2 + dp(self.mlp(self.norm2(cls2)), 'mlp')
        return tokens, cls2


class JointBlock(nn.Module):
    '''One joint space-time block (timesformer.py:453-466): a single attention over the
    cls token and every patch of every frame, 1 + N*T tokens in the reference's order
    b (h w t) m, never causal (JAX passes no causal_attention there, :460-462), then the
    MLP over the whole sequence. It has no temporal parameters.'''

    def __init__(self, cfg: TimeSformerConfig, device=None, tp=None):
        super().__init__()
        D = cfg.embed_dim
        self.norm1 = LayerNorm(D, cfg.ln_eps, device)
        self.attn = Attention(D, cfg.num_heads, cfg.attention_bwd, device, tp)
        self.norm2 = LayerNorm(D, cfg.ln_eps, device)
        self.mlp = Mlp(D, cfg.mlp_dim, device, tp)

    def forward(self, xs, cls, masks: DropPathMasks = None, frame_times=None,
                num_patches: Optional[int] = None):
        '''xs (B, N, T, D), cls (B, D), drop-path masks or None -> updated (xs, cls).
        frame_times and num_patches are unused: rope needs the divided temporal axis, and
        under sequence parallelism the rows are this rank's whole clips.'''
        B, N, T, D = xs.shape

        def dp(x, which):
            return x if masks is None else drop_path(x, getattr(masks, which), masks.keep)

        flat = torch.cat([cls[:, None, :], xs.reshape(B, N * T, D)], dim=1)
        flat = flat + dp(self.attn(self.norm1(flat), 0), 'spatial')
        flat = flat + dp(self.mlp(self.norm2(flat)), 'mlp')
        return flat[:, 1:].reshape(B, N, T, D), flat[:, 0]


def nearest_resize_1d(emb: torch.Tensor, new_len: int, dim: int = 0) -> torch.Tensor:
    '''torch F.interpolate(mode=nearest) semantics: src = floor(dst * in/out).'''
    n_in = emb.shape[dim]
    if n_in == new_len:
        return emb
    idx = np.floor(np.arange(new_len) * n_in / new_len).astype(np.int64)
    return emb.index_select(dim, torch.as_tensor(idx, device=emb.device))


def resize_pos_embed(pos_embed: torch.Tensor, src_grid: Tuple[int, int],
                     grid: Tuple[int, int]) -> torch.Tensor:
    '''Nearest-resizes the non-cls part of a (N+1, D) pos embed laid out on `src_grid`
    (h, w) to `grid`; kept as is when the patch counts agree (timesformer.py:349-372).'''
    (sh, sw), (gh, gw) = src_grid, grid
    if sh * sw == gh * gw:
        return pos_embed
    D = pos_embed.shape[1]
    g = pos_embed[1:].reshape(sh, sw, D)
    g = nearest_resize_1d(nearest_resize_1d(g, gh, dim=0), gw, dim=1)
    return torch.cat([pos_embed[0:1], g.reshape(gh * gw, D)], dim=0)


def _run_blocks(blocks, num_patches, xs, cls, masks, frame_times):
    '''The blocks in order, each with its drop-path masks (or None).'''
    for blk, m in zip(blocks, masks):
        xs, cls = blk(xs, cls, m, frame_times, num_patches)
    return xs, cls


class TimeSformer(nn.Module):
    '''Dense forward: pixels (B, C, T, H, W) -> (features (B, D, T, H', W'), cls (B, D)).
    With a mesh whose model axis has more than one rank the blocks hold this rank's
    shards; with one whose seq axis has, they split the tokens; with one whose pipe axis
    has, the model holds this stage's blocks (module docstring). `self.mesh` is that mesh
    (None without any), `tp` / `sp` / `pp` the mesh for each axis that has more than one
    rank, `block_ids` the global indices of the blocks held.'''

    def __init__(self, cfg: TimeSformerConfig, device=None, mesh=None):
        super().__init__()
        D, p = cfg.embed_dim, cfg.patch_size
        self.cfg = cfg
        self.tp, self.sp = mesh_lib.tp_mesh(mesh), mesh_lib.sp_mesh(mesh)
        self.pp = mesh_lib.pp_mesh(mesh)
        self.mesh = mesh if any(m is not None for m in (self.tp, self.sp, self.pp)) else None
        if self.tp is not None:
            mesh_lib.check_tp_widths(self.tp.n_model, D, cfg.mlp_dim)
        if self.sp is not None and cfg.divided:
            seq_lib.check_seq_split(cfg.num_patches, cfg.num_frames, self.sp.n_seq)
        self.block_ids = (range(cfg.depth) if self.pp is None
                          else self.pp.stage_blocks(cfg.depth))
        if len(self.block_ids) % cfg.remat_group:
            raise ValueError(f'remat_group {cfg.remat_group} does not divide the '
                             f'{len(self.block_ids)} blocks of a pipeline stage')
        self.patch_embed = Dense(p * p * cfg.in_channels, D, device)
        self.cls_token = nn.Parameter(torch.zeros(D, device=device))
        self.pos_embed = nn.Parameter(torch.zeros(cfg.num_patches + 1, D, device=device))
        self.time_embed = nn.Parameter(torch.zeros(cfg.num_frames, D, device=device))
        self.norm = LayerNorm(D, cfg.ln_eps, device)
        self.blocks = nn.ModuleList(
            DividedBlock(cfg, device, self.tp, self.sp) if cfg.divided
            else JointBlock(cfg, device, self.tp) for _ in self.block_ids)

    def init_params_(self, generator: torch.Generator):
        '''Random init of tcow_tpu timesformer.init_params (:149-188): trunc-normal(0.02)
        linears and embeddings, zero biases, unit LayerNorm, temporal_fc zero for blocks > 0
        (divided blocks; joint blocks have none). A tensor- or pipeline-parallel model
        raises: its part comes from the full model's init (mesh.shard_params).'''
        if self.tp is not None or self.pp is not None:
            raise ValueError('initialise the full model and load its part '
                             '(parallel/mesh.py:shard_params)')
        for name, prm in self.named_parameters():
            leaf = name.rsplit('.', 1)[-1]
            with torch.no_grad():
                if leaf in ('w', 'cls_token', 'pos_embed', 'time_embed'):
                    trunc_normal_(prm, generator)
                elif leaf == 'g':
                    prm.fill_(1.0)
                else:
                    prm.zero_()
        if self.cfg.divided:
            with torch.no_grad():
                for blk in self.blocks[1:]:
                    blk.temporal_fc.w.zero_()

    def embed(self, pixels: torch.Tensor):
        '''The part before the blocks: pixels (B, C, T, H, W) -> patch tokens (B, N, T, D)
        with their position and time embeddings, and the cls token (B, D).'''
        cfg = self.cfg
        B, C, T, H, W = pixels.shape
        p, D = cfg.patch_size, cfg.embed_dim
        gh, gw = H // p, W // p
        N = gh * gw
        x = pixels.to(cfg.compute_dtype)

        if cfg.normalize_inputs:
            mean = torch.tensor(TIMESFORMER_MEAN, dtype=x.dtype, device=x.device)
            std = torch.tensor(TIMESFORMER_STD, dtype=x.dtype, device=x.device)
            rgb = (x[:, 0:3] - mean.reshape(1, 3, 1, 1, 1)) / std.reshape(1, 3, 1, 1, 1)
            x = torch.cat([rgb, x[:, 3:]], dim=1)

        # Patch embed over (ph, pw, C) patch vectors (timesformer.py:738-744).
        x = x.permute(0, 2, 3, 4, 1).reshape(B, T, gh, p, gw, p, C)
        x = x.permute(0, 1, 2, 4, 3, 5, 6).reshape(B, T, N, p * p * C)
        x = self.patch_embed(x)

        pos = resize_pos_embed(self.pos_embed, (cfg.grid_h, cfg.grid_w), (gh, gw)).to(x.dtype)
        x = x + pos[None, None, 1:, :]
        cls = (self.cls_token.to(x.dtype) + pos[0])[None, :].expand(B, D)
        if not cfg.temporal_rope:
            time = nearest_resize_1d(self.time_embed, T, dim=0).to(x.dtype)
            x = x + time[None, :, None, :]
        # Under temporal_rope the rotation is the only time signal: time_embed stays a
        # parameter and gets no gradient (AdamW still decays it, as JAX's zero gradient).
        return x.transpose(1, 2).contiguous(), cls   # (B, N, T, D)

    def block_frame_times(self, frame_times):
        '''The frame times the blocks read: (B, T) f32 under temporal_rope, else None.'''
        return (frame_times.to(torch.float32) if self.cfg.temporal_rope
                and frame_times is not None else None)

    def stage_masks(self, generator: Optional[torch.Generator], train: bool, B: int, N: int,
                    T: int, device, rows: Optional[Tuple[int, int]] = None) -> list:
        '''The drop-path masks of the blocks held (None each without drop-path): every
        block's drawn for the B clips (draw_drop_path_masks; `rows` as there), the held
        ones kept; under sequence parallelism this rank's part, as seq_split splits the
        tokens: its patches' and frames' columns, or its chunk of the padded clips.'''
        cfg = self.cfg
        if not (train and cfg.drop_path_rate > 0.0 and generator is not None):
            return [None] * len(self.block_ids)
        cols = None
        if self.sp is not None and cfg.divided:
            cols = (seq_lib.local_range(N, self.sp), seq_lib.local_range(T, self.sp))
        masks = draw_drop_path_masks(generator, cfg.drop_path_rate, cfg.depth, B, N, T,
                                     device, cfg.divided, rows, cols)
        held = [masks[i] for i in self.block_ids]
        if self.sp is not None and not cfg.divided:
            held = [m.rows(*seq_lib.row_range(B, self.sp)) for m in held]
        return held

    def seq_split(self, xs, cls):
        '''This rank's part of the embedded (xs (B, N, T, D), cls (B, D)) under sequence
        parallelism: its chunk of the patches (divided), or of the zero-padded clips and
        their cls tokens (joint); both whole otherwise.'''
        if self.sp is None:
            return xs, cls
        if self.cfg.divided:
            return seq_lib.split_seq(xs, self.sp, 1), cls
        return seq_lib.split_rows(xs, self.sp), seq_lib.split_rows(cls, self.sp)

    def seq_gather(self, xs, cls, B: int, N: int):
        '''The inverse of seq_split after the blocks: the N patches of every rank joined
        (the cls token is replicated), or the B clips, tokens and cls in one gather.'''
        if self.sp is None:
            return xs, cls
        if self.cfg.divided:
            return seq_lib.gather_seq(xs, self.sp, 1, N), cls
        _, _, T, D = xs.shape
        flat = torch.cat([cls[:, None], xs.reshape(xs.shape[0], N * T, D)], dim=1)
        flat = seq_lib.gather_rows(flat, self.sp, B)
        return flat[:, 1:].reshape(B, N, T, D), flat[:, 0]

    def local_shape(self, B: int, N: int) -> Tuple[int, int]:
        '''(clips, patches) of this rank's part of B clips of N patches (seq_split).'''
        if self.sp is None:
            return B, N
        if self.cfg.divided:
            lo, hi = seq_lib.local_range(N, self.sp)
            return B, hi - lo
        lo, hi = seq_lib.row_range(B, self.sp)
        return hi - lo, N

    def run_blocks(self, xs, cls, masks, frame_times, num_patches: int):
        '''The blocks held, in order, each group of cfg.remat_group of them one checkpoint
        region under cfg.remat with gradients on (forward's docstring).'''
        cfg = self.cfg
        remat = cfg.remat and torch.is_grad_enabled()
        kw = {}
        if cfg.remat_policy != 'full':
            kw['context_fn'] = functools.partial(
                torch.utils.checkpoint.create_selective_checkpoint_contexts,
                remat_saved_ops(cfg.remat_policy))
        G = cfg.remat_group
        for start in range(0, len(self.blocks), G):
            group = functools.partial(_run_blocks, self.blocks[start:start + G], num_patches)
            group_masks = masks[start:start + G]
            if remat:
                # G consecutive blocks form one checkpoint region (:780-789). The blocks
                # draw nothing at random, so no RNG state needs restoring. The frame
                # times go in as an input, so a recompute sees them (:841).
                xs, cls = torch.utils.checkpoint.checkpoint(
                    group, xs, cls, group_masks, frame_times, use_reentrant=False,
                    preserve_rng_state=False, **kw)
            else:
                xs, cls = group(xs, cls, group_masks, frame_times)
        return xs, cls

    def finish(self, xs, cls, grid: Tuple[int, int]):
        '''The part after the blocks: the norm under norm_embeddings, then xs (B, N, T, D)
        -> features (B, D, T, H', W') on the (H', W') patch grid; and the cls token.'''
        if self.cfg.norm_embeddings:
            xs = self.norm(xs)
            cls = self.norm(cls)
        B, N, T, D = xs.shape
        feats = xs.reshape(B, grid[0], grid[1], T, D).permute(0, 4, 3, 1, 2)
        return feats, cls

    def forward(self, pixels: torch.Tensor, train: bool = False,
                generator: torch.Generator = None, frame_times: torch.Tensor = None,
                drop_path_rows: Optional[Tuple[int, int]] = None):
        '''train with a generator and drop_path_rate > 0 draws drop-path masks from the
        generator (for rows drop_path_rows of a larger batch when given,
        draw_drop_path_masks); with cfg.remat and gradients on, each group of
        cfg.remat_group blocks is recomputed in the backward pass (torch.utils.checkpoint),
        except the outputs that cfg.remat_policy keeps (`remat_saved_ops`): under 'full'
        the attention forwards run again, under the '_out' policies they do not.
        frame_times (B, T): the clip's true source timestamps, read only under
        cfg.temporal_rope (None means 0..T-1). Under sequence parallelism the blocks run on
        this rank's part of the tokens (seq_split after the embedding, seq_gather before the
        norm) with its part of the drop-path masks. A pipeline stage runs its parts through
        train/step.py instead.'''
        if self.pp is not None:
            raise ValueError('a pipeline stage runs embed / run_blocks / finish through '
                             'the pipeline schedule (train/step.py)')
        B, C, T, H, W = pixels.shape
        p = self.cfg.patch_size
        gh, gw = H // p, W // p
        N = gh * gw
        xs, cls = self.seq_split(*self.embed(pixels))
        masks = self.stage_masks(generator, train, B, N, T, xs.device, drop_path_rows)
        xs, cls = self.run_blocks(xs, cls, masks, self.block_frame_times(frame_times), N)
        return self.finish(*self.seq_gather(xs, cls, B, N), (gh, gw))
