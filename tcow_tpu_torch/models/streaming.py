'''
Streaming (online) inference for the causal seeker in PyTorch: the port of
tcow_tpu/models/streaming.py. A video goes in frame by frame; each block keeps a temporal
key/value cache, and every frame gets its masks at O(1) cost per frame.

causal_attention == 1 makes frame t's output independent of frames > t, so the batch
forward factorizes into a recurrence:
  - temporal attention: a key/value cache per block (the query is the new frame's
    tokens, the keys and values every cached frame), computed with torch ops
    (`_attend_cached`, logits and softmax in float32 as JAX takes them);
  - spatial attention over [cls_in(block), tokens(frame)]: the model's Attention module,
    so on CUDA every block of every frame launches K1 (fused_attention) at (B, N + 1, D),
    not causal. The block's cls output depends on frame 0's spatial attention alone, so
    the chain of cls inputs is computed at frame 0 and frozen;
  - the decode head per frame, in float32.

Windowed mode (`window=`) bounds the cache: the first `pinned_frames` slots stay resident
(the query frame and the frozen cls chain), the other `window - pinned_frames` slots are a
ring of the most recent frames. Without rope the time embedding clamps to the last trained
index past the training horizon; under temporal_rope q and the cached keys are rotated by
the absolute frame index instead and no time embedding is added.

The functions run on the port's MaskTracker modules (no second copy of the weights) under
torch.inference_mode, and write each block's cache slot in place: `state` is updated and
returned. A single stream (`init_stream`) knows its frame index t on the host, so no step
reads the device for it; a multi-session state (`init_stream_multi`, for continuous
batching in serving.py) keeps a per-example t (B,) on the device.
'''

import dataclasses
from typing import List, Optional, Tuple, Union

import torch

from tcow_tpu_torch.models import timesformer as tsf
from tcow_tpu_torch.models.mask_tracker import MaskTracker, coarsen_mask
from tcow_tpu_torch.ops import rope as rope_lib


@dataclasses.dataclass
class StreamState:
    '''Per-block caches, written in place slot by slot: k_cache[l], v_cache[l] are
    (B, N, nh, Tmax, dh) in the compute dtype (head-major, so both contractions of
    `_attend_cached` batch over (b, n, h) without a relayout); cls_in (L, B, D) is each
    block's input cls token, frozen after frame 0; t is the next frame's index, an int
    for a single stream and a (B,) int64 tensor on the device for a multi-session state.'''
    k_cache: List[torch.Tensor]
    v_cache: List[torch.Tensor]
    cls_in: torch.Tensor
    t: Union[int, torch.Tensor]


def _param_device(model: MaskTracker) -> torch.device:
    return model.backbone.cls_token.device


@torch.inference_mode()
def init_stream(model: MaskTracker, batch_size: int, max_frames: Optional[int] = None,
                window: Optional[int] = None, pinned_frames: int = 1) -> StreamState:
    '''With window=None the cache holds `max_frames or cfg.num_total_frames` slots and frame
    t writes slot t (exact unbounded attention up to the cache size). With window=S it
    holds S slots: `pinned_frames` permanent ones and a ring of S - pinned_frames, for
    videos of any length (streaming.py:52-73 of the JAX package).'''
    bb = model.cfg.backbone_config()
    if bb.causal_attention != 1:
        raise ValueError(f'streaming requires causal_attention == 1, got '
                         f'{bb.causal_attention}')
    if window is not None:
        if not window > pinned_frames >= 1:
            raise ValueError(f'need window > pinned_frames >= 1, got window={window} '
                             f'pinned_frames={pinned_frames}')
        tmax = window
    else:
        tmax = max_frames or bb.num_frames
    L, B, N, D, nh = bb.depth, batch_size, bb.num_patches, bb.embed_dim, bb.num_heads
    dev, dt = _param_device(model), bb.compute_dtype
    cache = lambda: [torch.zeros((B, N, nh, tmax, D // nh), dtype=dt, device=dev)
                     for _ in range(L)]
    return StreamState(k_cache=cache(), v_cache=cache(),
                       cls_in=torch.zeros((L, B, D), dtype=dt, device=dev), t=0)


@torch.inference_mode()
def init_stream_multi(model: MaskTracker, batch_size: int, max_frames: Optional[int] = None,
                      window: Optional[int] = None, pinned_frames: int = 1) -> StreamState:
    '''Like init_stream, with a per-example t (batch_size,): each example is an independent
    session at its own stream position (for stream_step_multi).'''
    state = init_stream(model, batch_size, max_frames, window, pinned_frames)
    state.t = torch.zeros((batch_size,), dtype=torch.int64, device=state.cls_in.device)
    return state


@torch.inference_mode()
def reset_stream_slot(state: StreamState, i: int) -> StreamState:
    '''Recycles batch slot i of a multi-session state for a fresh session: t[i] = 0 masks
    every slot the previous occupant wrote, so its cache is never read.'''
    state.t[i] = 0
    return state


def _attend_cached(q, k_all, v_all, num_heads: int, valid):
    '''q (B, N, D) over head-major cached keys and values (B, N, nh, S, dh); valid (S,) or
    per-example (B, S) bool marks the populated slots (their order does not matter: the
    softmax is invariant under a permutation of the slots). As JAX takes it
    (streaming.py:83-105): logits from float32 operands times dh^-0.5, -1e10 where not
    valid, the softmax in float32, the probabilities rounded to the compute dtype and
    contracted with v.'''
    B, N, D = q.shape
    dh = D // num_heads
    qh = q.reshape(B, N, num_heads, dh)
    logits = torch.matmul(k_all.float(), qh.float()[..., None])[..., 0] * dh ** -0.5
    vmask = valid[None, None, None, :] if valid.dim() == 1 else valid[:, None, None, :]
    logits = logits.masked_fill(~vmask, -1e10)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)               # (B, N, nh, S)
    out = torch.matmul(probs[..., None, :], v_all)[..., 0, :]        # (B, N, nh, dh)
    return out.reshape(B, N, D)


def _embed_frame(model: MaskTracker, frame_rgb, query_mask, gh: int, gw: int):
    '''Patch-embeds one frame and adds the spatial pos embed -> (tokens (B, N, D), pos
    (N + 1, D)), as the batch forward embeds each frame (streaming.py:108-124).'''
    bb, backbone = model.cfg.backbone_config(), model.backbone
    B = frame_rgb.shape[0]
    p = bb.patch_size
    x = torch.cat([frame_rgb.float(), query_mask.float()], dim=1).to(bb.compute_dtype)
    if bb.normalize_inputs:
        mean = torch.tensor(tsf.TIMESFORMER_MEAN, dtype=x.dtype, device=x.device)
        std = torch.tensor(tsf.TIMESFORMER_STD, dtype=x.dtype, device=x.device)
        x = torch.cat([(x[:, 0:3] - mean.reshape(1, 3, 1, 1)) / std.reshape(1, 3, 1, 1),
                       x[:, 3:]], dim=1)
    x = x.permute(0, 2, 3, 1).reshape(B, gh, p, gw, p, bb.in_channels)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, gh * gw, p * p * bb.in_channels)
    x = backbone.patch_embed(x)
    pos = tsf.resize_pos_embed(backbone.pos_embed, (bb.grid_h, bb.grid_w),
                               (gh, gw)).to(x.dtype)
    return x + pos[None, 1:], pos


def _decode_frame(model: MaskTracker, xs, gh: int, gw: int
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    '''The decode head on one frame's tokens, in float32 (streaming.py:127-144) -> (mask
    logits (B, C, H, W), flags (B, F) or None).'''
    cfg = model.cfg
    B, _, D = xs.shape
    p, C = cfg.patch_size, cfg.output_channels
    feats = xs.reshape(B, gh, gw, D).float()
    patches = model.post_linear(feats).reshape(B, gh, gw, C, p, p)
    mask = patches.permute(0, 3, 1, 4, 2, 5).reshape(B, C, gh * p, gw * p)
    mask = coarsen_mask(mask, cfg.track_map_stride, cfg.track_map_resize)
    flags = None
    if model.flag_linear is not None:
        flags = model.flag_linear(feats).mean(dim=(1, 2))
    return mask.float(), flags


def _block(blk, bb, xs, cls_in, q_rot, write_slot, attend):
    '''One divided space-time block on one frame (streaming.py:226-250): the temporal
    attention through the cache, the spatial attention over [cls_in, tokens] through the
    block's Attention module (K1 on CUDA), the MLP on the tokens and on the cls.
    q_rot(q, k) rotates q (B, N, nh, dh) and k under rope; write_slot(k, v) stores one
    frame's k and v (B, N, nh, dh) in the cache; attend(q) reads it. Returns (tokens,
    cls_out).'''
    nh = bb.num_heads
    y = blk.temporal_norm1(xs)
    qkv = blk.temporal_attn.qkv(y)
    B, N, D3 = qkv.shape
    D = D3 // 3
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(B, N, nh, D // nh) for i in range(3))
    q, k = q_rot(q, k)
    write_slot(k, v)
    res_t = attend(q.reshape(B, N, D))
    xt = xs + blk.temporal_fc(blk.temporal_attn.proj(res_t))

    seq = torch.cat([cls_in[:, None, :], xt], dim=1)
    res_sp = blk.attn(blk.norm1(seq), 0)
    tokens = xt + res_sp[:, 1:, :]
    cls_mid = cls_in + res_sp[:, 0, :]
    cls_out = cls_mid + blk.mlp(blk.norm2(cls_mid))
    tokens = tokens + blk.mlp(blk.norm2(tokens))
    return tokens, cls_out


def _frame_geometry(model: MaskTracker, frame_rgb):
    bb = model.cfg.backbone_config()
    H, W = frame_rgb.shape[-2:]
    return bb, H // bb.patch_size, W // bb.patch_size


def _ring(t, pinned_frames: int, window: int):
    '''(slot, number of ring slots written) of frame t in windowed mode: the pinned
    prefix, then a ring of window - pinned_frames slots (streaming.py:183-187). t is an
    int or a tensor of ints.'''
    P, R = pinned_frames, window - pinned_frames
    if isinstance(t, int):
        return (t if t < P else P + (t - P) % R), min(max(t + 1 - P, 0), R)
    return (torch.where(t < P, t, P + torch.remainder(t - P, R)),
            torch.clamp(t + 1 - P, 0, R))


@torch.inference_mode()
def stream_step(model: MaskTracker, state: StreamState, frame_rgb: torch.Tensor,
                query_mask: torch.Tensor, window: Optional[int] = None,
                pinned_frames: int = 1
                ) -> Tuple[StreamState, torch.Tensor, Optional[torch.Tensor]]:
    '''Processes ONE frame of a single stream (streaming.py:147-265).

    :param frame_rgb (B, 3, H, W) float in [0, 1] on the model's device.
    :param query_mask (B, 1, H, W): the query at its frame, zeros elsewhere.
    :param window, pinned_frames: as passed to init_stream; None = unbounded.
    :return (state, updated in place; mask logits (B, C, H, W) f32; flags (B, F) or None).
    '''
    bb, gh, gw = _frame_geometry(model, frame_rgb)
    backbone = model.backbone
    tmax = state.k_cache[0].shape[-2]
    t = state.t
    dev = frame_rgb.device
    x, pos = _embed_frame(model, frame_rgb, query_mask, gh, gw)
    if window is None:
        # Unbounded: slot == frame index; the time embedding nearest-resized to the cache
        # size (the identity when Tmax == num_frames, as in the batch forward).
        if t >= tmax:
            raise ValueError(f'unbounded stream is full at {tmax} frames')
        time = tsf.nearest_resize_1d(backbone.time_embed, tmax, dim=0)
        time_idx, slot = t, t
        valid = torch.arange(tmax, device=dev) <= t
    else:
        if tmax != window:
            raise ValueError(f'the state holds {tmax} slots, window is {window}')
        time = backbone.time_embed
        time_idx = min(t, time.shape[0] - 1)
        slot, n_ring = _ring(t, pinned_frames, window)
        valid = torch.cat([torch.arange(pinned_frames, device=dev) <= t,
                           torch.arange(window - pinned_frames, device=dev) < n_ring])
    if not bb.temporal_rope:
        # Under rope the rotation is the time signal, as in the batch forward.
        x = x + time[time_idx].to(x.dtype)[None, None, :]

    B = x.shape[0]
    cls_carry = (backbone.cls_token.to(x.dtype) + pos[0])[None, :].expand(B, -1)
    dh = bb.embed_dim // bb.num_heads
    if bb.temporal_rope:
        # Rotated by the ABSOLUTE frame index: the cache holds rotated keys, so the logits
        # depend on relative offsets only and no index clamps.
        cos_t, sin_t = rope_lib.rope_tables(torch.full((), float(t), device=dev), dh)
        q_rot = lambda q, k: (rope_lib.apply_rope(q, cos_t, sin_t),
                              rope_lib.apply_rope(k, cos_t, sin_t))
    else:
        q_rot = lambda q, k: (q, k)

    xs = x
    for l, blk in enumerate(backbone.blocks):
        # The block's input cls: at frame 0 the previous block's output (seeded with
        # cls0), afterwards the frozen cached value.
        if t == 0:
            state.cls_in[l].copy_(cls_carry)
        cls_in = state.cls_in[l]
        kc, vc = state.k_cache[l], state.v_cache[l]

        def write_slot(k, v, kc=kc, vc=vc):
            kc[:, :, :, slot] = k
            vc[:, :, :, slot] = v

        xs, cls_carry = _block(blk, bb, xs, cls_in, q_rot, write_slot,
                               lambda q, kc=kc, vc=vc: _attend_cached(q, kc, vc,
                                                                      bb.num_heads, valid))
    if bb.norm_embeddings:
        xs = backbone.norm(xs)
    mask, flags = _decode_frame(model, xs, gh, gw)
    state.t = t + 1
    return state, mask, flags


def _write_slot_multi(cache, new, slot, active):
    '''Per-example slot write, in place: cache (B, N, nh, S, dh), new (B, N, nh, dh),
    slot (B,) int64, active (B,) bool. Inactive examples write back the old value at their
    slot (a one-slot read, not a full-cache select; streaming.py:284-293).'''
    rows = torch.arange(cache.shape[0], device=cache.device)
    old = cache[rows, :, :, slot]
    cache[rows, :, :, slot] = torch.where(active[:, None, None, None], new, old)


@torch.inference_mode()
def stream_step_multi(model: MaskTracker, state: StreamState, frame_rgb: torch.Tensor,
                      query_mask: torch.Tensor, active: torch.Tensor,
                      window: Optional[int] = None, pinned_frames: int = 1
                      ) -> Tuple[StreamState, torch.Tensor, Optional[torch.Tensor]]:
    '''One frame for EVERY active example of a multi-session state (streaming.py:296-392):
    the math of stream_step per example, with state.t (B,) on the device and `active`
    (B,) bool on the device selecting the examples that consume their frame. Inactive
    examples keep their caches, cls and t; their outputs are garbage (callers drop them).
    No step reads the device on the host.'''
    bb, gh, gw = _frame_geometry(model, frame_rgb)
    backbone = model.backbone
    tmax = state.k_cache[0].shape[-2]
    t = state.t
    if not isinstance(t, torch.Tensor) or t.dim() != 1:
        raise ValueError('stream_step_multi needs a per-example t (init_stream_multi)')
    dev = frame_rgb.device
    x, pos = _embed_frame(model, frame_rgb, query_mask, gh, gw)
    if window is None:
        time = tsf.nearest_resize_1d(backbone.time_embed, tmax, dim=0)
        # The server bounds each session's frames; clamped all the same, as JAX does.
        time_idx = slot = torch.clamp(t, max=tmax - 1)
        valid = torch.arange(tmax, device=dev)[None, :] <= t[:, None]
    else:
        if tmax != window:
            raise ValueError(f'the state holds {tmax} slots, window is {window}')
        time = backbone.time_embed
        time_idx = torch.clamp(t, max=time.shape[0] - 1)
        slot, n_ring = _ring(t, pinned_frames, window)
        valid = torch.cat([
            torch.arange(pinned_frames, device=dev)[None, :] <= t[:, None],
            torch.arange(window - pinned_frames, device=dev)[None, :] < n_ring[:, None]],
            dim=1)
    if not bb.temporal_rope:
        x = x + time[time_idx].to(x.dtype)[:, None, :]

    B = x.shape[0]
    cls_carry = (backbone.cls_token.to(x.dtype) + pos[0])[None, :].expand(B, -1)
    is_first = (t == 0)[:, None]
    dh = bb.embed_dim // bb.num_heads
    if bb.temporal_rope:
        # Each session rotated by its own absolute frame index.
        cos_t, sin_t = rope_lib.rope_tables(t.float(), dh)            # (B, dh/2)
        cos_b, sin_b = cos_t[:, None, None, :], sin_t[:, None, None, :]
        q_rot = lambda q, k: (rope_lib.apply_rope(q, cos_b, sin_b),
                              rope_lib.apply_rope(k, cos_b, sin_b))
    else:
        q_rot = lambda q, k: (q, k)

    xs = x
    for l, blk in enumerate(backbone.blocks):
        cls_in = torch.where(is_first, cls_carry, state.cls_in[l])
        # Inactive examples keep their stored cls (an inactive fresh slot's carry is
        # garbage and must not overwrite it).
        state.cls_in[l] = torch.where(active[:, None], cls_in, state.cls_in[l])
        kc, vc = state.k_cache[l], state.v_cache[l]

        def write_slot(k, v, kc=kc, vc=vc):
            _write_slot_multi(kc, k, slot, active)
            _write_slot_multi(vc, v, slot, active)

        xs, cls_carry = _block(blk, bb, xs, cls_in, q_rot, write_slot,
                               lambda q, kc=kc, vc=vc: _attend_cached(q, kc, vc,
                                                                      bb.num_heads, valid))
    if bb.norm_embeddings:
        xs = backbone.norm(xs)
    mask, flags = _decode_frame(model, xs, gh, gw)
    state.t = torch.where(active, t + 1, t)
    return state, mask, flags
