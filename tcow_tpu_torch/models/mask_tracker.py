'''
Query-conditioned mask tracker (the "seeker") in PyTorch: the port of
tcow_tpu/models/mask_tracker.py.

forward(input_frames (B,3,T,H,W), query_mask (B,1,T,H,W), train=False, generator=None,
        frame_times=None) -> (mask_logits (B,3,T,H,W) f32, flags (B,T,F) f32 or None).
'''

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from tcow_tpu_torch.models import timesformer as tsf


@dataclasses.dataclass(frozen=True)
class SeekerConfig:
    num_total_frames: int = 30
    frame_height: int = 240
    frame_width: int = 320
    patch_size: int = 16
    attention_type: str = 'divided_space_time'
    causal_attention: int = 1
    norm_embeddings: bool = False
    drop_path_rate: float = 0.1
    network_depth: int = 12
    track_map_stride: int = 4
    track_map_resize: str = 'bilinear'  # or 'nearest'
    query_channels: int = 1
    output_channels: int = 3
    flag_channels: int = 3
    pretrained: bool = False  # controls input RGB normalization
    compute_dtype: torch.dtype = torch.float32
    remat: bool = False  # per-block rematerialization in the backbone
    remat_policy: str = 'full'  # what a remat block keeps (timesformer.REMAT_POLICIES)
    remat_group: int = 1  # blocks per checkpoint region (see TimeSformerConfig)
    attention_bwd: str = 'res'  # 'res' | 'kernel_qkv' | 'kernel_x' | 'kernel_x_wg'
    temporal_rope: bool = False  # rotary (relative) time encoding on temporal attention
    rope_time_coords: bool = False  # feed true source-frame times into the rope tables

    def __post_init__(self):
        '''Raises ValueError as the JAX config does (mask_tracker.py:74-79), and for
        unknown names (timesformer.check_config).'''
        if self.temporal_rope and self.attention_type != 'divided_space_time':
            raise ValueError('temporal_rope requires attention_type=divided_space_time '
                             '(joint attention has no separate temporal axis to rotate)')
        if self.rope_time_coords and not self.temporal_rope:
            raise ValueError('rope_time_coords requires temporal_rope=1 (only the rotary '
                             'encoding consumes per-frame time coordinates)')
        tsf.check_config(self.attention_type, self.remat_policy, self.attention_bwd)
        tsf.check_remat_group(self.network_depth, self.remat_group)

    @property
    def input_channels(self) -> int:
        return 3 + self.query_channels

    def backbone_config(self) -> tsf.TimeSformerConfig:
        embed_dim, num_heads = tsf.DEPTH_PRESETS[self.network_depth]
        return tsf.TimeSformerConfig(
            frame_height=self.frame_height, frame_width=self.frame_width,
            patch_size=self.patch_size, in_channels=self.input_channels,
            num_frames=self.num_total_frames, depth=self.network_depth,
            embed_dim=embed_dim, num_heads=num_heads,
            attention_type=self.attention_type, causal_attention=self.causal_attention,
            norm_embeddings=self.norm_embeddings, drop_path_rate=self.drop_path_rate,
            normalize_inputs=self.pretrained, compute_dtype=self.compute_dtype,
            remat=self.remat, remat_policy=self.remat_policy, remat_group=self.remat_group,
            attention_bwd=self.attention_bwd, temporal_rope=self.temporal_rope)


def seeker_config_from_args(seeker_args: Dict[str, Any], **overrides) -> SeekerConfig:
    '''SeekerConfig from the seeker_args dict that checkpoints embed
    (tcow_tpu mask_tracker.py:99-127); `overrides` set any field, as the JAX package's
    trainer sets remat, remat_policy, remat_group and attention_bwd.'''
    tracker_pretrained = seeker_args.get('tracker_pretrained', False)
    if isinstance(tracker_pretrained, str):
        pretrained = tracker_pretrained.lower() in ('1', 'y', 'yes', 't', 'true') \
            or len(tracker_pretrained) > 5
    else:
        pretrained = bool(tracker_pretrained)
    kw = dict(
        num_total_frames=seeker_args.get('num_total_frames', 30),
        frame_height=seeker_args.get('frame_height', 240),
        frame_width=seeker_args.get('frame_width', 320),
        patch_size=seeker_args.get('patch_size', 16),
        attention_type=seeker_args.get('attention_type', 'divided_space_time'),
        causal_attention=int(seeker_args.get('causal_attention', 0)),
        norm_embeddings=bool(seeker_args.get('norm_embeddings', False)),
        drop_path_rate=float(seeker_args.get('drop_path_rate', 0.1)),
        network_depth=int(seeker_args.get('network_depth', 12)),
        track_map_stride=int(seeker_args.get('track_map_stride', 4)),
        track_map_resize=seeker_args.get('track_map_resize', 'bilinear'),
        query_channels=int(seeker_args.get('query_channels', 1)),
        output_channels=int(seeker_args.get('output_channels', 3)),
        flag_channels=int(seeker_args.get('flag_channels', 3)),
        temporal_rope=bool(int(seeker_args.get('temporal_rope', 0))),
        rope_time_coords=bool(int(seeker_args.get('rope_time_coords', 0))),
        pretrained=pretrained)
    kw.update(overrides)
    return SeekerConfig(**kw)


def _bilinear_align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    '''Interpolation matrix M (n_out, n_in) such that y = M @ x reproduces
    torch F.interpolate(mode=bilinear, align_corners=True) along one axis.'''
    M = np.zeros((n_out, n_in), dtype=np.float32)
    if n_out == 1 or n_in == 1:
        M[:, 0] = 1.0
        return M
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    i0 = np.clip(np.floor(src).astype(np.int64), 0, n_in - 2)
    frac = (src - i0).astype(np.float32)
    M[np.arange(n_out), i0] = 1.0 - frac
    M[np.arange(n_out), i0 + 1] = frac
    return M


def coarsen_mask(mask: torch.Tensor, stride: int, mode: str) -> torch.Tensor:
    '''Avg-pool by `stride`, then upsample back (mask_tracker.py:164-182); mask (..., H, W).'''
    if stride <= 1:
        return mask
    *lead, H, W = mask.shape
    x = mask.reshape(*lead, H // stride, stride, W // stride, stride).mean(dim=(-3, -1))
    if mode == 'nearest':
        return x.repeat_interleave(stride, dim=-2).repeat_interleave(stride, dim=-1)
    if mode == 'bilinear':
        Mh = torch.as_tensor(_bilinear_align_corners_matrix(H // stride, H),
                             dtype=mask.dtype, device=mask.device)
        Mw = torch.as_tensor(_bilinear_align_corners_matrix(W // stride, W),
                             dtype=mask.dtype, device=mask.device)
        return torch.matmul(torch.matmul(Mh, x), Mw.T)
    raise ValueError(f'unknown track_map_resize: {mode}')


class MaskTracker(nn.Module):
    '''The seeker. With a DataMesh whose model axis has more than one rank (`mesh`), the
    backbone's blocks hold this rank's shards of the block weights and run tensor-parallel;
    with one whose seq axis has, they split the tokens over the seq ranks (timesformer.py);
    the heads stay replicated. `self.mesh` is that mesh, or None.'''

    def __init__(self, cfg: SeekerConfig, device=None, mesh=None):
        super().__init__()
        self.cfg = cfg
        D = tsf.DEPTH_PRESETS[cfg.network_depth][0]
        self.backbone = tsf.TimeSformer(cfg.backbone_config(), device, mesh)
        self.mesh = self.backbone.mesh
        self.post_linear = tsf.Dense(D, cfg.output_channels * cfg.patch_size ** 2, device)
        self.flag_linear = (tsf.Dense(D, cfg.flag_channels, device)
                            if cfg.flag_channels > 0 else None)

    def init_params_(self, generator: torch.Generator):
        '''Random init of tcow_tpu mask_tracker.init_params (:130-146).'''
        self.backbone.init_params_(generator)
        for head in (self.post_linear, self.flag_linear):
            if head is not None:
                tsf.trunc_normal_(head.w, generator)
                with torch.no_grad():
                    head.b.zero_()

    def forward(self, input_frames: torch.Tensor, query_mask: torch.Tensor,
                train: bool = False, generator: Optional[torch.Generator] = None,
                frame_times: Optional[torch.Tensor] = None,
                drop_path_rows: Optional[Tuple[int, int]] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        '''train=True with a generator applies stochastic depth drawn from it; with
        drop_path_rows = (start, total) the B clips are rows [start, start + B) of a batch
        of `total`, whose masks are drawn (timesformer.draw_drop_path_masks).
        frame_times (B, T): true source timestamps for time-calibrated rope, read only
        under cfg.temporal_rope (mask_tracker.py:185-201).'''
        cfg = self.cfg
        B, _, T, _, _ = input_frames.shape
        x = torch.cat([input_frames.float(), query_mask.float()], dim=1)
        feats, _ = self.backbone(x, train=train, generator=generator, frame_times=frame_times,
                                 drop_path_rows=drop_path_rows)
        feats = feats.permute(0, 2, 3, 4, 1)                  # (B, T, H', W', D)
        Ho, Wo = feats.shape[2], feats.shape[3]
        p, C = cfg.patch_size, cfg.output_channels

        patches = self.post_linear(feats)                     # (B, T, H', W', C*p*p)
        # Fold '(C h w)' patch vectors back to pixels.
        patches = patches.reshape(B, T, Ho, Wo, C, p, p)
        mask = patches.permute(0, 4, 1, 2, 5, 3, 6).reshape(B, C, T, Ho * p, Wo * p)
        mask = coarsen_mask(mask, cfg.track_map_stride, cfg.track_map_resize).float()

        flags = None
        if self.flag_linear is not None:
            flags = self.flag_linear(feats).mean(dim=(2, 3)).float()   # (B, T, F)
        return mask, flags
