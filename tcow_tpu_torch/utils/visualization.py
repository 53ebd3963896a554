'''
Overlay renderers (numpy): the port's copy of tcow_tpu/utils/visualization.py. Colour
conventions: snitch = green, frontmost occluder = red, outermost container = blue, query
border = white (or green / magenta in the single-channel views); a magma heat map for the
snitch output, viridis for loss-weight maps. The two maps are tables kept in the port
(utils/colormaps.py) and looked up as matplotlib's Colormap.__call__ looks them up, so the
renders are bit-equal to the JAX package's without matplotlib.
'''

import numpy as np

from tcow_tpu_torch.utils.colormaps import MAGMA, VIRIDIS


def _lookup_table(colors) -> np.ndarray:
    '''A listed colour map's float64 RGBA table with its three extra rows: under (the first
    colour), over (the last) and bad (transparent black).'''
    n = len(colors)
    lut = np.zeros((n + 3, 4), np.float64)
    lut[:n, :3] = colors
    lut[:n, 3] = 1.0
    lut[n] = lut[0]
    lut[n + 1] = lut[n - 1]
    return lut


_MAGMA_LUT = _lookup_table(MAGMA)
_VIRIDIS_LUT = _lookup_table(VIRIDIS)


def apply_colormap(lut: np.ndarray, x: np.ndarray) -> np.ndarray:
    '''(...) float values in [0, 1] -> (..., 4) float64 RGBA, as Colormap.__call__ maps
    float input: scaled by N in the input's own dtype, x == N mapped to N - 1, then
    truncated to an index; below 0 takes the under colour, N and above the over colour,
    NaN the bad colour.'''
    n = lut.shape[0] - 3
    xa = np.array(x, copy=True)
    xa *= n
    xa[xa == n] = n - 1
    under, over, bad = xa < 0, xa >= n, np.isnan(xa)
    with np.errstate(invalid='ignore'):
        idx = xa.astype(int)
    idx[under] = n
    idx[over] = n + 1
    idx[bad] = n + 2
    return lut.take(idx, axis=0, mode='clip')


def magma(x: np.ndarray) -> np.ndarray:
    return apply_colormap(_MAGMA_LUT, x)


def viridis(x: np.ndarray) -> np.ndarray:
    return apply_colormap(_VIRIDIS_LUT, x)


def draw_segm_borders(segm: np.ndarray, fill_white: bool = False) -> np.ndarray:
    '''(T, H, W, K) masks -> (T, H, W) boolean borders.'''
    assert segm.ndim == 4
    s = segm.astype(np.int16)
    border = (np.abs(s[:, 1:-1, 1:-1] - s[:, :-2, 1:-1]) +
              np.abs(s[:, 1:-1, 1:-1] - s[:, 2:, 1:-1]) +
              np.abs(s[:, 1:-1, 1:-1] - s[:, 1:-1, :-2]) +
              np.abs(s[:, 1:-1, 1:-1] - s[:, 1:-1, 2:]))
    border = np.any(border, axis=-1)
    border = np.pad(border, ((0, 0), (1, 1), (1, 1)), mode='constant')
    if fill_white:
        return np.repeat(border[..., None], 3, axis=-1).astype(np.float32)
    return border


def _to_gray(rgb):
    g = rgb[..., 0] * 0.2 + rgb[..., 1] * 0.6 + rgb[..., 2] * 0.2
    return np.stack([g, g, g], axis=-1)


def _paint_borders(vis, query_border, snitch_border, frontmost_border, outermost_border):
    for border in (query_border, snitch_border, frontmost_border, outermost_border):
        vis[border] = 0.0
    vis[query_border] = 1.0
    vis[snitch_border, 1] = 1.0
    vis[frontmost_border, 0] = 1.0
    vis[outermost_border, 2] = 1.0


def create_model_input_video(seeker_rgb, seeker_query_mask, query_border,
                             apply_pause: bool = True) -> np.ndarray:
    '''(T, H, W, 3) rgb + (T, H, W) query mask + (T, H, W) query border -> the input
    overlay video, the query frame dimmed and held for three frames.'''
    query_time = int(seeker_query_mask.any(axis=(1, 2)).argmax())
    vis = seeker_rgb + seeker_query_mask[..., None]
    vis[query_time] *= 0.6
    vis[query_border, 0] = 0.0
    vis[query_border, 1] = 1.0
    vis[query_border, 2] = 0.0
    if apply_pause:
        vis = np.concatenate([vis[0:query_time]] +
                             [vis[query_time:query_time + 1]] * 3 +
                             [vis[query_time + 1:]], axis=0)
    return np.clip(vis, 0.0, 1.0)


def create_model_output_snitch_video(seeker_rgb, output_mask, query_border, snitch_border,
                                     grayscale: bool = False) -> np.ndarray:
    '''The snitch channel as a magma heat map over the input.'''
    rgb = _to_gray(seeker_rgb) if grayscale else seeker_rgb
    heat = magma(output_mask[0])[..., 0:3]
    vis = rgb * 0.6 + heat * 0.5
    vis[query_border] = 0.0
    vis[snitch_border] = 0.0
    vis[query_border, 0] = 1.0
    vis[query_border, 2] = 1.0
    vis[snitch_border, 1] = 1.0
    return np.clip(vis, 0.0, 1.0)


def create_model_output_snitch_occl_cont_video(
        seeker_rgb, output_mask, query_border, snitch_border, frontmost_border,
        outermost_border, grayscale: bool = False) -> np.ndarray:
    '''The three output channels (snitch green, occluder red, container blue).'''
    rgb = _to_gray(seeker_rgb) if grayscale else seeker_rgb
    vis = rgb * 0.6
    vis = vis.copy()
    vis[..., 1] += output_mask[0] * 0.5
    if output_mask.shape[0] >= 2:
        vis[..., 0] += output_mask[1] * 0.5
    if output_mask.shape[0] >= 3:
        vis[..., 2] += output_mask[2] * 0.5
    _paint_borders(vis, query_border, snitch_border, frontmost_border, outermost_border)
    return np.clip(vis, 0.0, 1.0)


def create_snitch_weights_video(seeker_rgb, snitch_weights) -> np.ndarray:
    '''The per-pixel loss weights as a viridis heat map over the input.'''
    norm = snitch_weights.max() + 1e-6
    heat = viridis(snitch_weights / norm)[..., 0:3]
    return np.clip(seeker_rgb * 0.6 + heat * 0.5, 0.0, 1.0)


def create_model_input_target_video(
        seeker_rgb, seeker_query_mask, target_mask, query_border, snitch_border,
        frontmost_border, outermost_border, grayscale: bool = False) -> np.ndarray:
    '''The ground truth over the input.'''
    rgb = _to_gray(seeker_rgb) if grayscale else seeker_rgb
    vis = rgb.copy()
    vis += seeker_query_mask[..., None] * 0.3
    tm = np.clip(target_mask, 0.0, 1.0)
    vis[1:, ..., 1] += tm[0, 1:] * 0.2
    if tm.shape[0] >= 2:
        vis[..., 0] += tm[1] * 0.2
    if tm.shape[0] >= 3:
        vis[..., 2] += tm[2] * 0.2
    _paint_borders(vis, query_border, snitch_border, frontmost_border, outermost_border)
    return np.clip(vis, 0.0, 1.0)
