'''
Segmentation codecs: Kubric hue-palette PNGs <-> integer instance IDs. The port's copy of
tcow_tpu/data/vis_codec.py (:16-69) in numpy alone: the hue is matplotlib.colors'
rgb_to_hsv formula and the palette its hsv_to_rgb, written out here.

Kubric writes visible-instance segmentation as an HSV hue palette (background black,
instances at evenly spaced hues starting at HUE_START); the decoder recovers IDs by
outlier-tolerant hue-step estimation, so frame-subsampled scenes (where some IDs vanish)
still decode.
'''

import numpy as np

HUE_START = 0.01


def _rgb_to_hue(rgb: np.ndarray) -> np.ndarray:
    '''(*, 3) float RGB in [0, 1] -> hue in [0, 1), as matplotlib.colors.rgb_to_hsv
    computes it: from the channel that holds the maximum (red, then green, then blue
    winning ties in that order of assignment), 0 where the channels are equal.'''
    arr = np.asarray(rgb)
    arr = arr.astype(np.promote_types(arr.dtype, np.float32), copy=False)
    arr_max = arr.max(-1)
    delta = np.ptp(arr, -1)
    hue = np.zeros_like(delta)
    ipos = delta > 0
    r, g, b = arr[..., 0], arr[..., 1], arr[..., 2]
    idx = (r == arr_max) & ipos
    hue[idx] = (g[idx] - b[idx]) / delta[idx]
    idx = (g == arr_max) & ipos
    hue[idx] = 2. + (b[idx] - r[idx]) / delta[idx]
    idx = (b == arr_max) & ipos
    hue[idx] = 4. + (r[idx] - g[idx]) / delta[idx]
    return (hue / 6.0) % 1.0


def _hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    '''(*, 3) HSV in [0, 1] -> RGB, matplotlib.colors.hsv_to_rgb's formula and dtypes.'''
    hsv = np.asarray(hsv)
    hsv = hsv.astype(np.promote_types(hsv.dtype, np.float32), copy=False)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    for sector, (rs, gs, bs) in enumerate(((v, t, p), (q, v, p), (p, v, t),
                                           (p, q, v), (t, p, v), (v, p, q))):
        idx = (i % 6 == 0) if sector == 0 else (i == sector)
        r[idx], g[idx], b[idx] = rs[idx], gs[idx], bs[idx]
    idx = s == 0
    r[idx], g[idx], b[idx] = v[idx], v[idx], v[idx]
    return np.stack([r, g, b], axis=-1)


def segm_rgb_to_ids_kubric(segm_rgb: np.ndarray) -> np.ndarray:
    '''
    :param segm_rgb (*, 3) float RGB in [0, 1].
    :return segm_ids (*, 1) int32, 1-based instance IDs (0 = background).
    '''
    to_rank = _rgb_to_hue(segm_rgb)
    unique_hues = np.sort(np.unique(to_rank))
    if not np.isclose(unique_hues[0], 0.0, rtol=1e-3, atol=1e-3):
        raise ValueError(f'no background hue in the segmentation: {unique_hues}')

    # Smallest hue gap between instances estimates the palette step; tolerate integer
    # multiples from missing IDs.
    hue_steps = unique_hues[2:] - unique_hues[1:-1]
    if not np.all(hue_steps >= 1e-2):
        raise ValueError(f'segmentation hues closer than the palette allows: {hue_steps}')
    adjacent = hue_steps[hue_steps <= np.min(hue_steps) * 1.5] if len(hue_steps) else \
        np.array([max(unique_hues[1], HUE_START)])
    hue_step = float(np.mean(adjacent)) if len(adjacent) else float(unique_hues[1])

    # Threshold at HUE_START / 2, not HUE_START: uint8 PNG quantization can land the first
    # instance's hue at 0.0098 < 0.01, which would otherwise decode as background.
    nice_rank = to_rank.copy()
    nice_rank[nice_rank >= HUE_START / 2] += hue_step - HUE_START
    return np.round(nice_rank / hue_step)[..., None].astype(np.int32)


def segm_ids_to_rgb_kubric(segm_ids: np.ndarray, num_inst: int) -> np.ndarray:
    '''Encoder consistent with segm_rgb_to_ids_kubric: background black, instance k at hue
    HUE_START + (k-1) * step with full saturation and value. Used by the synthetic dataset
    writer.
    :param segm_ids (*,) int, 0 = background.
    :return (*, 3) float32 RGB in [0, 1].'''
    num_inst = max(int(num_inst), 1)
    step = (1.0 - HUE_START) / (num_inst + 1)
    hues = np.concatenate([[0.0], HUE_START + np.arange(num_inst) * step])
    hsv = np.zeros(segm_ids.shape + (3,), np.float32)
    hsv[..., 0] = hues[segm_ids]
    hsv[..., 1] = np.where(segm_ids > 0, 1.0, 0.0)
    hsv[..., 2] = np.where(segm_ids > 0, 1.0, 0.0)
    return _hsv_to_rgb(hsv).astype(np.float32)
