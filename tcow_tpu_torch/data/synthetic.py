'''
Synthetic training batches, the port's own copy of tcow_tpu/data/synthetic.py
(`synthetic_device_batch` :148-179 and the scene arrays it draws, :23-44 and :115-145 without
the scripted rich events) and of the numpy occlusion fractions of
tcow_tpu/data/data_utils.py (:20-46). The same seed gives the same arrays as the JAX
package: moving rectangles with a consistent depth order, so the visible segmentation,
the amodal masks and the occlusion fractions agree.
'''

from typing import Dict

import numpy as np


def _moving_rects(rng: np.random.RandomState, T: int, H: int, W: int, K: int):
    '''Amodal masks (K, T, H, W) uint8 of K rectangles moving at constant velocity
    (wrapping at the frame edges), and their centres (K, T, 2).'''
    div = np.zeros((K, T, H, W), np.uint8)
    centers = np.zeros((K, T, 2), np.float32)
    sizes = rng.randint(max(4, H // 8), max(6, H // 3), size=(K, 2))
    pos0 = np.stack([rng.uniform(0, H, K), rng.uniform(0, W, K)], axis=1)
    vel = rng.uniform(-2.5, 2.5, size=(K, 2))
    for t in range(T):
        p = pos0 + vel * t
        for k in range(K):
            cy, cx = p[k]
            cy = int(abs(cy)) % H
            cx = int(abs(cx)) % W
            hh, ww = sizes[k]
            y0, y1 = max(0, cy - hh // 2), min(H, cy + hh // 2 + 1)
            x0, x1 = max(0, cx - ww // 2), min(W, cx + ww // 2 + 1)
            div[k, t, y0:y1, x0:x1] = 1
            centers[k, t] = (cy, cx)
    return div, centers


def make_synthetic_scene_arrays(seed: int, T: int = 8, H: int = 64, W: int = 64,
                                K: int = 4) -> Dict[str, np.ndarray]:
    '''Consistent (rgb (T, H, W, 3), segm (T, H, W), div_segm (K, T, H, W)) arrays: the
    visible segm is the front-most instance at each pixel (higher index = nearer).'''
    rng = np.random.RandomState(seed)
    div, centers = _moving_rects(rng, T, H, W, K)
    segm = np.zeros((T, H, W), np.int32)
    for k in range(K):  # ascending: later (nearer) instances overwrite
        segm[div[k] == 1] = k + 1
    colors = rng.uniform(0.1, 0.9, size=(K + 1, 3)).astype(np.float32)
    rgb = colors[segm]  # (T, H, W, 3)
    rgb += rng.normal(0, 0.02, rgb.shape).astype(np.float32)
    rgb = np.clip(rgb, 0.0, 1.0)
    return {'rgb': rgb, 'segm': segm, 'div_segm': div, 'centers': centers}


def _occl_fracs_from_counts(vis_cnt, tot_cnt, Hf, Wf) -> np.ndarray:
    vis_cnt = vis_cnt.astype(np.float64)
    tot_cnt = tot_cnt.astype(np.float64)
    with np.errstate(divide='ignore', invalid='ignore'):
        f = np.where(tot_cnt > 0, 1.0 - vis_cnt / np.maximum(tot_cnt, 1), 0.0)
    out = np.stack([f, vis_cnt / (Hf * Wf), tot_cnt / (Hf * Wf)], axis=-1)  # (T, K, 3)
    return out.transpose(1, 0, 2).astype(np.float32)                        # (K, T, 3)


def get_thing_occl_fracs(pv_segm: np.ndarray, pv_div_segm: np.ndarray) -> np.ndarray:
    '''Occlusion statistics per instance and frame: pv_segm (T, Hf, Wf, 1) 1-based visible
    IDs, pv_div_segm (T, Hf, Wf, K) amodal masks -> (K, T, 3) float32 (f, v, t): occluded
    fraction, visible pixels / image size, total pixels / image size.'''
    T, Hf, Wf, K = pv_div_segm.shape
    ids = np.arange(1, K + 1).reshape(1, K)
    vis_cnt = (pv_segm.reshape(T, -1, 1) == ids[None]).sum(axis=1)          # (T, K)
    tot_cnt = (pv_div_segm.reshape(T, -1, K) == 1).sum(axis=1)              # (T, K)
    return _occl_fracs_from_counts(vis_cnt, tot_cnt, Hf, Wf)


def synthetic_device_batch(seed: int, B: int = 2, Q: int = 2, T: int = 8, H: int = 64,
                           W: int = 64, M: int = 8, K: int = 4,
                           query_time: int = 0) -> Dict[str, np.ndarray]:
    '''A batch in the train-step schema (train/step.py) with physically consistent
    occlusion fractions and a random but valid occlusion/containment DAG.'''
    rng = np.random.RandomState(seed)
    batch = {
        'rgb': np.zeros((B, 3, T, H, W), np.float32),
        'segm': np.zeros((B, T, H, W), np.int32),
        'div_segm': np.zeros((B, M, T, H, W), np.uint8),
        'query_inds': np.zeros((B, Q), np.int32),
        'query_time': np.int32(query_time),
        'occl_fracs': np.zeros((B, M, T, 3), np.float32),
        'occl_cont_dag': np.zeros((B, T, M, M, 3), np.float32),
    }
    for b in range(B):
        scene = make_synthetic_scene_arrays(seed * 997 + b, T, H, W, K)
        batch['rgb'][b] = scene['rgb'].transpose(3, 0, 1, 2)
        batch['segm'][b] = scene['segm']
        batch['div_segm'][b, :K] = scene['div_segm']
        batch['occl_fracs'][b, :K] = get_thing_occl_fracs(
            scene['segm'][..., None], scene['div_segm'].transpose(1, 2, 3, 0))
        # Random-but-valid DAG values (zero diagonal, zero padding).
        dag = rng.rand(T, K, K, 3).astype(np.float32) * 0.5
        dag[:, np.arange(K), np.arange(K)] = 0.0
        batch['occl_cont_dag'][b, :, :K, :K] = dag
        # Queries must be visible at query_time: the instances with most visible pixels.
        vis = np.array([(scene['segm'][query_time] == k + 1).sum() for k in range(K)])
        batch['query_inds'][b] = np.argsort(vis)[::-1][:Q].astype(np.int32)
    return batch


def synthetic_frame_times(seed: int, B: int, T: int, frame_stride: int = 1,
                          time_stretch_max: float = 4.0) -> np.ndarray:
    '''(B, T) float32 true source timestamps for time-calibrated rope, drawn per clip as
    tcow_tpu/data/augs.py draws its temporal augmentations (:183-204, :231-238, every one
    on): load indices at `frame_stride`, a palindrome (then reversed with p 0.35 and at
    doubled stride with p 0.35) or a reversal with p 0.5, a random offset, and a stretch
    exp(U(0, log time_stretch_max)). So times are non-integer and may fall, repeat or
    jump.'''
    rng = np.random.RandomState(seed)
    out = np.zeros((B, T), np.float32)
    for b in range(B):
        load = np.arange(2 * T, dtype=np.float32) * frame_stride
        clip = list(range(T))
        if rng.rand() < 0.5:
            clip = clip + clip[::-1][1:]
            if rng.rand() < 0.35:
                clip = clip[::-1]
            if rng.rand() < 0.35:
                clip = clip[::2]
        elif rng.rand() < 0.5:
            clip = clip[::-1]
        offset = rng.randint(0, len(clip) - T + 1)
        stretch = np.float32(np.exp(rng.uniform(0.0, np.log(time_stretch_max))))
        out[b] = load[np.asarray(clip[offset:offset + T])] * stretch
    return out


# The jitter ranges of tcow_tpu/data/augs.py:63-76 (sample_jitter_factors' defaults):
# brightness, contrast and saturation factors U(1 -+ 0.2), hue U(-+0.1).
JITTER_BRIGHTNESS, JITTER_CONTRAST, JITTER_SATURATION, JITTER_HUE = 0.2, 0.2, 0.2, 0.1


def synthetic_color_augs(seed: int, B: int, jitter=None, blur=None,
                         gray=None) -> Dict[str, np.ndarray]:
    '''The colour-augmentation keys of a batch for the on-device augmentations
    (ops/device_augs.py), drawn per clip as tcow_tpu/data/augs.py draws them for its
    deferred colour chain: jitter with p 0.9, blur with p 0.2 and grayscale with p 0.05
    (:213-215); the jitter factors in the JITTER_* ranges and a permutation of the four
    (sample_jitter_factors :63-76); a blur sigma U(0.1, 3.5) (:331-344, uncropped, so both
    axes take it as drawn). `jitter`, `blur` and `gray` (B bools each, or None) force an
    outcome per clip; the draws are made all the same, so the rest of the stream does not
    move. Returns jitter_factors (B, 5)
    f32 (fb, fc, fs, fh, apply), jitter_order (B, 4) int32 and blur_gray (B, 3) f32
    (sigma_y, sigma_x, grayscale), laid out as tcow_tpu/data/kubric.py:356-367 collates
    them.'''
    rng = np.random.default_rng(seed)
    factors = np.tile(np.array([1, 1, 1, 0, 0], np.float32), (B, 1))
    order = np.tile(np.arange(4, dtype=np.int32), (B, 1))
    blur_gray = np.zeros((B, 3), np.float32)
    for b in range(B):
        on = [rng.random() < p for p in (0.9, 0.2, 0.05)]
        for i, force in enumerate((jitter, blur, gray)):
            if force is not None:
                on[i] = bool(force[b])
        if on[0]:
            factors[b] = (rng.uniform(1 - JITTER_BRIGHTNESS, 1 + JITTER_BRIGHTNESS),
                          rng.uniform(1 - JITTER_CONTRAST, 1 + JITTER_CONTRAST),
                          rng.uniform(1 - JITTER_SATURATION, 1 + JITTER_SATURATION),
                          rng.uniform(-JITTER_HUE, JITTER_HUE), 1.0)
            order[b] = rng.permutation(4)
        if on[1]:
            blur_gray[b, :2] = rng.uniform(0.1, 3.5)
        blur_gray[b, 2] = float(on[2])
    return {'jitter_factors': factors, 'jitter_order': order, 'blur_gray': blur_gray}
