'''
Synthetic data, the port's own copy of tcow_tpu/data/synthetic.py, two flavors:

  1. `synthetic_device_batch`: a batch in the train-step schema (moving rectangles with a
     consistent depth order, so the visible segmentation, the amodal masks and the
     occlusion fractions agree), with no dataset on disk.
  2. `write_synthetic_kubric_scene(s)`: scenes on disk in the Kubric export layout
     (frames/ rgba_*.png, segmentation_*.png, divided_segmentation_*_*.png + <scene>.json
     metadata), written through data/png.py, for the loader (data/kubric.py) and the
     training driver. `python -m tcow_tpu_torch.data.synthetic --out DIR` writes a
     dataset.

The same seed gives the same arrays as the JAX package, and the same decoded images: the
PNG bytes may differ.
'''

import json
import os
from typing import Dict

import numpy as np

from tcow_tpu_torch.data import png, vis_codec
from tcow_tpu_torch.data.data_utils import get_thing_occl_fracs


def _moving_rects(rng: np.random.RandomState, T: int, H: int, W: int, K: int,
                  sizes: np.ndarray = None):
    '''Amodal masks (K, T, H, W) uint8 of K rectangles moving at constant velocity
    (wrapping at the frame edges), and their centres (K, T, 2).'''
    div = np.zeros((K, T, H, W), np.uint8)
    centers = np.zeros((K, T, 2), np.float32)
    if sizes is None:
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


def _apply_rich_events(rng: np.random.RandomState, T: int, H: int, W: int, K: int,
                       div: np.ndarray, centers: np.ndarray, sizes: np.ndarray,
                       cont_episodes: int = 0):
    '''Scripted occlusion + containment episodes on top of the random rect motion.

    Instance 0 is the "snitch" (small); instance K-2 a large occluder, K-1 a large
    container. With per-episode probability the snitch snaps to the host's center for a
    random frame span: behind the occluder it is fully occluded (mask-subset, painter
    order puts K-2 in front), inside the container its metadata position and 3-D box
    nest inside the container's enlarged box, so get_thing_occl_cont_dag's OBB
    containment (data/geometry.py) reports c[0, K-1] = 1.0 >= outer_cont_thres and the
    supervision emits channel-2 container targets + 'contained' flags. The
    container keeps moving while the snitch rides inside: tracking through containment.

    Returns (div, centers, z_pos (K, T), bbox_half (K,)) — z/bbox feed the metadata.
    '''
    if K < 4:
        raise ValueError('rich events need >= 4 instances (snitch + occluder + container + 1)')
    z_pos = np.tile(np.arange(K, dtype=np.float32)[:, None], (1, T))   # default z = k
    bbox_half = np.full(K, 0.1, np.float32)
    occluder, container = K - 2, K - 1
    bbox_half[container] = 0.5
    sh, sw = sizes[0]

    def stamp(t, cy, cx):
        div[0, t] = 0
        y0, y1 = max(0, int(cy) - sh // 2), min(H, int(cy) + sh // 2 + 1)
        x0, x1 = max(0, int(cx) - sw // 2), min(W, int(cx) + sw // 2 + 1)
        div[0, t, y0:y1, x0:x1] = 1
        centers[0, t] = (int(cy), int(cx))

    # Random non-overlapping spans, each present with high probability and bracketed by
    # visible frames at both clip ends. Default (cont_episodes=0): [occl episode][gap]
    # [containment episode]. cont_episodes=N>0 is the containment-heavy variant: 1 occl
    # slot + N containment slots partition the usable range, so a 40-frame scene carries
    # several independent containment events with distinct spans and trajectories.
    spans = []
    lo = max(1, int(T * 0.1))
    hi = max(lo + 2, int(T * 0.9))
    if cont_episodes > 0:
        bounds = np.linspace(lo, hi, 2 + cont_episodes).astype(int)
        for i in range(1 + cont_episodes):
            a0, a1 = int(bounds[i]), int(bounds[i + 1]) - 1   # gap frame between slots
            if a1 - a0 >= 2 and rng.rand() < 0.9:
                a = rng.randint(a0, a1 - 1)
                spans.append(('occl' if i == 0 else 'cont', a, rng.randint(a + 1, a1)))
    else:
        mid = rng.randint(lo + 1, hi - 1) if hi - lo > 2 else (lo + hi) // 2
        if rng.rand() < 0.85 and mid - lo >= 2:
            a = rng.randint(lo, mid - 1)
            spans.append(('occl', a, rng.randint(a + 1, mid)))
        if rng.rand() < 0.85 and hi - mid >= 2:
            a = rng.randint(mid, hi - 1)
            spans.append(('cont', a, rng.randint(a + 1, hi)))
    for kind, t0, t1 in spans:
        host = occluder if kind == 'occl' else container
        for t in range(t0, t1 + 1):
            stamp(t, *centers[host, t])
            if kind == 'cont':
                # Nest the 3-D box inside the container's; stay just behind it in z so
                # the metadata camera order matches the ascending-k painter order.
                z_pos[0, t] = z_pos[container, t] - 0.2
    return div, centers, z_pos, bbox_half


def make_synthetic_scene_arrays(seed: int, T: int = 8, H: int = 64, W: int = 64,
                                K: int = 4, rich_events: bool = False,
                                cont_episodes: int = 0) -> Dict[str, np.ndarray]:
    '''Consistent (rgb (T, H, W, 3), segm (T, H, W), div_segm (K, T, H, W)) arrays: the
    visible segm is the front-most instance at each pixel (higher index = nearer).
    rich_events=True adds scripted full-occlusion and containment episodes
    (_apply_rich_events).'''
    rng = np.random.RandomState(seed)
    sizes = None
    if rich_events:
        sizes = rng.randint(max(4, H // 8), max(6, H // 3), size=(K, 2))
        sizes[0] = (max(4, H // 10), max(4, W // 10))                  # small snitch
        sizes[K - 2] = (max(8, H // 3), max(8, W // 3))                # large occluder
        sizes[K - 1] = (max(8, H // 3), max(8, W // 3))                # large container
    div, centers = _moving_rects(rng, T, H, W, K, sizes=sizes)
    z_pos = bbox_half = None
    if rich_events:
        div, centers, z_pos, bbox_half = _apply_rich_events(rng, T, H, W, K, div,
                                                            centers, sizes,
                                                            cont_episodes=cont_episodes)
    segm = np.zeros((T, H, W), np.int32)
    for k in range(K):  # ascending: later (nearer) instances overwrite
        segm[div[k] == 1] = k + 1
    colors = rng.uniform(0.1, 0.9, size=(K + 1, 3)).astype(np.float32)
    rgb = colors[segm]  # (T, H, W, 3)
    rgb += rng.normal(0, 0.02, rgb.shape).astype(np.float32)
    rgb = np.clip(rgb, 0.0, 1.0)
    out = {'rgb': rgb, 'segm': segm, 'div_segm': div, 'centers': centers}
    if rich_events:
        out['z_pos'] = z_pos          # (K, T) metadata z per frame
        out['bbox_half'] = bbox_half  # (K,) metadata 3-D box half-extent
    return out


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


# ---------------------------------------------------------------------------
# On-disk synthetic Kubric-format scenes
# ---------------------------------------------------------------------------

def write_synthetic_kubric_scene(scene_dp: str, seed: int, T: int = 12, H: int = 64,
                                 W: int = 96, K: int = 4, rich_events: bool = False,
                                 cont_episodes: int = 0) -> None:
    '''Writes one scene directory in the Kubric export layout:
      <scene>/frames/rgba_00000.png ...
      <scene>/frames/segmentation_00000.png (hue-palette instance colors)
      <scene>/frames/divided_segmentation_<k>_<t>.png
      <scene>/<scene>.json  (camera + instance metadata, written last as completion marker)
    rgba rows are written with the Sub filter, the masks unfiltered, zlib at level 1.'''
    name = os.path.basename(scene_dp.rstrip('/'))
    frames_dp = os.path.join(scene_dp, 'frames')
    os.makedirs(frames_dp, exist_ok=True)
    scene = make_synthetic_scene_arrays(seed, T, H, W, K, rich_events=rich_events,
                                        cont_episodes=cont_episodes)
    for t in range(T):
        rgba = (np.concatenate([scene['rgb'][t],
                                np.ones((H, W, 1), np.float32)], axis=-1) * 255).astype(np.uint8)
        png.write_png(os.path.join(frames_dp, f'rgba_{t:05d}.png'), rgba, filter_type=1)
        segm_rgb = vis_codec.segm_ids_to_rgb_kubric(scene['segm'][t], K)
        png.write_png(os.path.join(frames_dp, f'segmentation_{t:05d}.png'),
                      (segm_rgb * 255).astype(np.uint8))
        for k in range(K):
            mask = (scene['div_segm'][k, t] * 255).astype(np.uint8)
            png.write_png(os.path.join(frames_dp, f'divided_segmentation_{k:03d}_{t:05d}.png'),
                          mask)

    # Metadata: camera at z=10 looking down; depth z = k so larger k is closer to the
    # camera, consistent with the painter's order used for the visible segmentation.
    instances = []
    z_pos = scene.get('z_pos')
    bbox_half = scene.get('bbox_half')
    for k in range(K):
        positions = []
        bboxes_3d = []
        for t in range(T):
            cy, cx = scene['centers'][k, t]
            z = float(z_pos[k, t]) if z_pos is not None else float(k)
            pos = [float(cx) / W, float(cy) / H, z]
            positions.append(pos)
            s = float(bbox_half[k]) if bbox_half is not None else 0.1
            corners = [[pos[0] + dx, pos[1] + dy, pos[2] + dz]
                       for dx in (-s, s) for dy in (-s, s) for dz in (-s, s)]
            bboxes_3d.append(corners)
        instances.append({'positions': positions, 'bboxes_3d': bboxes_3d,
                          'asset_id': f'synthetic_{k}', 'mass': 1.0, 'scale': 1.0})
    metadata = {
        'scene': {'num_frames': T, 'frame_rate': 12, 'resolution': [W, H],
                  'num_valo_instances': K},
        'camera': {'positions': [[0.0, 0.0, 10.0]] * T,
                   'field_of_view': 0.9},
        'instances': instances,
    }
    with open(os.path.join(scene_dp, f'{name}.json'), 'w') as f:
        json.dump(metadata, f)


def write_synthetic_kubric_dataset(root_dp: str, num_scenes: int = 3, seed: int = 0,
                                   **scene_kwargs) -> None:
    for i in range(num_scenes):
        scene_dn = f'{os.path.basename(root_dp.rstrip("/"))}_scn{i:05d}'
        write_synthetic_kubric_scene(os.path.join(root_dp, scene_dn), seed + i,
                                     **scene_kwargs)


if __name__ == '__main__':
    import argparse
    parser = argparse.ArgumentParser(
        description='Writes synthetic Kubric-format scenes for train_torch.py.')
    parser.add_argument('--out', required=True)
    parser.add_argument('--num_scenes', type=int, default=3)
    parser.add_argument('--frames', type=int, default=12)
    parser.add_argument('--height', type=int, default=64)
    parser.add_argument('--width', type=int, default=96)
    parser.add_argument('--seed', type=int, default=0)
    # Keep --objects comfortably above the --num_queries you train with: an instance
    # fully occluded at the query frame is unsampleable, and a scene with fewer than Q
    # sampleable instances is re-preprocessed every epoch ([SkipCache]).
    parser.add_argument('--objects', type=int, default=6)
    parser.add_argument('--rich', action='store_true',
                        help='scripted full-occlusion + containment episodes')
    parser.add_argument('--rich_cont_episodes', type=int, default=0)
    a = parser.parse_args()
    write_synthetic_kubric_dataset(a.out, a.num_scenes, a.seed, T=a.frames, H=a.height,
                                   W=a.width, K=a.objects, rich_events=a.rich,
                                   cont_episodes=a.rich_cont_episodes)
    print(f'Wrote {a.num_scenes} synthetic scenes to {a.out}')
