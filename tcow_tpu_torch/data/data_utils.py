'''
Host-side data utilities: occlusion fractions, the occlusion/containment DAG, padding,
temporal usage modes, path expansion and frame-directory reading. The port's copy of
tcow_tpu/data/data_utils.py: vectorized numpy (cv2 imported to read frame images), with
the overlap counts and the painter's reconstruction in the native library
(tcow_tpu_torch/native) unless TCOW_NO_NATIVE=1 selects numpy.
'''

import glob
import os
import pathlib
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tcow_tpu_torch import native
from tcow_tpu_torch.data import geometry


def _use_native(K: int) -> bool:
    return native.enabled() and 1 <= K <= native.MAX_STATS_K


def _occl_fracs_from_counts(vis_cnt, tot_cnt, Hf, Wf) -> np.ndarray:
    vis_cnt = vis_cnt.astype(np.float64)
    tot_cnt = tot_cnt.astype(np.float64)
    with np.errstate(divide='ignore', invalid='ignore'):
        f = np.where(tot_cnt > 0, 1.0 - vis_cnt / np.maximum(tot_cnt, 1), 0.0)
    out = np.stack([f, vis_cnt / (Hf * Wf), tot_cnt / (Hf * Wf)], axis=-1)  # (T, K, 3)
    return out.transpose(1, 0, 2).astype(np.float32)                        # (K, T, 3)


def get_thing_occl_fracs(pv_segm: np.ndarray, pv_div_segm: np.ndarray) -> np.ndarray:
    '''Soft occlusion statistics per instance per frame.

    :param pv_segm (T, Hf, Wf, 1) int: 1-based visible instance IDs (0 = background).
    :param pv_div_segm (T, Hf, Wf, K) {0,1}: amodal masks.
    :return occl_fracs (K, T, 3) float32 with (f, v, t):
        f = occlusion fraction, v = visible pixels / image size, t = total pixels / size.
    '''
    T, Hf, Wf, K = pv_div_segm.shape
    if _use_native(K):
        vis_cnt, tot_cnt, _, _ = native.scene_overlap_stats(pv_segm[..., 0], pv_div_segm)
        return _occl_fracs_from_counts(vis_cnt, tot_cnt, Hf, Wf)
    ids = np.arange(1, K + 1).reshape(1, K)
    vis_cnt = (pv_segm.reshape(T, -1, 1) == ids[None]).sum(axis=1)          # (T, K)
    tot_cnt = (pv_div_segm.reshape(T, -1, K) == 1).sum(axis=1)              # (T, K)
    return _occl_fracs_from_counts(vis_cnt, tot_cnt, Hf, Wf)


def get_thing_occl_cont_dag(pv_segm: np.ndarray, pv_div_segm: np.ndarray, metadata: Dict,
                            frame_inds: Sequence[int]
                            ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, float]:
    '''Occlusion/containment DAG.

    :param pv_segm (T, Hf, Wf, 1) int32.
    :param pv_div_segm (T, Hf, Wf, K) {0,1}.
    :param metadata scene metadata dict (camera positions, instance positions + bboxes_3d).
    :param frame_inds source-video frame index per clip frame.
    :return (occl_cont_dag (T, K, K, 3) float32 with (c, od, of), rel_order (T, K) int32
        back-to-front, recon_pv_segm (T, Hf, Wf, 1) int32, recon_error float).
    '''
    T, Hf, Wf, K = pv_div_segm.shape
    if _use_native(K):
        _, div_cnt, overlap_dd, overlap_dv = native.scene_overlap_stats(pv_segm[..., 0],
                                                                        pv_div_segm)
        div_cnt = div_cnt.astype(np.float32)
        overlap_dd = overlap_dd.astype(np.float32)
        overlap_dv = overlap_dv.astype(np.float32)
        div = (pv_div_segm == 1)
    else:
        div = (pv_div_segm == 1)
        div_flat = div.reshape(T, Hf * Wf, K).astype(np.float32)
        ids = np.arange(1, K + 1)
        vis = (pv_segm.reshape(T, Hf * Wf, 1) == ids.reshape(1, 1, K)).astype(np.float32)
        div_cnt = div_flat.sum(axis=1)                                 # (T, K)
        # Pairwise overlap counts: amodal x amodal, and amodal x visible.
        overlap_dd = np.einsum('tpk,tpl->tkl', div_flat, div_flat)     # (T, K, K)
        overlap_dv = np.einsum('tpk,tpl->tkl', div_flat, vis)          # (T, K, K)

    oc_dag = np.zeros((T, K, K, 3), np.float32)
    rel_order = np.zeros((T, K), np.int32)

    cam_pos = np.asarray(metadata['camera']['positions'])              # (Tsrc, 3)
    inst_pos = np.asarray([metadata['instances'][k]['positions'] for k in range(K)])
    # (K, Tsrc, 3)

    for f, t in enumerate(frame_inds):
        dist = np.linalg.norm(cam_pos[t][None] - inst_pos[:, t], axis=-1)  # (K,)
        rel_order[f] = np.argsort(dist)[::-1]                              # back to front

    if native.enabled():
        recon = native.paint_recon_segm(pv_div_segm, rel_order)
    else:
        recon = np.zeros((T, Hf, Wf), np.int32)
        for f in range(T):
            for ref in rel_order[f]:
                recon[f][div[f, :, :, ref]] = ref + 1

    for f, t in enumerate(frame_inds):
        cur_order = rel_order[f]
        ref_pxl = np.maximum(div_cnt[f], 1.0)                          # (K,)

        # c: containment fraction, all ordered pairs (ref, cand), cand != ref.
        boxes = np.asarray([metadata['instances'][k]['bboxes_3d'][t] for k in range(K)])
        c = geometry.get_containment_fraction_matrix(boxes, boxes)     # (K, K): ref -> cand
        np.fill_diagonal(c, 0.0)
        oc_dag[f, :, :, 0] = c

        # od: direct occlusion pointer, only for cand strictly in front of ref.
        pos_in_order = np.empty(K, np.int64)
        pos_in_order[cur_order] = np.arange(K)
        in_front = pos_in_order[None, :] > pos_in_order[:, None]       # (ref, cand)
        oc_dag[f, :, :, 1] = np.where(in_front, overlap_dd[f] / ref_pxl[:, None], 0.0)

        # of: frontmost occlusion pointer (visible candidate pixels over ref amodal), all
        # pairs cand != ref.
        of = overlap_dv[f] / ref_pxl[:, None]
        np.fill_diagonal(of, 0.0)
        oc_dag[f, :, :, 2] = of

    if not np.all(np.diagonal(oc_dag, 0, 1, 2) == 0.0):
        raise ValueError('occlusion / containment DAG has a non-zero diagonal')
    recon = recon[..., None]
    recon_error = float(np.mean(pv_segm != recon))
    return oc_dag, rel_order, recon, recon_error


def pad_div(div_array: np.ndarray, axes: Sequence[int], max_size: int
            ) -> Tuple[np.ndarray, int]:
    '''Zero-pads the instance axis (or axes) to max_size for static-shape collation.'''
    K = -1
    shape = list(div_array.shape)
    sl = [slice(None)] * div_array.ndim
    for axis in axes:
        cur = div_array.shape[axis]
        if K not in (-1, cur):
            raise ValueError(f'pad_div axes {axes} differ in size: {div_array.shape}')
        K = cur
        shape[axis] = max_size
        sl[axis] = slice(0, cur)
    # zeros + slice-assign: one memset + one copy (np.pad's generic pad walk is far
    # slower on the 36-instance mask stacks of the hot loader path).
    out = np.zeros(shape, div_array.dtype)
    out[tuple(sl)] = div_array
    return out, K


def get_usage_modes(available_input_inds, available_query_inds, available_target_inds,
                    num_frames: int, query_time: int, min_target_frames_covered: int = 2
                    ) -> List[Tuple[int, int, float]]:
    '''Enumerates (frame_start, frame_stride, target_coverage) clip subsamplings of an
    arbitrary-length video that place an annotated query frame at position query_time.
    Strides 1..10.'''
    available_input_inds = sorted(set(available_input_inds))
    available_query_inds = sorted(set(available_query_inds))
    available_target_inds = sorted(set(available_target_inds))
    valid_modes = []
    for query_idx in available_query_inds:
        for frame_stride in range(1, 11):
            frame_first = query_idx - query_time * frame_stride
            frame_last = frame_first + (num_frames - 1) * frame_stride
            if frame_first < 0 or frame_last > max(available_input_inds):
                continue
            covered = sum(1 for fi in range(frame_first, frame_last + 1, frame_stride)
                          if fi in available_input_inds and fi in available_target_inds)
            if covered >= min_target_frames_covered:
                valid_modes.append((frame_first, frame_stride, covered / num_frames))
    return valid_modes


def _paths_from_txt(txt_fp: str) -> List[str]:
    with open(txt_fp, 'r') as f:
        lines = [ln.strip() for ln in f.readlines()]
    lines = [ln for ln in lines if ln and not ln.lower().startswith('#')]
    txt_dp = str(pathlib.Path(txt_fp).parent)
    paths = []
    for line in lines:
        if os.path.exists(line):
            paths.append(line)
        else:
            ap = os.path.join(txt_dp, line)
            if not os.path.exists(ap):
                raise FileNotFoundError(ap)
            paths.append(ap)
    return paths


def get_data_paths_from_args(given_data_paths: Sequence[str]) -> List[str]:
    '''Expands .txt list files into the paths they contain.'''
    actual = []
    for dp in given_data_paths:
        if dp.lower().endswith('.txt'):
            actual += _paths_from_txt(dp)
        else:
            actual.append(dp)
    return actual


def read_all_images(src_dp: str, exclude_patterns=None, count_only: bool = False,
                    stack: bool = False, early_resize_height: Optional[int] = None,
                    convert_float: bool = True):
    '''Reads all jpg/png frames in a directory, sorted, as (H, W, 3) RGB: float32 in
    [0, 1] (convert_float) or uint8; frames taller than early_resize_height are resized
    to it (INTER_LINEAR).'''
    import cv2
    src_fps = sorted(glob.glob(os.path.join(src_dp, '*.jpg')) +
                     glob.glob(os.path.join(src_dp, '*.png')))
    if count_only:
        return len(src_fps)
    if exclude_patterns is not None:
        if not isinstance(exclude_patterns, list):
            exclude_patterns = [exclude_patterns]
        for pattern in exclude_patterns:
            src_fps = [fp for fp in src_fps if pattern not in fp]
    frames = []
    for fp in src_fps:
        frame = cv2.imread(fp, cv2.IMREAD_UNCHANGED)
        if frame.ndim == 3:
            frame = frame[..., [2, 1, 0]] if frame.shape[-1] == 3 else frame[..., [2, 1, 0, 3]]
            frame = frame[..., :3]
        else:
            frame = np.repeat(frame[..., None], 3, axis=-1)
        if convert_float:
            frame = (frame / 255.0).astype(np.float32)
        if early_resize_height is not None and early_resize_height > 0:
            H1, W1 = frame.shape[:2]
            if H1 > early_resize_height:
                H2 = early_resize_height
                W2 = int(round(early_resize_height * W1 / H1))
                frame = cv2.resize(frame, (W2, H2), interpolation=cv2.INTER_LINEAR)
        frames.append(frame)
    return np.stack(frames) if stack else frames
