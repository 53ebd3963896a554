'''
Plugin dataset: the tracker on any real video (mp4/avi/gif/webm or a directory of frames)
with sparse annotations. The port's copy of tcow_tpu/data/plugin.py:
  - timestamped mask discovery: <video>_<t>_query.png, _snitch, _occl, _cont, _contoccl
    (both the `_query_10.png` and the `_10_query.png` layouts);
  - usage-mode enumeration: every (frame_start, stride <= 10) clip subsampling that puts
    an annotated query frame at position query_time_idx;
  - sparse targets with -1 = unannotated, the query mask at the query frame only;
  - early resize to height 480 and the test-time center crop to the training aspect
    ratio; the float frames go through AugmentationPipeline's smooth resize (cv2).

Frames and masks are decoded by cv2 (VideoCapture, imread), imported inside the functions
that read them. get_streaming_example gives the streaming evaluation (--stream_window)
every frame of the video from the first query on.
'''

import os
import pathlib
from typing import Dict, List, Optional

import numpy as np

from tcow_tpu_torch.data import augs as augs_lib
from tcow_tpu_torch.data import data_utils

VIDEO_EXTS = ('.mp4', '.avi', '.gif', '.webm', '.mov', '.mkv')
MASK_NAMES = ('query', 'snitch', 'occl', 'cont', 'contoccl')


def _early_resize(frame: np.ndarray, height: Optional[int]) -> np.ndarray:
    import cv2
    if height is None or height <= 0:
        return frame
    H1, W1 = frame.shape[:2]
    if H1 <= height:
        return frame
    W2 = int(round(height * W1 / H1))
    return cv2.resize(frame, (W2, height), interpolation=cv2.INTER_LINEAR)


def load_timestamped_named_mask_files(src_dp: str, src_fn: Optional[str], name: str,
                                      early_resize_height: Optional[int]
                                      ) -> Dict[int, np.ndarray]:
    '''Returns {source frame index: (H, W, 1) uint8 mask}.'''
    import cv2
    named_fns = sorted(os.listdir(src_dp))
    named_fns = [fn for fn in named_fns if f'_{name}_' in fn or f'_{name}.' in fn]
    if src_fn is not None:
        stem = src_fn.split('.')[0]
        named_fns = [fn for fn in named_fns if stem in fn]
    out = {}
    for fn in named_fns:
        fp = os.path.join(src_dp, fn)
        if f'_{name}_' in fn:
            idx = int(fn.split(f'_{name}_')[-1].split('.')[0])
        else:
            idx = int(fn.split(f'_{name}.')[-2].split('_')[-1].split('/')[-1])
        img = cv2.imread(fp, cv2.IMREAD_UNCHANGED)
        if img.ndim == 3:
            img = img[..., :3].astype(np.float32) / 255.0
        else:
            img = (img.astype(np.float32) / 255.0)[..., None].repeat(3, -1)
        img = _early_resize(img, early_resize_height)
        out[idx] = (img.sum(axis=-1) > 0.1).astype(np.uint8)[..., None]
    return out


def read_video_frames(src_fp: str, early_resize_height: Optional[int] = None
                      ) -> List[np.ndarray]:
    import cv2
    cap = cv2.VideoCapture(src_fp)
    if not cap.isOpened():
        raise OSError(f'could not open video: {src_fp}')
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        frame = bgr[..., [2, 1, 0]]
        frames.append(_early_resize(frame, early_resize_height))
    cap.release()
    return frames


class PluginVideoDataset:

    def __init__(self, src_path: str, logger, phase: str, num_clip_frames: int = 20,
                 frame_height: int = 240, frame_width: int = 320, frame_rate: int = 30,
                 prefer_frame_stride: int = 3, query_time: float = 0.2,
                 annots_must_exist: bool = False, prefetch: bool = False,
                 center_crop: bool = False, early_resize_height: int = 480):
        if phase != 'test':
            raise ValueError(f'plugin videos are test data, got phase {phase!r}')
        self.src_path = src_path
        self.logger = logger
        self.phase = phase
        self.num_clip_frames = num_clip_frames
        self.frame_height = frame_height
        self.frame_width = frame_width
        self.frame_rate = frame_rate
        self.prefer_frame_stride = prefer_frame_stride
        self.query_time_val = query_time
        self.query_time_idx = int(np.floor(query_time * num_clip_frames))
        self.annots_must_exist = annots_must_exist
        self.prefetch = prefetch
        self.center_crop = center_crop
        self.early_resize_height = early_resize_height

        self.augs_pipeline = augs_lib.AugmentationPipeline(
            num_clip_frames, num_clip_frames, frame_height, frame_width,
            prefer_frame_stride, False, False, 0.0, 0.0, center_crop,
            defer_color_jitter=False)

        if os.path.isdir(src_path):
            self.src_dp, self.src_fp, self.src_fn = src_path, None, None
        else:
            if not os.path.exists(src_path):
                raise FileNotFoundError(src_path)
            self.src_dp = str(pathlib.Path(src_path).parent)
            self.src_fp = src_path
            self.src_fn = str(pathlib.Path(src_path).name)

        if self.prefetch:
            self.raw_frames = self._get_raw_frames()
            self.num_video_frames = len(self.raw_frames)
        else:
            self.raw_frames = None
            self.num_video_frames = self._get_num_video_frames()

        self.raw_query_frames = load_timestamped_named_mask_files(
            self.src_dp, self.src_fn, 'query', early_resize_height)
        self.raw_snitch_frames = load_timestamped_named_mask_files(
            self.src_dp, self.src_fn, 'snitch', early_resize_height)
        self.raw_occl_frames = load_timestamped_named_mask_files(
            self.src_dp, self.src_fn, 'occl', early_resize_height)
        self.raw_cont_frames = load_timestamped_named_mask_files(
            self.src_dp, self.src_fn, 'cont', early_resize_height)
        both = load_timestamped_named_mask_files(
            self.src_dp, self.src_fn, 'contoccl', early_resize_height)
        self.raw_occl_frames.update(both)
        self.raw_cont_frames.update(both)

        available_input_inds = list(range(self.num_video_frames))
        available_query_inds = sorted(self.raw_query_frames.keys())
        available_target_inds = sorted(set(self.raw_snitch_frames)
                                       | set(self.raw_occl_frames)
                                       | set(self.raw_cont_frames))
        min_cov = 1 if annots_must_exist else 0
        self.usage_modes = data_utils.get_usage_modes(
            available_input_inds, available_query_inds, available_target_inds,
            num_clip_frames, self.query_time_idx, min_target_frames_covered=min_cov)
        if logger is not None:
            logger.info(f'(PluginVideoDataset) Valid usage modes '
                        f'(min_target_frames_covered: {min_cov}): {self.usage_modes}')

    def __len__(self):
        return len(self.usage_modes)

    def __getitem__(self, index: int) -> Dict:
        usage_mode_idx = index % len(self.usage_modes)
        frame_start, frame_stride, target_coverage = self.usage_modes[usage_mode_idx]
        frame_inds = list(range(frame_start,
                                frame_start + self.num_clip_frames * frame_stride,
                                frame_stride))
        augs_params = self.augs_pipeline.sample_augs_params(np.random.default_rng(0))

        raw_frames = self.raw_frames if self.prefetch else self._get_raw_frames()
        if len(raw_frames) != self.num_video_frames:
            raise RuntimeError(f'{self.src_path}: decoded {len(raw_frames)} frames, '
                               f'{self.num_video_frames} expected')

        pv_rgb = []
        for t in frame_inds:
            rgb = raw_frames[t]
            if np.issubdtype(rgb.dtype, np.integer):
                rgb = (rgb / 255.0).astype(np.float32)
            pv_rgb.append(rgb)
        pv_rgb = np.stack(pv_rgb)                                  # (T, Hf, Wf, 3)
        T = pv_rgb.shape[0]

        pv_query = np.zeros_like(pv_rgb[..., 0:1], dtype=np.uint8)
        pv_query[self.query_time_idx] = \
            self.raw_query_frames[frame_inds[self.query_time_idx]]

        # Sparse targets, -1 = unannotated. Snitch annotations map with
        # round((t-start)/stride) but occl/cont with floor division, as in the JAX package
        # (plugin.py:188-198), so off-grid annotations land on the same frames.
        pv_target = -np.ones(pv_rgb.shape[:3] + (3,), np.int8)
        for (t, v) in self.raw_snitch_frames.items():
            f = int(round((t - frame_start) / frame_stride))
            if 0 <= f < T:
                pv_target[f, ..., 0] = v[..., 0]
        for (t, v) in self.raw_occl_frames.items():
            f = int(round((t - frame_start) // frame_stride))
            if 0 <= f < T:
                pv_target[f, ..., 1] = v[..., 0]
        for (t, v) in self.raw_cont_frames.items():
            f = int(round((t - frame_start) // frame_stride))
            if 0 <= f < T:
                pv_target[f, ..., 2] = v[..., 0]

        modalities = {
            'rgb': pv_rgb.transpose(3, 0, 1, 2).astype(np.float32),
            'query_mask': pv_query.transpose(3, 0, 1, 2),
            'target_mask': pv_target.transpose(3, 0, 1, 2).astype(np.float32),
        }
        aug = self.augs_pipeline.apply_augs_2d_frames(modalities, augs_params)

        return {
            'source_name': 'plugin',
            'src_path': self.src_path,
            'dset_idx': index,
            'scene_idx': 0,
            'usage_mode_idx': usage_mode_idx,
            'frame_inds': np.asarray(frame_inds, np.int32),
            'frame_start': frame_start,
            'frame_stride': frame_stride,
            'target_coverage': target_coverage,
            'match_prefer_fstride': frame_stride == self.prefer_frame_stride,
            'rgb': aug['rgb'],                                  # (3, T, Hf, Wf)
            'query': aug['query_mask'].astype(np.float32),      # (1, T, Hf, Wf)
            'target': aug['target_mask'].astype(np.float32),    # (3, T, Hf, Wf)
        }

    def get_streaming_example(self) -> Dict:
        '''Full-rate arrays for the streaming evaluation (plugin.py:219-275 of the JAX
        package): EVERY video frame from the first annotated query on, resized to the
        model's resolution by the float smooth resize, the query at position 0 and sparse
        targets (-1 = unannotated) at their true timestamps, with no usage-mode
        subsampling.'''
        raw_frames = self.raw_frames if self.prefetch else self._get_raw_frames()
        Hf, Wf = self.frame_height, self.frame_width
        query_frame = min(self.raw_query_frames.keys())
        inds = list(range(query_frame, self.num_video_frames))

        def crop(img):
            if not self.center_crop:
                return img
            H1, W1 = img.shape[:2]
            want_ar = Wf / Hf
            if W1 / H1 > want_ar:
                cw = int(H1 * want_ar)
                x0 = (W1 - cw) // 2
                return img[:, x0:x0 + cw]
            ch = int(W1 / want_ar)
            y0 = (H1 - ch) // 2
            return img[y0:y0 + ch]

        rgb = np.stack([crop(raw_frames[t]) for t in inds]).astype(np.float32)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
        rgb = augs_lib.resize_frames(rgb.transpose(3, 0, 1, 2), Hf, Wf, nearest=False)

        N = len(inds)
        query = np.zeros((1, N, Hf, Wf), np.float32)
        qraw = crop(self.raw_query_frames[query_frame])[..., 0:1]
        query[0, 0] = augs_lib.resize_frames(
            qraw.transpose(2, 0, 1)[:, None].astype(np.float32), Hf, Wf, nearest=True)[0, 0]
        target = -np.ones((3, N, Hf, Wf), np.float32)
        annotated = set()
        for c, frames in enumerate((self.raw_snitch_frames, self.raw_occl_frames,
                                    self.raw_cont_frames)):
            for t, v in frames.items():
                if query_frame <= t < self.num_video_frames:
                    m = crop(v)[..., 0:1].transpose(2, 0, 1)[:, None].astype(np.float32)
                    target[c, t - query_frame] = augs_lib.resize_frames(
                        m, Hf, Wf, nearest=True)[0, 0]
                    annotated.add(t - query_frame)
        return {
            'source_name': 'plugin', 'src_path': self.src_path, 'dset_idx': 0,
            'scene_idx': 0, 'frame_start': query_frame, 'frame_stride': 1,
            'query_frame': query_frame, 'num_frames': N,
            'rgb': rgb,                    # (3, N, Hf, Wf) float32
            'query': query,                # (1, N, Hf, Wf), the query at position 0
            'target': target,              # (3, N, Hf, Wf), -1 = unannotated
            'annotated_inds': np.asarray(sorted(annotated), np.int32),
        }

    def _get_raw_frames(self):
        if os.path.isdir(self.src_path):
            return data_utils.read_all_images(
                self.src_dp, exclude_patterns=list(MASK_NAMES),
                early_resize_height=self.early_resize_height)
        return read_video_frames(self.src_fp, self.early_resize_height)

    def _get_num_video_frames(self):
        import cv2
        if os.path.isdir(self.src_path):
            return data_utils.read_all_images(self.src_dp,
                                              exclude_patterns=list(MASK_NAMES),
                                              count_only=True)
        cap = cv2.VideoCapture(self.src_fp)
        n = int(round(cap.get(cv2.CAP_PROP_FRAME_COUNT)))
        cap.release()
        return n
