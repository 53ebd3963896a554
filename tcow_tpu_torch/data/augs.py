'''
Data augmentation pipeline, host side: the port's copy of tcow_tpu/data/augs.py.

  - temporal: palindrome p, reverse p (0.35 inside palindrome), frame-stride doubling
    p=0.35 inside palindrome, random clip offset within the loaded window;
  - colour (train only): jitter(0.2, 0.2, 0.2, 0.1) p 0.9, gaussian blur(5, sigma
    0.1-3.5) p 0.2, grayscale p 0.05. With defer_color_jitter (the default, --device_augs
    on) the keys are DRAWN here from the same RNG stream as the JAX package draws them and
    APPLIED on the device (ops/device_augs.py); without it (--device_augs 0, the host
    colour path) they are applied here in float32 with cv2 (HSV hue shift, Gaussian blur),
    the JAX package's calls, so the pixels are the same;
  - spatial (train only, augs_2d): horizontal flip p=0.5, random crop of 0-20% per side;
  - test-time center crop to the training aspect ratio;
  - final resize: nearest for segmentation-like modalities; smooth otherwise, INTER_AREA
    to reduce the height, else INTER_LINEAR: for uint8 rgb written in integer numpy to
    cv2.resize's arithmetic (`resize_u8`), for float frames cv2.resize itself.

cv2 is imported inside the functions of the host colour path and the float resize, never
at load. Randomness is drawn from an explicit numpy Generator, so an item is a pure
function of its seed.
'''

from typing import Dict, Optional

import numpy as np

# cv::resize's fixed point for 8-bit images (INTER_RESIZE_COEF_BITS).
RESIZE_COEF_BITS = 11
RESIZE_COEF_SCALE = 1 << RESIZE_COEF_BITS
_DBL_EPS = np.finfo(np.float64).eps


def _rgb_to_gray(img: np.ndarray) -> np.ndarray:
    '''(..., 3, H, W) -> (..., 1, H, W), ITU-R 601 weights like torchvision.'''
    w = np.array([0.299, 0.587, 0.114], img.dtype)
    return np.einsum('c,...chw->...hw', w, img)[..., None, :, :]


def _blend(a, b, factor):
    '''a*factor + b*(1-factor), clipped to [0,1], in place on a (the same per-element
    values and order of operations as the out-of-place expression).'''
    a *= factor
    a += b * (1.0 - factor)
    np.clip(a, 0.0, 1.0, out=a)
    return a


def _shift_hue(frames_tchw: np.ndarray, fh: float) -> np.ndarray:
    '''Hue rotation through cv2's float32 HSV. All T frames are stacked into one
    (T*H, W, 3) image, so the round trip is two cvtColor calls (cvtColor is per pixel).'''
    import cv2
    T, C, H, W = frames_tchw.shape
    hwc = np.clip(frames_tchw.transpose(0, 2, 3, 1), 0, 1).astype(
        np.float32).reshape(T * H, W, C)
    hsv = cv2.cvtColor(hwc, cv2.COLOR_RGB2HSV)
    hsv[..., 0] = (hsv[..., 0] + fh * 360.0) % 360.0
    return cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB).reshape(T, H, W, C).transpose(0, 3, 1, 2)


def sample_jitter_factors(rng: np.random.Generator, brightness=0.2, contrast=0.2,
                          saturation=0.2, hue=0.1) -> Dict:
    '''Draws the per-video ColorJitter factors + op order, the random values the JAX
    package's color_jitter() consumes, so every later draw of the stream is the same.'''
    return {
        'fb': rng.uniform(max(0.0, 1 - brightness), 1 + brightness),
        'fc': rng.uniform(max(0.0, 1 - contrast), 1 + contrast),
        'fs': rng.uniform(max(0.0, 1 - saturation), 1 + saturation),
        'fh': rng.uniform(-hue, hue),
        'order': rng.permutation(4).astype(np.int32),
    }


def color_jitter(frames: np.ndarray, rng: np.random.Generator, brightness=0.2, contrast=0.2,
                 saturation=0.2, hue=0.1, factors: Optional[Dict] = None) -> np.ndarray:
    '''torchvision.ColorJitter semantics on (T, 3, H, W) float frames: factors sampled once
    per video, the four adjustments applied in a random order.'''
    if factors is None:
        factors = sample_jitter_factors(rng, brightness, contrast, saturation, hue)
    fb, fc, fs, fh = factors['fb'], factors['fc'], factors['fs'], factors['fh']
    out = frames.astype(np.float32)
    for op in factors['order']:
        if op == 0:
            out *= fb
            np.clip(out, 0.0, 1.0, out=out)
        elif op == 1:
            mean = _rgb_to_gray(out).mean(axis=(-3, -2, -1), keepdims=True)
            out = _blend(out, mean, fc)
        elif op == 2:
            gray = _rgb_to_gray(out)
            out = _blend(out, gray, fs)
        else:
            out = _shift_hue(out, fh)
    return out


def gaussian_blur(frames: np.ndarray, rng: np.random.Generator, ksize=5,
                  sigma_range=(0.1, 3.5), sigma: Optional[float] = None) -> np.ndarray:
    '''cv2.GaussianBlur of each (3, H, W) frame of (T, 3, H, W), one sigma per video.'''
    import cv2
    if sigma is None:
        sigma = float(rng.uniform(*sigma_range))
    out = np.empty_like(frames)
    for t in range(frames.shape[0]):
        img = frames[t].transpose(1, 2, 0)
        out[t] = cv2.GaussianBlur(img, (ksize, ksize), sigma).transpose(2, 0, 1)
    return out


def nearest_gather_inds(dst: int, src: int) -> np.ndarray:
    '''The cv2.INTER_NEAREST source index per destination pixel. cv2 computes the scale
    as the double 1/(dst/src), NOT src/dst, which differs by one ulp exactly at integer
    boundaries (e.g. 368->320 at j=100); this is that expression.'''
    return np.minimum(np.floor(np.arange(dst) * (1.0 / (dst / src))).astype(np.int64),
                      src - 1)


# ---------------------------------------------------------------------------------------
# cv2.resize for uint8 images, in integer numpy (modules/imgproc/src/resize.cpp)
# ---------------------------------------------------------------------------------------

def _linear_taps(dst: int, src: int, area_mode: bool):
    '''Source index and fraction per destination index, as cv::resize's generic path
    computes them (in float32 from a double scale of 1/(dst/src)).'''
    inv = dst / src
    scale = 1.0 / inv
    d = np.arange(dst)
    if not area_mode:
        f = ((d + 0.5) * scale - 0.5).astype(np.float32)
        s = np.floor(f).astype(np.int64)
        f = f - s.astype(np.float32)
    else:
        s = np.floor(d * scale).astype(np.int64)
        f = ((d + 1) - (s + 1) * inv).astype(np.float32)
        f = np.where(f <= 0, np.float32(0), f - np.floor(f)).astype(np.float32)
    return s, f


def _fixed_weights(f: np.ndarray):
    '''saturate_cast<short>((1 - f) * 2048) and (f * 2048), each rounded to even.'''
    w0 = np.rint((np.float32(1) - f) * np.float32(RESIZE_COEF_SCALE)).astype(np.int32)
    w1 = np.rint(f * np.float32(RESIZE_COEF_SCALE)).astype(np.int32)
    return w0, w1


def _resize_linear(img: np.ndarray, height: int, width: int, area_mode: bool) -> np.ndarray:
    '''(N, H, W, C) uint8 -> (N, height, width, C): cv::resize's two-tap fixed-point path
    (INTER_LINEAR; INTER_AREA where a scale is < 1). Horizontally a tap outside the image
    is clamped with its weight set to 0; vertically the row index is clamped but the
    weights are kept, and the rows combine as VResizeLinear<uchar> does:
    (((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16) + 2) >> 2.'''
    _, H, W, _ = img.shape
    sx, fx = _linear_taps(width, W, area_mode)
    edge = (sx < 0) | (sx >= W - 1)
    fx = np.where(edge, np.float32(0), fx)
    sx = np.clip(sx, 0, W - 1)
    a0, a1 = _fixed_weights(fx)
    src = img.astype(np.int32)
    hbuf = (src[:, :, sx] * a0[None, None, :, None]
            + src[:, :, np.minimum(sx + 1, W - 1)] * a1[None, None, :, None])
    sy, fy = _linear_taps(height, H, area_mode)
    b0, b1 = _fixed_weights(fy)
    hbuf >>= 4
    rows0 = hbuf[:, np.clip(sy, 0, H - 1)]
    rows0 *= b0[None, :, None, None]
    rows0 >>= 16
    rows1 = hbuf[:, np.clip(sy + 1, 0, H - 1)]
    rows1 *= b1[None, :, None, None]
    rows1 >>= 16
    rows0 += rows1
    rows0 += 2
    rows0 >>= 2
    return np.clip(rows0, 0, 255).astype(np.uint8)


def _area_table(ssize: int, dsize: int, scale: float):
    '''computeResizeAreaTab: per destination index, its source indices and float32
    weights in cv2's order, as (n, dsize) arrays with a mask of the entries present.'''
    cells = []
    for dx in range(dsize):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, ssize - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, ssize - 1)
        sx1 = min(sx1, sx2)
        ent = []
        if sx1 - fsx1 > 1e-3:
            ent.append((sx1 - 1, (sx1 - fsx1) / cell))
        ent += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            ent.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        cells.append(ent)
    n = max(len(e) for e in cells)
    idx = np.zeros((n, dsize), np.int64)
    weight = np.zeros((n, dsize), np.float32)
    present = np.zeros((n, dsize), bool)
    for d, ent in enumerate(cells):
        for j, (s, a) in enumerate(ent):
            idx[j, d], weight[j, d], present[j, d] = s, a, True
    return idx, weight, present


def _resize_area(img: np.ndarray, height: int, width: int) -> np.ndarray:
    '''(N, H, W, C) uint8 -> (N, height, width, C), cv2.INTER_AREA when both scales are
    >= 1. Integer scales average blocks (2x2 with 1, 3 or 4 channels as (sum + 2) >> 2,
    others as round(sum * (1/area)) in float32); other scales sum the area table in
    float32 in cv2's order, a row of source pixels at a time, and round to even.'''
    N, H, W, C = img.shape
    sx_scale, sy_scale = 1.0 / (width / W), 1.0 / (height / H)
    ix, iy = int(round(sx_scale)), int(round(sy_scale))
    if abs(sx_scale - ix) < _DBL_EPS and abs(sy_scale - iy) < _DBL_EPS:
        s = img[:, :height * iy, :width * ix].astype(np.int32).reshape(
            N, height, iy, width, ix, C).sum((2, 4))
        if ix == 2 and iy == 2 and C in (1, 3, 4):
            return ((s + 2) >> 2).astype(np.uint8)
        return np.clip(np.rint(s.astype(np.float32) * np.float32(1.0 / (ix * iy))),
                       0, 255).astype(np.uint8)
    xi, xw, xp = _area_table(W, width, sx_scale)
    yi, yw, yp = _area_table(H, height, sy_scale)
    src = img.astype(np.float32)
    buf = np.zeros((N, H, width, C), np.float32)
    for j in range(xi.shape[0]):
        m = xp[j]
        buf[:, :, m] = buf[:, :, m] + src[:, :, xi[j, m]] * xw[j, m][None, None, :, None]
    acc = np.zeros((N, height, width, C), np.float32)
    for j in range(yi.shape[0]):
        m = yp[j]
        acc[:, m] = acc[:, m] + yw[j, m][None, :, None, None] * buf[:, yi[j, m]]
    return np.clip(np.rint(acc), 0, 255).astype(np.uint8)


def resize_u8(img: np.ndarray, height: int, width: int, area: bool) -> np.ndarray:
    '''cv2.resize(img[n], (width, height), INTER_AREA if area else INTER_LINEAR) for each
    of the N uint8 images of img (N, H, W, C), C <= 4, bit for bit: the dispatch of
    cv::hal::resize (an exact 2x reduction runs INTER_AREA under INTER_LINEAR too; true
    area averaging only where both scales are >= 1).'''
    if img.dtype != np.uint8 or img.ndim != 4 or img.shape[-1] > 4:
        raise TypeError(f'resize_u8 takes (N, H, W, C<=4) uint8, got {img.shape} {img.dtype}')
    _, H, W, _ = img.shape
    sx, sy = 1.0 / (width / W), 1.0 / (height / H)
    half = abs(sx - 2) < _DBL_EPS and abs(sy - 2) < _DBL_EPS
    if (area or half) and sx >= 1 and sy >= 1:
        return _resize_area(img, height, width)
    return _resize_linear(img, height, width, area_mode=area)


def resize_frames(frames: np.ndarray, height: int, width: int, nearest: bool) -> np.ndarray:
    '''(C, T, H, W) -> (C, T, height, width). nearest: one gather with cv2.INTER_NEAREST's
    indices, any dtype. Smooth: cv2's INTER_AREA to reduce the height, else INTER_LINEAR,
    on images of at most 4 channels as cv2 takes them (instance-mask stacks go up to
    K = 36 channels): uint8 in integer numpy (resize_u8), float by cv2.resize.'''
    C, T, H, W = frames.shape
    if (H, W) == (height, width):
        # Contiguous copy so no caller ever receives a view pinning the full-res buffer.
        return np.ascontiguousarray(frames)
    if nearest:
        yi = nearest_gather_inds(height, H)
        xi = nearest_gather_inds(width, W)
        return frames[:, :, yi[:, None], xi]
    if frames.dtype != np.uint8:
        return _resize_float(frames, height, width)
    out = np.empty((C, T, height, width), np.uint8)
    for c0 in range(0, C, 4):
        imgs = frames[c0:c0 + 4].transpose(1, 2, 3, 0)            # (T, H, W, <=4)
        out[c0:c0 + 4] = resize_u8(imgs, height, width, area=height < H).transpose(3, 0, 1, 2)
    return out


def _resize_float(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    '''The smooth resize of float (C, T, H, W) frames, one cv2.resize per frame and group
    of at most 4 channels.'''
    import cv2
    C, T, H, W = frames.shape
    interp = cv2.INTER_AREA if height < H else cv2.INTER_LINEAR
    out = np.empty((C, T, height, width), frames.dtype)
    for t in range(T):
        for c0 in range(0, C, 4):
            img = np.ascontiguousarray(frames[c0:c0 + 4, t].transpose(1, 2, 0))
            r = cv2.resize(img, (width, height), interpolation=interp)
            if r.ndim == 2:
                r = r[..., None]
            out[c0:c0 + 4, t] = r.transpose(2, 0, 1)
    return out


class AugmentationPipeline:

    def __init__(self, num_frames_load: int, num_frames_clip: int, frame_height: int,
                 frame_width: int, frame_stride: int, do_random_augs: bool, augs_2d: bool,
                 reverse_prob: float, palindrome_prob: float, center_crop: bool,
                 defer_color_jitter: bool = True, time_stretch_max: float = 1.0):
        # defer_color_jitter: sample the colour-chain parameters here (same RNG stream)
        # and leave all the pixel math (jitter + blur + grayscale) to the device
        # (ops/device_augs.py); the keys land in params['jitter_factors'] and
        # params['blur_sigmas'] (resize-ratio-scaled). Without it the host applies them.
        # time_stretch_max > 1 (train + rope_time_coords only): scale each example's rope
        # time coordinates by a random log-uniform factor in [1, max], a pure coordinate
        # augmentation that exercises long relative offsets.
        self.defer_color_jitter = defer_color_jitter
        self.time_stretch_max = time_stretch_max
        self.num_frames_load = num_frames_load
        self.num_frames_clip = num_frames_clip
        self.frame_height = frame_height
        self.frame_width = frame_width
        self.frame_stride = frame_stride
        self.do_random_augs = do_random_augs
        self.augs_2d = augs_2d
        self.reverse_prob = reverse_prob
        self.palindrome_prob = palindrome_prob
        self.center_crop = center_crop

    def sample_augs_params(self, rng: Optional[np.random.Generator] = None) -> Dict:
        if rng is None:
            rng = np.random.default_rng()
        palindrome = False
        reverse = False
        frame_stride_factor = 1
        offset = (self.num_frames_load - self.num_frames_clip) // 2
        frame_inds_load = list(range(0, self.num_frames_load * self.frame_stride,
                                     self.frame_stride))
        frame_inds_clip = list(range(0, self.num_frames_clip))

        if self.do_random_augs:
            palindrome = rng.random() < self.palindrome_prob
            if palindrome:
                reverse = rng.random() < 0.35
                frame_stride_factor = 2 if rng.random() < 0.35 else 1
            else:
                reverse = rng.random() < self.reverse_prob
            if palindrome:
                frame_inds_clip = frame_inds_clip + frame_inds_clip[::-1][1:]
            if reverse:
                frame_inds_clip = frame_inds_clip[::-1]
            if frame_stride_factor > 1:
                frame_inds_clip = frame_inds_clip[::frame_stride_factor]
            num_avail = len(frame_inds_clip)
            if num_avail < self.num_frames_clip:
                raise ValueError(f'{num_avail} frames left after the temporal '
                                 f'augmentations, {self.num_frames_clip} needed')
            offset = int(rng.integers(0, num_avail - self.num_frames_clip + 1))
            frame_inds_clip = frame_inds_clip[offset:offset + self.num_frames_clip]

        params = {
            'palindrome': palindrome, 'reverse': reverse,
            'frame_stride_factor': frame_stride_factor, 'offset': offset,
            'frame_inds_load': np.array(frame_inds_load),
            'frame_inds_clip': np.array(frame_inds_clip),
            'color_jitter': False, 'rgb_blur': False, 'rgb_grayscale': False,
            'horz_flip': False, 'crop_rect': -np.ones(4),
        }
        if self.do_random_augs:
            params['color_jitter'] = rng.random() < 0.9
            params['rgb_blur'] = rng.random() < 0.2
            params['rgb_grayscale'] = rng.random() < 0.05
            if self.augs_2d:
                params['horz_flip'] = rng.random() < 0.5
                params['crop_rect'] = np.array([
                    rng.random() * 0.2, rng.random() * 0.2 + 0.8,
                    rng.random() * 0.2, rng.random() * 0.2 + 0.8])
            # The colour keys are drawn inside apply (same rng), so stash its state.
        params['time_stretch'] = 1.0
        if self.do_random_augs and self.time_stretch_max > 1.0:
            params['time_stretch'] = float(np.exp(
                rng.uniform(0.0, np.log(self.time_stretch_max))))
        params['_rng_state'] = rng.bit_generator.state
        return params

    def frame_times(self, params: Dict) -> np.ndarray:
        '''True source timestamps (f32, len Tc) of the augmented clip for time-calibrated
        rope: load indices (which carry the base frame_stride) indexed by the temporally
        augmented clip order, times the optional stretch factor. Stride doubling yields
        doubled gaps, reversal decreasing times, palindrome mirror frames their repeated
        times.'''
        t = params['frame_inds_load'][params['frame_inds_clip']].astype(np.float32)
        return t * np.float32(params.get('time_stretch', 1.0))

    def nearest_index_maps(self, params: Dict, H: int, W: int):
        '''Compose frame-select + center-crop + flip + crop + nearest-resize into three
        per-axis int64 index maps (t_map, y_map, x_map) such that, for any nearest-path
        modality (segm / div / mask),
            apply_augs_2d_frames({m: raw})[m][c, t, y, x]
                == raw[c, t_map[t], y_map[y], x_map[x]]
        exactly, so the native fused gather (native.gather_div_bits) produces the
        augmented masks straight from the bit-packed cache in one pass.'''
        t_map = np.asarray(params['frame_inds_clip'], np.int64)

        off_y, off_x = 0, 0
        H1, W1 = H, W
        if self.center_crop:
            cur_ar = W / H
            want_ar = self.frame_width / self.frame_height
            if cur_ar > want_ar:
                W1 = int(H * want_ar)
                off_x = (W - W1) // 2
            elif cur_ar < want_ar:
                H1 = int(W / want_ar)
                off_y = (H - H1) // 2

        y1c, x1c = 0, 0
        H2, W2 = H1, W1
        crop_rect = params['crop_rect']
        if crop_rect is not None and np.all(np.asarray(crop_rect) >= 0.0):
            ry1, ry2, rx1, rx2 = crop_rect
            y1c, x1c = int(ry1 * H1), int(rx1 * W1)
            H2, W2 = int(ry2 * H1) - y1c, int(rx2 * W1) - x1c

        y_map = off_y + y1c + nearest_gather_inds(self.frame_height, H2)
        x_cc = x1c + nearest_gather_inds(self.frame_width, W2)   # in post-flip coords
        if params['horz_flip']:
            x_cc = W1 - 1 - x_cc
        x_map = off_x + x_cc
        return t_map, y_map, x_map

    def apply_augs_2d_frames(self, modalities: Dict[str, np.ndarray],
                             params: Dict) -> Dict[str, np.ndarray]:
        '''
        :param modalities: maps name (rgb / segm / div_segm / mask...) to (C|K, Tv, H, W)
            arrays; rgb uint8 or float.
        :return dict of (C|K, Tc, frame_height, frame_width) arrays. With
            defer_color_jitter, uint8 rgb stays uint8 and params gains the colour keys the
            device applies; without, rgb comes back float32 with the colours applied.
        '''
        rng = np.random.default_rng()
        if '_rng_state' in params:
            rng.bit_generator.state = params['_rng_state']
        out = {}
        for modality, raw in modalities.items():
            if raw.ndim < 4:
                out[modality] = raw.copy()
                continue
            frame_inds_clip = params['frame_inds_clip']
            if len(frame_inds_clip) != self.num_frames_clip:
                raise ValueError(f'{len(frame_inds_clip)} clip frames, '
                                 f'{self.num_frames_clip} expected')
            frames = raw[:, frame_inds_clip]          # (C, Tc, H, W)
            C, T, H, W = frames.shape
            # Only instance-mask stacks may exceed 3 channels (scenes with <= 3 instances
            # have fewer).
            if 'div' not in modality and C > 3:
                raise ValueError(f'{modality} has {C} channels')
            x = frames.transpose(1, 0, 2, 3)          # (T, C, H, W)

            if self.center_crop:
                cur_ar = W / H
                want_ar = self.frame_width / self.frame_height
                if cur_ar > want_ar:
                    cw = int(H * want_ar)
                    x0 = (W - cw) // 2
                    x = x[..., :, x0:x0 + cw]
                elif cur_ar < want_ar:
                    ch = int(W / want_ar)
                    y0 = (H - ch) // 2
                    x = x[..., y0:y0 + ch, :]

            if 'rgb' in modality and self.defer_color_jitter:
                # The host only SAMPLES the colour chain (consuming exactly the draws the
                # host ops would); jitter + blur + grayscale run on the device post-resize.
                if params['color_jitter']:
                    params['jitter_factors'] = sample_jitter_factors(rng)
                if params['rgb_blur']:
                    sigma = float(rng.uniform(0.1, 3.5))
                    # A host blur would run at source resolution before crop/resize; the
                    # device blurs after the resize, so sigma is scaled by the
                    # crop->target ratio to keep the blur strength relative to content.
                    Hc, Wc = x.shape[-2:]
                    ch, cw = Hc, Wc
                    cr = params['crop_rect']
                    if cr is not None and np.all(np.asarray(cr) >= 0.0):
                        y1, y2, x1, x2 = cr
                        ch = max(1, int(y2 * Hc) - int(y1 * Hc))
                        cw = max(1, int(x2 * Wc) - int(x1 * Wc))
                    params['blur_sigmas'] = (sigma * self.frame_height / ch,
                                             sigma * self.frame_width / cw)
            elif 'rgb' in modality:
                # The host colour path, at source resolution before the crop and resize.
                # uint8 input converts to float only when a colour op runs (frame select,
                # crop and flip are index ops that commute with the /255), else just
                # before the resize.
                if x.dtype == np.uint8 and (params['color_jitter'] or params['rgb_blur']
                                            or params['rgb_grayscale']):
                    x = x.astype(np.float32) / 255.0
                if params['color_jitter']:
                    x = color_jitter(x, rng)
                if params['rgb_blur']:
                    x = gaussian_blur(x, rng)
                if params['rgb_grayscale']:
                    x = np.repeat(_rgb_to_gray(x), 3, axis=1)   # (T, 1, H, W) -> (T, 3, H, W)

            if params['horz_flip']:
                x = x[..., ::-1]

            crop_rect = params['crop_rect']
            if crop_rect is not None and np.all(np.asarray(crop_rect) >= 0.0):
                y1, y2, x1, x2 = crop_rect
                Hc, Wc = x.shape[-2:]
                x = x[..., int(y1 * Hc):int(y2 * Hc), int(x1 * Wc):int(x2 * Wc)]

            nearest = ('segm' in modality or 'mask' in modality)
            x = x.transpose(1, 0, 2, 3)               # (C, T, H, W) view
            if 'rgb' in modality and x.dtype == np.uint8 and not self.defer_color_jitter:
                x = x.astype(np.float32)  # the same pixels as converting up front
                x /= 255.0
            out[modality] = resize_frames(x, self.frame_height, self.frame_width, nearest)
        return out
