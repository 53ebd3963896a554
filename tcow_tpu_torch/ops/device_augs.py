'''
On-device colour augmentation: the port of tcow_tpu/ops/device_augs.py (:25-146).

The host samples only the per-example factors (data/synthetic.py:synthetic_color_augs
draws them as the JAX package's loader does); the pixel work runs on the batch's device
inside the train step's unpacking (train/step.py:unpack_batch), jitter first, then blur
and grayscale. Plain torch ops on (B, 3, T, H, W) float32 in [0, 1], with every choice
made per example by a mask, so nothing is read back to the host: the four jitter
positions each evaluate the four adjustments and keep the one the example's order names.
'''

import torch
import torch.nn.functional as F

# ITU-R 601 luma weights (device_augs.py:64-68).
_GRAY = (0.299, 0.587, 0.114)


def _per_example(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    '''(B,) -> (B, 1, ..., 1) broadcastable against `like`.'''
    return v.reshape(v.shape + (1,) * (like.dim() - 1))


def _gray(x: torch.Tensor) -> torch.Tensor:
    '''(B, 3, T, H, W) -> (B, 1, T, H, W).'''
    return (_GRAY[0] * x[:, 0] + _GRAY[1] * x[:, 1] + _GRAY[2] * x[:, 2])[:, None]


def _rgb_to_hsv(x: torch.Tensor):
    '''(B, 3, ...) in [0, 1] -> h, s, v each (B, ...) (device_augs.py:25-40).'''
    r, g, b = x[:, 0], x[:, 1], x[:, 2]
    mx = x.amax(dim=1)
    mn = x.amin(dim=1)
    diff = mx - mn
    safe = torch.where(diff > 0, diff, torch.ones_like(diff))
    rc, gc, bc = (mx - r) / safe, (mx - g) / safe, (mx - b) / safe
    h = torch.where(mx == r, bc - gc, torch.where(mx == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(diff > 0, torch.remainder(h / 6.0, 1.0), torch.zeros_like(h))
    s = torch.where(mx > 0, diff / torch.where(mx > 0, mx, torch.ones_like(mx)),
                    torch.zeros_like(mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v) -> torch.Tensor:
    '''h, s, v (B, ...) -> (B, 3, ...) (device_augs.py:43-54).'''
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i = torch.remainder(i.to(torch.int32), 6)

    def select(*vals):
        out = vals[5]
        for k in range(4, -1, -1):
            out = torch.where(i == k, vals[k], out)
        return out

    return torch.stack([select(v, q, p, p, t, v), select(t, v, v, q, p, p),
                        select(p, p, t, v, v, q)], dim=1)


def _brightness(x, f):
    return torch.clamp(x * f, 0.0, 1.0)


def _contrast(x, f):
    mean = _gray(x).mean(dim=(-2, -1), keepdim=True)   # per frame (B, 1, T, 1, 1)
    return torch.clamp(x * f + mean * (1.0 - f), 0.0, 1.0)


def _saturation(x, f):
    return torch.clamp(x * f + _gray(x) * (1.0 - f), 0.0, 1.0)


def _hue(x, f):
    h, s, v = _rgb_to_hsv(torch.clamp(x, 0.0, 1.0))
    return _hsv_to_rgb(torch.remainder(h + f[:, 0], 1.0), s, v)


_ADJUSTMENTS = (_brightness, _contrast, _saturation, _hue)


def apply_color_jitter(rgb: torch.Tensor, factors: torch.Tensor,
                       order: torch.Tensor) -> torch.Tensor:
    '''torchvision ColorJitter semantics per example (device_augs.py:89-104).

    :param rgb (B, 3, T, H, W) float32 in [0, 1].
    :param factors (B, 5) float32: (brightness, contrast, saturation, hue, apply); an
        example is jittered only when apply > 0.5.
    :param order (B, 4) int: the example's order of the adjustments (0 brightness,
        1 contrast, 2 saturation, 3 hue).
    :return (B, 3, T, H, W) float32.
    '''
    factors = factors.to(device=rgb.device, dtype=torch.float32)
    order = order.to(rgb.device)
    x = rgb
    for j in range(4):
        out = x
        for k, adjust in enumerate(_ADJUSTMENTS):
            f = _per_example(factors[:, k], x)
            out = torch.where(_per_example(order[:, j] == k, x), adjust(x, f), out)
        x = out
    return torch.where(_per_example(factors[:, 4] > 0.5, rgb), x, rgb)


def _gauss5(sigma: torch.Tensor) -> torch.Tensor:
    '''(B,) sigmas -> (B, 5) normalised taps, cv2.getGaussianKernel(5, sigma) semantics
    (device_augs.py:107-112).'''
    d = torch.arange(5, dtype=torch.float32, device=sigma.device) - 2.0
    w = torch.exp(-(d * d) / (2.0 * sigma[:, None] * sigma[:, None]))
    return w / w.sum(dim=1, keepdim=True)


def _blur5(x: torch.Tensor, wy: torch.Tensor, wx: torch.Tensor) -> torch.Tensor:
    '''Separable 5x5 gaussian of (B, 3, T, H, W) with per-example taps (B, 5) and
    reflect-101 borders (F.pad 'reflect', as jnp.pad mode='reflect'; device_augs.py:115-
    122).'''
    B, C, T, H, W = x.shape
    flat = lambda t: t.reshape(B * C, T, t.shape[-2], t.shape[-1])
    xp = F.pad(flat(x), (0, 0, 2, 2), mode='reflect').reshape(B, C, T, H + 4, W)
    x = sum(_per_example(wy[:, i], x) * xp[..., i:i + H, :] for i in range(5))
    xp = F.pad(flat(x), (2, 2, 0, 0), mode='reflect').reshape(B, C, T, H, W + 4)
    return sum(_per_example(wx[:, i], x) * xp[..., :, i:i + W] for i in range(5))


def apply_blur_gray(rgb: torch.Tensor, blur_gray: torch.Tensor) -> torch.Tensor:
    '''Gaussian blur, then grayscale, per example (device_augs.py:125-146); called after
    apply_color_jitter.

    :param rgb (B, 3, T, H, W) float32 in [0, 1].
    :param blur_gray (B, 3) float32: (sigma_y, sigma_x, grayscale); sigma_y <= 0 means no
        blur, grayscale > 0.5 replaces the three channels by the luma.
    :return (B, 3, T, H, W) float32.
    '''
    blur_gray = blur_gray.to(device=rgb.device, dtype=torch.float32)
    sy, sx, g = blur_gray[:, 0], blur_gray[:, 1], blur_gray[:, 2]
    wy = _gauss5(torch.where(sy > 0, sy, torch.ones_like(sy)))
    wx = _gauss5(torch.where(sx > 0, sx, torch.ones_like(sx)))
    r = torch.where(_per_example(sy > 0, rgb), _blur5(rgb, wy, wx), rgb)
    return torch.where(_per_example(g > 0.5, r), _gray(r).expand_as(r), r)
