'''
The port's on-device colour augmentations (tcow_tpu_torch/ops/device_augs.py) against
tcow_tpu/ops/device_augs.py on the CPU in float32: the jitter under all 24 orders of its
four adjustments, each adjustment alone, the per-example apply flag, the blur with
sigma <= 0 (off) and > 0, grayscale, and the two applied in turn by unpack_batch; and
the port's seeded sampler of the colour keys.
'''

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.ops import device_augs as jaugs
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.data import synthetic as psyn
from tcow_tpu_torch.ops import device_augs as paugs
from tcow_tpu_torch.train import step as pstep

# f32 on the CPU: the two implementations round the same operations, in places in another
# order (the luma's sum, the blur's taps), and hue goes through HSV and back.
ATOL = 1e-5
ORDERS = np.array(list(itertools.permutations(range(4))), np.int32)   # (24, 4)


def clips(B, seed=0, T=2, H=12, W=10):
    '''(B, 3, T, H, W) f32 in [0, 1] with grey pixels (equal channels), pixels whose
    maximum is shared by two channels, and black and white ones, where HSV branches.'''
    rng = np.random.RandomState(seed)
    x = rng.rand(B, 3, T, H, W).astype(np.float32)
    x[:, :, :, 0, :] = x[:, :1, :, 0, :]            # grey row
    x[:, 1, :, 1, :] = x[:, 0, :, 1, :]             # r == g
    x[:, 2, :, 2, :] = x[:, 1, :, 2, :]             # g == b
    x[:, :, :, 3, :3] = 0.0
    x[:, :, :, 3, 3:6] = 1.0
    return x


def jitter_factors(B, seed=1):
    rng = np.random.RandomState(seed)
    f = np.stack([rng.uniform(0.8, 1.2, B), rng.uniform(0.8, 1.2, B),
                  rng.uniform(0.8, 1.2, B), rng.uniform(-0.1, 0.1, B), np.ones(B)], axis=1)
    return f.astype(np.float32)


def both_jitters(x, f, o):
    want = np.asarray(jaugs.apply_color_jitter(jnp.asarray(x), jnp.asarray(f), jnp.asarray(o)))
    got = paugs.apply_color_jitter(torch.from_numpy(x), torch.from_numpy(f),
                                   torch.from_numpy(o)).numpy()
    return got, want


def test_color_jitter_matches_jax_in_every_order():
    '''24 examples, one order each; the apply flag off on two of them leaves them as
    they were.'''
    x, f = clips(24), jitter_factors(24)
    f[[3, 17], 4] = 0.0
    got, want = both_jitters(x, f, ORDERS)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got[[3, 17]], x[[3, 17]])
    assert np.abs(got - x).max() > 0.05


@pytest.mark.parametrize('adjustment', range(4))
def test_each_adjustment_alone_matches_jax(adjustment):
    '''One adjustment away from its neutral value (brightness, contrast, saturation 1,
    hue 0), the others neutral: a strong factor per example on either side.'''
    x = clips(4, seed=2)
    f = np.tile(np.array([1, 1, 1, 0, 1], np.float32), (4, 1))
    f[:, adjustment] = ([0.3, 0.9, 1.1, 1.7] if adjustment < 3 else [-0.5, -0.05, 0.05, 0.5])
    o = np.tile(np.roll(np.arange(4, dtype=np.int32), -adjustment), (4, 1))
    got, want = both_jitters(x, f, o)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize('sigmas,gray', [
    ([(1.0, 1.0), (0.1, 3.5), (3.5, 0.2)], 0.0),      # blur on every example
    ([(0.0, 2.0), (-1.0, 1.0), (2.0, 0.0)], 0.0),     # sigma_y <= 0: off; sigma_x 0: 1.0
    ([(0.0, 0.0), (1.5, 2.5), (0.0, 0.0)], 1.0),      # grayscale, after the blur
])
def test_blur_gray_matches_jax(sigmas, gray):
    x = clips(3, seed=3, H=9, W=7)
    bg = np.array([(sy, sx, gray if i != 1 else 0.0) for i, (sy, sx) in enumerate(sigmas)],
                  np.float32)
    want = np.asarray(jaugs.apply_blur_gray(jnp.asarray(x), jnp.asarray(bg)))
    got = paugs.apply_blur_gray(torch.from_numpy(x), torch.from_numpy(bg)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    for i, (sy, _) in enumerate(sigmas):
        if sy <= 0 and bg[i, 2] <= 0.5:
            np.testing.assert_array_equal(got[i], x[i])
        if bg[i, 2] > 0.5:
            np.testing.assert_array_equal(got[i, 0], got[i, 2])


def test_unpack_batch_applies_jitter_then_blur_like_jax():
    '''The whole colour chain from a uint8 clip, as both packages unpack a batch.'''
    x = clips(4, seed=4)
    keys = psyn.synthetic_color_augs(5, 4, jitter=[1, 1, 0, 1], blur=[1, 0, 1, 0],
                                     gray=[0, 1, 0, 0])
    batch = {'rgb_u8': np.round(x * 255).astype(np.uint8), **keys}
    want = jstep.unpack_batch({k: jnp.asarray(v) for k, v in batch.items()})
    got = pstep.unpack_batch(batch, 'cpu')
    assert set(got) == set(want) == {'rgb'}
    np.testing.assert_allclose(got['rgb'].numpy(), np.asarray(want['rgb']), rtol=0, atol=ATOL)


def test_synthetic_color_augs_lay_out_keys_as_the_loader():
    '''Forced outcomes per clip; clips without jitter carry the no-op factors and the
    identity order, clips without blur sigma 0; the same seed gives the same draws.'''
    keys = psyn.synthetic_color_augs(0, 3, jitter=[1, 0, 1], blur=[0, 1, 0], gray=[0, 0, 1])
    f, o, bg = keys['jitter_factors'], keys['jitter_order'], keys['blur_gray']
    assert f.shape == (3, 5) and o.shape == (3, 4) and bg.shape == (3, 3)
    assert f.dtype == bg.dtype == np.float32 and o.dtype == np.int32
    np.testing.assert_array_equal(f[1], [1, 1, 1, 0, 0])
    np.testing.assert_array_equal(o[1], np.arange(4))
    assert f[0, 4] == f[2, 4] == 1.0 and sorted(o[0]) == [0, 1, 2, 3]
    assert np.all(np.abs(f[[0, 2], :3] - 1) <= 0.2) and np.all(np.abs(f[[0, 2], 3]) <= 0.1)
    assert bg[1, 0] == bg[1, 1] and 0.1 <= bg[1, 0] <= 3.5 and bg[0, 0] == bg[2, 0] == 0.0
    np.testing.assert_array_equal(bg[:, 2], [0, 0, 1])
    again = psyn.synthetic_color_augs(0, 3, jitter=[1, 0, 1], blur=[0, 1, 0], gray=[0, 0, 1])
    for k in keys:
        np.testing.assert_array_equal(again[k], keys[k])
    drawn = psyn.synthetic_color_augs(7, 200)
    assert 0.8 < drawn['jitter_factors'][:, 4].mean() < 0.97
    assert 0.1 < (drawn['blur_gray'][:, 0] > 0).mean() < 0.3
