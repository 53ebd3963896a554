'''
The port's host colour path (tcow_tpu_torch/data/augs.py, --device_augs 0) against
tcow_tpu's on the CPU, bit for bit: color_jitter in all 24 orders of its four
adjustments, the cv2 hue shift and Gaussian blur, the float smooth resize down and up
(cv2.resize in both packages), a training loader batch of the Kubric data path with
--device_augs 0, and with the default --device_augs -1, which colours on the host on the
CPU in both packages.
'''

import itertools

import numpy as np
import pytest

import conftest  # noqa: F401
from tcow_tpu.data import augs as jaugs
from tcow_tpu.data import synthetic as jsyn
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch.data import augs as paugs
from tcow_tpu_torch.data import factory as pfactory


def frames(seed, shape=(4, 3, 20, 28)):
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


@pytest.mark.parametrize('order', list(itertools.permutations(range(4))))
def test_color_jitter_every_order_bit_equal(order):
    factors = dict(fb=1.13, fc=0.86, fs=1.17, fh=-0.07, order=np.array(order, np.int32))
    x = frames(1)
    got = paugs.color_jitter(x, None, factors=factors)
    want = jaugs.color_jitter(x, None, factors=factors)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_color_jitter_draws_as_jax():
    '''Factors drawn from the generator: the same values and the same state after.'''
    x = frames(2)
    rp, rj = np.random.default_rng(11), np.random.default_rng(11)
    np.testing.assert_array_equal(paugs.color_jitter(x, rp), jaugs.color_jitter(x, rj))
    assert rp.bit_generator.state == rj.bit_generator.state


@pytest.mark.parametrize('fh', [-0.1, 0.0, 0.03, 0.1])
def test_shift_hue_bit_equal(fh):
    x = frames(3) * 1.2 - 0.1     # clipped to [0, 1] inside
    np.testing.assert_array_equal(paugs._shift_hue(x, fh), jaugs._shift_hue(x, fh))


@pytest.mark.parametrize('sigma', [None, 0.1, 1.7, 3.5])
def test_gaussian_blur_bit_equal(sigma):
    x = frames(4)
    rp, rj = np.random.default_rng(5), np.random.default_rng(5)
    np.testing.assert_array_equal(paugs.gaussian_blur(x, rp, sigma=sigma),
                                  jaugs.gaussian_blur(x, rj, sigma=sigma))


@pytest.mark.parametrize('size', [(13, 19), (20, 28), (45, 61), (240, 320)])
@pytest.mark.parametrize('channels', [1, 3, 6])
def test_float_resize_bit_equal(size, channels):
    '''Down (INTER_AREA), same size (a copy) and up (INTER_LINEAR), in groups of at most
    4 channels as cv2 takes them.'''
    x = frames(6, (channels, 3, 20, 28))
    got = paugs.resize_frames(x, *size, nearest=False)
    want = jaugs.resize_frames(x, *size, nearest=False)
    assert got.dtype == want.dtype == np.float32 and got.shape == (channels, 3) + size
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope='module')
def kubric_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('kubric_augs')
    jsyn.write_synthetic_kubric_dataset(str(root / 'train'), num_scenes=4, seed=31, T=8,
                                        H=48, W=64, K=4, rich_events=True)
    return str(root)


def train_argv(root, extra):
    return ['--name', '', '--data_path', root, '--batch_size', '2', '--num_queries', '2',
            '--num_frames', '6', '--frame_height', '32', '--frame_width', '48',
            '--kubric_max_delay', '2', '--num_workers', '1', '--seed', '5',
            '--device', 'cpu', '--max_objects', '8', *extra]


def first_batches(root, extra, n=2):
    from tcow_tpu import config as jconfig
    from tcow_tpu.data import factory as jfactory
    argv = train_argv(root, extra)
    out = []
    for config, factory in ((pconfig, pfactory), (jconfig, jfactory)):
        args = config.train_args(argv)
        loader, *_ = factory.create_train_val_data_loaders(args, None)
        loader.set_epoch(0)
        batches = []
        for i, b in enumerate(loader):
            b['meta'].pop('collate_rng_after', None)
            batches.append(b)
            if i + 1 == n:
                break
        out.append(batches)
    return out


def assert_batches_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            assert_batches_equal(got[k], w)
        elif isinstance(w, (np.ndarray, np.generic)):
            assert np.asarray(got[k]).dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize('extra', [['--device_augs', '0'], []],
                         ids=['device_augs_0', 'default_auto'])
def test_training_batches_colour_on_the_host_as_jax(kubric_root, extra):
    '''--device_augs 0, and the default -1 on the CPU: colour applied on the host, the
    batch carries no colour keys, and every array equals the JAX package's.'''
    args = pconfig.train_args(train_argv(kubric_root, extra))
    assert pfactory.kubric_dset_args(args)['device_color_jitter'] is False
    got, want = first_batches(kubric_root, extra)
    for g, w in zip(got, want):
        assert not {'jitter_factors', 'blur_gray'} & set(g['device'])
        assert_batches_equal(g, w)


def test_device_augs_auto_colours_on_the_device_for_cuda(kubric_root):
    args = pconfig.train_args(train_argv(kubric_root, []))
    args.device = 'cuda'
    assert pfactory.kubric_dset_args(args)['device_color_jitter'] is True
    args.device_augs = 0
    assert pfactory.kubric_dset_args(args)['device_color_jitter'] is False
