'''
The port's ResNet-50 (tcow_tpu_torch/models/resnet.py) and utils/misc.py against tcow_tpu
on the CPU in float32.

ResNet: the forward in eval and train mode from one JAX tree (BatchNorm statistics
non-trivial) for 3 and 4 input channels at an odd and an even size, where XLA's 'SAME'
pads asymmetrically (the stride-2 stem and 3x3 convolutions and the -inf max-pool pad
one more after than before on even sizes); train mode leaves the stored statistics
alone; import_torch_resnet50 from a numpy-made torchvision-layout state dict (3 and 5
channels) against JAX's; the JAX-tree bridge both ways. misc: every function against
tcow_tpu.utils.misc.
'''

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.models import resnet as jresnet
from tcow_tpu.utils import misc as jmisc
from tcow_tpu_torch.models import resnet as presnet
from tcow_tpu_torch.utils import misc as pmisc

# Relative L2 error of the features, f32, by mode: the convolutions sum in another order
# through 23 layers (eval measured 8.4e-7); in train mode each BatchNorm also divides by
# the batch's own standard deviation, over only 2 x 3 x 3 samples a channel in layer3, which
# magnifies those differences (measured 4.0e-5).
FEATURE_REL_L2 = {False: 1e-5, True: 1e-4}


def jax_tree(in_channels):
    '''A JAX-layout tree: the port's seeded He-normal convolutions, seeded non-trivial
    BatchNorm entries.'''
    rng = np.random.RandomState(in_channels)

    def bn(c):
        return {'g': (1 + 0.1 * rng.randn(c)).astype(np.float32),
                'b': (0.1 * rng.randn(c)).astype(np.float32),
                'mean': (0.1 * rng.randn(c)).astype(np.float32),
                'var': (1 + 0.2 * rng.rand(c)).astype(np.float32)}

    def fill(t):
        if isinstance(t, list):
            return [fill(v) for v in t]
        if set(t) == {'g', 'b', 'mean', 'var'}:
            return bn(t['g'].shape[0])
        return {k: fill(v) if isinstance(v, (dict, list)) else np.asarray(v)
                for k, v in t.items()}

    model = presnet.DenseResNet(presnet.DenseResNetConfig(in_channels=in_channels))
    model.init_params_(torch.Generator().manual_seed(in_channels))
    return fill(presnet.state_dict_to_jax(model.state_dict()))


def rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize('in_channels,H,W', [(3, 33, 47), (4, 32, 48)])
def test_resnet_forward_matches_jax(in_channels, H, W):
    tree = jax_tree(in_channels)
    jcfg = jresnet.DenseResNetConfig(in_channels=in_channels)
    model = presnet.DenseResNet(presnet.DenseResNetConfig(in_channels=in_channels))
    model.load_state_dict(presnet.state_dict_from_jax(tree))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    x = np.random.RandomState(7).rand(2, in_channels, H, W).astype(np.float32)
    for train in (False, True):
        want = np.asarray(jax.jit(lambda p, x: jresnet.forward(p, jcfg, x, train=train))(
            tree, jnp.asarray(x)))
        with torch.no_grad():
            got = model(torch.from_numpy(x), train=train).numpy()
        assert got.shape == want.shape == (2, 1024, -(-H // 16), -(-W // 16))
        assert rel_l2(got, want) <= FEATURE_REL_L2[train], (train, rel_l2(got, want))
    # Train mode normalised with the batch's moments and updated nothing.
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_same_padding_is_asymmetric_like_xla():
    '''(before, after) of XLA's 'SAME' where torch's symmetric padding differs.'''
    assert presnet._same_pads(240, 7, 2) == (2, 3)     # the stem on an even size
    assert presnet._same_pads(241, 7, 2) == (3, 3)
    assert presnet._same_pads(120, 3, 2) == (0, 1)     # max-pool and strided 3x3
    assert presnet._same_pads(60, 3, 1) == (1, 1)
    assert presnet._same_pads(60, 1, 2) == (0, 0)
    x = torch.arange(16.0).reshape(1, 1, 4, 4) - 100.0
    pooled = torch.nn.functional.max_pool2d(presnet._pad_same(x, 3, 2, float('-inf')), 3, 2)
    want = jax.lax.reduce_window(jnp.asarray(x.numpy()), -jnp.inf, jax.lax.max,
                                 (1, 1, 3, 3), (1, 1, 2, 2), 'SAME')
    np.testing.assert_array_equal(pooled.numpy(), np.asarray(want))


def torchvision_state_dict(rng):
    '''A resnet50 state dict in torchvision's layout, numpy-made (layers 1-3).'''
    sd = collections.OrderedDict()

    def conv(name, o, i, k):
        sd[name] = torch.from_numpy(rng.randn(o, i, k, k).astype(np.float32) * 0.05)

    def bn(prefix, c):
        sd[prefix + '.weight'] = torch.from_numpy(1 + 0.1 * rng.randn(c).astype(np.float32))
        sd[prefix + '.bias'] = torch.from_numpy(0.1 * rng.randn(c).astype(np.float32))
        sd[prefix + '.running_mean'] = torch.from_numpy(0.1 * rng.randn(c).astype(np.float32))
        sd[prefix + '.running_var'] = torch.from_numpy(1 + rng.rand(c).astype(np.float32))
        sd[prefix + '.num_batches_tracked'] = torch.tensor(0)

    conv('conv1.weight', 64, 3, 7)
    bn('bn1', 64)
    cin = 64
    for stage, (n, w) in enumerate(zip(presnet.BLOCK_COUNTS, presnet.STAGE_WIDTHS)):
        for b in range(n):
            pre = f'layer{stage + 1}.{b}'
            conv(pre + '.conv1.weight', w // 4, cin, 1)
            bn(pre + '.bn1', w // 4)
            conv(pre + '.conv2.weight', w // 4, w // 4, 3)
            bn(pre + '.bn2', w // 4)
            conv(pre + '.conv3.weight', w, w // 4, 1)
            bn(pre + '.bn3', w)
            if b == 0:
                conv(pre + '.downsample.0.weight', w, cin, 1)
                bn(pre + '.downsample.1', w)
            cin = w
    return sd


@pytest.mark.parametrize('in_channels', [3, 5])
def test_import_torch_resnet50_matches_jax(in_channels):
    '''The tree bit-equal to JAX's import (first conv tiled and rescaled for 5 channels),
    and the bridge carrying it into the module and back unchanged.'''
    sd = torchvision_state_dict(np.random.RandomState(in_channels))
    want = jresnet.import_torch_resnet50(sd, jresnet.DenseResNetConfig(in_channels=in_channels))
    got = presnet.import_torch_resnet50(sd, presnet.DenseResNetConfig(in_channels=in_channels))
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        assert g.dtype == np.float32, jax.tree_util.keystr(path)
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=jax.tree_util.keystr(path))
    assert got['stem']['conv'].shape == (7, 7, in_channels, 64)
    model = presnet.DenseResNet(presnet.DenseResNetConfig(in_channels=in_channels))
    model.load_state_dict(presnet.state_dict_from_jax(got))
    assert model.stem.conv.shape == (64, in_channels, 7, 7)
    assert torch.equal(model.layers[0][0].bn1.var, sd['layer1.0.bn1.running_var'])
    back = presnet.state_dict_to_jax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(want)
    for w, g in zip(jax.tree.leaves(want), jax.tree.leaves(back)):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_init_params_draws_he_normal_convolutions_and_unit_batchnorm():
    model = presnet.DenseResNet(presnet.DenseResNetConfig(in_channels=4))
    model.init_params_(torch.Generator().manual_seed(0))
    again = presnet.DenseResNet(presnet.DenseResNetConfig(in_channels=4))
    again.init_params_(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                                 again.state_dict().values()))
    w = model.layers[2][0].conv2.detach()
    assert abs(float(w.std()) - np.sqrt(2.0 / (9 * 256))) < 0.05 * np.sqrt(2.0 / (9 * 256))
    bn = model.layers[1][2].bn3
    assert torch.equal(bn.g, torch.ones(512)) and torch.equal(bn.var, torch.ones(512))
    assert not bn.mean.any() and not bn.b.any()
    with torch.no_grad():
        out = model(torch.rand(1, 4, 32, 48))
    assert out.shape == (1, 1024, 2, 3) and torch.isfinite(out).all()


# ---------------------------------------------------------------------------------------
# utils/misc against tcow_tpu.utils.misc
# ---------------------------------------------------------------------------------------

def test_misc_any_value_and_dict_to_numpy():
    d = {'a': None, 'b': 3, 'c': 4}
    assert pmisc.any_value(d) == jmisc.any_value(d) == 3
    assert pmisc.any_value({'a': None}) is jmisc.any_value({'a': None}) is None
    want = jmisc.dict_to_numpy({'a': jnp.ones(3), 'b': [jnp.zeros(2), 5], 'skip': jnp.ones(1)},
                               ignore_keys=['skip'])
    got = pmisc.dict_to_numpy({'a': torch.ones(3), 'b': [torch.zeros(2), 5],
                               'skip': torch.ones(1)}, ignore_keys=['skip'])
    assert set(got) == set(want) == {'a', 'b'} and isinstance(got['b'], list)
    np.testing.assert_array_equal(got['a'], want['a'])
    np.testing.assert_array_equal(got['b'][0], want['b'][0])
    assert got['b'][1] == want['b'][1] == 5 and isinstance(got['a'], np.ndarray)


@pytest.mark.parametrize('x', [np.ones(3), np.array([1.0, np.nan]), np.array([np.inf]),
                               np.zeros((2, 2), np.float32)])
def test_misc_is_nan_or_inf(x):
    assert pmisc.is_nan_or_inf(x) == jmisc.is_nan_or_inf(x)
    assert pmisc.is_nan_or_inf(torch.from_numpy(x)) == jmisc.is_nan_or_inf(x)


def test_misc_traject_to_track_map():
    traj = np.array([[0.1, 0.2], [0.9, 0.9], [1.5, 0.5], [0.0, 0.99]])
    np.testing.assert_array_equal(pmisc.traject_to_track_map(traj, 32, 64, 8),
                                  jmisc.traject_to_track_map(traj, 32, 64, 8))


@pytest.mark.parametrize('num_frequencies,base,top', [(4, 0.1, 10.0), (2, 0.5, 3.0)])
def test_misc_fourier_encoding(num_frequencies, base, top):
    x = np.random.RandomState(0).rand(5, 3).astype(np.float32)
    assert (pmisc.get_fourier_positional_encoding_size(3, num_frequencies)
            == jmisc.get_fourier_positional_encoding_size(3, num_frequencies))
    want = jmisc.apply_fourier_positional_encoding(x, num_frequencies, base, top)
    np.testing.assert_array_equal(
        pmisc.apply_fourier_positional_encoding(x, num_frequencies, base, top), want)
    got = pmisc.apply_fourier_positional_encoding(torch.from_numpy(x), num_frequencies, base,
                                                  top)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_misc_disk_cached_call(tmp_path):
    for misc, name in ((pmisc, 'p'), (jmisc, 'j')):
        calls = []
        fp = str(tmp_path / name / 'c.p')
        f = lambda a: calls.append(a) or a * 2
        assert misc.disk_cached_call(None, fp, None, f, 21) == 42
        assert misc.disk_cached_call(None, fp, None, f, 21) == 42
        assert misc.disk_cached_call(None, fp, 1e18, f, 21) == 42
        assert len(calls) == 2, name


@pytest.mark.parametrize('seed', [0, 1])
def test_misc_calculate_iou(seed):
    rng = np.random.RandomState(seed)
    a, b = rng.rand(8, 8), rng.rand(8, 8)
    assert pmisc.calculate_iou(a, b) == jmisc.calculate_iou(a, b)
    z = np.zeros((4, 4))
    assert np.isnan(pmisc.calculate_iou(z, z)) and np.isnan(jmisc.calculate_iou(z, z))


def test_misc_read_txt_strip_comments(tmp_path):
    fp = tmp_path / 'l.txt'
    fp.write_text('a # one\n\n  b\n# only a comment\nc#\n')
    assert pmisc.read_txt_strip_comments(str(fp)) == jmisc.read_txt_strip_comments(str(fp)) \
        == ['a', 'b', 'c']


@pytest.mark.parametrize('unique,normalize', [(False, None), (True, (0.0, 1.0))])
def test_misc_quick_pca(unique, normalize):
    x = np.random.RandomState(0).rand(6, 7, 8).astype(np.float32)
    x[0, :3] = x[1, :3]
    np.testing.assert_array_equal(pmisc.quick_pca(x, 3, unique, normalize),
                                  jmisc.quick_pca(x, 3, unique, normalize))


@pytest.mark.parametrize('x', [np.arange(6.0).reshape(2, 3), np.float32(2.5),
                               np.array([[-1, 4]], np.int32)])
def test_misc_debug_helpers(x):
    assert pmisc.st(x) == jmisc.st(x)
    assert pmisc.mmm(x) == jmisc.mmm(x)
    assert pmisc.stmmm(x) == jmisc.stmmm(x)
    assert pmisc.mmm(torch.as_tensor(x)) == jmisc.mmm(x)
