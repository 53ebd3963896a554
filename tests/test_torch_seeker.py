'''
Port backbone and seeker (tcow_tpu_torch.models) against tcow_tpu.models on the CPU in
float32, from the same weights (JAX init_params, perturbed so that every bias and norm
matters, carried over with weights.params_from_jax) and the same numpy inputs.
'''

import dataclasses

import jax
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.models import mask_tracker as mt
from tcow_tpu.models import timesformer as tsf
from tcow_tpu.ops import pallas_attention as pa
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

# fp32 tolerance of tests/test_pallas_attention.py:31.
RTOL, ATOL = 2e-4, 2e-5
TINY = dict(frame_height=32, frame_width=48, patch_size=16)


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(tsf.DEPTH_PRESETS, 2, (64, 4))
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, 2, (64, 4))


def perturbed(params, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.randn(*a.shape).astype(np.float32),
        params)


def backbone_pair(ca, seed=0, **kw):
    common = dict(TINY, in_channels=4, num_frames=6, depth=2, embed_dim=64, num_heads=4,
                  causal_attention=ca, **kw)
    jcfg = tsf.TimeSformerConfig(drop_path_rate=0.0, **common)
    params = perturbed(tsf.init_params(jax.random.key(seed), jcfg), seed)
    model = ptsf.TimeSformer(ptsf.TimeSformerConfig(**common))
    model.load_state_dict(params_from_jax(params))
    return jcfg, params, model


def run_port(model, *arrays):
    with torch.inference_mode():
        return [None if o is None else o.numpy()
                for o in model(*(torch.from_numpy(a) for a in arrays))]


@pytest.mark.parametrize('ca,kw', [(0, {}), (1, {}), (3, {}), (-1, {}),
                                   (1, dict(norm_embeddings=True, normalize_inputs=True))])
def test_backbone_matches_jax(ca, kw):
    jcfg, params, model = backbone_pair(ca, **kw)
    x = np.random.RandomState(1).rand(2, 4, 6, 32, 48).astype(np.float32)
    feats, cls = tsf.forward(params, jcfg, x)
    got_feats, got_cls = run_port(model, x)
    assert got_feats.shape == (2, 64, 6, 2, 3)
    np.testing.assert_allclose(got_feats, np.asarray(feats), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_cls, np.asarray(cls), rtol=RTOL, atol=ATOL)


def test_backbone_resized_embeddings_match_jax():
    '''Frames larger and clips shorter than the config: pos/time embeddings are resized.'''
    jcfg, params, model = backbone_pair(1, seed=2)
    x = np.random.RandomState(3).rand(1, 4, 4, 48, 64).astype(np.float32)
    feats, cls = tsf.forward(params, jcfg, x)
    got_feats, got_cls = run_port(model, x)
    np.testing.assert_allclose(got_feats, np.asarray(feats), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_cls, np.asarray(cls), rtol=RTOL, atol=ATOL)


def test_backbone_matches_jax_pallas_interpret():
    '''JAX through the Pallas kernel (interpret mode), the port through fused_attention.'''
    jcfg, params, model = backbone_pair(1, seed=4)
    jcfg = dataclasses.replace(jcfg, use_pallas_attention=True)
    x = np.random.RandomState(5).rand(2, 4, 6, 32, 48).astype(np.float32)
    old = pa.INTERPRET
    pa.INTERPRET = True
    try:
        feats, cls = tsf.forward(params, jcfg, x)
    finally:
        pa.INTERPRET = old
    got_feats, got_cls = run_port(model, x)
    np.testing.assert_allclose(got_feats, np.asarray(feats), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_cls, np.asarray(cls), rtol=RTOL, atol=ATOL)


def seeker_inputs(B=2, T=6, seed=0):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(B, 3, T, 32, 48).astype(np.float32)
    query = np.zeros((B, 1, T, 32, 48), np.float32)
    query[:, :, 0, 8:20, 12:30] = 1.0
    return rgb, query


def seeker_pair(seed=0, **kw):
    common = {**TINY, 'num_total_frames': 6, 'network_depth': 2, 'causal_attention': 1, **kw}
    jcfg = mt.SeekerConfig(drop_path_rate=0.0, **common)
    params = perturbed(mt.init_params(jax.random.key(seed), jcfg), seed)
    model = pmt.MaskTracker(pmt.SeekerConfig(**common))
    model.load_state_dict(params_from_jax(params))
    return jcfg, params, model


@pytest.mark.parametrize('mode', ['bilinear', 'nearest'])
def test_seeker_masks_and_flags_match_jax(tiny_preset, mode):
    jcfg, params, model = seeker_pair(track_map_resize=mode)
    rgb, query = seeker_inputs()
    mask, flags = mt.forward(params, jcfg, rgb, query)
    got_mask, got_flags = run_port(model, rgb, query)
    assert got_mask.shape == (2, 3, 6, 32, 48) and got_flags.shape == (2, 6, 3)
    np.testing.assert_allclose(got_mask, np.asarray(mask), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_flags, np.asarray(flags), rtol=RTOL, atol=ATOL)


def test_seeker_without_flag_head(tiny_preset):
    jcfg, params, model = seeker_pair(seed=1, flag_channels=0, causal_attention=0)
    rgb, query = seeker_inputs(seed=1)
    mask, flags = mt.forward(params, jcfg, rgb, query)
    got_mask, got_flags = run_port(model, rgb, query)
    assert flags is None and got_flags is None
    np.testing.assert_allclose(got_mask, np.asarray(mask), rtol=RTOL, atol=ATOL)


def test_seeker_config_from_args_matches_jax():
    args = dict(num_total_frames=12, frame_height=96, frame_width=128, causal_attention=3,
                norm_embeddings=True, network_depth=18, track_map_stride=2,
                track_map_resize='nearest', flag_channels=0, tracker_pretrained='yes')
    j, p = mt.seeker_config_from_args(args), pmt.seeker_config_from_args(args)
    for f in dataclasses.fields(p):
        if f.name != 'compute_dtype':
            assert getattr(p, f.name) == getattr(j, f.name), f.name
    assert p.backbone_config().embed_dim == j.backbone_config().embed_dim == 896


def test_init_params_matches_jax_statistics():
    '''Seeded init of the port: same leaves and shapes as the JAX tree, trunc-normal
    std 0.02 within +-2 sigma, zero biases, unit norms, temporal_fc zero past block 0.'''
    cfg = pmt.SeekerConfig(**TINY, num_total_frames=6, network_depth=12)
    model = pmt.MaskTracker(cfg)
    model.init_params_(torch.Generator().manual_seed(0))
    tree = params_to_jax(model.state_dict())
    jtree = jax.eval_shape(lambda: mt.init_params(jax.random.key(0), mt.SeekerConfig(
        **TINY, num_total_frames=6, network_depth=12)))
    assert (jax.tree.map(lambda a: a.shape, jtree)
            == jax.tree.map(lambda a: a.shape, tree))
    w = tree['backbone']['blocks']['mlp']['fc1']['w']
    assert abs(w.std() - 0.02 * 0.8796) < 5e-4 and np.abs(w).max() <= 0.04
    assert not tree['backbone']['blocks']['attn']['qkv']['b'].any()
    assert (tree['backbone']['blocks']['norm2']['g'] == 1).all()
    tfc = tree['backbone']['blocks']['temporal_fc']['w']
    assert tfc[0].any() and not tfc[1:].any()
