'''
The port's boundaries: checkpoints across both packages, the weights bridge, imports
without JAX, device selection, unported configurations, the metrics, and the batched
inference slice (load_networks -> InferenceEngine.run_plugin) against tcow_tpu's on the
CPU.
'''

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import conftest
from tcow_tpu.evaluation import inference as jinf
from tcow_tpu.models import mask_tracker as mt
from tcow_tpu.models import timesformer as tsf
from tcow_tpu.objectives import metrics as jmetrics
from tcow_tpu.objectives.losses import LossConfig
from tcow_tpu.train import checkpoint as jckpt
from tcow_tpu_torch.evaluation import inference as pinf
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.models.seeker import Seeker
from tcow_tpu_torch.objectives import metrics as pmetrics
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

# fp32 tolerance of tests/test_pallas_attention.py:31.
RTOL, ATOL = 2e-4, 2e-5
SEEKER_ARGS = dict(num_total_frames=6, frame_height=32, frame_width=48, patch_size=16,
                   attention_type='divided_space_time', causal_attention=1,
                   norm_embeddings=False, drop_path_rate=0.1, network_depth=2,
                   track_map_stride=4, track_map_resize='bilinear', query_channels=1,
                   output_channels=3, flag_channels=3, tracker_pretrained='0')


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(tsf.DEPTH_PRESETS, 2, (64, 4))
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, 2, (64, 4))


@pytest.fixture
def jax_params(tiny_preset):
    cfg = mt.seeker_config_from_args(SEEKER_ARGS)
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.randn(*a.shape).astype(np.float32),
        mt.init_params(jax.random.key(0), cfg))


def assert_trees_equal(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def test_jax_checkpoint_loads_in_port(tmp_path, jax_params):
    path = jckpt.save_checkpoint(str(tmp_path), epoch=3, name='x', params=jax_params,
                                 train_args={'seed': 1}, seeker_args=SEEKER_ARGS)
    got, want = pckpt.load_checkpoint(path), jckpt.load_checkpoint(path)
    assert_trees_equal(got['params'], want['params'])
    for k in ('epoch', 'name', 'train_args', 'dset_args', 'seeker_args', 'light'):
        assert got[k] == want[k], k


def test_port_checkpoint_loads_in_jax(tmp_path, jax_params):
    path = pckpt.save_checkpoint(str(tmp_path), epoch=5, name='y', params=jax_params,
                                 dset_args={'kubric': {'num_frames': 6}},
                                 seeker_args=SEEKER_ARGS)
    got = jckpt.load_checkpoint(path)
    assert_trees_equal(got['params'], jax_params)
    assert (got['epoch'], got['name'], got['seeker_args']) == (5, 'y', SEEKER_ARGS)
    assert got['dset_args'] == {'kubric': {'num_frames': 6}} and got['light']
    assert jckpt.get_checkpoint_epoch(path) == 5


def test_params_from_jax_round_trips(jax_params, tiny_preset):
    state = params_from_jax(jax_params)
    model = pmt.MaskTracker(pmt.seeker_config_from_args(SEEKER_ARGS))
    assert set(state) == set(model.state_dict())
    assert state['backbone.blocks.1.attn.qkv.w'].shape == (64, 192)
    np.testing.assert_array_equal(state['backbone.blocks.1.attn.qkv.w'].numpy(),
                                  jax_params['backbone']['blocks']['attn']['qkv']['w'][1])
    assert_trees_equal(params_to_jax(state), jax_params)


def test_import_without_jax_or_tcow_tpu():
    '''Every module of the port, chip_smoke.py, train_torch.py, eval_torch.py, the ranks of
    the multi-process tests (tests/test_torch_dp_ranks.py, test_torch_tp_ranks.py,
    test_torch_sp_ranks.py) and every
    tools/torch_*.py import with jax, optax, cv2, PIL, matplotlib and pandas made
    unimportable, and none of them pulls in tcow_tpu.'''
    code = (
        "import importlib, os, pkgutil, sys\n"
        "for m in ('jax', 'optax', 'cv2', 'PIL', 'matplotlib', 'pandas'):\n"
        "    sys.modules[m] = None\n"
        "import tcow_tpu_torch\n"
        "mods = [m.name for m in\n"
        "        pkgutil.walk_packages(tcow_tpu_torch.__path__, 'tcow_tpu_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "named = {'tcow_tpu_torch.' + m for m in ('train.step', 'train.optim',\n"
        "            'train.checkpoint', 'objectives.losses', 'objectives.supervision',\n"
        "            'data.synthetic', 'ops.rope', 'ops.device_augs', 'native',\n"
        "            'data.png', 'data.vis_codec', 'data.geometry', 'data.query_sampling',\n"
        "            'data.data_utils', 'data.augs', 'data.kubric', 'data.factory',\n"
        "            'config', 'utils.logvis', 'train.driver', 'utils.visualization',\n"
        "            'data.plugin', 'evaluation.inference', 'evaluation.test_driver',\n"
        "            'evaluation.pick_represent', 'models.streaming', 'serving',\n"
        "            'models.torch_import', 'models.resnet', 'utils.misc',\n"
        "            'parallel.mesh', 'parallel.tensor', 'parallel.sequence')}\n"
        "assert named <= set(mods), named - set(mods)\n"
        "import chip_smoke, train_torch, eval_torch\n"
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_dp_ranks, test_torch_tp_ranks, test_torch_sp_ranks\n"
        "sys.path.insert(0, 'tools')\n"
        "tools = sorted(f[:-3] for f in os.listdir('tools')\n"
        "               if f.startswith('torch_') and f.endswith('.py'))\n"
        "assert {'torch_serve', 'torch_vitl_probe', 'torch_stream_eval',\n"
        "        'torch_stream_bench', 'torch_serve_bench', 'torch_stream_demo',\n"
        "        'torch_warm_cache', 'torch_validate_dataset',\n"
        "        'torch_profile_item'} <= set(tools), tools\n"
        "for m in tools:\n"
        "    importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'tcow_tpu' or m.startswith('tcow_tpu.')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    out = subprocess.run([sys.executable, '-c', code], cwd=conftest.REPO_ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr


def test_cuda_default_raises_without_cuda(tmp_path, jax_params):
    if torch.cuda.is_available():
        pytest.skip('checks the behaviour on a machine without CUDA')
    path = pckpt.save_checkpoint(str(tmp_path), 0, 'z', jax_params, seeker_args=SEEKER_ARGS)
    cfg = pmt.seeker_config_from_args(SEEKER_ARGS)
    with pytest.raises(RuntimeError, match='CUDA'):
        pinf.load_networks(path)
    with pytest.raises(RuntimeError, match='CUDA'):
        pinf.InferenceEngine(jax_params, cfg)
    with pytest.raises(RuntimeError, match='CUDA'):
        Seeker(cfg, jax_params)


@pytest.mark.parametrize('args', [dict(rope_time_coords=1),
                                  dict(temporal_rope=1, rope_time_coords=1),
                                  dict(attention_type='joint_space_time')])
def test_unported_configs_raise(tiny_preset, args):
    '''rope_time_coords without temporal_rope raises ValueError, as JAX does when it builds
    the backbone config; both rope keys build a config with both fields set, as in JAX;
    joint attention builds the backbone config JAX builds (joint blocks, no temporal
    weights).'''
    full = {**SEEKER_ARGS, **args}
    if 'attention_type' in args:
        bb, jbb = (m.seeker_config_from_args(full).backbone_config() for m in (pmt, mt))
        assert bb.attention_type == jbb.attention_type == 'joint_space_time'
        assert not bb.divided and not jbb.divided
        assert (bb.depth, bb.embed_dim, bb.num_heads, bb.causal_attention) == (
            jbb.depth, jbb.embed_dim, jbb.num_heads, jbb.causal_attention)
        assert not any('temporal' in k for k in pmt.MaskTracker(
            pmt.seeker_config_from_args(full)).state_dict())
    elif 'temporal_rope' in args:
        cfg, jcfg = pmt.seeker_config_from_args(full), mt.seeker_config_from_args(full)
        assert (cfg.temporal_rope, cfg.rope_time_coords) == (True, True)
        assert (jcfg.temporal_rope, jcfg.rope_time_coords) == (True, True)
        assert cfg.backbone_config().temporal_rope
    else:
        with pytest.raises(ValueError, match='rope_time_coords'):
            pmt.seeker_config_from_args(full)
        with pytest.raises(ValueError, match='rope_time_coords'):
            mt.seeker_config_from_args(full).backbone_config()


def random_masks(B, C, T, H, W, seed, unannotated=False):
    rng = np.random.RandomState(seed)
    out = rng.randn(B, 1, 3, T, H, W).astype(np.float32)
    tgt = (rng.rand(B, 1, C, T, H, W) > 0.6).astype(np.float32)
    tgt[:, :, :, 1] = 0.0                                    # empty frame
    if unannotated:
        tgt[:, :, :, -2:] = -1.0                             # unannotated frames
    return out, tgt


@pytest.mark.parametrize('C,unannotated', [(3, True), (3, False), (1, True)])
def test_metrics_match_jax(C, unannotated):
    outs, tgts = random_masks(2, C, 7, 12, 16, seed=C, unannotated=unannotated)
    want = jmetrics.mask_track_metric_sums(outs, tgts)
    got = pmetrics.mask_track_metric_sums(torch.from_numpy(outs), torch.from_numpy(tgts))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)
    jfin, pfin = jmetrics.finalize_metric_sums(want), pmetrics.finalize_metric_sums(got)
    assert set(jfin) == set(pfin)
    for k in jfin:
        np.testing.assert_allclose(pfin[k], jfin[k], rtol=1e-6, err_msg=k)
    many = [pfin, pmetrics.finalize_metric_sums(pmetrics.mask_track_metric_sums(
        *map(torch.from_numpy, random_masks(1, 3, 5, 12, 16, seed=9))))]
    for fn in ('calculate_weighted_averages', 'calculate_unweighted_averages'):
        a, b = getattr(jmetrics, fn)(many), getattr(pmetrics, fn)(many)
        assert a.keys() == b.keys()
        np.testing.assert_allclose([b[k] for k in b], [a[k] for k in a], rtol=1e-12)


def plugin_inputs(B=2, T=6, seed=0):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(B, 3, T, 32, 48).astype(np.float32)
    query = np.zeros((B, 1, T, 32, 48), np.float32)
    query[:, :, 0, 8:20, 12:30] = 1.0
    target = (rng.rand(B, 3, T, 32, 48) > 0.7).astype(np.float32)
    target[:, :, 0] = 0.0
    target[:, :, -1] = -1.0
    return rgb, query, target


def test_inference_slice_matches_jax_on_cpu(tmp_path, jax_params):
    '''load_networks -> InferenceEngine.run_plugin on the CPU, against tcow_tpu's engine on
    the same checkpoint: outputs and metrics agree, and no kernel launch is counted.'''
    path = pckpt.save_checkpoint(str(tmp_path), 2, 'e', jax_params, seeker_args=SEEKER_ARGS)
    params, cfg, _, _, seeker_args, epoch = pinf.load_networks(str(tmp_path), device='cpu')
    assert (epoch, seeker_args) == (2, SEEKER_ARGS)
    rgb, query, target = plugin_inputs()
    before = fa.fused_attention.launches
    got = pinf.InferenceEngine(params, cfg, device='cpu').run_plugin(rgb, query, target)
    assert fa.fused_attention.launches == before

    jparams, jcfg, *_ = jinf.load_networks(path, None)
    want = jinf.InferenceEngine(jparams, jcfg, LossConfig(), num_queries=1).run_plugin(
        rgb, query, target)
    assert len(got) == len(want) == 2
    for (gm, gl), (wm, wl) in zip(got, want):
        assert gm.keys() == wm.keys()
        for k in ('seeker_input', 'target_mask', 'seeker_query_mask'):
            np.testing.assert_array_equal(gm[k], wm[k])
        np.testing.assert_allclose(gm['output_mask'], wm['output_mask'], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(gm['output_flags'], wm['output_flags'], rtol=RTOL, atol=ATOL)
        assert gl['metrics'].keys() == wl['metrics'].keys()
        for k in wl['metrics']:
            np.testing.assert_allclose(gl['metrics'][k], wl['metrics'][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_seeker_facade_on_cpu(tmp_path, jax_params):
    path = pckpt.save_checkpoint(str(tmp_path), 0, 's', jax_params, seeker_args=SEEKER_ARGS)
    rgb, query, _ = plugin_inputs(B=1, seed=3)
    mask, flags = Seeker.from_checkpoint(path, device='cpu')(rgb, query)
    want_mask, want_flags = mt.forward(jax_params, mt.seeker_config_from_args(SEEKER_ARGS),
                                       rgb, query)
    np.testing.assert_allclose(mask.numpy(), np.asarray(want_mask), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(flags.numpy(), np.asarray(want_flags), rtol=RTOL, atol=ATOL)
    fresh = Seeker.from_seeker_args(SEEKER_ARGS, seed=7, device='cpu')
    assert fresh(rgb, query)[0].shape == (1, 3, 6, 32, 48)
    with pytest.raises(FileNotFoundError):
        Seeker.from_checkpoint(str(tmp_path / 'absent.pth'), device='cpu')


@pytest.mark.parametrize('entry', ['from_checkpoint', 'from_seeker_args', 'engine'])
def test_entry_points_route_attention_through_fused_attention(tmp_path, jax_params,
                                                              monkeypatch, entry):
    '''Every entry point sends each attention call to ops.fused_attention, which picks the
    kernel on CUDA: 2 calls per block and forward, and no launch counted on the CPU.'''
    calls = []

    def counting(*args):
        calls.append(args[0].shape)
        return fa.fused_attention(*args)

    monkeypatch.setattr(ptsf, 'fused_attention', counting)
    rgb, query, target = plugin_inputs(B=1, seed=4)
    before = fa.fused_attention.launches
    if entry == 'from_checkpoint':
        path = pckpt.save_checkpoint(str(tmp_path), 0, 'r', jax_params, seeker_args=SEEKER_ARGS)
        Seeker.from_checkpoint(path, device='cpu')(rgb, query)
    elif entry == 'from_seeker_args':
        Seeker.from_seeker_args(SEEKER_ARGS, seed=1, device='cpu')(rgb, query)
    else:
        cfg = pmt.seeker_config_from_args(SEEKER_ARGS)
        pinf.InferenceEngine(jax_params, cfg, device='cpu').run_plugin(rgb, query, target)
    assert len(calls) == 2 * SEEKER_ARGS['network_depth']
    assert calls[0] == (6, 6, 64) and calls[1] == (6, 7, 64)   # temporal, spatial with cls
    assert fa.fused_attention.launches == before
