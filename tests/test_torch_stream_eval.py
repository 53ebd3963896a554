'''
The port's streaming evaluation against tcow_tpu's on the CPU in float32 (the preset of
tests/test_streaming.py: depth 3 at width 48 with 4 heads, T = 6 at 32x48, causal 1,
temporal_fc non-zero): PluginVideoDataset.get_streaming_example on a short synthetic plugin
video (a directory of 24 frames at 48x72 with timestamped masks), InferenceEngine.
run_plugin_stream through a window of 4 frames, and the test driver under
--stream_window (eval_torch.py against tcow_tpu's test_driver.main): one CSV row, the
friendly name with frame stride 0, the numbers and the overlay videos.
'''

import csv
import os
import types

import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.data import plugin as jplugin
from tcow_tpu_torch.data import plugin as pplugin

RTOL, ATOL = 2e-4, 2e-5      # fp32, tests/test_streaming.py
METRIC_RTOL = 1e-6
WINDOW = 4
FRAMES, VH, VW = 24, 48, 72
SEEKER_ARGS = dict(num_total_frames=6, frame_height=32, frame_width=48, patch_size=16,
                   attention_type='divided_space_time', causal_attention=1,
                   norm_embeddings=False, drop_path_rate=0.0, network_depth=3,
                   track_map_stride=4, track_map_resize='bilinear', query_channels=1,
                   output_channels=3, flag_channels=3, tracker_pretrained='0')
DSET_ARGS = dict(num_frames=6, frame_height=32, frame_width=48, frame_rate=12,
                 frame_stride=1, max_delay=2, use_data_frac=1.0, augs_2d=True,
                 num_queries=1, query_time=0.2, max_objects=6, front_occl_thres=0.95,
                 outer_cont_thres=0.75, reverse_prob=0.1, palindrome_prob=0.1)
PLUGIN_KW = dict(num_clip_frames=6, frame_height=32, frame_width=48, frame_rate=30,
                 prefer_frame_stride=3, query_time=0.2, annots_must_exist=False,
                 prefetch=True, center_crop=True)
# Timestamped masks of the synthetic video: the query at frame 2 and targets after it
# (frame 20 holds both occluder and container, as a _contoccl file).
MASKS = {'query': (2,), 'snitch': (5, 11, 20), 'occl': (11,), 'cont': (16,),
         'contoccl': (20,)}


@pytest.fixture(scope='module')
def presets():
    from tcow_tpu.models import timesformer as jtsf
    from tcow_tpu_torch.models import timesformer as ptsf
    old = dict(jtsf.DEPTH_PRESETS), dict(ptsf.DEPTH_PRESETS)
    jtsf.DEPTH_PRESETS[3] = ptsf.DEPTH_PRESETS[3] = (48, 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for presets_, saved in zip((jtsf.DEPTH_PRESETS, ptsf.DEPTH_PRESETS), old):
        presets_.clear()
        presets_.update(saved)


@pytest.fixture(scope='module')
def plugin_video(tmp_path_factory):
    '''A directory of FRAMES PNG frames (a bright square moving over noise) with the
    timestamped masks of MASKS, as a plugin video directory holds them.'''
    import cv2
    root = tmp_path_factory.mktemp('plugin_stream') / 'vid'
    root.mkdir()
    rng = np.random.RandomState(5)
    for t in range(FRAMES):
        frame = rng.randint(0, 120, size=(VH, VW, 3)).astype(np.uint8)
        x0 = 4 + 2 * t
        frame[12:30, x0:x0 + 18] = (230, 200, 40)
        cv2.imwrite(str(root / f'frame_{t:04d}.png'), frame)
    for name, ts in MASKS.items():
        for t in ts:
            m = np.zeros((VH, VW), np.uint8)
            x0 = 4 + 2 * t
            m[12:30, x0:x0 + 18] = 255
            cv2.imwrite(str(root / f'vid_{t}_{name}.png'), m)
    return str(root)


@pytest.fixture(scope='module')
def ckpt_root(tmp_path_factory, presets):
    '''The JAX checkpoint of the tiny streaming seeker, temporal_fc non-zero.'''
    import jax
    from tcow_tpu.models import mask_tracker
    from tcow_tpu.models.mask_tracker import seeker_config_from_args
    from tcow_tpu.train import checkpoint as jckpt
    root = tmp_path_factory.mktemp('ckpts_stream')
    params = mask_tracker.init_params(jax.random.key(0), seeker_config_from_args(SEEKER_ARGS))
    params['backbone']['blocks']['temporal_fc']['w'] = jax.random.normal(
        jax.random.key(7), params['backbone']['blocks']['temporal_fc']['w'].shape) * 0.05
    jckpt.save_checkpoint(os.path.join(str(root), 'tst1'), epoch=0, name='tst1',
                          params=params, train_args={'seed': 900, 'num_frames': 6},
                          dset_args={'kubric': DSET_ARGS}, seeker_args=SEEKER_ARGS)
    return str(root)


def test_streaming_example_matches_jax(plugin_video):
    '''Every frame from the query on, resized to 32x48, the query at position 0, sparse
    targets and the annotated positions: bit-equal to the JAX package's.'''
    want = jplugin.PluginVideoDataset(plugin_video, None, 'test', **PLUGIN_KW)
    got = pplugin.PluginVideoDataset(plugin_video, None, 'test', **PLUGIN_KW)
    want, got = want.get_streaming_example(), got.get_streaming_example()
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k
    assert got['rgb'].shape == (3, FRAMES - 2, 32, 48)
    assert got['annotated_inds'].tolist() == [3, 9, 14, 18]


def test_run_plugin_stream_matches_jax(ckpt_root, plugin_video, presets):
    '''22 frames through a window of 4 (the ring wraps, and frames pass the trained
    horizon of 6): the masks and flags at the annotated frames, the arrays that go with
    them and the metrics; a non-causal engine and an example without annotations raise.'''
    import dataclasses
    from tcow_tpu.evaluation import inference as jinf
    from tcow_tpu.objectives.losses import LossConfig as JLossConfig
    from tcow_tpu_torch.evaluation import inference as pinf
    path = os.path.join(ckpt_root, 'tst1')
    jparams, jcfg, *_ = jinf.load_networks(path, None)
    pparams, pcfg, *_ = pinf.load_networks(path, None, compute_dtype=torch.float32,
                                           device='cpu')
    ex = pplugin.PluginVideoDataset(plugin_video, None, 'test',
                                    **PLUGIN_KW).get_streaming_example()
    wm, wl = jinf.InferenceEngine(jparams, jcfg, JLossConfig(), 1).run_plugin_stream(
        ex, window=WINDOW)
    engine = pinf.InferenceEngine(pparams, pcfg, device='cpu')
    gm, gl = engine.run_plugin_stream(ex, window=WINDOW)
    assert set(gm) == set(wm)
    for k in ('seeker_input', 'target_mask', 'seeker_query_mask', 'annotated_inds'):
        np.testing.assert_array_equal(gm[k], wm[k], err_msg=k)
    for k in ('output_mask', 'output_flags'):
        assert gm[k].shape == np.asarray(wm[k]).shape, k
        np.testing.assert_allclose(gm[k], wm[k], rtol=RTOL, atol=ATOL, err_msg=k)
    assert gm['output_mask'].shape == (1, 3, 4, 32, 48)
    assert set(gl['metrics']) == set(wl['metrics'])
    for k, w in wl['metrics'].items():
        np.testing.assert_allclose(gl['metrics'][k], w, rtol=METRIC_RTOL, err_msg=k)
    with pytest.raises(ValueError, match='at least one annotated'):
        engine.run_plugin_stream(dict(ex, annotated_inds=np.zeros(0, np.int32)), WINDOW)
    noncausal = pinf.InferenceEngine(pparams, dataclasses.replace(pcfg, causal_attention=0),
                                     device='cpu')
    with pytest.raises(ValueError, match='causal_attention=1'):
        noncausal.run_plugin_stream(ex, WINDOW)


def eval_argv(ckpt_root, log_root, data_path, name):
    return ['--resume', 'tst1', '--name', name, '--data_path', data_path,
            '--checkpoint_root', ckpt_root, '--log_root', str(log_root),
            '--num_queries', '1', '--num_workers', '1', '--compute_dtype', 'float32',
            '--avoid_wandb', '2', '--device', 'cpu', '--stream_window', str(WINDOW)]


@pytest.fixture(scope='module')
def stream_runs(ckpt_root, plugin_video, tmp_path_factory, presets):
    '''tcow_tpu's test driver and eval_torch.py under --stream_window on the synthetic
    video, their videos captured before encoding.'''
    import eval_torch
    from tcow_tpu import config as jconfig
    from tcow_tpu.evaluation import test_driver as jdriver
    from tcow_tpu.utils import logvis as jlogvis
    from tcow_tpu_torch.utils import logvis as plogvis
    log_root = tmp_path_factory.mktemp('logs_stream')
    videos = {'j': {}, 'p': {}}
    mp = pytest.MonkeyPatch()
    for module, key in ((jlogvis, 'j'), (plogvis, 'p')):
        def write(fp, frames, fps, into=videos[key]):
            into[os.path.basename(fp)] = frames
            return fp
        mp.setattr(module, '_write_video', write)
    try:
        jargs = jconfig.test_args(eval_argv(ckpt_root, log_root, plugin_video, 'jst'))
        jdriver.main(jargs, jlogvis.MyLogger(jargs, context='test_' + jargs.name))
        eval_torch.main(eval_argv(ckpt_root, log_root, plugin_video, 'pst'))
    finally:
        mp.undo()
    return types.SimpleNamespace(
        videos=videos,
        jcsv=os.path.join(str(log_root), 'tst1', 'test_jst_e0', 'itemized_results.csv'),
        pcsv=os.path.join(str(log_root), 'tst1', 'test_pst_e0', 'itemized_results.csv'))


def _read(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


def test_stream_window_eval_writes_the_row_jax_writes(stream_runs):
    '''One CSV row for the video, the header and strings of the JAX run, the friendly name
    ending in _s0 (stride 0 marks streaming), the numbers within 1e-5; the same overlay
    videos, bit-equal but for the heat maps' 8-bit levels.'''
    got, want = _read(stream_runs.pcsv), _read(stream_runs.jcsv)
    assert got[0] == want[0] and len(got) == len(want) == 2
    name = got[1][got[0].index('friendly_short_name')]
    assert name == 'vid_i0_f2_s0'
    for col, g, w in zip(want[0], got[1], want[1]):
        try:
            wf = float(w)
        except ValueError:
            assert g == w, col
            continue
        np.testing.assert_allclose(float(g), wf, rtol=1e-5, atol=1e-12, err_msg=col)
    assert float(got[1][got[0].index('count_snitch_iou')]) == 3
    jv, pv = stream_runs.videos['j'], stream_runs.videos['p']
    assert sorted(pv) == sorted(jv) and len(pv) >= 3
    for k, w in jv.items():
        assert pv[k].shape == w.shape, k
        diff = np.abs(pv[k].astype(np.int16) - w.astype(np.int16))
        assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, k
