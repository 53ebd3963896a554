'''
The port's evaluation path against tcow_tpu's on the CPU (depth 2 at width 32, float32,
T = 6 at 32x48, as tests/test_eval.py): the plugin dataset on demo/rollball.mp4 (usage
modes, items, frame indices; the float resize from 240x320), the test loaders' batches
for Kubric and plugin sources, InferenceEngine.run_kubric's per-clip losses and metrics,
test_driver.main through eval_torch.py on a Kubric set plus the demo video (the itemized
CSV, its aggregates and the overlay videos), pick_represent's summary, the CSV writer
against pandas' to_csv byte for byte, and the flags the port refuses.
'''

import csv
import io
import os
import types

import numpy as np
import pandas as pd
import pytest
import torch

import conftest
from tcow_tpu.data import factory as jfactory
from tcow_tpu.data import plugin as jplugin
from tcow_tpu.data import synthetic as jsyn
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch.data import factory as pfactory
from tcow_tpu_torch.data import plugin as pplugin
from tcow_tpu_torch.evaluation import pick_represent as ppick
from tcow_tpu_torch.evaluation import test_driver as pdriver

# Per-clip losses as tests/test_torch_eval_vis.py holds them; metric means 1e-6 as the
# metric sums; CSV numbers and aggregates 1e-5.
LOSS_RTOL = 1e-5
METRIC_RTOL = 1e-6
CSV_RTOL = 1e-5

DEMO = os.path.join(conftest.REPO_ROOT, 'demo', 'rollball.mp4')
SEEKER_ARGS = dict(num_total_frames=6, frame_height=32, frame_width=48, patch_size=16,
                   attention_type='divided_space_time', causal_attention=1,
                   norm_embeddings=False, drop_path_rate=0.1, network_depth=2,
                   track_map_stride=4, track_map_resize='bilinear', query_channels=1,
                   output_channels=3, flag_channels=3, tracker_pretrained='0')
# The training clip of the checkpoint: the query at 0.2 of the clip, as the config of
# record evaluates the demo video.
DSET_ARGS = dict(num_frames=6, frame_height=32, frame_width=48, frame_rate=12,
                 frame_stride=1, max_delay=2, use_data_frac=1.0, augs_2d=True,
                 num_queries=1, query_time=0.2, max_objects=6, front_occl_thres=0.95,
                 outer_cont_thres=0.75, reverse_prob=0.1, palindrome_prob=0.1)
PLUGIN_KW = dict(num_clip_frames=6, frame_height=32, frame_width=48, frame_rate=30,
                 prefer_frame_stride=3, query_time=0.2, annots_must_exist=False,
                 prefetch=True, center_crop=True)


@pytest.fixture(scope='module')
def presets():
    '''Depth 2 at width 32 in both packages.'''
    from tcow_tpu.models import timesformer as jtsf
    from tcow_tpu_torch.models import timesformer as ptsf
    old = dict(jtsf.DEPTH_PRESETS), dict(ptsf.DEPTH_PRESETS)
    jtsf.DEPTH_PRESETS[2] = ptsf.DEPTH_PRESETS[2] = (32, 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for presets_, saved in zip((jtsf.DEPTH_PRESETS, ptsf.DEPTH_PRESETS), old):
        presets_.clear()
        presets_.update(saved)


@pytest.fixture(scope='module')
def ckpt_root(tmp_path_factory, presets):
    '''A tiny checkpoint written by the JAX package, from random weights.'''
    import jax
    from tcow_tpu.models import mask_tracker
    from tcow_tpu.models.mask_tracker import SeekerConfig
    from tcow_tpu.train import checkpoint as jckpt
    root = tmp_path_factory.mktemp('ckpts')
    cfg = SeekerConfig(num_total_frames=6, frame_height=32, frame_width=48,
                       causal_attention=1, drop_path_rate=0.0, network_depth=2)
    params = mask_tracker.init_params(jax.random.key(0), cfg)
    jckpt.save_checkpoint(os.path.join(str(root), 'tev1'), epoch=0, name='tev1',
                          params=params, train_args={'seed': 900, 'num_frames': 6},
                          dset_args={'kubric': DSET_ARGS}, seeker_args=SEEKER_ARGS)
    return str(root)


@pytest.fixture(scope='module')
def kubric_root(tmp_path_factory):
    '''Three 48x64 scenes: a batch of 2 and a tail of 1 at --test_device_batch 2.'''
    root = tmp_path_factory.mktemp('kubric_eval')
    jsyn.write_synthetic_kubric_dataset(str(root), num_scenes=3, seed=21, T=10, H=48, W=64,
                                        K=4)
    return str(root)


def eval_argv(ckpt_root, log_root, data_paths, name):
    return ['--resume', 'tev1', '--name', name, '--data_path', *data_paths,
            '--checkpoint_root', ckpt_root, '--log_root', str(log_root),
            '--num_queries', '1', '--num_workers', '1', '--compute_dtype', 'float32',
            '--avoid_wandb', '2', '--device', 'cpu', '--test_device_batch', '2',
            '--plugin_batch', '5']


def _capture_videos(monkeypatch, module, into):
    '''Records the frames of every video instead of encoding it.'''
    def write(fp, frames, fps):
        into[os.path.basename(fp)] = frames
        return fp
    monkeypatch.setattr(module, '_write_video', write)


@pytest.fixture(scope='module')
def runs(ckpt_root, kubric_root, tmp_path_factory, presets):
    '''tcow_tpu's test driver and eval_torch.py on the Kubric set and the demo video,
    their videos captured before encoding.'''
    import eval_torch
    from tcow_tpu import config as jconfig
    from tcow_tpu.evaluation import test_driver as jdriver
    from tcow_tpu.utils import logvis as jlogvis
    from tcow_tpu_torch.utils import logvis as plogvis
    log_root = tmp_path_factory.mktemp('logs')
    mp = pytest.MonkeyPatch()
    jvideos, pvideos = {}, {}
    _capture_videos(mp, jlogvis, jvideos)
    _capture_videos(mp, plogvis, pvideos)
    try:
        jargs = jconfig.test_args(eval_argv(ckpt_root, log_root, [kubric_root, DEMO], 'jev'))
        jlogger = jlogvis.MyLogger(jargs, context='test_' + jargs.name)
        jw, ju, jdf = jdriver.main(jargs, jlogger)
        pw, pu, ptable = eval_torch.main(eval_argv(ckpt_root, log_root,
                                                   [kubric_root, DEMO], 'pev'))
    finally:
        mp.undo()
    return types.SimpleNamespace(
        log_root=log_root, jw=jw, ju=ju, pw=pw, pu=pu, jvideos=jvideos, pvideos=pvideos,
        jlog=os.path.join(str(log_root), 'tev1', 'test_jev_e0'),
        plog=os.path.join(str(log_root), 'tev1', 'test_pev_e0'))


# ---------------------------------------------------------------------------------------
# The plugin dataset and the test loaders
# ---------------------------------------------------------------------------------------

@pytest.fixture(scope='module')
def plugin_pair():
    return (jplugin.PluginVideoDataset(DEMO, None, 'test', **PLUGIN_KW),
            pplugin.PluginVideoDataset(DEMO, None, 'test', **PLUGIN_KW))


def test_plugin_usage_modes_match_jax(plugin_pair):
    jds, pds = plugin_pair
    assert pds.usage_modes == jds.usage_modes and len(pds) == len(jds) == 10
    assert pds.num_video_frames == jds.num_video_frames == 200
    for name in ('raw_query_frames', 'raw_snitch_frames', 'raw_occl_frames',
                 'raw_cont_frames'):
        j, p = getattr(jds, name), getattr(pds, name)
        assert sorted(p) == sorted(j), name
        for t in j:
            np.testing.assert_array_equal(p[t], j[t], err_msg=f'{name} {t}')


@pytest.mark.parametrize('index', [0, 4, 9])
def test_plugin_items_match_jax(plugin_pair, index):
    '''The float frames (240x320, cropped to 213x320) are resized to 32x48 by cv2's
    INTER_AREA in both packages: bit-equal.'''
    jds, pds = plugin_pair
    want, got = jds[index], pds[index]
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype and got[k].shape == w.shape, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k
    assert got['rgb'].shape == (3, 6, 32, 48)
    assert list(got['frame_inds']) == list(range(got['frame_start'], got['frame_start']
                                                 + 6 * got['frame_stride'],
                                                 got['frame_stride']))


def _batches_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, dict):
            _batches_equal(got[k], w)
        elif isinstance(w, np.ndarray):
            assert np.asarray(got[k]).dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize('source', ['kubric', 'plugin'])
def test_test_loader_batches_match_jax(ckpt_root, kubric_root, tmp_path, source):
    from tcow_tpu import config as jconfig
    path = kubric_root if source == 'kubric' else DEMO
    argv = eval_argv(ckpt_root, tmp_path, [path], 'ld')
    jargs, pargs = jconfig.test_args(argv), pconfig.test_args(argv)
    jl, jsrc = jfactory.create_test_data_loader({}, jargs, {'kubric': DSET_ARGS}, None)
    pl, psrc = pfactory.create_test_data_loader({}, pargs, {'kubric': DSET_ARGS}, None)
    assert psrc == jsrc and len(pl) == len(jl) == (2 if source == 'kubric' else 5)
    for got, want in zip(pl, jl):
        # The port's meta also carries the query stream's state (for a resumed run).
        if source == 'kubric':
            assert got['meta'].pop('collate_rng_after')
        _batches_equal(got, want)


# ---------------------------------------------------------------------------------------
# run_kubric, the driver, the CSV and pick_represent
# ---------------------------------------------------------------------------------------

def test_run_kubric_matches_jax(ckpt_root, kubric_root, tmp_path, presets):
    from tcow_tpu import config as jconfig
    from tcow_tpu.evaluation import inference as jinf
    from tcow_tpu.objectives.losses import LossConfig as JLossConfig
    from tcow_tpu_torch.evaluation import inference as pinf
    from tcow_tpu_torch.objectives.losses import LossConfig as PLossConfig
    argv = eval_argv(ckpt_root, tmp_path, [kubric_root], 'rk')
    jl, _ = jfactory.create_test_data_loader({}, jconfig.test_args(argv),
                                            {'kubric': DSET_ARGS}, None)
    batch = next(iter(jl))['device']
    path = os.path.join(ckpt_root, 'tev1')
    jparams, jcfg, *_ = jinf.load_networks(path, None)
    pparams, pcfg, *_ = pinf.load_networks(path, None, compute_dtype=torch.float32,
                                           device='cpu')
    want = jinf.InferenceEngine(jparams, jcfg, JLossConfig(), 1).run_kubric(batch)
    got = pinf.InferenceEngine(pparams, pcfg, PLossConfig(), 1, device='cpu').run_kubric(batch)
    assert len(got) == len(want) == 2
    for (gm, gl), (wm, wl) in zip(got, want):
        assert set(gm) == set(wm) and set(gl) == set(wl)
        for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker'):
            np.testing.assert_allclose(gl[k], wl[k], rtol=LOSS_RTOL, atol=1e-7, err_msg=k)
        assert set(gl['metrics']) == set(wl['metrics'])
        for k, w in wl['metrics'].items():
            np.testing.assert_allclose(gl['metrics'][k], w, rtol=METRIC_RTOL, err_msg=k)
        for k in ('seeker_input', 'target_mask', 'seeker_query_mask', 'sel_query_inds'):
            np.testing.assert_array_equal(gm[k], wm[k], err_msg=k)
        for k in ('output_mask', 'output_flags', 'snitch_weights'):
            assert gm[k].shape == np.asarray(wm[k]).shape, k
            np.testing.assert_allclose(gm[k], wm[k], rtol=2e-4, atol=2e-5, err_msg=k)
    tail = pinf.InferenceEngine(pparams, pcfg, device='cpu').run_kubric(batch, valid=1)
    assert len(tail) == 1


def _read(path):
    with open(path, newline='') as f:
        return list(csv.reader(f))


def _assert_csv_close(got_fp, want_fp, rtol):
    '''The same header, the same strings, numbers within rtol.'''
    got, want = _read(got_fp), _read(want_fp)
    assert got[0] == want[0]
    assert len(got) == len(want)
    for g_row, w_row in zip(got[1:], want[1:]):
        for col, g, w in zip(want[0], g_row, w_row):
            try:
                wf = float(w)
            except ValueError:
                assert g.replace('pev', 'jev') == w, col   # the runs' names differ
                continue
            np.testing.assert_allclose(float(g), wf, rtol=rtol, atol=1e-12, err_msg=col)
            assert ('.' in g or 'e' in g or g in ('nan', 'inf')) == \
                   ('.' in w or 'e' in w or w in ('nan', 'inf')), (col, g, w)


def test_test_driver_csv_matches_jax(runs):
    '''itemized_results.csv: 3 Kubric rows then 10 plugin rows, the header of pandas'
    to_csv (scene_dn and loss_* empty on plugin rows), the friendly names, the numbers;
    the weighted and unweighted aggregates.'''
    got_fp = os.path.join(runs.plog, 'itemized_results.csv')
    want_fp = os.path.join(runs.jlog, 'itemized_results.csv')
    _assert_csv_close(got_fp, want_fp, CSV_RTOL)
    rows = _read(got_fp)
    names = [r[rows[0].index('friendly_short_name')] for r in rows[1:]]
    assert len(names) == 13
    assert [n.split('_', 2)[-1] for n in names[:3]] == ['scn00000_q0', 'scn00001_q0',
                                                        'scn00002_q0']
    assert names[3:5] == ['rollball_i0_f14_s1', 'rollball_i1_f13_s2']
    for agg_p, agg_j in ((runs.pw, runs.jw), (runs.pu, runs.ju)):
        assert set(agg_p) == set(agg_j)
        for k, v in agg_j.items():
            np.testing.assert_allclose(agg_p[k], v, rtol=CSV_RTOL, err_msg=k)


def test_test_driver_videos_match_jax(runs):
    '''Every clip's overlay videos: the same names, frames bit-equal but for the output
    heat maps, whose logits agree within float tolerance (at most one 8-bit level apart
    in a handful of pixels).'''
    assert sorted(runs.pvideos) == sorted(runs.jvideos)
    assert len(runs.pvideos) >= 13 * 3
    for name, want in runs.jvideos.items():
        got = runs.pvideos[name]
        assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape, name
        if name.endswith(('_in.webm', '_gt.webm')):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3, name


def test_test_driver_logs_no_self_check_error(runs):
    log = open(os.path.join(runs.plog, 'test_pev_e0.log')).read()
    assert 'does not match' not in log and 'overlay rendering failed' not in log
    assert 'Exported quantitative results' in log


def test_pick_represent_matches_jax(runs, tmp_path):
    '''Both packages' pick_represent on the JAX run's results with a guide that selects
    one Kubric and one plugin clip, and the demo guide, which selects none at T = 6: the
    same summary, filtered CSV and metrics text.'''
    from tcow_tpu.evaluation import pick_represent as jpick
    from tcow_tpu.utils.logvis import Logger as JLogger
    guide = tmp_path / 'guide_eval.txt'
    guide.write_text('# two of the clips\nscn00001_q\nrollball_i1_\n')
    outs = {}
    for key in ('j', 'p'):
        out = tmp_path / f'represent_{key}'
        argv = ['--testres_path', runs.jlog, '--represent_guide', str(guide),
                os.path.join(conftest.REPO_ROOT, 'rep_lists', 'demo_rollball.txt'),
                '--output_dir', str(out)]
        if key == 'j':
            jpick.main(jpick.get_args(argv), JLogger(context='pickrep'))
        else:
            assert ppick.cli(argv) == 0
        outs[key] = out
    summary = outs['p'] / '_autosmr_0.csv'
    _assert_csv_close(summary, outs['j'] / '_autosmr_0.csv', 0)
    rows = _read(summary)
    assert len(rows) == 2 and rows[1][rows[0].index('num_examples')] == '2'
    # pandas' read_csv parses floats with its own routine, which can round the 17th
    # significant digit differently from float(): the numbers agree to 1e-12.
    sub = 'test_jev_e0_ar_guide_eval'
    _assert_csv_close(outs['p'] / sub / 'z_filt_item_res_guide_eval.csv',
                      outs['j'] / sub / 'z_filt_item_res_guide_eval.csv', 1e-12)
    got, want = ((outs[k] / sub / 'z_metrics_guide_eval.txt').read_text().splitlines()
                 for k in ('p', 'j'))
    assert [ln.split(': ')[0] for ln in got] == [ln.split(': ')[0] for ln in want]
    for g, w in zip(got, want):
        if ': ' in w and w.split(': ')[0] not in ('Logs', 'Guide'):
            np.testing.assert_allclose(float(g.split(': ')[1]), float(w.split(': ')[1]),
                                       rtol=1e-12, err_msg=w)
        else:
            assert g == w
    assert sorted(os.listdir(outs['p'] / sub)) == sorted(os.listdir(outs['j'] / sub))


@pytest.mark.parametrize('case', ['mixed', 'ints_with_missing', 'empty'])
def test_csv_writer_matches_pandas(tmp_path, case):
    rows = {
        'mixed': [{'a': 'kubric', 'b': 1, 'c': 'x,y', 'd': 0.1, 'e': 1 / 3, 'f': -1.0,
                   'g': True, 'h': np.float32(0.1), 'i': np.float64(1e16)},
                  {'a': 'plugin', 'b': 2, 'd': float('nan'), 'e': float('inf'), 'f': 3,
                   'g': False, 'h': 2.5, 'i': 5, 'j': 'late'}],
        'ints_with_missing': [{'n': 3, 'm': None}, {'n': 4}, {'k': 7, 'n': np.int64(5)}],
        'empty': [],
    }[case]
    fp = tmp_path / 'port.csv'
    pdriver.write_csv(str(fp), pdriver.Table(rows))
    buf = io.StringIO()
    pd.DataFrame(rows).to_csv(buf)
    assert fp.read_text() == buf.getvalue()


def test_unported_eval_options_raise(ckpt_root, tmp_path):
    argv = eval_argv(ckpt_root, tmp_path, [DEMO], 'ur')
    assert pconfig.test_args(argv + ['--stream_window', '1']).stream_window == 1
    with pytest.raises(NotImplementedError, match='item 7'):
        pconfig.test_args(argv + ['--mesh_devices', '2'])
    # A reference .pth is no longer refused: a .pth-only directory resolves to it.
    pth = tmp_path / 'ck' / 'pth1' / 'checkpoint.pth'
    pth.parent.mkdir(parents=True)
    torch.save({'epoch': 3}, pth)
    args = pconfig.test_args(argv[2:] + ['--resume', 'pth1', '--checkpoint_root',
                                         str(tmp_path / 'ck')])
    assert args.resume == str(pth) and args.name.endswith('_e3')
