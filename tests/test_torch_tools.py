'''
The port's tools on the CPU: tools/torch_stream_eval.py against tools/stream_eval.py (a
tiny seeded checkpoint, depth 2 at width 64 with 4 heads, T = 4 at 32x64, written once by
the port and loaded by both packages' load_networks; one synthetic Kubric scene of 12
frames with occlusion and containment events; windows 0 and 4, buckets at 4): every metric
of every variant and bucket within 1e-4. Then torch_stream_bench, torch_serve_bench and
torch_stream_demo run and print their keys; torch_warm_cache fills the port's caches;
torch_validate_dataset exits 1 on a scene with too few desirable instances and 0 on good
ones; and objectives/metrics.calculate_metrics_mask_track against tcow_tpu's.
'''

import ast
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu.objectives import metrics as jmetrics
from tcow_tpu_torch.data.synthetic import write_synthetic_kubric_dataset
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.models.mask_tracker import MaskTracker, seeker_config_from_args
from tcow_tpu_torch.objectives import metrics as pmetrics
from tcow_tpu_torch.train.checkpoint import save_checkpoint
from tcow_tpu_torch.weights import params_to_jax

sys.path.insert(0, os.path.join(conftest.REPO_ROOT, 'tools'))
import stream_eval as jstream_eval  # noqa: E402
import torch_serve_bench  # noqa: E402
import torch_stream_bench  # noqa: E402
import torch_stream_demo  # noqa: E402
import torch_stream_eval  # noqa: E402
import torch_validate_dataset  # noqa: E402
import torch_warm_cache  # noqa: E402

METRIC_ATOL = 1e-4
SEEKER_ARGS = dict(num_total_frames=4, frame_height=32, frame_width=64, patch_size=16,
                   attention_type='divided_space_time', causal_attention=1,
                   norm_embeddings=False, drop_path_rate=0.0, network_depth=2,
                   track_map_stride=4, track_map_resize='bilinear', query_channels=1,
                   output_channels=3, flag_channels=3, tracker_pretrained='0')
SCENE_FRAMES = 12


@pytest.fixture(scope='module')
def tiny(tmp_path_factory):
    '''The depth-2 preset in both packages, a seeded checkpoint (temporal_fc non-zero) and
    a test split of one rich synthetic scene; one intra-op thread.'''
    old = dict(jtsf.DEPTH_PRESETS), dict(ptsf.DEPTH_PRESETS)
    jtsf.DEPTH_PRESETS[2] = ptsf.DEPTH_PRESETS[2] = (64, 4)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp('tools')
    model = MaskTracker(seeker_config_from_args(SEEKER_ARGS))
    model.init_params_(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, prm in model.named_parameters():
            if 'temporal_fc.w' in name:
                prm.normal_(0.0, 0.02, generator=g)
    ckpt = save_checkpoint(str(root / 'ckpt'), 0, 'tools', params_to_jax(model.state_dict()),
                           seeker_args=SEEKER_ARGS)
    write_synthetic_kubric_dataset(str(root / 'data' / 'test'), 1, seed=3, T=SCENE_FRAMES,
                                   H=32, W=64, K=4, rich_events=True)
    yield root, ckpt
    torch.set_num_threads(threads)
    for presets, saved in zip((jtsf.DEPTH_PRESETS, ptsf.DEPTH_PRESETS), old):
        presets.clear()
        presets.update(saved)


def test_stream_eval_matches_jax(tiny, monkeypatch):
    root, ckpt = tiny
    args = ['--resume', ckpt, '--data_path', str(root / 'data'), '--num_frames',
            str(SCENE_FRAMES), '--windows', '0,4', '--buckets', '4', '--device', 'cpu']
    monkeypatch.setattr(sys, 'argv', ['stream_eval.py', *args, '--out', str(root / 'j.json')])
    jstream_eval.main()
    torch_stream_eval.main([*args, '--out', str(root / 'p.json'), '--compute_dtype',
                            'float32'])
    want = json.loads((root / 'j.json').read_text())
    got = json.loads((root / 'p.json').read_text())
    assert sorted(got) == sorted(want) == ['joint', 'latency_ms_w4', 'latency_ms_winf',
                                           'stream_w4', 'stream_winf']
    for variant, buckets in want.items():
        if not isinstance(buckets, dict):
            assert got[variant] > 0
            continue
        assert sorted(got[variant]) == sorted(buckets) == ['0-4', '4-12', 'all']
        for bucket, row in buckets.items():
            assert sorted(got[variant][bucket]) == sorted(row)
            for k, v in row.items():
                assert abs(got[variant][bucket][k] - v) <= METRIC_ATOL, (variant, bucket, k)
    # The scene has occluded and contained frames past the first bucket.
    assert want['stream_winf']['4-12']['count_occl_mask_iou'] > 0
    assert want['stream_winf']['4-12']['count_cont_mask_iou'] > 0


def test_stream_eval_functions_agree_in_process(tiny):
    '''The functions a caller drives per scene: the unbounded stream against the offline
    forward over the same frames (f32: the same function of the frames).'''
    root, ckpt = tiny
    model, cfg = torch_stream_eval.load_model(ckpt, '', 'cpu', torch.float32)
    ds = torch_stream_eval.make_dataset(str(root / 'data'), cfg, SCENE_FRAMES)
    rgb, qmask, target = torch_stream_eval.scene_inputs(ds[0], 'cpu')
    assert rgb.shape == (3, SCENE_FRAMES, 32, 64) and qmask.shape == (1, SCENE_FRAMES, 32, 64)
    assert target.shape == (1, 1, 3, SCENE_FRAMES, 32, 64) and qmask[:, 0].any()
    stream, lat = torch_stream_eval.stream_masks(model, rgb, qmask, 0, SCENE_FRAMES, 'cpu')
    offline = torch_stream_eval.offline_masks(model, rgb, qmask, 'cpu')
    assert stream.shape == offline.shape == (1, 1, 3, SCENE_FRAMES, 32, 64)
    assert len(lat) == SCENE_FRAMES
    np.testing.assert_allclose(stream.numpy(), offline.numpy(), rtol=2e-4, atol=2e-5)


def test_stream_bench_prints_its_keys(tiny, capsys):
    torch_stream_bench.main(['--frames', '6', '--windows', '3,5', '--multi', '2', '--height',
                             '32', '--width', '64', '--depth', '2', '--repeats', '1',
                             '--device', 'cpu'])
    out = capsys.readouterr().out.splitlines()
    results = ast.literal_eval(out[-1])
    keys = ['unbounded', 'window3', 'window5', 'multi2_w3', 'multi2_w5']
    assert list(results) == keys and all(np.isfinite(v) and v > 0 for v in results.values())
    detail = json.loads(out[-2])
    assert list(detail['stream_bench']) == keys and detail['device'] == 'cpu'
    assert all(np.isfinite(d['checksum']) for d in detail['stream_bench'].values())


@pytest.mark.parametrize('slots,extra', [(1, []), (2, ['--reload_midway', '--migrate', '1'])])
def test_serve_bench_prints_its_lines(tiny, capsys, slots, extra):
    _, ckpt = tiny
    torch_serve_bench.main(['--sessions', '1,2', '--frames', '4', '--window', '3',
                            '--batch_slots', str(slots), '--resume', ckpt, '--device', 'cpu',
                            '--compute_dtype', 'float32', *extra])
    out = [ln for ln in capsys.readouterr().out.splitlines() if not ln.startswith(
        ('Loading weights', '=> Loaded'))]
    assert len(out) == 4 and all(ln.startswith('sessions=') for ln in out[::2])
    assert all('agg_fps=' in ln and 'p50=' in ln and 'p95=' in ln for ln in out[::2])
    recs = [json.loads(ln) for ln in out[1::2]]
    assert [r['serve_bench']['sessions'] for r in recs] == [1, 2]
    for r in recs:
        assert r['serve_bench']['stale_errors'] == 0 and r['batch_slots'] == slots
        assert r['server_steps'] >= r['serve_bench']['frames_total'] / slots
    if slots > 1:
        assert all('avg_batch=' in ln and 'stale_errors=0' in ln for ln in out[::2])


def test_stream_demo_writes_the_overlay_video(tiny, tmp_path, capsys):
    import cv2
    _, ckpt = tiny
    out = tmp_path / 'demo.webm'
    torch_stream_demo.main(['--resume', ckpt, '--video', os.path.join(
        conftest.REPO_ROOT, 'demo', 'rollball.mp4'), '--query', os.path.join(
        conftest.REPO_ROOT, 'demo', 'rollball_15_query.png'), '--query_frame', '15',
        '--window', '3', '--max_frames', '5', '--out', str(out), '--device', 'cpu'])
    written = [p for p in tmp_path.iterdir() if p.stem == 'demo']
    assert len(written) == 1
    rec = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rec['stream_demo']['frames'] == 5 and rec['stream_demo']['out'] == str(written[0])
    assert rec['stream_demo']['launches'] == {} and rec['device'] == 'cpu'
    cap = cv2.VideoCapture(str(written[0]))
    frames = 0
    while cap.read()[0]:
        frames += 1
    cap.release()
    assert frames == 5
    rgb = np.full((2, 2, 3), 0.5, np.float32)
    vis = torch_stream_demo.overlay(rgb, np.zeros((3, 2, 2), np.float32))
    np.testing.assert_array_equal(vis, np.full((2, 2, 3), 140, np.uint8))


def test_warm_cache_and_validate_dataset(tmp_path, capsys):
    '''Caches for every scene of each split; a scene with one object cannot serve 2
    queries (exit 1, BAD), scenes of four can (exit 0).'''
    write_synthetic_kubric_dataset(str(tmp_path / 'good' / 'train'), 2, seed=0, T=10, H=48,
                                   W=64, K=4)
    write_synthetic_kubric_dataset(str(tmp_path / 'bad' / 'val'), 1, seed=5, T=10, H=48,
                                   W=64, K=1)
    torch_warm_cache.main(['--data_path', str(tmp_path / 'good'), '--num_frames', '8',
                           '--max_delay', '2', '--workers', '2'])
    scenes = sorted((tmp_path / 'good' / 'train').iterdir())
    assert len(scenes) == 2 and all(any(p.name.startswith('cc_torch') for p in s.iterdir())
                                    for s in scenes)
    common = ['--num_queries', '2', '--num_frames', '8', '--frame_height', '48',
              '--frame_width', '64']
    assert torch_validate_dataset.main(['--data_path', str(tmp_path / 'good' / 'train'),
                                        '--aug_probes', '1', *common]) == 0
    assert '2/2 scenes support num_queries=2' in capsys.readouterr().out
    assert torch_validate_dataset.main(['--data_path', str(tmp_path / 'bad' / 'val'),
                                        *common]) == 1
    out = capsys.readouterr().out
    assert 'BAD' in out and '0/1 scenes support num_queries=2' in out


@pytest.mark.parametrize('channels', [1, 3])
def test_calculate_metrics_mask_track_matches_jax(channels):
    rng = np.random.RandomState(channels)
    out = rng.randn(2, 1, 3, 5, 8, 8).astype(np.float32)
    target = (rng.rand(2, 1, channels, 5, 8, 8) > 0.6).astype(np.float32)
    target[:, :, :, -1] = -1.0          # unannotated frames
    want = jmetrics.calculate_metrics_mask_track(jnp.asarray(out), jnp.asarray(target))
    got = pmetrics.calculate_metrics_mask_track(torch.from_numpy(out),
                                                torch.from_numpy(target))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert type(got[k]) is type(v), k
        np.testing.assert_allclose(got[k], v, rtol=1e-6, err_msg=k)
