'''
The port's overlay renderers (tcow_tpu_torch/utils/visualization.py) and media writers
(utils/logvis.py) against tcow_tpu's on the CPU: the magma and viridis tables against
matplotlib's colour maps (0, 1, values just below 1, below 0 and above 1, NaN), every
renderer bit-equal on the same seeded arrays, and _save_query_overlays in train and test
phases (with the loss-weight map, with extra_visuals) writing the same files with the
same frames, captured before encoding; then the writers themselves (a video decoded back,
a PNG, a gallery, a pickle).
'''

import os
import pickle

import matplotlib.pyplot as plt
import numpy as np
import pytest

import conftest  # noqa: F401
from tcow_tpu.utils import logvis as jlogvis
from tcow_tpu.utils import visualization as jvis
from tcow_tpu_torch.data import png
from tcow_tpu_torch.utils import logvis as plogvis
from tcow_tpu_torch.utils import visualization as pvis

T, H, W = 5, 24, 32


def grid():
    x = np.linspace(-0.5, 1.5, 4001, dtype=np.float32)
    edges = np.array([0, 1, np.nextafter(np.float32(1), np.float32(0)), 1 / 256, 255 / 256,
                      -1e-7, 1 + 1e-7, 0.5, np.nan], np.float32)
    return np.concatenate([x, edges])


@pytest.mark.parametrize('name', ['magma', 'viridis'])
@pytest.mark.parametrize('dtype', [np.float32, np.float64])
def test_colormap_tables_match_matplotlib(name, dtype):
    x = grid().astype(dtype)
    got = getattr(pvis, name)(x)
    want = getattr(plt.cm, name)(x)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    # A sigmoid of a large logit gives exactly 1 in float32: the last colour.
    np.testing.assert_array_equal(getattr(pvis, name)(np.ones(3, dtype))[:, :3],
                                  np.asarray(getattr(plt.cm, name).colors)[[-1] * 3])


def inputs(seed):
    rng = np.random.default_rng(seed)
    rgb = rng.random((T, H, W, 3), dtype=np.float32)
    qmask = np.zeros((T, H, W), np.float32)
    qmask[1, 6:14, 8:20] = 1.0
    out = 1.0 / (1.0 + np.exp(-rng.normal(0, 3, (3, T, H, W)).astype(np.float32)))
    out[0, 0, :2] = 1.0
    target = (rng.random((3, T, H, W)) > 0.7).astype(np.float32)
    target[:, -1] = -1.0
    borders = [jvis.draw_segm_borders(m[..., None] > 0.5) for m in
               (qmask, target[0], target[1], target[2])]
    return rgb, qmask, out, target, borders


@pytest.mark.parametrize('fill_white', [False, True])
def test_draw_segm_borders_bit_equal(fill_white):
    rng = np.random.default_rng(3)
    segm = (rng.random((T, H, W, 2)) > 0.6).astype(np.float32)
    got = pvis.draw_segm_borders(segm, fill_white)
    want = jvis.draw_segm_borders(segm, fill_white)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


RENDERERS = {
    'input': lambda m, rgb, q, out, tgt, b: m.create_model_input_video(rgb.copy(), q, b[0]),
    'input_no_pause': lambda m, rgb, q, out, tgt, b: m.create_model_input_video(
        rgb.copy(), q, b[0], apply_pause=False),
    'snitch': lambda m, rgb, q, out, tgt, b: m.create_model_output_snitch_video(
        rgb, out, b[0], b[1]),
    'snitch_gray': lambda m, rgb, q, out, tgt, b: m.create_model_output_snitch_video(
        rgb, out, b[0], b[1], grayscale=True),
    'three_channels': lambda m, rgb, q, out, tgt, b:
        m.create_model_output_snitch_occl_cont_video(rgb, out, *b),
    'one_channel_gray': lambda m, rgb, q, out, tgt, b:
        m.create_model_output_snitch_occl_cont_video(rgb, out[:1], *b, grayscale=True),
    'weights': lambda m, rgb, q, out, tgt, b: m.create_snitch_weights_video(
        rgb, out[0] * 7.0),
    'target': lambda m, rgb, q, out, tgt, b: m.create_model_input_target_video(
        rgb, q, tgt, *b),
    'target_gray_two': lambda m, rgb, q, out, tgt, b: m.create_model_input_target_video(
        rgb, q, tgt[:2], *b, grayscale=True),
}


@pytest.mark.parametrize('renderer', sorted(RENDERERS))
def test_renderers_bit_equal(renderer):
    args = inputs(5)
    got = RENDERERS[renderer](pvis, *args)
    want = RENDERERS[renderer](jvis, *args)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def model_retval(seed, queries=2, weights=True):
    '''A vis-step payload (float16, example 0, `queries` queries) as the train driver
    hands it to handle_train_step.'''
    rng = np.random.default_rng(seed)
    f16 = lambda a: a.astype(np.float16)
    qm = np.zeros((1, queries, 1, T, H, W), np.float32)
    qm[..., 0, 4:12, 6:18] = 1.0
    tm = (rng.random((1, queries, 3, T, H, W)) > 0.6).astype(np.float32)
    out = {'seeker_input': rng.random((1, 3, T, H, W), dtype=np.float32),
           'output_mask': f16(rng.normal(0, 4, (1, queries, 3, T, H, W))),
           'target_mask': f16(tm), 'seeker_query_mask': f16(qm)}
    if weights:
        out['snitch_weights'] = f16(rng.random((1, queries, T, H, W)) * 5)
    return out


def capture(monkeypatch, module):
    frames = {}

    def write(fp, arr, fps):
        frames[os.path.basename(fp)] = (arr, fps)
        return fp
    monkeypatch.setattr(module, '_write_video', write)
    return frames


@pytest.mark.parametrize('phase', ['train', 'val_aug', 'test', 'test_extra'])
def test_query_overlays_match_jax(tmp_path, monkeypatch, phase):
    '''The same file names and frames (uint8, as handed to the encoder) from both
    packages; train phases add the loss-weight map, extra_visuals the debug views.'''
    got_frames, want_frames = capture(monkeypatch, plogvis), capture(monkeypatch, jlogvis)
    mr = model_retval(7, weights=phase != 'test')
    plog = plogvis.MyLogger(context='train', log_dir=str(tmp_path / 'p'))
    jlog = jlogvis.MyLogger(context='train', log_dir=str(tmp_path / 'j'))
    for logger in (plog, jlog):
        logger.extra_visuals = phase == 'test_extra'
        if phase.startswith('test'):
            data = {'source_name': 'plugin', 'src_path': '/x/rollball.mp4', 'dset_idx': 1,
                    'frame_start': 3, 'frame_stride': 2}
            name = logger.handle_test_step(4, data, mr, {'metrics': {}})
            assert name == 'rollball_i1_f3_s2'
        else:
            logger.handle_train_step(0, phase, 0, 0, 4, {}, mr, {'total_seeker': 1.0})
        logger.epoch_finished(0)
    plog.close()
    assert sorted(got_frames) == sorted(want_frames)
    n_videos = {'train': 10, 'val_aug': 10, 'test': 8, 'test_extra': 20}[phase]
    assert len(got_frames) == n_videos
    for name, (arr, fps) in want_frames.items():
        got, got_fps = got_frames[name]
        assert got.dtype == arr.dtype == np.uint8 and got_fps == fps, name
        np.testing.assert_array_equal(got, arr, err_msg=name)


def test_kubric_friendly_name():
    data = {'source_name': 'kubric', 'scene_dn': 'test_scn00004', 'dset_idx': 4}
    assert plogvis.MyLogger.friendly_short_name(data) == \
        jlogvis.MyLogger.friendly_short_name(data) == 'test_scn00004_q0'


def test_media_writers(tmp_path):
    '''A video encoded by cv2 decodes back to its frame count and size (VP8 .webm, or
    mp4v .mp4 where the build has no VP8); images are PNGs; galleries tile; pickles load.'''
    import cv2
    logger = plogvis.Logger(str(tmp_path), context='media')
    frames = (np.random.default_rng(0).random((7, 24, 32, 3)) * 255).astype(np.uint8)
    logger.save_video(frames, 'clip.webm', fps=6)
    logger.wait_pending()
    written = [f for f in os.listdir(tmp_path / 'visuals') if f.startswith('clip.')]
    assert len(written) == 1 and written[0] in ('clip.webm', 'clip.mp4')
    cap = cv2.VideoCapture(str(tmp_path / 'visuals' / written[0]))
    decoded = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        decoded.append(bgr)
    cap.release()
    assert len(decoded) == 7 and decoded[0].shape == (24, 32, 3)

    img = np.random.default_rng(1).random((10, 12, 3)).astype(np.float32)
    fp = logger.save_image(img, 'img.png')
    np.testing.assert_array_equal(png.read_png(fp), (np.clip(img, 0, 1) * 255).astype(np.uint8))
    grid_fp = logger.save_gallery((np.ones((5, 4, 6, 3)) * 0.5).astype(np.float32), 'g.png',
                                  num_cols=2)
    assert png.read_png(grid_fp).shape == (12, 12, 3)
    pk = logger.save_pickle({'a': 1}, 'results/r.p')
    with open(pk, 'rb') as f:
        assert pickle.load(f) == {'a': 1}
    logger.close()
