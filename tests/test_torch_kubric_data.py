'''
The port's Kubric data path against tcow_tpu's on the CPU: the segmentation codec, the
occlusion fractions and DAG, desirability and query sampling, the scene writers, the
augmentation pipeline (cv2's resize in integer numpy), KubricQueryDataset items and
collated batches over every phase, two epochs and a resize up and down, the native and
numpy paths, and the PrefetchLoader's batch order in both worker modes.

Every comparison is bit for bit: the port's smooth resize reproduces cv2's INTER_LINEAR /
INTER_AREA arithmetic for uint8, so rgb is exact too.
'''

import json
import os

import cv2
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.data import augs as jaugs
from tcow_tpu.data import data_utils as jdu
from tcow_tpu.data import geometry as jgeo
from tcow_tpu.data import kubric as jkub
from tcow_tpu.data import query_sampling as jqs
from tcow_tpu.data import synthetic as jsyn
from tcow_tpu.data import vis_codec as jvc
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch import native
from tcow_tpu_torch.data import augs as paugs
from tcow_tpu_torch.data import data_utils as pdu
from tcow_tpu_torch.data import factory as pfactory
from tcow_tpu_torch.data import geometry as pgeo
from tcow_tpu_torch.data import kubric as pkub
from tcow_tpu_torch.data import png
from tcow_tpu_torch.data import query_sampling as pqs
from tcow_tpu_torch.data import synthetic as psyn
from tcow_tpu_torch.data import vis_codec as pvc
from tcow_tpu_torch.train import step as pstep

SCENE_KW = dict(T=10, H=48, W=64, K=6, rich_events=True)
# Clip geometry: 6 frames + 2 of delay; frames resized down (32x48), kept (48x64) and up
# (64x96) from the 48x64 scenes.
ITEM_KW = dict(num_frames=6, max_delay=2, num_queries=2, max_objects=8, seed=7,
               device_color_jitter=True)
SIZES = {'down': (32, 48), 'same': (48, 64), 'up': (64, 96)}


@pytest.fixture(scope='module')
def jax_root(tmp_path_factory):
    '''A dataset written by the JAX package's writer (cv2 PNGs): train 3, val 2 scenes.'''
    root = tmp_path_factory.mktemp('kub_jax')
    jsyn.write_synthetic_kubric_dataset(str(root / 'train'), num_scenes=3, seed=5, **SCENE_KW)
    jsyn.write_synthetic_kubric_dataset(str(root / 'val'), num_scenes=2, seed=9, **SCENE_KW)
    return str(root)


def assert_items_equal(got, want, where=''):
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g = got[k]
        if k == 'augs_params':
            assert set(g) == set(w)
            for kk, wv in w.items():
                gv = g[kk]
                if isinstance(wv, dict):
                    assert set(gv) == set(wv)
                    for x in wv:
                        np.testing.assert_array_equal(gv[x], wv[x], err_msg=f'{kk}.{x}')
                else:
                    np.testing.assert_array_equal(gv, wv, err_msg=f'{where} {kk}')
        elif isinstance(w, np.ndarray) or isinstance(w, np.generic):
            assert np.asarray(g).dtype == np.asarray(w).dtype, (where, k)
            np.testing.assert_array_equal(g, w, err_msg=f'{where} {k}')
        elif isinstance(w, tuple):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=f'{where} {k}')
        else:
            assert g == w, (where, k)


# ---------------------------------------------------------------------------------------
# Codec, statistics, sampling
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('K', [1, 3, 7, 20, 36])
def test_segm_codec_matches_jax(K):
    rng = np.random.RandomState(K)
    ids = rng.randint(0, K + 1, size=(3, 12, 16))
    ids.flat[:K + 1] = np.arange(K + 1)
    rgb = pvc.segm_ids_to_rgb_kubric(ids, K)
    np.testing.assert_array_equal(rgb, jvc.segm_ids_to_rgb_kubric(ids, K))
    quant = (rgb * 255).astype(np.uint8) / 255.0            # as the PNG round trip stores it
    got = pvc.segm_rgb_to_ids_kubric(quant)
    np.testing.assert_array_equal(got, jvc.segm_rgb_to_ids_kubric(quant))
    np.testing.assert_array_equal(got[..., 0], ids)


def test_hue_is_matplotlibs_formula():
    import matplotlib.colors
    rng = np.random.default_rng(0)
    rgb = rng.random((500, 3)).astype(np.float32)
    rgb[:50] = rgb[:50, :1]                                 # gray: hue 0
    rgb[50:100, 1] = rgb[50:100, 0]                         # ties between channels
    np.testing.assert_array_equal(pvc._rgb_to_hue(rgb),
                                  matplotlib.colors.rgb_to_hsv(rgb)[..., 0])


def scene_inputs(seed, T=5, H=24, W=32, K=6):
    scene = jsyn.make_synthetic_scene_arrays(seed, T, H, W, K, rich_events=True)
    meta = json.loads(json.dumps(_metadata(scene, T, H, W, K)))
    return scene['segm'][..., None], scene['div_segm'].transpose(1, 2, 3, 0), meta


def _metadata(scene, T, H, W, K):
    instances = []
    for k in range(K):
        pos = [[float(scene['centers'][k, t, 1]) / W, float(scene['centers'][k, t, 0]) / H,
                float(scene['z_pos'][k, t])] for t in range(T)]
        s = float(scene['bbox_half'][k])
        boxes = [[[p[0] + dx, p[1] + dy, p[2] + dz] for dx in (-s, s) for dy in (-s, s)
                  for dz in (-s, s)] for p in pos]
        instances.append({'positions': pos, 'bboxes_3d': boxes})
    return {'camera': {'positions': [[0.0, 0.0, 10.0]] * T}, 'instances': instances}


@pytest.mark.parametrize('use_native', [True, False])
@pytest.mark.parametrize('seed', [0, 4])
def test_occl_fracs_and_dag_match_jax(monkeypatch, use_native, seed):
    segm, div, meta = scene_inputs(seed)
    want_fr = jdu.get_thing_occl_fracs(segm, div)
    want_dag = jdu.get_thing_occl_cont_dag(segm, div, meta, [0, 2, 1, 4, 3])
    if not use_native:
        monkeypatch.setenv('TCOW_NO_NATIVE', '1')
    np.testing.assert_array_equal(pdu.get_thing_occl_fracs(segm, div), want_fr)
    got_dag = pdu.get_thing_occl_cont_dag(segm, div, meta, [0, 2, 1, 4, 3])
    for g, w in zip(got_dag, want_dag):
        np.testing.assert_array_equal(g, w)


def test_containment_pad_usage_modes_and_paths_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    boxes = np.asarray(_metadata(jsyn.make_synthetic_scene_arrays(
        1, 2, 24, 32, 5, rich_events=True), 2, 24, 32, 5)['instances'][0]['bboxes_3d'])
    boxes = np.concatenate([boxes, boxes * 0.5 + rng.random(3) * 0.1])
    np.testing.assert_array_equal(pgeo.get_containment_fraction_matrix(boxes, boxes),
                                  jgeo.get_containment_fraction_matrix(boxes, boxes))
    arr = rng.random((3, 4, 4, 2)).astype(np.float32)
    for g, w in zip(pdu.pad_div(arr, [1, 2], 7), jdu.pad_div(arr, [1, 2], 7)):
        np.testing.assert_array_equal(g, w)
    args = (list(range(100)), [20, 41], list(range(0, 100, 3)))
    assert pdu.get_usage_modes(*args, num_frames=10, query_time=2) == \
        jdu.get_usage_modes(*args, num_frames=10, query_time=2)
    (tmp_path / 'a').mkdir()
    (tmp_path / 'list.txt').write_text('# comment\na\n')
    paths = [str(tmp_path / 'list.txt'), str(tmp_path)]
    assert pdu.get_data_paths_from_args(paths) == jdu.get_data_paths_from_args(paths)


@pytest.mark.parametrize('phase', ['train', 'test'])
def test_desirability_and_query_sampling_match_jax(phase):
    rng = np.random.RandomState(3)
    K, T, H, W, B, Q = 6, 5, 12, 16, 3, 2
    div = (rng.rand(K, T, H, W) > 0.6).astype(np.uint8)
    occl = rng.rand(K, T, 3).astype(np.float32) * 0.5
    want = jqs.get_thing_traject_desirability(div, occl, 1)
    np.testing.assert_array_equal(pqs.get_thing_traject_desirability(div, occl, 1), want)
    desir = np.stack([np.abs(want)] * B)
    counts = np.array([6, 5, 4])
    got = pqs.sample_query_inds(B, Q, counts, desir, phase, rng=np.random.default_rng(8))
    np.testing.assert_array_equal(
        got, jqs.sample_query_inds(B, Q, counts, desir, phase, rng=np.random.default_rng(8)))


# ---------------------------------------------------------------------------------------
# Writers and augmentations
# ---------------------------------------------------------------------------------------

def read_cv2_scene(scene_dp):
    out = {}
    for fn in sorted(os.listdir(os.path.join(scene_dp, 'frames'))):
        img = cv2.imread(os.path.join(scene_dp, 'frames', fn), cv2.IMREAD_UNCHANGED)
        if img.ndim == 3:
            img = img[..., [2, 1, 0, 3][:img.shape[-1]]]
        out[fn] = img
    return out


@pytest.mark.parametrize('rich', [True, False])
def test_scene_writers_decode_equal(tmp_path, rich):
    kw = dict(T=4, H=24, W=40, K=5, rich_events=rich)
    jsyn.write_synthetic_kubric_scene(str(tmp_path / 'j_scn0'), 17, **kw)
    psyn.write_synthetic_kubric_scene(str(tmp_path / 'p_scn0'), 17, **kw)
    want = read_cv2_scene(str(tmp_path / 'j_scn0'))
    frames = str(tmp_path / 'p_scn0' / 'frames')
    assert sorted(os.listdir(frames)) == sorted(want)
    for fn, w in want.items():
        np.testing.assert_array_equal(png.read_png(os.path.join(frames, fn)), w, err_msg=fn)
    with open(tmp_path / 'j_scn0' / 'j_scn0.json') as f, \
            open(tmp_path / 'p_scn0' / 'p_scn0.json') as g:
        assert json.load(f) == json.load(g)
    for k in ('rgb', 'segm', 'div_segm'):
        np.testing.assert_array_equal(
            psyn.make_synthetic_scene_arrays(3, 6, 20, 24, 6, rich_events=rich)[k],
            jsyn.make_synthetic_scene_arrays(3, 6, 20, 24, 6, rich_events=rich)[k])


@pytest.mark.parametrize('src,dst', [((40, 60), (64, 96)), ((100, 140), (240, 320)),
                                     ((203, 287), (240, 320)), ((48, 64), (32, 48)),
                                     ((96, 128), (48, 64)), ((300, 410), (240, 320)),
                                     ((50, 90), (64, 60)), ((60, 50), (40, 80))])
@pytest.mark.parametrize('area', [False, True])
def test_resize_u8_is_cv2_bit_for_bit(src, dst, area):
    '''Random uint8 images, up, down and mixed, 3 and 4 channels: the port's integer
    resize gives cv2.resize's bytes (INTER_LINEAR's 11-bit fixed point, INTER_AREA's
    block means and float32 area sums).'''
    rng = np.random.default_rng(src[0] * dst[1])
    imgs = rng.integers(0, 256, (2, *src, 4)).astype(np.uint8)
    interp = cv2.INTER_AREA if area else cv2.INTER_LINEAR
    for c in (3, 4):
        got = paugs.resize_u8(imgs[..., :c], *dst, area=area)
        for n in range(2):
            want = cv2.resize(np.ascontiguousarray(imgs[n, ..., :c]), dst[::-1],
                              interpolation=interp)
            np.testing.assert_array_equal(got[n], want)


def test_resize_frames_and_index_maps_match_jax():
    rng = np.random.default_rng(4)
    frames = rng.integers(0, 256, (3, 5, 53, 71)).astype(np.uint8)[:, :, 2:, ::-1]
    for size in ((60, 80), (32, 48)):
        np.testing.assert_array_equal(paugs.resize_frames(frames, *size, False),
                                      jaugs.resize_frames(frames, *size, False))
        np.testing.assert_array_equal(paugs.resize_frames(frames, *size, True),
                                      jaugs.resize_frames(frames, *size, True))
    kw = dict(num_frames_load=8, num_frames_clip=6, frame_height=32, frame_width=48,
              frame_stride=2, do_random_augs=True, augs_2d=True, reverse_prob=0.5,
              palindrome_prob=0.5, center_crop=True, defer_color_jitter=True,
              time_stretch_max=3.0)
    jp, pp = jaugs.AugmentationPipeline(**kw), paugs.AugmentationPipeline(**kw)
    for seed in range(6):
        want = jp.sample_augs_params(np.random.default_rng(seed))
        got = pp.sample_augs_params(np.random.default_rng(seed))
        np.testing.assert_array_equal(pp.frame_times(got), jp.frame_times(want))
        for g, w in zip(pp.nearest_index_maps(got, 50, 90), jp.nearest_index_maps(want, 50, 90)):
            np.testing.assert_array_equal(g, w)
    # The host colour path (defer_color_jitter off): the colour ops on the host, then
    # the float resize, as the JAX package runs them.
    host = {**kw, 'defer_color_jitter': False}
    jh, ph = jaugs.AugmentationPipeline(**host), paugs.AugmentationPipeline(**host)
    rgb = rng.integers(0, 256, (3, 8, 40, 60)).astype(np.uint8)
    for seed in range(6):
        want = jh.apply_augs_2d_frames({'rgb': rgb}, jh.sample_augs_params(
            np.random.default_rng(seed)))['rgb']
        got = ph.apply_augs_2d_frames({'rgb': rgb}, ph.sample_augs_params(
            np.random.default_rng(seed)))['rgb']
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------------------
# Items, batches, loaders
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('size', sorted(SIZES))
@pytest.mark.parametrize('phase', ['train', 'val_aug', 'val_noaug'])
def test_kubric_items_and_batches_match_jax(jax_root, phase, size):
    '''Two epochs, several indices: every item key (rgb, masks, segm, frame_times, colour
    keys, DAG, desirability, augmentation parameters) and the collated batch (queries
    included) are bit-equal.'''
    fh, fw = SIZES[size]
    kw = dict(ITEM_KW, frame_height=fh, frame_width=fw, use_cache=False)
    jds = jkub.KubricQueryDataset(jax_root, None, phase, **kw)
    pds = pkub.KubricQueryDataset(jax_root, None, phase, **kw)
    for epoch in (0, 1):
        jds.set_epoch(epoch)
        pds.set_epoch(epoch)
        indices = range(len(pds)) if phase == 'train' else [1, 0]
        jit, pit = [jds[i] for i in indices], [pds[i] for i in indices]
        for i, (g, w) in enumerate(zip(pit, jit)):
            assert_items_equal(g, w, f'{phase} {size} e{epoch} i{i}')
        want = jkub.collate_kubric(jit, 2, phase, rng=np.random.default_rng(epoch))
        got = pkub.collate_kubric(pit, 2, phase, rng=np.random.default_rng(epoch))
        assert_items_equal(got, want, f'{phase} {size} e{epoch} batch')


def test_items_from_the_port_writer_and_cache_match_jax(tmp_path):
    '''A dataset the port wrote, read through the port's .npy cache (second read), against
    the JAX loader reading the JAX writer's dataset with its own cache.'''
    for pkg, writer in (('j', jsyn), ('p', psyn)):
        writer.write_synthetic_kubric_dataset(str(tmp_path / pkg / 'train'), num_scenes=2,
                                              seed=21, **SCENE_KW)
    kw = dict(ITEM_KW, frame_height=32, frame_width=48)
    jds = jkub.KubricQueryDataset(str(tmp_path / 'j'), None, 'train', **kw)
    pds = pkub.KubricQueryDataset(str(tmp_path / 'p'), None, 'train', **kw)
    for _ in range(2):
        for i in range(2):
            g, w = pds[i], jds[i]
            for k in ('scene_dp', 'scene_dn'):
                g.pop(k), w.pop(k)
            assert_items_equal(g, w, f'item {i}')
    caches = [d for d in os.listdir(pds.scene_dps[0]) if d.startswith(pkub.CACHE_PREFIX)]
    assert caches and os.path.exists(os.path.join(pds.scene_dps[0], caches[0],
                                                  'pv_rgb_u8.npy'))


def test_native_and_numpy_paths_give_equal_items(jax_root, monkeypatch):
    kw = dict(ITEM_KW, frame_height=64, frame_width=96, use_cache=False)
    ds = pkub.KubricQueryDataset(jax_root, None, 'train', **kw)
    want = [ds[i] for i in range(2)]
    monkeypatch.setenv('TCOW_NO_NATIVE', '1')
    assert not native.enabled()
    for i in range(2):
        got = ds[i]
        # The numpy chain packs the masks in the collate, not in the item.
        assert 'div_segm_packed_w' not in got
        w = dict(want[i])
        w.pop('div_segm_packed_w')
        assert_items_equal(got, w, f'item {i}')
    batch_np = pkub.collate_kubric([ds[0], ds[1]], 2, 'train', rng=np.random.default_rng(0))
    batch_nat = pkub.collate_kubric(want, 2, 'train', rng=np.random.default_rng(0))
    assert_items_equal(batch_np, batch_nat, 'batch')


def test_batch_keys_are_what_unpack_batch_reads(jax_root):
    ds = pkub.KubricQueryDataset(jax_root, None, 'train', frame_height=32, frame_width=48,
                                 use_cache=False, **ITEM_KW)
    batch = pkub.collate_kubric([ds[0], ds[1]], 2, 'train', rng=np.random.default_rng(0))
    assert set(batch) == {'rgb_u8', 'div_segm_packed', 'segm_u8', 'jitter_factors',
                          'jitter_order', 'blur_gray', 'frame_times', 'query_inds',
                          'query_time', 'occl_fracs', 'occl_cont_dag'}
    dev = pstep.unpack_batch(batch, torch.device('cpu'))
    assert set(dev) == {'rgb', 'div_segm', 'segm', 'frame_times', 'query_inds',
                        'query_time', 'occl_fracs', 'occl_cont_dag'}
    assert dev['rgb'].shape == (2, 3, 6, 32, 48) and dev['rgb'].dtype == torch.float32
    assert dev['div_segm'].shape == (2, 8, 6, 32, 48)
    np.testing.assert_array_equal(dev['frame_times'].numpy(), batch['frame_times'])


def make_loader(root, mode, workers=2):
    ds = pkub.KubricQueryDataset(root, None, 'train', frame_height=32, frame_width=48,
                                 **ITEM_KW)
    return pfactory.PrefetchLoader(ds, batch_size=2, collate_fn=pfactory.make_kubric_collate(
        2, 'train', seed=7), shuffle=True, drop_last=False, num_workers=workers, seed=7,
        worker_mode=mode)


def test_loader_order_is_the_same_in_both_worker_modes(jax_root):
    '''Thread workers and forkserver process workers give the same batches, and the
    same as JAX's PrefetchLoader order.'''
    from tcow_tpu.data import factory as jfactory
    for epoch in (0, 1):
        lt, lp = make_loader(jax_root, 'thread'), make_loader(jax_root, 'process')
        lt.set_epoch(epoch)
        lp.set_epoch(epoch)
        bt, bp = list(lt), list(lp)
        assert len(bt) == len(bp) == 2
        for a, b in zip(bt, bp):
            assert_items_equal(b['device'], a['device'], f'e{epoch}')
            assert a['meta']['scene_dn'] == b['meta']['scene_dn']
        jl = jfactory.PrefetchLoader(list(range(3)), batch_size=2, collate_fn=list,
                                     shuffle=True, drop_last=False, num_workers=1, seed=7)
        jl.set_epoch(epoch)
        assert [list(b['meta']['dset_idx']) for b in bt] == list(jl)


@pytest.mark.parametrize('mode', ['thread', 'process'])
def test_iter_batches_resumes_mid_epoch(jax_root, mode):
    loader = make_loader(jax_root, mode)
    loader.set_epoch(3)
    full = [b['meta']['dset_idx'] for b in loader]
    tail = [b['meta']['dset_idx'] for b in loader.iter_batches(1)]
    assert len(tail) == 1
    np.testing.assert_array_equal(tail[0], full[1])
    loader.start_ahead(4)
    ahead = [b['meta']['dset_idx'] for b in loader.iter_batches(0)]
    loader.set_epoch(4)
    assert [list(x) for x in ahead] == [list(b) for b in loader.batch_order()]


def test_iter_batches_skips_without_loading():
    touched = []

    class _DS:
        def __len__(self):
            return 12

        def __getitem__(self, i):
            touched.append(i)
            return i

    loader = pfactory.PrefetchLoader(_DS(), batch_size=2, collate_fn=list, shuffle=True,
                                     drop_last=True, num_workers=1, seed=5)
    loader.set_epoch(3)
    full = list(loader)
    touched.clear()
    assert list(loader.iter_batches(2)) == full[2:]
    assert sorted(touched) == sorted(sum(full[2:], []))
    loader.set_epoch(4)
    assert list(loader) != full


def test_loader_factory_phases_and_refusals(jax_root):
    argv = ['--data_path', jax_root, '--num_frames', '6', '--kubric_max_delay', '2',
            '--frame_height', '32', '--frame_width', '48', '--batch_size', '2',
            '--num_queries', '2', '--max_objects', '8', '--do_val_noaug', '1',
            '--num_workers', '1']
    args = pconfig.train_args(argv)
    train, val_aug, val_noaug, dset_args = pfactory.create_train_val_data_loaders(args, None)
    assert (len(train), len(val_aug), len(val_noaug)) == (1, 1, 1)
    assert dset_args['kubric']['device_color_jitter'] is True
    batch = next(iter(val_noaug))
    assert batch['device']['rgb_u8'].shape == (2, 3, 6, 32, 48)
    # --device_augs 0 and the default on the CPU colour on the host.
    for extra in (['--device_augs', '0'], ['--device', 'cpu']):
        args = pconfig.train_args(argv + extra)
        assert pfactory.kubric_dset_args(args)['device_color_jitter'] is False
