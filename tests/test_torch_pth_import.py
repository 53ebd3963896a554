'''
Reference `.pth` checkpoints in the port (tcow_tpu_torch/models/torch_import.py) against
tcow_tpu.models.torch_import on the CPU: a reference-layout TCOW checkpoint written from
numpy-seeded weights (32x48, T=4, depth 2 at width 64) for both attention types gives
bit-equal trees and the same seeker outputs; the ImageNet ViT inflation and its merge
into an initialised backbone are bit-equal; `module.` / `seeker.` wrappers are stripped;
a .pth-only experiment directory resolves and loads as in JAX; the driver bootstraps from
a .pth and refuses a .pth resume without --allow_opt_reinit.
'''

import argparse
import logging
import os
import pickle

import jax
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.evaluation import inference as jinference
from tcow_tpu.models import mask_tracker as jmt
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu.models import torch_import as jimport
from tcow_tpu.train import checkpoint as jckpt
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch.evaluation import inference as pinference
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.models import torch_import as pimport
from tcow_tpu_torch.models.seeker import Seeker
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import driver as pdriver
from tcow_tpu_torch.utils.logvis import MyLogger
from tcow_tpu_torch.weights import params_to_jax

DIVIDED, JOINT = 'divided_space_time', 'joint_space_time'
DEPTH, WIDTH, HEADS, PATCH = 2, 64, 4, 16
T, H, W = 4, 32, 48
BB_PREFIX = 'tracker_backbone.timesformer.model.'
# fp32 tolerance of tests/test_pallas_attention.py:31 (the two packages sum in other orders).
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(jtsf.DEPTH_PRESETS, DEPTH, (WIDTH, HEADS))
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, DEPTH, (WIDTH, HEADS))


def seeker_args(attention_type):
    return dict(num_total_frames=T, num_visible_frames=T, frame_height=H, frame_width=W,
                tracker_pretrained='0', attention_type=attention_type, patch_size=PATCH,
                causal_attention=1, norm_embeddings=False, drop_path_rate=0.0,
                network_depth=DEPTH, track_map_stride=4, track_map_resize='bilinear',
                query_channels=1, output_channels=3, flag_channels=3)


def numpy_tree(attention_type, seed=0):
    '''A seeker tree in the JAX layout with numpy-seeded weights (every leaf random).'''
    model = pmt.MaskTracker(pmt.seeker_config_from_args(seeker_args(attention_type)))
    rng = np.random.RandomState(seed)
    return params_to_jax({k: torch.from_numpy(0.05 * rng.randn(*v.shape).astype(np.float32))
                          for k, v in model.state_dict().items()})


def reference_state_dict(tree, attention_type):
    '''The reference QueryMaskTracker state dict of a seeker tree (the port's exporter),
    with a classifier head in the backbone that the import ignores.'''
    sd = pimport.seeker_state_dict_to_torch(
        tree, pmt.seeker_config_from_args(seeker_args(attention_type)))
    sd[BB_PREFIX + 'head.weight'], sd[BB_PREFIX + 'head.bias'] = torch.ones(5, WIDTH), torch.ones(5)
    return sd


def write_reference_pth(path, tree, attention_type, epoch=4):
    '''A reference TCOW checkpoint: net_seeker, seeker_args, an argparse train_args, epoch.'''
    os.makedirs(os.path.dirname(path), exist_ok=True)
    torch.save({'epoch': epoch, 'net_seeker': reference_state_dict(tree, attention_type),
                'seeker_args': seeker_args(attention_type), 'dset_args': {'kubric': {}},
                'train_args': argparse.Namespace(num_frames=T, seed=900)}, path)
    return str(path)


def assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('attention_type', [DIVIDED, JOINT])
def test_pth_loads_like_jax(tiny_preset, tmp_path, attention_type):
    '''Both loaders give the tree the file was written from, bit for bit, and the same
    config; the seeker built from the file matches JAX's forward of it.'''
    tree = numpy_tree(attention_type)
    path = write_reference_pth(tmp_path / 'ref' / 'checkpoint.pth', tree, attention_type)
    jparams, jcfg, jck = jimport.load_tcow_checkpoint(path)
    params, cfg, ck = pimport.load_tcow_checkpoint(path)
    assert_trees_equal(params, jparams)
    assert_trees_equal(params, tree)
    assert (cfg.attention_type, cfg.network_depth, cfg.causal_attention) == (
        jcfg.attention_type, jcfg.network_depth, jcfg.causal_attention)
    assert ck['epoch'] == jck['epoch'] == 4
    rng = np.random.RandomState(3)
    rgb = rng.rand(2, 3, T, H, W).astype(np.float32)
    query = (rng.rand(2, 1, T, H, W) > 0.7).astype(np.float32)
    want = jmt.forward(jparams, jcfg, rgb, query)
    got = Seeker.from_checkpoint(path, device='cpu')(rgb, query)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def imagenet_vit(seed, patch_2d=False, time_embed=False):
    '''A timm-layout image ViT state dict at width 64 on a 3x3 patch grid: a conv patch
    embedding (or the 2-D manual-patchify weight), no temporal weights, a classifier head;
    with time_embed, 8 frames of it.'''
    rng = np.random.RandomState(seed)
    r = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))
    sd = {'patch_embed.proj.weight': (r(WIDTH, 3 * PATCH * PATCH) if patch_2d
                                      else r(WIDTH, 3, PATCH, PATCH)),
          'patch_embed.proj.bias': r(WIDTH), 'cls_token': r(1, 1, WIDTH),
          'pos_embed': r(1, 10, WIDTH), 'norm.weight': r(WIDTH), 'norm.bias': r(WIDTH),
          'head.weight': r(1000, WIDTH), 'head.bias': r(1000)}
    if time_embed:
        sd['time_embed'] = r(1, 8, WIDTH)
    for i in range(DEPTH):
        for name, shape in (('attn.qkv', (3 * WIDTH, WIDTH)), ('attn.proj', (WIDTH, WIDTH)),
                            ('mlp.fc1', (4 * WIDTH, WIDTH)), ('mlp.fc2', (WIDTH, 4 * WIDTH)),
                            ('norm1', (WIDTH,)), ('norm2', (WIDTH,))):
            sd[f'blocks.{i}.{name}.weight'] = r(*shape)
            sd[f'blocks.{i}.{name}.bias'] = r(shape[0])
    return sd


@pytest.mark.parametrize('in_chans,attention_type,patch_2d,time_embed',
                         [(4, DIVIDED, False, False), (7, JOINT, True, True)])
def test_imagenet_inflation_matches_jax(in_chans, attention_type, patch_2d, time_embed):
    '''inflate_imagenet_vit_state_dict and apply_pretrained_to_params bit-equal to JAX's:
    channels inflated to in_chans, pos_embed resized from 9 patches to 6, time_embed
    (where present) from 8 frames to 4, spatial weights copied to the temporal ones
    (divided), and the init kept where the file has nothing.'''
    sd = imagenet_vit(5, patch_2d, time_embed)
    kw = dict(in_chans=in_chans, num_patches=6, num_frames=T, attention_type=attention_type)
    got = pimport.inflate_imagenet_vit_state_dict(sd, **kw)
    want = jimport.inflate_imagenet_vit_state_dict(sd, **kw)
    assert got.keys() == want.keys() and not any(k.startswith('head.') for k in got)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got['patch_embed.proj.weight'].shape == (WIDTH, in_chans, PATCH, PATCH)
    common = dict(frame_height=H, frame_width=W, in_channels=in_chans, num_frames=T,
                  depth=DEPTH, embed_dim=WIDTH, num_heads=HEADS, attention_type=attention_type)
    init = jax.tree.map(np.asarray, jtsf.init_params(jax.random.key(1),
                                                     jtsf.TimeSformerConfig(**common)))
    merged = pimport.apply_pretrained_to_params(init, got, ptsf.TimeSformerConfig(**common))
    assert_trees_equal(merged, jimport.apply_pretrained_to_params(
        init, want, jtsf.TimeSformerConfig(**common)))
    np.testing.assert_array_equal(merged['blocks']['attn']['qkv']['w'][1],
                                  sd['blocks.1.attn.qkv.weight'].numpy().T)
    if not time_embed:
        np.testing.assert_array_equal(merged['time_embed'], init['time_embed'])
    if attention_type == DIVIDED:
        np.testing.assert_array_equal(merged['blocks']['temporal_fc']['w'],
                                      init['blocks']['temporal_fc']['w'])


@pytest.mark.parametrize('wrapper', ['module.', 'seeker.', 'module.seeker.'])
def test_wrappers_are_stripped(tiny_preset, wrapper):
    tree = numpy_tree(DIVIDED, seed=2)
    sd = {wrapper + k: v for k, v in reference_state_dict(tree, DIVIDED).items()}
    cfg = pmt.seeker_config_from_args(seeker_args(DIVIDED))
    got = pimport.seeker_params_from_torch(sd, cfg)
    assert_trees_equal(got, tree)
    assert_trees_equal(got, jimport.seeker_params_from_torch(
        sd, jmt.seeker_config_from_args(seeker_args(DIVIDED))))


def _touch(path):
    open(path, 'w').close()


class _RunsCode:
    '''Unpickling it would call _touch(path).'''
    def __init__(self, path):
        self.path = path

    def __reduce__(self):
        return _touch, (self.path,)


def test_pth_load_runs_no_code(tmp_path):
    '''A .pth is unpickled with weights_only: an argparse train_args loads, and an object
    whose unpickling would call a function is refused without calling it.'''
    good = tmp_path / 'good.pth'
    torch.save({'epoch': 2, 'train_args': argparse.Namespace(seed=900)}, good)
    ckpt = pimport.load_torch_file(str(good))
    assert ckpt['train_args'].seed == 900
    assert pckpt.get_checkpoint_epoch(str(good)) == 2
    flag = tmp_path / 'ran'
    bad = tmp_path / 'bad.pth'
    torch.save({'epoch': 2, 'obj': _RunsCode(str(flag))}, bad)
    for load in (pimport.load_torch_file, pckpt.get_checkpoint_epoch):
        with pytest.raises(pickle.UnpicklingError):
            load(str(bad))
    assert not flag.exists()


def test_pth_only_directory_resolves_and_loads_as_jax(tiny_preset, tmp_path):
    '''An experiment directory holding only reference .pth files: --resume and
    load_networks pick the file JAX picks (model_{epoch}.pth for a given epoch, else
    checkpoint.pth), read its epoch and load the same tree and arguments; an .npz beside
    them takes precedence in both.'''
    root = tmp_path / 'ck'
    tree = numpy_tree(JOINT, seed=4)
    write_reference_pth(root / 'exp' / 'checkpoint.pth', tree, JOINT, epoch=4)
    write_reference_pth(root / 'exp' / 'model_2.pth', numpy_tree(JOINT, seed=5), JOINT, epoch=2)
    for epoch in (-1, 2, 7):
        got = pconfig.resolve_resume_path(str(root), 'exp', epoch)
        assert got == jckpt.resolve_resume_path(str(root), 'exp', epoch)
        assert pckpt.get_checkpoint_epoch(got) == jckpt.get_checkpoint_epoch(got)
    args = pconfig.test_args(['--resume', 'exp', '--name', 't', '--data_path', 'clip.mp4',
                              '--checkpoint_root', str(root), '--log_root', str(tmp_path / 'lg'),
                              '--device', 'cpu'])
    assert args.resume == str(root / 'exp' / 'checkpoint.pth') and args.name == 't_e4'
    got = pinference.load_networks(str(root / 'exp'), logging.getLogger('t'), device='cpu')
    want = jinference.load_networks(str(root / 'exp'), logging.getLogger('t'))
    assert_trees_equal(got[0], want[0])
    assert got[1].attention_type == want[1].attention_type == JOINT
    assert got[2:] == want[2:] and got[5] == 4 and got[2]['seed'] == 900
    pckpt.save_checkpoint(str(root / 'exp'), 6, 'exp', tree, seeker_args=seeker_args(JOINT))
    got = pconfig.resolve_resume_path(str(root), 'exp', 6)
    assert got == jckpt.resolve_resume_path(str(root), 'exp', 6)
    assert got.endswith('model_6.npz')


def test_driver_bootstraps_from_pth(tiny_preset, tmp_path):
    '''--tracker_pretrained <file.pth>: a TCOW checkpoint loads whole; an image ViT (under
    'model') is inflated over the random init, which keeps time_embed and temporal_fc.'''
    log = logging.getLogger('t')
    args = seeker_args(DIVIDED)
    tree = numpy_tree(DIVIDED, seed=6)
    path = write_reference_pth(tmp_path / 'tcow.pth', tree, DIVIDED)
    cfg = pmt.seeker_config_from_args({**args, 'tracker_pretrained': path})
    assert cfg.pretrained
    model = pmt.MaskTracker(cfg)
    model.init_params_(torch.Generator().manual_seed(0))
    pdriver.init_seeker_params(model, cfg, {**args, 'tracker_pretrained': path}, log)
    assert_trees_equal(params_to_jax(model.state_dict()), tree)

    vit = tmp_path / 'vit.pth'
    torch.save({'model': imagenet_vit(7)}, vit)
    model.init_params_(torch.Generator().manual_seed(0))
    init = params_to_jax(model.state_dict())
    pdriver.init_seeker_params(model, cfg, {**args, 'tracker_pretrained': str(vit)}, log)
    got = params_to_jax(model.state_dict())
    want = jimport.apply_pretrained_to_params(
        init['backbone'], jimport.inflate_imagenet_vit_state_dict(
            imagenet_vit(7), in_chans=4, num_patches=6, num_frames=T),
        jmt.seeker_config_from_args(args).backbone_config())
    assert_trees_equal(got['backbone'], want)
    assert_trees_equal(got['post_linear'], init['post_linear'])
    np.testing.assert_array_equal(got['backbone']['blocks']['temporal_fc']['w'],
                                  init['backbone']['blocks']['temporal_fc']['w'])


def test_resume_pth_needs_allow_opt_reinit(tiny_preset, tmp_path):
    '''--resume x.pth without --allow_opt_reinit raises the JAX driver's ValueError before
    any data is read.'''
    path = write_reference_pth(tmp_path / 'ck' / 'ref' / 'checkpoint.pth',
                               numpy_tree(DIVIDED), DIVIDED)
    argv = ['--name', 'boot', '--data_path', str(tmp_path / 'no_data'), '--resume', path,
            '--checkpoint_root', str(tmp_path / 'ck'), '--log_root', str(tmp_path / 'lg'),
            '--network_depth', str(DEPTH), '--num_frames', str(T), '--frame_height', str(H),
            '--frame_width', str(W), '--device', 'cpu', '--avoid_wandb', '2']
    args = pconfig.train_args(argv)
    assert args.resume == path
    logger = MyLogger(args, context='train')
    try:
        with pytest.raises(ValueError, match='Pass --allow_opt_reinit 1 to accept that'):
            pdriver.main(args, logger)
    finally:
        logger.close()
