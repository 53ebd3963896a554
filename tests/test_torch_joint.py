'''
Joint space-time attention in the port against tcow_tpu on the CPU in float32: the
backbone and the seeker at causal_attention 0 and 1 (a joint block ignores it), the loss
and every gradient of the tiny seeker under each pairing of an attention-backward mode
with its remat policy, the joint tree (no temporal weights) and its optimizer state
through a checkpoint both ways, and what a joint model refuses (temporal_rope, streaming).
'''

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.data import synthetic as jsyn
from tcow_tpu.models import mask_tracker as jmt
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu.objectives import losses as jlosses
from tcow_tpu.train import checkpoint as jckpt
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch import serving
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import streaming as pstream
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

JOINT = 'joint_space_time'
# Tiny preset: depth 2 at width 64 with 4 heads, T=4 at 32x48 (6 patches, so one joint
# sequence of 1 + 6 * 4 = 25 tokens), B=2 clips, Q=2, M=8, K=4.
DEPTH = 2
SEEKER_KW = dict(num_total_frames=4, frame_height=32, frame_width=48, attention_type=JOINT,
                 drop_path_rate=0.0, network_depth=DEPTH)
BATCH_KW = dict(B=2, Q=2, T=4, H=32, W=48, M=8, K=4)
PROGRESS = 0.05
PAIRINGS = [('kernel_x', 'dots_nb_out'), ('kernel_qkv', 'dots_nb_out_qkv'),
            ('res', 'dots_nb'), ('kernel_x_wg', 'dots_nb_out')]
# fp32 tolerance of tests/test_pallas_attention.py:31 for outputs; the losses and gradient
# leaves of tests/test_torch_remat_policy.py (elements near zero against 1e-5 of the
# leaf's largest magnitude).
RTOL, ATOL = 2e-4, 2e-5
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4, 1e-5
OPT_KW = dict(learn_rate=1e-3, lr_decay=0.3, num_epochs=5, steps_per_epoch=1,
              gradient_clip=0.3)


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(jtsf.DEPTH_PRESETS, DEPTH, (64, 4))
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, DEPTH, (64, 4))


def perturbed(params, seed):
    '''params with every leaf moved by numpy noise, so each bias and norm matters.'''
    rng = np.random.RandomState(seed)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.randn(*a.shape).astype(np.float32),
        params)


def seeker_params(ca=1, seed=0):
    return perturbed(jmt.init_params(jax.random.key(seed),
                                     jmt.SeekerConfig(**SEEKER_KW, causal_attention=ca)), seed)


def assert_leaves_close(got, want, rtol, atol_rel):
    gl, wl = jax.tree.leaves(got), jax.tree_util.tree_leaves_with_path(want)
    assert len(gl) == len(wl)
    for (path, w), g in zip(wl, gl):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=rtol,
                                   atol=atol_rel * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('what', ['backbone', 'seeker'])
@pytest.mark.parametrize('ca', [0, 1])
def test_joint_forward_matches_jax(tiny_preset, what, ca):
    rng = np.random.RandomState(1)
    if what == 'backbone':
        common = dict(frame_height=32, frame_width=48, in_channels=4, num_frames=4,
                      depth=DEPTH, embed_dim=64, num_heads=4, attention_type=JOINT,
                      causal_attention=ca)
        params = perturbed(jtsf.init_params(jax.random.key(2), jtsf.TimeSformerConfig(
            **common)), 2)
        x = rng.rand(2, 4, 4, 32, 48).astype(np.float32)
        want = jtsf.forward(params, jtsf.TimeSformerConfig(drop_path_rate=0.0, **common), x)
        model = ptsf.TimeSformer(ptsf.TimeSformerConfig(**common))
        inputs = (x,)
    else:
        params = seeker_params(ca)
        rgb = rng.rand(2, 3, 4, 32, 48).astype(np.float32)
        query = (rng.rand(2, 1, 4, 32, 48) > 0.7).astype(np.float32)
        want = jmt.forward(params, jmt.SeekerConfig(**SEEKER_KW, causal_attention=ca),
                           rgb, query)
        model = pmt.MaskTracker(pmt.SeekerConfig(**SEEKER_KW, causal_attention=ca))
        inputs = (rgb, query)
    assert all(isinstance(b, ptsf.JointBlock) for b in model.modules()
               if isinstance(b, (ptsf.JointBlock, ptsf.DividedBlock)))
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model(*(torch.from_numpy(a) for a in inputs))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


_JAX_LOSS_AND_GRADS = {}


def jax_loss_and_grads(params):
    '''JAX's loss and gradients of the tiny joint seeker at causal 1 (its XLA attention:
    every backward mode computes this function), computed once per module.'''
    if 'causal1' not in _JAX_LOSS_AND_GRADS:
        jcfg = jstep.StepConfig(seeker=jmt.SeekerConfig(**SEEKER_KW, causal_attention=1),
                                loss=jlosses.LossConfig(), num_queries=2)
        b = {k: jnp.asarray(v) for k, v in jsyn.synthetic_device_batch(0, **BATCH_KW).items()}
        fn = jax.jit(jax.value_and_grad(
            lambda p, batch: jstep._loss_and_aux(p, jcfg, batch, None, jnp.float32(PROGRESS),
                                                 True), has_aux=True))
        (loss, _), grads = fn(params, b)
        _JAX_LOSS_AND_GRADS['causal1'] = (float(loss), grads)
    return _JAX_LOSS_AND_GRADS['causal1']


@pytest.mark.parametrize('mode,policy', PAIRINGS)
def test_joint_pairing_loss_and_grads_match_jax(tiny_preset, mode, policy):
    '''One loss-and-backward of the tiny joint seeker under per-block remat, through the
    pairing's autograd path (its custom operator, backward and saved outputs), against
    JAX: 2 attention forwards per step, one per block, or 4 when the policy does not keep
    the forward's outputs.'''
    params = seeker_params()
    want_loss, want_grads = jax_loss_and_grads(params)
    cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**SEEKER_KW, causal_attention=1,
                                                   remat=True, attention_bwd=mode,
                                                   remat_policy=policy),
                           loss=plosses.LossConfig(), num_queries=2)
    model = pmt.MaskTracker(cfg.seeker)
    model.load_state_dict(params_from_jax(params))
    before = fa.fused_attention.calls[mode]
    loss, _ = pstep.loss_and_aux(model, cfg, jsyn.synthetic_device_batch(0, **BATCH_KW),
                                 None, PROGRESS, True)
    loss.backward()
    assert fa.fused_attention.calls[mode] - before == (2 if policy == 'dots_nb' else 1) * DEPTH
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_RTOL)
    grads = params_to_jax({k: torch.zeros_like(p) if p.grad is None else p.grad
                           for k, p in model.named_parameters()})
    assert_leaves_close(grads, want_grads, GRAD_RTOL, GRAD_ATOL_REL)


def test_joint_tree_and_optimizer_state_round_trip(tiny_preset, tmp_path):
    '''The joint tree (no temporal_norm1, temporal_attn or temporal_fc) goes into the
    port's modules and back bit for bit; after two AdamW steps the port's checkpoint
    holds every leaf of JAX's joint TrainState under its own path, and JAX restores the
    parameters and moments from it exactly.'''
    params = seeker_params()
    assert 'temporal_attn' not in params['backbone']['blocks']
    state_dict = params_from_jax(params)
    assert not any('temporal' in k for k in state_dict)
    model = pmt.MaskTracker(pmt.SeekerConfig(**SEEKER_KW))
    model.load_state_dict(state_dict)
    back = params_to_jax(model.state_dict())
    assert jax.tree.structure(back) == jax.tree.structure(params)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(g, w)

    cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**SEEKER_KW), loss=plosses.LossConfig(),
                           num_queries=2)
    state = pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **OPT_KW),
                                   params=params, device='cpu')
    train = pstep.make_train_step(cfg)
    for _ in range(2):
        state, _ = train(state, jsyn.synthetic_device_batch(0, **BATCH_KW), PROGRESS)
    path = pckpt.save_train_state(str(tmp_path), 1, 'joint', state)
    jcfg = jstep.StepConfig(seeker=jmt.SeekerConfig(**SEEKER_KW), loss=jlosses.LossConfig(),
                            num_queries=2)
    template = jstep.init_train_state(jax.random.key(0), jcfg,
                                      joptim.make_optimizer('adamw', **OPT_KW), params=params)
    assert set(pckpt.opt_state_to_jax(state.optimizer)) == set(
        jckpt._flatten_with_paths(template.opt_state))
    got = jckpt.load_checkpoint(path, template)['state']
    want = params_to_jax(state.model.state_dict())
    named = list(state.model.named_parameters())
    for tree, ref in ((got.params, want),
                      (got.opt_state[1][0].mu, params_to_jax(
                          {n: state.optimizer.torch_opt.state[p]['exp_avg'] for n, p in named})),
                      (got.opt_state[1][0].nu, params_to_jax(
                          {n: state.optimizer.torch_opt.state[p]['exp_avg_sq']
                           for n, p in named}))):
        assert jax.tree.structure(tree) == jax.tree.structure(ref)
        for g, w in zip(jax.tree.leaves(tree), jax.tree.leaves(ref)):
            np.testing.assert_array_equal(np.asarray(g), w)
    fresh = pstep.init_train_state(1, cfg, poptim.make_optimizer('adamw', **OPT_KW),
                                   device='cpu')
    pckpt.load_checkpoint(path, fresh)
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k


def test_joint_drop_path_masks_one_per_clip(tiny_preset):
    '''A joint block draws one spatial and one MLP mask per clip and no temporal mask,
    and a training forward with drop-path differs from the deterministic one.'''
    masks = ptsf.draw_drop_path_masks(torch.Generator().manual_seed(0), 0.5, DEPTH, 3, 6, 4,
                                      'cpu', divided=False)
    assert all(m.temporal is None and m.spatial.shape == (3,) and m.mlp.shape == (3,)
               for m in masks)
    model = pmt.MaskTracker(pmt.SeekerConfig(**{**SEEKER_KW, 'drop_path_rate': 0.9}))
    model.load_state_dict(params_from_jax(seeker_params()))
    rgb = torch.rand(2, 3, 4, 32, 48, generator=torch.Generator().manual_seed(1))
    query = torch.zeros(2, 1, 4, 32, 48)
    with torch.inference_mode():
        plain = model(rgb, query)[0]
        dropped = model(rgb, query, train=True, generator=torch.Generator().manual_seed(2))[0]
    assert torch.isfinite(dropped).all() and not torch.equal(plain, dropped)


def test_joint_temporal_rope_raises(tiny_preset):
    '''temporal_rope needs the divided temporal axis: both packages raise ValueError.'''
    with pytest.raises(ValueError, match='temporal_rope requires'):
        pmt.SeekerConfig(**SEEKER_KW, temporal_rope=True)
    with pytest.raises(ValueError, match='temporal_rope requires'):
        jmt.SeekerConfig(**SEEKER_KW, temporal_rope=True).backbone_config()
    with pytest.raises(ValueError, match='attention_type'):
        pmt.SeekerConfig(**{**SEEKER_KW, 'attention_type': 'space_only'})


def test_stream_refuses_joint(tiny_preset):
    '''The stream's cache is the temporal attention's, which a joint model lacks: the
    stream and the server raise a ValueError naming the attention type.'''
    cfg = pmt.SeekerConfig(**SEEKER_KW, causal_attention=1)
    model = pmt.MaskTracker(cfg)
    model.load_state_dict(params_from_jax(seeker_params()))
    with pytest.raises(ValueError, match=JOINT):
        pstream.init_stream(model, 1)
    with pytest.raises(ValueError, match=JOINT):
        pstream.init_stream_multi(model, 2, window=3)
    with pytest.raises(ValueError, match=JOINT):
        serving.TrackerServer(seeker_params(), cfg, device='cpu')
    divided = dataclasses.replace(cfg, attention_type='divided_space_time')
    pstream.check_streamable(divided)
