'''
The port's training slice against tcow_tpu on the CPU in float32: the synthetic batch,
supervision, losses, the learning-rate schedule, and the whole train step (loss, aux,
gradient norm, every gradient leaf, parameters after 1 and 3 AdamW steps) from the same
weights, plus the port's own guarantees (NaN skip, drop-path under remat, unpacking).
'''


import functools

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
from tcow_tpu.objectives import supervision as jsup
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.data import synthetic as psyn
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.objectives import supervision as psup
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

# Tiny preset: depth 2 at width 64 with 4 heads, T=4 at 32x48, B=2 clips, Q=2, M=8, K=4.
SEEKER_KW = dict(num_total_frames=4, frame_height=32, frame_width=48, causal_attention=1,
                 drop_path_rate=0.0, network_depth=2)
BATCH_KW = dict(B=2, Q=2, T=4, H=32, W=48, M=8, K=4)
# Optimizer: milestones at updates 2, 3 and 4 (num_epochs 5), so 3 steps cross a decay.
OPT_KW = dict(learn_rate=1e-3, lr_decay=0.3, num_epochs=5, steps_per_epoch=1,
              gradient_clip=0.3)
PROGRESS = 0.05
# Tolerances, f32 on the CPU; the two implementations differ in the order of their sums.
# Losses and aux (measured: 3.4e-7 relative).
LOSS_RTOL = 1e-5
# Gradient norm after updates: the parameters already differ by ~6e-7 (measured 4.8e-6
# relative at step 3).
NORM_RTOL = 5e-5
# Gradient leaves through two blocks, the top-k bisection and the softmax backward;
# elements near zero compare against the leaf's scale (measured 4.4e-7 of the leaf max).
GRAD_RTOL, GRAD_ATOL_REL = 1e-4, 1e-5
# Parameters after AdamW updates of size ~lr = 1e-3 (measured 6.1e-7 absolute).
PARAM_ATOL = 5e-6


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(jtsf.DEPTH_PRESETS, 2, (64, 4))
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, 2, (64, 4))


@pytest.fixture
def jax_params(tiny_preset):
    cfg = jmt.SeekerConfig(**SEEKER_KW)
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.randn(*a.shape).astype(np.float32),
        jmt.init_params(jax.random.key(0), cfg))


def configs(loss_kw=None, seeker_kw=None):
    loss = dict(loss_kw or {})
    seeker = {**SEEKER_KW, **(seeker_kw or {})}
    jcfg = jstep.StepConfig(seeker=jmt.SeekerConfig(**seeker),
                            loss=jlosses.LossConfig(**loss), num_queries=2)
    pcfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**seeker),
                            loss=plosses.LossConfig(**loss), num_queries=2)
    return jcfg, pcfg


def batch(seed=0):
    return jsyn.synthetic_device_batch(seed, **BATCH_KW)


@functools.lru_cache(maxsize=None)
def jax_train_step(optimizer, grad_accum=1):
    '''The JAX package's train step at configs() and OPT_KW, jitted once per
    (optimizer, grad_accum), so that tests taking the same step share its compile.'''
    jcfg, _ = configs()
    tx = joptim.make_optimizer(optimizer, **OPT_KW)
    return jax.jit(jstep.make_train_step(jcfg, tx, grad_accum=grad_accum))


def grads_to_jax(model):
    return params_to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                          for k, p in model.named_parameters()})


def assert_tree_close(got, want, rtol, atol_rel=0.0, atol=0.0):
    gl, wl = jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)
    assert len(gl) == len(wl)
    for (path, w), g in zip(gl, wl):
        w = np.asarray(w)
        np.testing.assert_allclose(
            np.asarray(g), w, rtol=rtol, atol=max(atol, atol_rel * float(np.abs(w).max())),
            err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------------------
# Data, supervision, losses, schedule
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('seed,kw', [(0, BATCH_KW), (3, dict(B=3, Q=1, T=5, H=40, W=24,
                                                            M=6, K=3, query_time=2))])
def test_synthetic_batch_is_bit_identical(seed, kw):
    want, got = jsyn.synthetic_device_batch(seed, **kw), psyn.synthetic_device_batch(seed, **kw)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def supervision_inputs(seed):
    '''A synthetic batch whose DAG and occlusion fractions cross the thresholds, with ties
    in the occluder and container rows.'''
    b = jsyn.synthetic_device_batch(seed, B=2, Q=3, T=5, H=24, W=32, M=6, K=5)
    rng = np.random.RandomState(seed)
    b['occl_cont_dag'] = rng.rand(*b['occl_cont_dag'].shape).astype(np.float32)
    b['occl_cont_dag'][:, :, :, 2, :] = b['occl_cont_dag'][:, :, :, 3, :]   # ties
    b['occl_fracs'][..., 0] = rng.choice([0.5, 0.96, 1.0], b['occl_fracs'].shape[:-1])
    b['query_time'] = np.int32(1)
    return b


@pytest.mark.parametrize('seed', [0, 1])
def test_supervision_matches_jax(seed):
    b = supervision_inputs(seed)
    keys = ('segm', 'div_segm', 'query_inds', 'query_time', 'occl_fracs', 'occl_cont_dag')
    want = jsup.fill_query_target_batch(*(jnp.asarray(b[k]) for k in keys))
    got = psup.fill_query_target_batch(*(torch.as_tensor(b[k]) for k in keys))
    assert set(got) == set(want)
    assert float(want['target_flags'][..., 0].sum()) > 0   # occluded frames exist
    assert float(want['target_flags'][..., 1].sum()) > 0   # contained frames exist
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize('loss_kw,progress', [
    ({}, 0.0), ({}, 0.05), ({}, 0.5), (dict(focal_loss=True), 0.05),
    (dict(aot_loss=0.0), 0.05), (dict(class_balancing=False, hard_negative_factor=1.0), 0.2),
    (dict(qt_downweight_last_only=True), 0.05)])
def test_compute_losses_match_jax(loss_kw, progress):
    b = supervision_inputs(2)
    keys = ('segm', 'div_segm', 'query_inds', 'query_time', 'occl_fracs', 'occl_cont_dag')
    sup = {k: np.asarray(v) for k, v in
           jsup.fill_query_target_batch(*(jnp.asarray(b[k]) for k in keys)).items()}
    B, Q = b['query_inds'].shape
    sel = b['occl_fracs'][np.arange(B)[:, None], b['query_inds']]
    logits = np.random.RandomState(5).randn(*sup['target_mask'].shape).astype(np.float32) * 2
    args = tuple(np.array(a) for a in (logits, sup['target_mask'], sel,
                                       sup['snitch_occl_by_ptr'], b['query_time']))
    want = jlosses.compute_losses(jlosses.LossConfig(**loss_kw), *map(jnp.asarray, args),
                                  jnp.float32(progress))
    got = plosses.compute_losses(plosses.LossConfig(**loss_kw), *map(torch.as_tensor, args),
                                 progress)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)


def test_topk_mean_stays_exact_on_ties():
    rng = np.random.RandomState(0)
    values = np.round(rng.rand(4, 50).astype(np.float32) * 4) / 4     # many ties
    mask = rng.rand(4, 50) > 0.3
    for k in (1, 7, 40):
        got = plosses.topk_mean_masked(torch.from_numpy(values), torch.from_numpy(mask),
                                       torch.tensor(k, dtype=torch.int32))
        want = np.sort(values[mask])[::-1][:k].mean()
        np.testing.assert_allclose(float(got), want, rtol=1e-6)


@pytest.mark.parametrize('num_epochs,steps_per_epoch', [(70, 1000), (5, 1), (2, 3)])
def test_multistep_schedule_matches_optax(num_epochs, steps_per_epoch):
    want = joptim.multistep_schedule(1e-4, 0.3, num_epochs, steps_per_epoch)
    got = poptim.multistep_schedule(1e-4, 0.3, num_epochs, steps_per_epoch)
    for count in sorted({0, 1, 2, 3, 5, 6, 27999, 28000, 42000, 55999, 56000, 70000,
                         num_epochs * steps_per_epoch}):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   err_msg=str(count))


def test_lamb_and_accumulation_build_and_bad_settings_raise(tiny_preset):
    '''LAMB and grad_accum=2 build; an unknown optimizer raises, and so does a grad_accum
    that does not divide the batch, when the step splits it.'''
    assert poptim.make_optimizer('lamb').name == 'lamb'
    _, pcfg = configs()
    assert callable(pstep.make_train_step(pcfg, grad_accum=2))
    with pytest.raises(ValueError, match='unknown optimizer'):
        poptim.make_optimizer('adagrad')
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer('lamb', **OPT_KW),
                                   device='cpu')
    with pytest.raises(ValueError, match='does not divide'):
        pstep.make_train_step(pcfg, grad_accum=3)(state, batch(), PROGRESS)


def test_unpack_batch_expands_compact_forms():
    b = batch()
    compact = dict(b)
    compact['div_segm_packed'] = np.packbits(compact.pop('div_segm'), axis=-1)
    compact['rgb_u8'] = np.round(compact.pop('rgb') * 255).astype(np.uint8)
    compact['segm_u8'] = compact.pop('segm').astype(np.uint8)
    got = pstep.unpack_batch(compact, 'cpu')
    np.testing.assert_array_equal(got['div_segm'].numpy(), b['div_segm'])
    np.testing.assert_array_equal(got['segm'].numpy(), b['segm'])
    assert got['segm'].dtype == torch.int32
    np.testing.assert_allclose(got['rgb'].numpy(), compact['rgb_u8'] / 255.0, rtol=1e-6)
    # Colour keys are consumed on the device: a brightness of 0.5 applied to example 0
    # only (its apply flag), the order starting with brightness.
    factors = np.array([[0.5, 1, 1, 0, 1], [0.5, 1, 1, 0, 0]], np.float32)
    order = np.tile(np.arange(4, dtype=np.int32), (2, 1))
    got = pstep.unpack_batch({**b, 'jitter_factors': factors, 'jitter_order': order}, 'cpu')
    assert not {'jitter_factors', 'jitter_order'} & set(got)
    np.testing.assert_allclose(got['rgb'][0].numpy(), b['rgb'][0] * 0.5, rtol=1e-6)
    np.testing.assert_array_equal(got['rgb'][1].numpy(), b['rgb'][1])


def test_seeker_args_carry_drop_path_rate():
    cfg = pmt.seeker_config_from_args({'drop_path_rate': 0.25})
    assert cfg.drop_path_rate == 0.25 and cfg.backbone_config().drop_path_rate == 0.25
    assert pmt.seeker_config_from_args({}).drop_path_rate == 0.1


# ---------------------------------------------------------------------------------------
# The whole step against tcow_tpu
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('remat', [False, True])
def test_loss_and_grads_match_jax(jax_params, remat):
    jcfg, pcfg = configs(seeker_kw=dict(remat=remat))
    b = batch()
    (jloss, jaux), jgrads = jax.value_and_grad(jstep._loss_and_aux, has_aux=True)(
        jax_params, jcfg, {k: jnp.asarray(v) for k, v in b.items()}, None,
        jnp.float32(PROGRESS), True)
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer(**OPT_KW),
                                   params=jax_params, device='cpu')
    ploss, paux = pstep.loss_and_aux(state.model, pcfg, b, state.generator, PROGRESS, True)
    ploss.backward()
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), rtol=LOSS_RTOL)
    for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker'):
        np.testing.assert_allclose(float(paux[k].detach()), float(jaux[k]), rtol=LOSS_RTOL,
                                   err_msg=k)
    for k, v in jaux['metric_sums'].items():
        np.testing.assert_allclose(float(paux['metric_sums'][k]), float(v), rtol=1e-6,
                                   err_msg=k)
    assert_tree_close(grads_to_jax(state.model), jgrads, GRAD_RTOL, GRAD_ATOL_REL)


def test_train_steps_match_jax(jax_params):
    '''Loss, aux and grad_norm of each of 3 AdamW steps (clipped at 0.3, the rate decayed
    after the second), and the parameters after steps 1 and 3.'''
    jcfg, pcfg = configs()
    tx = joptim.make_optimizer('adamw', **OPT_KW)
    jstate = jstep.init_train_state(jax.random.key(0), jcfg, tx, params=jax_params)
    jtrain = jax_train_step('adamw')
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer('adamw', **OPT_KW),
                                   params=jax_params, device='cpu')
    ptrain = pstep.make_train_step(pcfg)
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    for i in range(3):
        jstate, jaux = jtrain(jstate, jb, jnp.float32(PROGRESS))
        state, paux = ptrain(state, b, PROGRESS)
        for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker', 'grad_norm',
                  'skipped_nonfinite'):
            np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                       rtol=NORM_RTOL if k == 'grad_norm' else LOSS_RTOL,
                                       err_msg=f'step {i} {k}')
        if i in (0, 2):
            assert_tree_close(params_to_jax(state.model.state_dict()), jstate.params,
                              rtol=0.0, atol=PARAM_ATOL)
    assert state.step == int(jstate.step) == 3 and state.optimizer.count == 3


def test_eval_step_matches_jax(jax_params):
    jcfg, pcfg = configs()
    b = batch(seed=1)
    want = jstep.make_eval_step(jcfg, return_outputs=True)(
        jax_params, {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(0.5))
    model = pmt.MaskTracker(pcfg.seeker)
    model.load_state_dict(params_from_jax(jax_params))
    got = pstep.make_eval_step(pcfg, return_outputs=True)(model, b, 0.5)
    for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker'):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    for k in ('output_mask', 'output_flags', 'target_mask', 'seeker_query_mask',
              'snitch_weights'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2e-4,
                                   atol=2e-5, err_msg=k)


# ---------------------------------------------------------------------------------------
# The port's own guarantees
# ---------------------------------------------------------------------------------------

def test_nonfinite_loss_skips_the_update(jax_params):
    _, pcfg = configs()
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer(**OPT_KW),
                                   params=jax_params, device='cpu')
    ptrain = pstep.make_train_step(pcfg)
    state, _ = ptrain(state, batch(), PROGRESS)     # optimizer state exists from here
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    opt_state = {id(p): {k: (v.clone() if torch.is_tensor(v) else v) for k, v in s.items()}
                 for p, s in state.optimizer.torch_opt.state.items()}
    bad = batch()
    bad['rgb'][0, 0, 0, 0, 0] = np.nan
    state, aux = ptrain(state, bad, PROGRESS)
    assert float(aux['skipped_nonfinite']) == 1.0 and not np.isfinite(float(aux['total_seeker']))
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0)
    for p, s in state.optimizer.torch_opt.state.items():
        for k, v in s.items():
            torch.testing.assert_close(v, opt_state[id(p)][k], rtol=0, atol=0)
    assert state.step == 2 and state.optimizer.count == 1


def test_drop_path_grads_equal_under_remat(jax_params):
    '''Masks are drawn before the blocks, so a recomputed block sees the same masks: the
    gradients with remat equal those without it for the same generator seed.'''
    grads = []
    for remat in (False, True):
        _, pcfg = configs(seeker_kw=dict(drop_path_rate=0.5, remat=remat))
        model = pmt.MaskTracker(pcfg.seeker)
        model.load_state_dict(params_from_jax(jax_params))
        loss, _ = pstep.loss_and_aux(model, pcfg, batch(), torch.Generator().manual_seed(7),
                                      PROGRESS, True)
        loss.backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0].keys() == grads[1].keys()
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], rtol=1e-6, atol=1e-9)


def test_drop_path_masks_follow_the_rates(tiny_preset):
    '''Block 0 keeps every row (rate 0); masks have the folded-row shapes; the generator
    decides the draw.'''
    masks = ptsf.draw_drop_path_masks(torch.Generator().manual_seed(0), 0.5, 3, 6, 40, 5,
                                      'cpu')
    assert [m.temporal.shape for m in masks] == [(6, 40)] * 3
    assert masks[1].spatial.shape == (6, 5) and masks[2].mlp.shape == (6,)
    assert bool(masks[0].temporal.all() and masks[0].spatial.all() and masks[0].mlp.all())
    np.testing.assert_allclose([float(m.keep) for m in masks], [1.0, 0.75, 0.5])
    assert 0.35 < float(masks[2].temporal.float().mean()) < 0.65
    again = ptsf.draw_drop_path_masks(torch.Generator().manual_seed(0), 0.5, 3, 6, 40, 5, 'cpu')
    assert torch.equal(again[2].temporal, masks[2].temporal)


def test_training_forward_applies_drop_path(jax_params):
    '''train=True with a generator changes the output; without one, or with train=False,
    the forward is the inference forward.'''
    _, pcfg = configs(seeker_kw=dict(drop_path_rate=0.5))
    model = pmt.MaskTracker(pcfg.seeker)
    model.load_state_dict(params_from_jax(jax_params))
    rng = np.random.RandomState(0)
    rgb = torch.from_numpy(rng.rand(2, 3, 4, 32, 48).astype(np.float32))
    query = torch.from_numpy((rng.rand(2, 1, 4, 32, 48) > 0.5).astype(np.float32))
    with torch.no_grad():
        base = model(rgb, query)[0]
        torch.testing.assert_close(model(rgb, query, train=True)[0], base)
        dropped = model(rgb, query, train=True, generator=torch.Generator().manual_seed(1))[0]
    assert not torch.allclose(dropped, base)


def test_cpu_train_step_counts_no_launches(jax_params):
    _, pcfg = configs()
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer(**OPT_KW),
                                   params=jax_params, device='cpu')
    before = (fa.fused_attention.launches, fa.fused_attention_bwd.launches)
    pstep.make_train_step(pcfg)(state, batch(), PROGRESS)
    assert (fa.fused_attention.launches, fa.fused_attention_bwd.launches) == before
