'''
The port's remat policies and attention-backward modes in the training step, on the CPU
in float32: the tiny seeker's loss and gradients under each pairing of a mode with its
remat policy against tcow_tpu with the Pallas attention (interpret mode) and the same
mode and policy; the number of attention forwards each policy runs per step; gradients
under every policy equal to those under 'full' bit for bit; the configs' validation.
'''

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
from tcow_tpu.ops import pallas_attention as pa
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

# Tiny preset as tests/test_torch_train_step.py: depth 2 at width 64 with 4 heads, T=4 at
# 32x48, B=2 clips, Q=2, M=8, K=4.
DEPTH = 2
SEEKER_KW = dict(num_total_frames=4, frame_height=32, frame_width=48, causal_attention=1,
                 drop_path_rate=0.0, network_depth=DEPTH, remat=True)
BATCH_KW = dict(B=2, Q=2, T=4, H=32, W=48, M=8, K=4)
PROGRESS = 0.05
# The pairings of a backward mode with the policy that keeps what it needs (BASELINE.md
# of the JAX package; bench.py's step of record is the first).
PAIRINGS = [('kernel_x', 'dots_nb_out'), ('kernel_qkv', 'dots_nb_out_qkv'),
            ('res', 'dots_nb'), ('kernel_x_wg', 'dots_nb_out')]
# Tolerances of tests/test_torch_train_step.py: losses 1e-5 relative; gradient leaves
# rtol 1e-4 with elements near zero against 1e-5 of the leaf's largest magnitude.
LOSS_RTOL, GRAD_RTOL, GRAD_ATOL_REL = 1e-5, 1e-4, 1e-5


@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(jtsf.DEPTH_PRESETS, DEPTH, (64, 4))
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, DEPTH, (64, 4))


@pytest.fixture
def jax_params(tiny_preset):
    cfg = jmt.SeekerConfig(**SEEKER_KW)
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.randn(*a.shape).astype(np.float32),
        jmt.init_params(jax.random.key(0), cfg))


def port_config(mode, policy, **kw):
    seeker = pmt.SeekerConfig(**{**SEEKER_KW, **kw}, attention_bwd=mode, remat_policy=policy)
    return pstep.StepConfig(seeker=seeker, loss=plosses.LossConfig(), num_queries=2)


def port_grads(params, mode, policy, generator=None, **kw):
    '''(loss, {name: gradient}) of one loss-and-backward of the tiny seeker; zeros for a
    parameter the loss does not reach, as JAX gives.'''
    cfg = port_config(mode, policy, **kw)
    model = pmt.MaskTracker(cfg.seeker)
    model.load_state_dict(params_from_jax(params))
    loss, _ = pstep.loss_and_aux(model, cfg, jsyn.synthetic_device_batch(0, **BATCH_KW),
                                 generator, PROGRESS, True)
    loss.backward()
    return loss.detach(), {k: torch.zeros_like(p) if p.grad is None else p.grad
                           for k, p in model.named_parameters()}


@pytest.mark.parametrize('mode,policy', PAIRINGS)
def test_pairing_matches_jax_pallas_interpret(jax_params, mode, policy):
    jcfg = jstep.StepConfig(
        seeker=jmt.SeekerConfig(**SEEKER_KW, use_pallas_attention=True, attention_bwd=mode,
                                remat_policy=policy),
        loss=jlosses.LossConfig(), num_queries=2)
    b = jsyn.synthetic_device_batch(0, **BATCH_KW)
    old = pa.INTERPRET
    pa.INTERPRET = True
    try:
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p, jb: jstep._loss_and_aux(p, jcfg, jb, None, jnp.float32(PROGRESS), True),
            has_aux=True))(jax_params, {k: jnp.asarray(v) for k, v in b.items()})
    finally:
        pa.INTERPRET = old
    loss, grads = port_grads(jax_params, mode, policy)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = params_to_jax(grads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jgrads), jax.tree.leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('mode,policy,per_block', [
    ('kernel_x', 'dots_nb_out', 2), ('kernel_x', 'dots_nb_out_qkv', 2), ('kernel_x', 'full', 4),
    ('kernel_x_wg', 'dots_nb_out', 2), ('kernel_x_wg', 'dots', 4),
    ('kernel_qkv', 'dots_nb_out_qkv', 2), ('kernel_qkv', 'dots_nb_out', 4),
    ('kernel_qkv', 'full', 4), ('res', 'dots_nb', 4), ('res', 'dots_nb_attn', 2),
    ('res', 'attn_res', 2), ('res', 'full', 4)])
def test_policy_sets_how_often_the_attention_forward_runs(jax_params, mode, policy,
                                                          per_block):
    '''Two attention calls per block; a policy that keeps the forward's outputs runs each
    once per step (2 x depth), one that does not runs it again in the backward
    (4 x depth). Counted on the CPU by fused_attention.calls.'''
    before = dict(fa.fused_attention.calls)
    port_grads(jax_params, mode, policy)
    after = fa.fused_attention.calls
    assert after[mode] - before[mode] == per_block * DEPTH
    assert all(after[m] == before[m] for m in fa.BWD_MODES if m != mode)


@pytest.fixture(scope='module')
def full_remat_grads():
    '''Gradients under 'full', per mode, with drop-path 0.5 from one generator seed.'''
    return {}


@pytest.mark.parametrize('mode', fa.BWD_MODES)
@pytest.mark.parametrize('policy', [p for p in ptsf.REMAT_POLICIES if p != 'full'])
def test_policy_gradients_equal_full_remat_bit_for_bit(jax_params, full_remat_grads, mode,
                                                       policy):
    def grads(pol):
        return port_grads(jax_params, mode, pol, torch.Generator().manual_seed(3),
                          drop_path_rate=0.5)
    if mode not in full_remat_grads:
        full_remat_grads[mode] = grads('full')
    loss, want = full_remat_grads[mode]
    got_loss, got = grads(policy)
    assert torch.equal(got_loss, loss)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_no_remat_gradients_equal_full_remat(jax_params):
    a = port_grads(jax_params, 'kernel_x', 'dots_nb_out', remat=False)[1]
    b = port_grads(jax_params, 'kernel_x', 'full')[1]
    for k in b:
        assert torch.equal(a[k], b[k]), k


def test_configs_take_jax_names_and_defaults():
    cfg = pmt.SeekerConfig()
    assert (cfg.remat_policy, cfg.attention_bwd) == ('full', 'res')
    assert (jmt.SeekerConfig().remat_policy, jmt.SeekerConfig().attention_bwd) == ('full', 'res')
    cfg = pmt.seeker_config_from_args({}, remat=True, remat_policy='dots_nb_out_qkv',
                                      attention_bwd='kernel_qkv')
    bb = cfg.backbone_config()
    assert (bb.remat, bb.remat_policy, bb.attention_bwd) == (True, 'dots_nb_out_qkv',
                                                             'kernel_qkv')
    assert set(ptsf.REMAT_POLICIES) == {'full', 'dots', 'dots_nb', 'dots_nb_attn', 'attn_res',
                                        'dots_nb_out', 'dots_nb_out_qkv'}
    with pytest.raises(ValueError, match='remat_policy'):
        pmt.SeekerConfig(remat_policy='dots_out')
    with pytest.raises(ValueError, match='attention_bwd'):
        pmt.SeekerConfig(attention_bwd='kernel')
    with pytest.raises(ValueError, match='remat_policy'):
        ptsf.TimeSformerConfig(remat_policy='everything')


def test_model_attention_carries_the_mode(tiny_preset):
    model = pmt.MaskTracker(port_config('kernel_x_wg', 'dots_nb_out').seeker)
    modes = {m.bwd_mode for m in model.modules() if isinstance(m, ptsf.Attention)}
    assert modes == {'kernel_x_wg'}
