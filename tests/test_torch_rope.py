'''
Time-calibrated temporal rope in the port against tcow_tpu on the CPU in float32: the
port's ops/rope.py against tcow_tpu/ops/rope.py; the plain K1r, K2r and K3r forwards
against the Pallas forward with rope=True (interpret mode); the gradients of
fused_attention with rope and per-row positions in each backward mode against JAX's custom
VJP; the tiny seeker with temporal_rope and frame_times; three AdamW steps of the rope
step; run_plugin reading frame_times only under rope_time_coords; the attention forwards
each remat policy runs; the configs' rope keys and a rope checkpoint's time_embed.
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.data import synthetic as jsyn
from tcow_tpu.evaluation import inference as jinf
from tcow_tpu.models import mask_tracker as jmt
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu.objectives import losses as jlosses
from tcow_tpu.ops import pallas_attention as pa
from tcow_tpu.ops import rope as jrope
from tcow_tpu.train import checkpoint as jckpt
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.data.synthetic import synthetic_frame_times
from tcow_tpu_torch.evaluation import inference as pinf
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.ops import rope as prope
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

# fp32 tolerance of tests/test_pallas_attention.py:31.
RTOL, ATOL = 2e-4, 2e-5
HEADS = 4
GRAD_NAMES = ('dx', 'dqkv_w', 'dqkv_b', 'dproj_w', 'dproj_b')
# The tiny rope seeker: depth 2 at width 64 with 4 heads, T=6 at 32x48, causal 1.
DEPTH = 2
SEEKER_KW = dict(num_total_frames=6, frame_height=32, frame_width=48, causal_attention=1,
                 drop_path_rate=0.0, network_depth=DEPTH, temporal_rope=True,
                 rope_time_coords=True)
BATCH_KW = dict(B=2, Q=2, T=6, H=32, W=48, M=8, K=4)
# Three AdamW steps, milestones at updates 2, 3 and 4 (as tests/test_torch_train_step.py),
# and its tolerances: losses 1e-5 relative, grad norm 5e-5, parameters 5e-6 absolute.
OPT_KW = dict(learn_rate=1e-3, lr_decay=0.3, num_epochs=5, steps_per_epoch=1,
              gradient_clip=0.3)
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-5, 5e-5, 5e-6
PROGRESS = 0.05

t = torch.from_numpy


def assert_close(got, want, name=''):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=ATOL,
                               err_msg=name)


def make_inputs(B=3, S=7, D=32, seed=0):
    '''x, qkv_w, qkv_b, proj_w, proj_b and an incoming gradient g, float32 numpy; q and k
    large enough that the logits are O(1) and the rotation shows.'''
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, D).astype(np.float32) * 0.5,
            (rng.randn(D, 3 * D) * 0.8).astype(np.float32),
            (rng.randn(3 * D) * 0.01).astype(np.float32),
            (rng.randn(D, D) * 0.1).astype(np.float32),
            (rng.randn(D) * 0.01).astype(np.float32),
            rng.randn(B, S, D).astype(np.float32))


POSITIONS = {'rows': lambda B, S: np.tile(np.arange(S, dtype=np.float32), (B, 1)),
             'times': lambda B, S: synthetic_frame_times(B + S, B, S, frame_stride=2)}


# ---------------------------------------------------------------------------------------
# ops/rope.py
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('positions', list(POSITIONS))
@pytest.mark.parametrize('which', ['forward', 'inverse', 'round_trip'])
def test_rope_module_matches_jax(which, positions):
    pos = POSITIONS[positions](3, 9)
    x = np.random.RandomState(1).randn(3, 9, 16).astype(np.float32)
    jc, js = jrope.rope_tables(jnp.asarray(pos), 16)
    pc, ps = prope.rope_tables(t(pos), 16)
    assert pc.dtype == ps.dtype == torch.float32 and pc.shape == (3, 9, 8)
    assert_close(pc, jc, 'cos')
    assert_close(ps, js, 'sin')
    if which == 'round_trip':
        back = prope.apply_rope(prope.apply_rope(t(x), pc, ps), pc, ps, inverse=True)
        np.testing.assert_allclose(back.numpy(), x, rtol=1e-5, atol=1e-5)
        return
    inverse = which == 'inverse'
    want = jrope.apply_rope(jnp.asarray(x), jc, js, inverse=inverse)
    assert_close(prope.apply_rope(t(x), pc, ps, inverse=inverse), want)
    # The math in f32, the result rounded to x's dtype, as JAX rounds it.
    xb = t(x).to(torch.bfloat16)
    got = prope.apply_rope(xb, pc, ps, inverse=inverse)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got, prope.apply_rope(xb.float(), pc, ps, inverse).to(
        torch.bfloat16), rtol=0, atol=0)


# ---------------------------------------------------------------------------------------
# K1r, K2r, K3r and the gradients of every mode
# ---------------------------------------------------------------------------------------

FORWARDS = {'K1r': (fa.fused_attention_fwd, False), 'K2r': (fa.fused_attention_fwd_qkv, 'qkv'),
            'K3r': (fa.fused_attention_fwd_res, True)}


@pytest.mark.parametrize('positions', [None, 'times'])
@pytest.mark.parametrize('ca', [0, 1, 3])
@pytest.mark.parametrize('kernel', list(FORWARDS))
def test_rope_forward_matches_pallas(kernel, ca, positions):
    '''The plain K1r (out), K2r (out, un-rotated qkv) and K3r (out, qkv, probabilities,
    attn) against _fused_attention_fwd_impl(rope=True, pos=...) in interpret mode; K3r's
    probabilities against the diagonal blocks of the Pallas kernel's packed layout.'''
    B, S = 3, 7
    *args, _ = make_inputs(B=B, S=S, seed=ca)
    pos = None if positions is None else POSITIONS[positions](B, S)
    fn, residuals = FORWARDS[kernel]
    want = pa._fused_attention_fwd_impl(*args, HEADS, ca, interpret=True,
                                        want_residuals=residuals, rope=True,
                                        pos=None if pos is None else jnp.asarray(pos))
    got = fn(*map(t, args), HEADS, ca, True, None if pos is None else t(pos))
    got = (got,) if kernel == 'K1r' else got
    assert_close(got[0], want[0], 'out')
    if kernel != 'K1r':
        assert_close(got[1], np.asarray(want[1])[:B, :S], 'qkv')
        unrotated = fa.attention_qkv_ref(*map(t, args), HEADS, ca)[1]
        torch.testing.assert_close(got[1], unrotated, rtol=0, atol=0)
    if kernel == 'K3r':
        _, _, _, S_pad, pack, _, _ = pa._geometry(jnp.asarray(args[0]), HEADS)
        probs = np.asarray(want[2])
        diag = np.stack([probs[b // pack, :, (b % pack) * S_pad:(b % pack) * S_pad + S,
                               (b % pack) * S_pad:(b % pack) * S_pad + S] for b in range(B)])
        assert_close(got[2], diag, 'probs')
        assert_close(got[3], np.asarray(want[3])[:B, :S], 'attn')
    # The rotation shows in the output.
    plain = fa.fused_attention_fwd(*map(t, args), HEADS, ca)
    assert (got[0] - plain).abs().max() > 1e-3


@pytest.mark.parametrize('ca', [1, 3])
@pytest.mark.parametrize('mode', fa.BWD_MODES)
def test_rope_gradients_match_pallas_vjp(mode, ca):
    '''The output and all five gradients of one differentiable call with rope and per-row
    positions, against pallas_attention.fused_attention's custom VJP with the same mode
    (interpret mode); the positions get no gradient.'''
    *args, g = make_inputs(S=13, seed=10 + ca)
    pos = POSITIONS['times'](3, 13)
    old = pa.INTERPRET
    pa.INTERPRET = True
    try:
        out, vjp = jax.vjp(lambda *a: pa.fused_attention(*a[:5], a[5], HEADS, ca, mode, True),
                           *args, jnp.asarray(pos))
        want = vjp(jnp.asarray(g))
    finally:
        pa.INTERPRET = old
    leaves = [t(a).requires_grad_() for a in args]
    p = t(pos).requires_grad_()
    got = fa.fused_attention(*leaves, HEADS, ca, mode, True, p)
    got.backward(t(g))
    assert_close(got.detach(), out, 'out')
    for name, leaf, w in zip(GRAD_NAMES, leaves, want):
        assert_close(leaf.grad, w, name)
    assert p.grad is None and not np.asarray(want[5]).any()


# ---------------------------------------------------------------------------------------
# The seeker, the train step and the inference engine
# ---------------------------------------------------------------------------------------

@pytest.fixture
def tiny_preset(monkeypatch):
    monkeypatch.setitem(jtsf.DEPTH_PRESETS, DEPTH, (64, 4))
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, DEPTH, (64, 4))


@pytest.fixture
def base_params(tiny_preset):
    '''JAX-layout weights of the tiny rope seeker, as tests/test_torch_train_step.py
    makes them.'''
    rng = np.random.RandomState(0)
    return jax.tree.map(
        lambda a: np.asarray(a, np.float32) + 0.02 * rng.randn(*a.shape).astype(np.float32),
        jmt.init_params(jax.random.key(0), jmt.SeekerConfig(**SEEKER_KW)))


@pytest.fixture
def rope_params(base_params):
    '''base_params with O(1) logits in the temporal attention, so that positions visibly
    change the output (as tests/test_rope.py's rope_setup boosts them).'''
    params = jax.tree.map(np.copy, base_params)
    blocks = params['backbone']['blocks']
    blocks['temporal_attn']['qkv']['w'] *= 20.0
    blocks['temporal_attn']['proj']['w'] *= 4.0
    return params


def clip_inputs(B=2, T=6, seed=3):
    rng = np.random.RandomState(seed)
    rgb = rng.rand(B, 3, T, 32, 48).astype(np.float32)
    query = np.zeros((B, 1, T, 32, 48), np.float32)
    query[:, :, 1, 8:16, 8:24] = 1.0
    return rgb, query


def port_model(params, **kw):
    model = pmt.MaskTracker(pmt.SeekerConfig(**{**SEEKER_KW, **kw}))
    model.load_state_dict(params_from_jax(params))
    return model


@pytest.mark.parametrize('times', ['none', 'rows', 'times'])
def test_rope_seeker_matches_jax(rope_params, times):
    '''Masks and flags of the tiny rope seeker without frame times, with row times
    0..T-1 (equal to none) and with augmented times, against tcow_tpu's forward.'''
    rgb, query = clip_inputs()
    ft = None if times == 'none' else POSITIONS[times](2, 6)
    jcfg = jmt.SeekerConfig(**SEEKER_KW)
    want = jmt.forward(rope_params, jcfg, rgb, query,
                       frame_times=None if ft is None else jnp.asarray(ft))
    with torch.no_grad():
        got = port_model(rope_params)(t(rgb), t(query),
                                      frame_times=None if ft is None else t(ft))
    for a, b in zip(got, want):
        assert_close(a, b)
    if times == 'times':
        with torch.no_grad():
            rows = port_model(rope_params)(t(rgb), t(query))[0]
        assert (got[0] - rows).abs().max() > 1e-4


def test_rope_seeker_ignores_time_embed(rope_params):
    '''Under temporal_rope the absolute time embedding is skipped: a different time_embed
    gives the same outputs bit for bit, in the port as in JAX.'''
    rgb, query = clip_inputs(seed=4)
    ft = t(POSITIONS['times'](2, 6))
    other = jax.tree.map(np.copy, rope_params)
    other['backbone']['time_embed'] = np.random.RandomState(9).randn(
        *other['backbone']['time_embed'].shape).astype(np.float32)
    with torch.no_grad():
        a = port_model(rope_params)(t(rgb), t(query), frame_times=ft)
        b = port_model(other)(t(rgb), t(query), frame_times=ft)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    jcfg = jmt.SeekerConfig(**SEEKER_KW)
    np.testing.assert_array_equal(
        np.asarray(jmt.forward(rope_params, jcfg, rgb, query, frame_times=jnp.asarray(ft))[0]),
        np.asarray(jmt.forward(other, jcfg, rgb, query, frame_times=jnp.asarray(ft))[0]))


def rope_batch(seed=0):
    b = jsyn.synthetic_device_batch(seed, **BATCH_KW)
    b['frame_times'] = synthetic_frame_times(seed, BATCH_KW['B'], BATCH_KW['T'], frame_stride=2)
    return b


def test_rope_train_steps_match_jax(base_params):
    '''Three AdamW steps of the rope step with frame times in the batch, the port in the
    step of record's pairing (kernel_x / dots_nb_out under remat), against tcow_tpu.train
    .step: losses, grad norm, and every parameter after steps 1 and 3, time_embed (zero
    gradient, decayed by AdamW) included. The weights are not boosted: Adam's first
    update, g / (|g| + eps), turns the f32 noise of gradients near eps into parameter
    differences above PARAM_ATOL.'''
    rope_params = base_params
    jcfg = jstep.StepConfig(seeker=jmt.SeekerConfig(**SEEKER_KW), loss=jlosses.LossConfig(),
                            num_queries=2)
    pcfg = pstep.StepConfig(
        seeker=pmt.SeekerConfig(**SEEKER_KW, remat=True, attention_bwd='kernel_x',
                                remat_policy='dots_nb_out'),
        loss=plosses.LossConfig(), num_queries=2)
    tx = joptim.make_optimizer('adamw', **OPT_KW)
    jstate = jstep.init_train_state(jax.random.key(0), jcfg, tx, params=rope_params)
    jtrain = jax.jit(jstep.make_train_step(jcfg, tx))
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer('adamw', **OPT_KW),
                                   params=rope_params, device='cpu')
    ptrain = pstep.make_train_step(pcfg)
    b = rope_batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    time_embed = rope_params['backbone']['time_embed']
    for i in range(3):
        jstate, jaux = jtrain(jstate, jb, jnp.float32(PROGRESS))
        state, paux = ptrain(state, b, PROGRESS)
        for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker', 'grad_norm'):
            np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                       rtol=NORM_RTOL if k == 'grad_norm' else LOSS_RTOL,
                                       err_msg=f'step {i} {k}')
        if i in (0, 2):
            got = params_to_jax(state.model.state_dict())
            for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jstate.params),
                                    jax.tree.leaves(got)):
                np.testing.assert_allclose(g, np.asarray(w), rtol=0.0, atol=PARAM_ATOL,
                                           err_msg=f'step {i} {jax.tree_util.keystr(path)}')
    decayed = params_to_jax(state.model.state_dict())['backbone']['time_embed']
    assert not np.array_equal(decayed, time_embed)
    assert np.all(np.abs(decayed) <= np.abs(time_embed))


@pytest.mark.parametrize('rope_time_coords', [False, True])
def test_rope_step_reads_frame_times_only_under_rope_time_coords(rope_params, monkeypatch,
                                                                 rope_time_coords):
    '''The step broadcasts the batch's (B, T) frame times to every query of an example and
    hands them to the model only when the config sets rope_time_coords (step.py:73-77).'''
    seen = []
    forward = pmt.MaskTracker.forward
    monkeypatch.setattr(pmt.MaskTracker, 'forward', lambda self, *a, **kw: (
        seen.append(kw.get('frame_times')), forward(self, *a, **kw))[1])
    cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**{**SEEKER_KW,
                                                      'rope_time_coords': rope_time_coords}),
                           loss=plosses.LossConfig(), num_queries=2)
    model = port_model(rope_params, rope_time_coords=rope_time_coords)
    b = rope_batch(seed=1)
    pstep.make_eval_step(cfg)(model, b, 0.5)
    if not rope_time_coords:
        assert seen == [None]
        return
    assert seen[0].shape == (4, 6) and seen[0].dtype == torch.float32
    np.testing.assert_array_equal(seen[0].numpy(), np.repeat(b['frame_times'], 2, axis=0))


@pytest.mark.parametrize('rope_time_coords', [False, True])
def test_rope_run_plugin_matches_jax(tmp_path, rope_params, rope_time_coords):
    '''load_networks -> run_plugin with frame times of a rope checkpoint against tcow_tpu's
    engine: the times are read only under rope_time_coords, and then change the output.'''
    args = dict(SEEKER_KW, temporal_rope=1, rope_time_coords=int(rope_time_coords),
                tracker_pretrained='0')
    path = pckpt.save_checkpoint(str(tmp_path), 0, 'r', rope_params, seeker_args=args)
    params, cfg, *_ = pinf.load_networks(str(tmp_path), device='cpu')
    assert (cfg.temporal_rope, cfg.rope_time_coords) == (True, rope_time_coords)
    rgb, query = clip_inputs(seed=5)
    target = (np.random.RandomState(5).rand(2, 3, 6, 32, 48) > 0.7).astype(np.float32)
    times = (np.arange(6, dtype=np.float32) * 3.0)[None].repeat(2, 0)
    engine = pinf.InferenceEngine(params, cfg, device='cpu')
    got = engine.run_plugin(rgb, query, target, frame_times=times)
    jparams, jcfg, *_ = jinf.load_networks(path, None)
    want = jinf.InferenceEngine(jparams, jcfg, jlosses.LossConfig(), num_queries=1).run_plugin(
        rgb, query, target, frame_times=times)
    for (gm, gl), (wm, wl) in zip(got, want):
        assert_close(gm['output_mask'], wm['output_mask'], 'mask')
        assert_close(gm['output_flags'], wm['output_flags'], 'flags')
        for k in wl['metrics']:
            np.testing.assert_allclose(gl['metrics'][k], wl['metrics'][k], rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    none = engine.run_plugin(rgb, query, target)
    changed = np.abs(got[0][0]['output_mask'] - none[0][0]['output_mask']).max()
    assert (changed > 1e-4) if rope_time_coords else (changed == 0)


@pytest.mark.parametrize('mode,policy,per_block', [
    ('kernel_x', 'dots_nb_out', 2), ('kernel_x', 'full', 4), ('kernel_qkv', 'dots_nb_out_qkv', 2),
    ('res', 'dots_nb', 4), ('res', 'attn_res', 2), ('kernel_x_wg', 'dots_nb_out', 2)])
def test_rope_keeps_the_forwards_each_policy_runs(rope_params, mode, policy, per_block):
    '''With temporal rope and frame times, each remat policy runs the attention forward as
    often as without rope (tests/test_torch_remat_policy.py), and its gradients equal
    those under 'full' bit for bit.'''
    def grads(pol):
        cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**SEEKER_KW, remat=True,
                                                       attention_bwd=mode, remat_policy=pol),
                               loss=plosses.LossConfig(), num_queries=2)
        model = pmt.MaskTracker(cfg.seeker)
        model.load_state_dict(params_from_jax(rope_params))
        loss, _ = pstep.loss_and_aux(model, cfg, rope_batch(seed=2), None, PROGRESS, True)
        loss.backward()
        return {k: p.grad for k, p in model.named_parameters()}

    before = dict(fa.fused_attention.calls)
    got = grads(policy)
    after = dict(fa.fused_attention.calls)
    assert after[mode] - before[mode] == per_block * DEPTH
    assert all(after[m] == before[m] for m in fa.BWD_MODES if m != mode)
    assert got['backbone.time_embed'] is None
    want = grads('full')
    for k, g in want.items():
        assert (g is None and got[k] is None) or torch.equal(got[k], g), k


# ---------------------------------------------------------------------------------------
# Configs and checkpoints
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('args', [{}, dict(temporal_rope=1),
                                  dict(temporal_rope=1, rope_time_coords=1)])
def test_rope_keys_map_as_in_jax(args):
    j = jmt.seeker_config_from_args(args)
    p = pmt.seeker_config_from_args(args)
    assert (p.temporal_rope, p.rope_time_coords) == (j.temporal_rope, j.rope_time_coords)
    assert p.backbone_config().temporal_rope == j.backbone_config().temporal_rope


def test_rope_checkpoint_keeps_time_embed(tmp_path, rope_params):
    '''A rope seeker still carries time_embed (unused, kept for checkpoint shape): it
    round-trips through the port's checkpoint and weights bridge, and JAX loads it.'''
    args = dict(SEEKER_KW, temporal_rope=1, rope_time_coords=1)
    path = pckpt.save_checkpoint(str(tmp_path), 1, 'k', rope_params, seeker_args=args)
    params, cfg, *_ = pinf.load_networks(path, device='cpu')
    want = rope_params['backbone']['time_embed']
    np.testing.assert_array_equal(params['backbone']['time_embed'], want)
    state = pmt.MaskTracker(cfg).state_dict()
    state.update(params_from_jax(params))
    np.testing.assert_array_equal(params_to_jax(state)['backbone']['time_embed'], want)
    np.testing.assert_array_equal(jckpt.load_checkpoint(path)['params']['backbone']['time_embed'],
                                  want)
    assert cfg.temporal_rope and cfg.rope_time_coords
