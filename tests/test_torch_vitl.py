'''
The stretch configuration's width on the CPU in float32: a ViT-L-width seeker (D = 1024,
16 heads of 64, BASELINE.json config 5) cut to depth 2 at T = 4 and 32x64, against
tcow_tpu from the same weights: the forward, then one AdamW step's loss, gradients and
parameters. The depth-2 preset is registered in both packages for the module and restored
after it, as tests/test_stretch_config.py does. Then tools/torch_vitl_probe.py: its ladder
and --geoms parsing against tools/vitl_probe.py's, and one rung run on the CPU.
'''

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.data import synthetic as jsyn
from tcow_tpu.models import mask_tracker as jmt
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu.objectives import losses as jlosses
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

sys.path.insert(0, os.path.join(conftest.REPO_ROOT, 'tools'))
import torch_vitl_probe  # noqa: E402
import vitl_probe  # noqa: E402

# tests/test_pallas_attention.py:31 (fp32).
RTOL, ATOL = 2e-4, 2e-5
VITL = (1024, 16)
SEEKER_KW = dict(num_total_frames=4, frame_height=32, frame_width=64, causal_attention=1,
                 drop_path_rate=0.0, network_depth=2)
BATCH_KW = dict(B=1, Q=2, T=4, H=32, W=64, M=6, K=3)
OPT_KW = dict(learn_rate=1e-4, num_epochs=70, steps_per_epoch=1000, gradient_clip=0.3)
PROGRESS = 0.1
# Gradient leaves: elements near zero compare against the leaf's scale, as
# tests/test_torch_train_step.py compares them; parameters after one AdamW update of ~lr.
GRAD_ATOL_REL = 1e-5
PARAM_ATOL = 5e-6


@pytest.fixture(scope='module')
def vitl_preset():
    old = dict(jtsf.DEPTH_PRESETS), dict(ptsf.DEPTH_PRESETS)
    jtsf.DEPTH_PRESETS[2] = ptsf.DEPTH_PRESETS[2] = VITL
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    for presets, saved in zip((jtsf.DEPTH_PRESETS, ptsf.DEPTH_PRESETS), old):
        presets.clear()
        presets.update(saved)


@pytest.fixture(scope='module')
def params(vitl_preset):
    '''The port's seeded init at ViT-L width plus seeded noise (temporal_fc and the
    biases non-zero), as a JAX-layout tree.'''
    model = pmt.MaskTracker(pmt.SeekerConfig(**SEEKER_KW))
    model.init_params_(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    return jax.tree.map(lambda a: a + 0.02 * rng.randn(*a.shape).astype(np.float32),
                        params_to_jax(model.state_dict()))


def test_vitl_width_forward_matches_jax(params):
    cfg = pmt.SeekerConfig(**SEEKER_KW)
    bb = cfg.backbone_config()
    assert (bb.embed_dim, bb.num_heads, bb.embed_dim // bb.num_heads) == (1024, 16, 64)
    assert params['backbone']['blocks']['attn']['qkv']['w'].shape == (2, 1024, 3072)
    rng = np.random.RandomState(1)
    rgb = rng.rand(1, 3, 4, 32, 64).astype(np.float32)
    query = (rng.rand(1, 1, 4, 32, 64) > 0.7).astype(np.float32)
    want = jmt.forward(params, jmt.SeekerConfig(**SEEKER_KW), rgb, query)
    model = pmt.MaskTracker(cfg)
    model.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = model(torch.from_numpy(rgb), torch.from_numpy(query))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_vitl_width_adamw_step_matches_jax(params):
    '''Loss and every gradient leaf of the first step, then the parameters after one
    AdamW update of those gradients (clipped at 0.3), as make_train_step applies it.'''
    jcfg = jstep.StepConfig(seeker=jmt.SeekerConfig(**SEEKER_KW), loss=jlosses.LossConfig(),
                            num_queries=2)
    pcfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**SEEKER_KW), loss=plosses.LossConfig(),
                            num_queries=2)
    b = jsyn.synthetic_device_batch(0, **BATCH_KW)
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(
        lambda p, batch: jstep._loss_and_aux(p, jcfg, batch, None, jnp.float32(PROGRESS),
                                             True), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in b.items()})
    tx = joptim.make_optimizer('adamw', **OPT_KW)
    jparams = jax.jit(lambda g, p: optax.apply_updates(p, tx.update(g, tx.init(p), p)[0]))(
        jgrads, params)

    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer('adamw', **OPT_KW),
                                   params=params, device='cpu')
    loss, _ = pstep.loss_and_aux(state.model, pcfg, b, None, PROGRESS, True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    grads = [p.grad for p in state.model.parameters() if p.grad is not None]
    np.testing.assert_allclose(float(poptim.global_norm(grads)),
                               float(optax.global_norm(jgrads)), rtol=RTOL)
    got = params_to_jax({k: (p.grad if p.grad is not None else torch.zeros_like(p))
                         for k, p in state.model.named_parameters()})
    leaves = jax.tree_util.tree_leaves_with_path(jgrads)
    assert len(leaves) == len(jax.tree.leaves(got))
    for (path, w), g in zip(leaves, jax.tree.leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=RTOL, atol=GRAD_ATOL_REL * float(np.abs(w).max()),
                                   err_msg=jax.tree_util.keystr(path))

    state.optimizer.step(poptim.global_norm(grads))
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jparams),
                            jax.tree.leaves(params_to_jax(state.model.state_dict()))):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0.0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('spec', ['24,1,1,30,240,320,1',
                                  '24,1,3,30,240,320,1,dots_nb_out;24,1,1,60,480,640,1,full',
                                  '24,2,1,30,240,320,2;;2,1,1,4,32,64,1,res'])
def test_ladder_parsing_matches_jax(monkeypatch, capsys, spec):
    '''The port's ladder equals the JAX tool's, and --geoms parses to the tuples the JAX
    tool hands its try_geom (read by replacing that function).'''
    assert torch_vitl_probe.DEFAULT_LADDER == vitl_probe.DEFAULT_LADDER
    seen = []
    monkeypatch.setattr(vitl_probe, 'try_geom', lambda *g, steps, policy: (
        seen.append(g + ((policy,) if policy else ())) or 100.0))
    monkeypatch.setattr(sys, 'argv', ['vitl_probe.py', '--geoms', spec])
    vitl_probe.main()
    capsys.readouterr()
    assert torch_vitl_probe.parse_ladder(spec) == seen


def test_probe_rung_runs_on_cpu(vitl_preset, capsys):
    '''One rung at ViT-L width (depth 2, T = 4 at 32x64) through the port's probe on the
    CPU: a JSON record with a finite loss and every step's launches (none on the CPU), and
    the markdown table.'''
    torch_vitl_probe.main(['--geoms', '2,1,1,4,32,64,1', '--device', 'cpu', '--steps', '1'])
    out = capsys.readouterr().out.splitlines()
    rec = json.loads(next(ln for ln in out if ln.startswith('{')))
    assert rec['fits'] and np.isfinite(rec['loss']) and rec['ms'] > 0
    assert rec['policy'] == 'dots_nb' and rec['tokens'] == 32 and rec['device'] == 'cpu'
    assert rec['launches'] == [{}, {}, {}]
    assert out[-3:-1] == ['| geometry | tokens/clip | result | detail |', '|---|---|---|---|']
    assert out[-1].startswith('| d2 B1 Q1 T4 32x64 accum1 | 32 | ')
