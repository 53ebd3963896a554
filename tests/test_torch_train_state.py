'''
Full training state in the port's checkpoints (tcow_tpu_torch/train/checkpoint.py)
against tcow_tpu/train/checkpoint.py on the CPU: a port save restores into a JAX
TrainState and a JAX save into the port's, AdamW and LAMB moments and counts included,
under optax's own key paths; a port round trip continues bit for bit (parameters,
moments and the drop-path generator); and the directory layout of both packages:
model_{epoch} snapshots, partial (preemption) saves, debug thinning, light saves and
find_full_snapshot.
'''

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.train import checkpoint as jckpt
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_to_jax
from test_torch_train_step import (  # noqa: F401 (fixtures)
    OPT_KW, PARAM_ATOL, PROGRESS, batch, configs, jax_params, jax_train_step, tiny_preset)

OPTIMIZERS = ['adamw', 'lamb']


def port_state(jax_params, name, steps, seeker_kw=None):
    _, pcfg = configs(seeker_kw=seeker_kw)
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer(name, **OPT_KW),
                                   params=jax_params, device='cpu')
    train = pstep.make_train_step(pcfg)
    for _ in range(steps):
        state, _ = train(state, batch(), PROGRESS)
    return state, train


def jax_state(jax_params, name):
    jcfg, _ = configs()
    tx = joptim.make_optimizer(name, **OPT_KW)
    return jstep.init_train_state(jax.random.key(0), jcfg, tx, params=jax_params)


def moments(state):
    '''{'mu' / 'nu': JAX-layout tree} of a port state's optimizer.'''
    named = list(state.model.named_parameters())
    return {w: params_to_jax({n: state.optimizer.torch_opt.state[p][k] for n, p in named})
            for w, k in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq'))}


def assert_trees_equal(got, want):
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                      err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('name', OPTIMIZERS)
def test_port_train_state_restores_in_jax(tmp_path, jax_params, name):
    '''The port writes every leaf of the JAX TrainState's opt_state under its own path;
    JAX restores the parameters, the moments, both counts and the step exactly.'''
    state, _ = port_state(jax_params, name, 2)
    path = pckpt.save_train_state(str(tmp_path), 1, 'p', state)
    template = jax_state(jax_params, name)
    want_keys = set(jckpt._flatten_with_paths(template.opt_state))
    assert set(pckpt.opt_state_to_jax(state.optimizer)) == want_keys
    got = jckpt.load_checkpoint(path, template)['state']
    assert_trees_equal(got.params, params_to_jax(state.model.state_dict()))
    adam = got.opt_state[1][0]
    assert int(adam.count) == 2 and int(got.opt_state[1][-1].count) == 2
    m = moments(state)
    assert_trees_equal(adam.mu, m['mu'])
    assert_trees_equal(adam.nu, m['nu'])
    assert int(got.step) == 2
    np.testing.assert_array_equal(jax.random.key_data(got.rng),
                                  jax.random.key_data(template.rng))


@pytest.mark.parametrize('name', OPTIMIZERS)
def test_jax_train_state_restores_in_port_and_resumes(tmp_path, jax_params, name):
    '''A JAX save after 2 steps restores into a fresh port state (moments, counts, step);
    one more step from it matches JAX's third step within test_train_steps_match_jax's
    tolerance.'''
    jstate = jax_state(jax_params, name)
    jtrain = jax_train_step(name)
    jb = {k: jnp.asarray(v) for k, v in batch().items()}
    for _ in range(2):
        jstate, _ = jtrain(jstate, jb, jnp.float32(PROGRESS))
    path = jckpt.save_checkpoint(str(tmp_path), 1, 'j', jstate.params, jstate.opt_state,
                                 jstate.rng, jstate.step)
    state, train = port_state(jax_params, name, 0)
    loaded = pckpt.load_checkpoint(path, state)
    assert loaded['opt_restored'] and loaded['state'] is state
    assert state.step == 2 and state.optimizer.count == 2
    assert_trees_equal(params_to_jax(state.model.state_dict()), jstate.params)
    m = moments(state)
    assert_trees_equal(m['mu'], jstate.opt_state[1][0].mu)
    assert_trees_equal(m['nu'], jstate.opt_state[1][0].nu)
    assert all(float(s['step']) == 2 for s in state.optimizer.torch_opt.state.values())
    jstate, _ = jtrain(jstate, jb, jnp.float32(PROGRESS))
    state, _ = train(state, batch(), PROGRESS)
    for (p, w), g in zip(jax.tree_util.tree_leaves_with_path(jstate.params),
                         jax.tree.leaves(params_to_jax(state.model.state_dict()))):
        np.testing.assert_allclose(g, np.asarray(w), rtol=0, atol=PARAM_ATOL,
                                   err_msg=jax.tree_util.keystr(p))


@pytest.mark.parametrize('name', OPTIMIZERS)
def test_port_round_trip_continues_bit_for_bit(tmp_path, jax_params, name):
    '''Save after one step (drop-path 0.5, so the generator matters), load into a fresh
    state built from other weights, take one more step in both: the same bits.'''
    kw = dict(drop_path_rate=0.5)
    state, train = port_state(jax_params, name, 1, kw)
    path = pckpt.save_train_state(str(tmp_path), 0, 'r', state)
    fresh, _ = port_state(jax.tree.map(lambda a: a * 0.5, jax_params), name, 0, kw)
    pckpt.load_checkpoint(path, fresh)
    assert fresh.step == 1 and fresh.optimizer.count == 1
    state, _ = train(state, batch(), PROGRESS)
    fresh, _ = train(fresh, batch(), PROGRESS)
    for (k, a), b in zip(state.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    for which in ('mu', 'nu'):
        assert_trees_equal(moments(fresh)[which], moments(state)[which])


def test_directory_layout_matches_jax(tmp_path, jax_params):
    '''Snapshots every checkpoint_every epochs, partial saves without a snapshot, debug
    thinning, light saves; peek_meta, get_checkpoint_epoch and find_full_snapshot read
    the port's directory as the JAX package reads it.'''
    state, _ = port_state(jax_params, 'adamw', 1)
    d = str(tmp_path / 'exp')
    for epoch in range(4):
        pckpt.save_train_state(d, epoch, 'x', state, checkpoint_every=2)
    assert sorted(f for f in os.listdir(d) if f.startswith('model_')) == ['model_0.npz',
                                                                          'model_2.npz']
    main = os.path.join(d, 'checkpoint.npz')
    assert pckpt.get_checkpoint_epoch(main) == jckpt.get_checkpoint_epoch(main) == 3
    pckpt.save_train_state(d, 4, 'x', state, steps_done=5)
    meta = pckpt.peek_meta(main)
    assert meta == jckpt.peek_meta(main)
    assert meta['partial'] and meta['steps_done_in_epoch'] == 5 and meta['opt_restored']
    assert not os.path.exists(os.path.join(d, 'model_4.npz'))
    pckpt.save_train_state(d, 5, 'x', state, is_debug=True)        # thinned: not written
    assert pckpt.get_checkpoint_epoch(main) == 4
    pckpt.save_checkpoint(d, 6, 'x', params_to_jax(state.model.state_dict()))   # light
    assert pckpt.peek_meta(os.path.join(d, 'model_6.npz'))['light']
    full = os.path.join(d, 'model_2.npz')
    assert pckpt.find_full_snapshot(main) == jckpt.find_full_snapshot(main) == full
    assert not pckpt.load_checkpoint(main)['opt_restored']
    assert pckpt.load_checkpoint(full)['opt_restored']
