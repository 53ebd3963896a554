'''
LAMB in the port (tcow_tpu_torch/train/optim.py:Lamb) against optax.lamb as the JAX
package builds it (tcow_tpu/train/optim.py:38-39, chained after clip_by_global_norm), in
float32 on the CPU: the update alone on tensors whose parameter or update norm is zero
(where the trust ratio is 1), with and without clipping, and 3 steps of the whole train
step of the tiny seeker.
'''

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_to_jax
from test_torch_train_step import (  # noqa: F401 (fixtures)
    LOSS_RTOL, NORM_RTOL, OPT_KW, PARAM_ATOL, PROGRESS, assert_tree_close, batch, configs,
    jax_params, jax_train_step, tiny_preset)

# The update alone: the same f32 operations in another order of the norms' sums; the
# parameters move by ~lr * ||p|| / ||u|| per element (measured <= 6e-8).
UPDATE_ATOL = 1e-6


def leaves(seed):
    '''Parameters and three gradients each: a matrix, a bias at zero whose gradients are
    zero (both norms 0 at first), a bias at zero with gradients (parameter norm 0 at
    first), and a vector with gradients of mixed scale.'''
    rng = np.random.RandomState(seed)
    params = {'w': rng.randn(6, 5).astype(np.float32) * 0.1,
              'b_still': np.zeros(5, np.float32), 'b_moving': np.zeros(7, np.float32),
              'v': rng.randn(9).astype(np.float32)}
    grads = [{'w': rng.randn(6, 5).astype(np.float32),
              'b_still': np.zeros(5, np.float32),
              'b_moving': rng.randn(7).astype(np.float32) * 0.01,
              'v': rng.randn(9).astype(np.float32) * np.float32(10.0 ** (i - 1))}
             for i in range(3)]
    return params, grads


@pytest.mark.parametrize('gradient_clip', [0.3, 0.0])
def test_lamb_update_matches_optax(gradient_clip):
    params, grads = leaves(0)
    kw = dict(learn_rate=1e-2, lr_decay=0.3, num_epochs=5, steps_per_epoch=1,
              gradient_clip=gradient_clip)
    tx = joptim.make_optimizer('lamb', **kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = poptim.make_optimizer('lamb', **kw).init(tp.items())
    update = jax.jit(tx.update)
    for g in grads:
        updates, opt_state = update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0,
                                       atol=UPDATE_ATOL, err_msg=k)
    np.testing.assert_array_equal(tp['b_still'].detach().numpy(), 0.0)
    assert np.abs(tp['b_moving'].detach().numpy()).max() > 1e-3   # ratio 1, not 0
    assert opt.count == 3


def test_lamb_train_steps_match_jax(jax_params):
    '''Loss, grad_norm and parameters over 3 LAMB steps of the tiny seeker (clipped at
    0.3, the rate decayed after the second), biases at zero included.'''
    jcfg, pcfg = configs()
    tx = joptim.make_optimizer('lamb', **OPT_KW)
    jstate = jstep.init_train_state(jax.random.key(0), jcfg, tx, params=jax_params)
    jtrain = jax_train_step('lamb')
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer('lamb', **OPT_KW),
                                   params=jax_params, device='cpu')
    ptrain = pstep.make_train_step(pcfg)
    b = batch()
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    for i in range(3):
        jstate, jaux = jtrain(jstate, jb, jnp.float32(PROGRESS))
        state, paux = ptrain(state, b, PROGRESS)
        for k in ('total_seeker', 'grad_norm'):
            np.testing.assert_allclose(float(paux[k]), float(jaux[k]),
                                       rtol=NORM_RTOL if k == 'grad_norm' else LOSS_RTOL,
                                       err_msg=f'step {i} {k}')
        assert_tree_close(params_to_jax(state.model.state_dict()), jstate.params, rtol=0.0,
                          atol=PARAM_ATOL)
    assert state.optimizer.count == 3
