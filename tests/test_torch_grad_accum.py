'''
Gradient accumulation in the port's train step (make_train_step(grad_accum=A)) against
tcow_tpu's (step.py:163-222) on the CPU in float32: A = 2 microbatches of the tiny
seeker's batch over 3 AdamW steps (averaged losses, summed metric sums, the gradient norm
of the averaged gradients, the parameters), a non-finite microbatch skipping the update,
and the microbatches themselves.
'''

import jax
import jax.numpy as jnp
import numpy as np
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


def test_accumulated_steps_match_jax(jax_params):
    '''3 steps of A = 2 (microbatches of one clip): each step's averaged losses and
    grad_norm, its metric sums summed over the microbatches, and the parameters after
    steps 1 and 3, within the tolerances of test_train_steps_match_jax.'''
    jcfg, pcfg = configs()
    tx = joptim.make_optimizer('adamw', **OPT_KW)
    jstate = jstep.init_train_state(jax.random.key(0), jcfg, tx, params=jax_params)
    jtrain = jax_train_step('adamw', grad_accum=2)
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer('adamw', **OPT_KW),
                                   params=jax_params, device='cpu')
    ptrain = pstep.make_train_step(pcfg, grad_accum=2)
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
        for k, v in jaux['metric_sums'].items():
            np.testing.assert_allclose(float(paux['metric_sums'][k]), float(v), rtol=1e-6,
                                       err_msg=f'step {i} {k}')
        if i in (0, 2):
            assert_tree_close(params_to_jax(state.model.state_dict()), jstate.params,
                              rtol=0.0, atol=PARAM_ATOL)
    assert state.step == int(jstate.step) == 3 and state.optimizer.count == 3


def test_accumulated_metric_sums_add_the_microbatches(jax_params):
    '''The metric sums of an A = 2 step are those of one step over the whole batch (they
    are counts); the losses are the mean of the two halves' own losses.'''
    _, pcfg = configs()
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer(**OPT_KW),
                                   params=jax_params, device='cpu')
    with torch.no_grad():
        halves = [pstep.loss_and_aux(state.model, pcfg, part, None, PROGRESS, True)[1]
                  for part in pstep.split_microbatches(batch(), 2)]
        whole = pstep.loss_and_aux(state.model, pcfg, batch(), None, PROGRESS, True)[1]
    _, aux = pstep.make_train_step(pcfg, grad_accum=2)(state, batch(), PROGRESS)
    for k, v in whole['metric_sums'].items():
        np.testing.assert_allclose(float(aux['metric_sums'][k]), float(v), rtol=1e-6,
                                   err_msg=k)
    mean = 0.5 * float(halves[0]['total_seeker'] + halves[1]['total_seeker'])
    np.testing.assert_allclose(float(aux['total_seeker']), mean, rtol=1e-6)


def test_nonfinite_microbatch_skips_the_update(jax_params):
    '''A NaN in the second microbatch makes the averaged loss non-finite: no parameter
    and no moment moves, the count of applied updates stays, the step advances (as JAX
    selects the old state when the averaged loss is not finite, step.py:210-216).'''
    _, pcfg = configs()
    state = pstep.init_train_state(0, pcfg, poptim.make_optimizer(**OPT_KW),
                                   params=jax_params, device='cpu')
    ptrain = pstep.make_train_step(pcfg, grad_accum=2)
    state, _ = ptrain(state, batch(), PROGRESS)
    params = {k: v.clone() for k, v in state.model.state_dict().items()}
    moments = [s['exp_avg'].clone() for s in state.optimizer.torch_opt.state.values()]
    bad = batch()
    bad['rgb'][1, 0, 0, 0, 0] = np.nan
    state, aux = ptrain(state, bad, PROGRESS)
    assert float(aux['skipped_nonfinite']) == 1.0
    for k, v in state.model.state_dict().items():
        torch.testing.assert_close(v, params[k], rtol=0, atol=0)
    for s, m in zip(state.optimizer.torch_opt.state.values(), moments):
        torch.testing.assert_close(s['exp_avg'], m, rtol=0, atol=0)
    assert state.step == 2 and state.optimizer.count == 1


@pytest.mark.parametrize('A', [2, 4])
def test_microbatches_split_batch_leaves_and_share_scalars(A):
    b = {'rgb': np.arange(8 * 3).reshape(8, 3),
         'frame_times': np.arange(8 * 2).reshape(8, 2), 'query_time': np.int32(1)}
    parts = pstep.split_microbatches(b, A)
    assert len(parts) == A
    for i, part in enumerate(parts):
        n = 8 // A
        np.testing.assert_array_equal(part['rgb'], b['rgb'][i * n:(i + 1) * n])
        np.testing.assert_array_equal(part['frame_times'],
                                      b['frame_times'][i * n:(i + 1) * n])
        assert part['query_time'] == 1
    with pytest.raises(ValueError, match='does not divide'):
        pstep.split_microbatches(b, 3)
