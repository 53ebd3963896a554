'''
The port's per-example evaluation step and train-time visualisation step
(make_eval_step(per_example=True), make_vis_step) against tcow_tpu's (step.py:225-322) on
the CPU in float32, with on-device colour augmentation in the batch: every per-example
loss and metric sum (leading B axis), the outputs, and the vis payload's example-0
scalars and float16 slices; and the per-example numbers equal to B = 1 evaluations.
'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.data import synthetic as psyn
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax
from test_torch_train_step import (  # noqa: F401 (fixtures)
    LOSS_RTOL, batch, configs, jax_params, tiny_preset)

# The outputs of the two forwards (tests/test_pallas_attention.py:31); float16 slices are
# compared after the rounding, so within one float16 ulp of values up to ~20 as well.
OUT_RTOL, OUT_ATOL = 2e-4, 2e-5
F16_RTOL, F16_ATOL = 1e-3, 2e-5


def augmented_batch():
    b = batch(seed=1)
    b.update(psyn.synthetic_color_augs(3, 2, jitter=[1, 1], blur=[1, 0], gray=[0, 1]))
    return b


def both(jax_params, make_j, make_p):
    '''The port's step and, unless make_j is None, the JAX package's (jitted) on the
    augmented batch.'''
    jcfg, pcfg = configs()
    b = augmented_batch()
    want = None if make_j is None else jax.jit(make_j(jcfg))(
        jax_params, {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(0.5))
    model = pmt.MaskTracker(pcfg.seeker)
    model.load_state_dict(params_from_jax(jax_params))
    return make_p(pcfg)(model, b, 0.5), want, (model, pcfg, b)


def test_per_example_eval_matches_jax(jax_params):
    got, want, _ = both(jax_params, lambda c: jstep.make_eval_step(c, per_example=True),
                        lambda c: pstep.make_eval_step(c, per_example=True))
    for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker'):
        assert got[k].shape == want[k].shape == (2,), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=LOSS_RTOL,
                                   atol=1e-7, err_msg=k)
    for k, v in want['metric_sums'].items():
        assert got['metric_sums'][k].shape == v.shape == (2,), k
        np.testing.assert_allclose(got['metric_sums'][k].numpy(), np.asarray(v), rtol=1e-6,
                                   err_msg=k)
    for k in ('output_mask', 'output_flags', 'target_mask', 'seeker_query_mask',
              'snitch_weights'):
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=OUT_RTOL,
                                   atol=OUT_ATOL, err_msg=k)


def test_per_example_eval_equals_single_clip_evaluations(jax_params):
    '''Example b's numbers are those of evaluating clip b alone (the forced batch-1
    protocol), from one batched forward.'''
    got, _, (model, pcfg, b) = both(jax_params, None,
                                    lambda c: pstep.make_eval_step(c, per_example=True))
    single = pstep.make_eval_step(pcfg)
    for i in range(2):
        one = single(model, {k: (v[i:i + 1] if np.ndim(v) else v) for k, v in b.items()}, 0.5)
        for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker'):
            np.testing.assert_allclose(float(got[k][i]), float(one[k]), rtol=LOSS_RTOL,
                                       atol=1e-7, err_msg=f'{i} {k}')
        for k, v in one['metric_sums'].items():
            np.testing.assert_allclose(float(got['metric_sums'][k][i]), float(v), rtol=1e-6,
                                       err_msg=f'{i} {k}')


@pytest.mark.parametrize('max_queries', [1, 2])
def test_vis_step_matches_jax(jax_params, max_queries):
    got, want, _ = both(jax_params, lambda c: jstep.make_vis_step(c, max_queries),
                        lambda c: pstep.make_vis_step(c, max_queries))
    assert set(got) == set(want)
    for k in ('track', 'occl_mask', 'cont_mask', 'total_seeker'):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=LOSS_RTOL, err_msg=k)
    for k, v in want['metric_sums'].items():
        np.testing.assert_allclose(float(got['metric_sums'][k]), float(v), rtol=1e-6,
                                   err_msg=k)
    for k in ('seeker_rgb', 'output_mask', 'target_mask', 'seeker_query_mask',
              'snitch_weights'):
        w = np.asarray(want[k])
        assert got[k].dtype == torch.float16 and got[k].shape == w.shape, k
        np.testing.assert_allclose(got[k].float().numpy(), w.astype(np.float32),
                                   rtol=F16_RTOL, atol=F16_ATOL, err_msg=k)
    assert got['output_mask'].shape[:2] == (1, max_queries)
