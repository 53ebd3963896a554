'''
remat_group in the port (G consecutive blocks per checkpoint region,
tcow_tpu_torch/models/timesformer.py) on the CPU in float32: the tiny seeker's loss and
gradients with G = 2 and 4 equal to G = 1 bit for bit (drop-path on: the masks are drawn
before the blocks), G = 2 against tcow_tpu with remat_group=2, the attention forwards per
step unchanged, and a G that does not divide the depth refused.
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
from tcow_tpu.train import step as jstep
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.ops import fused_attention as fa
from tcow_tpu_torch.weights import params_to_jax
from test_torch_remat_policy import (  # noqa: F401 (fixtures)
    BATCH_KW, GRAD_ATOL_REL, GRAD_RTOL, LOSS_RTOL, PROGRESS, SEEKER_KW, jax_params,
    port_grads, tiny_preset)


@pytest.fixture
def depth4(monkeypatch):
    '''A depth-4 preset at the tiny width, so that G = 2 and G = 4 both divide it.'''
    monkeypatch.setitem(ptsf.DEPTH_PRESETS, 4, (64, 4))
    cfg = pmt.SeekerConfig(**{**SEEKER_KW, 'network_depth': 4})
    model = pmt.MaskTracker(cfg)
    model.init_params_(torch.Generator().manual_seed(0))
    return params_to_jax(model.state_dict())


@pytest.mark.parametrize('mode,policy', [('kernel_x', 'dots_nb_out'), ('res', 'full')])
@pytest.mark.parametrize('G', [2, 4])
def test_grouped_regions_give_the_same_gradients_bit_for_bit(depth4, G, mode, policy):
    def grads(group):
        return port_grads(depth4, mode, policy, torch.Generator().manual_seed(5),
                          network_depth=4, drop_path_rate=0.5, remat_group=group)
    loss, want = grads(1)
    got_loss, got = grads(G)
    assert torch.equal(got_loss, loss)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_remat_group_matches_jax(jax_params):
    '''G = 2 at depth 2 (one region) against tcow_tpu's remat_group=2 under full remat,
    within the tolerances of test_torch_train_step.py.'''
    jcfg = jstep.StepConfig(seeker=jmt.SeekerConfig(**SEEKER_KW, remat_group=2),
                            loss=jlosses.LossConfig(), num_queries=2)
    b = jsyn.synthetic_device_batch(0, **BATCH_KW)
    (jloss, _), jgrads = jax.jit(lambda p, jb, progress: jax.value_and_grad(
        jstep._loss_and_aux, has_aux=True)(p, jcfg, jb, None, progress, True))(
        jax_params, {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(PROGRESS))
    loss, grads = port_grads(jax_params, 'res', 'full', remat_group=2)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=LOSS_RTOL)
    got = params_to_jax(grads)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jgrads), jax.tree.leaves(got)):
        w = np.asarray(w)
        np.testing.assert_allclose(g, w, rtol=GRAD_RTOL, atol=GRAD_ATOL_REL * np.abs(w).max(),
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize('mode,policy,per_block', [('kernel_x', 'dots_nb_out', 2),
                                                   ('kernel_x', 'full', 4)])
def test_remat_group_keeps_the_attention_forwards_per_step(depth4, mode, policy, per_block):
    '''Grouping blocks changes what a region holds, not how often a forward runs: 2 per
    block when the policy keeps the attention output, 4 when the backward re-runs it.'''
    for G in (1, 2, 4):
        before = dict(fa.fused_attention.calls)
        port_grads(depth4, mode, policy, network_depth=4, remat_group=G)
        assert fa.fused_attention.calls[mode] - before[mode] == per_block * 4, G


def test_remat_group_must_divide_the_depth():
    with pytest.raises(ValueError, match='remat_group'):
        pmt.SeekerConfig(network_depth=12, remat_group=5)
    with pytest.raises(ValueError, match='remat_group'):
        ptsf.TimeSformerConfig(depth=12, remat_group=0)
    cfg = pmt.seeker_config_from_args({}, remat=True, remat_group=4)
    assert cfg.remat_group == cfg.backbone_config().remat_group == 4
    assert jtsf.TimeSformerConfig().remat_group == ptsf.TimeSformerConfig().remat_group == 1
