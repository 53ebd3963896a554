'''
The port's data parallelism (tcow_tpu_torch/parallel/mesh.py, the global-batch losses, the
data-parallel train step) on CPU gloo process groups, against the JAX package's data mesh
on the CPU's virtual devices: each rank's rows and loader batches, the global-batch losses
and their gradients, 3 AdamW steps at 2 and 4 ranks and under grad_accum = 2, drop-path
masks drawn for the global batch, and the parallel flags that still raise.

The ranks are processes running tests/test_torch_dp_ranks.py (which imports no JAX), forked
from a forkserver, one intra-op thread each, meeting at a free port; each launch has its
own timeout. Tiny geometry: depth 2 at width 64, T = 4 at
32 x 48 (tests/test_multiprocess.py:40-46), f32.
'''

import multiprocessing
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import conftest  # noqa: F401
from tcow_tpu import config as jconfig
from tcow_tpu.data import factory as jfactory
from tcow_tpu.data import synthetic as jsyn
from tcow_tpu.objectives import losses as jlosses
from tcow_tpu.parallel import mesh as jmesh
from tcow_tpu.train import checkpoint as jckpt
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch.data import factory as pfactory
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_to_jax
import test_torch_dp_ranks as dp_ranks
from test_torch_train_step import (GRAD_ATOL_REL, GRAD_RTOL, LOSS_RTOL, NORM_RTOL, OPT_KW,
                                   PARAM_ATOL, PROGRESS, SEEKER_KW, assert_tree_close,
                                   configs, jax_params, jax_train_step,  # noqa: F401
                                   tiny_preset)

# Seconds one launch of ranks may take (their imports, the rendezvous, the steps).
RANKS_TIMEOUT_S = 120
BATCH_KW = dict(Q=2, T=4, H=32, W=48, M=8, K=4)
LOSS_KEYS = ('track', 'occl_mask', 'cont_mask', 'total_seeker')


# ---------------------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------------------

def start_ranks(tmp_path, kind, world, payload):
    '''Starts test_torch_dp_ranks.rank_main(kind) in `world` processes on `payload`;
    finish_ranks waits for them, so the caller can compute its oracle meanwhile. The
    processes fork from a forkserver that has imported torch and the port once.'''
    inp = tmp_path / f'{kind}_in.pkl'
    inp.write_bytes(pickle.dumps(payload))
    port = pmesh.free_port()
    ctx = multiprocessing.get_context('forkserver')
    ctx.set_forkserver_preload(['test_torch_dp_ranks'])
    outs = [tmp_path / f'{kind}_out{r}.pkl' for r in range(world)]
    procs = [ctx.Process(target=dp_ranks.rank_main,
                         args=(kind, r, world, port, str(inp), str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    return procs, outs, time.monotonic() + RANKS_TIMEOUT_S


def finish_ranks(handle):
    '''Each rank's result, in rank order. Fails when a rank raised (its traceback), exited
    non-zero, or had not ended RANKS_TIMEOUT_S after the start.'''
    procs, outs, deadline = handle
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    res = [pickle.loads(out.read_bytes()) if out.exists() else None for out in outs]
    for r, (p, got) in enumerate(zip(procs, res)):
        assert got is not None and 'error' not in got and p.exitcode == 0, (
            f'rank {r} exited {p.exitcode}: {got and got.get("error")}')
    return res


def run_ranks(tmp_path, kind, world, payload):
    return finish_ranks(start_ranks(tmp_path, kind, world, payload))


def train_payload(jax_params, b, grad_accum=1, steps=3, **seeker_kw):
    return dict(params=jax_params, batch=b, grad_accum=grad_accum, steps=steps,
                seeker_kw={**SEEKER_KW, **seeker_kw}, opt_kw=OPT_KW, progress=PROGRESS)


# ---------------------------------------------------------------------------------------
# Rows and loader batches
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('world,grad_accum', [(2, 1), (2, 2), (4, 1)])
def test_shard_batch_rows_match_jax(world, grad_accum):
    '''Each rank's rows are JAX's data-axis shard of the batch, or under grad_accum of each
    of the step's microbatches (the global batch reshaped to (A, B/A) as
    tcow_tpu/train/step.py:174-182 splits it, sharded on the data axis).'''
    b = jsyn.synthetic_device_batch(0, B=8, **BATCH_KW)
    mesh = jmesh.make_mesh(num_devices=world)
    if grad_accum == 1:
        want = {k: jmesh.shard_batch(b, mesh)[k] for k in b}
    else:
        spec = lambda v: NamedSharding(mesh, P() if v.ndim == 0 else P(None, jmesh.DATA_AXIS))
        split = lambda v: v if v.ndim == 0 else v.reshape((grad_accum, -1) + v.shape[1:])
        want = {k: jax.device_put(split(v), spec(split(v))) for k, v in b.items()}
    for rank in range(world):
        fake = pmesh.DataMesh(world, rank, rank, torch.device('cpu'), 'gloo', '')
        got = pmesh.shard_batch(b, fake, grad_accum)
        tensors = pmesh.shard_batch({k: torch.as_tensor(v) for k, v in b.items()}, fake,
                                    grad_accum)
        for k, v in want.items():
            if v.ndim == 0:
                assert got[k] == b[k]
                continue
            shard = np.asarray(v.addressable_shards[rank].data)
            if grad_accum > 1:
                shard = shard.reshape((-1,) + shard.shape[2:])
            np.testing.assert_array_equal(got[k], shard, err_msg=f'{k} rank {rank}')
            np.testing.assert_array_equal(tensors[k].numpy(), shard, err_msg=k)
    with pytest.raises(ValueError, match='must divide'):
        pmesh.shard_rows(6, 0, 4)
    with pytest.raises(ValueError, match='must divide'):
        pmesh.shard_rows(4, 0, 4, grad_accum=2)


@pytest.fixture(scope='module')
def loader_root(tmp_path_factory):
    root = tmp_path_factory.mktemp('kub_dp')
    jsyn.write_synthetic_kubric_dataset(str(root), num_scenes=8, seed=4, T=8, H=48, W=64,
                                        K=4, rich_events=True)
    return str(root)


def loader_argv(root, batch_size, grad_accum=1):
    return ['--data_path', root, '--num_frames', '6', '--kubric_max_delay', '2',
            '--frame_height', '32', '--frame_width', '48', '--batch_size', str(batch_size),
            '--num_queries', '2', '--max_objects', '8', '--num_workers', '1',
            '--do_val_aug', '0', '--device_augs', '1', '--seed', '5',
            '--grad_accum', str(grad_accum)]


def assert_batches_equal(got, want, where):
    assert set(got) == set(want), where
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]),
                                      err_msg=f'{where} {k}')


@pytest.mark.parametrize('grad_accum', [1, 2])
def test_loader_shards_match_jax(loader_root, grad_accum):
    '''Rank r of 2: the port's train loader batches equal the JAX loader's with
    shard=(r, 2), bit for bit, over an epoch. Under grad_accum = 2 a port batch holds the
    rank's rows of both microbatches: JAX's loader at batch_size / 2 gives them as two
    consecutive batches, collated in the same order on the same stream.'''
    B, W = 4, 2
    for rank in range(W):
        pargs = pconfig.train_args(loader_argv(loader_root, B, grad_accum))
        jargs = jconfig.train_args(loader_argv(loader_root, B // grad_accum))
        ptrain = pfactory.create_train_val_data_loaders(pargs, None, shard=(rank, W))[0]
        jtrain = jfactory.create_train_val_data_loaders(jargs, None, shard=(rank, W))[0]
        ptrain.set_epoch(1)
        jtrain.set_epoch(1)
        got, want = list(ptrain), list(jtrain)
        assert len(got) * grad_accum == len(want) == 8 // B * grad_accum
        for i, g in enumerate(got):
            parts = [w['device'] for w in want[i * grad_accum:(i + 1) * grad_accum]]
            merged = {k: (parts[0][k] if np.ndim(parts[0][k]) == 0
                          else np.concatenate([p[k] for p in parts])) for k in parts[0]}
            assert_batches_equal(g['device'], merged, f'rank {rank} batch {i}')
            np.testing.assert_array_equal(
                g['meta']['dset_idx'],
                np.concatenate([w['meta']['dset_idx']
                                for w in want[i * grad_accum:(i + 1) * grad_accum]]))


# ---------------------------------------------------------------------------------------
# Global-batch losses
# ---------------------------------------------------------------------------------------

def skewed_loss_inputs(seed=0, B=4, Q=2, T=4, H=16, W=24):
    '''Logits and targets whose positives sit on rank 0's rows (a positive fraction >= 0.3)
    and barely on rank 1's (<= 0.01): the class balance, the selected counts and the
    top-k threshold of the global batch differ from either rank's alone.'''
    rng = np.random.RandomState(seed)
    target = np.zeros((B, Q, 3, T, H, W), np.float32)
    target[:B // 2, :, 0] = rng.rand(B // 2, Q, T, H, W) < 0.4
    target[B // 2:, :, 0, 0, :1, :2] = 1.0
    target[:, :, 1:] = rng.rand(B, Q, 2, T, H, W) < 0.1
    target[B // 2:, :, 1:, 1:] = 0.0
    pos = target[:, :, 0].reshape(B, -1).mean(1)
    assert pos[:B // 2].min() >= 0.3 and pos[B // 2:].max() <= 0.01, pos
    occl = rng.rand(B, Q, T, 3).astype(np.float32)
    return dict(logits=rng.randn(B, Q, 3, T, H, W).astype(np.float32), target=target,
                sel_occl_fracs=occl,
                snitch=(rng.rand(B, Q, 1, T, H, W) < 0.05).astype(np.int32) * 3,
                query_time=1, progress=0.05)


# The extremes of test_group_extremes_share_ties_like_jax: the maximum tied within and
# across ranks, the minimum once on each.
TIES = np.array([[1.0, 5.0, 5.0, -2.0, 0.0], [5.0, 0.5, 3.0, 2.0, -2.0]], np.float32)


@pytest.fixture(scope='module')
def loss_ranks(tmp_path_factory):
    '''One launch of 2 ranks for the loss tests: the skewed batch's losses and the
    extremes of TIES.'''
    p = skewed_loss_inputs()
    return p, run_ranks(tmp_path_factory.mktemp('dp_losses'), 'losses', 2, {**p, 'x': TIES})


def test_global_batch_losses_match_jax(loss_ranks):
    '''compute_losses over a 2-rank group equals JAX's compute_losses on the global batch,
    value and gradient with respect to each rank's logits; the per-rank losses averaged
    without the group miss JAX by more than 10x the limit (the test has teeth). At
    progress 0.05 the top-k keeps 57.5 % of the selected pixels.'''
    p, res = loss_ranks
    cfg = jlosses.LossConfig()

    def total(logits):
        out = jlosses.compute_losses(cfg, logits, jnp.asarray(p['target']),
                                     jnp.asarray(p['sel_occl_fracs']),
                                     jnp.asarray(p['snitch']), p['query_time'],
                                     jnp.float32(p['progress']))
        return out['total_seeker'], out

    (_, want), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(
        jnp.asarray(p['logits']))
    for r in res:
        for k in LOSS_KEYS:
            np.testing.assert_allclose(r['grouped'][k], float(want[k]), rtol=LOSS_RTOL,
                                       err_msg=k)
    got_grad = np.concatenate([r['grad'] for r in res])
    g = np.asarray(grad)
    np.testing.assert_allclose(got_grad, g, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * float(np.abs(g).max()))
    averaged = np.mean([r['alone']['total_seeker'] for r in res])
    miss = abs(averaged - float(want['total_seeker'])) / abs(float(want['total_seeker']))
    assert miss > 10 * LOSS_RTOL, miss


def test_group_extremes_share_ties_like_jax(loss_ranks):
    '''all_max / all_min over 2 ranks (TIES): the global extremum, its gradient shared
    among its ties on every rank as jnp.max's is.'''
    _, res = loss_ranks
    for name, f in (('max', jnp.max), ('min', jnp.min)):
        grad = np.asarray(jax.grad(lambda v: 3.0 * f(v))(jnp.asarray(TIES)))
        for r, got in enumerate(res):
            assert got['extremes'][name][0] == float(f(TIES)), name
            np.testing.assert_array_equal(got['extremes'][name][1], grad[r], err_msg=name)


# ---------------------------------------------------------------------------------------
# The data-parallel train step
# ---------------------------------------------------------------------------------------

def port_steps(jax_params, b, steps, grad_accum=1, seeker_kw=None):
    '''The one-process port step: (losses, parameters) after each step.'''
    _, cfg = configs(seeker_kw=seeker_kw)
    state = pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **OPT_KW),
                                   params=jax_params, device='cpu')
    train_step = pstep.make_train_step(cfg, grad_accum=grad_accum)
    out = []
    for _ in range(steps):
        state, aux = train_step(state, b, PROGRESS)
        out.append((float(aux['total_seeker']),
                    pmesh.fetch_global(params_to_jax(state.model.state_dict()))))
    return out


# AdamW's update of an element is m / (sqrt(v) + eps), eps = 1e-8 (m, v bias-corrected):
# where sqrt(v) is below eps the update is set by eps, not by the gradient, and the f32
# rounding of gradients that small moves it by up to its own size, so a parameter
# comparison there tests the rounding.
ADAMW_EPS, ADAMW_B2 = 1e-8, 0.999
# Elements of the tiny model (258,435) that rule leaves out at the grad_accum = 2 batch,
# after step 1 and after step 3.
ILL_CONDITIONED_AT_ACCUM2 = {0: 21965, 2: 21608}


def adam_state(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def assert_params_close_where_conditioned(got, want, opt_state, atol):
    '''Parameters within atol wherever JAX's bias-corrected sqrt(v) after the step is at
    least AdamW's eps; returns how many elements the rule left out.'''
    adam = adam_state(opt_state)
    correction = 1.0 - ADAMW_B2 ** int(adam.count)
    excluded = 0
    wl = jax.tree_util.tree_leaves_with_path(want)
    for (path, w), g, nu in zip(wl, jax.tree.leaves(got), jax.tree.leaves(adam.nu),
                                strict=True):
        keep = np.sqrt(np.asarray(nu) / correction) >= ADAMW_EPS
        excluded += int(keep.size - keep.sum())
        np.testing.assert_allclose(np.asarray(g)[keep], np.asarray(w)[keep], rtol=0.0,
                                   atol=atol, err_msg=jax.tree_util.keystr(path))
    return excluded


@pytest.mark.parametrize('world,B,grad_accum', [(2, 4, 1), (2, 4, 2), (4, 4, 1)])
def test_dp_train_steps_match_jax_mesh(jax_params, tmp_path, world, B, grad_accum):
    '''3 AdamW steps of the `world`-rank step (B = 4 clips, Q = 2) against JAX's jitted
    step on a `world`-device data mesh: losses and grad_norm each step, parameters after
    steps 1 and 3 on every rank; every rank's state has the same digest. Under grad_accum
    = 2 the first step's gradients are held against JAX's too, and the parameters after
    step 3 come from one step of the ranks from JAX's state after step 2: along the
    trajectory, the f32 rounding where an update is ill-conditioned (sqrt(v) below AdamW's
    eps) moves the next steps' gradients, and the step-3 parameters drift up to 1.4e-4
    from JAX's, the one-process port step's as much (its gradients at JAX's own
    parameters of steps 2 and 3 are within 1 % of GRAD_RTOL's limit). Both comparisons leave out the ill-conditioned
    elements (assert_params_close_where_conditioned), ILL_CONDITIONED_AT_ACCUM2 of them.'''
    b = jsyn.synthetic_device_batch(0, B=B, **BATCH_KW)
    payload = train_payload(jax_params, b, grad_accum)
    if grad_accum == 1:
        ranks = start_ranks(tmp_path, 'train', world, payload)
    mesh = jmesh.make_mesh(num_devices=world)
    tx = joptim.make_optimizer('adamw', **OPT_KW)
    jcfg, _ = configs()
    jstate = jmesh.replicate_tree(jstep.init_train_state(jax.random.key(0), jcfg, tx,
                                                         params=jax_params), mesh)
    jtrain = jax_train_step('adamw', grad_accum)
    jb = jmesh.shard_batch(b, mesh)
    jsteps, jstates = [], []
    for i in range(3):
        jstate, jaux = jtrain(jstate, jb, jnp.float32(PROGRESS))
        jsteps.append({k: float(v) for k, v in jaux.items() if k != 'metric_sums'})
        jstates.append(jax.device_get(jstate))
    if grad_accum > 1:
        restart = dict(params=jstates[1].params, opt_state={
            k: np.asarray(v) for k, v in jckpt._flatten_with_paths(jstates[1].opt_state).items()})
        ranks = start_ranks(tmp_path, 'train', world, {**payload, 'restart': restart})
        parts = [{k: (v if np.ndim(v) == 0 else v[i * 2:(i + 1) * 2]) for k, v in b.items()}
                 for i in range(grad_accum)]
        grad_fn = jax.jit(jax.grad(lambda prm, part: jstep._loss_and_aux(
            prm, jcfg, part, None, jnp.float32(PROGRESS), True)[0]))
        jgrads = jax.tree.map(lambda *g: sum(g) / grad_accum,
                              *[grad_fn(jax_params, part) for part in parts])
    res = finish_ranks(ranks)
    assert len({r['digest'] for r in res}) == 1
    for r in res:
        assert r['rows'] == B // world
        for i, (got, want) in enumerate(zip(r['steps'], jsteps)):
            for k, v in got.items():
                np.testing.assert_allclose(v, want[k], err_msg=f'step {i} {k}',
                                           rtol=NORM_RTOL if k == 'grad_norm' else LOSS_RTOL)
        if grad_accum > 1:
            assert_tree_close(r['grads'], jgrads, GRAD_RTOL, GRAD_ATOL_REL)
            excluded = {i: assert_params_close_where_conditioned(
                got, jstates[i].params, jstates[i].opt_state, PARAM_ATOL)
                for i, got in ((0, r['params'][0]), (2, r['restart_params']))}
            assert excluded == ILL_CONDITIONED_AT_ACCUM2
        else:
            for i in (0, 2):
                assert_tree_close(r['params'][i], jstates[i].params, rtol=0.0, atol=PARAM_ATOL)


def test_dp_drop_path_masks_are_the_global_batch_s(jax_params, tmp_path, tiny_preset):
    '''At drop-path 0.1 the 2-rank step equals the one-process port step: each rank draws
    the global batch's masks and keeps its rows. The masks matter: the step at drop-path 0
    lands more than 10x the limit away.'''
    b = jsyn.synthetic_device_batch(0, B=4, **BATCH_KW)
    ranks = start_ranks(tmp_path, 'train', 2,
                        train_payload(jax_params, b, steps=1, drop_path_rate=0.1))
    one = {rate: port_steps(jax_params, b, 1, seeker_kw=dict(drop_path_rate=rate))[0]
           for rate in (0.1, 0.0)}
    res = finish_ranks(ranks)
    for r in res:
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], one[0.1][0], rtol=LOSS_RTOL)
        assert_tree_close(r['params'][0], one[0.1][1], rtol=0.0, atol=PARAM_ATOL)
    moved = max(float(np.abs(a - w).max()) for a, w in zip(jax.tree.leaves(one[0.0][1]),
                                                            jax.tree.leaves(one[0.1][1])))
    assert moved > 10 * PARAM_ATOL, moved
    # Rows of a larger batch: the same draws as the whole batch's, sliced.
    gen = lambda: torch.Generator().manual_seed(3)
    whole = ptsf.draw_drop_path_masks(gen(), 0.5, 2, 12, 6, 4, 'cpu')
    part = ptsf.draw_drop_path_masks(gen(), 0.5, 2, 4, 6, 4, 'cpu', rows=(4, 12))
    for w, q in zip(whole, part):
        for name in ('temporal', 'spatial', 'mlp'):
            torch.testing.assert_close(getattr(q, name), getattr(w, name)[4:8], rtol=0, atol=0)


# ---------------------------------------------------------------------------------------
# Flags
# ---------------------------------------------------------------------------------------

# Every training layout trains since joint attention under --seq_shards and --pp_stages
# beside it were ported: over 2 data-parallel ranks joint attention at seq 2 parses, and the
# layouts of 8 or 4 ranks raise ValueError, the world being 2
# (tests/test_torch_sp_joint_pp.py holds the layouts that train).
@pytest.mark.parametrize('flags,error', [
    (['--seq_shards', '2', '--attention_type', 'joint_space_time'], None),
    (['--tp_shards', '2', '--seq_shards', '2', '--pp_stages', '2'],
     '--seq_shards 2 x --tp_shards 2 x --pp_stages 2 does not divide the world of 2 ranks'),
    (['--pp_stages', '2', '--seq_shards', '2'],
     '--seq_shards 2 x --pp_stages 2 does not divide the world of 2 ranks')])
def test_sequence_tensor_pipeline_flags_still_raise(flags, error):
    argv = ['--data_path', 'x', '--device', 'cpu', '--mesh_devices', '2', *flags]
    if error is None:
        assert pconfig.train_args(argv).seq_shards == 2
    else:
        with pytest.raises(ValueError, match=error):
            pconfig.train_args(argv)
    assert pconfig.train_args(argv[:6]).mesh_devices == 2
