'''
The port's sequence parallelism (tcow_tpu_torch/parallel/sequence.py, the seq axis of
parallel/mesh.py, the sequence-parallel backbone, train step and checkpoints) on CPU gloo
process groups, against the JAX package on the CPU's virtual devices: the rank layout and
rows of the (data, seq, model) mesh, the backbone forward at seq 2 and seq 4 under each cls
behaviour against JAX's unsharded forward, the step's gradients at (seq 2), (data 2, seq 2)
and (seq 2, model 2), and at seq 2 under causal_attention 0 and with rope, against JAX's
single-device step, the loss of one JAX step on its
(data 2, seq 4) mesh, the drop-path columns, rope and a checkpoint read by one process.

The ranks are processes running tests/test_torch_sp_ranks.py (which imports no JAX), forked
from a forkserver, one intra-op thread each; each process takes a list of jobs, one mesh a
job, so four processes serve the layouts of a fixture in turn while the test computes the
JAX oracle. Geometry: depth 2 at width 64 (4 heads), T = 7 at 32 x 80, a 2 x 5 patch grid:
seq 2 splits the frames 4 / 3, seq 4 the frames 2 / 2 / 2 / 1 and the patches 3 / 3 / 3 /
1, so neither divides; f32.
'''

import multiprocessing
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import conftest  # noqa: F401
from tcow_tpu.data import synthetic as jsyn
from tcow_tpu.models import mask_tracker as jmt
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu.objectives.losses import LossConfig as JLossConfig
from tcow_tpu.parallel import mesh as jmesh
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.parallel import sequence as pseq
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_to_jax
import test_torch_sp_ranks as sp_ranks
from test_torch_data_parallel import port_steps
from test_torch_train_step import (LOSS_RTOL, NORM_RTOL, OPT_KW, PARAM_ATOL, PROGRESS,
                                   SEEKER_KW, assert_tree_close)

# Seconds one launch of ranks may take (their imports, every job's rendezvous and work).
RANKS_TIMEOUT_S = 150
PROCS = 4
TINY_PRESET = (64, 4)
GEOM = dict(num_total_frames=7, frame_height=32, frame_width=80)
SP_SEEKER_KW = {**SEEKER_KW, **GEOM}
BATCH_KW = dict(Q=2, T=7, H=32, W=80, M=8, K=4)
CAUSAL = (0, 1, 2)
# test_stretch_config.py:71-73: the sequence-parallel forward against the unsharded one.
FWD_RTOL, FWD_ATOL = 2e-5, 1e-6
# The step's gradients against JAX's single-device step: relative L2 of each leaf
# (measured ~3e-7 against the one-process port).
GRAD_REL_L2 = 1e-4
# The step of record's pairing: per-block remat keeping the attention output, so the seq
# collectives run inside each block's checkpoint region and again in its recompute.
REMAT_KW = dict(remat=True, remat_policy='dots_nb_out', attention_bwd='kernel_x')
# test_stretch_config.py:23-45: the (data 2, seq 4) mesh's preset, B = 2, Q = 1.
STRETCH_PRESET = (32, 4)
STRETCH_SEEKER_KW = dict(num_total_frames=8, frame_height=32, frame_width=64,
                         causal_attention=1, drop_path_rate=0.0, network_depth=2)
STRETCH_OPT_KW = dict(learn_rate=1e-4, num_epochs=10, steps_per_epoch=10)


# ---------------------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------------------

def mesh_jobs(name, kind, payload, seq, model=1, n_data=1, procs=0, preset=TINY_PRESET):
    '''{process: job} of one mesh of n_data x seq x model ranks on the processes from
    `procs` on, meeting at a free port.'''
    world, port = n_data * seq * model, pmesh.free_port()
    return {procs + r: dict(name=name, kind=kind, payload=payload, world=world, rank=r,
                            port=port, seq=seq, model=model, preset=preset)
            for r in range(world)}


def start_jobs(tmp_path, name, payloads, rounds, procs=PROCS):
    '''Starts `procs` processes of test_torch_sp_ranks.rank_main, each with its jobs of
    `rounds` (a list of {process: job}) in order; finish_jobs waits for them.'''
    inp = tmp_path / f'{name}_in.pkl'
    inp.write_bytes(pickle.dumps(payloads))
    jobs = [[r[p] for r in rounds if p in r] for p in range(procs)]
    ctx = multiprocessing.get_context('forkserver')
    ctx.set_forkserver_preload(['test_torch_sp_ranks'])
    outs = [tmp_path / f'{name}_out{p}.pkl' for p in range(procs)]
    ps = [ctx.Process(target=sp_ranks.rank_main, args=(jobs[p], str(inp), str(outs[p])))
          for p in range(procs)]
    for p in ps:
        p.start()
    return ps, outs, time.monotonic() + RANKS_TIMEOUT_S


def finish_jobs(handle):
    '''{job name: [each rank's result, in rank order]}. Fails when a process raised (its
    traceback), exited non-zero, or had not ended RANKS_TIMEOUT_S after the start.'''
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
    for i, (p, got) in enumerate(zip(procs, res)):
        assert got is not None and 'error' not in got and p.exitcode == 0, (
            f'process {i} exited {p.exitcode}: {got and got.get("error")}')
    by_job = {}
    for got in res:
        for name, result in got.items():
            by_job.setdefault(name, []).append(result)
    return by_job


def noisy(tree, seed):
    '''A JAX parameter tree as numpy, every leaf moved by 0.02 x N(0, 1) (so that no block
    weight is zero).'''
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.02 * rng.randn(*a.shape).astype(np.float32), tree)


# ---------------------------------------------------------------------------------------
# Layout: the ranks of the (data, seq, model) mesh, their rows, chunks and masks
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('seq,model', [(4, 1), (2, 2)])
def test_sp_rank_layout_and_rows_match_jax_mesh(seq, model):
    '''The rank at each (data, seq, model) coordinate of an 8-rank world is JAX's device
    there, each rank's seq group is its (data, model) line, and its rows (shard_batch) are
    the data shard JAX's mesh gives that device: the seq and model ranks of a data row
    hold the same rows.'''
    world = 8
    mesh = jmesh.make_mesh(num_devices=world, seq=seq, model=model)
    layout = pmesh.rank_layout(world, model=model, seq=seq)
    np.testing.assert_array_equal(layout, np.vectorize(lambda d: d.id)(mesh.devices))
    b = jsyn.synthetic_device_batch(0, B=4, **BATCH_KW)
    placed = jmesh.shard_batch(b, mesh)
    for rank in range(world):
        fake = pmesh.DataMesh(world, rank, rank, torch.device('cpu'), 'gloo', '',
                              n_model=model, n_seq=seq)
        d, s, m = (int(c) for c in np.argwhere(layout[..., 0] == rank)[0])
        assert (fake.data_rank, fake.seq_rank, fake.model_rank) == (d, s, m)
        assert fake.seq_ranks == layout[d, :, m, 0].tolist()
        got = pmesh.shard_batch(b, fake)
        dev = mesh.devices[d, s, m, 0]
        for k, v in placed.items():
            if np.ndim(v) > 0:
                want = next(x.data for x in v.addressable_shards if x.device == dev)
                np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=f'{k} {rank}')


def test_sp_chunks_and_drop_path_columns():
    '''Chunks are contiguous and ceil-sized, the last shorter (T = 30 over 4: 8, 8, 8, 6),
    and an empty one raises; each rank's drop-path masks are its patches' and frames'
    columns of the whole (B, N) and (B, T) draws, the per-clip MLP masks whole.'''
    assert pseq.chunks(30, 4) == [(0, 8), (8, 16), (16, 24), (24, 30)]
    assert pseq.chunks(300, 2) == [(0, 150), (150, 300)]
    with pytest.raises(ValueError, match='non-empty'):
        pseq.chunks(5, 4)
    gen = lambda: torch.Generator().manual_seed(3)
    whole = ptsf.draw_drop_path_masks(gen(), 0.5, 2, 4, 10, 7, 'cpu')
    for n_seq in (2, 4):
        for r in range(n_seq):
            (n0, n1), (t0, t1) = pseq.chunks(10, n_seq)[r], pseq.chunks(7, n_seq)[r]
            part = ptsf.draw_drop_path_masks(gen(), 0.5, 2, 4, 10, 7, 'cpu',
                                             cols=((n0, n1), (t0, t1)))
            for w, q in zip(whole, part):
                torch.testing.assert_close(q.temporal, w.temporal[:, n0:n1], rtol=0, atol=0)
                torch.testing.assert_close(q.spatial, w.spatial[:, t0:t1], rtol=0, atol=0)
                torch.testing.assert_close(q.mlp, w.mlp, rtol=0, atol=0)


# ---------------------------------------------------------------------------------------
# The backbone forward at seq 2 and seq 4
# ---------------------------------------------------------------------------------------

BACKBONE_CFG = dict(frame_height=32, frame_width=80, patch_size=16, in_channels=4,
                    num_frames=7, depth=2, embed_dim=64, num_heads=4, drop_path_rate=0.0)


@pytest.fixture(scope='module')
def sp_forward(tmp_path_factory):
    '''JAX's unsharded backbone forward (features, cls) under each causal_attention of
    CAUSAL, and the ranks' at seq 4 and then seq 2, from the same weights and clips.'''
    params = noisy(jtsf.init_params(jax.random.key(0), jtsf.TimeSformerConfig(**BACKBONE_CFG)),
                   0)
    x = np.random.RandomState(1).randn(2, 4, 7, 32, 80).astype(np.float32)
    payload = dict(params=params, x=x, cfg=BACKBONE_CFG, cases=CAUSAL)
    handle = start_jobs(tmp_path_factory.mktemp('sp_forward'), 'forward', {'fwd': payload}, [
        mesh_jobs('seq4', 'forward', 'fwd', 4), mesh_jobs('seq2', 'forward', 'fwd', 2)])
    want = {}
    for ca in CAUSAL:
        cfg = jtsf.TimeSformerConfig(**BACKBONE_CFG, causal_attention=ca)
        feats, cls = jax.jit(lambda p, v: jtsf.forward(p, cfg, v))(params, jnp.asarray(x))
        want[ca] = (np.asarray(feats), np.asarray(cls))
    return want, finish_jobs(handle)


@pytest.mark.parametrize('ca', CAUSAL)
def test_sp_backbone_forward_matches_jax(sp_forward, ca):
    '''At seq 4 and seq 2 every rank's features and cls token equal JAX's unsharded
    forward's within test_stretch_config's tolerance, under causal_attention 0 (the cls
    token the mean over frames: a sum over the seq ranks), 1 (frame 0's: seq rank 0's) and
    2 (no cls token in spatial attention); each rank runs two attention calls a block, on
    its patches' and its frames' rows.'''
    want, res = sp_forward
    for name in ('seq4', 'seq2'):
        assert [r['coords'] for r in res[name]] == [(0, s, 0) for s in range(len(res[name]))]
        for s, r in enumerate(res[name]):
            got = r[ca]
            assert got['calls'] == {'res': 2 * BACKBONE_CFG['depth']}, got['calls']
            for k, w, g in (('feats', want[ca][0], got['feats']), ('cls', want[ca][1],
                                                                    got['cls'])):
                np.testing.assert_allclose(g, w, rtol=FWD_RTOL, atol=FWD_ATOL,
                                           err_msg=f'{name} rank {s} ca {ca} {k}')


# ---------------------------------------------------------------------------------------
# The train step: gradients, drop-path, rope, checkpoints
# ---------------------------------------------------------------------------------------

def step_payload(params, b, steps=1, out=None, **seeker_kw):
    return dict(params=params, batch=b, seeker_kw={**SP_SEEKER_KW, **seeker_kw},
                num_queries=2, opt_kw=OPT_KW, progress=PROGRESS, steps=steps, out=out)


def with_frame_times(b, seed=5):
    rng = np.random.RandomState(seed)
    B, T = b['query_inds'].shape[0], BATCH_KW['T']
    return {**b, 'frame_times': (np.cumsum(1.0 + rng.rand(B, T), axis=1)).astype(np.float32)}


@pytest.fixture(scope='module')
def sp_steps(tmp_path_factory):
    '''The ranks' gradients of a 4-clip batch at (data 2, seq 2), (seq 2, model 2) and
    (seq 2), and at seq 2 under causal_attention 0 and with rope; one step at seq 2 of a
    2-clip batch with rope, and with drop-path 0.1 under the step of record's remat policy
    followed by a checkpoint; against them JAX's single-device gradients of the 4-clip
    batch (as set, under causal_attention 0 and with rope) and the one-process port's
    steps.'''
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jtsf.DEPTH_PRESETS, 2, TINY_PRESET)
        mp.setitem(ptsf.DEPTH_PRESETS, 2, TINY_PRESET)
        params = noisy(jmt.init_params(jax.random.key(0), jmt.SeekerConfig(**SP_SEEKER_KW)), 0)
        b4 = jsyn.synthetic_device_batch(0, B=4, **BATCH_KW)
        b2 = jsyn.synthetic_device_batch(1, B=2, **BATCH_KW)
        tmp = tmp_path_factory.mktemp('sp_steps')
        rope_kw = dict(temporal_rope=True, rope_time_coords=True)
        payloads = {'grads': step_payload(params, b4),
                    'grads_ca0': step_payload(params, b4, causal_attention=0),
                    'grads_rope': step_payload(params, with_frame_times(b4), **rope_kw),
                    'rope': step_payload(params, with_frame_times(b2), **rope_kw),
                    'drop': step_payload(params, b2, out=str(tmp / 'ckpt'),
                                         drop_path_rate=0.1, **REMAT_KW)}
        handle = start_jobs(tmp, 'steps', payloads, [
            mesh_jobs('data2_seq2', 'grads', 'grads', 2, n_data=2),
            mesh_jobs('seq2_model2', 'grads', 'grads', 2, model=2),
            {**mesh_jobs('seq2', 'grads', 'grads', 2),
             **mesh_jobs('rope', 'train', 'rope', 2, procs=2)},
            {**mesh_jobs('drop', 'train', 'drop', 2),
             **mesh_jobs('ca0', 'grads', 'grads_ca0', 2, procs=2)},
            mesh_jobs('rope_grads', 'grads', 'grads_rope', 2, procs=2)])
        want = jax_grads(params, b4)
        want_ca0 = jax_grads(params, b4, causal_attention=0)
        want_rope = jax_grads(params, with_frame_times(b4), **rope_kw)
        one = {'rope': port_steps(params, with_frame_times(b2), 1,
                                  seeker_kw={**GEOM, **rope_kw})[0],
               'drop': port_steps(params, b2, 1,
                                  seeker_kw={**GEOM, 'drop_path_rate': 0.1, **REMAT_KW})[0],
               'nodrop': port_steps(params, b2, 1, seeker_kw={**GEOM, **REMAT_KW})[0],
               'ca0': port_grads(params, b4, causal_attention=0)}
        return dict(want, ca0=want_ca0, rope=want_rope), one, finish_jobs(handle)


def jax_grads(params, b, **seeker_kw):
    '''JAX's single-device loss, losses and gradients of b (jitted).'''
    jcfg = jstep.StepConfig(seeker=jmt.SeekerConfig(**{**SP_SEEKER_KW, **seeker_kw}),
                            loss=JLossConfig(), num_queries=2)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jstep._loss_and_aux(p, jcfg, b, None, jnp.float32(PROGRESS), True),
        has_aux=True))
    (jloss, jaux), jgrads = grad_fn(params, {k: jnp.asarray(v) for k, v in b.items()})
    return dict(loss=float(jloss), losses={k: float(jaux[k]) for k in sp_ranks.LOSS_KEYS},
                grads=jax.tree.map(np.asarray, jgrads))


def port_grads(params, b, **seeker_kw):
    '''The one-process port step's gradients of b (a JAX-layout tree).'''
    cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**{**SP_SEEKER_KW, **seeker_kw}),
                           loss=plosses.LossConfig(), num_queries=2)
    state = pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **OPT_KW),
                                   params=params, device='cpu')
    pstep.compute_gradients(state, cfg, b, PROGRESS)
    return params_to_jax({n: (q.grad if q.grad is not None else torch.zeros_like(q))
                          for n, q in state.model.named_parameters()})


def assert_grads_close(got, want, what):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got),
                            strict=True):
        err = np.linalg.norm(g - w)
        assert err <= GRAD_REL_L2 * np.linalg.norm(w), (
            f'{what} {jax.tree_util.keystr(path)}: {err} of {np.linalg.norm(w)}')


@pytest.mark.parametrize('layout,coords', [
    ('seq2', [(0, 0, 0), (0, 1, 0)]),
    ('data2_seq2', [(0, 0, 0), (0, 1, 0), (1, 0, 0), (1, 1, 0)]),
    ('seq2_model2', [(0, 0, 0), (0, 0, 1), (0, 1, 0), (0, 1, 1)])])
def test_sp_gradients_match_jax_single_device(sp_steps, layout, coords):
    '''The step's f32 gradients of a 4-clip batch, summed over the (data x seq) ranks and
    gathered over the model ranks, equal JAX's single-device gradients on every rank within
    GRAD_REL_L2 (relative L2 of each leaf), and so do the losses within LOSS_RTOL. Every
    replicated computation (the embedding, the cls token's MLP, the heads, the losses)
    enters the sum once: a scheme that gave every seq rank the whole cotangent of the cls
    token would count its MLP twice and fail here.'''
    want, _, res = sp_steps
    assert [r['coords'] for r in res[layout]] == coords
    for r in res[layout]:
        assert r['rows'] == 4 // (1 + (layout == 'data2_seq2'))
        for k, v in want['losses'].items():
            np.testing.assert_allclose(r['losses'][k], v, rtol=LOSS_RTOL, err_msg=k)
        assert_grads_close(r['grads'], want['grads'], layout)


def test_sp_mean_over_frames_gradients_match_one_process(sp_steps):
    '''Under causal_attention 0 the new cls token is the mean of every frame's cls output,
    a sum over the seq ranks whose backward sums the ranks' partial cotangents: the seq-2
    gradients equal the one-process port step's within GRAD_REL_L2.'''
    _, one, res = sp_steps
    for r in res['ca0']:
        assert_grads_close(r['grads'], one['ca0'], 'ca0')


def test_sp_mean_over_frames_gradients_match_jax_single_device(sp_steps):
    '''Under causal_attention 0 the seq-2 ranks' f32 gradients of the 4-clip batch, and the
    one-process port step's, equal JAX's single-device gradients within GRAD_REL_L2, and
    the ranks' losses JAX's within LOSS_RTOL: the cls token's sum over the seq ranks and
    its backward against JAX.'''
    want, one, res = sp_steps
    assert_grads_close(one['ca0'], want['ca0']['grads'], 'ca0 one process')
    for r in res['ca0']:
        for k, v in want['ca0']['losses'].items():
            np.testing.assert_allclose(r['losses'][k], v, rtol=LOSS_RTOL, err_msg=k)
        assert_grads_close(r['grads'], want['ca0']['grads'], 'ca0')


def test_sp_rope_gradients_match_jax_single_device(sp_steps):
    '''Time-calibrated rope under seq 2: the ranks' f32 gradients of the 4-clip batch with
    its frame times equal JAX's single-device rope gradients within GRAD_REL_L2, and the
    losses JAX's within LOSS_RTOL.'''
    want, _, res = sp_steps
    assert [r['coords'] for r in res['rope_grads']] == [(0, 0, 0), (0, 1, 0)]
    for r in res['rope_grads']:
        for k, v in want['rope']['losses'].items():
            np.testing.assert_allclose(r['losses'][k], v, rtol=LOSS_RTOL, err_msg=k)
        assert_grads_close(r['grads'], want['rope']['grads'], 'rope')


def test_sp_drop_path_and_remat_match_one_process(sp_steps):
    '''At drop-path 0.1, under the step of record's remat policy, the seq-2 step equals the
    one-process port step: each seq rank keeps its patches' and frames' columns of the data
    row's masks, and computes one attention forward a call (2 a block: the policy keeps the
    output, the recompute re-issues only the collectives). The masks matter: the step at
    drop-path 0 lands more than 10x the limit away.'''
    _, one, res = sp_steps
    for r in res['drop']:
        assert r['calls'] == [{'kernel_x': 2 * SEEKER_KW['network_depth']}], r['calls']
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], one['drop'][0],
                                   rtol=LOSS_RTOL)
        assert_tree_close(r['params'][0], one['drop'][1], rtol=0.0, atol=PARAM_ATOL)
    moved = max(float(np.abs(a - w).max()) for a, w in zip(jax.tree.leaves(one['nodrop'][1]),
                                                            jax.tree.leaves(one['drop'][1])))
    assert moved > 10 * PARAM_ATOL, moved


def test_sp_rope_step_matches_one_process(sp_steps):
    '''Time-calibrated rope under seq 2: each rank's temporal calls rotate its patches' rows
    by the clip's frame times; the step equals the one-process port step.'''
    _, one, res = sp_steps
    for r in res['rope']:
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], one['rope'][0],
                                   rtol=LOSS_RTOL)
        assert_tree_close(r['params'][0], one['rope'][1], rtol=0.0, atol=PARAM_ATOL)


def test_sp_checkpoint_loads_in_one_process(sp_steps):
    '''The checkpoint written after the seq-2 step (rank 0 writes, the state being
    replicated) loads into a one-process state that holds what the ranks held, bit for
    bit: parameters, AdamW moments, step, count and generator.'''
    _, _, res = sp_steps
    ranks = res['drop']
    assert ranks[0]['path'] is not None and ranks[1]['path'] is None
    assert ranks[0]['digest'] == ranks[1]['digest']
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ptsf.DEPTH_PRESETS, 2, TINY_PRESET)
        cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**SP_SEEKER_KW),
                               loss=plosses.LossConfig(), num_queries=2)
        template = pstep.init_train_state(1, cfg, poptim.make_optimizer('adamw', **OPT_KW),
                                          device='cpu')
        loaded = pckpt.load_checkpoint(ranks[0]['path'], state_template=template)['state']
    held = ranks[0]['held']
    got = {'params': params_to_jax(loaded.model.state_dict()),
           'opt_state': pckpt.opt_state_to_jax(loaded.optimizer)}
    for what in ('params', 'opt_state'):
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(held[what]),
                                jax.tree.leaves(got[what]), strict=True):
            np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
    assert (loaded.step, loaded.optimizer.count) == (held['step'], held['count']) == (1, 1)
    np.testing.assert_array_equal(loaded.generator.get_state().numpy(), held['generator'])


# ---------------------------------------------------------------------------------------
# One step of JAX's (data 2, seq 4) mesh
# ---------------------------------------------------------------------------------------

def test_sp_step_loss_matches_jax_data2_seq4_mesh(tmp_path):
    '''One AdamW step of 8 ranks as (data 2, seq 4) at test_stretch_config's preset (width
    32, T = 8 at 32 x 64, B = 2, Q = 1: one clip a data row, 2 patches and 2 frames a seq
    rank) has the loss and gradient norm of JAX's jitted step on its own (data 2, seq 4)
    mesh, from the same state.'''
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jtsf.DEPTH_PRESETS, 2, STRETCH_PRESET)
        seeker = jmt.SeekerConfig(**STRETCH_SEEKER_KW, batch_axis=jmesh.DATA_AXIS,
                                  seq_axis=jmesh.SEQ_AXIS)
        cfg = jstep.StepConfig(seeker=seeker, loss=JLossConfig(), num_queries=1)
        tx = joptim.make_optimizer('adamw', **STRETCH_OPT_KW)
        state = jstep.init_train_state(jax.random.key(0), cfg, tx)
        params = jax.tree.map(np.array, state.params)     # copies: JAX may reuse them
        b = jsyn.synthetic_device_batch(0, B=2, Q=1, T=8, H=32, W=64, M=6, K=3)
        payload = dict(params=params, batch=b, seeker_kw=STRETCH_SEEKER_KW, num_queries=1,
                       opt_kw=STRETCH_OPT_KW, progress=0.0, steps=1)
        handle = start_jobs(tmp_path, 'mesh', {'mesh': payload}, [
            mesh_jobs('data2_seq4', 'train', 'mesh', 4, n_data=2, preset=STRETCH_PRESET)],
            procs=8)
        mesh = jmesh.make_mesh(seq=4)
        with jax.set_mesh(mesh):
            _, aux = jax.jit(jstep.make_train_step(cfg, tx))(
                jmesh.replicate_tree(state, mesh), jmesh.shard_batch(b, mesh), jnp.float32(0.0))
        want = {k: float(aux[k]) for k in ('total_seeker', 'grad_norm')}
    res = finish_jobs(handle)['data2_seq4']
    assert [r['coords'] for r in res] == [(d, s, 0) for d in range(2) for s in range(4)]
    assert len({r['digest'] for r in res}) == 1
    for r in res:
        assert r['rows'] == 1
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], want['total_seeker'],
                                   rtol=1e-5)
        np.testing.assert_allclose(r['steps'][0]['grad_norm'], want['grad_norm'],
                                   rtol=NORM_RTOL)


# ---------------------------------------------------------------------------------------
# Flags
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('flags,error', [
    (['--mesh_devices', '2', '--seq_shards', '2'], None),
    (['--mesh_devices', '4', '--seq_shards', '2', '--tp_shards', '2'], None),
    (['--mesh_devices', '8', '--seq_shards', '4', '--num_frames', '30'], None),
    (['--mesh_devices', '4', '--seq_shards', '2', '--tp_shards', '4'],
     '--seq_shards 2 x --tp_shards 4 does not divide the world of 4 ranks'),
    (['--seq_shards', '2'], 'does not divide the world of 1 ranks'),
    (['--mesh_devices', '4', '--seq_shards', '4', '--num_frames', '6'],
     'non-empty seq chunks')])
def test_seq_shards_parse_for_training_when_they_divide(flags, error):
    '''--seq_shards parses for training, alone or beside --tp_shards, when seq_shards x
    tp_shards divides the world (--mesh_devices, or the one CPU process) and every seq rank
    keeps frames (6 frames over 4 ranks leave the last none); else ValueError.'''
    argv = ['--data_path', 'x', '--device', 'cpu', *flags]
    if error is None:
        assert pconfig.train_args(argv).seq_shards == int(flags[flags.index('--seq_shards') + 1])
    else:
        with pytest.raises(ValueError, match=error):
            pconfig.train_args(argv)


@pytest.mark.parametrize('flags,error', [
    (['--mesh_devices', '2', '--seq_shards', '2', '--attention_type', 'joint_space_time'],
     None),
    (['--mesh_devices', '4', '--seq_shards', '4', '--num_frames', '6', '--attention_type',
      'joint_space_time'], None),
    (['--mesh_devices', '4', '--seq_shards', '2', '--pp_stages', '2'], None),
    (['--mesh_devices', '8', '--seq_shards', '2', '--tp_shards', '2', '--pp_stages', '2'],
     None),
    (['--mesh_devices', '2', '--seq_shards', '2', '--pp_stages', '2'],
     '--seq_shards 2 x --pp_stages 2 does not divide the world of 2 ranks'),
    (['--mesh_devices', '6', '--seq_shards', '4', '--attention_type', 'joint_space_time'],
     'does not divide the world of 6 ranks')])
def test_seq_shards_with_joint_attention_and_pipeline_stages_parse(flags, error):
    '''Joint attention and pipeline stages beside --seq_shards parse for training when the
    product of the axes divides the world, else ValueError; joint attention splits the
    clips, not the frames, so 6 frames over 4 seq ranks parse there.'''
    argv = ['--data_path', 'x', '--device', 'cpu', *flags]
    if error is None:
        args = pconfig.train_args(argv)
        assert args.seq_shards == int(flags[flags.index('--seq_shards') + 1])
    else:
        with pytest.raises(ValueError, match=error):
            pconfig.train_args(argv)


def test_seq_shards_still_raise_for_evaluation():
    with pytest.raises(NotImplementedError, match='item 7'):
        pconfig.test_args(['--data_path', 'x', '--device', 'cpu', '--seq_shards', '2'])
