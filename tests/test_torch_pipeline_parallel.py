'''
The port's pipeline parallelism (tcow_tpu_torch/parallel/pipeline.py, the pipe axis of
parallel/mesh.py, the stage-local backbone, the pipelined train, eval and vis steps and
their checkpoints) on CPU gloo process groups, against the JAX package: its plain
functions (resolve_pp_microbatches, validate_pp_args), its (data, seq, model, pipe) mesh
and block_pspec's stage split, and its single-device step, forward and gradients at the
small presets of tests/test_pipeline_parallel.py (width 32, 4 heads; T = 4 at 32 x 32;
B = 4 clips x 2 queries, 8 folded rows). JAX's own tests hold its GSPMD and manual pipe
against that single-device step, so its pipe programs are not run here again.

Layouts: pipe 2 at M = 2 and 4, pipe 4 (depth 4), remat_group 2 (depth 4), grad_accum 2,
(data 2, pipe 2), (model 2, pipe 2), (data 2, model 2, pipe 2); drop-path against the
one-process port step (the masks do not follow JAX's threefry); a checkpoint that one
process, port or JAX, loads; the vis step at one query; train_torch.py --pp_stages 2.

The ranks are processes running tests/test_torch_pp_ranks.py (which imports no JAX),
forked from a forkserver, one intra-op thread each; each process takes a list of jobs, one
mesh a job, while the test computes the JAX oracles (jitted). f32.
'''

import argparse
import json
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
from tcow_tpu.train import checkpoint as jckpt
from tcow_tpu.train import driver as jdriver
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.parallel import pipeline as ppipe
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax
import test_torch_pp_ranks as pp_ranks
from test_torch_multiprocess_train import (RUN_TIMEOUT_S, STEP_STATS, STEPS_PER_EPOCH,  # noqa: F401
                                           checkpoint_arrays, finish, kubric_root,
                                           rank_logs, start, train_argv)

# Seconds one launch of ranks may take (their imports, every job's rendezvous and work).
RANKS_TIMEOUT_S = 180
PROCS = 4
# tests/test_pipeline_parallel.py:28-36, 102-110: the presets, geometry, batch, optimizer.
PRESET = (32, 4)
SEEKER_KW = dict(num_total_frames=4, frame_height=32, frame_width=32, causal_attention=1,
                 drop_path_rate=0.0, network_depth=2)
BATCH_KW = dict(B=4, Q=2, T=4, H=32, W=32, M=6, K=3)
OPT_KW = dict(learn_rate=1e-3, num_epochs=10, steps_per_epoch=5)
PROGRESS = 0.0
# tests/test_pallas_attention.py:31: the forward; tests/test_pipeline_parallel.py:146: the
# parameters after a step, and the loss.
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
PARAM_RTOL, PARAM_ATOL = 1e-3, 1e-5
LOSS_RTOL = 1e-5
# Gradients against JAX's single-device gradients: relative L2 of each leaf, as the
# sequence-parallel tests hold them.
GRAD_REL_L2 = 1e-4
# The step of record's pairing: per-block remat keeping the attention output.
REMAT_KW = dict(remat=True, remat_policy='dots_nb_out', attention_bwd='kernel_x')


# ---------------------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------------------

def mesh_jobs(name, kind, payload, pipe, model=1, n_data=1, procs=0):
    '''{process: job} of one mesh of n_data x model x pipe ranks on the processes from
    `procs` on, meeting at a free port.'''
    world, port = n_data * model * pipe, pmesh.free_port()
    return {procs + r: dict(name=name, kind=kind, payload=payload, world=world, rank=r,
                            port=port, model=model, pipe=pipe, preset=PRESET)
            for r in range(world)}


def start_jobs(tmp_path, name, payloads, rounds, procs=PROCS):
    '''Starts `procs` processes of test_torch_pp_ranks.rank_main, each with its jobs of
    `rounds` (a list of {process: job}) in order; finish_jobs waits for them.'''
    inp = tmp_path / f'{name}_in.pkl'
    inp.write_bytes(pickle.dumps(payloads))
    jobs = [[r[p] for r in rounds if p in r] for p in range(procs)]
    ctx = multiprocessing.get_context('forkserver')
    ctx.set_forkserver_preload(['test_torch_pp_ranks'])
    outs = [tmp_path / f'{name}_out{p}.pkl' for p in range(procs)]
    ps = [ctx.Process(target=pp_ranks.rank_main, args=(jobs[p], str(inp), str(outs[p])))
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


def port_init(seed, **seeker_kw):
    '''The seeker's initial parameters (the port's init of tcow_tpu's init_params) as a
    JAX-layout numpy tree.'''
    model = pmt.MaskTracker(pmt.SeekerConfig(**{**SEEKER_KW, **seeker_kw}), device='cpu')
    model.init_params_(torch.Generator().manual_seed(seed))
    return params_to_jax(model.state_dict())


def jax_state(params, jcfg, tx):
    '''JAX's TrainState over copies of `params` (JAX may reuse the arrays it is given).'''
    return jstep.init_train_state(jax.random.key(0), jcfg, tx,
                                  params=jax.tree.map(lambda a: jnp.asarray(a.copy()), params))


def noisy(tree, seed):
    '''A JAX parameter tree as numpy, every leaf moved by 0.02 x N(0, 1) (so that no block
    weight is zero).'''
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        + 0.02 * rng.randn(*a.shape).astype(np.float32), tree)


def same_clips(b):
    '''The batch with every clip a copy of clip 0 (its queries too).'''
    return {k: (np.repeat(v[:1], v.shape[0], axis=0) if np.ndim(v) > 0 else v)
            for k, v in b.items()}


# ---------------------------------------------------------------------------------------
# Plain functions, the rank layout and the stage split
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('requested,stages,rows', [
    (0, 2, 8), (0, 2, 12), (0, 2, 6), (0, 2, 2), (0, 4, 64), (0, 2, 3), (3, 2, 8), (0, 4, 8),
    (0, 3, 18), (2, 2, 6)])
def test_pp_resolve_microbatches_matches_jax(requested, stages, rows):
    '''The port's resolve_pp_microbatches is JAX's (the largest of 4S, 2S and S that
    divides the rows; an explicit request as it is), case for case.'''
    assert ppipe.resolve_pp_microbatches(requested, stages, rows) == \
        jtsf.resolve_pp_microbatches(requested, stages, rows)


@pytest.mark.parametrize('kw', [
    dict(pp_stages=5), dict(pp_stages=2, pp_microbatches=7),
    dict(pp_stages=2, remat_group=5, batch_size=2, num_queries=2),
    dict(pp_stages=2, batch_size=2, num_queries=2), dict(pp_stages=1),
    dict(pp_stages=4, network_depth=12, remat_group=2), dict(pp_stages=3, num_queries=3),
    dict(pp_stages=2, grad_accum=2, batch_size=4, num_queries=1, pp_microbatches=4)])
def test_pp_validate_args_matches_jax(kw):
    '''The port's validate_pp_args accepts (returning pp_stages) and refuses (ValueError,
    the same text) what JAX's does, on the flags' defaults.'''
    args = argparse.Namespace(**{**dict(network_depth=12, remat_group=1, grad_accum=1,
                                        batch_size=4, num_queries=1, pp_microbatches=0), **kw})
    outcomes = []
    for fn in (jdriver.validate_pp_args, ppipe.validate_pp_args):
        try:
            outcomes.append(fn(args))
        except ValueError as e:
            outcomes.append(str(e))
    assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize('model,pipe', [(1, 2), (2, 2), (1, 4), (2, 4)])
def test_pp_rank_layout_and_rows_match_jax_mesh(model, pipe):
    '''The rank at each (data, seq, model, pipe) coordinate of an 8-rank world is JAX's
    device there (pipe varies fastest), each rank's pipe group is its (data, model) line,
    and its rows (shard_batch) are the data shard JAX's mesh gives that device.'''
    world = 8
    mesh = jmesh.make_mesh(num_devices=world, model=model, pipe=pipe)
    layout = pmesh.rank_layout(world, model=model, pipe=pipe)
    np.testing.assert_array_equal(layout, np.vectorize(lambda d: d.id)(mesh.devices))
    b = jsyn.synthetic_device_batch(0, **{**BATCH_KW, 'B': 8 // (model * pipe)})
    placed = jmesh.shard_batch(b, mesh)
    for rank in range(world):
        fake = pmesh.DataMesh(world, rank, rank, torch.device('cpu'), 'gloo', '',
                              n_model=model, n_pipe=pipe)
        d, s, m, p = (int(c) for c in np.argwhere(layout == rank)[0])
        assert (fake.data_rank, fake.seq_rank, fake.model_rank, fake.pipe_rank) == (d, s, m, p)
        assert fake.pipe_ranks == layout[d, s, m].tolist()
        got = pmesh.shard_batch(b, fake)
        dev = mesh.devices[d, s, m, p]
        for k, v in placed.items():
            if np.ndim(v) > 0:
                want = next(x.data for x in v.addressable_shards if x.device == dev)
                np.testing.assert_array_equal(got[k], np.asarray(want), err_msg=f'{k} {rank}')


@pytest.mark.parametrize('model,pipe', [(1, 2), (2, 2), (1, 4)])
def test_pp_stage_split_matches_block_pspec(model, pipe):
    '''shard_params gives each rank the stage's contiguous chunk of every stacked block
    leaf (numbered from 0), with the tensor-parallel split on top, and everything else
    whole: the shard block_pspec(pipe_axis='pipe') places on that rank's device;
    gather_state_dict's inverse, without collectives, is checked by the rank tests.'''
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ptsf.DEPTH_PRESETS, 4, PRESET)
        params = port_init(0, network_depth=4)
    world = 8
    mesh = jmesh.make_mesh(num_devices=world, model=model, pipe=pipe)
    placed = jmesh.shard_state(params, mesh, tensor_parallel=model > 1, pipeline=True)
    full = params_from_jax(params)
    layout = pmesh.rank_layout(world, model=model, pipe=pipe)
    for rank in range(world):
        fake = pmesh.DataMesh(world, rank, rank, torch.device('cpu'), 'gloo', '',
                              n_model=model, n_pipe=pipe)
        got = params_to_jax(pmesh.shard_params(full, fake))
        dev = mesh.devices[tuple(int(c) for c in np.argwhere(layout == rank)[0])]
        for (path, v), g in zip(jax.tree_util.tree_leaves_with_path(placed),
                                jax.tree.leaves(got), strict=True):
            want = next(x.data for x in v.addressable_shards if x.device == dev)
            np.testing.assert_array_equal(g, np.asarray(want),
                                          err_msg=f'{jax.tree_util.keystr(path)} {rank}')


@pytest.mark.parametrize('flags,error', [
    (['--mesh_devices', '4', '--pp_stages', '2', '--pp_manual', '1'], None),
    (['--mesh_devices', '2', '--pp_stages', '2', '--pp_microbatches', '3'], None),
    (['--mesh_devices', '4', '--tp_shards', '2', '--pp_stages', '2', '--pp_manual', '1'],
     r'--pp_manual supports \(pipe x data\) meshes only; --tp_shards is 2'),
    (['--mesh_devices', '4', '--tp_shards', '2', '--pp_stages', '4'],
     '--tp_shards 2 x --pp_stages 4 does not divide the world of 4 ranks'),
    (['--pp_stages', '2'], 'does not divide the world of 1 ranks')])
def test_pp_flags_parse_when_they_divide_and_pp_manual_keeps_jax_layout(flags, error):
    '''--pp_stages parses for training, alone or beside --tp_shards, when tp_shards x
    pp_stages divides the world; --pp_manual 1 keeps JAX's manual-pipe rule of (pipe x
    data) meshes only (tcow_tpu/models/timesformer.py:646-648), else ValueError.'''
    argv = ['--data_path', 'x', '--device', 'cpu', *flags]
    if error is None:
        assert pconfig.train_args(argv).pp_stages == 2
    else:
        with pytest.raises(ValueError, match=error):
            pconfig.train_args(argv)


# ---------------------------------------------------------------------------------------
# The pipelined step against JAX's single-device step and the one-process port
# ---------------------------------------------------------------------------------------

def payload(params, b, steps=1, num_queries=2, out=None, accum=1, **seeker_kw):
    return dict(params=params, batch=b, seeker_kw={**SEEKER_KW, **seeker_kw},
                num_queries=num_queries, opt_kw=OPT_KW, progress=PROGRESS, steps=steps,
                out=out, accum=accum, micro=2, train=False, seed=0)


def jax_cfg(num_queries=2, **seeker_kw):
    return jstep.StepConfig(seeker=jmt.SeekerConfig(**{**SEEKER_KW, **seeker_kw}),
                            loss=JLossConfig(), num_queries=num_queries)


def jax_grads(params, b, **seeker_kw):
    '''JAX's single-device loss, losses and gradients of b (jitted).'''
    jcfg = jax_cfg(**seeker_kw)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, b: jstep._loss_and_aux(p, jcfg, b, None, jnp.float32(PROGRESS), True),
        has_aux=True))
    (jloss, jaux), jgrads = grad_fn(params, {k: jnp.asarray(v) for k, v in b.items()})
    return dict(loss=float(jloss), losses={k: float(jaux[k]) for k in pp_ranks.LOSS_KEYS},
                grads=jax.tree.map(np.asarray, jgrads))


def port_state(params, num_queries=2, **seeker_kw):
    cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**{**SEEKER_KW, **seeker_kw}),
                           loss=plosses.LossConfig(), num_queries=num_queries)
    return cfg, pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **OPT_KW),
                                       params=params, device='cpu')


def port_grads(params, b, accum=1, **seeker_kw):
    '''The one-process port step's gradients of b (a JAX-layout tree).'''
    cfg, state = port_state(params, **seeker_kw)
    pstep.compute_gradients(state, cfg, b, PROGRESS, accum)
    return params_to_jax({n: (q.grad if q.grad is not None else torch.zeros_like(q))
                          for n, q in state.model.named_parameters()})


def assert_grads_close(got, want, what):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got),
                            strict=True):
        err = np.linalg.norm(g - w)
        assert err <= GRAD_REL_L2 * np.linalg.norm(w), (
            f'{what} {jax.tree_util.keystr(path)}: {err} of {np.linalg.norm(w)}')


def assert_tree_close(got, want, what, rtol, atol):
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want), jax.tree.leaves(got),
                            strict=True):
        np.testing.assert_allclose(g, np.asarray(w), rtol=rtol, atol=atol,
                                   err_msg=f'{what} {jax.tree_util.keystr(path)}')


# The gradient layouts: (job, payload, pipe, model, n_data, stages' blocks) and the JAX
# oracle of each payload.
GRAD_LAYOUTS = {'s2_m2': ('g2_m2', 2, [[0], [1]]), 's2_m4': ('g2_m4', 2, [[0], [1]]),
                's4_m2': ('g4_m2', 4, [[0], [1], [2], [3]]),
                's2_m4_g2': ('g4_g2', 2, [[0, 1], [2, 3]]),
                's2_accum2': ('g2_accum2', 2, [[0], [1]])}


def pipeline_runs(tmp):
    '''The ranks' gradients of the 4-clip batch under GRAD_LAYOUTS; one AdamW step from
    the initial state at pipe 2, (data 2, pipe 2), (model 2, pipe 2) and, on 8 more
    processes, (data 2, model 2, pipe 2); one step with drop-path 0.1 under the step of
    record's remat policy and its checkpoint; the pipelined forward at M = 2, at drop-path
    0.5 on two equal clips, and the vis step at one query; against them JAX's
    single-device gradients, step and forward, and the one-process port's.'''
    with pytest.MonkeyPatch.context() as mp:
        for depth in (2, 4):
            mp.setitem(jtsf.DEPTH_PRESETS, depth, PRESET)
            mp.setitem(ptsf.DEPTH_PRESETS, depth, PRESET)
        init = port_init(0)
        p2, p4 = noisy(init, 0), noisy(port_init(1, network_depth=4), 1)
        tx = joptim.make_optimizer('adamw', **OPT_KW)
        jcfg = jax_cfg()
        jstate = jax_state(init, jcfg, tx)
        b = jsyn.synthetic_device_batch(3, **BATCH_KW)
        b1 = jsyn.synthetic_device_batch(5, **{**BATCH_KW, 'B': 2, 'Q': 1})
        twin = same_clips(jsyn.synthetic_device_batch(7, **{**BATCH_KW, 'B': 2, 'Q': 1}))
        d4 = dict(network_depth=4)
        payloads = {
            'g2_m2': payload(p2, b, pp_microbatches=2),
            'g2_m4': payload(p2, b, pp_microbatches=4),
            'g4_m2': payload(p4, b, pp_microbatches=2, **d4),
            'g4_g2': payload(p4, b, pp_microbatches=4, remat=True, remat_group=2, **d4),
            'g2_accum2': payload(p2, b, accum=2),
            'train': payload(init, b),
            'drop': payload(p2, b, out=str(tmp / 'ckpt'), drop_path_rate=0.1, **REMAT_KW),
            'fwd': payload(p2, b),
            'twin': {**payload(p2, twin, num_queries=1, drop_path_rate=0.5), 'train': True,
                     'seed': 11},
            'vis': payload(p2, b1, num_queries=1)}
        handle = start_jobs(tmp, 'pp', payloads, [
            {**mesh_jobs('s2_m2', 'grads', 'g2_m2', 2),
             **mesh_jobs('s2_m4', 'grads', 'g2_m4', 2, procs=2)},
            mesh_jobs('s4_m2', 'grads', 'g4_m2', 4),
            {**mesh_jobs('s2_m4_g2', 'grads', 'g4_g2', 2),
             **mesh_jobs('s2_accum2', 'grads', 'g2_accum2', 2, procs=2)},
            {**mesh_jobs('pipe2', 'train', 'train', 2),
             **mesh_jobs('drop', 'train', 'drop', 2, procs=2)},
            mesh_jobs('data2_pipe2', 'train', 'train', 2, n_data=2),
            mesh_jobs('model2_pipe2', 'train', 'train', 2, model=2),
            {**mesh_jobs('fwd', 'forward', 'fwd', 2),
             **mesh_jobs('twin', 'forward', 'twin', 2, procs=2)},
            mesh_jobs('vis', 'vis', 'vis', 2)])
        grid = start_jobs(tmp, 'grid', payloads, [
            mesh_jobs('data2_model2_pipe2', 'train', 'train', 2, model=2, n_data=2)], procs=8)
        want = {'g2': jax_grads(p2, b), 'g4': jax_grads(p4, b, **d4)}
        jstate2, jaux = jax.jit(jstep.make_train_step(jcfg, tx))(
            jstate, {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(PROGRESS))
        want['step'] = dict(loss=float(jaux['total_seeker']),
                            grad_norm=float(jaux['grad_norm']),
                            params=jax.tree.map(np.asarray, jstate2.params))
        jeval = jax.jit(jstep.make_eval_step(jcfg, return_outputs=True))(
            p2, {k: jnp.asarray(v) for k, v in b.items()}, jnp.float32(PROGRESS))
        want['fwd'] = dict(mask=np.asarray(jeval['output_mask']),
                           losses={k: float(jeval[k]) for k in pp_ranks.LOSS_KEYS})
        one = {'g2': port_grads(p2, b), 'g4_m2': port_grads(p4, b, **d4),
               'g4_g2': port_grads(p4, b, remat=True, remat_group=2, **d4),
               'g2_accum2': port_grads(p2, b, accum=2)}
        for name, kw in (('drop', dict(drop_path_rate=0.1, **REMAT_KW)), ('nodrop', REMAT_KW)):
            cfg, state = port_state(p2, **kw)
            state, aux = pstep.make_train_step(cfg)(state, b, PROGRESS)
            one[name] = (float(aux['total_seeker']), params_to_jax(state.model.state_dict()))
        cfg, state = port_state(p2, num_queries=1, drop_path_rate=0.5)
        with torch.no_grad():
            batch = pstep.unpack_batch(twin, 'cpu')
            sup = pstep.build_supervision(cfg, batch)
            one['twin'] = pstep._forward_queries(state.model, cfg, batch, sup, True,
                                                 torch.Generator().manual_seed(11))[0].numpy()
        cfg, state = port_state(p2, num_queries=1)
        one['vis'] = pstep.make_vis_step(cfg)(state.model, b1, PROGRESS)
        return want, one, {**finish_jobs(handle), **finish_jobs(grid)}


def test_pp_ranks_match_jax_single_device_and_one_process(tmp_path):
    '''pipeline_runs' ranks against JAX and the one-process port, every check_* below in
    turn. It is one test so that one pytest-xdist worker starts the ranks and no other
    waits for them.'''
    runs = pipeline_runs(tmp_path)
    check_stages(runs)
    for layout in sorted(GRAD_LAYOUTS):
        check_gradients(runs, layout)
    for layout, rows in (('pipe2', 4), ('data2_pipe2', 2), ('model2_pipe2', 4),
                         ('data2_model2_pipe2', 2)):
        check_train_step(runs, layout, rows)
    check_forward(runs)
    check_drop_path(runs)
    check_checkpoint(runs)
    check_vis(runs)


def check_stages(runs):
    '''Each rank sits at its (data, model, pipe) coordinates and holds its stage's
    contiguous blocks; a stage runs two attention forwards a block for each of its
    microbatches (the plain 'res' pairing on the CPU), and every stage reports the global
    batch's losses (broadcast from the last stage).'''
    _, _, res = runs
    for name, (_, pipe, blocks) in GRAD_LAYOUTS.items():
        assert [r['coords'] for r in res[name]] == [(0, 0, s) for s in range(pipe)], name
        assert [r['blocks'] for r in res[name]] == blocks, name
        # Microbatch forwards a step: M, twice under remat 'full' (the recompute), M per
        # accumulation microbatch under grad_accum 2 (4 rows each, so M = 4).
        micro = {'s2_m2': 2, 's2_m4': 4, 's4_m2': 2, 's2_m4_g2': 2 * 4, 's2_accum2': 2 * 4}[name]
        for r in res[name]:
            assert r['calls'] == {'res': 2 * len(r['blocks']) * micro}, (name, r['calls'])
            assert r['losses'] == res[name][-1]['losses']
    assert [r['coords'] for r in res['data2_pipe2']] == [(0, 0, 0), (0, 0, 1), (1, 0, 0),
                                                         (1, 0, 1)]
    assert [r['coords'] for r in res['model2_pipe2']] == [(0, 0, 0), (0, 0, 1), (0, 1, 0),
                                                          (0, 1, 1)]
    assert [r['coords'] for r in res['data2_model2_pipe2']] == [
        (d, m, p) for d in range(2) for m in range(2) for p in range(2)]


def check_gradients(runs, layout):
    '''The pipelined step's f32 gradients of the 4-clip batch (8 rows in M microbatches,
    M = 2 or 4, on 2 or 4 stages, remat_group 2, grad_accum 2), summed over the stages'
    ranks and gathered, equal JAX's single-device gradients and the one-process port's on
    every rank within GRAD_REL_L2 (relative L2 of each leaf), and the losses JAX's within
    LOSS_RTOL.'''
    want, one, res = runs
    key = GRAD_LAYOUTS[layout][0]
    jax_want = want['g4' if key.startswith('g4') else 'g2']
    port_want = one.get(key, one['g2'])
    for r in res[layout]:
        assert r['rows'] == 4
        assert_grads_close(r['grads'], port_want, f'{layout} vs one process')
        if key != 'g2_accum2':
            assert_grads_close(r['grads'], jax_want['grads'], f'{layout} vs JAX')
            for k, v in jax_want['losses'].items():
                np.testing.assert_allclose(r['losses'][k], v, rtol=LOSS_RTOL, err_msg=k)


def check_train_step(runs, layout, rows):
    '''One AdamW step from the initial state on (pipe 2), (data 2, pipe 2), (model 2,
    pipe 2) and (data 2, model 2, pipe 2) (JAX's test_pipeline_with_tp_and_dp: Megatron
    shards of each stage's blocks): the loss within LOSS_RTOL and the updated parameters
    within tests/test_pipeline_parallel.py's rtol 1e-3, atol 1e-5 of JAX's jitted
    single-device step, the same on every rank; the replicated tensors agree over the
    world and each stage's blocks over its ranks.'''
    want, _, res = runs
    assert len({r['digests'][0] for r in res[layout]}) == 1
    for r in res[layout]:
        assert r['rows'] == rows
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], want['step']['loss'],
                                   rtol=LOSS_RTOL)
        assert r['steps'][0]['skipped_nonfinite'] == 0.0
        assert_tree_close(r['params'][0], want['step']['params'], layout, PARAM_RTOL,
                          PARAM_ATOL)


def check_forward(runs):
    '''The pipelined forward (M = 2) on the last stage: the output mask within the forward
    tolerance of JAX's single-device eval step; every stage's eval losses (one
    microbatch, broadcast from the last stage) within LOSS_RTOL of JAX's.'''
    want, _, res = runs
    first, last = res['fwd']
    assert first['mask'] is None
    np.testing.assert_allclose(last['mask'], want['fwd']['mask'], rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    for r in res['fwd']:
        for k, v in want['fwd']['losses'].items():
            np.testing.assert_allclose(r['eval'][k], v, rtol=LOSS_RTOL, err_msg=k)


def check_drop_path(runs):
    '''Drop-path under the pipeline: every rank draws the whole batch's masks and keeps its
    blocks' rows of each microbatch, so at 0.1 under the step of record's remat policy the
    pipe-2 step equals the one-process port step (the masks matter: drop-path 0 lands more
    than 10x the limit away), and two equal clips in two microbatches at 0.5 get different
    masks (JAX's test_gpipe_droppath_runs_and_decorrelates), the forward the one-process
    port's under the same generator.'''
    _, one, res = runs
    for r in res['drop']:
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], one['drop'][0],
                                   rtol=LOSS_RTOL)
        assert_tree_close(r['params'][0], one['drop'][1], 'drop', 0.0, 5e-6)
    moved = max(float(np.abs(a - w).max()) for a, w in zip(jax.tree.leaves(one['nodrop'][1]),
                                                            jax.tree.leaves(one['drop'][1])))
    assert moved > 10 * 5e-6, moved
    mask = res['twin'][-1]['mask']
    assert np.isfinite(mask).all() and float(np.abs(mask[0] - mask[1]).max()) > 0
    np.testing.assert_allclose(mask, one['twin'], rtol=FWD_RTOL, atol=FWD_ATOL)


def check_checkpoint(runs):
    '''The checkpoint written after the pipe-2 step (every rank gathers, rank 0 writes)
    holds the one-process layout and loads into a one-process port state that holds what
    the ranks held, bit for bit (parameters, AdamW moments, step, count, generator); JAX's
    loader reads the same parameters.'''
    _, _, res = runs
    ranks = res['drop']
    assert ranks[0]['path'] is not None and ranks[1]['path'] is None
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ptsf.DEPTH_PRESETS, 2, PRESET)
        _, template = port_state(None)
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
    jparams = jckpt.load_checkpoint(ranks[0]['path'])['params']
    assert jparams['backbone']['blocks']['attn']['qkv']['w'].shape == (2, 32, 96)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(held['params']),
                            jax.tree.leaves(jparams), strict=True):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=jax.tree_util.keystr(path))


def check_vis(runs):
    '''make_vis_step under --pp_stages 2 at one query (JAX's
    test_vis_step_under_pipeline_parallel): the example through the stages as one
    microbatch, the last stage's float16 payload on every stage, equal to the one-process
    vis step's within float16 rounding.'''
    _, one, res = runs
    for r in res['vis']:
        vis = r['vis']
        assert vis['output_mask'].shape == (1, 1, 3, 4, 32, 32)
        np.testing.assert_allclose(vis['total_seeker'], float(one['vis']['total_seeker']),
                                   rtol=LOSS_RTOL)
        for k in ('output_mask', 'target_mask', 'seeker_query_mask', 'seeker_rgb'):
            np.testing.assert_allclose(vis[k], one['vis'][k].float().numpy(), rtol=1e-3,
                                       atol=1e-3, err_msg=k)


# ---------------------------------------------------------------------------------------
# train_torch.py --pp_stages 2
# ---------------------------------------------------------------------------------------

def test_pp_driver_ranks_train_and_write_one_process_checkpoint(kubric_root, tmp_path):
    '''train_torch.py --device cpu --mesh_devices 2 --pp_stages 2: both ranks hold data row
    0 (pipe ranks 0 and 1) and take the epoch's 4 steps and the vis step; rank 0 writes the
    checkpoint in the one-process layout (every block), which loads into a one-process
    port state bit for bit and into JAX's loader.'''
    deadline = time.monotonic() + RUN_TIMEOUT_S
    proc = start(train_argv(kubric_root, tmp_path, 'mppp', '--num_epochs', '1',
                            '--do_val_aug', '0', '--pp_stages', '2'))
    finish(proc, deadline)
    for rank, t in enumerate(rank_logs(tmp_path, 'mppp')):
        recs = [json.loads(m.group(1)) for m in STEP_STATS.finditer(t)]
        assert {(r['rank'], r['world'], r['data_rank'], r['pipe_rank']) for r in recs} == {
            (rank, 2, 0, rank)}
        assert [(r['phase'], r['step']) for r in recs] == [
            ('train', 0), ('vis', 0), *[('train', s) for s in range(1, STEPS_PER_EPOCH)]]
    ckpt = tmp_path / 'checkpoints' / 'mppp' / 'checkpoint.npz'
    file = checkpoint_arrays(ckpt)
    assert file["params['backbone']['blocks']['attn']['qkv']['w']"].shape == (2, 32, 96)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ptsf.DEPTH_PRESETS, 2, (32, 4))
        cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(
            num_total_frames=6, frame_height=32, frame_width=48, network_depth=2),
            loss=plosses.LossConfig(), num_queries=2)
        template = pstep.init_train_state(1, cfg, poptim.make_optimizer('adamw'),
                                          device='cpu')
        state = pckpt.load_checkpoint(str(ckpt), state_template=template)['state']
    held = {'params' + k: v for k, v in pckpt.flatten_with_paths(
        params_to_jax(state.model.state_dict())).items()}
    held.update({'opt_state' + k: v for k, v in pckpt.opt_state_to_jax(
        state.optimizer).items()})
    assert state.step == STEPS_PER_EPOCH
    for k, v in held.items():
        np.testing.assert_array_equal(v, file[k], err_msg=k)
    jparams = jckpt.load_checkpoint(str(ckpt))['params']
    np.testing.assert_array_equal(np.asarray(jparams['backbone']['blocks']['mlp']['fc1']['w']),
                                  file["params['backbone']['blocks']['mlp']['fc1']['w']"])
