'''
The port's last two layouts of the JAX package's mesh on CPU gloo process groups: joint
space-time attention under sequence parallelism (each seq rank runs whole joint blocks on
its chunk of the folded clips, zero-padded as JAX's fused_attention_rows pads its rows) and
pipeline stages beside sequence parallelism (each (data, seq, model) line a GPipe pipe whose
stages make the seq collectives inside their blocks), against the JAX package: its
single-device gradients at joint seq 2, seq 4 (6 folded rows: the last rank holds padding
only) and (seq 2, model 2), at (seq 2, pipe 2) with and without rope, (seq 2, model 2, pipe
2) and joint (seq 2, pipe 2); drop-path 0.1 at (seq 2, pipe 2) against the one-process port
step and its checkpoint read by one process; the loss of one step of JAX's own mesh
programs, joint on make_mesh(seq=2) and divided on make_mesh(seq=2, pipe=2); train_torch.py
under both layouts against one process; and --pp_manual beside them.

The ranks are processes running tests/test_torch_pp_ranks.py (which imports no JAX), forked
from a forkserver, one intra-op thread each, one job a mesh, while the test computes the JAX
oracles (jitted). Geometry of tests/test_torch_sequence_parallel.py: depth 2 at width 64 (4
heads), T = 7 at 32 x 80, a 2 x 5 patch grid (seq 2 splits the frames 4 / 3), f32.
'''

import json
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
from tcow_tpu_torch.data import synthetic as psyn
from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.parallel import pipeline as ppipe
from tcow_tpu_torch.parallel import sequence as pseq
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_to_jax
from test_torch_data_parallel import port_steps
from test_torch_multiprocess_train import (STEP_STATS, checkpoint_arrays, finish, start,
                                           train_argv)
from test_torch_pipeline_parallel import finish_jobs, start_jobs
from test_torch_sequence_parallel import (BATCH_KW, GEOM, REMAT_KW, SP_SEEKER_KW,
                                          STRETCH_OPT_KW, STRETCH_PRESET, STRETCH_SEEKER_KW,
                                          TINY_PRESET, assert_grads_close, jax_grads, noisy,
                                          with_frame_times)
from test_torch_train_step import LOSS_RTOL, OPT_KW, PARAM_ATOL, PROGRESS

JOINT = dict(attention_type='joint_space_time')
ROPE = dict(temporal_rope=True, rope_time_coords=True)
# Seconds a driver run may take (its ranks' start, 2 steps, the vis step, a checkpoint).
DRIVER_TIMEOUT_S = 150
# The checkpoint of a layout's driver run against the one-process run's (the same batches
# and masks; only the order of the sums differs), as the tensor-parallel driver test holds.
DRIVER_ATOL = 5e-6


def mesh_jobs(name, kind, payload, seq=1, model=1, pipe=1, n_data=1, procs=0,
              preset=TINY_PRESET):
    '''{process: job} of one (data, seq, model, pipe) mesh on the processes from `procs`
    on, meeting at a free port.'''
    world, port = n_data * seq * model * pipe, pmesh.free_port()
    return {procs + r: dict(name=name, kind=kind, payload=payload, world=world, rank=r,
                            port=port, seq=seq, model=model, pipe=pipe, preset=preset)
            for r in range(world)}


def payload(params, b, steps=1, out=None, num_queries=2, opt_kw=OPT_KW, progress=PROGRESS,
            seeker_kw=SP_SEEKER_KW, **kw):
    return dict(params=params, batch=b, seeker_kw={**seeker_kw, **kw}, num_queries=num_queries,
                opt_kw=opt_kw, progress=progress, steps=steps, out=out, accum=1, micro=2,
                train=False, seed=0)


def init(seed, **seeker_kw):
    return noisy(jmt.init_params(jax.random.key(seed),
                                 jmt.SeekerConfig(**{**SP_SEEKER_KW, **seeker_kw})), seed)


# (job, payload, seq, model, pipe, oracle, attention calls a rank makes a step: one a joint
# block, two a divided one, on each of the stage's blocks once a microbatch).
GRAD_LAYOUTS = {
    'joint_seq2': ('joint', 2, 1, 1, 'joint', 2),
    'joint_seq4': ('joint', 4, 1, 1, 'joint', 2),
    'joint_seq2_model2': ('joint', 2, 2, 1, 'joint', 2),
    'joint_seq2_pipe2': ('joint_pp', 2, 1, 2, 'joint', 2),
    'seq2_pipe2': ('divided_pp', 2, 1, 2, 'divided', 4),
    'seq2_pipe2_rope': ('rope_pp', 2, 1, 2, 'rope', 4),
    'seq2_model2_pipe2': ('divided_pp', 2, 2, 2, 'divided', 4)}


def layout_runs(tmp):
    '''The ranks' gradients under GRAD_LAYOUTS (joint: 3 clips x 2 queries, 6 rows; divided:
    4 x 2 in 2 microbatches), one step at (seq 2, pipe 2) with drop-path 0.1 under the step
    of record's remat policy and its checkpoint; JAX's single-device gradients and the
    one-process port's steps against them.'''
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jtsf.DEPTH_PRESETS, 2, TINY_PRESET)
        mp.setitem(ptsf.DEPTH_PRESETS, 2, TINY_PRESET)
        divided, joint = init(0), init(1, **JOINT)
        b6 = jsyn.synthetic_device_batch(2, B=3, **BATCH_KW)
        b8 = jsyn.synthetic_device_batch(0, B=4, **BATCH_KW)
        b4 = jsyn.synthetic_device_batch(1, B=2, **BATCH_KW)
        payloads = {'joint': payload(joint, b6, **JOINT),
                    'joint_pp': payload(joint, b6, pp_microbatches=2, **JOINT),
                    'divided_pp': payload(divided, b8, pp_microbatches=2),
                    'rope_pp': payload(divided, with_frame_times(b8), pp_microbatches=2, **ROPE),
                    'drop': payload(divided, b4, out=str(tmp / 'ckpt'), drop_path_rate=0.1,
                                    **REMAT_KW)}
        jobs = {name: mesh_jobs(name, 'grads', p, seq, model, pipe)
                for name, (p, seq, model, pipe, _, _) in GRAD_LAYOUTS.items()}
        handle = start_jobs(tmp, 'layouts', payloads, [
            *(jobs[n] for n in ('joint_seq4', 'joint_seq2_model2', 'joint_seq2_pipe2',
                                'seq2_pipe2', 'seq2_pipe2_rope')),
            mesh_jobs('drop', 'train', 'drop', 2, pipe=2)])
        grid = start_jobs(tmp, 'grid', payloads, [jobs['seq2_model2_pipe2'],
                                                   jobs['joint_seq2']], procs=8)
        want = {'joint': jax_grads(joint, b6, **JOINT), 'divided': jax_grads(divided, b8),
                'rope': jax_grads(divided, with_frame_times(b8), **ROPE)}
        one = {'drop': port_steps(divided, b4, 1,
                                  seeker_kw={**GEOM, 'drop_path_rate': 0.1, **REMAT_KW})[0],
               'nodrop': port_steps(divided, b4, 1, seeker_kw={**GEOM, **REMAT_KW})[0]}
        return want, one, {**finish_jobs(handle), **finish_jobs(grid)}


def test_layouts_match_jax_single_device_and_one_process(tmp_path):
    '''layout_runs' ranks against JAX and the one-process port, every check_* below in
    turn. It is one test so that one pytest-xdist worker starts the ranks and no other
    waits for them.'''
    runs = layout_runs(tmp_path)
    for layout in sorted(GRAD_LAYOUTS):
        check_gradients(runs, layout)
    check_drop_path_and_checkpoint(runs)


def check_gradients(runs, layout):
    '''The step's f32 gradients, summed over the (data x seq) ranks of a stage and gathered
    over the model and pipe ranks, equal JAX's single-device gradients on every rank within
    GRAD_REL_L2 (relative L2 of each leaf), and the losses JAX's within LOSS_RTOL; every
    rank sits at its mesh coordinates and makes its calls: a joint block's one on its chunk
    of the clips (seq 4: the last rank's chunk is zero padding), a divided block's two, once
    a microbatch on a stage's block.'''
    want, _, res = runs
    _, seq, model, pipe, oracle, calls = GRAD_LAYOUTS[layout]
    ranks = res[layout]
    assert [(r['seq'], *r['coords']) for r in ranks] == [
        (s, 0, m, p) for s in range(seq) for m in range(model) for p in range(pipe)]
    for r in ranks:
        assert r['calls'] == {'res': calls}, (layout, r['calls'])
        for k, v in want[oracle]['losses'].items():
            np.testing.assert_allclose(r['losses'][k], v, rtol=LOSS_RTOL, err_msg=k)
        assert_grads_close(r['grads'], want[oracle]['grads'], layout)


def check_drop_path_and_checkpoint(runs):
    '''At drop-path 0.1 under the step of record's remat policy the (seq 2, pipe 2) step
    equals the one-process port step on every rank (each rank keeps its stage's blocks,
    its microbatches' rows and its patches' and frames' columns of the whole batch's masks;
    drop-path 0 lands more than 10x the limit away); the checkpoint written after it (every
    rank gathers, rank 0 writes) loads into a one-process state that holds what the ranks
    held, bit for bit.'''
    _, one, res = runs
    ranks = res['drop']
    assert [(r['seq'], r['coords'][2]) for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert len({r['digests'][0] for r in ranks}) == 1     # the replicated tensors
    assert [r['digest'] for r in ranks[:2]] == [r['digest'] for r in ranks[2:]]  # by stage
    for r in ranks:
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], one['drop'][0],
                                   rtol=LOSS_RTOL)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(one['drop'][1]),
                                jax.tree.leaves(r['params'][0]), strict=True):
            np.testing.assert_allclose(g, w, rtol=0, atol=PARAM_ATOL,
                                       err_msg=jax.tree_util.keystr(path))
    moved = max(float(np.abs(a - w).max()) for a, w in zip(jax.tree.leaves(one['nodrop'][1]),
                                                            jax.tree.leaves(one['drop'][1])))
    assert moved > 10 * PARAM_ATOL, moved
    assert ranks[0]['path'] is not None and all(r['path'] is None for r in ranks[1:])
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


def test_joint_row_split_pads_and_masks_follow():
    '''split_rows gives seq rank r the rows [r k, (r + 1) k) of the rows zero-padded to
    n_seq x k, k = ceil(rows / n_seq) (6 rows over 4 ranks: 2, 2, 2 and 2 of padding), and
    a joint block's drop-path masks of those rows are the whole batch's, padded.'''
    x = torch.arange(6.0)[:, None].expand(6, 3)
    masks = ptsf.draw_drop_path_masks(torch.Generator().manual_seed(3), 0.5, 2, 6, 10, 7,
                                      'cpu', divided=False)
    for r in range(4):
        fake = pmesh.DataMesh(4, r, r, torch.device('cpu'), 'gloo', '', n_seq=4)
        lo, hi = pseq.row_range(6, fake)
        assert (lo, hi) == (2 * r, 2 * r + 2)
        part = pseq.split_rows(x, fake)
        want = torch.cat([x, torch.zeros(2, 3)])[lo:hi]
        torch.testing.assert_close(part, want, rtol=0, atol=0)
        for m in masks:
            got = m.rows(lo, hi)
            whole = torch.cat([m.spatial, torch.ones(2, dtype=torch.bool)])
            torch.testing.assert_close(got.spatial, whole[lo:hi], rtol=0, atol=0)
            assert got.temporal is None and got.mlp.shape == (2,)


# ---------------------------------------------------------------------------------------
# One step of JAX's own mesh programs
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('mesh_kw,seeker_kw', [
    (dict(seq=2), JOINT), (dict(seq=2, pipe=2), {})])
def test_layout_step_loss_matches_jax_mesh(tmp_path, mesh_kw, seeker_kw):
    '''One AdamW step of 8 ranks laid out as JAX's make_mesh(**mesh_kw) of 8 virtual
    devices (joint: data 4 x seq 2, one clip a data row, so each seq rank holds one real
    row or padding; divided: data 2 x seq 2 x pipe 2) at test_stretch_config's preset has
    the loss and gradient norm of JAX's jitted step on its own mesh, from the same state.'''
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jtsf.DEPTH_PRESETS, 2, STRETCH_PRESET)
        n_data = 8 // (mesh_kw['seq'] * mesh_kw.get('pipe', 1))
        skw = {**STRETCH_SEEKER_KW, **seeker_kw}
        mesh = jmesh.make_mesh(**mesh_kw)
        pipe = mesh_kw.get('pipe', 1)
        seeker = jmt.SeekerConfig(**skw, batch_axis=jmesh.DATA_AXIS, seq_axis=jmesh.SEQ_AXIS,
                                  pipe_axis=jmesh.PIPE_AXIS if pipe > 1 else None,
                                  pp_stages=pipe)
        cfg = jstep.StepConfig(seeker=seeker, loss=JLossConfig(), num_queries=1)
        tx = joptim.make_optimizer('adamw', **STRETCH_OPT_KW)
        state = jstep.init_train_state(jax.random.key(0), cfg, tx)
        params = jax.tree.map(np.array, state.params)     # copies: JAX may reuse them
        b = jsyn.synthetic_device_batch(0, B=n_data, Q=1, T=8, H=32, W=64, M=6, K=3)
        job = payload(params, b, num_queries=1, opt_kw=STRETCH_OPT_KW, progress=0.0,
                      seeker_kw=skw)
        handle = start_jobs(tmp_path, 'mesh', {'mesh': job}, [mesh_jobs(
            'mesh', 'train', 'mesh', mesh_kw['seq'], pipe=pipe, n_data=n_data,
            preset=STRETCH_PRESET)], procs=8)
        with jax.set_mesh(mesh):
            _, aux = jax.jit(jstep.make_train_step(cfg, tx))(
                jmesh.replicate_tree(state, mesh), jmesh.shard_batch(b, mesh),
                jnp.float32(0.0))
        want = {k: float(aux[k]) for k in ('total_seeker', 'grad_norm')}
    res = finish_jobs(handle)['mesh']
    assert len({r['digests'][0] for r in res}) == 1       # the replicated tensors
    for r in res:
        assert r['rows'] == 1
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], want['total_seeker'],
                                   rtol=1e-5)
        np.testing.assert_allclose(r['steps'][0]['grad_norm'], want['grad_norm'], rtol=5e-5)


# ---------------------------------------------------------------------------------------
# train_torch.py under both layouts
# ---------------------------------------------------------------------------------------

DRIVER_STEPS = 2


@pytest.fixture(scope='module')
def kubric_4(tmp_path_factory):
    '''A Kubric-format set of 4 train scenes: one epoch of 2 global batches of 2.'''
    root = tmp_path_factory.mktemp('kub_sp_pp')
    psyn.write_synthetic_kubric_dataset(str(root / 'train'), num_scenes=2 * DRIVER_STEPS,
                                        seed=17, T=8, H=48, W=64, K=4)
    return str(root)


@pytest.mark.parametrize('flags,coords', [
    (['--mesh_devices', '4', '--seq_shards', '2', '--pp_stages', '2', '--pp_manual', '1'],
     [(0, 0), (0, 1), (1, 0), (1, 1)]),
    (['--mesh_devices', '2', '--seq_shards', '2', '--attention_type', 'joint_space_time'],
     [(0, 0), (1, 0)])])
def test_driver_layout_trains_and_writes_one_process_checkpoint(kubric_4, tmp_path, flags,
                                                                 coords):
    '''train_torch.py --device cpu with (seq 2, pipe 2) (and --pp_manual 1, which parses as
    JAX's CLI parses it) and with joint attention at seq 2: every rank holds data row 0 at
    its (seq, pipe) coordinates and takes the epoch's 2 steps and the vis step; rank 0
    writes the checkpoint in the one-process layout, within DRIVER_ATOL of a one-process run
    of the same flags (the same batches and drop-path masks), and it loads into a
    one-process port state.'''
    deadline = time.monotonic() + DRIVER_TIMEOUT_S
    joint = [f for f in flags if f == 'joint_space_time']
    extra = ('--num_epochs', '1', '--do_val_aug', '0')
    one = start(train_argv(kubric_4, tmp_path, 'one', *extra, '--mesh_devices', '1',
                           *(['--attention_type', 'joint_space_time'] if joint else [])))
    proc = start(train_argv(kubric_4, tmp_path, 'lay', *extra, *flags))
    finish(proc, deadline)
    finish(one, deadline)
    logs = tmp_path / 'logs' / 'lay'
    for rank, (seq, pipe) in enumerate(coords):
        text = (logs / ('train.log' if rank == 0 else f'rank{rank}/train.log')).read_text()
        recs = [json.loads(m.group(1)) for m in STEP_STATS.finditer(text)]
        assert {(r['rank'], r['world'], r['data_rank'], r['seq_rank'], r['pipe_rank'])
                for r in recs} == {(rank, len(coords), 0, seq, pipe)}
        assert [(r['phase'], r['step']) for r in recs] == [
            ('train', 0), ('vis', 0), *[('train', s) for s in range(1, DRIVER_STEPS)]]
    got = checkpoint_arrays(tmp_path / 'checkpoints' / 'lay' / 'checkpoint.npz')
    want = checkpoint_arrays(tmp_path / 'checkpoints' / 'one' / 'checkpoint.npz')
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k], w, rtol=0, atol=DRIVER_ATOL, err_msg=k)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ptsf.DEPTH_PRESETS, 2, (32, 4))
        cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(
            num_total_frames=6, frame_height=32, frame_width=48, network_depth=2,
            **(JOINT if joint else {})), loss=plosses.LossConfig(), num_queries=2)
        template = pstep.init_train_state(1, cfg, poptim.make_optimizer('adamw'),
                                          device='cpu')
        state = pckpt.load_checkpoint(str(tmp_path / 'checkpoints' / 'lay' / 'checkpoint.npz'),
                                      state_template=template)['state']
    assert state.step == DRIVER_STEPS
    held = params_to_jax(state.model.state_dict())
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(held), jax.tree.leaves(
            pckpt.load_checkpoint(str(tmp_path / 'checkpoints' / 'lay' / 'checkpoint.npz'))
            ['params']), strict=True):
        np.testing.assert_array_equal(np.asarray(g), w, err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------------------
# --pp_manual
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('kw,n_data,want,warns', [
    (dict(pp_manual=1), 1, True, False),
    (dict(pp_manual=1, tp_shards=2), 1, False, False),
    (dict(pp_manual=1, seq_shards=2), 1, False, False),
    (dict(pp_manual=1, batch_size=2, num_queries=1), 2, False, True),
    (dict(pp_manual=0), 1, False, False)])
def test_pp_manual_takes_jax_manual_pipe_rule_and_raises_nothing(kw, n_data, want, warns):
    '''check_pp_manual answers whether JAX's driver would take its manual pipe
    (tcow_tpu/train/driver.py:60-78): on (pipe x data) meshes only, silently off beside
    --tp_shards or --seq_shards > 1, and with JAX's warning when a microbatch's rows do not
    divide over the data rows (2 rows in 2 microbatches over 2 data rows); it raises
    nothing, the port's one schedule running either way.'''
    args = type('Args', (), {**dict(pp_stages=2, tp_shards=1, seq_shards=1, batch_size=4,
                                    num_queries=2, grad_accum=1, pp_microbatches=0), **kw})()
    said = []
    logger = type('Log', (), {'warning': lambda self, msg: said.append(msg)})()
    assert ppipe.check_pp_manual(args, n_data, logger) is want
    assert bool(said) == warns, said
