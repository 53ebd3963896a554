'''
The port's tensor parallelism (tcow_tpu_torch/parallel/mesh.py's model axis,
parallel/tensor.py, the tensor-parallel train step, optimizer and checkpoints) on CPU gloo
process groups, against the JAX package's (data, model) mesh on the CPU's virtual devices:
the shards of every leaf and the rank layout, the row-parallel attention and the Megatron
MLP, 3 AdamW steps at (data 1, model 2) and (data 2, model 2), LAMB, drop-path and a
checkpoint round trip.

The ranks are processes running tests/test_torch_tp_ranks.py (which imports no JAX), forked
from a forkserver, one intra-op thread each, meeting at a free port; each launch has its
own timeout. Tiny geometry: depth 2 at width 64, T = 4 at 32 x 48, f32.
'''

import dataclasses
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
from tcow_tpu.models import timesformer as jtsf
from tcow_tpu.parallel import mesh as jmesh
from tcow_tpu.train import checkpoint as jckpt
from tcow_tpu.train import optim as joptim
from tcow_tpu.train import step as jstep
from tcow_tpu_torch import config as pconfig
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax
import test_torch_tp_ranks as tp_ranks
from test_torch_data_parallel import BATCH_KW, port_steps
from test_torch_train_step import (GRAD_ATOL_REL, GRAD_RTOL, LOSS_RTOL, NORM_RTOL, OPT_KW,
                                   PARAM_ATOL, PROGRESS, SEEKER_KW, assert_tree_close,
                                   configs, jax_params, tiny_preset)  # noqa: F401

# Seconds one launch of ranks may take (their imports, the rendezvous, the steps).
RANKS_TIMEOUT_S = 120
# Row-parallel attention cases: R = 7 rows (not a multiple of 2) of S = 5 at width 64.
ATTN_R, ATTN_S, ATTN_D, ATTN_HEADS = 7, 5, 64, 4


# ---------------------------------------------------------------------------------------
# The ranks
# ---------------------------------------------------------------------------------------

def start_ranks(tmp_path, kind, world, n_model, payload):
    '''Starts test_torch_tp_ranks.rank_main(kind) in `world` processes, n_model to a data
    row, on `payload`; finish_ranks waits for them, so the caller can compute its oracle
    meanwhile.'''
    inp = tmp_path / f'{kind}_in.pkl'
    inp.write_bytes(pickle.dumps({**payload, 'n_model': n_model}))
    port = pmesh.free_port()
    ctx = multiprocessing.get_context('forkserver')
    ctx.set_forkserver_preload(['test_torch_dp_ranks', 'test_torch_tp_ranks'])
    outs = [tmp_path / f'{kind}_out{r}.pkl' for r in range(world)]
    procs = [ctx.Process(target=tp_ranks.rank_main,
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


def fake_mesh(world, rank, n_model):
    '''A DataMesh without process groups: enough for the layout functions.'''
    return pmesh.DataMesh(world, rank, rank, torch.device('cpu'), 'gloo', '',
                          n_model=n_model)


def jax_mesh(n_data, n_model):
    return jmesh.make_mesh(num_devices=n_data * n_model, model=n_model)


def jax_shard(arr, mesh, coords):
    '''The data of the shard of a placed array on the device at mesh coordinates
    (data, model).'''
    dev = mesh.devices[coords[0], 0, coords[1], 0]
    return np.asarray(next(s.data for s in arr.addressable_shards if s.device == dev))


# ---------------------------------------------------------------------------------------
# Layout: the shards of every leaf, the ranks and their rows
# ---------------------------------------------------------------------------------------

def test_shard_params_are_block_pspec_shards(jax_params):
    '''Each model coordinate's shard_params of the one-process state_dict is, leaf by
    leaf, exactly the shard JAX's block_pspec placement holds on that coordinate's device
    (the sharded leaves half their width, every other leaf whole), and the optax moments'
    key paths shard on the dims JAX's shard_state gives them (tp_dim).'''
    mesh = jax_mesh(1, 2)
    placed = jmesh.shard_state({'params': jax_params}, mesh, tensor_parallel=True)['params']
    full = params_from_jax(jax_params)
    sharded = 0
    for m in range(2):
        got = params_to_jax(pmesh.shard_params(full, fake_mesh(2, m, 2)))
        for (path, want), g in zip(jax.tree_util.tree_leaves_with_path(placed),
                                   jax.tree.leaves(got), strict=True):
            shard = jax_shard(want, mesh, (0, m))
            np.testing.assert_array_equal(g, shard, err_msg=jax.tree_util.keystr(path))
            sharded += shard.shape != want.shape
    assert sharded == 2 * 7   # qkv.w and proj.w of both attentions, fc1.w, fc1.b, fc2.w
    jcfg, _ = configs()
    tx = joptim.make_optimizer('adamw', **OPT_KW)
    jstate = jmesh.shard_state(jstep.init_train_state(jax.random.key(0), jcfg, tx,
                                                      params=jax_params),
                               mesh, tensor_parallel=True)
    flat = jckpt._flatten_with_paths(jstate.opt_state)
    leaves = jax.tree.leaves(jstate.opt_state)
    assert len(flat) == len(leaves)
    for key, leaf in zip(flat, leaves, strict=True):
        spec = tuple(leaf.sharding.spec) + (None,) * (np.ndim(leaf) - len(leaf.sharding.spec))
        want = next((d for d, a in enumerate(spec) if a == jmesh.MODEL_AXIS), None)
        assert pmesh.tp_dim(key) == want, key
    assert pmesh.shard_params(full, None) is full
    assert pmesh.shard_params(full, fake_mesh(2, 0, 1)) is full


@pytest.mark.parametrize('n_data,grad_accum', [(1, 1), (2, 1), (2, 2)])
def test_rank_layout_and_rows_match_jax_mesh(n_data, grad_accum):
    '''The rank at each (data, model) coordinate is JAX's device there, and each rank's
    rows (shard_batch; under grad_accum = 2 its rows of each microbatch) are the data
    shard JAX gives that device: the model ranks of a data row hold the same rows.'''
    n_model = 2
    mesh = jax_mesh(n_data, n_model)
    layout = pmesh.rank_layout(n_data * n_model, model=n_model)
    np.testing.assert_array_equal(layout, np.vectorize(lambda d: d.id)(mesh.devices))
    b = jsyn.synthetic_device_batch(0, B=4, **BATCH_KW)
    placed = jmesh.shard_batch(b, mesh)
    for rank in range(n_data * n_model):
        fake = fake_mesh(n_data * n_model, rank, n_model)
        coords = tuple(int(c) for c in np.argwhere(layout[:, 0, :, 0] == rank)[0])
        assert (fake.data_rank, fake.model_rank) == coords
        got = pmesh.shard_batch(b, fake, grad_accum)
        for k, v in placed.items():
            if np.ndim(v) == 0:
                continue
            want = jax_shard(v, mesh, coords)
            if grad_accum > 1:
                # JAX's microbatch i is global rows [i B/A, (i+1) B/A), sharded on data.
                micro = np.split(np.asarray(b[k]), grad_accum)
                want = np.concatenate([np.split(mb, n_data)[fake.data_rank] for mb in micro])
            np.testing.assert_array_equal(got[k], want, err_msg=f'{k} rank {rank}')


# ---------------------------------------------------------------------------------------
# Row-parallel attention and the Megatron MLP
# ---------------------------------------------------------------------------------------

def attention_cases():
    rng = np.random.RandomState(11)
    R, S, D = ATTN_R, ATTN_S, ATTN_D
    cases = []
    for bwd_mode in ('res', 'kernel_qkv', 'kernel_x', 'kernel_x_wg'):
        for rope in (False, True):
            cases.append(dict(
                x=rng.randn(R, S, D).astype(np.float32),
                qkv_w=(0.1 * rng.randn(D, 3 * D)).astype(np.float32),
                qkv_b=(0.1 * rng.randn(3 * D)).astype(np.float32),
                proj_w=(0.1 * rng.randn(D, D)).astype(np.float32),
                proj_b=(0.1 * rng.randn(D)).astype(np.float32),
                g=rng.randn(R, S, D).astype(np.float32),
                pos=(np.cumsum(rng.rand(R, S), axis=1) * 3).astype(np.float32) if rope
                else None,
                heads=ATTN_HEADS, causal=1, bwd_mode=bwd_mode, rope=rope))
    return cases


def mlp_case():
    rng = np.random.RandomState(12)
    D, H = ATTN_D, 4 * ATTN_D
    return dict(x=rng.randn(6, 3, D).astype(np.float32),
                fc1_w=(0.1 * rng.randn(D, H)).astype(np.float32),
                fc1_b=(0.1 * rng.randn(H)).astype(np.float32),
                fc2_w=(0.1 * rng.randn(H, D)).astype(np.float32),
                fc2_b=(0.1 * rng.randn(D)).astype(np.float32),
                g=rng.randn(6, 3, D).astype(np.float32))


@pytest.fixture(scope='module')
def block_ranks(tmp_path_factory):
    payload = {'attention': attention_cases(), 'mlp': mlp_case()}
    return payload, finish_ranks(start_ranks(tmp_path_factory.mktemp('tp_blocks'), 'blocks',
                                             2, 2, payload))


def assert_close(got, want, what):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                               atol=GRAD_ATOL_REL * float(np.abs(want).max()), err_msg=what)


def test_row_parallel_attention_matches_jax(block_ranks):
    '''attention_rows at 2 model ranks on 7 rows (padded to 8), in every backward mode,
    with and without rope positions: the output, dx, the qkv.w / proj.w gradients (each
    rank's shard of JAX's) and the bias gradients (whole on each rank) against JAX's
    attention; the forward ran once on each rank.'''
    payload, res = block_ranks
    for i, case in enumerate(payload['attention']):
        p = {'qkv': {'w': case['qkv_w'], 'b': case['qkv_b']},
             'proj': {'w': case['proj_w'], 'b': case['proj_b']}}
        pos = None if case['pos'] is None else jnp.asarray(case['pos'])
        fn = lambda p, x: jtsf.attention(p, x, case['heads'], case['causal'],
                                         rope=case['rope'], pos=pos)
        out, vjp = jax.vjp(fn, p, jnp.asarray(case['x']))
        dp, dx = vjp(jnp.asarray(case['g']))
        what = f'case {i} {case["bwd_mode"]} rope {case["rope"]}'
        for r, got in enumerate(res):
            got = got['attention'][i]
            assert got['calls'][case['bwd_mode']] == 1, (what, got['calls'])
            assert_close(got['out'], out, f'{what} out rank {r}')
            assert_close(got['dx'], dx, f'{what} dx rank {r}')
            for k in ('qkv', 'proj'):
                assert_close(got['grads'][f'{k}_b'], dp[k]['b'], f'{what} {k}.b rank {r}')
                assert_close(got['grads'][f'{k}_w'], np.split(np.asarray(dp[k]['w']), 2)[r],
                             f'{what} {k}.w rank {r}')


def test_megatron_mlp_matches_jax(block_ranks):
    '''The Megatron MLP at 2 model ranks: output and dx on each rank, fc1's column shards,
    fc2.w's row shards and fc2.b (whole) against JAX's mlp.'''
    payload, res = block_ranks
    m = payload['mlp']
    p = {'fc1': {'w': m['fc1_w'], 'b': m['fc1_b']}, 'fc2': {'w': m['fc2_w'], 'b': m['fc2_b']}}
    out, vjp = jax.vjp(jtsf.mlp, p, jnp.asarray(m['x']))
    dp, dx = vjp(jnp.asarray(m['g']))
    for r, got in enumerate(res):
        got = got['mlp']
        assert_close(got['out'], out, f'out rank {r}')
        assert_close(got['dx'], dx, f'dx rank {r}')
        want = {'fc1.w': np.split(np.asarray(dp['fc1']['w']), 2, axis=1)[r],
                'fc1.b': np.split(np.asarray(dp['fc1']['b']), 2)[r],
                'fc2.w': np.split(np.asarray(dp['fc2']['w']), 2)[r], 'fc2.b': dp['fc2']['b']}
        assert set(got['grads']) == set(want)
        for k, w in want.items():
            assert_close(got['grads'][k], w, f'{k} rank {r}')


# ---------------------------------------------------------------------------------------
# The tensor-parallel train step
# ---------------------------------------------------------------------------------------

def jax_tp_steps(jax_params, b, optimizer, n_data, n_model, steps=3):
    '''JAX's jitted step on a (data, model) mesh with model_axis set, after
    shard_state(tensor_parallel=True): per step the losses and grad_norm, and the
    parameters after each step.'''
    mesh = jax_mesh(n_data, n_model)
    jcfg, _ = configs()
    jcfg = dataclasses.replace(jcfg, seeker=dataclasses.replace(
        jcfg.seeker, batch_axis=jmesh.DATA_AXIS, model_axis=jmesh.MODEL_AXIS))
    tx = joptim.make_optimizer(optimizer, **OPT_KW)
    step = jax.jit(jstep.make_train_step(jcfg, tx))
    out, params = [], []
    with jax.set_mesh(mesh):
        state = jmesh.shard_state(jstep.init_train_state(jax.random.key(0), jcfg, tx,
                                                         params=jax_params),
                                  mesh, tensor_parallel=True)
        jb = jmesh.shard_batch(b, mesh)
        for _ in range(steps):
            state, aux = step(state, jb, jnp.float32(PROGRESS))
            out.append({k: float(v) for k, v in aux.items() if k != 'metric_sums'})
            params.append(jmesh.fetch_global(state.params))
    return out, params


def train_payload(jax_params, b, optimizer='adamw', steps=3, **seeker_kw):
    return dict(params=jax_params, batch=b, grad_accum=1, steps=steps, optimizer=optimizer,
                seeker_kw={**SEEKER_KW, **seeker_kw}, opt_kw=OPT_KW, progress=PROGRESS)


def check_steps(res, jsteps, jparams, n_model):
    for r in res:
        for i, (got, want) in enumerate(zip(r['steps'], jsteps, strict=True)):
            for k, v in got.items():
                np.testing.assert_allclose(v, want[k], err_msg=f'step {i} {k}',
                                           rtol=NORM_RTOL if k == 'grad_norm' else LOSS_RTOL)
        for i in (0, 2):
            assert_tree_close(r['params'][i], jparams[i], rtol=0.0, atol=PARAM_ATOL)
        blocks = {n: s for n, s in r['shapes'].items() if '.blocks.0.attn.qkv.w' in n
                  or '.blocks.0.mlp.fc1.' in n}
        assert blocks == {'backbone.blocks.0.attn.qkv.w': (64 // n_model, 192),
                          'backbone.blocks.0.mlp.fc1.w': (64, 256 // n_model),
                          'backbone.blocks.0.mlp.fc1.b': (256 // n_model,)}, blocks


@pytest.mark.parametrize('optimizer,n_data', [('adamw', 1), ('adamw', 2), ('lamb', 1)])
def test_tp_train_steps_match_jax_mesh(jax_params, tmp_path, optimizer, n_data):
    '''3 steps (AdamW, or LAMB with its per-leaf trust ratio over the logical leaf) of the
    (n_data, 2) mesh's step (B = 4 clips, Q = 2) against JAX's jitted step on its (data,
    model) mesh: losses and grad_norm each step, the gathered parameters after steps 1 and
    3 on every rank; the shards are half width, the state's replicas and shards agree
    (check_replicas), and gather_state_dict undoes shard_params of the initial tree.'''
    b = jsyn.synthetic_device_batch(0, B=4, **BATCH_KW)
    world = 2 * n_data
    init = jax.tree.map(np.copy, jax_params)   # JAX's step may reuse the arrays' memory
    ranks = start_ranks(tmp_path, 'train', world, 2, train_payload(jax_params, b, optimizer))
    jsteps, jparams = jax_tp_steps(jax_params, b, optimizer, n_data, 2)
    res = finish_ranks(ranks)
    assert [r['coords'] for r in res] == [(d, m) for d in range(n_data) for m in range(2)]
    assert {r['rows'] for r in res} == {4 // n_data}
    check_steps(res, jsteps, jparams, 2)
    for r in res:
        for g, w in zip(jax.tree.leaves(r['roundtrip']), jax.tree.leaves(init), strict=True):
            np.testing.assert_array_equal(g, w)


# The step of record's pairing, as the driver picks it on the card: per-block remat keeping
# the attention output, so the model-axis collectives run inside each block's checkpoint
# region and again in its recompute, while the attention forward is not re-run.
REMAT_KW = dict(remat=True, remat_policy='dots_nb_out', attention_bwd='kernel_x')


def test_tp_drop_path_masks_follow_the_data_row(jax_params, tmp_path, tiny_preset):
    '''At drop-path 0.1, under the step of record's remat policy, the (1, 2) step equals
    the one-process port step: both model ranks draw the data row's masks; each rank
    computes one attention forward a call (2 a block). The masks matter: the step at
    drop-path 0 lands more than 10x the limit away.'''
    b = jsyn.synthetic_device_batch(0, B=4, **BATCH_KW)
    ranks = start_ranks(tmp_path, 'train', 2, 2,
                        train_payload(jax_params, b, steps=1, drop_path_rate=0.1, **REMAT_KW))
    one = {rate: port_steps(jax_params, b, 1, seeker_kw=dict(drop_path_rate=rate, **REMAT_KW))[0]
           for rate in (0.1, 0.0)}
    res = finish_ranks(ranks)
    for r in res:
        assert r['calls'] == [{'kernel_x': 2 * SEEKER_KW['network_depth']}], r['calls']
        np.testing.assert_allclose(r['steps'][0]['total_seeker'], one[0.1][0], rtol=LOSS_RTOL)
        assert_tree_close(r['params'][0], one[0.1][1], rtol=0.0, atol=PARAM_ATOL)
    moved = max(float(np.abs(a - w).max()) for a, w in zip(jax.tree.leaves(one[0.0][1]),
                                                            jax.tree.leaves(one[0.1][1])))
    assert moved > 10 * PARAM_ATOL, moved


# ---------------------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------------------

def test_tp_checkpoint_round_trip(jax_params, tmp_path, tiny_preset):
    '''A checkpoint written at (1, 2) (every rank gathers, rank 0 writes) holds the
    one-process layout: its arrays are the gathered state bit for bit, it loads into a
    one-process state, and its parameters are within PARAM_ATOL of the one-process step's.
    A one-process checkpoint resumed at (1, 2): each rank holds exactly its shards, and
    gathered back they are the file's parameters and AdamW moments, with its step, count
    and generator.'''
    b = jsyn.synthetic_device_batch(0, B=4, **BATCH_KW)
    _, cfg = configs()
    one = pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **OPT_KW),
                                 params=jax_params, device='cpu')
    one, _ = pstep.make_train_step(cfg)(one, b, PROGRESS)
    one_path = pckpt.save_train_state(str(tmp_path / 'one'), 0, 'one', one)
    res = finish_ranks(start_ranks(tmp_path, 'checkpoint', 2, 2, dict(
        train_payload(jax_params, b), out=str(tmp_path / 'tp'), one=one_path)))
    assert res[0]['path'] == str(tmp_path / 'tp' / 'checkpoint.npz') and res[1]['path'] is None
    with np.load(res[0]['path']) as z:
        wrote = {k: z[k] for k in z.files}
    for r in res:
        got = {'params' + k: v for k, v in pckpt.flatten_with_paths(r['wrote']['params']).items()}
        got.update({'opt_state' + k: v for k, v in r['wrote']['opt_state'].items()})
        for k, v in got.items():
            np.testing.assert_array_equal(wrote[k], v, err_msg=k)
        assert r['shards_equal']
    template = pstep.init_train_state(1, cfg, poptim.make_optimizer('adamw', **OPT_KW),
                                      device='cpu')
    loaded = pckpt.load_checkpoint(res[0]['path'], state_template=template)['state']
    assert_tree_close(params_to_jax(loaded.model.state_dict()),
                      params_to_jax(one.model.state_dict()), rtol=0.0, atol=PARAM_ATOL)
    with np.load(one_path) as z:
        file = {k: z[k] for k in z.files if k != '__meta__'}
    for r in res:
        resumed = r['resumed']
        got = {'params' + k: v for k, v in pckpt.flatten_with_paths(resumed['params']).items()}
        got.update({'opt_state' + k: v for k, v in resumed['opt_state'].items()})
        got.update(step=np.asarray(resumed['step'], np.int32),
                   **{pckpt.GENERATOR_KEY: resumed['generator']})
        assert set(got) == set(file)
        for k, v in file.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert resumed['count'] == 1


# ---------------------------------------------------------------------------------------
# Flags
# ---------------------------------------------------------------------------------------

@pytest.mark.parametrize('flags,error', [
    (['--mesh_devices', '2', '--tp_shards', '2'], None),
    (['--mesh_devices', '4', '--tp_shards', '2', '--grad_accum', '2'], None),
    (['--mesh_devices', '2', '--tp_shards', '5'], 'does not divide embed_dim 768'),
    (['--mesh_devices', '2', '--tp_shards', '4'], 'does not divide the world of 2 ranks'),
    (['--tp_shards', '2'], 'does not divide the world of 1 ranks')])
def test_tp_shards_parse_for_training_when_they_divide(flags, error):
    '''--tp_shards parses for training when it divides the width (768 and 3072 at depth
    12) and the world (--mesh_devices, or the one CPU process); else ValueError.'''
    argv = ['--data_path', 'x', '--device', 'cpu', *flags]
    if error is None:
        assert pconfig.train_args(argv).tp_shards == int(flags[flags.index('--tp_shards') + 1])
    else:
        with pytest.raises(ValueError, match=error):
            pconfig.train_args(argv)


def test_tp_shards_still_raise_for_evaluation():
    with pytest.raises(NotImplementedError, match='item 7'):
        pconfig.test_args(['--data_path', 'x', '--device', 'cpu', '--tp_shards', '2'])
