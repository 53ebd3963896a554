'''
The ranks of tests/test_torch_tensor_parallel.py: each runs as its own process
(`rank_main(kind, rank, world, port, payload, out)`), joins a CPU gloo group as a (data,
model) mesh of payload['n_model'] model ranks a data row and runs one of RANK_KINDS on a
pickled payload, writing its result as a pickle. It imports torch and the port only, so
the forkserver that preloads it holds no JAX. It holds no tests of its own.
'''

import pickle
import traceback

import torch

from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.parallel import tensor as ptensor
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

LOSS_KEYS = ('track', 'occl_mask', 'cont_mask', 'total_seeker')


def rank_main(kind, rank, world, port, inp, out):
    '''One rank: joins the gloo group on the CPU with payload['n_model'] model ranks a
    data row, runs RANK_KINDS[kind] on the payload and writes its result, or {'error':
    traceback} when it raised.'''
    torch.set_num_threads(1)
    ptsf.DEPTH_PRESETS[2] = (64, 4)
    try:
        with open(inp, 'rb') as f:
            payload = pickle.load(f)
        mesh = pmesh.make_mesh('cpu', int(rank), int(world), 0, '127.0.0.1', int(port),
                               model=payload['n_model'])
        try:
            assert mesh.backend == 'gloo', mesh
            result = RANK_KINDS[kind](mesh, payload)
            result['coords'] = (mesh.data_rank, mesh.model_rank)
        finally:
            mesh.close()
    except Exception:  # noqa: BLE001 — reported by the test that started the rank
        result = {'error': traceback.format_exc()}
    with open(out, 'wb') as f:
        pickle.dump(result, f)


def _shard(t, mesh, dim):
    k = t.shape[dim] // mesh.n_model
    return t.narrow(dim, mesh.model_rank * k, k).contiguous()


def rank_blocks(mesh, p):
    '''Row-parallel attention for each case of p['attention'] and the Megatron MLP on
    p['mlp']: the output, and the gradients of sum(out * g) with respect to the input and
    to this rank's shards and biases; the replicated gradients must be the same on every
    rank (checked by the test).'''
    out = {'attention': [], 'mlp': None}
    for case in p['attention']:
        x = torch.tensor(case['x'], requires_grad=True)
        w = {k: torch.tensor(case[k], requires_grad=True) for k in ('qkv_b', 'proj_b')}
        w['qkv_w'] = _shard(torch.tensor(case['qkv_w']), mesh, 0).requires_grad_()
        w['proj_w'] = _shard(torch.tensor(case['proj_w']), mesh, 0).requires_grad_()
        pos = None if case['pos'] is None else torch.tensor(case['pos'])
        counts = dict(ptsf.fused_attention.calls)
        y = ptensor.attention_rows(x, w['qkv_w'], w['qkv_b'], w['proj_w'], w['proj_b'],
                                   case['heads'], case['causal'], case['bwd_mode'],
                                   case['rope'], pos, mesh)
        (y * torch.tensor(case['g'])).sum().backward()
        out['attention'].append(dict(
            out=y.detach().numpy(), dx=x.grad.numpy(),
            grads={k: v.grad.numpy() for k, v in w.items()},
            calls={k: n - counts[k] for k, n in ptsf.fused_attention.calls.items()}))
    m = p['mlp']
    x = torch.tensor(m['x'], requires_grad=True)
    mlp = ptsf.Mlp(m['fc1_w'].shape[0], m['fc1_w'].shape[1], 'cpu', mesh)
    with torch.no_grad():
        mlp.fc1.w.copy_(_shard(torch.tensor(m['fc1_w']), mesh, 1))
        mlp.fc1.b.copy_(_shard(torch.tensor(m['fc1_b']), mesh, 0))
        mlp.fc2.w.copy_(_shard(torch.tensor(m['fc2_w']), mesh, 0))
        mlp.fc2.b.copy_(torch.tensor(m['fc2_b']))
    y = mlp(x)
    (y * torch.tensor(m['g'])).sum().backward()
    out['mlp'] = dict(out=y.detach().numpy(), dx=x.grad.numpy(),
                      grads={n: q.grad.numpy() for n, q in mlp.named_parameters()})
    return out


def step_config(p):
    return pstep.StepConfig(seeker=pmt.SeekerConfig(**p['seeker_kw']),
                            loss=plosses.LossConfig(), num_queries=2)


def rank_train(mesh, p):
    '''p['steps'] steps of p['optimizer'] from the JAX-layout params on the (data, model)
    mesh: per step the losses, grad_norm and skipped flag and the attention forwards
    computed in each mode; the gathered parameters after steps 1 and 3; the shapes of
    this rank's parameters; the parameters gathered back from the shards of the initial
    tree (gather_state_dict of shard_params); the replicas checked.'''
    cfg = step_config(p)
    state = pstep.init_train_state(0, cfg, poptim.make_optimizer(p['optimizer'],
                                                                 **p['opt_kw']),
                                   params=p['params'], device='cpu', mesh=mesh)
    pmesh.shard_state(state, mesh)
    roundtrip = pmesh.fetch_global(params_to_jax(pmesh.gather_state_dict(
        state.model.state_dict(), mesh)))
    train_step = pstep.make_train_step(cfg, grad_accum=p['grad_accum'], mesh=mesh)
    local = pmesh.shard_batch(p['batch'], mesh, p['grad_accum'])
    steps, params, calls = [], {}, []
    for i in range(p['steps']):
        counts = dict(ptsf.fused_attention.calls)
        state, aux = train_step(state, local, p['progress'])
        steps.append({k: float(aux[k]) for k in (*LOSS_KEYS, 'grad_norm',
                                                 'skipped_nonfinite')})
        calls.append({k: n - counts[k] for k, n in ptsf.fused_attention.calls.items() if n
                      != counts[k]})
        if i in (0, 2):
            params[i] = pmesh.fetch_global(params_to_jax(state.model.state_dict()), mesh)
    return {'steps': steps, 'calls': calls, 'params': params, 'roundtrip': roundtrip,
            'shapes': {n: tuple(q.shape) for n, q in state.model.named_parameters()},
            'digest': pmesh.check_replicas(state, mesh),
            'rows': local['query_inds'].shape[0]}


def rank_checkpoint(mesh, p):
    '''One AdamW step, then save_train_state at p['out'] (every rank gathers, rank 0
    writes); the gathered parameters and optimizer state it wrote. Then p['one']'s
    checkpoint (written by one process) loaded into this rank's state: what the rank holds
    gathered back, and this rank's shards of its parameters.'''
    cfg = step_config(p)
    tx = poptim.make_optimizer('adamw', **p['opt_kw'])
    state = pstep.init_train_state(0, cfg, tx, params=p['params'], device='cpu', mesh=mesh)
    pmesh.shard_state(state, mesh)
    train_step = pstep.make_train_step(cfg, mesh=mesh)
    state, _ = train_step(state, pmesh.shard_batch(p['batch'], mesh), p['progress'])
    path = pckpt.save_train_state(p['out'], 0, 'tp', state)
    wrote = {'params': pmesh.fetch_global(params_to_jax(state.model.state_dict()), mesh),
             'opt_state': pmesh.fetch_global(pckpt.opt_state_to_jax(state.optimizer), mesh)}
    fresh = pstep.init_train_state(1, cfg, tx, device='cpu', mesh=mesh)
    loaded = pckpt.load_checkpoint(p['one'], state_template=fresh)['state']
    full = params_from_jax(pckpt.load_checkpoint(p['one'])['params'])
    shards_equal = all(torch.equal(t, pmesh.shard_params(full, mesh)[n])
                       for n, t in loaded.model.state_dict().items())
    return {'path': path, 'wrote': wrote, 'shards_equal': shards_equal,
            'resumed': {
                'params': pmesh.fetch_global(params_to_jax(loaded.model.state_dict()), mesh),
                'opt_state': pmesh.fetch_global(pckpt.opt_state_to_jax(loaded.optimizer),
                                                mesh),
                'step': loaded.step, 'count': loaded.optimizer.count,
                'generator': loaded.generator.get_state().numpy()},
            'digest': pmesh.check_replicas(loaded, mesh)}


RANK_KINDS = {'blocks': rank_blocks, 'train': rank_train, 'checkpoint': rank_checkpoint}
