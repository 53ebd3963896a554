'''
The ranks of tests/test_torch_sequence_parallel.py: each runs as its own process
(`rank_main(jobs, inp, out)`) and takes its jobs in turn; a job joins a CPU gloo group of
job['world'] ranks as a (data, seq, model) mesh, runs one of RANK_KINDS on a payload of
the pickled file `inp` and leaves the group, so one process can serve several meshes. The
results, by job name, are written to `out` as a pickle. It imports torch and the port only,
so the forkserver that preloads it holds no JAX. It holds no tests of its own.
'''

import pickle
import traceback

import torch

from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

LOSS_KEYS = ('track', 'occl_mask', 'cont_mask', 'total_seeker')


def rank_main(jobs, inp, out):
    '''This process's jobs, in order: each joins the gloo group on the CPU at
    (job['world'], job['rank'], job['port']) with job['seq'] seq and job['model'] model
    ranks a data row, registers job['preset'] as the depth-2 width, runs
    RANK_KINDS[job['kind']] on payload job['payload'] and leaves; writes {job name:
    result}, or {'error': traceback} when a job raised.'''
    torch.set_num_threads(1)
    results = {}
    try:
        with open(inp, 'rb') as f:
            payloads = pickle.load(f)
        for job in jobs:
            ptsf.DEPTH_PRESETS[2] = tuple(job['preset'])
            mesh = pmesh.make_mesh('cpu', job['rank'], job['world'], 0, '127.0.0.1',
                                   job['port'], model=job['model'], seq=job['seq'])
            try:
                assert mesh.backend == 'gloo', mesh
                result = RANK_KINDS[job['kind']](mesh, payloads[job['payload']])
                result['coords'] = (mesh.data_rank, mesh.seq_rank, mesh.model_rank)
            finally:
                mesh.close()
            results[job['name']] = result
    except Exception:  # noqa: BLE001 — reported by the test that started the rank
        results = {'error': traceback.format_exc()}
    with open(out, 'wb') as f:
        pickle.dump(results, f)


def _calls_since(counts):
    return {k: n - counts[k] for k, n in ptsf.fused_attention.calls.items() if n != counts[k]}


def rank_forward(mesh, p):
    '''The backbone (p['cfg'] under each causal_attention of p['cases']) from p['params']
    on this data row's clips of p['x']: the features and the cls token, and the attention
    forwards each computed.'''
    x = torch.as_tensor(p['x'])
    rows = pmesh.shard_rows(x.shape[0], mesh.data_rank, mesh.n_data)
    out = {}
    for ca in p['cases']:
        model = ptsf.TimeSformer(ptsf.TimeSformerConfig(**p['cfg'], causal_attention=ca),
                                 'cpu', mesh)
        model.load_state_dict(params_from_jax(p['params']))
        counts = dict(ptsf.fused_attention.calls)
        with torch.no_grad():
            feats, cls = model(x[rows])
        out[ca] = {'feats': feats.numpy(), 'cls': cls.numpy(), 'calls': _calls_since(counts)}
    return out


def step_config(p):
    return pstep.StepConfig(seeker=pmt.SeekerConfig(**p['seeker_kw']),
                            loss=plosses.LossConfig(), num_queries=p['num_queries'])


def rank_grads(mesh, p):
    '''The step's gradients of p['batch'] (compute_gradients: summed over the gradient
    group) from p['params'], gathered into the one-process layout, with the losses.'''
    cfg = step_config(p)
    state = pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **p['opt_kw']),
                                   params=p['params'], device='cpu', mesh=mesh)
    local = pmesh.shard_batch(p['batch'], mesh)
    aux = pstep.compute_gradients(state, cfg, local, p['progress'], mesh=mesh)
    grads = {n: (q.grad if q.grad is not None else torch.zeros_like(q))
             for n, q in state.model.named_parameters()}
    return {'losses': {k: float(aux[k]) for k in LOSS_KEYS},
            'grads': pmesh.fetch_global(params_to_jax(pmesh.gather_state_dict(grads, mesh))),
            'rows': local['query_inds'].shape[0]}


def rank_train(mesh, p):
    '''p['steps'] steps of AdamW from p['params'] placed by shard_state: per step the
    losses, grad_norm and skipped flag and the attention forwards computed; the parameters
    after each step; the replicas checked; with p['out'], then save_train_state there
    (rank 0 writes) and the parameters and optimizer state the ranks held.'''
    cfg = step_config(p)
    state = pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **p['opt_kw']),
                                   params=p['params'], device='cpu', mesh=mesh)
    pmesh.shard_state(state, mesh)
    train_step = pstep.make_train_step(cfg, mesh=mesh)
    local = pmesh.shard_batch(p['batch'], mesh)
    steps, params, calls = [], [], []
    for _ in range(p['steps']):
        counts = dict(ptsf.fused_attention.calls)
        state, aux = train_step(state, local, p['progress'])
        steps.append({k: float(aux[k]) for k in (*LOSS_KEYS, 'grad_norm',
                                                 'skipped_nonfinite')})
        calls.append(_calls_since(counts))
        params.append(pmesh.fetch_global(params_to_jax(state.model.state_dict()), mesh))
    out = {'steps': steps, 'params': params, 'calls': calls,
           'digest': pmesh.check_replicas(state, mesh), 'rows': local['query_inds'].shape[0]}
    if p.get('out'):
        out['path'] = pckpt.save_train_state(p['out'], 0, 'sp', state)
        out['held'] = {'params': pmesh.fetch_global(params_to_jax(state.model.state_dict()),
                                                    mesh),
                       'opt_state': pmesh.fetch_global(pckpt.opt_state_to_jax(state.optimizer),
                                                       mesh),
                       'step': state.step, 'count': state.optimizer.count,
                       'generator': state.generator.get_state().numpy()}
    return out


RANK_KINDS = {'forward': rank_forward, 'grads': rank_grads, 'train': rank_train}
