'''
The ranks of tests/test_torch_pipeline_parallel.py and tests/test_torch_sp_joint_pp.py:
each runs as its own process (`rank_main(jobs, inp, out)`) and takes its jobs in turn; a job
joins a CPU gloo group of job['world'] ranks as a (data, seq, model, pipe) mesh, runs one of
RANK_KINDS on a payload of
the pickled file `inp` and leaves the group, so one process can serve several meshes. The
results, by job name, are written to `out` as a pickle. It imports torch and the port only,
so the forkserver that preloads it holds no JAX. It holds no tests of its own.
'''

import pickle
import traceback

import numpy as np
import torch

from tcow_tpu_torch.models import mask_tracker as pmt
from tcow_tpu_torch.models import timesformer as ptsf
from tcow_tpu_torch.objectives import losses as plosses
from tcow_tpu_torch.parallel import mesh as pmesh
from tcow_tpu_torch.train import checkpoint as pckpt
from tcow_tpu_torch.train import optim as poptim
from tcow_tpu_torch.train import step as pstep
from tcow_tpu_torch.weights import params_to_jax

LOSS_KEYS = ('track', 'occl_mask', 'cont_mask', 'total_seeker')


def rank_main(jobs, inp, out):
    '''This process's jobs, in order: each joins the gloo group on the CPU at
    (job['world'], job['rank'], job['port']) with job['model'] model, job['pipe'] pipe and
    job.get('seq', 1) seq ranks a data row, registers job['preset'] as the width of depths 2
    and 4, runs RANK_KINDS[job['kind']] on payload job['payload'] and leaves; writes {job
    name: result} (its seq coordinate under 'seq'), or {'error': traceback} when a job
    raised.'''
    torch.set_num_threads(1)
    results = {}
    try:
        with open(inp, 'rb') as f:
            payloads = pickle.load(f)
        for job in jobs:
            ptsf.DEPTH_PRESETS[2] = ptsf.DEPTH_PRESETS[4] = tuple(job['preset'])
            mesh = pmesh.make_mesh('cpu', job['rank'], job['world'], 0, '127.0.0.1',
                                   job['port'], model=job['model'], pipe=job['pipe'],
                                   seq=job.get('seq', 1))
            try:
                assert mesh.backend == 'gloo', mesh
                result = RANK_KINDS[job['kind']](mesh, payloads[job['payload']])
                result['coords'] = (mesh.data_rank, mesh.model_rank, mesh.pipe_rank)
                result['seq'] = mesh.seq_rank
            finally:
                mesh.close()
            results[job['name']] = result
    except Exception:  # noqa: BLE001 — reported by the test that started the rank
        results = {'error': traceback.format_exc()}
    with open(out, 'wb') as f:
        pickle.dump(results, f)


def _calls_since(counts):
    return {k: n - counts[k] for k, n in ptsf.fused_attention.calls.items() if n != counts[k]}


def step_config(p):
    return pstep.StepConfig(seeker=pmt.SeekerConfig(**p['seeker_kw']),
                            loss=plosses.LossConfig(), num_queries=p['num_queries'])


def _state(mesh, p):
    return pstep.init_train_state(0, step_config(p),
                                  poptim.make_optimizer(p.get('opt', 'adamw'), **p['opt_kw']),
                                  params=p['params'], device='cpu', mesh=mesh)


def rank_grads(mesh, p):
    '''The step's gradients of p['batch'] (compute_gradients at p['accum']: summed over the
    gradient groups) from p['params'], gathered into the one-process layout, with the
    losses, the blocks this stage holds and the attention forwards it computed.'''
    cfg = step_config(p)
    state = _state(mesh, p)
    local = pmesh.shard_batch(p['batch'], mesh, p.get('accum', 1))
    counts = dict(ptsf.fused_attention.calls)
    aux = pstep.compute_gradients(state, cfg, local, p['progress'], p.get('accum', 1), mesh)
    grads = {n: (q.grad if q.grad is not None else torch.zeros_like(q))
             for n, q in state.model.named_parameters()}
    return {'losses': {k: float(aux[k]) for k in LOSS_KEYS},
            'grads': pmesh.fetch_global(params_to_jax(pmesh.gather_state_dict(grads, mesh))),
            'rows': local['query_inds'].shape[0], 'calls': _calls_since(counts),
            'blocks': list(state.model.backbone.block_ids)}


def rank_train(mesh, p):
    '''p['steps'] steps from p['params'] placed by shard_state: per step the losses,
    grad_norm and skipped flag; the parameters after each step; the replicas checked; with
    p['out'], then save_train_state there (rank 0 writes) and the parameters and optimizer
    state the ranks held.'''
    cfg = step_config(p)
    state = _state(mesh, p)
    pmesh.shard_state(state, mesh)
    train_step = pstep.make_train_step(cfg, mesh=mesh)
    local = pmesh.shard_batch(p['batch'], mesh)
    steps, params = [], []
    for _ in range(p['steps']):
        state, aux = train_step(state, local, p['progress'])
        steps.append({k: float(aux[k]) for k in (*LOSS_KEYS, 'grad_norm',
                                                 'skipped_nonfinite')})
        params.append(pmesh.fetch_global(params_to_jax(state.model.state_dict()), mesh))
    out = {'steps': steps, 'params': params, 'digests': pmesh.state_digests(state),
           'digest': pmesh.check_replicas(state, mesh), 'rows': local['query_inds'].shape[0]}
    if p.get('out'):
        out['path'] = pckpt.save_train_state(p['out'], 0, 'pp', state)
        out['held'] = {'params': params[-1],
                       'opt_state': pmesh.fetch_global(pckpt.opt_state_to_jax(state.optimizer),
                                                       mesh),
                       'step': state.step, 'count': state.optimizer.count,
                       'generator': state.generator.get_state().numpy()}
    return out


def rank_forward(mesh, p):
    '''The pipelined forward of p['batch'] at p['micro'] microbatches with gradients off:
    under p['train'] with the drop-path masks of p['seed']'s generator; the last stage
    returns the output mask, every stage the losses of make_eval_step (one microbatch,
    broadcast from the last stage).'''
    cfg = step_config(p)
    state = _state(mesh, p)
    local = pmesh.shard_batch(p['batch'], mesh)
    gen = torch.Generator().manual_seed(p['seed'])
    with torch.no_grad():
        res = pstep._pipeline_pass(state.model, cfg, local, gen, p['progress'], p['train'],
                                   mesh, False, group=mesh.group, n_micro=p['micro'])
    evals = pstep.make_eval_step(cfg, mesh=mesh)(state.model, local, p['progress'])
    return {'mask': None if res is None else res[2].numpy(),
            'eval': {k: float(evals[k]) for k in LOSS_KEYS}}


def rank_vis(mesh, p):
    '''make_vis_step under the pipeline on this data row's batch: the payload every stage
    gets (the last stage's), as numpy.'''
    cfg = step_config(p)
    state = _state(mesh, p)
    vis = pstep.make_vis_step(cfg, mesh=mesh)(state.model, pmesh.shard_batch(p['batch'], mesh),
                                              p['progress'])
    host = lambda v: ({k: host(x) for k, x in v.items()} if isinstance(v, dict) else
                      None if v is None else np.asarray(v.float()))
    return {'vis': host(vis)}


RANK_KINDS = {'grads': rank_grads, 'train': rank_train, 'forward': rank_forward,
              'vis': rank_vis}
