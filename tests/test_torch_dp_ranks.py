'''
The ranks of tests/test_torch_data_parallel.py: each runs as its own process
(`rank_main(kind, rank, world, port, payload, out)`), joins a CPU gloo group and runs one
of RANK_KINDS on a pickled payload, writing its result as a pickle. It imports torch and
the port only, so the forkserver that preloads it holds no JAX. It holds no tests of its
own.
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
from tcow_tpu_torch.weights import params_to_jax

LOSS_KEYS = ('track', 'occl_mask', 'cont_mask', 'total_seeker')


def rank_main(kind, rank, world, port, inp, out):
    '''One rank: joins the gloo group on the CPU, runs RANK_KINDS[kind] on the payload and
    writes its result, or {'error': traceback} when it raised.'''
    torch.set_num_threads(1)
    ptsf.DEPTH_PRESETS[2] = (64, 4)
    try:
        with open(inp, 'rb') as f:
            payload = pickle.load(f)
        mesh = pmesh.make_mesh('cpu', int(rank), int(world), 0, '127.0.0.1', int(port))
        try:
            assert mesh.backend == 'gloo', mesh
            result = RANK_KINDS[kind](mesh, payload)
        finally:
            mesh.close()
    except Exception:  # noqa: BLE001 — reported by the test that started the rank
        result = {'error': traceback.format_exc()}
    with open(out, 'wb') as f:
        pickle.dump(result, f)


def rank_losses(mesh, p):
    '''compute_losses over the group and on this rank's rows alone: values, and the
    gradient of the grouped total with respect to this rank's logits; then
    rank_extremes.'''
    rows = pmesh.shard_rows(p['logits'].shape[0], mesh.rank, mesh.world)
    args = [torch.as_tensor(p[k][rows]) for k in ('target', 'sel_occl_fracs', 'snitch')]
    logits = torch.tensor(p['logits'][rows], requires_grad=True)
    cfg = plosses.LossConfig()
    out = plosses.compute_losses(cfg, logits, *args, p['query_time'], p['progress'],
                                 group=mesh.group)
    out['total_seeker'].backward()
    alone = plosses.compute_losses(cfg, logits.detach(), *args, p['query_time'],
                                   p['progress'])
    return {'grouped': {k: float(out[k]) for k in LOSS_KEYS},
            'alone': {k: float(alone[k]) for k in LOSS_KEYS},
            'grad': logits.grad.numpy(), 'extremes': rank_extremes(mesh, p)}


def rank_train(mesh, p):
    '''p['steps'] data-parallel AdamW steps from the JAX-layout params: the first step's
    gradients (compute_gradients), per step the losses, grad_norm and skipped flag, the parameters after steps 1 and 3, the state digest; with
    p['restart'], also the parameters after one step from that state.'''
    cfg = pstep.StepConfig(seeker=pmt.SeekerConfig(**p['seeker_kw']),
                           loss=plosses.LossConfig(), num_queries=2)
    state = pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **p['opt_kw']),
                                   params=p['params'], device='cpu')
    pmesh.shard_state(state, mesh)
    train_step = pstep.make_train_step(cfg, grad_accum=p['grad_accum'], mesh=mesh)
    local = pmesh.shard_batch(p['batch'], mesh, p['grad_accum'])
    drawn = state.generator.get_state()
    pstep.compute_gradients(state, cfg, local, p['progress'], p['grad_accum'], mesh)
    state.generator.set_state(drawn)     # the first step draws the same masks
    grads = pmesh.fetch_global(params_to_jax(
        {k: (q.grad if q.grad is not None else torch.zeros_like(q))
         for k, q in state.model.named_parameters()}))
    steps, params = [], {}
    for i in range(p['steps']):
        state, aux = train_step(state, local, p['progress'])
        steps.append({k: float(aux[k]) for k in (*LOSS_KEYS, 'grad_norm',
                                                 'skipped_nonfinite')})
        if i in (0, 2):
            params[i] = pmesh.fetch_global(params_to_jax(state.model.state_dict()))
    out = {'steps': steps, 'params': params, 'grads': grads,
           'digest': pmesh.check_replicas(state, mesh),
           'rows': local['query_inds'].shape[0]}
    if 'restart' in p:
        # One more step from a given state (JAX-layout params and optimizer state).
        state = pstep.init_train_state(0, cfg, poptim.make_optimizer('adamw', **p['opt_kw']),
                                       params=p['restart']['params'], device='cpu')
        pckpt.load_opt_state(state.optimizer, p['restart']['opt_state'])
        pmesh.shard_state(state, mesh)
        state, _ = train_step(state, local, p['progress'])
        out['restart_params'] = pmesh.fetch_global(params_to_jax(state.model.state_dict()))
    return out


def rank_extremes(mesh, p):
    '''all_max and all_min of this rank's row of p['x'] and the gradients of 3x each.'''
    out = {}
    for name, fn in (('max', pmesh.all_max), ('min', pmesh.all_min)):
        v = torch.tensor(p['x'][mesh.rank], requires_grad=True)
        y = fn(v, mesh.group)
        (3.0 * y).backward()
        out[name] = (float(y), v.grad.numpy())
    return out


RANK_KINDS = {'losses': rank_losses, 'train': rank_train}
