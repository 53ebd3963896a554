'''
Reader and writer of the tcow_tpu `.npz` checkpoint format: the port of
tcow_tpu/train/checkpoint.py (:63-202).

Format: `np.savez` of flat keys built from each tree's key paths under a prefix, 'params'
+ "['backbone']['blocks']['attn']['qkv']['w']", 'opt_state' + "[1][0].mu['backbone']...",
'step', plus a `__meta__` entry holding the args JSON as uint8 bytes. The parameter tree
keeps the JAX layout (linear `w` is (din, dout), blocks stacked on a leading axis), so a
checkpoint written by either package loads in the other with no transposes. The
optimizer state is written under optax's own paths (`opt_state_to_jax`), so AdamW and
LAMB moments and counts saved by either package restore in the other.

The JAX package keeps a threefry key under 'rng'; the port's drop-path generator is a
torch.Generator, saved under GENERATOR_KEY. The JAX loader selects its subtrees by prefix
(k.startswith('params' / 'opt_state' / 'rng' / 'step')), so that key starts with none of
them and the JAX loader passes it by.

A directory holds checkpoint.npz (the latest save, replaced atomically), model_{epoch}.npz
snapshots every `checkpoint_every` epochs, and the checkpoint_epoch.txt /
checkpoint_name.txt sidecars.
'''

import glob
import json
import os
import re
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from tcow_tpu_torch.models import torch_import
from tcow_tpu_torch.weights import params_from_jax, params_to_jax

GENERATOR_KEY = 'torch_generator'
# Where optax keeps each optimizer's state inside its chain (optim.py of the JAX package):
# the index of scale_by_adam's (count, mu, nu), None for sgd, and of the schedule's count.
# The chain sits at index [1] behind clip_by_global_norm when clipping is on.
OPTAX_LAYOUT = {'sgd': (None, 1), 'adam': (0, 1), 'adamw': (0, 2), 'lamb': (0, 3)}


def flatten_with_paths(tree, path=()) -> Dict[str, np.ndarray]:
    '''Nested dict of arrays -> {keystr: array}, the key format of jax.tree_util.keystr.'''
    if not isinstance(tree, dict):
        return {''.join(f"['{k}']" for k in path): np.asarray(tree)}
    flat = {}
    for k, v in tree.items():
        flat.update(flatten_with_paths(v, path + (k,)))
    return flat


def nest_from_keystrs(flat: Dict[str, np.ndarray]):
    '''Rebuilds a nested dict/list tree from keystr paths like ["a"]["b"][0].'''
    root: Dict[Any, Any] = {}
    for keystr, val in flat.items():
        parts = re.findall(r"\['([^']+)'\]|\[(\d+)\]", keystr)
        keys = [p[0] if p[0] else int(p[1]) for p in parts]
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val

    def intify(node):
        if isinstance(node, dict):
            if node and all(isinstance(k, int) for k in node):
                return [intify(node[i]) for i in sorted(node)]
            return {k: intify(v) for k, v in node.items()}
        return node

    return intify(root)


def _optax_prefixes(optimizer):
    pre = '[1]' if optimizer.spec.gradient_clip > 0.0 else ''
    adam, sched = OPTAX_LAYOUT[optimizer.spec.name]
    return (None if adam is None else f'{pre}[{adam}]'), f'{pre}[{sched}]'


def opt_state_to_jax(optimizer) -> Dict[str, np.ndarray]:
    '''The state of a train/optim.py Optimizer as the JAX package's TrainState.opt_state
    flattens it into a checkpoint (keystr -> array, without the 'opt_state' prefix): the
    schedule's count and Adam's count as int32 (both the count of applied updates), and
    the moments mu / nu (torch's exp_avg / exp_avg_sq) as JAX-layout trees of the
    parameters, zeros before the first update.'''
    adam, sched = _optax_prefixes(optimizer)
    out = {f'{sched}.count': np.asarray(optimizer.count, np.int32)}
    if adam is None:
        return out
    out[f'{adam}.count'] = np.asarray(optimizer.count, np.int32)
    state = optimizer.torch_opt.state
    for which, key in (('mu', 'exp_avg'), ('nu', 'exp_avg_sq')):
        tree = params_to_jax({n: state[p].get(key, torch.zeros_like(p))
                              for n, p in zip(optimizer.names, optimizer.params)})
        out.update({f'{adam}.{which}{k}': v for k, v in flatten_with_paths(tree).items()})
    return out


def load_opt_state(optimizer, flat: Dict[str, np.ndarray]):
    '''Restores into `optimizer` what `opt_state_to_jax` writes (and the JAX package
    saves for the same optimizer): the count of applied updates, and the moments with
    torch's per-parameter step set to Adam's count.'''
    adam, sched = _optax_prefixes(optimizer)
    optimizer.count = int(flat[f'{sched}.count'])
    if adam is None:
        return
    count = int(flat[f'{adam}.count'])
    state = optimizer.torch_opt.state
    state.clear()
    if count == 0:
        return
    moments = {}
    for which in ('mu', 'nu'):
        head = f'{adam}.{which}'
        moments[which] = params_from_jax(nest_from_keystrs(
            {k[len(head):]: v for k, v in flat.items() if k.startswith(head + '[')}))
    for n, p in zip(optimizer.names, optimizer.params):
        state[p] = {'step': torch.tensor(float(count), dtype=torch.float32),
                    'exp_avg': moments['mu'][n].to(p.device, p.dtype),
                    'exp_avg_sq': moments['nu'][n].to(p.device, p.dtype)}


def save_checkpoint(checkpoint_dir: str, epoch: int, name: str, params,
                    train_args: Optional[Dict[str, Any]] = None,
                    dset_args: Optional[Dict[str, Any]] = None,
                    seeker_args: Optional[Dict[str, Any]] = None,
                    opt_state: Optional[Dict[str, np.ndarray]] = None,
                    step: Optional[int] = None,
                    generator_state: Optional[np.ndarray] = None,
                    checkpoint_every: int = 2, is_debug: bool = False,
                    steps_done: Optional[int] = None,
                    loader_state: Optional[Dict[str, Any]] = None) -> str:
    '''Writes checkpoint.npz (and a model_{epoch}.npz snapshot every checkpoint_every
    epochs) with the sidecars; returns the main checkpoint's path. `params` is the
    JAX-layout tree of numpy arrays (weights.params_to_jax); `opt_state` the flat optax
    state (opt_state_to_jax), None for a light, params-only save; `step` the steps
    taken; `generator_state` the drop-path generator's bytes (`save_train_state` fills
    these three from a TrainState).

    steps_done: a mid-epoch (preemption) save. `epoch` is then the epoch in progress, of
    which steps_done steps are complete; it is always written and never snapshotted. In
    debug runs (is_debug) the main checkpoint is written only every checkpoint_every
    epochs, as in checkpoint.py:97-106.'''
    os.makedirs(checkpoint_dir, exist_ok=True)
    payload = {'params' + k: v for k, v in flatten_with_paths(params).items()}
    if opt_state is not None:
        payload.update({'opt_state' + k: np.asarray(v) for k, v in opt_state.items()})
    if step is not None:
        payload['step'] = np.asarray(step, np.int32)
    if generator_state is not None:
        payload[GENERATOR_KEY] = np.asarray(generator_state, np.uint8)
    meta = {
        'epoch': int(epoch),
        'name': name,
        'train_args': train_args or {},
        'dset_args': dset_args or {},
        'seeker_args': seeker_args or {},
        'light': opt_state is None,
        'partial': steps_done is not None,
        'steps_done_in_epoch': int(steps_done) if steps_done is not None else 0,
        'format_version': 1,
    }
    if loader_state is not None:
        meta['loader_state'] = loader_state
    payload['__meta__'] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = os.path.join(checkpoint_dir, 'checkpoint.npz')
    snapshot_epoch = epoch % checkpoint_every == 0 or epoch < 0
    if steps_done is not None or not is_debug or snapshot_epoch:
        tmp = path + '.tmp.npz'
        np.savez(tmp, **payload)
        os.replace(tmp, path)
        np.savetxt(os.path.join(checkpoint_dir, 'checkpoint_epoch.txt'),
                   np.array([epoch], dtype=np.int32), fmt='%d')
        with open(os.path.join(checkpoint_dir, 'checkpoint_name.txt'), 'w') as f:
            f.write(name + '\n')
    if steps_done is None and snapshot_epoch:
        snap = os.path.join(checkpoint_dir, f'model_{epoch}.npz')
        if os.path.exists(snap):
            os.remove(snap)
        try:
            os.link(path, snap)   # checkpoint.npz is replaced, never rewritten in place
        except OSError:
            shutil.copy(path, snap)
    return path


def save_train_state(checkpoint_dir: str, epoch: int, name: str, state, **kwargs) -> str:
    '''save_checkpoint of a train/step.py TrainState: its model's parameters, its
    optimizer's state under optax's paths, its step and its generator.'''
    return save_checkpoint(checkpoint_dir, epoch, name,
                           params_to_jax(state.model.state_dict()),
                           opt_state=opt_state_to_jax(state.optimizer),
                           step=state.step, generator_state=state.generator.get_state().numpy(),
                           **kwargs)


def load_checkpoint(path: str, state_template=None) -> Dict[str, Any]:
    '''Loads a checkpoint.npz: the meta keys ('epoch', 'train_args', 'dset_args',
    'seeker_args', ...), 'params' (the nested JAX-layout tree of numpy arrays) and
    'opt_restored' (whether optimizer state is present). With `state_template`, a
    train/step.py TrainState built for the same model and optimizer, also restores into
    it, in place, and returns it as 'state': the parameters; the optimizer state when
    present (a light save keeps the template's); the step; and the generator. A port
    checkpoint restores the generator's saved state. A JAX checkpoint holds a threefry
    key instead, which no torch generator can continue: the generator is then seeded
    from that key's words, so a resume is repeatable but draws other masks than JAX
    would; with neither, the template's generator is kept.'''
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop('__meta__')).decode())

    def subtree(prefix):
        return {k[len(prefix):]: v for k, v in flat.items() if k.startswith(prefix)}

    out = dict(meta)
    out['params'] = nest_from_keystrs(subtree('params'))
    opt_flat = subtree('opt_state')
    out['opt_restored'] = bool(opt_flat)
    if state_template is not None:
        state = state_template
        device = next(state.model.parameters()).device
        state.model.load_state_dict({k: v.to(device) for k, v in
                                     params_from_jax(out['params']).items()})
        if opt_flat:
            load_opt_state(state.optimizer, opt_flat)
        if 'step' in flat:
            state.step = int(flat['step'])
        if GENERATOR_KEY in flat:
            state.generator.set_state(torch.from_numpy(flat[GENERATOR_KEY]))
        elif 'rng' in flat:
            words = np.asarray(flat['rng'], np.uint32).tobytes()
            state.generator.manual_seed(int.from_bytes(words, 'little') % 2 ** 63)
        out['state'] = state
    return out


def peek_meta(path: str) -> Dict[str, Any]:
    '''The embedded __meta__ JSON alone, plus 'opt_restored' (whether optimizer state is
    present): np.load reads lazily, so this reads one small member of the archive.'''
    with np.load(path) as z:
        meta = json.loads(bytes(np.asarray(z['__meta__'])).decode())
        meta['opt_restored'] = any(k.startswith('opt_state') for k in z.files)
    return meta


def find_full_snapshot(checkpoint_path: str) -> Optional[str]:
    '''The newest model_{epoch}.npz beside checkpoint_path that carries optimizer state,
    or None: where to resume training when the latest checkpoint is a light save.'''
    d = os.path.dirname(os.path.abspath(checkpoint_path))
    cands = []
    for p in glob.glob(os.path.join(d, 'model_*.npz')):
        m = re.fullmatch(r'model_(-?\d+)\.npz', os.path.basename(p))
        if m:
            cands.append((int(m.group(1)), p))
    for _, p in sorted(cands, reverse=True):
        try:
            if peek_meta(p).get('opt_restored'):
                return p
        except (OSError, ValueError, KeyError):
            continue
    return None


def get_checkpoint_epoch(checkpoint_path: str) -> int:
    '''The epoch of a checkpoint: its directory's checkpoint_epoch.txt, else the payload's
    (checkpoint.py:223-234): an .npz's meta or a reference .pth's `epoch`.'''
    epoch_file = os.path.join(os.path.dirname(checkpoint_path), 'checkpoint_epoch.txt')
    if os.path.exists(epoch_file):
        return int(np.loadtxt(epoch_file, dtype=np.int32))
    if checkpoint_path.endswith('.pth'):
        return int(torch_import.load_torch_file(checkpoint_path).get('epoch', -1))
    return int(peek_meta(checkpoint_path)['epoch'])


def resolve_checkpoint_path(path: str, epoch: int = -1) -> str:
    '''A checkpoint file as given, or inside an experiment directory: model_{epoch}.npz,
    else model_{epoch}.pth, when epoch >= 0 and present; else checkpoint.npz, else a
    reference checkpoint.pth (tcow_tpu resolve_resume_path, checkpoint.py:205-220).'''
    if os.path.isfile(path):
        return path
    names = ([f'model_{epoch}{ext}' for ext in ('.npz', '.pth')] if epoch >= 0 else [])
    for name in names + ['checkpoint.npz', 'checkpoint.pth']:
        candidate = os.path.join(path, name)
        if os.path.exists(candidate):
            return candidate
    raise FileNotFoundError(f'no checkpoint found at {path}')
