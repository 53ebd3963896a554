'''
Numpy-only reader and writer of the tcow_tpu `.npz` checkpoint format (params + meta).

Format (tcow_tpu/train/checkpoint.py:63-170): `np.savez` of flat keys built from the
parameter tree's key paths, `params['backbone']['blocks']['attn']['qkv']['w']`, plus a
`__meta__` entry holding the args JSON as uint8 bytes. The tree keeps the JAX layout
(linear `w` is (din, dout), blocks stacked on a leading axis), so a checkpoint written by
either package loads in the other with no transposes. Optimizer state is not written here.
'''

import json
import os
import re
from typing import Any, Dict, Optional

import numpy as np


def _flatten_with_paths(tree, path=()) -> Dict[str, np.ndarray]:
    '''Nested dict of arrays -> {keystr: array}, the key format of jax.tree_util.keystr.'''
    if not isinstance(tree, dict):
        return {''.join(f"['{k}']" for k in path): np.asarray(tree)}
    flat = {}
    for k, v in tree.items():
        flat.update(_flatten_with_paths(v, path + (k,)))
    return flat


def _nest_from_keystrs(flat: Dict[str, np.ndarray]):
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


def save_checkpoint(checkpoint_dir: str, epoch: int, name: str, params,
                    train_args: Optional[Dict[str, Any]] = None,
                    dset_args: Optional[Dict[str, Any]] = None,
                    seeker_args: Optional[Dict[str, Any]] = None) -> str:
    '''Writes a params-only (light) checkpoint.npz plus the epoch/name sidecars.
    `params` is the JAX-layout tree of numpy arrays (weights.params_to_jax).
    Returns the checkpoint path.'''
    os.makedirs(checkpoint_dir, exist_ok=True)
    payload = {'params' + k: v for k, v in _flatten_with_paths(params).items()}
    meta = {
        'epoch': int(epoch),
        'name': name,
        'train_args': train_args or {},
        'dset_args': dset_args or {},
        'seeker_args': seeker_args or {},
        'light': True,
        'partial': False,
        'steps_done_in_epoch': 0,
        'format_version': 1,
    }
    payload['__meta__'] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    path = os.path.join(checkpoint_dir, 'checkpoint.npz')
    tmp = path + '.tmp.npz'
    np.savez(tmp, **payload)
    os.replace(tmp, path)
    np.savetxt(os.path.join(checkpoint_dir, 'checkpoint_epoch.txt'),
               np.array([epoch], dtype=np.int32), fmt='%d')
    with open(os.path.join(checkpoint_dir, 'checkpoint_name.txt'), 'w') as f:
        f.write(name + '\n')
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    '''Loads a checkpoint.npz: the meta keys ('epoch', 'train_args', 'dset_args',
    'seeker_args', ...) plus 'params', the nested JAX-layout tree of numpy arrays.'''
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    meta = json.loads(bytes(flat.pop('__meta__')).decode())
    out = dict(meta)
    out['params'] = _nest_from_keystrs(
        {k[len('params'):]: v for k, v in flat.items() if k.startswith('params')})
    return out


def resolve_checkpoint_path(path: str, epoch: int = -1) -> str:
    '''A checkpoint file as given, or inside an experiment directory: model_{epoch}.npz
    when epoch >= 0 and present, else checkpoint.npz (tcow_tpu resolve_resume_path).'''
    if os.path.isfile(path):
        return path
    if epoch >= 0:
        snap = os.path.join(path, f'model_{epoch}.npz')
        if os.path.exists(snap):
            return snap
    main = os.path.join(path, 'checkpoint.npz')
    if os.path.exists(main):
        return main
    raise FileNotFoundError(f'no .npz checkpoint found at {path}')
