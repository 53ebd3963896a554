'''
Weights bridge between the JAX parameter tree and the port's state_dict.

The JAX tree (tcow_tpu mask_tracker.init_params) nests dicts of arrays and stacks the
transformer blocks on a leading axis: params['backbone']['blocks']['attn']['qkv']['w'] is
(L, D, 3D). The port's state_dict uses the same names and leaf layouts, dot-joined, with
the block axis unrolled: 'backbone.blocks.3.attn.qkv.w' is (D, 3D). No leaf is
transposed, so both packages compute the same function from the same weights.
'''

import re
from typing import Any, Dict

import numpy as np
import torch

_BLOCK_KEY = re.compile(r'^(.*\bblocks)\.(\d+)\.(.+)$')


def _flatten(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


def jax_leaf_name(key: str) -> str:
    '''The JAX tree leaf a state_dict key belongs to, dot-joined: the block index dropped
    ('backbone.blocks.3.attn.qkv.w' -> 'backbone.blocks.attn.qkv.w').'''
    m = _BLOCK_KEY.match(key)
    return f'{m.group(1)}.{m.group(3)}' if m else key


def params_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    '''JAX-layout tree of numpy arrays -> state_dict of float32 CPU tensors.'''
    state = {}
    for key, arr in _flatten(tree):
        arr = np.asarray(arr, dtype=np.float32)
        head, sep, rest = key.partition('blocks.')
        if sep and (head == '' or head.endswith('.')):
            for i in range(arr.shape[0]):
                state[f'{head}blocks.{i}.{rest}'] = torch.from_numpy(arr[i].copy())
        else:
            state[key] = torch.from_numpy(arr.copy())
    return state


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    '''state_dict -> JAX-layout tree of float32 numpy arrays (blocks stacked again).'''
    flat, stacks = {}, {}
    for key, t in state.items():
        arr = t.detach().to('cpu', torch.float32).numpy()
        m = _BLOCK_KEY.match(key)
        if m:
            stacks.setdefault(jax_leaf_name(key), {})[int(m.group(2))] = arr
        else:
            flat[key] = arr
    for key, per_block in stacks.items():
        if sorted(per_block) != list(range(len(per_block))):
            raise ValueError(f'{key}: block indices {sorted(per_block)} are not 0..L-1')
        flat[key] = np.stack([per_block[i] for i in range(len(per_block))])
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        *path, leaf = key.split('.')
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = arr
    return tree
