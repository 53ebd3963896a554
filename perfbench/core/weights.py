'''
Seeds and weights of a run. Every random thing of a run follows from --seed: the weights,
the drop-path generator, the traffic and the sample of requests checked. The weights are
drawn on the device in one call and handed, the same, to the program and to the
reference.
'''

import re
from typing import Dict

import numpy as np
import torch

# What a leaf's last name says about its initial value: drawn (normal, clamped at +-trunc
# standard deviations, times std), ones (LayerNorm gains) or zeros (biases).
DRAWN = ('w', 'cls_token', 'pos_embed', 'time_embed')
ONES = ('g',)


def sub_seeds(seed: int) -> Dict[str, int]:
    '''Independent 32-bit seeds for each use, from any whole number.'''
    if seed < 0:
        raise ValueError(f'--seed must be >= 0, got {seed}')
    names = ('weights', 'drop_path', 'traffic', 'sample')
    state = np.random.SeedSequence(int(seed)).generate_state(len(names), dtype=np.uint32)
    return {n: int(s) for n, s in zip(names, state)}


def make_weights(shapes: Dict[str, tuple], seed: int, device, init: Dict
                 ) -> Dict[str, torch.Tensor]:
    '''Float32 weights of the given shapes, drawn on `device` from a generator seeded with
    `seed` in one call. init: {'std', 'trunc', 'zero': [regular expressions of leaves that
    start at zero]}.'''
    zero = [re.compile(p) for p in init.get('zero', ())]
    kind = {}
    for name in shapes:
        leaf = name.rsplit('.', 1)[-1]
        if any(p.search(name) for p in zero):
            kind[name] = 'zero'
        elif leaf in DRAWN:
            kind[name] = 'drawn'
        elif leaf in ONES:
            kind[name] = 'one'
        else:
            kind[name] = 'zero'
    drawn = [n for n in shapes if kind[n] == 'drawn']
    total = sum(int(np.prod(shapes[n])) for n in drawn)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    z.clamp_(-init['trunc'], init['trunc']).mul_(init['std'])
    out, off = {}, 0
    for name, shape in shapes.items():
        if kind[name] == 'drawn':
            n = int(np.prod(shape))
            out[name] = z[off:off + n].view(shape)
            off += n
        elif kind[name] == 'one':
            out[name] = torch.ones(shape, device=device)
        else:
            out[name] = torch.zeros(shape, device=device)
    return out
