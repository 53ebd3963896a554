'''
The host's clock in a run: the device sync that ends a window, set-up's progress and the
window's pace on standard error.
'''

import sys
import time

import torch


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize(device)


def mark(what: str, t_start: float):
    '''Set-up's progress on standard error: seconds since the process started.'''
    print(f'[perfbench] {what} at {time.perf_counter() - t_start:.2f} s', file=sys.stderr)


def print_sixths(what: str, ends):
    '''The window's pace in each sixth of it, on standard error: the median time between
    consecutive ends (of steps or requests) that fall in it.'''
    if len(ends) < 2:
        return
    span = ends[-1] / 6.0
    gaps = [(b, 1e3 * (b - a)) for a, b in zip(ends, ends[1:])]
    parts = []
    for k in range(6):
        g = sorted(d for e, d in gaps if k * span < e <= (k + 1) * span)
        parts.append(f'{g[len(g) // 2]:.1f}' if g else '-')
    print(f'[perfbench] {what} by sixth of the window: {" ".join(parts)}', file=sys.stderr)
