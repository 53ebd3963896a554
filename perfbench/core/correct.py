'''
The numbers that decide `correct`, each the gap between what the program's timed path
produced and what the reference (reference/seeker.py) works out from the same weights and
inputs, and each held to a limit of the cell's (workloads/<cell>.json, 'limits').

Training (the first three steps, which run through the window's own call on rows that all
differ, before the window):
  loss_gap    the largest relative gap of a step's loss;
  gnorm_gap   the relative gap of the first step's global gradient norm before clipping
              (it carries the gradient's scale, which clipping and Adam take out);
  grad_gap    the first step's clipped gradient as the optimizer took it (its first moment
              over 1 - beta1), by the worst leaf: |‖g‖ - ‖g_ref‖| over the larger of
              ‖g_ref‖ and the median leaf's;
  grad_median_gap  the same gap of the median leaf: steady from seed to seed, where the
              worst leaf swings, so that a gradient of part of the batch stands out;
  change_gap  the parameters' change after the three steps, the same way, over the
              leaves whose reference gradient is at least 1e-3 of the median leaf's (a
              leaf whose gradient is nought to rounding moves under Adam by round-off).
Requests (a sample of those answered in the window, drawn from the seed, the last always
among them):
  mask_gap    relative L2 gap of the output mask logits, worst request;
  flags_gap   relative L2 gap of the flags, worst request;
  iou_gap     the largest gap of a clip's mean IoU of a metric family, and any count that
              differs.
'''

import sys
from typing import Dict, List, Optional

import numpy as np

SKIP_GRAD_SHARE = 1e-3


def _median(values) -> float:
    return float(np.median(np.asarray(list(values), dtype=np.float64)))


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep: Optional[List[str]] = None) -> List[float]:
    '''Each leaf's |prog - ref| / max(ref, median of ref) over the leaves in `keep`.'''
    names = list(ref) if keep is None else keep
    med = _median(ref[n] for n in ref)
    return [abs(prog.get(n, 0.0) - ref[n]) / max(ref[n], med) for n in names
            if max(ref[n], med) > 0]


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[List[str]] = None) -> float:
    '''The worst leaf's gap (leaf_gaps).'''
    return max(leaf_gaps(prog, ref, keep), default=0.0)


def train_readings(prog: Dict, ref: Dict) -> Dict[str, float]:
    '''prog / ref: {'losses': [three floats], 'grad': {leaf: norm}, 'change': {leaf: norm},
    'gnorm': float}.'''
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(prog['losses'],
                                                                    ref['losses']))
    if len(prog['losses']) != len(ref['losses']) or not np.all(np.isfinite(prog['losses'])):
        loss_gap = float('inf')
    gnorm_gap = abs(prog['gnorm'] - ref['gnorm']) / max(ref['gnorm'], 1e-30)
    if not np.isfinite(prog['gnorm']):
        gnorm_gap = float('inf')
    med = _median(ref['grad'].values())
    moved = [n for n, g in ref['grad'].items() if g >= SKIP_GRAD_SHARE * med]
    grad_gaps = leaf_gaps(prog['grad'], ref['grad'])
    return {'loss_gap': loss_gap, 'gnorm_gap': gnorm_gap, 'grad_gap': max(grad_gaps),
            'grad_median_gap': _median(grad_gaps),
            'change_gap': leaf_gap(prog['change'], ref['change'], moved)}


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape or not np.all(np.isfinite(a)):
        return float('inf')
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def request_readings(pairs: List[Dict]) -> Dict[str, float]:
    '''pairs: per checked clip {'mask', 'mask_ref', 'flags', 'flags_ref', 'metrics',
    'metrics_ref'}; metrics as {'sum_<f>', 'count_<f>'}.'''
    mask_gap = max(_rel_l2(p['mask'], p['mask_ref']) for p in pairs)
    flags_gap = max(_rel_l2(p['flags'], p['flags_ref']) for p in pairs)
    iou_gap = 0.0
    for p in pairs:
        m, r = p['metrics'], p['metrics_ref']
        for key in r:
            if not key.startswith('count_'):
                continue
            fam = key[len('count_'):]
            if key not in m or round(m[key]) != round(r[key]):
                iou_gap = float('inf')
            elif r[key] > 0:
                iou_gap = max(iou_gap, abs(m[f'sum_{fam}'] - r[f'sum_{fam}']) / r[key])
    return {'mask_gap': mask_gap, 'flags_gap': flags_gap, 'iou_gap': iou_gap}


def judge(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    '''Correct when every limited number is finite and at most its limit.'''
    return all(k in readings and np.isfinite(readings[k]) and readings[k] <= lim
               for k, lim in limits.items())


def checks(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, Dict]:
    '''{name: {'value', 'limit'}} of each number compared, for the result's last key.'''
    return {k: {'value': readings.get(k, float('nan')), 'limit': lim}
            for k, lim in limits.items()}


def print_checks(readings: Dict[str, float], limits: Dict[str, float]):
    '''The numbers read but not compared (no limit holds them: PERF.md says why), then each
    number compared beside its limit, as the last lines on standard error.'''
    for k, v in readings.items():
        if k not in limits:
            print(f'read {k} {v!r} (not compared)', file=sys.stderr)
    for k, lim in limits.items():
        v = readings.get(k, float('nan'))
        ok = 'ok' if np.isfinite(v) and v <= lim else 'FAIL'
        print(f'check {k} {v!r} limit {lim!r} {ok}', file=sys.stderr)
    sys.stderr.flush()
