'''
The traced sub-window: torch.profiler over a few steps or requests after the measured
window, reduced to a record that the per-layer metric readers (metrics/<name>.py) read.

A record holds lists of events, each (name, start_us, end_us): 'device' (kernels, copies
and memsets that ran on the card) and 'host' (the CUDA runtime calls the host made), and
the traced window's length on the host clock. Kernels are put in groups
by the kernel_groups files: a kernel goes to the first group (by 'order') one of whose
patterns its name contains, and to 'other' when none does.
'''

import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

Event = Tuple[str, float, float]


def profile(fn: Callable[[], None], units: int, sync: Callable[[], None]) -> Dict:
    '''Runs fn `units` times under torch.profiler with CUDA activity alone (the kernels,
    copies and memsets, and the host's CUDA runtime calls; no operator events, stacks or
    shapes, so that the host runs near its untraced pace) and returns {'window_s',
    'device', 'host'}. The window runs from a device sync before the first call to one
    after the last.'''
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(units):
            fn()
        sync()
        window_s = time.perf_counter() - t0
    device, host = [], []
    for ev in prof.events():
        item = (ev.name, float(ev.time_range.start), float(ev.time_range.end))
        (device if ev.device_type == DeviceType.CUDA else host).append(item)
    return {'window_s': window_s, 'device': device, 'host': host}


def group_of(name: str, groups: Sequence[Dict]) -> str:
    for g in groups:
        if any(p in name for p in g['patterns']):
            return g['name']
    return 'other'


def group_seconds(device: List[Event], groups: Sequence[Dict]) -> Dict[str, float]:
    '''Device seconds of each kernel group (a group with no kernel is absent).'''
    out: Dict[str, float] = {}
    for name, s, e in device:
        g = group_of(name, groups)
        out[g] = out.get(g, 0.0) + (e - s) / 1e6
    return out


def busy_intervals(device: List[Event]) -> List[Tuple[float, float]]:
    '''The union of the device events' intervals, in order, in microseconds.'''
    merged: List[List[float]] = []
    for s, e in sorted((s, e) for _, s, e in device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_seconds(device: List[Event]) -> float:
    return sum(e - s for s, e in busy_intervals(device)) / 1e6


def top_ops(device: List[Event], n: int = 10) -> List[List]:
    '''The n device operations (by name) that took most time: [[name, seconds], ...].'''
    total: Dict[str, float] = {}
    for name, s, e in device:
        total[name] = total.get(name, 0.0) + (e - s) / 1e6
    return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]


def host_at(host: List[Event], t: float) -> Optional[str]:
    '''The innermost host event running at time t (the latest to start among those that
    cover it).'''
    best = None
    for name, s, e in host:
        if s <= t < e and (best is None or s >= best[1]):
            best = (name, s)
    return None if best is None else best[0]


def idle_gaps(device: List[Event], host: List[Event], n: int = 10) -> List[List]:
    '''The n longest gaps between device activity, each named by what the host was doing
    when the gap began (its CUDA runtime call, or none: Python and torch on the host):
    [[name, seconds], ...].'''
    iv = busy_intervals(device)
    gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1]) for i in range(len(iv) - 1)),
                  reverse=True)[:n]
    return [[host_at(host, start) or 'host, no CUDA call', dur / 1e6]
            for dur, start in gaps if dur > 0]
