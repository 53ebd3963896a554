'''
What the per-layer metric readers (metrics/<name>.py) share. A reader takes the record of
a run (drivers/train.py, drivers/infer.py: the traced sub-window's events and group seconds,
the needed work per unit, the measured window's units and seconds, the peak memory) and
returns its metric, or None where the record has nothing to read: a reader never returns
0 for a share of a roofline or of a peak.
'''

from perfbench.core import flops


def of_kind(rec, kind: str) -> bool:
    return rec is not None and rec.get('kind') == kind


def mfu(rec, kind: str):
    '''The needed operations of every unit of the measured window over its host-clock
    seconds and the bf16 peak, in %.'''
    if not of_kind(rec, kind) or rec['window']['seconds'] <= 0 or rec['window']['units'] <= 0:
        return None
    done = rec['needed']['flops'] * rec['window']['units']
    return 100.0 * done / (rec['window']['seconds'] * flops.PEAK_BF16_FLOPS)


def roofline(rec, kind: str, group: str):
    '''The least time the group's needed work could take (core/flops.bound) over the
    device time of the group's kernels in the traced sub-window, in %.'''
    if not of_kind(rec, kind):
        return None
    seconds = rec['group_s'].get(group, 0.0)
    if seconds <= 0:
        return None
    least_ms, _ = flops.bound(rec['needed'][f'{group}_flops'], rec['needed'][f'{group}_bytes'])
    return 100.0 * least_ms * rec['units'] / (1e3 * seconds)


def idle_share(rec, kind: str):
    '''One minus the union of device activity over the traced sub-window, in %.'''
    from perfbench.core import trace
    if not of_kind(rec, kind) or rec['window_s'] <= 0 or not rec['device']:
        return None
    return 100.0 * (1.0 - trace.busy_seconds(rec['device']) / rec['window_s'])


def group_ms_per_unit(rec, kind: str, groups=None, exclude=()):
    '''Device ms per unit of the kernels of `groups`, or of every group but `exclude`.'''
    if not of_kind(rec, kind) or rec['units'] <= 0 or not rec['device']:
        return None
    picked = [g for g in rec['group_s'] if (g in groups if groups else g not in exclude)]
    return 1e3 * sum(rec['group_s'][g] for g in picked) / rec['units']
