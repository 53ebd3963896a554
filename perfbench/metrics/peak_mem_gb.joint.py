'''peak_mem_gb.joint: what metrics/peak_mem_gb.train.py reads, in train.joint, whose clips per
second are train_clips_per_s.joint.'''

from perfbench.core import readers


def read(rec):
    if not readers.of_kind(rec, 'train') or rec['peak_bytes'] <= 0:
        return None
    return rec['peak_bytes'] / 1e9
