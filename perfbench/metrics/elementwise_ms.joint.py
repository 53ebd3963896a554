'''elementwise_ms.joint: what metrics/elementwise_ms.train.py reads, in train.joint, whose
clips per second are train_clips_per_s.joint.'''

from perfbench.core import readers


def read(rec):
    return readers.group_ms_per_unit(rec, 'train', exclude=('attn', 'gemm', 'copy', 'optimizer'))
