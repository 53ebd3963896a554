'''elementwise_ms.train: device ms per step of every kernel that is neither
attention, GEMM, copy nor optimizer (kernel_groups/): the torch ops of the seeker, the
backbone and the losses.'''

from perfbench.core import readers


def read(rec):
    return readers.group_ms_per_unit(rec, 'train', exclude=('attn', 'gemm', 'copy', 'optimizer'))
