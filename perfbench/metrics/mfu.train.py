'''mfu.train: the training step's needed operations (core/flops.step_flops: three
forwards, no remat recompute) times the steps of the measured window, over its seconds and
the bf16 peak, in %.'''

from perfbench.core import readers


def read(rec):
    return readers.mfu(rec, 'train')
