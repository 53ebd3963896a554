'''mfu.joint: what metrics/mfu.train.py reads, in train.joint, whose clips per second are
train_clips_per_s.joint.'''

from perfbench.core import readers


def read(rec):
    return readers.mfu(rec, 'train')
