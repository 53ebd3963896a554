'''attn_roofline.joint: what metrics/attn_roofline.train.py reads, in train.joint, whose clips
per second are train_clips_per_s.joint.'''

from perfbench.core import readers


def read(rec):
    return readers.roofline(rec, 'train', 'attn')
