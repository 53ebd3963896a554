'''attn_roofline.train: the attention cores' needed work of a step (forward
scores and P.v, backward dv, dp, dq, dk; core/flops.attention_core) at the bound of the
bf16 peak and HBM bandwidth, over the device time of the attn group, in %.'''

from perfbench.core import readers


def read(rec):
    return readers.roofline(rec, 'train', 'attn')
