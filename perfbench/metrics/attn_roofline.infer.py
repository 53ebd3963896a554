'''attn_roofline.infer: the attention cores' needed work of a request's
forward at the bound, over the device time of the attn group, in %.'''

from perfbench.core import readers


def read(rec):
    return readers.roofline(rec, 'infer', 'attn')
