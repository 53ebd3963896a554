'''idle_share.infer: the share of the traced requests' window in which nothing
ran on the card, in %.'''

from perfbench.core import readers


def read(rec):
    return readers.idle_share(rec, 'infer')
