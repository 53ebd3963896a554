'''idle_share.train: the share of the traced steps' window in which no kernel,
copy or memset ran on the card, in %.'''

from perfbench.core import readers


def read(rec):
    return readers.idle_share(rec, 'train')
