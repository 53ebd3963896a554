'''mfu.infer: a request's needed operations (one forward of its clips) times the
requests of the measured window, over its seconds and the bf16 peak, in %.'''

from perfbench.core import readers


def read(rec):
    return readers.mfu(rec, 'infer')
