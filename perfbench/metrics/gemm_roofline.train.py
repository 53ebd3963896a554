'''gemm_roofline.train: the GEMMs' needed work of a step (three times the
forward's; core/flops.gemms) at the bound, over the device time of the gemm group (the
port's gemm_bias / wgrad kernels and cuBLAS), in %.'''

from perfbench.core import readers


def read(rec):
    return readers.roofline(rec, 'train', 'gemm')
