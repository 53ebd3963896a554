'''peak_mem_gb.train: the largest device memory the process held allocated
(torch.cuda.max_memory_allocated) over set-up and window, in GB (1e9 bytes): which batch fits.'''

from perfbench.core import readers


def read(rec):
    if not readers.of_kind(rec, 'train') or rec['peak_bytes'] <= 0:
        return None
    return rec['peak_bytes'] / 1e9
