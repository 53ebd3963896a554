'''copy_ms.infer: device ms per request of the host<->device copies and memsets
(the copy group: Memcpy HtoD and DtoH of the numpy inputs and outputs).'''

from perfbench.core import readers


def read(rec):
    return readers.group_ms_per_unit(rec, 'infer', groups=('copy',))
