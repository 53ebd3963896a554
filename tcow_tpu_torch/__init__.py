'''
PyTorch + CUDA port of tcow_tpu for NVIDIA Hopper (H100).

The JAX package `tcow_tpu` is the reference; this package mirrors its layout (models/,
ops/, objectives/, evaluation/, train/) and imports nothing from it. Entry points run on
the GPU unless the caller passes device='cpu'; without CUDA a GPU request raises.
'''

import torch


def resolve_device(device='cuda') -> torch.device:
    '''The device an entry point runs on. A CUDA request on a machine without CUDA raises
    instead of carrying on quietly on the CPU.'''
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is False; "
                           "pass device='cpu' to run on the CPU")
    return device
