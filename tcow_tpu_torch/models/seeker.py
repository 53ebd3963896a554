'''
Seeker facade: a SeekerConfig with its MaskTracker on one device (the port of
tcow_tpu/models/seeker.py:17-45).
'''

from typing import Any, Dict, Optional

import torch

from tcow_tpu_torch import resolve_device
from tcow_tpu_torch.models.mask_tracker import MaskTracker, SeekerConfig, seeker_config_from_args
from tcow_tpu_torch.train import checkpoint as ckpt_lib
from tcow_tpu_torch.weights import params_from_jax


class Seeker:

    def __init__(self, cfg: SeekerConfig, params: Optional[Dict[str, Any]] = None,
                 seed: int = 0, device='cuda'):
        '''params: the JAX-layout tree of numpy arrays; None initialises from `seed`.'''
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = MaskTracker(cfg, device=self.device)
        if params is None:
            self.model.init_params_(torch.Generator().manual_seed(seed))
        else:
            self.model.load_state_dict(params_from_jax(params))
        self.model.eval()

    @classmethod
    def from_seeker_args(cls, seeker_args: Dict[str, Any], seed: int = 0, device='cuda',
                         **overrides) -> 'Seeker':
        return cls(seeker_config_from_args(seeker_args, **overrides), seed=seed, device=device)

    @classmethod
    def from_checkpoint(cls, path: str, device='cuda') -> 'Seeker':
        if path.endswith('.pth'):
            raise NotImplementedError('.pth checkpoints are not ported yet; use .npz')
        state = ckpt_lib.load_checkpoint(path)
        return cls(seeker_config_from_args(state['seeker_args']), state['params'],
                   device=device)

    def __call__(self, input_frames, query_mask, frame_times=None):
        '''(B,3,T,H,W), (B,1,T,H,W) -> (mask_logits (B,3,T,H,W), flags (B,T,F)).
        frame_times (B, T): true source timestamps, read under temporal_rope.'''
        with torch.inference_mode():
            ft = None if frame_times is None else torch.as_tensor(frame_times,
                                                                  device=self.device)
            return self.model(torch.as_tensor(input_frames, device=self.device),
                              torch.as_tensor(query_mask, device=self.device),
                              frame_times=ft)
