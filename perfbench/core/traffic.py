'''
The one traffic generator. A traffic mix (traffic/<name>.json) gives its parameters; the
seed gives the draws, made on the run's device in bulk. Scenes are rectangles that move at
constant speed and wrap at the frame's edges, painted back to front (a higher index is
nearer), so that the visible segmentation, the amodal masks and the occlusion fractions
agree. Every seed gives the same shapes and sizes of work: only the contents differ.

A mix's driver (drivers/<kind>.py) picks what one entry of its pool is:
  train_batch    a training batch in the train step's schema (rgb, segm, div_segm,
                 query_inds, query_time, occl_fracs, occl_cont_dag) as tensors on the
                 device;
  infer_request  a tracking request (rgb, query, target) as float32 numpy arrays in
                 pageable host memory, as a user's process holds them.
'''

from typing import Callable, Dict, List

import numpy as np
import torch


def _stream(seed: int, i: int, device) -> torch.Generator:
    '''The generator of pool entry i of `seed`.'''
    s = int(np.random.SeedSequence([seed, i]).generate_state(1, dtype=np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def scene(gen: torch.Generator, T: int, H: int, W: int, K: int, mix: Dict):
    '''(rgb (3, T, H, W) f32, segm (T, H, W) int32 1-based visible ids, div (K, T, H, W)
    uint8 amodal masks) on the generator's device.'''
    dev = gen.device
    lo, hi = mix['rect_frac']
    u = torch.rand((K, 6), generator=gen, device=dev, dtype=torch.float64)
    extent = torch.tensor([H, W], device=dev, dtype=torch.float64)
    size = (lo + (hi - lo) * u[:, 0:2]) * extent
    pos0 = u[:, 2:4] * extent
    vel = (2.0 * u[:, 4:6] - 1.0) * mix['speed']
    t = torch.arange(T, device=dev, dtype=torch.float64)
    centre = pos0[:, None, :] + vel[:, None, :] * t[None, :, None]          # (K, T, 2)

    def inside(n, axis):
        d = torch.remainder(torch.arange(n, device=dev, dtype=torch.float64)[None, None, :]
                            - centre[:, :, axis, None] + n / 2.0, n) - n / 2.0
        return d.abs() < size[:, None, axis, None] / 2.0                    # (K, T, n)

    div = inside(H, 0)[:, :, :, None] & inside(W, 1)[:, :, None, :]          # (K, T, H, W)
    ids = torch.arange(1, K + 1, device=dev, dtype=torch.int32).reshape(K, 1, 1, 1)
    segm = (div.to(torch.int32) * ids).amax(dim=0)
    colours = 0.1 + 0.8 * torch.rand((K + 1, 3), generator=gen, device=dev)
    noise = torch.randn((T, H, W, 3), generator=gen, device=dev) * mix['noise']
    rgb = (colours[segm.long()] + noise).clamp_(0.0, 1.0).permute(3, 0, 1, 2).contiguous()
    return rgb, segm, div.to(torch.uint8)


def occl_fracs(segm, div):
    '''(K, T, 3) f32: occluded fraction, visible pixels and amodal pixels over the frame's.'''
    K, T, H, W = div.shape
    ids = torch.arange(1, K + 1, device=div.device, dtype=segm.dtype).reshape(K, 1, 1, 1)
    vis = (segm[None] == ids).sum(dim=(2, 3)).double()
    tot = div.sum(dim=(2, 3), dtype=torch.float64)
    f = torch.where(tot > 0, 1.0 - vis / tot.clamp(min=1.0), torch.zeros_like(tot))
    return torch.stack([f, vis / (H * W), tot / (H * W)], dim=-1).float()


def _visible_order(segm_t, K: int):
    '''Instance indices by visible pixels in one frame, most first (ties: lower index).'''
    ids = torch.arange(1, K + 1, device=segm_t.device, dtype=segm_t.dtype).reshape(K, 1, 1)
    vis = (segm_t[None] == ids).sum(dim=(1, 2))
    return torch.sort(-vis, stable=True).indices


def train_batch(gen: torch.Generator, mix: Dict) -> Dict[str, torch.Tensor]:
    '''One training batch of mix['clips'] clips, mix['queries'] queries each.'''
    B, Q, T, H, W = (mix[k] for k in ('clips', 'queries', 'frames', 'height', 'width'))
    M, K, qt = mix['max_instances'], mix['instances'], mix['query_time']
    dev = gen.device
    batch = {'rgb': torch.zeros((B, 3, T, H, W), device=dev),
             'segm': torch.zeros((B, T, H, W), dtype=torch.int32, device=dev),
             'div_segm': torch.zeros((B, M, T, H, W), dtype=torch.uint8, device=dev),
             'query_inds': torch.zeros((B, Q), dtype=torch.int32, device=dev),
             'query_time': torch.tensor(qt, dtype=torch.int32, device=dev),
             'occl_fracs': torch.zeros((B, M, T, 3), device=dev),
             'occl_cont_dag': torch.zeros((B, T, M, M, 3), device=dev)}
    for b in range(B):
        rgb, segm, div = scene(gen, T, H, W, K, mix)
        batch['rgb'][b], batch['segm'][b], batch['div_segm'][b, :K] = rgb, segm, div
        batch['occl_fracs'][b, :K] = occl_fracs(segm, div)
        dag = torch.rand((T, K, K, 3), generator=gen, device=dev) * mix['dag_max']
        dag[:, torch.arange(K), torch.arange(K)] = 0.0
        batch['occl_cont_dag'][b, :, :K, :K] = dag
        batch['query_inds'][b] = _visible_order(segm[qt], K)[:Q].to(torch.int32)
    return batch


def infer_request(gen: torch.Generator, mix: Dict):
    '''One request of mix['clips'] clips as float32 numpy arrays: rgb (B, 3, T, H, W); the
    query (B, 1, T, H, W), the most visible instance's mask at the query frame; the target
    (B, 3, T, H, W): its amodal mask, the amodal mask of the instance that hides most of it
    where at least mix['occluded_at'] of it is hidden, and no container; the last
    mix['unannotated'] frames -1.'''
    B, T, H, W, K = (mix[k] for k in ('clips', 'frames', 'height', 'width', 'instances'))
    qt = mix['query_time']
    dev = gen.device
    rgb = torch.zeros((B, 3, T, H, W), device=dev)
    query = torch.zeros((B, 1, T, H, W), device=dev)
    target = torch.zeros((B, 3, T, H, W), device=dev)
    ids = torch.arange(1, K + 1, device=dev, dtype=torch.int32).reshape(K, 1, 1, 1)
    for b in range(B):
        rgb[b], segm, div = scene(gen, T, H, W, K, mix)
        q = int(_visible_order(segm[qt], K)[0])
        query[b, 0, qt] = (segm[qt] == q + 1).float()
        snitch = div[q].bool()
        target[b, 0] = snitch.float()
        hidden = snitch & (segm != q + 1)                                   # (T, H, W)
        cover = (hidden[None] & (segm[None] == ids)).sum(dim=(2, 3))        # (K, T)
        frac = hidden.sum(dim=(1, 2)) / snitch.sum(dim=(1, 2)).clamp(min=1)
        front = div[cover.argmax(dim=0), torch.arange(T, device=dev)].float()
        target[b, 1] = torch.where((frac >= mix['occluded_at'])[:, None, None], front, 0.0)
        if mix['unannotated']:
            target[b, :, T - mix['unannotated']:] = -1.0
    return tuple(np.ascontiguousarray(x.cpu().numpy()) for x in (rgb, query, target))


def pool(make: Callable, mix: Dict, seed: int, device) -> List:
    '''mix['pool'] entries make(generator, mix), each from its own stream of `seed`, made
    on `device`.'''
    return [make(_stream(seed, i, device), mix) for i in range(mix['pool'])]
