'''
Per-query supervision targets built on the device: the port of
tcow_tpu/objectives/supervision.py (`fill_query_target_batch` :32-122), vectorised over
(B examples, Q queries) instead of two vmaps.

For each (example, query): the query mask (visible snitch at the query frame), the
occluder-pointer map (visible instance ID + 1 at amodal-snitch pixels that are hidden),
the target mask (amodal snitch; frontmost occluder; outermost container), the occluder and
container IDs + 1 per frame, and the per-frame flags (occluded, contained, occluded
fraction). argmax / argmin ties resolve to the lowest instance index, as in JAX.
'''

from typing import Dict

import torch


def fill_query_target_batch(segm, div_segm, query_inds, qt_idx, occl_fracs, occl_cont_dag,
                            front_occl_thres: float = 0.95, outer_cont_thres: float = 0.75
                            ) -> Dict[str, torch.Tensor]:
    '''
    :param segm (B, T, H, W) int: 1-based visible instance IDs (0 = background).
    :param div_segm (B, M, T, H, W): binary amodal masks per (padded) instance.
    :param query_inds (B, Q) int in [0, M).
    :param qt_idx int or 0-d tensor: the shared query frame.
    :param occl_fracs (B, M, T, 3) f32 with (f, v, t).
    :param occl_cont_dag (B, T, M, M, 3) f32 with (c, od, of), indexed (ref, cand).
    :return dict of (B, Q, ...) tensors: seeker_query_mask (1, T, H, W) f32,
        snitch_occl_by_ptr (1, T, H, W) int32, full_occl_cont_id (T, 2) int32,
        target_mask (3, T, H, W) f32, target_flags (T, 3) f32.
    '''
    B, T, H, W = segm.shape
    Q = query_inds.shape[1]
    dev = segm.device
    segm = segm.to(torch.int32)
    div = div_segm.to(torch.int32)
    qi = query_inds.long()
    bi = torch.arange(B, device=dev)[:, None].expand(B, Q)

    snitch_div = div[bi, qi]                                      # (B, Q, T, H, W)
    visible = segm[:, None] == (qi + 1)[..., None, None, None]    # (B, Q, T, H, W)
    is_qt = (torch.arange(T, device=dev) == qt_idx)[:, None, None]
    query_mask = visible & is_qt

    occl_pixels = (snitch_div == 1) & ~visible
    snitch_occl_by_ptr = torch.where(occl_pixels, segm[:, None], 0)
    target0 = snitch_div == 1

    def pick_instance(ids):
        '''Amodal mask of instance ids (B, Q, T) at each frame -> (B, Q, T, H, W).'''
        t = torch.arange(T, device=dev)
        return div[bi[..., None], ids, t]

    # Frontmost occluder per frame (data_utils.py:454-461 of the reference).
    of_rows = occl_cont_dag[..., 2].transpose(1, 2)[bi, qi]       # (B, Q, T, M) of[q, cand]
    snitch_occl_frac = occl_fracs[..., 0][bi, qi]                 # (B, Q, T)
    front_cond = (snitch_occl_frac >= front_occl_thres) & \
        (of_rows.amax(dim=-1) >= front_occl_thres / 2.0)
    front_id = of_rows.argmax(dim=-1)                             # (B, Q, T)
    target1 = front_cond[..., None, None] & (pick_instance(front_id) == 1)

    # Outermost container per frame: among the instances containing the snitch at
    # >= outer_cont_thres, the one least contained by anything else.
    cont = occl_cont_dag[..., 0]                                  # (B, T, M, M)
    c_rows = cont.transpose(1, 2)[bi, qi]                         # (B, Q, T, M) c[q, cand]
    cont_cond = c_rows.amax(dim=-1) >= outer_cont_thres
    cand_score = cont.amax(dim=-1)[:, None]                       # (B, 1, T, M)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=dev)
    outer_id = torch.where(c_rows >= outer_cont_thres, cand_score, big).argmin(dim=-1)
    target2 = cont_cond[..., None, None] & (pick_instance(outer_id) == 1)

    full_occl_cont_id = torch.stack([torch.where(front_cond, front_id + 1, 0),
                                     torch.where(cont_cond, outer_id + 1, 0)],
                                    dim=-1).to(torch.int32)
    target_flags = torch.stack([front_cond.float(), cont_cond.float(),
                                snitch_occl_frac.float()], dim=-1)
    target_mask = torch.stack([target0, target1, target2], dim=2).float()
    return {
        'seeker_query_mask': query_mask.float()[:, :, None],            # (B, Q, 1, T, H, W)
        'snitch_occl_by_ptr': snitch_occl_by_ptr.to(torch.int32)[:, :, None],
        'full_occl_cont_id': full_occl_cont_id,                         # (B, Q, T, 2)
        'target_mask': target_mask,                                     # (B, Q, 3, T, H, W)
        'target_flags': target_flags,                                   # (B, Q, T, 3)
    }
