'''
Objective functions for hierarchical mask tracking: the port of
tcow_tpu/objectives/losses.py (everything `compute_losses` :233-275 reaches), as masked
reductions on tensors with no host reads.

  - weighted BCE (or focal) per pixel, with frame weights (occlusion-scaled, query-frame
    discount) times pixel weights (class balancing, occluded-snitch doubling, hard
    negatives);
  - AOT-style bootstrapped BCE: the mean of the top-k pixel losses with
    k = floor(clip(1 - 8.5 progress, 0.15, 1) * numel), by a fixed 48-step threshold
    bisection that stays on the device;
  - soft Jaccard / Tversky (alpha = beta = 1, eps = 0.1);
  - per-channel gating of the occluder and container losses with a small always-on weight;
  - total = track * track_lw + occl * occl_mask_lw + cont * cont_mask_lw.

`group` (a torch.distributed process group, as DataMesh.group gives it; None for one
process) makes every whole-batch reduction global, as the JAX package's are under a data
mesh and as balance_axis_name does for the class-balancing counts (:141-161): the
class-balancing counts, n_sel, the masked sums and mean(final_weights) of the mask loss,
the Tversky sums, the top-k bisection's extremes and counts. Each rank then computes the
global-batch loss from its own rows, and its gradient is its rows' share of the global
gradient (parallel/mesh.py). Every rank must call with the same shapes: numel counts
them as the rank's times the world size. compute_losses runs the mask channels together
(mask_losses): their sums share one all_reduce and their bisections run in lockstep, one
all_reduce of the channels' counts per iteration, 56 collectives a microbatch in all.
'''

import dataclasses
from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tcow_tpu_torch.parallel.mesh import all_max, all_min, all_sum, all_sums


@dataclasses.dataclass(frozen=True)
class LossConfig:
    track_lw: float = 1.0
    occl_mask_lw: float = 0.5
    cont_mask_lw: float = 0.5
    occluded_weight: float = 5.0
    occl_cont_zero_weight: float = 0.02
    class_balancing: bool = True
    focal_loss: bool = False
    aot_loss: float = 0.8
    hard_negative_factor: float = 3.0
    front_occl_thres: float = 0.95
    outer_cont_thres: float = 0.75
    # True reproduces the reference's query-frame down-weighting of only the last example
    # of the batch (losses.py:47-54 of the JAX package).
    qt_downweight_last_only: bool = False


def bce_with_logits(logits, targets):
    '''Numerically stable elementwise BCEWithLogits.'''
    return torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, alpha: float = 0.25, gamma: float = 2.0):
    '''torchvision.ops.sigmoid_focal_loss semantics (reduction=none).'''
    p = torch.sigmoid(logits)
    ce = bce_with_logits(logits, targets)
    p_t = p * targets + (1.0 - p) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        alpha_t = alpha * targets + (1.0 - alpha) * (1.0 - targets)
        loss = alpha_t * loss
    return loss


def _world(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def topk_mean_masked(values, mask, k, num_iters: int = 48, group=None, rows: bool = False):
    '''Mean of the k largest `values` where mask is True, k an integer tensor (at least 1
    is used). Threshold bisection: #(values > t) is monotone in t, so after num_iters
    halvings the bracket [lo, hi] is at float resolution; ties at the threshold count at
    hi (losses.py:74-99). Runs on the device with no host read; with a group, over every
    rank's values. With rows, values[i] and mask[i] are independent problems with k[i]
    (the mask channels), bisected in lockstep: one all_reduce of the rows' counts per
    iteration.'''
    if not rows:
        return topk_mean_masked(values[None], mask[None], k.reshape(1), num_iters, group,
                                rows=True)[0]
    C = values.shape[0]
    values, mask = values.reshape(C, -1), mask.reshape(C, -1)
    big = torch.tensor(3.4e38, dtype=torch.float32, device=values.device)
    vm = torch.where(mask, values, -big)
    lo = all_min(torch.where(mask, values, big), group, rows=True)
    hi = all_max(vm, group, rows=True)
    k = torch.clamp(k, min=1)
    for _ in range(num_iters):
        mid = 0.5 * (lo + hi)
        too_many = all_sum((vm > mid[:, None]).sum(1), group) > k
        lo, hi = torch.where(too_many, mid, lo), torch.where(too_many, hi, mid)
    above = vm > hi[:, None]
    cnt_above = all_sum(above.sum(1), group)
    sum_above = all_sum(torch.where(above, vm, 0.0).sum(1), group)
    return (sum_above + (k - cnt_above) * hi) / k


def _tversky_sums(logits, target, sel_f):
    '''The five sums of the soft Jaccard / Tversky loss (losses.py tversky_loss) over all
    but the leading axis: selected elements, target, true positives, false positives,
    false negatives.'''
    dims = tuple(range(1, logits.dim()))
    p0 = torch.sigmoid(logits)
    return torch.stack([sel_f.sum(dims), (target * sel_f).sum(dims),
                        (p0 * target * sel_f).sum(dims),
                        (p0 * (1.0 - target) * sel_f).sum(dims),
                        ((1.0 - p0) * target * sel_f).sum(dims)])


def _tversky_from_sums(sums, alpha, beta, eps):
    '''The loss from the (global) sums; 0 where the selected target is empty.'''
    n, t_sum, numer, fp, fn = sums.unbind(0)
    n = torch.clamp(n, min=1.0)
    t_mean = t_sum / n
    denom = numer + alpha * fp + beta * fn
    loss = 1.0 - numer / (denom + eps)
    return torch.where(t_mean >= 1e-6, loss, 0.0)


def mask_track_frame_weights(sel_occl_fracs, query_time, cfg: LossConfig):
    '''(B, Q, T, 3) occlusion fractions -> (B, Q, T) frame weights.'''
    w = torch.clamp(sel_occl_fracs[..., 0] * cfg.occluded_weight, min=1.0)
    B, _, T = w.shape
    is_qt = torch.arange(T, device=w.device) == query_time
    if cfg.qt_downweight_last_only and B > 1:
        is_qt = is_qt & (torch.arange(B, device=w.device) == B - 1)[:, None, None]
    return torch.where(is_qt, w * 0.2, w)


def _dilate_binary(mask, band: int):
    '''(..., H, W) binary dilation with a band x band square (band odd): a stride-1 max
    pool with band // 2 padding, as reduce_window with SAME padding (losses.py:129-138).'''
    *lead, H, W = mask.shape
    x = mask.reshape(-1, 1, H, W).float()
    y = F.max_pool2d(x, band, stride=1, padding=band // 2)
    return (y > 0.0).reshape(*lead, H, W)


def mask_track_pixel_weights(target_mask, snitch_occl_by_ptr, cfg: LossConfig,
                             no_hard_negatives: bool = False, group=None):
    '''(B, Q, T, H, W) target and occluder-pointer maps -> pixel weights; with a group the
    class balance counts every rank's pixels (balance_axis_name, losses.py:141-161).'''
    B, Q, T, H, W = target_mask.shape
    w = torch.ones(target_mask.shape, dtype=torch.float32, device=target_mask.device)

    if cfg.class_balancing:
        pos_mask = target_mask == 1.0
        neg_mask = target_mask == 0.0
        numel = float(target_mask.numel() * _world(group))
        pos_cnt, neg_cnt = all_sums(group, pos_mask.sum(dtype=torch.float32),
                                    neg_mask.sum(dtype=torch.float32))
        pos_frac = torch.clamp(pos_cnt / numel, min=0.05)
        neg_frac = torch.clamp(neg_cnt / numel, min=0.05)
        ratio = torch.minimum(pos_frac, neg_frac) / torch.maximum(pos_frac, neg_frac)
        # The smaller class gets ratio**-0.3 (boost), the larger ratio**0.7 (damp).
        boost, damp = ratio ** -0.3, ratio ** 0.7
        pos_is_minority = pos_frac <= neg_frac
        pos_corr = torch.where(pos_is_minority, boost, damp)
        neg_corr = torch.where(pos_is_minority, damp, boost)
        w = w * torch.where(neg_mask, neg_corr, 1.0) * torch.where(pos_mask, pos_corr, 1.0)

    w = torch.where(snitch_occl_by_ptr != 0, w * 2.0, w)

    if cfg.hard_negative_factor > 1.0 and not no_hard_negatives:
        band = int((H * W) ** 0.5 / 12.0)
        if band % 2 == 0:
            band += 1
        hard_neg = _dilate_binary(target_mask, band) & (target_mask < 0.5)
        w = torch.where(hard_neg, w * cfg.hard_negative_factor, w)
    return w


def mask_losses(logits, target, final_weights, progress, apply_weights_for_aot, cfg: LossConfig,
                group=None):
    '''The mask loss (losses.py my_mask_loss) of each channel c of (C, B, Q, T, H, W)
    tensors, with apply_weights_for_aot[c]: a (C,) tensor. Frames whose weights are all
    zero drop out of every reduction; each loss is scaled by sqrt(selected fraction). The
    channels' sums share one all_reduce and their bisections run in lockstep
    (topk_mean_masked with rows).'''
    C = logits.shape[0]
    dims = tuple(range(1, logits.dim()))
    which_frames = (final_weights != 0.0).any(dim=-1).any(dim=-1)     # (C, B, Q, T)
    sel = which_frames[..., None, None].expand(logits.shape)
    sel_f = sel.float()
    numel = float(logits[0].numel() * _world(group))

    loss_fn = sigmoid_focal_loss if cfg.focal_loss else bce_with_logits
    loss_bce = loss_fn(logits, target)
    sums = [sel_f.sum(dims), (loss_bce * final_weights * sel_f).sum(dims),
            final_weights.sum(dims)]
    # Tversky for the channels whose Jaccard term is not the bootstrap.
    jac = [c for c in range(C) if not apply_weights_for_aot[c]] if cfg.aot_loss > 0.0 else []
    if jac:
        sums += _tversky_sums(logits[jac], target[jac], sel_f[jac]).unbind(0)
    sums = all_sum(torch.cat(sums), group)
    n_sel, weighted, weights = sums[:3 * C].view(3, C).unbind(0)
    n_safe = torch.clamp(n_sel, min=1.0)
    loss_mask_custom = weighted / n_safe

    if cfg.aot_loss > 0.0:
        aot_weights = torch.stack([final_weights[c] if apply_weights_for_aot[c]
                                   else torch.ones_like(final_weights[c]) for c in range(C)])
        loss_for_aot = loss_bce * aot_weights
        topk_frac = torch.clamp(1.0 - progress * 8.5, 0.15, 1.0)
        k = torch.floor(topk_frac * n_sel).to(torch.int32)
        loss_bootstrap = topk_mean_masked(loss_for_aot, sel, k, group=group, rows=True)
        loss_jaccard = list(loss_bootstrap.unbind(0))
        if jac:
            tv = _tversky_from_sums(sums[3 * C:].view(5, len(jac)), 1.0, 1.0, 0.1)
            for i, c in enumerate(jac):
                loss_jaccard[c] = tv[i]
        loss_aot = (loss_bootstrap + torch.stack(loss_jaccard)) / 2.0
        loss_mask = loss_aot * cfg.aot_loss + loss_mask_custom * (1.0 - cfg.aot_loss)
    else:
        loss_mask = loss_mask_custom

    loss_mask = loss_mask * torch.sqrt(n_sel / numel)
    valid = (n_sel > 0.0) & (weights / numel >= 1e-4)
    return torch.where(valid, loss_mask, 0.0)


def compute_losses(cfg: LossConfig, output_mask, target_mask, sel_occl_fracs,
                   snitch_occl_by_ptr, query_time, progress, group=None) -> Dict[str, Any]:
    '''
    :param output_mask (B, Q, 3, T, H, W) logits.
    :param target_mask (B, Q, 3, T, H, W) f32 in {0, 1}.
    :param sel_occl_fracs (B, Q, T, 3).
    :param snitch_occl_by_ptr (B, Q, 1, T, H, W) integer occluder-ID map.
    :param query_time int or 0-d tensor.
    :param progress float or 0-d f32 tensor in [0, 1].
    :param group process group whose ranks' rows form the batch (None: this batch alone).
    :return dict with 'track', 'occl_mask', 'cont_mask', 'total_seeker' 0-d tensors and
        'snitch_weights' (B, Q, T, H, W).
    '''
    out = {}
    zero = torch.zeros((), dtype=torch.float32, device=output_mask.device)
    progress = torch.as_tensor(progress, dtype=torch.float32, device=output_mask.device)
    snitch_weights = None

    # The channels with a weight, stacked: (C, B, Q, T, H, W) for mask_losses.
    chans, weights, weighted = [], [], []
    if cfg.track_lw > 0.0:
        fw = mask_track_frame_weights(sel_occl_fracs, query_time, cfg)           # (B, Q, T)
        pw = mask_track_pixel_weights(target_mask[:, :, 0], snitch_occl_by_ptr[:, :, 0], cfg,
                                      group=group)
        snitch_weights = fw[..., None, None] * pw
        chans.append((0, 'track'))
        weights.append(snitch_weights)
        weighted.append(False)
    for ch, key, lw in ((1, 'occl_mask', cfg.occl_mask_lw), (2, 'cont_mask', cfg.cont_mask_lw)):
        if lw > 0.0:
            frame_has = (target_mask[:, :, ch] > 0.0).any(dim=-1).any(dim=-1)     # (B, Q, T)
            wch = frame_has.float()[..., None, None].expand(target_mask[:, :, ch].shape)
            chans.append((ch, key))
            weights.append(wch * (1.0 - cfg.occl_cont_zero_weight) + cfg.occl_cont_zero_weight)
            weighted.append(True)
    for key in ('track', 'occl_mask', 'cont_mask'):
        out[key] = zero
    if chans:
        idx = [ch for ch, _ in chans]
        pick = (lambda x: x.movedim(2, 0)) if idx == [0, 1, 2] else (
            lambda x: x[:, :, idx].movedim(2, 0))
        losses = mask_losses(pick(output_mask), pick(target_mask), torch.stack(weights),
                             progress, tuple(weighted), cfg, group)
        for (_, key), loss in zip(chans, losses.unbind(0)):
            out[key] = loss

    out['total_seeker'] = out['track'] * cfg.track_lw + \
        out['occl_mask'] * cfg.occl_mask_lw + out['cont_mask'] * cfg.cont_mask_lw
    if snitch_weights is not None:
        out['snitch_weights'] = snitch_weights
    return out
