'''
Evaluation metrics as masked reductions on tensors: the port of
tcow_tpu/objectives/metrics.py (:19-108).

Binary IoU (output logit > 0 vs target > 0.5) per (batch, query, channel, frame) for six
families; frames with empty or negative (unannotated) targets are excluded, and each
family reports a (sum, count) pair, finalized to mean_* / count_* (mean -1.0 when the
count is 0). With a process group the sums cover every rank's rows.
'''

from typing import Dict, List

import numpy as np
import torch

from tcow_tpu_torch.parallel.mesh import all_sum

METRIC_KEYS = ('snitch_iou', 'occl_mask_iou', 'cont_mask_iou',
               'snitch_during_vis_iou', 'snitch_during_occl_iou', 'snitch_during_cont_iou')


def mask_track_metric_sums(output_mask: torch.Tensor, target_mask: torch.Tensor,
                           group=None) -> Dict[str, torch.Tensor]:
    '''
    :param output_mask (B, Q, Co, T, H, W) logits, Co in {1, 3}.
    :param target_mask (B, Q, Ct, T, H, W), Ct in {1, 3}; negative values mark unannotated.
    :param group process group whose ranks' rows form the batch (one all_reduce), or None.
    :return dict mapping 'sum_<k>' / 'count_<k>' to f32 scalar tensors.
    '''
    out_b, tgt_b = torch.broadcast_tensors(output_mask > 0.0, target_mask > 0.5)
    Ct = target_mask.shape[2]

    inter = (out_b & tgt_b).sum(dim=(-2, -1)).float()   # (B, Q, C, T)
    union = (out_b | tgt_b).sum(dim=(-2, -1)).float()
    area = tgt_b.sum(dim=(-2, -1)).float()
    iou = inter / (union + 1e-7)
    has = area > 0
    none = torch.zeros_like(has[:, :, 0])
    sums, counts = {}, {}

    def family(name, valid, values):
        sums[f'sum_{name}'] = torch.where(valid, values, 0.0).sum()
        counts[f'count_{name}'] = valid.sum().float()

    family('snitch_iou', has[:, :, 0], iou[:, :, 0])
    if Ct >= 2:
        family('occl_mask_iou', has[:, :, 1], iou[:, :, 1])
        family('snitch_during_vis_iou', has[:, :, 0] & ~has[:, :, 1], iou[:, :, 0])
        family('snitch_during_occl_iou', has[:, :, 0] & has[:, :, 1], iou[:, :, 0])
    else:
        for name in ('occl_mask_iou', 'snitch_during_vis_iou', 'snitch_during_occl_iou'):
            family(name, none, iou[:, :, 0])
    if Ct >= 3:
        family('cont_mask_iou', has[:, :, 2], iou[:, :, 2])
        family('snitch_during_cont_iou', has[:, :, 0] & has[:, :, 2], iou[:, :, 0])
    else:
        for name in ('cont_mask_iou', 'snitch_during_cont_iou'):
            family(name, none, iou[:, :, 0])

    sums.update(counts)
    if group is not None:
        keys = list(sums)
        sums = dict(zip(keys, all_sum(torch.stack([sums[k] for k in keys]), group).unbind(0)))
    return sums


def finalize_metric_sums(sums: Dict[str, object]) -> Dict[str, float]:
    '''(sum, count) pairs -> the reference's metrics_retval schema of mean_*/count_* values.'''
    out = {}
    for k in METRIC_KEYS:
        count = float(sums[f'count_{k}'])
        total = float(sums[f'sum_{k}'])
        out[f'mean_{k}'] = total / (count + 1e-7) if count > 0 else -1.0
        out[f'count_{k}'] = int(round(count))
    return out


def calculate_metrics_mask_track(output_mask: torch.Tensor, target_mask: torch.Tensor
                                 ) -> Dict[str, float]:
    '''The reference-format dict of one batch (metrics.py:81-83 of the JAX package).'''
    return finalize_metric_sums(mask_track_metric_sums(output_mask, target_mask))


def calculate_weighted_averages(metrics_retvals: List[Dict[str, float]]) -> Dict[str, float]:
    '''Frame-weighted aggregation across batches.'''
    final = {}
    for k in METRIC_KEYS:
        counts = np.array([m[f'count_{k}'] for m in metrics_retvals], dtype=np.float64)
        means = np.array([m[f'mean_{k}'] for m in metrics_retvals], dtype=np.float64)
        new_count = counts.sum()
        final[f'count_{k}'] = new_count
        final[f'mean_{k}'] = float((means * counts).sum() / (new_count + 1e-7)) \
            if new_count > 0 else -1.0
    return final


def calculate_unweighted_averages(metrics_retvals: List[Dict[str, float]],
                                  exclude_value: float = -1.0) -> Dict[str, float]:
    '''Per-scene aggregation ignoring invalid entries.'''
    final = {}
    for k in METRIC_KEYS:
        values = np.array([m[f'mean_{k}'] for m in metrics_retvals], dtype=np.float64)
        filtered = values[values != exclude_value]
        final[f'count_{k}'] = len(filtered)
        final[f'mean_{k}'] = float(filtered.mean()) if len(filtered) > 0 else float('nan')
    return final
