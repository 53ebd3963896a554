'''
Query instance sampling: desirability scoring + elitist-shuffled selection. The port's
copy of tcow_tpu/data/query_sampling.py; the same RNG draws in the same order, so the same
seed selects the same queries.
'''

from typing import Optional

import numpy as np

DESIRABILITY_WEIGHTS = (3.0, 4.0, 64.0, 256.0, 1.0, 16.0)


def get_thing_traject_desirability(div_segm: np.ndarray, occl_fracs: np.ndarray,
                                   query_time: int, shape=None,
                                   mask_counts=None) -> np.ndarray:
    '''Per-instance query desirability from occlusion dynamics / mask motion / visibility.

    :param div_segm (K, Tc, Hf, Wf) {0,1} amodal masks (post-augmentation); may be None
        when mask_counts is given.
    :param occl_fracs (K, Tc, 3) float32 (f, v, t) (post-augmentation).
    :param query_time int.
    :param shape (K, Tc, Hf, Wf) when div_segm is None.
    :param mask_counts optional (area_tk (Tc, K) int64, delta_kt (K, Tc) int64) from the
        native fused gather: per-frame mask pixel counts and consecutive-frame change
        counts. Sums of 0/1 values below 2^24 are exact in f32, so the count-based means
        are bit-identical to the array reductions.
    :return (K, 7) float32: weighted score then the six constituents
        (avg_occl_frac, norm_total_var_mask, significance_hard, init_vis_size_hard,
        init_vis_rel_soft, init_vis_rel_hard); negative weighted => never sample.
    '''
    K, T, H, W = div_segm.shape if div_segm is not None else shape
    avg_occl_frac = occl_fracs[:, :, 0].mean(axis=1)                       # (K,)

    if mask_counts is not None:
        area_tk, delta_kt = mask_counts
        max_area = area_tk.T.max(axis=1) / (H * W)                         # (K,) f64
        delta_mean = (delta_kt[:, 1:].sum(axis=1).astype(np.float32)
                      / np.float32((T - 1) * H * W))
    else:
        # Bool compare + f32-accumulated mean: no int16/f32 materializations of the
        # (K, T-1, H, W) stack (~125 MB/item saved); numpy's pairwise summation over the
        # same 0.0/1.0 values makes the mean bit-identical to the old float32-array mean.
        delta = div_segm[:, 1:] != div_segm[:, :-1]
        max_area = div_segm.reshape(K, T, -1).sum(axis=-1).max(axis=1) / (H * W)
        delta_mean = delta.reshape(K, -1).mean(axis=1, dtype=np.float32)
    norm_total_var = delta_mean / (max_area + 1e-6)                        # (K,)

    significance_hard = np.minimum(occl_fracs[:, :, 1].mean(axis=1) * 10000.0, 1.0) - 1.0
    init_vis_size_hard = np.minimum(occl_fracs[:, query_time, 1] * 2500.0, 1.0) - 1.0
    init_vis_rel_soft = 1.0 - occl_fracs[:, query_time, 0]
    init_vis_rel_hard = np.minimum(init_vis_rel_soft * 5.0, 1.0) - 1.0

    parts = np.stack([avg_occl_frac, norm_total_var, significance_hard, init_vis_size_hard,
                      init_vis_rel_soft, init_vis_rel_hard], axis=1)       # (K, 6)
    weighted = parts @ np.asarray(DESIRABILITY_WEIGHTS, np.float64)
    return np.concatenate([weighted[:, None], parts], axis=1).astype(np.float32)


def elitist_shuffle(items: np.ndarray, inequality: float,
                    rng: Optional[np.random.Generator] = None) -> np.ndarray:
    '''Rank-biased shuffle: higher-ranked items keep a higher probability of staying
    highly ranked.'''
    if rng is None:
        rng = np.random.default_rng()
    weights = np.power(np.linspace(1, 0, num=len(items), endpoint=False), inequality)
    weights = weights / weights.sum()
    return rng.choice(items, size=len(items), replace=False, p=weights)


def sample_query_inds(B: int, Qs: int, inst_count: np.ndarray,
                      target_desirability: np.ndarray, phase: str,
                      rng: Optional[np.random.Generator] = None) -> np.ndarray:
    '''Selects Qs query instances per example: desirability-ranked,
    elitist-shuffled at train time (inequality 9), deterministic top-Qs at test, with the
    last slot uniformly resampled with prob clip(0.2 + Qs*0.1, 0.3, 0.5) for balance.

    :param inst_count (B,) int: valid (VALO) instance count per example.
    :param target_desirability (B, M, >=1) float.
    :return (B, Qs) int32.
    '''
    if rng is None:
        rng = np.random.default_rng()
    sel = np.zeros((B, Qs), np.int32)
    for b in range(B):
        Qt = int(inst_count[b])
        to_rank = np.asarray(target_desirability[b, :Qt, 0], np.float64)
        ranking = np.argsort(to_rank)[::-1]
        valid = ranking[to_rank[ranking] >= 0.0]
        num_valid = len(valid)
        if num_valid < Qs:
            raise ValueError(f'Not enough valid queries for batch index {b}.')
        if 'test' not in phase:
            rough = elitist_shuffle(valid, inequality=9, rng=rng)
        else:
            rough = valid
        sel[b, :] = rough[:Qs]
        if 'test' not in phase:
            random_prob = np.clip(0.2 + Qs * 0.1, 0.3, 0.5)
            if rng.random() < random_prob:
                idx = int(rng.integers(Qs - 1, num_valid))
                sel[b, -1] = rough[idx]
    return sel
