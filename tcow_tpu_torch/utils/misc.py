'''
Miscellaneous utilities: the port's own copy of tcow_tpu/utils/misc.py (:16-153), in
numpy, with torch tensors where the JAX package takes device arrays.

The general-purpose helpers of the reference's utils/my_utils.py not covered elsewhere
(query sampling lives in data/query_sampling.py, checkpoint epoch lookup in
train/checkpoint.py).
'''

import os
import pickle
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def any_value(d: Dict):
    '''First non-None value of a dict (my_utils.py:31-35).'''
    for v in d.values():
        if v is not None:
            return v
    return None


def dict_to_numpy(x, ignore_keys: Sequence[str] = ()):
    '''Recursively converts tensors (on any device) to host numpy (my_utils.py:62-74
    dict_to_cpu).'''
    if isinstance(x, dict):
        return {k: dict_to_numpy(v, ignore_keys) for k, v in x.items()
                if k not in ignore_keys}
    if isinstance(x, (list, tuple)):
        return type(x)(dict_to_numpy(v, ignore_keys) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return x


def is_nan_or_inf(x) -> bool:
    '''(my_utils.py:77-84).'''
    arr = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return bool(np.any(np.isnan(arr)) or np.any(np.isinf(arr)))


def traject_to_track_map(trajectory: np.ndarray, frame_height: int, frame_width: int,
                         map_cell_dim: int) -> np.ndarray:
    '''(T, 2) normalized [x, y] track -> (1, T, Hm, Wm) one-hot heatmap
    (my_utils.py:38-59).'''
    if frame_height % map_cell_dim or frame_width % map_cell_dim:
        raise ValueError(f'map_cell_dim {map_cell_dim} must divide {frame_height}x'
                         f'{frame_width}')
    T = trajectory.shape[0]
    Hm, Wm = frame_height // map_cell_dim, frame_width // map_cell_dim
    heatmap = np.zeros((1, T, Hm, Wm), np.float32)
    for t in range(T):
        cx = int(np.floor(trajectory[t][0] * Wm))
        cy = int(np.floor(trajectory[t][1] * Hm))
        if 0 <= cx < Wm and 0 <= cy < Hm:
            heatmap[0, t, cy, cx] = 1.0
    return heatmap


def get_fourier_positional_encoding_size(num_coords: int, num_frequencies: int) -> int:
    '''(my_utils.py:87-93).'''
    return num_coords * (1 + num_frequencies * 2)


def apply_fourier_positional_encoding(raw_coords, num_frequencies: int,
                                      base_frequency: float = 0.1,
                                      max_frequency: float = 10.0):
    '''Fourier features (identity + cos/sin per frequency) over (*, C) coordinates
    (my_utils.py:96-120). Works on numpy arrays or torch tensors.'''
    if not (num_frequencies > 0 and max_frequency > base_frequency > 0):
        raise ValueError(f'need num_frequencies > 0 and max_frequency > base_frequency > 0, '
                         f'got {num_frequencies}, {max_frequency}, {base_frequency}')
    xp = torch if isinstance(raw_coords, torch.Tensor) else np
    parts = [raw_coords]
    for f in range(num_frequencies):
        freq = f * (max_frequency - base_frequency) / (num_frequencies - 1) + base_frequency
        parts.append(xp.cos(raw_coords * 2.0 * np.pi * freq))
        parts.append(xp.sin(raw_coords * 2.0 * np.pi * freq))
    if xp is torch:
        return torch.cat(parts, dim=-1)
    return np.concatenate(parts, axis=-1)


def disk_cached_call(logger, cache_fp: Optional[str], newer_than: Optional[float],
                     func, *args, **kwargs):
    '''Caches a function result to disk as pickle, invalidating entries older than
    `newer_than` (my_utils.py:191-221). Reads back only files this function wrote.'''
    use_cache = cache_fp is not None and os.path.exists(cache_fp)
    if use_cache and newer_than is not None and os.path.getmtime(cache_fp) < newer_than:
        if logger is not None:
            logger.info(f'Deleting too old cached result at {cache_fp}...')
        os.remove(cache_fp)
        use_cache = False
    if use_cache:
        with open(cache_fp, 'rb') as f:
            return pickle.load(f)
    result = func(*args, **kwargs)
    if cache_fp is not None:
        os.makedirs(os.path.dirname(cache_fp) or '.', exist_ok=True)
        with open(cache_fp, 'wb') as f:
            pickle.dump(result, f)
    return result


def calculate_iou(pred: np.ndarray, target: np.ndarray) -> float:
    '''Binary mask IoU at 0.5 thresholds (my_utils.py:224-253).'''
    if pred.shape != target.shape:
        raise ValueError(f'shapes differ: {pred.shape} vs {target.shape}')
    p = pred > 0.5
    t = target > 0.5
    union = np.sum(p | t)
    return float(np.sum(p & t) / union) if union > 0 else float('nan')


def read_txt_strip_comments(txt_fp: str) -> List[str]:
    '''(my_utils.py:256-262).'''
    with open(txt_fp, 'r') as f:
        lines = [x.split('#')[0].strip() for x in f.readlines()]
    return [x for x in lines if x]


def quick_pca(array: np.ndarray, k: int = 3, unique_features: bool = False,
              normalize=None) -> np.ndarray:
    '''PCA to k components over the last axis, optionally fit on unique feature rows, with
    min/max normalization (my_utils.py:144-176). Used for embedding visualizations.'''
    import sklearn.decomposition
    n = array.shape[-1]
    flat = array.reshape(-1, n)
    pca = sklearn.decomposition.PCA(n_components=k)
    pca.fit(np.unique(flat, axis=0) if unique_features else flat)
    result = pca.transform(flat).reshape(*array.shape[:-1], k)
    if normalize is not None:
        axes = tuple(range(array.ndim - 1))
        lo = result.min(axis=axes, keepdims=True)
        hi = result.max(axis=axes, keepdims=True)
        result = (result - lo) / (hi - lo)
        result = result * (normalize[1] - normalize[0]) + normalize[0]
    return result.astype(np.float32)


def st(x) -> str:
    '''Shape/dtype one-liner for interactive debugging (reference __init__.py:73-83).'''
    arr = np.asarray(x) if not hasattr(x, 'shape') else x
    return f'{tuple(arr.shape)} {arr.dtype}'


def mmm(x) -> str:
    '''min/mean/max one-liner for interactive debugging (reference __init__.py:73-83).'''
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x, dtype=np.float64)
    return f'min {arr.min():.5f} mean {arr.mean():.5f} max {arr.max():.5f}'


def stmmm(x) -> str:
    return f'{st(x)} {mmm(x)}'
