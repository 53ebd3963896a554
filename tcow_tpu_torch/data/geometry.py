'''
3-D geometry helpers for containment estimation: the port's copy of
tcow_tpu/data/geometry.py. Containment fraction = the fraction of a 6x6x6 sample grid of
the candidate oriented bounding box that lies inside the outer OBB.
'''

import numpy as np


def box_to_tf_matrix(box: np.ndarray) -> np.ndarray:
    '''(8, 3) OBB corners -> (4, 4) object-to-world transform. The first corner is the
    origin; the second is assumed adjacent; the two remaining orthogonal edge directions are
    searched among the other corners.'''
    origin = box[0]
    axis1 = box[1] - origin
    axis2 = axis3 = None
    for i in range(2, 8):
        cand = box[i] - origin
        if axis2 is None:
            if abs(np.dot(axis1, cand)) < 1e-7:
                axis2 = cand
        elif axis3 is None:
            if abs(np.dot(axis1, cand)) < 1e-7 and abs(np.dot(axis2, cand)) < 1e-7:
                axis3 = cand
    if axis2 is None or axis3 is None:
        raise ValueError('could not find orthogonal box axes')
    m = np.stack([axis1, axis2, axis3, origin], axis=1)
    return np.concatenate([m, [[0.0, 0.0, 0.0, 1.0]]], axis=0)


_GRID = None


def _unit_grid() -> np.ndarray:
    global _GRID
    if _GRID is None:
        x, y, z = np.meshgrid(*([np.linspace(0, 1, 6)] * 3), indexing='ij')
        pts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
        _GRID = np.concatenate([pts, np.ones((pts.shape[0], 1))], axis=1)  # (216, 4)
    return _GRID


def get_containment_fraction_approx(inside_box: np.ndarray, outside_box: np.ndarray) -> float:
    '''Scalar version of get_containment_fraction_matrix.'''
    return float(get_containment_fraction_matrix(inside_box[None], outside_box[None])[0, 0])


def get_containment_fraction_matrix(inside_boxes: np.ndarray,
                                    outside_boxes: np.ndarray) -> np.ndarray:
    '''Vectorized all-pairs containment: inside_boxes (A, 8, 3), outside_boxes (B, 8, 3) ->
    (A, B) fractions of each inside box's sample grid lying inside each outside box.'''
    A = inside_boxes.shape[0]
    B = outside_boxes.shape[0]
    tf_in = np.stack([box_to_tf_matrix(b) for b in inside_boxes])        # (A, 4, 4)
    tf_out = np.stack([box_to_tf_matrix(b) for b in outside_boxes])      # (B, 4, 4)
    world_to_out = np.linalg.inv(tf_out)                                  # (B, 4, 4)
    pts = _unit_grid()                                                    # (P, 4)
    pts_world = np.einsum('aij,pj->api', tf_in, pts)                      # (A, P, 4)
    warped = np.einsum('bij,apj->abpi', world_to_out, pts_world)          # (A, B, P, 4)
    xyz = warped[..., :3]
    inside = np.logical_and((xyz >= 0.0).all(axis=-1), (xyz <= 1.0).all(axis=-1))
    return inside.mean(axis=-1).astype(np.float32)                        # (A, B)
