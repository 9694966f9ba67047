"""Ground-truth label creation: per-node class labels + 2D box encodings.

Port of `radargnn_tpu/data/ground_truth.py` (numpy, unchanged): per-object
minimum bounding rectangles with the three invariance encodings ("none" /
"translation" / "en"), the special cases for 1-point (0.5×0.5 box) and
2-point objects, NaN rows for background, angles stored in radians.
"""

from __future__ import annotations

import numpy as np

from radargnn_tpu_torch.ops.knn import nearest_neighbor_host
from radargnn_tpu_torch.postprocess import boxes as bx
from radargnn_tpu_torch.utils.geometry import (
    minimum_bounding_rectangle_with_rotation,
    minimum_bounding_rectangle_without_rotation,
)


def build_one_hot_vectors(label_id: np.ndarray, num_classes: int = 6) -> np.ndarray:
    """Parity: `dataset_creation.py:238-245`."""
    labels = np.asarray(label_id).reshape(-1).astype(int)
    target = np.zeros([labels.shape[0], num_classes])
    target[np.arange(labels.shape[0]), labels] = 1
    return target


def _object_groups(track_ids: np.ndarray):
    ids = np.asarray(track_ids).reshape(-1)
    uniq = [u for u in np.unique(ids) if u != b"" and u != ""]
    for u in uniq:
        yield np.where(ids == u)[0]


def create_2d_bounding_boxes(pos: np.ndarray, track_ids: np.ndarray,
                             aligned: bool, bb_invariance: str) -> np.ndarray:
    """Per-node GT boxes; background nodes get NaN rows.

    Parity: `GroundTruthCreator.create_2D_bounding_boxes`
    (`dataset_creation.py:247-521`). Angles returned in **radians** (columns
    1 and 4 for "en", column 4 otherwise), matching `:399-405,446-452`.
    """
    pos = np.asarray(pos, dtype=np.float64)
    if aligned:
        return _aligned_boxes(pos, track_ids)
    return _rotated_boxes(pos, track_ids, bb_invariance)


def _aligned_boxes(pos: np.ndarray, track_ids: np.ndarray) -> np.ndarray:
    out = np.full((pos.shape[0], 4), np.nan)
    for idx in _object_groups(track_ids):
        if idx.shape[0] == 1:
            out[idx] = [0.0, 0.0, 0.5, 0.5]
        else:
            rect = minimum_bounding_rectangle_without_rotation(pos[idx])
            corners = np.broadcast_to(rect, (idx.shape[0], 4, 2))
            out[idx] = bx.absolute_corners_to_relative_aligned(corners, pos[idx])
    return out


def _rotated_boxes(pos: np.ndarray, track_ids: np.ndarray,
                   bb_invariance: str) -> np.ndarray:
    if bb_invariance not in ("none", "translation", "en"):
        raise ValueError("Wrong invariance for bounding box selection")

    n = pos.shape[0]
    out = np.full((n, 5), np.nan)
    nn_pos = None
    if bb_invariance == "en" and n > 1:
        nn_pos = pos[nearest_neighbor_host(pos)]

    # pass 1 — per-object geometry (min-area rect / connection vector);
    # the box-algebra transforms are batched over ALL object nodes after
    rel = np.full((n, 5), np.nan)        # relative-rotated encoding
    corners = np.zeros((n, 4, 2))
    multi = np.zeros(n, bool)            # >= 3-point objects
    for idx in _object_groups(track_ids):
        pts = pos[idx]
        if idx.shape[0] == 1:
            # single radar target: fixed 0.5×0.5 box centered on the point
            if bb_invariance == "none":
                x, y = pos[idx[0], 0], pos[idx[0], 1]
            else:
                x, y = 0.0, 0.0
            out[idx] = [x, y, 0.5, 0.5, 0.0]
            continue
        if idx.shape[0] == 2:
            # long side = connection vector; width fixed 0.5
            p1, p2 = pts[0], pts[1]
            c = (p1 + p2) / 2
            v_l = p2 - p1
            theta = np.degrees(np.arctan2(v_l[1], v_l[0]))
            theta = theta + 180.0 if theta < 0 else theta
            theta = theta - 180.0 if theta >= 180.0 - 1e-9 else theta  # canonical [0,180)
            l, w = np.linalg.norm(v_l), 0.5
            rel[idx] = np.stack([c[0] - pts[:, 0], c[1] - pts[:, 1],
                                 np.full(2, l), np.full(2, w),
                                 np.full(2, theta)], axis=1)
            continue
        # ≥ 3 points: minimum-area rotated rectangle, shared by the object
        corners[idx] = minimum_bounding_rectangle_with_rotation(pts)
        multi[idx] = True

    # pass 2 — one batched box-algebra call per transform
    if multi.any():
        rel[multi] = bx.absolute_to_relative_rotated(corners[multi],
                                                     pos[multi])
    obj = np.isfinite(rel[:, 0])         # all 2- and >=3-point object nodes
    if obj.any():
        if bb_invariance == "none":
            enc = rel[obj].copy()
            enc[:, 0] += pos[obj, 0]
            enc[:, 1] += pos[obj, 1]
        elif bb_invariance == "translation":
            enc = rel[obj]
        else:  # en
            enc = bx.relative_rotated_to_rotation_invariant(
                rel[obj], pos[obj], nn_pos[obj])
        out[obj] = _deg_to_rad_cols(enc, bb_invariance)
    return out


def _deg_to_rad_cols(enc: np.ndarray, bb_invariance: str) -> np.ndarray:
    enc = enc.copy()
    if bb_invariance == "en":
        enc[:, 1] = np.deg2rad(enc[:, 1])
    enc[:, 4] = np.deg2rad(enc[:, 4])
    return enc
