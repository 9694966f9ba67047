"""Vectorized 2D bounding-box algebra — all three invariance encodings.

Port of `radargnn_tpu/postprocess/boxes.py` (numpy, unchanged): pure array
functions over batches of boxes.

  encodings (B = 5 columns unless noted):
    absolute rotated     [x, y, l, w, θ]         (bb_invariance == "none")
    relative rotated     [x_rel, y_rel, l, w, θ] ("translation")
    rotation invariant   [d, θ_pnn_pc, l, w, θ_pnn_dir]  ("en")
    relative aligned     [x_rel, y_rel, dx, dy]  (4 columns, aligned boxes)

  θ conventions: degrees in these helpers (converted to rad at the dataset
  boundary); box θ ∈ [0, 180).
"""

from __future__ import annotations

import numpy as np


def _wrap_0_360(x: np.ndarray) -> np.ndarray:
    return np.mod(x, 360.0)


def _wrap_0_180(x: np.ndarray) -> np.ndarray:
    return np.mod(x, 180.0)


def corners_from_absolute(boxes: np.ndarray) -> np.ndarray:
    """[B,5] (x,y,l,w,θdeg) → [B,4,2] corners, vectorized."""
    boxes = np.asarray(boxes, dtype=np.float64)
    l, w = boxes[:, 2], boxes[:, 3]
    base = np.stack([
        np.stack([l / 2, w / 2], -1), np.stack([l / 2, -w / 2], -1),
        np.stack([-l / 2, -w / 2], -1), np.stack([-l / 2, w / 2], -1)],
        axis=1)                                        # [B,4,2]
    t = np.deg2rad(boxes[:, 4])
    rot = np.stack([np.stack([np.cos(t), -np.sin(t)], -1),
                    np.stack([np.sin(t), np.cos(t)], -1)], axis=1)  # [B,2,2]
    return np.einsum("bij,bkj->bki", rot, base) + boxes[:, None, :2]


def corners_to_xylwt(corners: np.ndarray) -> np.ndarray:
    """[B,4,2] corners → [B,5] (x_center, y_center, l, w, θdeg∈[0,180)).

    Parity with `BoundingBox.get_absolute_rotated_box_representations`
    (`bounding_box.py:466-528`): among the three distances from corner 0, the
    smallest is the width, the middle the length; the direction of the
    length-matching pair gives θ.
    """
    corners = np.asarray(corners, dtype=np.float64)
    p1 = corners[:, 0]
    diffs = p1[:, None, :] - corners[:, 1:, :]         # [B,3,2] p1-p2, p1-p3, p1-p4
    d = np.linalg.norm(diffs, axis=-1)                 # [B,3]
    order = np.argsort(d, axis=1)                      # w, l, diag
    w = np.take_along_axis(d, order[:, :1], axis=1)[:, 0]
    l = np.take_along_axis(d, order[:, 1:2], axis=1)[:, 0]
    # The reference picks the *first* pair (p1-p2, p1-p3, p1-p4 order) whose
    # distance equals l; argsort is stable so order[:,1] reproduces that
    # except for exact w==l ties, where it also takes the earlier index.
    v_l = np.take_along_axis(
        diffs, order[:, 1:2, None].repeat(2, -1), axis=1)[:, 0]
    c = corners.mean(axis=1)
    theta = np.degrees(np.arctan2(v_l[:, 1], v_l[:, 0]))
    theta = np.where(theta < 0, 180.0 + theta, theta)
    # canonicalize the measure-zero θ≈180 boundary to 0 so forward and
    # inverse ("en") encodings agree (the reference leaves 180 here,
    # `bounding_box.py:383-385`, while its inverse wraps to [0,180)).
    theta = np.where(theta >= 180.0 - 1e-9, theta - 180.0, theta)
    return np.stack([c[:, 0], c[:, 1], l, w, theta], axis=1)


def aligned_corners_to_two_point(corners: np.ndarray) -> np.ndarray:
    """[B,4,2] → [B,4] (x_min, y_min, x_max, y_max)."""
    corners = np.asarray(corners, dtype=np.float64)
    return np.concatenate([corners.min(axis=1), corners.max(axis=1)], axis=1)


# --------------------------------------------------------------------------
# relative ↔ absolute
# --------------------------------------------------------------------------

def relative_aligned_to_absolute_corners(boxes: np.ndarray,
                                         points: np.ndarray) -> np.ndarray:
    """[B,4] (x_rel, y_rel, dx, dy) + [B,2] points → [B,4,2] corners.

    Corner order (±dx/2, ±dy/2) as `RelativeAlignedBoundingBox:291-312`.
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    c = points[:, :2] + boxes[:, :2]
    dx, dy = boxes[:, 2] / 2, boxes[:, 3] / 2
    return np.stack([
        np.stack([c[:, 0] + dx, c[:, 1] + dy], -1),
        np.stack([c[:, 0] + dx, c[:, 1] - dy], -1),
        np.stack([c[:, 0] - dx, c[:, 1] - dy], -1),
        np.stack([c[:, 0] - dx, c[:, 1] + dy], -1)], axis=1)


def relative_rotated_to_absolute(boxes: np.ndarray,
                                 points: np.ndarray) -> np.ndarray:
    """[B,5] (x_rel, y_rel, l, w, θdeg) + points [B,2] → absolute [B,5]."""
    boxes = np.asarray(boxes, dtype=np.float64)
    out = boxes.copy()
    out[:, 0] = points[:, 0] + boxes[:, 0]
    out[:, 1] = points[:, 1] + boxes[:, 1]
    return out


def absolute_to_relative_rotated(corners: np.ndarray,
                                 points: np.ndarray) -> np.ndarray:
    """[B,4,2] corners + per-box reference points → [B,5] relative rotated."""
    xylwt = corners_to_xylwt(corners)
    xylwt[:, 0] -= points[:, 0]
    xylwt[:, 1] -= points[:, 1]
    return xylwt


def absolute_corners_to_relative_aligned(corners: np.ndarray,
                                         points: np.ndarray) -> np.ndarray:
    """[B,4,2] aligned-box corners + points → [B,4] (x_rel, y_rel, dx, dy).

    Corner layout from `minimum_bounding_rectangle_without_rotation`
    (`bounding_box.py:396-416`: dx = |c1.x−c3.x|, dy = |c1.y−c2.y|).
    """
    corners = np.asarray(corners, dtype=np.float64)
    c = corners.mean(axis=1)
    dx = np.abs(corners[:, 0, 0] - corners[:, 2, 0])
    dy = np.abs(corners[:, 0, 1] - corners[:, 1, 1])
    return np.stack([c[:, 0] - points[:, 0], c[:, 1] - points[:, 1],
                     dx, dy], axis=1)


# --------------------------------------------------------------------------
# rotation-invariant ("en") encoding
# --------------------------------------------------------------------------

def relative_rotated_to_rotation_invariant(boxes: np.ndarray,
                                           points: np.ndarray,
                                           nn_points: np.ndarray) -> np.ndarray:
    """[B,5] relative rotated (θdeg) → [B,5] rotation invariant (deg).

    Parity: `RelativeRotatedBoundingBox
    .relative_rotated_bb_to_rotation_invariant_representation`
    (`bounding_box.py:205-272`), vectorized; the while-loop wraps become
    modular arithmetic after the same 5-decimal rounding.
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    v_p_nn = nn_points[:, :2] - points[:, :2]
    v_p_c = boxes[:, :2]
    theta = boxes[:, 4]

    v_dir = np.stack([np.ones_like(theta), np.tan(np.deg2rad(theta))], -1)
    theta_v_dir_x = np.degrees(np.arctan2(v_dir[:, 1], v_dir[:, 0]))
    theta_v_p_nn_x = np.degrees(np.arctan2(v_p_nn[:, 1], v_p_nn[:, 0]))

    theta_pnn_dir = _wrap_0_180(
        _wrap_0_360(np.round(theta_v_dir_x - theta_v_p_nn_x, 5)))

    d = np.linalg.norm(v_p_c, axis=-1)
    theta_v_p_c_x = np.degrees(np.arctan2(v_p_c[:, 1], v_p_c[:, 0]))
    theta_pnn_pc = np.where(
        d == 0, 0.0, _wrap_0_360(np.round(theta_v_p_c_x - theta_v_p_nn_x, 5)))

    return np.stack([d, theta_pnn_pc, boxes[:, 2], boxes[:, 3],
                     theta_pnn_dir], axis=1)


def rotation_invariant_to_relative_rotated(boxes: np.ndarray,
                                           points: np.ndarray,
                                           nn_points: np.ndarray) -> np.ndarray:
    """Inverse transform: [B,5] rotation invariant (deg) → relative rotated.

    Parity: `RotationInvariantRelativeRotatedBoundingBox
    .rotation_invariant_representation_to_relative_rotated_bb`
    (`bounding_box.py:97-153`).
    """
    boxes = np.asarray(boxes, dtype=np.float64)
    d, theta_pnn_pc, l, w, theta_pnn_dir = boxes.T

    v_p_nn = nn_points[:, :2] - points[:, :2]
    theta_v_p_nn_x = np.degrees(np.arctan2(v_p_nn[:, 1], v_p_nn[:, 0]))

    theta_v_dir_x = _wrap_0_180(
        _wrap_0_360(np.round(theta_pnn_dir + theta_v_p_nn_x, 5)))

    theta_v_p_c_x = theta_pnn_pc + theta_v_p_nn_x
    theta_v_p_c_x = np.where(theta_v_p_c_x > 360, theta_v_p_c_x - 360,
                             theta_v_p_c_x)

    x_c = d * np.cos(np.deg2rad(theta_v_p_c_x))
    y_c = d * np.sin(np.deg2rad(theta_v_p_c_x))
    return np.stack([x_c, y_c, l, w, theta_v_dir_x], axis=1)


def rotation_invariant_to_absolute_corners(boxes: np.ndarray,
                                           points: np.ndarray,
                                           nn_points: np.ndarray) -> np.ndarray:
    """[B,5] "en" boxes (deg) → [B,4,2] absolute corners."""
    rel = rotation_invariant_to_relative_rotated(boxes, points, nn_points)
    absolute = relative_rotated_to_absolute(rel, points)
    return corners_from_absolute(absolute)
