"""Host-side 2D geometry: convex hull, minimum-area rectangles, point-IoU.

Port of `radargnn_tpu/utils/geometry.py` (numpy, unchanged): a
monotone-chain hull and rotating-calipers min-area rectangle, vectorized
point-in-box tests and the discrete point-IoU. The compiled helper
(radargnn_tpu_torch.native) is used when it builds; these numpy
implementations are the reference semantics.
"""

from __future__ import annotations

import numpy as np


# --------------------------------------------------------------------------
# Box corners / representations
# --------------------------------------------------------------------------

def get_box_corners(x: float, y: float, l: float, w: float, theta_deg: float) -> np.ndarray:
    """Corner points of a rotated box [x, y, l, w, theta(deg)].

    Corner order matches `utils/math.py:9-46`: (+l/2,+w/2), (+l/2,-w/2),
    (-l/2,-w/2), (-l/2,+w/2) in the box frame, rotated by theta then translated.
    """
    corners = np.array([[l / 2, w / 2],
                        [l / 2, -w / 2],
                        [-l / 2, -w / 2],
                        [-l / 2, w / 2]], dtype=np.float64)
    t = np.deg2rad(theta_deg)
    rot = np.array([[np.cos(t), -np.sin(t)], [np.sin(t), np.cos(t)]])
    return corners @ rot.T + np.array([x, y])


def box_area_rotated(box_matrix: np.ndarray) -> np.ndarray:
    """Areas of rotated boxes [..., (x, y, l, w, theta)]. Parity: `utils/math.py:49-58`."""
    return box_matrix[:, 2] * box_matrix[:, 3]


# --------------------------------------------------------------------------
# Point-in-box tests
# --------------------------------------------------------------------------

def is_point_in_rect(rect: np.ndarray, point: np.ndarray) -> bool:
    """True if `point` lies inside the quadrilateral `rect` (4×2 corners).

    Triangle-area-sum test, identical tolerance (1e-6) to `utils/math.py:61-96`.
    """
    return bool(points_in_rect_mask(rect, np.asarray(point, dtype=np.float64).reshape(1, 2))[0])


def points_in_rect_mask(rect: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Vectorized triangle-area-sum inclusion test for many points.

    rect: (4,2) corners in clockwise or counter-clockwise order.
    points: (N,2). Returns bool mask (N,).
    """
    xA, yA = rect[0]
    xB, yB = rect[1]
    xC, yC = rect[2]
    xD, yD = rect[3]
    xP = points[:, 0]
    yP = points[:, 1]

    abcd = 0.5 * abs((yA - yC) * (xD - xB) + (yB - yD) * (xA - xC))

    abp = 0.5 * np.abs(xA * (yB - yP) + xB * (yP - yA) + xP * (yA - yB))
    bcp = 0.5 * np.abs(xB * (yC - yP) + xC * (yP - yB) + xP * (yB - yC))
    cdp = 0.5 * np.abs(xC * (yD - yP) + xD * (yP - yC) + xP * (yC - yD))
    dap = 0.5 * np.abs(xD * (yA - yP) + xA * (yP - yD) + xP * (yD - yA))

    return (abp + bcp + cdp + dap - abcd) < 1e-6


def get_points_in_rotated_box(box: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Points inside a rotated box [x, y, l, w, theta(deg)]. Parity: `utils/math.py:99-125`."""
    box = np.asarray(box, dtype=np.float64)
    corners = get_box_corners(box[0], box[1], box[2], box[3], box[4])
    mask = points_in_rect_mask(corners, np.asarray(points, dtype=np.float64))
    return np.asarray(points)[mask, :]


def get_points_in_box(box: np.ndarray, points: np.ndarray) -> np.ndarray:
    """Points inside an aligned box [x_min, y_min, x_max, y_max]. Parity: `utils/math.py:128-147`."""
    box = np.asarray(box, dtype=np.float64)
    x_min, y_min, x_max, y_max = box[:4]
    mask = ((points[:, 0] >= x_min) & (points[:, 0] <= x_max)
            & (points[:, 1] >= y_min) & (points[:, 1] <= y_max))
    return points[mask, :]


# --------------------------------------------------------------------------
# Discrete (point-based) IoU
# --------------------------------------------------------------------------

def get_stats_of_predicted_box_points(box_points_predict: np.ndarray,
                                      box_points_true: np.ndarray) -> tuple:
    """tp/fp/fn between two point sets (set semantics). Parity: `utils/math.py:150-164`."""
    aset = {tuple(x) for x in box_points_predict}
    bset = {tuple(x) for x in box_points_true}
    tp = len(aset & bset)
    fn = box_points_true.shape[0] - tp
    fp = box_points_predict.shape[0] - tp
    return tp, fp, fn


def get_discrete_iou(tp: int, fp: int, fn: int) -> float:
    """Discrete point IoU with the reference's 1e-5 empty fallback (`utils/math.py:167-173`)."""
    denom = tp + fp + fn
    return tp / denom if denom != 0 else 0.00001


def point_iou(boxes_pred: np.ndarray, boxes_gt: np.ndarray, points: np.ndarray,
              box_aligned: bool) -> np.ndarray:
    """Pairwise discrete point-IoU matrix between box sets. Parity: `utils/math.py:176-211`.

    Vectorized: one membership matrix per box set (B×N bool), then IoU from
    set-intersection counts — the reference's per-pair Python loop with
    identical semantics (membership of *distinct point coordinates*).
    """
    boxes_pred = np.asarray(boxes_pred, dtype=np.float64)
    boxes_gt = np.asarray(boxes_gt, dtype=np.float64)
    points = np.asarray(points, dtype=np.float64)

    # The reference counts tp over *distinct* coordinates (set semantics) but
    # counts |pred| / |gt| over raw points (duplicates included).
    uniq = np.unique(points, axis=0) if points.size else points.reshape(0, 2)

    def membership(boxes, pts):
        if boxes.shape[0] == 0 or pts.shape[0] == 0:
            return np.zeros((boxes.shape[0], pts.shape[0]), dtype=bool)
        if box_aligned:
            b = boxes[:, :4, None]                            # [B, 4, 1]
            return ((pts[None, :, 0] >= b[:, 0])
                    & (pts[None, :, 0] <= b[:, 2])
                    & (pts[None, :, 1] >= b[:, 1])
                    & (pts[None, :, 1] <= b[:, 3]))
        # batched rotated membership: corners for ALL boxes at once, then
        # one broadcast triangle-area inclusion test [B, N] (replaces the
        # per-box Python loop — full-dataset eval no longer scales with
        # detection count in interpreter time)
        x, y, l, w = (boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3])
        t = np.deg2rad(boxes[:, 4])
        ct, st = np.cos(t), np.sin(t)
        bx = np.stack([l / 2, l / 2, -l / 2, -l / 2], axis=1)  # [B, 4]
        by = np.stack([w / 2, -w / 2, -w / 2, w / 2], axis=1)
        cx = bx * ct[:, None] - by * st[:, None] + x[:, None]  # [B, 4]
        cy = bx * st[:, None] + by * ct[:, None] + y[:, None]
        nxt = [1, 2, 3, 0]
        abcd = 0.5 * np.abs((cy[:, 0] - cy[:, 2]) * (cx[:, 3] - cx[:, 1])
                            + (cy[:, 1] - cy[:, 3]) * (cx[:, 0] - cx[:, 2]))
        px, py = pts[None, None, :, 0], pts[None, None, :, 1]  # [1,1,N]
        x1, y1 = cx[:, :, None], cy[:, :, None]                # [B,4,1]
        x2, y2 = cx[:, nxt, None], cy[:, nxt, None]
        tri = 0.5 * np.abs(x1 * (y2 - py) + x2 * (py - y1)
                           + px * (y1 - y2))                   # [B,4,N]
        return (tri.sum(axis=1) - abcd[:, None]) < 1e-6

    mu_p = membership(boxes_pred, uniq).astype(np.int64)
    mu_g = membership(boxes_gt, uniq).astype(np.int64)
    tp = mu_p @ mu_g.T                                         # |pred ∩ gt| (unique)

    n_pred = membership(boxes_pred, points).sum(axis=1)[:, None]   # |pred| (raw)
    n_gt = membership(boxes_gt, points).sum(axis=1)[None, :]       # |gt| (raw)
    union = n_pred + n_gt - tp
    iou = np.where(union != 0, tp / np.maximum(union, 1), 0.00001)
    return iou


# --------------------------------------------------------------------------
# Minimum bounding rectangles
# --------------------------------------------------------------------------

def convex_hull(points: np.ndarray) -> np.ndarray:
    """Monotone-chain convex hull, counter-clockwise, no repeated last point.

    Replaces the reference's qhull dependency (`utils/math.py:415`).
    """
    pts = np.unique(np.asarray(points, dtype=np.float64), axis=0)
    if pts.shape[0] <= 2:
        return pts
    # lexicographic sort (x, then y)
    order = np.lexsort((pts[:, 1], pts[:, 0]))
    pts = pts[order]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points_iter):
        chain = []
        for p in points_iter:
            while len(chain) >= 2 and cross2(chain[-2], chain[-1], p) <= 0:
                chain.pop()
            chain.append(p)
        return chain

    lower = half(pts)
    upper = half(pts[::-1])
    hull = np.array(lower[:-1] + upper[:-1])
    return hull


def minimum_bounding_rectangle_without_rotation(points: np.ndarray) -> np.ndarray:
    """Axis-aligned minimum rectangle; corner order matches `utils/math.py:284-299`:
    (x_min,y_min), (x_min,y_max), (x_max,y_min), (x_max,y_max)."""
    x_min, y_min = points[:, 0].min(), points[:, 1].min()
    x_max, y_max = points[:, 0].max(), points[:, 1].max()
    return np.array([[x_min, y_min], [x_min, y_max],
                     [x_max, y_min], [x_max, y_max]], dtype=np.float64)


def minimum_bounding_rectangle_with_rotation(points: np.ndarray) -> np.ndarray:
    """Minimum-area enclosing rotated rectangle via rotating calipers on the hull.

    Functional parity with `minimum_bounding_rectangle_with_rotation_alternative`
    (`utils/math.py:302-439`): iterate hull edges, project hull onto the edge
    direction and its orthogonal, take the minimum-area candidate. Returns the
    4 corner points (4×2) in (+,+), (+,-), (-,-), (-,+) order of the box frame.
    """
    points = np.asarray(points, dtype=np.float64)
    from radargnn_tpu_torch import native
    res = native.min_area_rect(points)
    if res is not None:
        return res
    hull = convex_hull(points)
    if hull.shape[0] <= 2:
        raise ValueError("More than two points required.")

    edges = np.roll(hull, -1, axis=0) - hull                   # (H,2)
    lengths = np.linalg.norm(edges, axis=1)
    keep = lengths > 0
    u = edges[keep] / lengths[keep, None]                       # unit edge dirs (H,2)
    o = np.stack([-u[:, 1], u[:, 0]], axis=1)                   # orthogonals

    proj_p = u @ hull.T                                        # (H, Nh)
    proj_o = o @ hull.T

    min_p, max_p = proj_p.min(axis=1), proj_p.max(axis=1)
    min_o, max_o = proj_o.min(axis=1), proj_o.max(axis=1)
    len_p, len_o = max_p - min_p, max_o - min_o
    areas = len_p * len_o
    i = int(np.argmin(areas))

    center = (u[i] * (min_p[i] + len_p[i] / 2)
              + o[i] * (min_o[i] + len_o[i] / 2))
    half_p = u[i] * len_p[i] / 2
    half_o = o[i] * len_o[i] / 2
    return np.array([center + half_p + half_o,
                     center + half_p - half_o,
                     center - half_p - half_o,
                     center - half_p + half_o])


# Alias mirroring the reference public name (`utils/math.py:304`).
minimum_bounding_rectangle_with_rotation_alternative = \
    minimum_bounding_rectangle_with_rotation
