"""Non-maximum suppression of aligned and rotated boxes, on the device of
the boxes.

Port of `radargnn_tpu/postprocess/nms.py` (JAX device code there, not a
Pallas kernel): a vectorized IoU matrix (the rotated IoU by fixed-buffer
Sutherland–Hodgman convex clipping, quad ∩ quad ≤ 8 vertices, over all
pairs at once) and the greedy score-ordered suppression sweep. The sweep
is sequential by nature: the `iou > threshold` matrix is formed on the
device in score order, copied to the host once, and swept there in numpy,
rather than n small launches of a Python loop on the card.

Semantics as in the JAX package: a box is suppressed iff its IoU with a
higher-scoring kept box is strictly greater than the threshold; ties in
score keep their input order (stable sort); kept indices are returned in
descending-score order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from radargnn_tpu_torch.device import DeviceLike, resolve_device

_POLY_BUF = 16  # vertex buffer for clipped polygons (quad∩quad needs ≤ 8)
# rotated IoU pairs formed at once: each pair holds ~2 KB of clip
# intermediates, so a chunk takes ~1 GB
_PAIR_CHUNK = 1 << 19


def aligned_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """IoU of aligned boxes [..., N, 4] × [..., M, 4] in (x1, y1, x2, y2)."""
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    pos = union > 0
    return torch.where(pos, inter / torch.where(pos, union, 1.0),
                       torch.zeros_like(inter))


def _corner_offsets(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, l, w, θdeg CCW) → [..., 4, 2] corners relative to
    the box's centre (CCW order)."""
    l, w = boxes[..., 2], boxes[..., 3]
    t = torch.deg2rad(boxes[..., 4])
    c, s = torch.cos(t)[..., None], torch.sin(t)[..., None]
    dx = torch.stack([l / 2, l / 2, -l / 2, -l / 2], -1)
    dy = torch.stack([-w / 2, w / 2, w / 2, -w / 2], -1)
    return torch.stack([dx * c - dy * s, dx * s + dy * c], dim=-1)


def _box_corners(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, l, w, θdeg CCW) → [..., 4, 2] corners (CCW order)."""
    return _corner_offsets(boxes) + boxes[..., None, :2]


def _wrap_last(verts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """Each vertex's successor in a polygon of `count` vertices held in a
    [..., V, 2] buffer: the last valid vertex wraps back to vertex 0."""
    nxt = torch.roll(verts, -1, dims=-2)
    idx = torch.arange(verts.shape[-2], device=verts.device)
    last = (idx == (count[..., None] - 1))[..., None]
    return torch.where(last, verts[..., :1, :], nxt)


def _clip_polygon(verts: torch.Tensor, count: torch.Tensor,
                  p1: torch.Tensor, p2: torch.Tensor):
    """Clips polygons (verts [..., V, 2], count [...]) by the half-plane left
    of p1→p2 ([..., 2] each); returns the clipped (verts, count)."""
    v = verts
    nxt = _wrap_last(v, count)
    idx = torch.arange(_POLY_BUF, device=v.device)
    edge_valid = idx < count[..., None]

    d = (p2 - p1)[..., None, :]
    p1 = p1[..., None, :]

    def side(q):
        return d[..., 0] * (q[..., 1] - p1[..., 1]) \
            - d[..., 1] * (q[..., 0] - p1[..., 0])

    s_cur, s_nxt = side(v), side(nxt)
    in_cur = s_cur >= 0
    in_nxt = s_nxt >= 0

    denom = s_cur - s_nxt
    nz = denom != 0
    t = torch.where(nz, s_cur / torch.where(nz, denom, 1.0),
                    torch.zeros_like(denom))
    inter = v + t[..., None] * (nxt - v)

    # each input edge emits up to 2 points: the current vertex (if inside)
    # and the intersection (if the edge crosses the line)
    emit_cur = in_cur & edge_valid
    emit_int = (in_cur != in_nxt) & edge_valid

    pts = torch.stack([v, inter], dim=-2).flatten(-3, -2)      # [..., 2V, 2]
    emit = torch.stack([emit_cur, emit_int], dim=-1).flatten(-2)
    # compact the emitted points to the front, in order (a stable sort of
    # the "not emitted" flag), and zero the rest of the buffer
    order = torch.argsort((~emit).to(torch.uint8), dim=-1, stable=True)
    order = order[..., :_POLY_BUF]
    out = torch.gather(pts, -2, order[..., None].expand(
        *order.shape, 2))
    out_count = emit.sum(-1)
    keep = (idx < out_count[..., None])[..., None]
    return torch.where(keep, out, torch.zeros_like(out)), out_count


def _poly_area(verts: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    nxt = _wrap_last(verts, count)
    idx = torch.arange(_POLY_BUF, device=verts.device)
    valid = idx < count[..., None]
    cross = verts[..., 0] * nxt[..., 1] - nxt[..., 0] * verts[..., 1]
    return 0.5 * torch.abs(torch.where(valid, cross,
                                       torch.zeros_like(cross)).sum(-1))


def _pair_intersection_area(corners_a: torch.Tensor,
                            corners_b: torch.Tensor) -> torch.Tensor:
    """Intersection areas of convex quads [..., 4, 2] × [..., 4, 2] (same
    leading shape) by Sutherland–Hodgman."""
    lead = corners_a.shape[:-2]
    verts = torch.zeros(*lead, _POLY_BUF, 2, dtype=corners_a.dtype,
                        device=corners_a.device)
    verts[..., :4, :] = corners_a
    count = torch.full(lead, 4, dtype=torch.long, device=corners_a.device)
    for i in range(4):
        verts, count = _clip_polygon(verts, count, corners_b[..., i, :],
                                     corners_b[..., (i + 1) % 4, :])
    area = _poly_area(verts, count)
    return torch.where(count >= 3, area, torch.zeros_like(area))


def _rotated_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Rotated IoU [F, N, M] of boxes [F, N, 5] × [F, M, 5]. The (frame,
    row) pairs are formed in chunks of at most _PAIR_CHUNK.

    Each pair is clipped in a frame centred on its first box: the shoelace
    area of float32 corners tens of metres from the origin cancels to about
    1e-4 of a small box's area, where corners near the origin keep it near
    float32's resolution (the JAX package clips in absolute coordinates).
    A box of zero area has IoU 0 with every box: clipping by a degenerate
    quad keeps the other quad whole, and its union is then rounding noise.
    """
    f, n, m = a.shape[0], a.shape[1], b.shape[1]
    inter = torch.zeros((f * n, m), dtype=a.dtype, device=a.device)
    if n and m:
        off_a = _corner_offsets(a).reshape(f * n, 4, 2)
        off_b = _corner_offsets(b)                        # [F, M, 4, 2]
        xy_a = a[..., :2].reshape(f * n, 2)
        frame = torch.arange(f * n, device=a.device) // n
        rows = max(1, _PAIR_CHUNK // m)
        for lo in range(0, f * n, rows):
            hi = min(lo + rows, f * n)
            shift = b[frame[lo:hi], :, :2] - xy_a[lo:hi, None]  # [r, M, 2]
            inter[lo:hi] = _pair_intersection_area(
                off_a[lo:hi, None].expand(-1, m, -1, -1),
                off_b[frame[lo:hi]] + shift[..., None, :])
    inter = inter.reshape(f, n, m)
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    pos = (union > 0) & (area_a[..., :, None] > 0) & (area_b[..., None, :] > 0)
    return torch.where(pos, inter / torch.where(pos, union, 1.0),
                       torch.zeros_like(inter))


def rotated_iou_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact rotated IoU [N, M] for boxes [*, 5] = (x, y, l, w, θdeg)."""
    return _rotated_iou(a[None], b[None])[0]


def batched_iou_matrices(det: torch.Tensor, gt: torch.Tensor,
                         rotated: bool) -> torch.Tensor:
    """All frames' IoU matrices in one batched computation: det [F, Dmax,
    4|5], gt [F, Gmax, 4|5] (zero-padded rows: l = w = 0 boxes have IoU 0
    against everything) → [F, Dmax, Gmax]."""
    return _rotated_iou(det, gt) if rotated else aligned_iou_matrix(det, gt)


def _greedy_sweep(suppress: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The greedy sweep over boxes in score order: `suppress[i, j]` is
    iou_s[i, j] > threshold; a kept valid box i drops every later j it
    suppresses. Returns the keep mask in score order."""
    keep = valid.copy()
    n = keep.shape[0]
    for i in range(n):
        if keep[i]:
            keep[i + 1:] &= ~suppress[i, i + 1:]
    return keep


def nms_keep_mask(boxes: torch.Tensor, scores: torch.Tensor,
                  iou_threshold: float, rotated: bool,
                  valid: torch.Tensor = None) -> torch.Tensor:
    """Greedy NMS on the device of `boxes`. Returns the bool keep mask
    aligned with the input order (on that device)."""
    n = boxes.shape[0]
    dev = boxes.device
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    ranked = torch.where(valid, scores,
                         torch.full_like(scores, -math.inf))
    order = torch.argsort(-ranked, stable=True)
    b = boxes[order]
    iou_s = rotated_iou_matrix(b, b) if rotated else aligned_iou_matrix(b, b)
    suppress = (iou_s > iou_threshold).cpu().numpy()
    keep_s = _greedy_sweep(suppress, valid[order].cpu().numpy())
    keep = torch.zeros((n,), dtype=torch.bool, device=dev)
    keep[order] = torch.from_numpy(keep_s).to(dev)
    return keep


def nms_indices(boxes: np.ndarray, scores: np.ndarray, iou_threshold: float,
                rotated: bool, device: DeviceLike = None) -> np.ndarray:
    """Host convenience: kept indices in descending-score order (the
    torchvision/detectron2 return convention). The IoU runs on `device`
    (`device.resolve_device`: None is the card)."""
    boxes = np.asarray(boxes, dtype=np.float32)
    scores = np.asarray(scores, dtype=np.float32)
    if boxes.shape[0] == 0:
        return np.zeros((0,), np.int64)
    dev = resolve_device(device)
    keep = nms_keep_mask(torch.from_numpy(boxes).to(dev),
                         torch.from_numpy(scores).to(dev),
                         float(iou_threshold), rotated).cpu().numpy()
    idx = np.nonzero(keep)[0]
    return idx[np.argsort(-scores[idx], kind="stable")]
