"""nuScenes-format conversions: points -> RadarPointCloud, boxes -> the
per-node box encodings.

Port of `radargnn_tpu/data/nuscenes/conversion.py` (host numpy): the
points-in-box test is batched box algebra, the graph comes from the port's
host graph construction (`graph.build`), the encodings from
`postprocess.boxes`.
"""

from __future__ import annotations

from typing import List

import numpy as np

from radargnn_tpu_torch.configs import (
    GraphConstructionConfiguration, NuScenesDatasetConfiguration,
)
from radargnn_tpu_torch.data.nuscenes.db import Box
from radargnn_tpu_torch.data.point_cloud import RadarPointCloud
from radargnn_tpu_torch.data.ground_truth import _deg_to_rad_cols
from radargnn_tpu_torch.graph.build import build_geometric_graph, GeometricGraphArrays
from radargnn_tpu_torch.ops.knn import nearest_neighbor_host
from radargnn_tpu_torch.postprocess import boxes as bx


def extended_points_in_box(box: Box, points: np.ndarray, wlh_factor: float = 1.0,
                           wlh_offset: float = 0.0, use_z: bool = True) -> np.ndarray:
    """Inflatable point-in-box mask over (3, N) points."""
    corners = box.corners(wlh_factor=wlh_factor)
    p1 = corners[:, 0]
    p_x = corners[:, 4]
    p_y = corners[:, 1]
    p_z = corners[:, 3]

    i = p_x - p1
    j = p_y - p1
    k = p_z - p1
    v = points - p1.reshape((-1, 1))

    iv = np.dot(i, v) / np.linalg.norm(i)
    jv = np.dot(j, v) / np.linalg.norm(j)
    kv = np.dot(k, v) / np.linalg.norm(k)

    mask = ((-wlh_offset <= iv) & (iv <= np.linalg.norm(i) + wlh_offset)
            & (-wlh_offset <= jv) & (jv <= np.linalg.norm(j) + wlh_offset))
    if use_z:
        mask &= (-wlh_offset <= kv) & (kv <= np.linalg.norm(k) + wlh_offset)
    return mask


def convert_point_cloud(points: np.ndarray, labels: np.ndarray) -> RadarPointCloud:
    """nuScenes 19-row point matrix (18 radar rows and the time lag) →
    RadarPointCloud."""
    pc = RadarPointCloud()
    pc.X_cc = np.vstack([points[0], points[1]]).T
    pc.V_cc = np.vstack([points[6], points[7]]).T
    pc.V_cc_compensated = np.vstack([points[8], points[9]]).T
    pc.rcs = np.atleast_2d(points[5]).T
    pc.timestamp = np.atleast_2d(points[18]).T
    pc.label_id = np.atleast_2d(labels).T
    return pc


def build_graph(config: GraphConstructionConfiguration,
                point_cloud: RadarPointCloud) -> GeometricGraphArrays:
    """The frame's graph by the shared host graph construction (the time
    lags as the time index's timestamps)."""
    return build_geometric_graph(
        config, point_cloud.X_cc, point_cloud.V_cc_compensated,
        rcs=point_cloud.rcs, timestamps=point_cloud.timestamp)


def convert_bounding_boxes(config: NuScenesDatasetConfiguration,
                           point_cloud: RadarPointCloud, boxes: List[Box],
                           wlh_factor: float = 1.0,
                           wlh_offset: float = 0.0) -> np.ndarray:
    """nuScenes Boxes → per-node 5-column encodings (angles in rad; NaN
    rows for points outside every box)."""
    n = point_cloud.X_cc.shape[0]
    out = np.full((n, 5), np.nan)

    nn_pos = None
    if config.bb_invariance == "en" and n > 1:
        nn_pos = point_cloud.X_cc[nearest_neighbor_host(point_cloud.X_cc)]

    points_3d = np.vstack([point_cloud.X_cc.T,
                           np.zeros_like(point_cloud.X_cc.T[0])])

    for box in boxes:
        mask = extended_points_in_box(box, points_3d, wlh_factor=wlh_factor,
                                      wlh_offset=wlh_offset, use_z=False)
        idx = np.flatnonzero(mask)
        if idx.size == 0:
            continue

        corners2d = box.bottom_corners()[:2].T            # (4, 2)
        pts = point_cloud.X_cc[idx]
        rel = bx.absolute_to_relative_rotated(
            np.broadcast_to(corners2d, (idx.size, 4, 2)), pts)

        if config.bb_invariance == "none":
            enc = rel.copy()
            enc[:, 0] += pts[:, 0]
            enc[:, 1] += pts[:, 1]
        elif config.bb_invariance == "translation":
            enc = rel
        elif config.bb_invariance == "en":
            enc = bx.relative_rotated_to_rotation_invariant(rel, pts, nn_pos[idx])
        else:
            raise ValueError("Wrong invariance for bounding box selection")

        out[idx] = _deg_to_rad_cols(enc, config.bb_invariance)
    return out
