"""RadarPointCloud: container for all RadarScenes radar channels.

Port of `radargnn_tpu/data/point_cloud.py` (numpy): the same attributes and
filtering API (nan-label removal, nan-velocity removal, a spatial crop to
the front and sides that also drops points behind the car, index-based
removal).
"""

from __future__ import annotations

import numpy as np


class RadarPointCloud:
    def __init__(self):
        self.X_cc = None
        self.X_seq = None
        self.V_cc = None
        self.V_cc_compensated = None
        self.range_sc = None
        self.azimuth_sc = None
        self.rcs = None
        self.vr = None
        self.vr_compensated = None
        self.timestamp = None
        self.sensor_id = None
        self.uuid = None
        self.track_id = None
        self.label_id = None

    def remove_points_without_labelID(self) -> None:
        idx = np.where(np.isnan(self.label_id[:, 0]))[0]
        self.remove_points_based_on_index(idx)

    def remove_points_without_valid_velocity(self) -> None:
        idx1 = np.where(np.isnan(self.V_cc_compensated[:, 0]))[0]
        idx2 = np.where(np.isnan(self.V_cc_compensated[:, 1]))[0]
        self.remove_points_based_on_index(
            np.unique(np.concatenate((idx1, idx2), axis=0)))

    def remove_points_out_of_range(self, x_max: float, y_max: float) -> None:
        """Removes points beyond x_max ahead / y_max sideways / behind the car."""
        idx1 = np.where(np.abs(self.X_cc[:, 1]) > y_max)[0]
        idx2 = np.where(self.X_cc[:, 0] > x_max)[0]
        idx3 = np.where(self.X_cc[:, 0] < 0)[0]
        self.remove_points_based_on_index(
            np.unique(np.concatenate([idx1, idx2, idx3], axis=0)))

    def remove_points_based_on_index(self, idx_array: np.ndarray) -> None:
        for key, value in vars(self).items():
            if value is not None:
                vars(self)[key] = np.delete(value, idx_array, axis=0)

    @property
    def num_points(self) -> int:
        return 0 if self.X_cc is None else self.X_cc.shape[0]
