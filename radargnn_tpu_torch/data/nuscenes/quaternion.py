"""Minimal quaternion algebra (w, x, y, z), in place of pyquaternion.

Port of `radargnn_tpu/data/nuscenes/quaternion.py` (numpy, float64).
"""

from __future__ import annotations

import numpy as np


class Quaternion:
    """Unit quaternion (w, x, y, z) with the operations the pipelines need."""

    def __init__(self, wxyz=None, axis=None, angle=None):
        if wxyz is not None:
            q = np.asarray(wxyz, dtype=np.float64).reshape(4)
        else:
            axis = np.asarray(axis, dtype=np.float64)
            axis = axis / np.linalg.norm(axis)
            half = 0.5 * float(angle)
            q = np.concatenate([[np.cos(half)], np.sin(half) * axis])
        self.q = q

    @property
    def w(self):
        return float(self.q[0])

    @property
    def x(self):
        return float(self.q[1])

    @property
    def y(self):
        return float(self.q[2])

    @property
    def z(self):
        return float(self.q[3])

    @property
    def elements(self) -> np.ndarray:
        return self.q.copy()

    @property
    def inverse(self) -> "Quaternion":
        w, x, y, z = self.q
        n = np.dot(self.q, self.q)
        return Quaternion([w / n, -x / n, -y / n, -z / n])

    def __mul__(self, other: "Quaternion") -> "Quaternion":
        w1, x1, y1, z1 = self.q
        w2, x2, y2, z2 = other.q
        return Quaternion([
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ])

    @property
    def rotation_matrix(self) -> np.ndarray:
        w, x, y, z = self.q / np.linalg.norm(self.q)
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ])

    def rotate(self, v: np.ndarray) -> np.ndarray:
        return self.rotation_matrix @ np.asarray(v, dtype=np.float64)

    @property
    def yaw_pitch_roll(self):
        """ZYX intrinsic Tait–Bryan angles (yaw, pitch, roll) — pyquaternion
        convention."""
        w, x, y, z = self.q / np.linalg.norm(self.q)
        yaw = np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
        sinp = np.clip(2 * (w * y - z * x), -1.0, 1.0)
        pitch = np.arcsin(sinp)
        roll = np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        return yaw, pitch, roll
