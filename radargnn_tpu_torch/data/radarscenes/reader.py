"""Self-contained RadarScenes reader (no `radar_scenes` SDK dependency).

Port of `radargnn_tpu/data/radarscenes/reader.py` (numpy). Reads the public
RadarScenes on-disk format directly: per-sequence `scenes.json` (the scene
index) and `radar_data.h5` (structured `radar_data` and `odometry`
datasets, read by the port's own HDF5 reader, `data.hdf5`: no h5py).
Provides what the dataset creation reads from the SDK:
`Sequence.from_json`, `get_scene` / `next_*`, the sensor mounting poses,
the sequence-to-car coordinate transform, and the 11-to-5 reduced class
mapping.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List, Optional

import numpy as np

from radargnn_tpu_torch.data.hdf5 import read_dataset

# Published default mounting poses of the four radar sensors (car frame):
# x [m], y [m], yaw [rad].
SENSOR_MOUNTING = {
    1: {"x": 3.663, "y": -0.873, "yaw": -1.48418552},
    2: {"x": 3.86, "y": -0.70, "yaw": -0.436185662},
    3: {"x": 3.86, "y": 0.70, "yaw": 0.436185662},
    4: {"x": 3.663, "y": 0.873, "yaw": 1.48418552},
}

# Original 12-label taxonomy -> reduced 6-class labels (5 + static).
# None = dropped (animal/other), as ClassificationLabel.label_to_clabel.
LABEL_TO_CLABEL = {
    0: 0,      # CAR -> CAR
    1: 4,      # LARGE_VEHICLE -> LARGE_VEHICLE
    2: 4,      # TRUCK -> LARGE_VEHICLE
    3: 4,      # BUS -> LARGE_VEHICLE
    4: 4,      # TRAIN -> LARGE_VEHICLE
    5: 3,      # BICYCLE -> TWO_WHEELER
    6: 3,      # MOTORIZED_TWO_WHEELER -> TWO_WHEELER
    7: 1,      # PEDESTRIAN -> PEDESTRIAN
    8: 2,      # PEDESTRIAN_GROUP -> PEDESTRIAN_GROUP
    9: None,   # ANIMAL -> dropped
    10: None,  # OTHER -> dropped
    11: 5,     # STATIC -> STATIC (background)
}


def get_mounting(sensor_id: int, json_path=None) -> dict:
    return SENSOR_MOUNTING[int(sensor_id)]


def label_to_clabel_array(label_id: np.ndarray) -> np.ndarray:
    """Vectorized 11-to-5 reduced-class mapping; dropped classes become NaN."""
    out = np.full(label_id.shape, np.nan, dtype=np.float64)
    for raw, reduced in LABEL_TO_CLABEL.items():
        if reduced is not None:
            out[label_id == raw] = reduced
    return out


def transform_detections_sequence_to_car(x_seq: np.ndarray, y_seq: np.ndarray,
                                         odometry) -> tuple:
    """Sequence (global) frame -> car frame at the given odometry pose: the
    inverse SE(2) transform of the car pose (fields x_seq, y_seq,
    yaw_seq)."""
    x_car = float(odometry["x_seq"])
    y_car = float(odometry["y_seq"])
    yaw = float(odometry["yaw_seq"])
    dx = x_seq - x_car
    dy = y_seq - y_car
    c, s = np.cos(yaw), np.sin(yaw)
    return c * dx + s * dy, -s * dx + c * dy


@dataclasses.dataclass
class Scene:
    timestamp: int
    sensor_id: int
    radar_data: np.ndarray          # structured rows for this scan
    odometry_data: np.ndarray       # structured odometry row
    camera_image_name: Optional[str] = None


class Sequence:
    """One RadarScenes sequence: scene index + radar/odometry tables."""

    def __init__(self, meta: dict, radar_data: np.ndarray,
                 odometry: np.ndarray, directory: str = ""):
        self.meta = meta
        self.radar_data = radar_data
        self.odometry = odometry
        self.directory = directory
        self._scenes = meta["scenes"]
        self.timestamps = np.array(sorted(int(t) for t in self._scenes))

    @classmethod
    def from_json(cls, scenes_json_path: str) -> "Sequence":
        with open(scenes_json_path) as f:
            meta = json.load(f)
        directory = os.path.dirname(scenes_json_path)
        tables = os.path.join(directory, "radar_data.h5")
        return cls(meta, read_dataset(tables, "radar_data"),
                   read_dataset(tables, "odometry"), directory)

    def get_scene(self, timestamp: int) -> Scene:
        info = self._scenes[str(int(timestamp))]
        start, end = info["radar_indices"]
        image = info.get("image_name")
        return Scene(
            timestamp=int(timestamp), sensor_id=int(info["sensor_id"]),
            radar_data=self.radar_data[start:end],
            odometry_data=self.odometry[info["odometry_index"]],
            camera_image_name=(os.path.join(self.directory, image)
                               if image else None))

    def next_timestamp_after(self, timestamp: int) -> Optional[int]:
        idx = np.searchsorted(self.timestamps, int(timestamp), side="right")
        if idx >= len(self.timestamps):
            return None
        return int(self.timestamps[idx])

    def next_scene_after(self, timestamp: int) -> Optional[Scene]:
        ts = self.next_timestamp_after(timestamp)
        return None if ts is None else self.get_scene(ts)


def get_training_sequences(sequence_file: str) -> List[str]:
    """Sequence names with category 'train' (SDK-compatible helper)."""
    with open(sequence_file) as f:
        seqs = json.load(f)["sequences"]
    return [name for name, m in seqs.items() if m.get("category") == "train"]


def get_validation_sequences(sequence_file: str) -> List[str]:
    with open(sequence_file) as f:
        seqs = json.load(f)["sequences"]
    return [name for name, m in seqs.items() if m.get("category") == "validation"]
