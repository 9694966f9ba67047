"""Scene accumulation: consecutive RadarScenes scans -> one point-cloud frame.

Port of `radargnn_tpu/data/radarscenes/scene_collection.py` (numpy), with
its vectorized structured-array field reads. Semantics:

  * reduced 11-to-5 class labels (dropped classes -> NaN label),
  * X_seq re-expressed in the car frame of the collection's FIRST scene,
  * radial-to-cartesian velocity decomposition
    v = vr * (cos(azimuth + sensor_yaw), sin(azimuth + sensor_yaw)),
  * `concatenate_subsequent_scenes` walks as the reference does, including
    the one-scene overlap past the window boundary.
"""

from __future__ import annotations

import numpy as np

from radargnn_tpu_torch.data.point_cloud import RadarPointCloud
from radargnn_tpu_torch.data.radarscenes.reader import (
    Sequence, get_mounting, label_to_clabel_array,
    transform_detections_sequence_to_car,
)


class SceneCollection:
    def __init__(self):
        self.scenes = []
        self.point_cloud: RadarPointCloud = None

    def process(self, use_reduced_classes: bool = True) -> None:
        self.extract_scene_radar_data(use_reduced_classes)
        self.transform_radar_data()

    def extract_scene_radar_data(self, use_reduced_classes: bool = True) -> None:
        pc = RadarPointCloud()
        data = np.concatenate([s.radar_data for s in self.scenes])
        n = data.shape[0]

        def col(name):
            return np.asarray(data[name], dtype=np.float64).reshape(n, 1)

        pc.timestamp = col("timestamp")
        pc.sensor_id = col("sensor_id")
        pc.range_sc = col("range_sc")
        pc.azimuth_sc = col("azimuth_sc")
        pc.rcs = col("rcs")
        pc.vr = col("vr")
        pc.vr_compensated = col("vr_compensated")
        pc.X_cc = np.stack([np.asarray(data["x_cc"], np.float64),
                            np.asarray(data["y_cc"], np.float64)], axis=1)
        pc.X_seq = np.stack([np.asarray(data["x_seq"], np.float64),
                             np.asarray(data["y_seq"], np.float64)], axis=1)
        pc.uuid = np.asarray(data["uuid"]).reshape(n, 1)
        pc.track_id = np.asarray(data["track_id"]).reshape(n, 1)

        raw_labels = np.asarray(data["label_id"], np.float64)
        if use_reduced_classes:
            pc.label_id = label_to_clabel_array(raw_labels).reshape(n, 1)
        else:
            pc.label_id = raw_labels.reshape(n, 1)
        self.point_cloud = pc

    def transform_radar_data(self) -> None:
        pc = self.point_cloud
        x, y = transform_detections_sequence_to_car(
            pc.X_seq[:, 0], pc.X_seq[:, 1], self.scenes[0].odometry_data)
        pc.X_seq = np.stack((x, y), axis=-1)

        yaw = np.array([get_mounting(int(s))["yaw"]
                        for s in pc.sensor_id[:, 0]]).reshape(-1, 1)
        angles = pc.azimuth_sc + yaw
        pc.V_cc = np.concatenate(
            [pc.vr * np.cos(angles), pc.vr * np.sin(angles)], axis=1)
        pc.V_cc_compensated = np.concatenate(
            [pc.vr_compensated * np.cos(angles),
             pc.vr_compensated * np.sin(angles)], axis=1)


def concatenate_subsequent_scenes(sequence: Sequence, start_timestamp: int,
                                  time: float) -> SceneCollection:
    """Collects scenes from start_timestamp spanning `time` seconds; the
    first scene past the window boundary is still appended (frames overlap
    by one scene)."""
    first_scene = sequence.get_scene(start_timestamp)
    collection = SceneCollection()
    collection.scenes.append(first_scene)

    subsuq = sequence.next_scene_after(start_timestamp)
    if subsuq is not None:
        collection.scenes.append(subsuq)
        current = start_timestamp
        while (subsuq.timestamp - first_scene.timestamp) * 1e-6 < time:
            current = sequence.next_timestamp_after(current)
            if current is None:
                break
            subsuq = sequence.next_scene_after(current)
            if subsuq is None:
                break
            collection.scenes.append(subsuq)
    return collection
