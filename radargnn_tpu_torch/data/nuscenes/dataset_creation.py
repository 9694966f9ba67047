"""nuScenes graph-dataset creation: radar key frames -> GraphSamples.

Port of `radargnn_tpu/data/nuscenes/dataset_creation.py` (host numpy):
5-radar multisweep aggregation into the vehicle frame, the 23 -> 11
detection-class mapping, box filtering (at least one lidar or radar
point), the crop, inflated points-in-box labelling against boxes in the
LIDAR_TOP ego frame, and one `graph_<timestamp>_<scene>_<sample>.npz` a
sample (`submission.get_sample_token` reads the sample token back from
that name).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List

import numpy as np

from radargnn_tpu_torch.configs import (
    GraphConstructionConfiguration, NuScenesDatasetConfiguration,
    NuScenesSplitConfiguration,
)
from radargnn_tpu_torch.data.nuscenes import conversion
from radargnn_tpu_torch.data.nuscenes.db import (
    Box, NuScenes, RADAR_CHANNELS, RadarPointCloudLoader,
)
from radargnn_tpu_torch.data.nuscenes.quaternion import Quaternion
from radargnn_tpu_torch.graph.batch import GraphSample

# 23 original classes → 11 detection-challenge ids (0 = void/background).
CLASS_NAME_TO_ID = {
    "animal": 0,
    "human.pedestrian.personal_mobility": 0,
    "human.pedestrian.stroller": 0,
    "human.pedestrian.wheelchair": 0,
    "movable_object.debris": 0,
    "movable_object.pushable_pullable": 0,
    "static_object.bicycle_rack": 0,
    "vehicle.emergency.ambulance": 0,
    "vehicle.emergency.police": 0,
    "movable_object.barrier": 1,
    "vehicle.bicycle": 2,
    "vehicle.bus.bendy": 3,
    "vehicle.bus.rigid": 3,
    "vehicle.car": 4,
    "vehicle.construction": 5,
    "vehicle.motorcycle": 6,
    "human.pedestrian.adult": 7,
    "human.pedestrian.child": 7,
    "human.pedestrian.construction_worker": 7,
    "human.pedestrian.police_officer": 7,
    "movable_object.trafficcone": 8,
    "vehicle.trailer": 9,
    "vehicle.truck": 10,
}


class NuScenesGraphDataset:
    def __init__(self, root: str, graph_config: GraphConstructionConfiguration,
                 dataset_config: NuScenesDatasetConfiguration,
                 process: bool = True):
        self.root = root
        self.graph_config = graph_config
        self.dataset_config = dataset_config
        self.nsweeps = dataset_config.nsweeps
        self.wlh_factor = dataset_config.wlh_factor
        self.wlh_offset = dataset_config.wlh_offset
        if process:
            self.process()

    # ------------------------------------------------------------------

    @staticmethod
    def _get_box_label(name: str) -> int:
        return CLASS_NAME_TO_ID[name]

    @staticmethod
    def filter_bounding_boxes(nusc: NuScenes, boxes: List[Box]) -> List[Box]:
        """Keep boxes with ≥1 lidar or radar point."""
        annotations = [nusc.get("sample_annotation", b.token) for b in boxes]
        return [b for b, a in zip(boxes, annotations)
                if a["num_lidar_pts"] + a["num_radar_pts"] > 0]

    def crop_bounding_boxes(self, boxes: List[Box]) -> List[Box]:
        xlim = self.dataset_config.crop_settings["x"]
        ylim = self.dataset_config.crop_settings["y"]
        return [b for b in boxes
                if (-xlim < b.center[0] < xlim) and (-ylim < b.center[1] < ylim)]

    def crop_point_cloud(self, points: np.ndarray) -> np.ndarray:
        xlim = self.dataset_config.crop_settings["x"]
        ylim = self.dataset_config.crop_settings["y"]
        keep = ((np.abs(points[0]) <= xlim) & (np.abs(points[1]) <= ylim))
        return points[:, keep]

    def get_sensor_points(self, nusc: NuScenes, sample: dict,
                          sensor: str) -> np.ndarray:
        """Sensor sweeps → vehicle frame (positions + velocity rotation)."""
        pts, times = RadarPointCloudLoader.from_file_multisweep(
            nusc, sample, chan=sensor, ref_chan=sensor,
            nsweeps=self.nsweeps, min_distance=1.0)
        pts = np.vstack([pts, times])

        sample_data = nusc.get("sample_data", sample["data"][sensor])
        cs = nusc.get("calibrated_sensor", sample_data["calibrated_sensor_token"])
        rot = Quaternion(cs["rotation"]).rotation_matrix
        pts[:3] = rot @ pts[:3]
        pts[:3] += np.expand_dims(cs["translation"], axis=-1)
        pts[8:10] = rot[:2, :2] @ pts[8:10]
        return pts

    def get_bounding_boxes(self, nusc: NuScenes, sample: dict,
                           sensor: str) -> List[Box]:
        boxes = nusc.get_boxes(sample["data"][sensor])
        for box in boxes:
            box.label = self._get_box_label(box.name)
        return boxes

    def get_labels(self, nusc: NuScenes, sample: dict, sensor: str,
                   points: np.ndarray):
        """Per-point labels via inflated points-in-box against boxes in the
        vehicle frame of `sensor`'s ego pose."""
        sample_data = nusc.get("sample_data", sample["data"][sensor])
        ego_pose = nusc.get("ego_pose", sample_data["ego_pose_token"])

        points[2, :] = 0.0                     # quasi-2D radar data
        labels = np.zeros(points.shape[1], dtype=int)

        boxes = self.get_bounding_boxes(nusc, sample, sensor)
        boxes = self.filter_bounding_boxes(nusc, boxes)

        for box in boxes:
            box.translate(np.multiply(ego_pose["translation"], -1))
            box.rotate(Quaternion(ego_pose["rotation"]).inverse)

        if self.dataset_config.crop_point_cloud:
            boxes = self.crop_bounding_boxes(boxes)

        for box in boxes:
            mask = conversion.extended_points_in_box(
                box, points[:3], wlh_factor=self.wlh_factor,
                wlh_offset=self.wlh_offset, use_z=False)
            labels[mask] = box.label
        return labels, boxes

    def process_single_sample(self, nusc: NuScenes, sample: dict,
                              path_to_destination: str) -> None:
        points = np.empty((RadarPointCloudLoader.nbr_dims() + 1, 0))
        for sensor in RADAR_CHANNELS:
            points = np.append(points, self.get_sensor_points(nusc, sample, sensor),
                               axis=1)

        if self.dataset_config.crop_point_cloud:
            points = self.crop_point_cloud(points)

        labels, boxes = self.get_labels(nusc, sample, "LIDAR_TOP", points)
        pc = conversion.convert_point_cloud(points, labels)
        if pc.num_points <= 1:
            return

        graph = conversion.build_graph(self.graph_config, pc)
        bounding_boxes = conversion.convert_bounding_boxes(
            self.dataset_config, pc, boxes, wlh_factor=self.wlh_factor,
            wlh_offset=self.wlh_offset)

        sample_obj = GraphSample(
            node_feat=graph.node_feat.astype(np.float32),
            edge_feat=graph.edge_feat.astype(np.float32),
            senders=graph.senders.astype(np.int32),
            receivers=graph.receivers.astype(np.int32),
            labels=labels.astype(np.int32),
            boxes=bounding_boxes.astype(np.float32),
            pos=pc.X_cc.astype(np.float32),
            vel=pc.V_cc_compensated.astype(np.float32))
        name = (f"graph_{sample['timestamp']}_{sample['scene_token']}"
                f"_{sample['token']}.npz")
        sample_obj.save_npz(os.path.join(path_to_destination, name))

    def process(self) -> None:
        split_config = NuScenesSplitConfiguration(
            version=self.dataset_config.version)
        self.dataset_split_config = split_config

        path_to_nuscenes = f"{self.root}/raw"
        nusc = NuScenes(version=self.dataset_config.version,
                        dataroot=path_to_nuscenes, verbose=False)
        scene_by_name = {s["name"]: s for s in nusc.scene}

        os.makedirs(f"{self.root}/processed", exist_ok=True)
        create_data_set_description(
            self.graph_config, self.dataset_config, split_config,
            f"{self.root}/processed/config.json")

        for split_name, sequence_list in split_config.sequence_dict.items():
            dest = f"{self.root}/processed/{split_name}"
            os.makedirs(dest, exist_ok=True)
            for i, sequence in enumerate(sequence_list):
                if sequence in scene_by_name:
                    scene = scene_by_name[sequence]
                elif sequence in nusc._index["scene"]:
                    scene = nusc.get("scene", sequence)
                else:
                    continue            # scene absent from this (sub)dataset
                sample = nusc.get("sample", scene["first_sample_token"])
                self.process_single_sample(nusc, sample, dest)
                for _ in range(scene["nbr_samples"] - 1):
                    sample = nusc.get("sample", sample["next"])
                    self.process_single_sample(nusc, sample, dest)


def create_data_set_description(graph_config, dataset_config, split_config,
                                path_to_destination: str) -> None:
    json_dict = {
        "GRAPH_CONSTRUCTION_SETTINGS": dataclasses.asdict(graph_config),
        "DATASET_CONFIG": dataclasses.asdict(dataset_config),
        "DATASET_SPLIT_CONFIG": dataclasses.asdict(split_config),
    }
    with open(path_to_destination, "w") as f:
        json.dump(json_dict, f, indent=4)
