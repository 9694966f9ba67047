"""nuScenes detection-submission writer.

Port of `radargnn_tpu/data/nuscenes/submission.py` (host numpy): 2D box ->
3D through the class height map, vehicle -> global frame through the
sample's LIDAR_TOP ego pose, yaw quaternions, detection and attribute
names, the sample token read back from a graph file's name, and the
submission dict.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Tuple

import numpy as np

from radargnn_tpu_torch.data.nuscenes.db import NuScenes
from radargnn_tpu_torch.data.nuscenes.quaternion import Quaternion

HEIGHT_MAP: Dict[str, float] = {
    "void": 1.029, "barrier": 0.981, "bicycle": 1.283, "bus": 3.41,
    "car": 1.698, "construction_vehicle": 3.05, "motorcycle": 1.471,
    "pedestrian": 1.78, "traffic_cone": 1.067, "trailer": 4.04,
    "truck": 2.843,
}

DETECTION_NAMES: List[str] = [
    "void", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
]

ATTRIBUTE_NAME_MAP: Dict[str, str] = {
    "barrier": "", "traffic_cone": "",
    "bicycle": "cycle.with_rider", "motorcycle": "cycle.with_rider",
    "pedestrian": "pedestrian.moving",
    "car": "vehicle.moving", "bus": "vehicle.moving",
    "construction_vehicle": "vehicle.moving", "trailer": "vehicle.moving",
    "truck": "vehicle.moving",
}


def transform_bounding_box(bounding_box: np.ndarray, nusc: NuScenes,
                           sample_token: str) -> np.ndarray:
    """Vehicle frame → global frame via the LIDAR_TOP ego pose."""
    sample = nusc.get("sample", sample_token)
    sample_data = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
    ego_pose = nusc.get("ego_pose", sample_data["ego_pose_token"])

    q = Quaternion(ego_pose["rotation"])
    bounding_box[:3] = q.rotation_matrix @ bounding_box[:3]
    bounding_box[:3] += np.asarray(ego_pose["translation"])
    yaw, _, _ = q.yaw_pitch_roll
    bounding_box[-1] = np.deg2rad(bounding_box[-1]) + yaw
    return bounding_box


def get_3d_bounding_box(bounding_box: np.ndarray,
                        size: Tuple[float, float, float]) -> np.ndarray:
    return np.array([bounding_box[0], bounding_box[1], 0.0,
                     size[0], size[1], size[2], bounding_box[4]], dtype=float)


def get_bounding_box_size(bounding_box: np.ndarray,
                          detection_name: str) -> Tuple[float, float, float]:
    return (float(bounding_box[3]), float(bounding_box[2]),
            float(HEIGHT_MAP[detection_name]))


def get_bounding_box_rotation(bounding_box: np.ndarray):
    q = Quaternion(axis=[0, 0, 1], angle=float(bounding_box[-1]))
    return q.w, q.x, q.y, q.z


def get_bounding_box_detection_name(label) -> str:
    return DETECTION_NAMES[int(label)]


def get_bounding_box_attribute_name(detection_name: str, velocity) -> str:
    return ATTRIBUTE_NAME_MAP[detection_name]


def get_bounding_box_velocity(velocity, nusc, sample_token) -> Tuple[float, float]:
    # radar point velocities are not propagated to the box velocity (as in
    # the reference implementation)
    return 0.0, 0.0


def get_sample_token(graph_name: str) -> str:
    file_name, _ = os.path.splitext(os.path.split(graph_name)[-1])
    return file_name.split("_")[-1]


def convert_results(nusc: NuScenes, bb_preds: List[Dict], vels: List[np.ndarray],
                    graph_names: List[str]) -> Dict:
    assert len(bb_preds) == len(graph_names) == len(vels)
    results: Dict[str, List] = {}

    for bb_pred, vel, graph_name in zip(bb_preds, vels, graph_names):
        sample_token = get_sample_token(graph_name)
        results[sample_token] = []

        boxes = bb_pred["boxes"]
        matrix = boxes.to_xylwt() if len(boxes) else np.zeros((0, 5))

        for i in range(matrix.shape[0]):
            bb = matrix[i]
            detection_name = get_bounding_box_detection_name(bb_pred["labels"][i])
            detection_score = float(bb_pred["scores"][i])
            attribute_name = get_bounding_box_attribute_name(detection_name,
                                                             vel[i])
            size = get_bounding_box_size(bb, detection_name)
            bb3 = get_3d_bounding_box(bb, size)
            bb3 = transform_bounding_box(bb3, nusc, sample_token)
            bb3[2] += size[2] / 2

            results[sample_token].append({
                "sample_token": sample_token,
                "translation": tuple(float(v) for v in bb3[:3]),
                "size": size,
                "rotation": get_bounding_box_rotation(bb3),
                "velocity": get_bounding_box_velocity(vel[i], nusc, sample_token),
                "detection_name": detection_name,
                "detection_score": detection_score,
                "attribute_name": attribute_name,
            })
    return results


def get_submission(nusc: NuScenes, bb_pred: List[Dict], vel: List[np.ndarray],
                   graph_names: List[str]) -> Dict:
    bb_preds = copy.deepcopy(bb_pred)
    vels = copy.deepcopy(vel)
    return {
        "meta": {
            "use_camera": False, "use_lidar": False, "use_radar": True,
            "use_map": False, "use_external": False,
        },
        "results": convert_results(nusc, bb_preds, vels, graph_names),
    }
