"""The nuScenes pipeline end to end on one device (the card unless
`--device` names another): synthetic nuScenes-format tables, multisweep
dataset creation, training through `Trainer.fit` on the dense tiling,
`Predictor`, `Postprocessor` (NMS) and `NuscenesEvaluator` (submission.json,
the native CVPR-2019 detection eval with finite-difference ground-truth
velocities). Port of `benchmarks/nuscenes_e2e.py`; prints the final mAP
and NDS.

    python -m radargnn_tpu_torch.benchmarks.nuscenes_e2e [--device cpu]

`write_nuscenes_tables` writes the tables and radar sweeps; the on-card
smoke writes its nuScenes data with it too.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import tempfile
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from radargnn_tpu_torch.configs import (
    GNNArchitectureConfig, GraphConstructionConfiguration,
    NuScenesDatasetConfiguration, PostProcessingConfiguration, TrainingConfig,
)
from radargnn_tpu_torch.data.loader import get_data_loaders
from radargnn_tpu_torch.data.nuscenes.dataset_creation import (
    NuScenesGraphDataset,
)
from radargnn_tpu_torch.data.nuscenes.db import RADAR_CHANNELS
from radargnn_tpu_torch.data.nuscenes.evaluation import NuscenesEvaluator
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.models.detnet import DetNet
from radargnn_tpu_torch.models.layers import fused_csr_tiling
from radargnn_tpu_torch.postprocess.extraction import (
    Postprocessor, PredictionExtractor,
)
from radargnn_tpu_torch.postprocess.inference import Predictor
from radargnn_tpu_torch.train.trainer import Trainer, set_seeds

# -- the table writer ---------------------------------------------------------

# the nuScenes radar PCD layout: 18 fields, F4 positions, velocities and
# rcs beside 1- and 2-byte signed and unsigned integer fields
PCD_FIELDS = (("x", "F", 4), ("y", "F", 4), ("z", "F", 4),
              ("dyn_prop", "I", 1), ("id", "U", 2), ("rcs", "F", 4),
              ("vx", "F", 4), ("vy", "F", 4), ("vx_comp", "F", 4),
              ("vy_comp", "F", 4), ("is_quality_valid", "U", 1),
              ("ambig_state", "I", 1), ("x_rms", "I", 1), ("y_rms", "I", 1),
              ("invalid_state", "U", 1), ("pdh0", "I", 1),
              ("vx_rms", "I", 1), ("vy_rms", "I", 1))
PCD_DTYPE = np.dtype([(name, {"F": "<f", "I": "<i", "U": "<u"}[t] + str(s))
                      for name, t, s in PCD_FIELDS])

# each radar's mounting on the car (x, y, z m; yaw deg), roughly where the
# five nuScenes radars sit; LIDAR_TOP's pose is the sample's ego pose
RADAR_MOUNTS = {"RADAR_FRONT": (3.41, 0.0, 0.5, 0.0),
                "RADAR_FRONT_LEFT": (2.42, 0.80, 0.5, 85.0),
                "RADAR_FRONT_RIGHT": (2.42, -0.80, 0.5, -85.0),
                "RADAR_BACK_LEFT": (-0.56, 0.62, 0.5, 170.0),
                "RADAR_BACK_RIGHT": (-0.56, -0.62, 0.5, -170.0)}
FOV_DEG = 75.0              # a radar sees objects within +-FOV_DEG
RANGE_M = 90.0

# the objects of a scene, one instance each: (category, w, l, h m,
# returns a sweep in a radar that sees it, rcs dBsm, attribute)
OBJECTS = (("vehicle.car", 1.9, 4.6, 1.7, 4, 10.0, "vehicle.moving"),
           ("vehicle.truck", 2.5, 8.0, 3.0, 6, 15.0, "vehicle.moving"),
           ("human.pedestrian.adult", 0.7, 0.7, 1.8, 2, -8.0,
            "pedestrian.moving"),
           ("movable_object.barrier", 2.5, 0.5, 1.0, 2, 0.0, ""),
           ("vehicle.bicycle", 0.6, 1.8, 1.3, 2, -2.0, "cycle.with_rider"),
           ("vehicle.bus.rigid", 2.9, 11.0, 3.4, 6, 18.0, "vehicle.moving"),
           ("vehicle.motorcycle", 0.8, 2.1, 1.5, 2, 2.0, "cycle.with_rider"),
           ("movable_object.trafficcone", 0.4, 0.4, 1.0, 1, -10.0, ""))

SAMPLE_US = 500_000         # key frames 0.5 s apart
SWEEP_US = 75_000           # non-key radar sweeps 75 ms apart
EGO_SPEED = 3.0             # m/s
EGO_YAW_RATE = 0.03         # rad/s
LANDMARKS = 600             # static structures a scene
LANDMARK_DISC_M = 100.0


def _yaw_quat(yaw: float) -> List[float]:
    return [float(np.cos(yaw / 2)), 0.0, 0.0, float(np.sin(yaw / 2))]


def _rot(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s], [s, c]])


class _Scene:
    """One scene's ego path (constant speed and yaw rate from a start pose)
    and its objects, each moving slowly in the ego frame so that it stays
    in range of the radars for the whole scene."""

    def __init__(self, rng: np.random.Generator):
        self.start = rng.uniform(-500, 500, 2)
        self.yaw0 = rng.uniform(-np.pi, np.pi)
        n = len(OBJECTS)
        # distinct bearings, 9-24 m out, so that no two boxes overlap
        bearings = (np.arange(n) * 2 * np.pi / n
                    + rng.uniform(-0.15, 0.15, n))
        dist = rng.uniform(9, 24, n)
        self.objects = [(kind, dist[i] * np.array([np.cos(bearings[i]),
                                                   np.sin(bearings[i])]),
                         rng.uniform(-0.3, 0.3, 2), rng.uniform(-np.pi, np.pi))
                        for i, kind in enumerate(OBJECTS)]
        # static structures around the scene's path, which successive
        # sweeps see again: the clutter of a multisweep frame clusters
        mid, _ = self.ego(8.0)
        r = LANDMARK_DISC_M * np.sqrt(rng.uniform(0, 1, LANDMARKS))
        a = rng.uniform(-np.pi, np.pi, LANDMARKS)
        self.landmarks = mid + np.stack([r * np.cos(a), r * np.sin(a)], 1)

    def ego(self, t: float) -> Tuple[np.ndarray, float]:
        """The ego's global (x, y) and yaw at `t` seconds into the scene."""
        yaw = self.yaw0 + EGO_YAW_RATE * t
        r = EGO_SPEED / EGO_YAW_RATE
        xy = self.start + r * np.array([np.sin(yaw) - np.sin(self.yaw0),
                                        np.cos(self.yaw0) - np.cos(yaw)])
        return xy, yaw

    def object_pose(self, i: int, t: float) -> Tuple[np.ndarray, float]:
        """Object i's global (x, y) and yaw at `t`."""
        _, offset, drift, heading = self.objects[i]
        xy, yaw = self.ego(t)
        return xy + _rot(yaw) @ (offset + drift * t), yaw + heading

    def object_velocity(self, i: int, t: float) -> np.ndarray:
        dt = 1e-3
        return (self.object_pose(i, t + dt)[0]
                - self.object_pose(i, t - dt)[0]) / (2 * dt)


def _sweep_points(rng, scene: _Scene, chan: str, t: float,
                  points: int) -> np.ndarray:
    """One radar sweep at `t`: the returns of each object the radar sees,
    inside its box, then static clutter in the radar's field of view, in
    the radar's frame; `points` rows in PCD_DTYPE (more where the objects'
    returns alone exceed it)."""
    mx, my, _, myaw = RADAR_MOUNTS[chan]
    ego_xy, ego_yaw = scene.ego(t)
    s_yaw = ego_yaw + np.deg2rad(myaw)
    s_xy = ego_xy + _rot(ego_yaw) @ np.array([mx, my])
    to_sensor = _rot(s_yaw).T
    ego_v = scene.ego(t + 1e-3)[0] - scene.ego(t - 1e-3)[0]
    ego_v = to_sensor @ (ego_v / 2e-3)
    xy, v, rcs = [], [], []
    for i, (kind, *_rest) in enumerate(scene.objects):
        _, w, length, _, returns, o_rcs, _ = kind
        center, yaw = scene.object_pose(i, t)
        local = to_sensor @ (center - s_xy)
        if not (local[0] > 1.0 and np.hypot(*local) < RANGE_M and abs(
                np.degrees(np.arctan2(local[1], local[0]))) < FOV_DEG):
            continue
        # inside the box's footprint, a margin from its edges
        box = rng.uniform(-0.4, 0.4, (returns, 2)) * [length, w]
        glob_xy = center + box @ _rot(yaw).T
        xy.append((glob_xy - s_xy) @ to_sensor.T)
        v.append(np.tile(to_sensor @ scene.object_velocity(i, t),
                         (returns, 1)))
        rcs.append(rng.normal(o_rcs, 2.0, returns))
    clutter = max(points - sum(len(a) for a in xy), 0)
    # clutter: the landmarks in the field of view, with 0.25 m of noise,
    # the rest (if too few are in view) anywhere in it
    seen = (scene.landmarks - s_xy) @ to_sensor.T
    dist = np.hypot(seen[:, 0], seen[:, 1])
    seen = seen[(dist > 2.0) & (dist < 80.0) & (np.abs(np.degrees(
        np.arctan2(seen[:, 1], seen[:, 0]))) < 65.0)]
    seen = seen[rng.permutation(len(seen))[:clutter]]
    xy.append(seen + rng.normal(0.0, 0.25, seen.shape))
    rest = clutter - len(seen)
    rng_m = rng.uniform(2.0, 80.0, rest)
    az = np.deg2rad(rng.uniform(-65.0, 65.0, rest))
    xy.append(np.stack([rng_m * np.cos(az), rng_m * np.sin(az)], axis=1))
    v.append(rng.normal(0.0, 0.1, (clutter, 2)))
    rcs.append(rng.normal(-5.0, 5.0, clutter))
    xy, v, rcs = (np.concatenate(a) for a in (xy, v, rcs))
    rows = np.zeros(len(xy), PCD_DTYPE)
    rows["x"], rows["y"] = xy[:, 0], xy[:, 1]
    rows["z"] = rng.normal(0.0, 0.2, len(xy))
    rows["dyn_prop"] = rng.integers(0, 8, len(xy))
    rows["id"] = np.arange(len(xy))
    rows["rcs"] = rcs
    rows["vx_comp"], rows["vy_comp"] = v[:, 0], v[:, 1]
    rows["vx"], rows["vy"] = v[:, 0] - ego_v[0], v[:, 1] - ego_v[1]
    rows["is_quality_valid"] = 1
    rows["ambig_state"] = 3
    rows["x_rms"] = rng.integers(0, 20, len(xy))
    rows["y_rms"] = rng.integers(0, 20, len(xy))
    rows["pdh0"] = 1
    rows["vx_rms"] = rng.integers(0, 20, len(xy))
    rows["vy_rms"] = rng.integers(0, 20, len(xy))
    return rows


def write_pcd(path: str, rows: np.ndarray) -> None:
    """A binary PCD file of PCD_DTYPE rows, with the nuScenes header."""
    header = "\n".join([
        "# .PCD v0.7 - Point Cloud Data file format", "VERSION 0.7",
        "FIELDS " + " ".join(n for n, _, _ in PCD_FIELDS),
        "SIZE " + " ".join(str(s) for _, _, s in PCD_FIELDS),
        "TYPE " + " ".join(t for _, t, _ in PCD_FIELDS),
        "COUNT " + " ".join("1" for _ in PCD_FIELDS),
        f"WIDTH {len(rows)}", "HEIGHT 1", "VIEWPOINT 0 0 0 1 0 0 0",
        f"POINTS {len(rows)}", "DATA binary", ""])
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rows.astype(PCD_DTYPE).tobytes())


def write_nuscenes_tables(root: str, scenes: Sequence[Tuple[str, str, int]],
                          version: str = "v1.0-mini", sweeps: int = 1,
                          points_per_sweep: int = 30) -> str:
    """Writes a nuScenes-format dataset under `root`/raw: the JSON tables in
    `root`/raw/`version` and the radar sweeps as binary PCD files in
    `root`/raw/sweeps. Returns `root`.

    `scenes` gives each scene's (token, name, samples); the dataset
    creation matches a split's entry against either. Samples are 0.5 s
    apart. Each of the five radars has, at each sample, its key-frame
    sweep and `sweeps` - 1 earlier non-key sweeps 75 ms apart, chained by
    prev and next through the scene, each sweep with an ego pose of its
    own on a path with speed and yaw rate. Every sweep holds
    `points_per_sweep` returns, +-1/8: those of the objects in the radar's
    field of view, inside their boxes, and clutter, mostly the scene's
    static landmarks in view. Each scene has
    one instance of each of OBJECTS, moving across the samples, with
    annotations chained by prev and next. The second annotation of the
    last scene's first instance records no lidar or radar point (the
    dataset creation and the eval drop such boxes). The tables are made
    from seed 0."""
    rng = np.random.default_rng(0)
    raw = os.path.join(root, "raw")
    table_dir = os.path.join(raw, version)
    os.makedirs(table_dir)
    os.makedirs(os.path.join(raw, "sweeps"), exist_ok=True)
    tables: Dict[str, list] = {t: [] for t in (
        "scene", "sample", "sample_data", "sample_annotation", "ego_pose",
        "calibrated_sensor", "category", "instance", "attribute", "sensor")}
    categories = sorted({o[0] for o in OBJECTS})
    tables["category"] = [{"token": f"cat_{i}", "name": name}
                          for i, name in enumerate(categories)]
    attributes = sorted({o[6] for o in OBJECTS if o[6]})
    tables["attribute"] = [{"token": f"attr_{i}", "name": name}
                           for i, name in enumerate(attributes)]
    for chan in RADAR_CHANNELS + ("LIDAR_TOP",):
        x, y, z, yaw = RADAR_MOUNTS.get(chan, (0.0, 0.0, 1.84, 0.0))
        tables["sensor"].append({"token": f"sensor_{chan}", "channel": chan,
                                 "modality": "lidar" if chan == "LIDAR_TOP"
                                 else "radar"})
        tables["calibrated_sensor"].append({
            "token": f"cs_{chan}", "sensor_token": f"sensor_{chan}",
            "translation": [x, y, z], "rotation": _yaw_quat(np.deg2rad(yaw)),
            "camera_intrinsic": []})

    for s_i, (scene_token, scene_name, n_samples) in enumerate(scenes):
        scene = _Scene(rng)
        t0 = 1_532_402_900_000_000 + s_i * 100_000_000
        poses = {}

        def pose(ts: int) -> str:
            if ts not in poses:
                xy, yaw = scene.ego((ts - t0) * 1e-6)
                poses[ts] = f"pose_{s_i}_{ts}"
                tables["ego_pose"].append({
                    "token": poses[ts], "timestamp": ts,
                    "translation": [float(xy[0]), float(xy[1]), 0.0],
                    "rotation": _yaw_quat(yaw)})
            return poses[ts]

        # no "_" in a sample token: the graph files' names end in it
        samples = [f"sample{s_i}x{k}" for k in range(n_samples)]
        tables["scene"].append({
            "token": scene_token, "name": scene_name,
            "nbr_samples": n_samples, "first_sample_token": samples[0],
            "last_sample_token": samples[-1]})
        instances = [f"inst_{s_i}_{i}" for i in range(len(scene.objects))]
        for i, (kind, *_rest) in enumerate(scene.objects):
            tables["instance"].append({
                "token": instances[i],
                "category_token": f"cat_{categories.index(kind[0])}"})
        chain = {chan: [] for chan in RADAR_CHANNELS}
        for k, token in enumerate(samples):
            ts = t0 + (sweeps - 1) * SWEEP_US + k * SAMPLE_US
            data, anns = {}, []
            for chan in RADAR_CHANNELS:
                for j in range(sweeps - 1, -1, -1):
                    sd = f"sd_{s_i}_{k}_{chan}" + (f"_{j}" if j else "")
                    sweep_ts = ts - j * SWEEP_US
                    rows = _sweep_points(
                        rng, scene, chan, (sweep_ts - t0) * 1e-6,
                        int(rng.integers(points_per_sweep * 7 // 8,
                                         points_per_sweep * 9 // 8 + 1)))
                    fname = f"sweeps/{sd}.pcd"
                    write_pcd(os.path.join(raw, fname), rows)
                    chain[chan].append({
                        "token": sd, "sample_token": token,
                        "ego_pose_token": pose(sweep_ts),
                        "calibrated_sensor_token": f"cs_{chan}",
                        "timestamp": sweep_ts, "filename": fname,
                        "fileformat": "pcd", "is_key_frame": j == 0})
                data[chan] = f"sd_{s_i}_{k}_{chan}"
            lidar = f"sd_{s_i}_{k}_LIDAR_TOP"
            tables["sample_data"].append({
                "token": lidar, "sample_token": token,
                "ego_pose_token": pose(ts),
                "calibrated_sensor_token": "cs_LIDAR_TOP", "timestamp": ts,
                "filename": "", "fileformat": "pcd", "is_key_frame": True,
                "prev": f"sd_{s_i}_{k - 1}_LIDAR_TOP" if k else "",
                "next": (f"sd_{s_i}_{k + 1}_LIDAR_TOP"
                         if k + 1 < n_samples else "")})
            data["LIDAR_TOP"] = lidar
            for i, (kind, *_rest) in enumerate(scene.objects):
                _, w, length, h, returns, _, attr = kind
                xy, yaw = scene.object_pose(i, (ts - t0) * 1e-6)
                ann = f"ann_{s_i}_{k}_{i}"
                anns.append(ann)
                empty = s_i == len(scenes) - 1 and i == 0 and k == 1
                tables["sample_annotation"].append({
                    "token": ann, "sample_token": token,
                    "instance_token": instances[i],
                    "translation": [float(xy[0]), float(xy[1]), h / 2],
                    "size": [w, length, h], "rotation": _yaw_quat(yaw),
                    "num_lidar_pts": 0 if empty else 12,
                    "num_radar_pts": 0 if empty else returns,
                    "attribute_tokens": ([f"attr_{attributes.index(attr)}"]
                                         if attr else []),
                    "visibility_token": "4",
                    "prev": f"ann_{s_i}_{k - 1}_{i}" if k else "",
                    "next": (f"ann_{s_i}_{k + 1}_{i}"
                             if k + 1 < n_samples else "")})
            tables["sample"].append({
                "token": token, "timestamp": ts, "scene_token": scene_token,
                "data": data, "anns": anns,
                "prev": samples[k - 1] if k else "",
                "next": samples[k + 1] if k + 1 < n_samples else ""})
        for rows in chain.values():
            for a, row in enumerate(rows):
                row["prev"] = rows[a - 1]["token"] if a else ""
                row["next"] = rows[a + 1]["token"] if a + 1 < len(rows) else ""
            tables["sample_data"] += rows

    for name, rows in tables.items():
        with open(os.path.join(table_dir, f"{name}.json"), "w") as f:
            json.dump(rows, f)
    return root


# -- the end-to-end run -------------------------------------------------------

# the JAX script's run: two v1.0-mini scenes of 3 samples, one sweep of 30
# returns a radar, a kNN graph of k 4, conv [16, 16], 4 epochs of batch 2
SCENES = (("scenetok0", "scene-0061", 3), ("scenetok1", "scene-0103", 3))
POINTS_PER_SWEEP = 30
SEED = 7


def run(device: DeviceLike, folder: str) -> Dict:
    """The end-to-end run, its files in `folder`; returns the train losses,
    the nuScenes metrics and the evaluation folder."""
    dev = resolve_device(device)
    root = write_nuscenes_tables(os.path.join(folder, "nuscenes"), SCENES,
                                 points_per_sweep=POINTS_PER_SWEEP)
    gcfg = GraphConstructionConfiguration(
        "knn", {"k": 4, "r": 1.0}, ["rcs", "velocity_vector", "degree"],
        ["relative_position"], "directed", "X")
    dcfg = NuScenesDatasetConfiguration(
        version="v1.0-mini", nsweeps=1, crop_point_cloud=True,
        crop_settings={"x": 100, "y": 100}, bb_invariance="translation")
    NuScenesGraphDataset(root, gcfg, dcfg)

    arch = GNNArchitectureConfig(
        # rcs (1), velocity_vector (2), degree (1); relative_position (2)
        node_feature_dimension=4, edge_feature_dimension=2,
        conv_layer_dimensions=[16, 16],
        classification_head_layer_dimensions=[11],
        regression_head_layer_dimensions=[8, 5],
        initial_node_feature_embedding=True,
        initial_edge_feature_embedding=True,
        node_feature_embedding_layer_dimensions=[8, 16],
        edge_feature_embedding_layer_dimensions=[4, 8],
        batch_norm_in_mlps=False, compute_dtype="bfloat16",
        assume_sorted_edges=True)
    tcfg = TrainingConfig(dataset="nuscenes", learning_rate=3e-3, epochs=4,
                          batch_size=2, shuffle=True, bg_index=0,
                          deterministic=True, seed=SEED,
                          adapt_orientation_angle=True, bb_loss_weight=0.5)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    try:
        set_seeds(SEED, deterministic=True)
        loaders, _ = get_data_loaders(
            ["train", "validate"], os.path.join(root, "processed"),
            batch_size=2, shuffle=True, bg_index=0, seed=SEED,
            csr_tiling=fused_csr_tiling(arch, k=gcfg.k), device=dev)
        model = DetNet(arch, device=dev, seed=SEED)
        trainer = Trainer(tcfg, model)
        trainer.fit(loaders, verbose=False)
    finally:
        torch.use_deterministic_algorithms(was_deterministic)

    config = PostProcessingConfiguration(
        split="validate", iou_for_nms=0.01,
        min_object_score={n: 0.2 for n in
                          ("barrier", "bicycle", "bus", "car", "construction",
                           "motorcycle", "pedestrian", "trafficcone",
                           "trailer", "truck")},
        max_score_for_background=0.6, iou_for_mAP=0.3, use_point_iou=True,
        bg_index=0, bb_invariance="translation", adapt_orientation_angle=True)
    preds, gts, pos, vel = Predictor(model, loaders["validate"],
                                     verbose=False).predict()
    bb_p, bb_g, cls_p, cls_g = Postprocessor(dev).process(
        config, pos, vel, preds, gts)
    cls_pred_label = PredictionExtractor().extract(preds)
    graph_names = sorted(glob.glob(os.path.join(root, "processed", "validate",
                                                "*.npz")))
    model_dir = os.path.join(folder, "model")
    os.makedirs(model_dir)
    ev = NuscenesEvaluator(config=config, version="v1.0-mini",
                           dataset_path=os.path.join(root, "raw"),
                           model_path=model_dir, device=dev)
    ev.evaluate(bb_p, bb_g, cls_p, cls_pred_label, cls_g, vel,
                graph_names=graph_names)
    eval_folder = ev.save_results()
    with open(os.path.join(eval_folder, "nuscenes_metrics.json")) as f:
        metrics = json.load(f)
    return {"device": str(dev), "train_loss": [float(x) for x in
                                               trainer.train_loss],
            "metrics": metrics, "eval_folder": eval_folder}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card)")
    args = parser.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="nusc_torch_") as folder:
        res = run(args.device, folder)
    print("device:", res["device"])
    print("losses:", [round(x, 3) for x in res["train_loss"]])
    print("NUSC-TORCH ok: mAP=%.4f NDS=%.4f" % (res["metrics"]["mean_ap"],
                                                res["metrics"]["nd_score"]))


if __name__ == "__main__":
    main()
