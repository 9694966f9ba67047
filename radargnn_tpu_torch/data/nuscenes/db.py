"""Native nuScenes database reader, in place of the nuscenes-devkit.

Port of `radargnn_tpu/data/nuscenes/db.py` (host numpy). The nuScenes
on-disk format is a set of JSON tables
(`<dataroot>/<version>/{scene,sample,sample_data,sample_annotation,ego_pose,
calibrated_sensor,category,instance,attribute,sensor}.json`) plus sensor
files; radar sweeps are PCD files with an ASCII header and a binary
payload. This module gives the devkit surface the pipeline reads:
`NuScenes`, `Box` and `RadarPointCloud.from_file_multisweep`.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

from radargnn_tpu_torch.data.nuscenes.quaternion import Quaternion

TABLES = ("scene", "sample", "sample_data", "sample_annotation", "ego_pose",
          "calibrated_sensor", "category", "instance", "attribute", "sensor")

RADAR_CHANNELS = ("RADAR_FRONT", "RADAR_FRONT_LEFT", "RADAR_FRONT_RIGHT",
                  "RADAR_BACK_LEFT", "RADAR_BACK_RIGHT")

# nuScenes radar point layout: 18 rows a point (the dataset creation
# appends the time lag as a 19th)
RADAR_NBR_DIMS = 18


class Box:
    """3D bounding box: center, size (w, l, h), orientation quaternion.

    The devkit `nuscenes.Box` surface the pipeline uses:
    translate/rotate/corners/bottom_corners/center/wlh/label/name/token.
    """

    def __init__(self, center, size, orientation: Quaternion, label: int = -1,
                 name: str = "", token: str = "", velocity=(np.nan,) * 3):
        self.center = np.asarray(center, dtype=np.float64)
        self.wlh = np.asarray(size, dtype=np.float64)       # width, length, height
        self.orientation = orientation
        self.label = label
        self.name = name
        self.token = token
        self.velocity = np.asarray(velocity, dtype=np.float64)

    def translate(self, x: np.ndarray) -> None:
        self.center = self.center + np.asarray(x, dtype=np.float64)

    def rotate(self, quaternion: Quaternion) -> None:
        self.center = quaternion.rotate(self.center)
        self.orientation = quaternion * self.orientation
        if np.isfinite(self.velocity).all():
            self.velocity = quaternion.rotate(self.velocity)

    def corners(self, wlh_factor: float = 1.0) -> np.ndarray:
        """(3, 8) corner matrix in devkit order: x-axis→length, first four
        corners at +l/2 (front), order (+w,+h),(+w,-h)? — devkit order:
        corners 0-3 front face clockwise from top-left, 4-7 rear."""
        w, l, h = self.wlh * wlh_factor
        # devkit: x_corners = l/2 * [1,1,1,1,-1,-1,-1,-1]
        #         y_corners = w/2 * [1,-1,-1,1,1,-1,-1,1]
        #         z_corners = h/2 * [1,1,-1,-1,1,1,-1,-1]
        x_c = l / 2 * np.array([1, 1, 1, 1, -1, -1, -1, -1])
        y_c = w / 2 * np.array([1, -1, -1, 1, 1, -1, -1, 1])
        z_c = h / 2 * np.array([1, 1, -1, -1, 1, 1, -1, -1])
        corners = np.vstack([x_c, y_c, z_c])
        corners = self.orientation.rotation_matrix @ corners
        return corners + self.center.reshape(3, 1)

    def bottom_corners(self) -> np.ndarray:
        """(3, 4) bottom face corners (devkit: columns [2, 3, 7, 6])."""
        return self.corners()[:, [2, 3, 7, 6]]


# PCD (TYPE, SIZE) -> little-endian numpy scalar type
PCD_TYPES = {("F", 4): "<f4", ("F", 8): "<f8",
             ("I", 1): "<i1", ("I", 2): "<i2", ("I", 4): "<i4",
             ("I", 8): "<i8",
             ("U", 1): "<u1", ("U", 2): "<u2", ("U", 4): "<u4",
             ("U", 8): "<u8"}


def _read_pcd_header(f) -> Dict[str, str]:
    header = {}
    while True:
        raw = f.readline()
        if not raw:
            raise ValueError(f"PCD file {f.name} ends before its DATA line")
        line = raw.decode("ascii", errors="replace").strip()
        if not line or line.startswith("#"):
            continue
        key, _, value = line.partition(" ")
        header[key] = value
        if key == "DATA":
            return header


def parse_pcd(path: str) -> np.ndarray:
    """Parses a PCD file (ASCII header, binary or ASCII payload) into a
    (D, N) float64 array, one row per scalar of the header's
    FIELDS/SIZE/TYPE/COUNT declarations: the format of nuScenes radar
    sweeps. The binary payload is read in one pass through a packed
    structured dtype built from the header."""
    with open(path, "rb") as f:
        header = _read_pcd_header(f)
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header["POINTS"])
        scalars = [PCD_TYPES[(t, s)] for t, s, c in zip(types, sizes, counts)
                   for _ in range(c)]

        if header["DATA"] == "binary":
            row = np.dtype([(f"c{j}", t) for j, t in enumerate(scalars)])
            table = np.frombuffer(f.read(row.itemsize * n), dtype=row,
                                  count=n)
            return np.stack([table[name].astype(np.float64)
                             for name in row.names]).reshape(len(scalars), n)
        if header["DATA"] == "ascii":
            rows = [list(map(float, f.readline().split())) for _ in range(n)]
            return np.asarray(rows, dtype=np.float64).reshape(n, -1).T
        raise ValueError(f"unsupported PCD DATA mode {header['DATA']}")


class NuScenes:
    """Token-indexed access to the nuScenes JSON tables."""

    def __init__(self, version: str, dataroot: str, verbose: bool = False):
        self.version = version
        self.dataroot = dataroot
        table_dir = os.path.join(dataroot, version)
        self._tables: Dict[str, list] = {}
        self._index: Dict[str, dict] = {}
        for table in TABLES:
            path = os.path.join(table_dir, f"{table}.json")
            rows = []
            if os.path.exists(path):
                with open(path) as f:
                    rows = json.load(f)
            self._tables[table] = rows
            self._index[table] = {r["token"]: r for r in rows}
        if verbose:
            for t, rows in self._tables.items():
                print(f"{len(rows)} {t}")

        # category token -> name, instance token -> category name
        self._category_name = {r["token"]: r["name"]
                               for r in self._tables["category"]}

    def get(self, table: str, token: str) -> dict:
        return self._index[table][token]

    @property
    def scene(self) -> list:
        return self._tables["scene"]

    @property
    def sample(self) -> list:
        return self._tables["sample"]

    @property
    def sample_annotation(self) -> list:
        return self._tables["sample_annotation"]

    def get_sample_data_path(self, sample_data_token: str) -> str:
        sd = self.get("sample_data", sample_data_token)
        return os.path.join(self.dataroot, sd["filename"])

    def box_from_annotation(self, ann: dict) -> Box:
        instance = self.get("instance", ann["instance_token"])
        name = self._category_name[instance["category_token"]]
        return Box(ann["translation"], ann["size"],
                   Quaternion(ann["rotation"]), name=name, token=ann["token"])

    def box_velocity(self, sample_annotation_token: str,
                     max_time_diff: float = 1.5) -> np.ndarray:
        """Global-frame box velocity [vx, vy, vz] by finite difference over
        the instance's neighboring annotations — devkit
        `NuScenes.box_velocity` semantics (the official detection eval
        computes ground-truth velocities this way): centered difference over (prev, next) when
        both exist, one-sided otherwise, NaN for single annotations or when
        the time gap exceeds `max_time_diff` seconds (doubled for the
        centered case)."""
        current = self.get("sample_annotation", sample_annotation_token)
        has_prev = current["prev"] != ""
        has_next = current["next"] != ""
        if not has_prev and not has_next:
            return np.array([np.nan, np.nan, np.nan])

        first = self.get("sample_annotation", current["prev"]) \
            if has_prev else current
        last = self.get("sample_annotation", current["next"]) \
            if has_next else current

        pos_diff = (np.asarray(last["translation"], float)
                    - np.asarray(first["translation"], float))
        time_last = 1e-6 * self.get("sample", last["sample_token"])[
            "timestamp"]
        time_first = 1e-6 * self.get("sample", first["sample_token"])[
            "timestamp"]
        time_diff = time_last - time_first

        if has_next and has_prev:
            # centered difference spans two keyframe gaps
            max_time_diff *= 2
        if time_diff > max_time_diff:
            return np.array([np.nan, np.nan, np.nan])
        return pos_diff / time_diff

    def get_boxes(self, sample_data_token: str) -> List[Box]:
        """Boxes (global frame) for a sample_data. Key frames only: the
        dataset creation queries `sample['data'][sensor]`, a key frame, so
        no interpolation between annotations is needed."""
        sd = self.get("sample_data", sample_data_token)
        sample = self.get("sample", sd["sample_token"])
        return [self.box_from_annotation(self.get("sample_annotation", t))
                for t in sample["anns"]]


class RadarPointCloudLoader:
    """Devkit `RadarPointCloud.from_file_multisweep` equivalent."""

    @staticmethod
    def nbr_dims() -> int:
        return RADAR_NBR_DIMS

    @staticmethod
    def from_file_multisweep(nusc: NuScenes, sample: dict, chan: str,
                             ref_chan: str, nsweeps: int = 1,
                             min_distance: float = 1.0):
        """Aggregates `nsweeps` sweeps of `chan` into the reference channel's
        sensor frame at the sample timestamp. Returns (points [18, N],
        timestamps [N] time-lag seconds)."""
        ref_sd = nusc.get("sample_data", sample["data"][ref_chan])
        ref_cs = nusc.get("calibrated_sensor", ref_sd["calibrated_sensor_token"])
        ref_pose = nusc.get("ego_pose", ref_sd["ego_pose_token"])
        ref_time = ref_sd["timestamp"] * 1e-6

        def inv_transform(rotation, translation):
            r = Quaternion(rotation).rotation_matrix.T
            t = -r @ np.asarray(translation, dtype=np.float64)
            return r, t

        ref_from_global_r, ref_from_global_t = inv_transform(
            ref_pose["rotation"], ref_pose["translation"])
        sens_from_car_r, sens_from_car_t = inv_transform(
            ref_cs["rotation"], ref_cs["translation"])

        all_points = np.zeros((RADAR_NBR_DIMS, 0))
        all_times = np.zeros((0,))

        sd = nusc.get("sample_data", sample["data"][chan])
        for _ in range(nsweeps):
            pts = parse_pcd(nusc.get_sample_data_path(sd["token"]))
            if pts.shape[0] < RADAR_NBR_DIMS:
                pad = np.zeros((RADAR_NBR_DIMS - pts.shape[0], pts.shape[1]))
                pts = np.vstack([pts, pad])
            pts = pts[:RADAR_NBR_DIMS]

            # min-distance filter (in the sweep's own sensor frame)
            keep = np.linalg.norm(pts[:2], axis=0) >= min_distance
            pts = pts[:, keep]

            cs = nusc.get("calibrated_sensor", sd["calibrated_sensor_token"])
            pose = nusc.get("ego_pose", sd["ego_pose_token"])

            # sweep sensor frame -> global
            r1 = Quaternion(cs["rotation"]).rotation_matrix
            t1 = np.asarray(cs["translation"], dtype=np.float64)
            r2 = Quaternion(pose["rotation"]).rotation_matrix
            t2 = np.asarray(pose["translation"], dtype=np.float64)
            xyz = pts[:3]
            xyz = r2 @ (r1 @ xyz + t1[:, None]) + t2[:, None]
            # global -> ref sensor frame
            xyz = sens_from_car_r @ (
                ref_from_global_r @ xyz + ref_from_global_t[:, None]) \
                + sens_from_car_t[:, None]
            pts[:3] = xyz

            lag = ref_time - sd["timestamp"] * 1e-6
            all_points = np.hstack([all_points, pts])
            all_times = np.concatenate([all_times,
                                        np.full(pts.shape[1], lag)])

            if not sd["prev"]:
                break
            sd = nusc.get("sample_data", sd["prev"])

        return all_points, all_times
