"""RadarScenes graph-dataset creation: raw sequences -> per-frame GraphSamples.

Port of `radargnn_tpu/data/radarscenes/dataset_creation.py` (host numpy;
graphs from `graph.build`, ground truth from `data.ground_truth`):

  * 0.5 s scene-accumulation windows per frame,
  * crop + invalid-point filtering,
  * kNN/radius graph + invariant features,
  * GT class labels + 2D boxes in all three invariance encodings,
  * per-split `graph_<i>.npz` GraphSamples + `config.json` provenance,
  * sequences processed in parallel by a process pool; the graphs are
    written in sequence-submission order whatever the completion order.

The pool's workers start by `spawn`: a parent that holds the CUDA card
must not hand it to a forked child. They run numpy only and never touch
the card.
"""

from __future__ import annotations

import dataclasses
import json
import multiprocessing as mp
import os
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np

from radargnn_tpu_torch.configs import (
    GraphConstructionConfiguration, RadarScenesDatasetConfiguration,
    RadarScenesSplitConfiguration,
)
from radargnn_tpu_torch.data.ground_truth import create_2d_bounding_boxes
from radargnn_tpu_torch.data.point_cloud import RadarPointCloud
from radargnn_tpu_torch.data.radarscenes.reader import Sequence
from radargnn_tpu_torch.data.radarscenes.scene_collection import (
    concatenate_subsequent_scenes,
)
from radargnn_tpu_torch.graph.batch import GraphSample
from radargnn_tpu_torch.graph.build import build_geometric_graph


class PointCloudProcessor:
    """Crop + invalid-point removal."""

    @staticmethod
    def transform(dataset_config: RadarScenesDatasetConfiguration,
                  point_cloud: RadarPointCloud) -> RadarPointCloud:
        if dataset_config.crop_point_cloud:
            front = dataset_config.crop_settings.get("front")
            sides = dataset_config.crop_settings.get("sides")
            point_cloud.remove_points_out_of_range(front, sides)
        point_cloud.remove_points_without_labelID()
        point_cloud.remove_points_without_valid_velocity()
        return point_cloud


def create_point_cloud_frames(path_to_radarscenes: str, sequence_name: str,
                              dataset_config: RadarScenesDatasetConfiguration
                              ) -> List[RadarPointCloud]:
    """One sequence -> list of accumulated + preprocessed point-cloud frames,
    subsampled evenly where a small subset is asked for."""
    path = f"{path_to_radarscenes}/data/{sequence_name}/scenes.json"
    sequence = Sequence.from_json(path)
    timestamps = sequence.timestamps

    start = int(timestamps.min())
    end_final = int(timestamps.max())
    end = 0

    point_clouds = []
    while end != end_final:
        collection = concatenate_subsequent_scenes(
            sequence, start, dataset_config.time_per_point_cloud_frame)
        last_scene = collection.scenes[-1]
        collection.process(use_reduced_classes=True)
        pc = PointCloudProcessor.transform(dataset_config, collection.point_cloud)
        point_clouds.append(pc)
        start = last_scene.timestamp
        end = last_scene.timestamp

    if dataset_config.create_small_subset and \
            "num_clouds_per_sequence" in (dataset_config.subset_settings or {}):
        avail = len(point_clouds)
        allowed = dataset_config.subset_settings["num_clouds_per_sequence"]
        idx = np.floor(np.linspace(0, avail - 1, allowed)).astype(int)
        point_clouds = [point_clouds[i] for i in idx]
    return point_clouds


def create_graph_sample(graph, target: np.ndarray, bounding_box: np.ndarray,
                        point_cloud: RadarPointCloud) -> GraphSample:
    """Graph arrays + ground truth -> GraphSample (labels and boxes as
    separate arrays)."""
    return GraphSample(
        node_feat=graph.node_feat.astype(np.float32),
        edge_feat=graph.edge_feat.astype(np.float32),
        senders=graph.senders.astype(np.int32),
        receivers=graph.receivers.astype(np.int32),
        labels=np.asarray(target).reshape(-1).astype(np.int32),
        boxes=bounding_box.astype(np.float32),
        pos=point_cloud.X_cc.astype(np.float32),
        vel=point_cloud.V_cc_compensated.astype(np.float32))


def create_graph_data_from_one_sequence(
        graph_config: GraphConstructionConfiguration,
        dataset_config: RadarScenesDatasetConfiguration,
        sequence_name: str, path_to_radarscenes: str) -> List[GraphSample]:
    """Every frame of one sequence with more than one point as a
    GraphSample."""
    point_clouds = create_point_cloud_frames(
        path_to_radarscenes, sequence_name, dataset_config)
    samples = []
    for pc in point_clouds:
        if pc.num_points > 1:
            graph = build_geometric_graph(
                graph_config, pc.X_cc, pc.V_cc_compensated,
                rcs=pc.rcs, timestamps=pc.timestamp)
            target = pc.label_id
            boxes = create_2d_bounding_boxes(
                pc.X_cc, pc.track_id,
                dataset_config.bounding_boxes_aligned,
                dataset_config.bb_invariance)
            samples.append(create_graph_sample(graph, target, boxes, pc))
    return samples


def _worker(args):
    graph_config, dataset_config, seq, root = args
    return create_graph_data_from_one_sequence(
        graph_config, dataset_config, seq, root)


class RadarScenesGraphDataset:
    """Split orchestration + npz serialization. Creating the object runs
    `process()` unless `process=False`."""

    def __init__(self, root: str, graph_config: GraphConstructionConfiguration,
                 dataset_config: RadarScenesDatasetConfiguration,
                 process: bool = True, num_workers: Optional[int] = None):
        self.root = root
        self.graph_config = graph_config
        self.dataset_config = dataset_config
        self.num_workers = num_workers
        if process:
            self.process()

    @property
    def raw_dir(self) -> str:
        return os.path.join(self.root, "raw")

    @property
    def processed_dir(self) -> str:
        return os.path.join(self.root, "processed")

    def process(self) -> None:
        if self.dataset_config.deterministic:
            np.random.seed(self.dataset_config.seed)

        sequence_file = os.path.join(self.raw_dir, "data", "sequences.json")
        split_config = RadarScenesSplitConfiguration(sequence_file)

        os.makedirs(self.processed_dir, exist_ok=True)
        self.write_description(split_config)

        for split, sequences in split_config.sequence_dict.items():
            split_dir = os.path.join(self.processed_dir, split)
            os.makedirs(split_dir, exist_ok=True)
            self._process_split(split_dir, sequences)

    def _process_split(self, split_dir: str, sequences: List[str]) -> None:
        tasks = [(self.graph_config, self.dataset_config, seq, self.raw_dir)
                 for seq in sequences]
        idx = 0
        if self.dataset_config.parallelize and len(sequences) > 1:
            workers = min(self.num_workers or os.cpu_count(), len(tasks))
            with ProcessPoolExecutor(max_workers=workers,
                                     mp_context=mp.get_context("spawn")) as pool:
                for samples in pool.map(_worker, tasks):
                    idx = self._write_samples(split_dir, samples, idx)
        else:
            for task in tasks:
                idx = self._write_samples(split_dir, _worker(task), idx)

    @staticmethod
    def _write_samples(split_dir: str, samples: List[GraphSample],
                       start_idx: int) -> int:
        for i, sample in enumerate(samples):
            sample.save_npz(os.path.join(split_dir,
                                         f"graph_{start_idx + i}.npz"))
        return start_idx + len(samples)

    def write_description(self, split_config) -> None:
        """`processed/config.json`: the graph, dataset and split
        configurations the graphs were made with."""
        json_dict = {
            "GRAPH_CONSTRUCTION_SETTINGS": dataclasses.asdict(self.graph_config),
            "DATASET_CONFIG": dataclasses.asdict(self.dataset_config),
            "DATASET_SPLIT_CONFIG": dataclasses.asdict(split_config),
        }
        with open(os.path.join(self.processed_dir, "config.json"), "w") as f:
            json.dump(json_dict, f, indent=4)

    def len(self, split_name: str) -> int:
        return len(os.listdir(os.path.join(self.processed_dir, split_name)))

    def get(self, split_name: str, idx: int) -> GraphSample:
        return GraphSample.load_npz(
            os.path.join(self.processed_dir, split_name, f"graph_{idx}.npz"))
