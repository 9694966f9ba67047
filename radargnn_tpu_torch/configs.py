"""Typed configuration system: single 3-section YAML -> dataclasses.

Port of `radargnn_tpu/configs.py`. The YAML schema is identical
(CREATE_DATASET / TRAIN / EVALUATE sections with DATASET_PROCESSING,
GRAPH_CONSTRUCTION, MODEL_ARCHITECTURE, TRAINING, POSTPROCESSING subsections),
so the files in `configurations/` load verbatim.
"""

from __future__ import annotations

import dataclasses
import json
import logging
from dataclasses import dataclass, field
from typing import Optional

import yaml


def dataclass_from_dict(data_class, d):
    """Recursively converts a dict into a dataclass instance; leaf values
    that are not dataclass fields pass through unchanged."""
    try:
        fieldtypes = {f.name: f.type for f in dataclasses.fields(data_class)}
        return data_class(**{f: dataclass_from_dict(fieldtypes[f], d[f]) for f in d})
    except Exception:
        return d


# --------------------------------------------------------------------------
# Graph construction
# --------------------------------------------------------------------------

@dataclass
class GraphConstructionConfiguration:
    """Settings for building a graph from a point cloud."""

    graph_construction_algorithm: str       # "knn" | "radius"
    graph_construction_settings: dict       # {"k": int, "r": float}

    node_features: list
    edge_features: list
    edge_mode: str                          # "directed" | "undirected"

    distance_definition: str                # "X" | "XV"

    def __post_init__(self):
        if self.graph_construction_algorithm == "knn":
            self.k = self.graph_construction_settings.get("k")
            self.r = None
        elif self.graph_construction_algorithm == "radius":
            self.r = self.graph_construction_settings.get("r")
            self.k = None
        else:
            raise ValueError("Invalid graph construction algorithm selected")


# --------------------------------------------------------------------------
# Dataset creation
# --------------------------------------------------------------------------

@dataclass
class RadarScenesDatasetConfiguration:
    """Settings for creating point-cloud frames from RadarScenes."""

    time_per_point_cloud_frame: float
    crop_point_cloud: bool
    crop_settings: dict
    bounding_boxes_aligned: bool
    bb_invariance: str                      # "none" | "translation" | "en"
    create_small_subset: bool
    subset_settings: dict = None

    deterministic: bool = False
    seed: int = 0

    parallelize: bool = False


# The 28 held-out test sequences of the reference standard split: indices
# into the RadarScenes "training" sequence list; the rest become "train".
RADARSCENES_TEST_SPLIT_INDICES = frozenset({
    4, 6, 11, 16, 18, 24, 33, 34, 36, 37, 42, 44, 48, 52,
    53, 60, 63, 67, 73, 84, 86, 92, 94, 100, 108, 119, 124, 126,
})


@dataclass
class RadarScenesSplitConfiguration:
    """Train/test/validate split over RadarScenes sequences, parsed from the
    dataset's sequences.json: category "train" forms train+test (split by
    RADARSCENES_TEST_SPLIT_INDICES), category "validation" forms validate."""

    sequence_dict: dict

    def __init__(self, sequence_file: str = None, standard_split: bool = True,
                 train_sequences: list = (), test_sequences: list = (),
                 validate_sequences: list = ()):
        if standard_split:
            with open(sequence_file) as f:
                seq_meta = json.load(f)["sequences"]
            train_val = [name for name, meta in seq_meta.items()
                         if meta.get("category") == "train"]
            validate = [name for name, meta in seq_meta.items()
                        if meta.get("category") == "validation"]
            all_idx = set(range(len(train_val)))
            # indices beyond the sequence count are ignored (reduced and
            # synthetic datasets reuse the standard split)
            idx_test = {i for i in RADARSCENES_TEST_SPLIT_INDICES
                        if i < len(train_val)}
            idx_train = all_idx - idx_test
            self.sequence_dict = {
                "train": [train_val[i] for i in idx_train],
                "test": [train_val[i] for i in idx_test],
                "validate": validate,
            }
        else:
            self.sequence_dict = {
                "train": list(train_sequences),
                "test": list(test_sequences),
                "validate": list(validate_sequences),
            }


@dataclass
class NuScenesDatasetConfiguration:
    """Settings for creating point-cloud frames from nuScenes."""

    version: str = "v1.0-trainval"
    nsweeps: int = 1
    crop_point_cloud: bool = False
    crop_settings: dict = None
    wlh_factor: float = 1.0
    wlh_offset: float = 0.0
    bounding_boxes_aligned: bool = False
    bb_invariance: str = "translation"
    deterministic: bool = False
    seed: int = 0


@dataclass
class NuScenesSplitConfiguration:
    """Scene-name split for nuScenes: needs the vendored split tables, which
    arrive with the port's data pipelines."""

    sequence_dict: dict

    def __init__(self, version: str = "v1.0-mini"):
        raise NotImplementedError(
            "the nuScenes split tables are not ported yet (ROADMAP.md, "
            "item A8: data pipelines and CLI)")


# --------------------------------------------------------------------------
# Model / training
# --------------------------------------------------------------------------

@dataclass
class GNNArchitectureConfig:
    """GNN model architecture."""

    node_feature_dimension: int
    edge_feature_dimension: int

    conv_layer_dimensions: list
    classification_head_layer_dimensions: list
    regression_head_layer_dimensions: list

    initial_node_feature_embedding: bool = False
    initial_edge_feature_embedding: bool = False
    node_feature_embedding_layer_dimensions: list = None
    edge_feature_embedding_layer_dimensions: list = None
    conv_layer_type: str = "MPNNConv"

    batch_norm_in_mlps: bool = True
    conv_pre_mlp_layer_number: int = 1
    conv_post_mlp_layer_number: int = 1
    conv_use_edge_encoder: bool = False
    aggregation_function: str = "max"

    # matmul input dtype ("float32" | "bfloat16"); parameters and
    # reductions stay float32, products accumulate in float32
    compute_dtype: str = "float32"
    # edges are receiver-sorted within each graph (the stack_samples layout)
    assume_sorted_edges: bool = False
    # fused max aggregation over a tiled batch; None = AUTO, resolved in
    # __post_init__ to "the configuration is the hoisted one"
    use_fused_aggregation: Optional[bool] = None
    # tiling family of the fused path: "auto" (dense for kNN graphs,
    # windowed otherwise), "dense", "windowed" or "csr"; the port runs all
    # four
    fused_tiling: str = "auto"
    # static overflow-edge budget fraction of the tiling
    fused_overflow_fraction: float = 0.05
    # training-only knobs of the JAX package, kept so its YAMLs load
    fused_bf16_max: bool = False
    fused_run_cap: Optional[int] = 4
    halo_overflow_fraction: float = 0.5

    def __post_init__(self):
        # the fused aggregation accelerates exactly the hoisted configuration
        # (single linear pre-MLP + max aggregation); anything else runs the
        # unfused path, with a log line saying why
        if self.use_fused_aggregation is None:
            ok = (self.conv_pre_mlp_layer_number == 1
                  and self.aggregation_function == "max")
            self.use_fused_aggregation = ok
            if not ok:
                logging.getLogger(__name__).info(
                    "fused aggregation auto-disabled: requires "
                    "conv_pre_mlp_layer_number == 1 and "
                    "aggregation_function == 'max' (got %d, %r); "
                    "running the unfused aggregation path",
                    self.conv_pre_mlp_layer_number,
                    self.aggregation_function)


@dataclass
class TrainingConfig:
    """Training hyper-parameters."""

    dataset: str

    learning_rate: float
    epochs: int
    batch_size: int
    shuffle: bool

    bg_index: int

    deterministic: bool = False
    seed: int = 0

    class_weights: dict = field(default_factory=dict)
    set_weights_according_radar_scenes_distribution: bool = False
    val_class_weights: dict = field(default_factory=dict)

    bb_loss_weight: float = 1
    cls_loss_weight: float = 1

    regularization_strength: float = 1e-4
    reduce_lr_on_plateau_factor: float = 0.5
    reduce_lr_on_plateau_patience: int = 0
    exponential_lr_decay_factor: float = 0.0

    early_stopping_patience: int = 10

    adapt_orientation_angle: bool = False

    # extensions of the JAX package, kept so its YAMLs load
    max_nodes_per_graph: int = 0
    checkpoint_every_epochs: int = 0
    mesh_axes: dict = field(default_factory=dict)
    shard_params_over_model: bool = False
    scan_steps_per_dispatch: int = 1
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.dataset == "radarscenes":
            for name in ("car", "pedestrian", "pedestrian_group",
                         "two_wheeler", "large_vehicle"):
                self.class_weights.setdefault(name, 1)
            self.class_weights.setdefault("background", 0.05)
        elif self.dataset == "nuscenes":
            self.class_weights.setdefault("background", 0.05)
            for name in ("barrier", "bicycle", "bus", "car", "construction",
                         "motorcycle", "pedestrian", "trafficcone",
                         "trailer", "truck"):
                self.class_weights.setdefault(name, 1)
        else:
            raise ValueError("Only the radarscenes and nuscenes dataset are supported!")

        if self.val_class_weights:
            if set(self.class_weights) != set(self.val_class_weights):
                raise ValueError("val_class_weights must name the same "
                                 "classes as class_weights")
        else:
            self.val_class_weights = self.class_weights


# --------------------------------------------------------------------------
# Postprocessing / evaluation
# --------------------------------------------------------------------------

@dataclass
class PostProcessingConfiguration:
    """Postprocessing + evaluation settings."""

    split: str

    iou_for_nms: float
    min_object_score: dict
    max_score_for_background: float

    iou_for_mAP: float = 0.3
    use_point_iou: bool = False

    bg_index: int = 5

    bb_invariance: str = "translation"
    adapt_orientation_angle: bool = False

    get_mAP: bool = True
    get_confusion: bool = True
    get_segmentation_f1: bool = True
    f1_class_averaging: Optional[str] = None


# --------------------------------------------------------------------------
# Reader
# --------------------------------------------------------------------------

def _dataset_config_selector(dataset: str):
    return {
        "radarscenes": RadarScenesDatasetConfiguration,
        "nuscenes": NuScenesDatasetConfiguration,
    }[dataset]


class ConfigToDataClassMapping:
    """Maps each YAML subsection to its dataclass and its section."""

    @staticmethod
    def get_mapping_dicts(dataset: str):
        dataclass_mapping_dict = {
            "DATASET_PROCESSING": _dataset_config_selector(dataset),
            "GRAPH_CONSTRUCTION": GraphConstructionConfiguration,
            "MODEL_ARCHITECTURE": GNNArchitectureConfig,
            "TRAINING": TrainingConfig,
            "POSTPROCESSING": PostProcessingConfiguration,
        }
        supertask_mapping_dict = {
            "DATASET_PROCESSING": "CREATE_DATASET",
            "GRAPH_CONSTRUCTION": "CREATE_DATASET",
            "MODEL_ARCHITECTURE": "TRAIN",
            "TRAINING": "TRAIN",
            "POSTPROCESSING": "EVALUATE",
        }
        return dataclass_mapping_dict, supertask_mapping_dict


class UserConfigurationReader:
    """YAML -> dataclass reader."""

    @staticmethod
    def get_config_object(config_subset_name: str, config_dict: dict):
        dataset = config_dict["CREATE_DATASET"]["dataset"]
        dataclass_mapping, supertask_mapping = \
            ConfigToDataClassMapping.get_mapping_dicts(dataset)

        super_task = supertask_mapping.get(config_subset_name)
        subset_config_dict = config_dict.get(super_task).get(config_subset_name)

        config = dataclass_from_dict(
            dataclass_mapping.get(config_subset_name), subset_config_dict)

        if not isinstance(config, dataclass_mapping.get(config_subset_name)):
            raise ValueError("Conversion of config file to dataclass failed.")
        return config

    @staticmethod
    def read_config_file(path: str) -> dict:
        with open(path) as f:
            return yaml.safe_load(f)
