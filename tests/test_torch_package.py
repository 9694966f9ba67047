"""The PyTorch port as a package: it stands alone (no JAX, nothing of the JAX
package), its on-card smoke rehearses on the CPU, and `chip_smoke.py` refuses
to report a result without a card."""

import dataclasses
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import radargnn_tpu_torch
from radargnn_tpu_torch import smoke
from torch_threads import few_threads  # noqa: F401

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PKG = os.path.dirname(os.path.abspath(radargnn_tpu_torch.__file__))

# an import of JAX, flax, the JAX package itself (`radargnn_tpu.x` or
# `from radargnn_tpu import x`) — but not of `radargnn_tpu_torch` — or of
# h5py, orbax, tensorstore, zstandard, a crc32c package, matplotlib or PIL
# (the card's machine has none of them: the port reads HDF5 with
# `data.hdf5`, orbax's layout with `train.orbax_format`, `train.ocdbt`,
# `train.zstd`, and draws its figures with `postprocess.figure`)
_NAMES = (r"jax|jaxlib|flax|h5py|orbax|tensorstore|zstandard|crc32c"
          r"|google_crc32c|matplotlib|PIL")
_FORBIDDEN = re.compile(
    rf"^\s*(?:from|import)\s+(?:{_NAMES})\b"
    r"|^\s*(?:from|import)\s+radargnn_tpu(?:\.|\s)"
    rf"|import_module\(\s*['\"](?:{_NAMES}|radargnn_tpu(?:\.|['\"]))",
    re.MULTILINE)


def _port_sources():
    # the card tests and the multi-rank tests' workers, which spawned ranks
    # import afresh, must not import JAX either
    paths = [os.path.join(_REPO, "chip_smoke.py"),
             os.path.join(_REPO, "tests", "test_torch_gpu.py"),
             os.path.join(_REPO, "tests", "torch_parallel_workers.py")]
    for root, _, files in os.walk(_PKG):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return paths


def test_forbidden_import_pattern():
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from radargnn_tpu.ops import knn")
    assert _FORBIDDEN.search("    from radargnn_tpu import configs")
    assert _FORBIDDEN.search("    import h5py")
    assert _FORBIDDEN.search("from h5py import File")
    assert _FORBIDDEN.search("    import tensorstore as ts")
    assert _FORBIDDEN.search("import zstandard")
    assert _FORBIDDEN.search("from google_crc32c import value")
    assert _FORBIDDEN.search("    import crc32c")
    assert _FORBIDDEN.search("import orbax.checkpoint as ocp")
    assert _FORBIDDEN.search("importlib.import_module('tensorstore')")
    assert _FORBIDDEN.search("    import matplotlib")
    assert _FORBIDDEN.search("import matplotlib.pyplot as plt")
    assert _FORBIDDEN.search("from matplotlib.collections import Collection")
    assert _FORBIDDEN.search("from PIL import Image")
    assert _FORBIDDEN.search("importlib.import_module('matplotlib')")
    assert not _FORBIDDEN.search("import matplotlib_like")
    assert not _FORBIDDEN.search("from radargnn_tpu_torch.utils import png")
    assert not _FORBIDDEN.search("from radargnn_tpu_torch.train import zstd")
    assert not _FORBIDDEN.search("import tensorstore_like")
    assert not _FORBIDDEN.search("from radargnn_tpu_torch.ops import knn")
    assert not _FORBIDDEN.search("import radargnn_tpu_torch")
    assert not _FORBIDDEN.search("from radargnn_tpu_torch.data import hdf5")


def test_port_sources_import_nothing_of_jax():
    offenders = []
    for path in _port_sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, _REPO)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders


def test_every_submodule_imports_without_jax():
    """A fresh interpreter imports the package, every submodule and
    chip_smoke.py; neither jax nor the JAX package is loaded after."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import radargnn_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'radargnn_tpu_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'radargnn_tpu', 'orbax', 'tensorstore', "
        "'zstandard', 'crc32c', 'google_crc32c')]\n"
        "assert not bad, bad\n"
        "for m in ('ops.csr_aggregate', 'ops.fused_linear', "
        "'ops.message_segment_max', 'ops.hoisted_aggregate', "
        "'benchmarks.kernel_check', 'benchmarks.kernel_bench', "
        "'data.point_cloud', 'data.loader', 'data.hdf5', "
        "'data.radarscenes.reader', "
        "'data.radarscenes.scene_collection', "
        "'data.radarscenes.dataset_creation', 'graph.online', "
        "'cli.create_dataset', 'cli.train', 'cli.evaluate', 'cli.main', "
        "'data.nuscenes', 'data.nuscenes.quaternion', 'data.nuscenes.db', "
        "'data.nuscenes.splits', 'data.nuscenes.splits_vendored', "
        "'data.nuscenes.conversion', 'data.nuscenes.dataset_creation', "
        "'data.nuscenes.detection_eval', 'data.nuscenes.submission', "
        "'data.nuscenes.evaluation', 'benchmarks.nuscenes_e2e', "
        "'parallel', 'parallel.mesh', 'parallel.comm', "
        "'parallel.edge_partition', 'parallel.halo', 'parallel.halo_dense', "
        "'parallel.halo_windowed', 'parallel.tensor', 'parallel.dryrun', "
        "'benchmarks.scaling', 'benchmarks.halo_accounting', "
        "'smoke_parallel', 'train.zstd', 'train.ocdbt', "
        "'train.orbax_format'):\n"
        "    assert 'radargnn_tpu_torch.' + m in names, m\n"
        "print(len(names))\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 91   # every module of 15 slices
    for path in (("ops", "csr_aggregate.py"), ("ops", "hoisted_aggregate.py"),
                 ("benchmarks", "kernel_check.py"), ("parallel", "comm.py"),
                 ("parallel", "halo_dense.py")):
        assert os.path.join(_PKG, *path) in _port_sources()


# the TPU kernel (the line's start) each entry of the kernels line replaces
_REPLACED = {"dense_proj_v4": "def _fused_fwd_kernel_v4",
             "dense_fwd_v4": "def _fused_fwd_kernel_v4",
             "dense_bwd_v4": "def _fused_bwd_kernel_v4",
             "segment_sum_csr": "def _segsum_kernel",
             "windowed_fwd_v3": "def _fused_fwd_kernel_v3",
             "windowed_bwd_v3": "def _fused_bwd_kernel_v3",
             "csr_fwd_v2": "def _fused_fwd_kernel_v2",
             "csr_bwd_v2": "def _fused_bwd_kernel_v2",
             "fused_linear": "def _linear_kernel",
             "msg_segmax": "def _msg_segmax_scan_kernel",
             "hoisted_fwd_v1": "def _hoisted_scan_kernel",
             "hoisted_bwd_v1": "def _hoisted_bwd_kernel",
             "dense_fwd_v4_bf16_max": "def _fused_bwd_kernel_v4",
             "windowed_fwd_v3_bf16_max": "def _fused_bwd_kernel_v3",
             "segment_sum_csr_ovf_ssum": "def _segsum_kernel",
             "windowed_fwd_v3_bf16_landing": "        if bf16_landing:",
             "dense_fwd_v4_r_tile_8": "def _fused_fwd_kernel_v4",
             "dense_bwd_v4_r_tile_8": "def _fused_bwd_kernel_v4"}


def check_kernel_entries(kernels):
    """Every entry of the kernels line as the CPU rehearsal gives it: the
    chip run's keys, no launch and no time, exact agreement, a bound, its
    source in the repo, and the line of the TPU kernel it replaces."""
    for kernel in kernels:
        assert set(kernel) == {"name", "route", "source", "replaces",
                               "launches", "max_abs_err", "ms", "plain_ms",
                               "bound_ms", "bound_by", "library_ms"}
        assert kernel["route"] == "cuda"
        assert kernel["launches"] == 0 and kernel["ms"] is None
        assert kernel["max_abs_err"] == 0.0
        assert kernel["bound_ms"] > 0 and kernel["bound_by"] in (
            "bytes", "operations")
        assert os.path.exists(os.path.join(_REPO, kernel["source"]))
        path, line = kernel["replaces"].split(":")
        with open(os.path.join(_REPO, path)) as f:
            assert f.readlines()[int(line) - 1].startswith(
                _REPLACED[kernel["name"]])


@pytest.mark.usefixtures("few_threads")
def test_smoke_rehearses_on_cpu():
    """The on-card smoke, at a tiny size on the CPU: the flagship config on
    the kNN graph (dense tiling), on the radius graph (windowed tiling, r
    scaled as 3.0·sqrt(2816/points) so the mean degree stays near 20) and
    on the kNN graph under the CSR tiling, the seven kernels' checks
    against their plain versions at the model's layer shapes (the windowed
    and the CSR ones on two layouts each), three requests, four train steps
    on the kernel path, again, on the plain path (here all plain) and on
    the witness (the plain path re-associated); the
    fourth phase (the other four kernels against their plain versions at
    the flagship's widths, then kernel_check and kernel_bench, the latter
    at a tiny size); the fifth and sixth (evaluation, bench); and the
    kernels line with every key the chip run reports, each of the twelve
    entries of these phases pointing at the TPU kernel it replaces. The
    seventh to tenth phases run on the card only; each is rehearsed here
    by a test of its own (tests/test_torch_smoke_cli.py,
    test_torch_nuscenes_smoke.py, test_torch_smoke_variants.py and
    test_torch_smoke_settings.py, test_torch_halo.py). Nothing is timed and nothing launches here."""
    lines = []
    before = torch.are_deterministic_algorithms_enabled()
    summary = smoke.run("cpu", points=200, graphs=2, batches=3, reps=1,
                        bench=(2000, 96, 24, 40), out=lines.append)
    assert torch.are_deterministic_algorithms_enabled() == before
    kernels = summary["kernels"]
    assert [k["name"] for k in kernels] == [
        "dense_proj_v4", "dense_fwd_v4", "dense_bwd_v4", "segment_sum_csr",
        "windowed_fwd_v3",
        "windowed_bwd_v3", "csr_fwd_v2", "csr_bwd_v2", "fused_linear",
        "msg_segmax", "hoisted_fwd_v1", "hoisted_bwd_v1"]
    assert not {"cli", "nuscenes", "variants", "parallel"} & set(summary)
    check_kernel_entries(kernels)
    assert [r["d_in"] for r in summary["per_shape"]] == [224, 224, 224, 128,
                                                          64]
    assert [r["h"] for r in summary["per_shape_proj"]] == [464, 464, 464,
                                                           272, 144]
    assert all(r["bits_flipped"] == 0 for r in summary["per_shape"])
    assert all(r["bitwise_repeat"] and r["routed"] > 0
               for r in summary["per_shape_bwd"])
    assert summary["model_max_dprob"] == 0.0
    losses = np.asarray(summary["train_losses"])
    assert losses.shape == (4, 3) and np.isfinite(losses).all()
    assert summary["train_max_rel_loss_diff"] == 0.0
    assert losses[-1, 0] < losses[0, 0]
    last = json.loads(lines[-1])
    assert last["per_shape"] == summary["per_shape"]
    radius = summary["radius"]
    assert radius["replaced"] == {
        "graph_construction_algorithm": "radius",
        "graph_construction_settings": {"k": 20, "r": pytest.approx(
            3.0 * np.sqrt(2816 / 200))},
        "fused_run_cap": None}
    assert last["radius"]["per_shape_fwd"] == radius["per_shape_fwd"]
    for key in ("per_shape_bwd", "knn_per_shape_bwd"):
        assert all(r["bitwise_repeat"] and r["max_abs_err"] == 0.0
                   for r in radius[key])
    assert [r["d_in"] for r in radius["knn_per_shape_fwd"]] == [
        224, 224, 224, 128, 64]
    # ~12 at 200 points: the frame's edges cut more of each r-disk there
    mean_degree = np.mean(radius["tiling"]["valid_edges"]) / 200
    assert 10 < mean_degree < 30
    assert radius["model_max_dprob"] == 0.0
    assert radius["train_max_rel_loss_diff"] == 0.0
    r_losses = np.asarray(radius["train_losses"])
    assert r_losses.shape == (4, 3) and r_losses[-1, 0] < r_losses[0, 0]
    csr = summary["csr"]
    assert csr["replaced"] == {"fused_tiling": "csr"}
    assert last["csr"]["per_shape_fwd"] == csr["per_shape_fwd"]
    for key in ("per_shape_bwd", "radius_per_shape_bwd"):
        assert [r["d_in"] for r in csr[key]] == [224, 224, 224, 128, 64]
        assert all(r["bitwise_repeat"] and r["max_abs_err"] == 0.0
                   for r in csr[key])
    # B3 at the CSR backward's two landings: d_x at d_in, then the sender
    # sums of d_op at H of its hp columns
    for key in ("per_shape_segsum", "radius_per_shape_segsum"):
        assert [(r["site"], r["d"], r["pitch"]) for r in csr[key]] == [
            ("d_xg", d, d) for d in (224, 224, 224, 128, 64)] + [
            ("d_op", h, hp) for h, hp in ((464, 512), (464, 512),
                                          (464, 512), (272, 320), (144, 192))]
        assert all(r["bitwise_repeat"] and r["bitwise_listed"]
                   and r["max_abs_err"] == 0.0 for r in csr[key])
    # the float32 edge products bound the CSR kernels at the wide layers
    assert csr["per_shape_fwd"][0]["bound_by"] == "operations"
    assert csr["model_max_dprob"] == 0.0
    assert csr["train_max_rel_loss_diff"] == 0.0
    c_losses = np.asarray(csr["train_losses"])
    assert c_losses.shape == (4, 3) and c_losses[-1, 0] < c_losses[0, 0]
    # each path's plain run re-associated (the witness) drifts from the
    # plain run (reported, not bounded); the kernel run is the plain run
    # here
    for res in (summary, radius, csr):
        assert res["train_free_running_drift"] == 0.0
        assert 0.0 < res["train_witness_drift"] < 1.0
    # the radius batch under the CSR tiling: 256-node blocks of 512 slots
    assert all(v > 0 for v in csr["radius_tiling"]["valid_edges"])
    assert csr["radius_tiling"]["tiles_per_graph"] > 1
    last4 = summary["last_four"]
    assert [(r["rows"], r["d_in"], r["d_out"]) for r in last4["linear"]] == [
        (4096, 256, 512), (2 * 256, 224, 464)]
    assert [r["case"] for r in last4["segmax"]] == [
        "kNN batch", "wide range", "empty blocks", "all-negative"]
    assert (last4["segmax"][0]["d_in"], last4["segmax"][0]["h"]) == (464, 464)
    assert [r["h"] for r in last4["v1_fwd"]] == [464, 464, 464, 272, 144]
    assert all(r["d_e"] == 16 for r in last4["v1_bwd"])
    assert all(r["bitwise_repeat"] and r["max_abs_err"] == 0.0
               for r in last4["v1_bwd"])
    assert all(r["bound_by"] == "operations" for r in last4["v1_fwd"])
    assert set(last4["entry_launches"]) == set(smoke.KERNEL_NAMES)
    assert last4["kernel_check"]["strict_ratio"] == pytest.approx(1.0,
                                                                  abs=0.03)
    assert last4["kernel_bench"]["kernel_ms"] is None
    assert "KERNEL CHECK OK" in lines
    bench_lines = [json.loads(s) for s in lines if s.startswith(
        '{"metric": "segmax_')]
    assert [b["metric"] for b in bench_lines] == ["segmax_library_ms",
                                                  "segmax_kernel_ms"]
    assert last["last_four"]["v1_fwd"] == last4["v1_fwd"]
    # the fifth phase: the evaluation stage on the served kNN requests and
    # on oracle predictions, each against the same chain on the CPU
    ev = summary["evaluation"]
    assert ev["oracle"]["map"] == 1.0 and ev["oracle"]["box_iou_map"] == 1.0
    assert all(b > a for a, b in zip(ev["oracle"]["boxes_after_nms"],
                                     ev["oracle"]["boxes_before_nms"]))
    for label in ("real", "oracle"):
        assert ev[label]["max_abs_dmap"] == 0.0
        assert {"eval_configs.json", "eval_results.json", "confusion_abs.npy",
                "confusion_rel.npy"} <= set(ev[label]["artifacts"])
    assert ev["rotated_iou"]["max_abs_diff"] == 0.0
    assert ev["rotated_iou"]["overlapping_pairs"] > ev["rotated_iou"]["boxes"]
    # the sixth phase: the bench's four cells as child processes
    assert [(b["tiling"], b["mode"]) for b in summary["bench"]] == list(
        smoke.BENCH_CASES)
    for b in summary["bench"]:
        assert b["metric"] == f"{b['mode']}_edges_per_s" and b["value"] > 0
        assert [r["path"] for r in b["runs"]] == ["fused", "unfused"]


def test_postprocess_and_bench_import_no_jax_sklearn_or_matplotlib():
    """A fresh interpreter imports the evaluation stage and the bench, and
    draws a confusion matrix: neither jax, the JAX package, scikit-learn,
    matplotlib nor PIL is loaded (the card's machine has none of the last
    three)."""
    code = (
        "import os, sys, tempfile\n"
        "import radargnn_tpu_torch.postprocess as p\n"
        "import radargnn_tpu_torch.benchmarks.bench\n"
        "from radargnn_tpu_torch.postprocess import evaluation, extraction, "
        "mean_ap, nms, segmentation_metrics, visualization\n"
        "from radargnn_tpu_torch.utils import png\n"
        "path = os.path.join(tempfile.mkdtemp(), 'confusion.png')\n"
        "import numpy as np\n"
        "visualization.plot_confusion_matrix(np.array([[3, 1], [0, 4]]), "
        "['a', 'b'], True).savefig(path)\n"
        "assert png.read_png(path).shape == (600, 600, 4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'flax', 'radargnn_tpu', 'sklearn', 'matplotlib', "
        "'PIL')]\n"
        "assert not bad, bad\n"
        "for name in ('BoxArray', 'Postprocessor', 'PredictionExtractor', "
        "'GroundTruthExtractor', 'BoxSuppressor', 'decode_boxes_to_corners', "
        "'Predictor', 'MeanAveragePrecision', 'ObjectDetectionMetrics', "
        "'SegmentationMetrics', 'Evaluator', 'RadarscenesEvaluator', "
        "'evaluation_selector', 'get_new_evaluation_folder_path'):\n"
        "    assert hasattr(p, name), name\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_pipeline_and_cli_import_without_h5py_or_matplotlib():
    """A fresh interpreter where h5py and matplotlib cannot be imported
    (the card's machine lacks them) imports the RadarScenes pipeline, the
    loader, the online builder and the CLI, writes raw sequences, reads
    one and runs create_dataset on them (the flagship YAML's spawned
    workers) through the port's HDF5 code, and draws the loss curves
    with the port's own figure code; h5py was never imported, nor
    matplotlib or PIL."""
    code = (
        "import os, sys, tempfile\n"
        "class NoH5py:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] == 'h5py':\n"
        "            raise ImportError('h5py is blocked')\n"
        "sys.meta_path.insert(0, NoH5py())\n"
        "sys.modules['matplotlib'] = None\n"
        "from radargnn_tpu_torch.data.radarscenes import reader\n"
        "import radargnn_tpu_torch.data.radarscenes\n"
        "from radargnn_tpu_torch.data import loader, point_cloud\n"
        "from radargnn_tpu_torch.graph import online\n"
        "from radargnn_tpu_torch.cli import create_dataset, evaluate, "
        "main, train\n"
        "from radargnn_tpu_torch import smoke\n"
        "if __name__ == '__main__':\n"
        "    root = tempfile.mkdtemp()\n"
        "    smoke.write_radarscenes(root, scans=10, points_per_scan=40)\n"
        "    seq = reader.Sequence.from_json(os.path.join(\n"
        "        root, 'raw', 'data', 'sequence_1', 'scenes.json'))\n"
        "    assert len(seq.timestamps) == 10\n"
        "    assert seq.radar_data.dtype == smoke.RADAR_DTYPE\n"
        "    assert seq.odometry.dtype == smoke.ODO_DTYPE\n"
        "    create_dataset.main(root, smoke.cli_config(root), device='cpu')\n"
        "    made = os.listdir(os.path.join(root, 'processed', 'train'))\n"
        "    assert len(made) == 6, made\n"
        "    from types import SimpleNamespace\n"
        "    from radargnn_tpu_torch.train.trainer import Trainer\n"
        "    from radargnn_tpu_torch.utils import png\n"
        "    losses = SimpleNamespace(train_loss=[2.0, 1.0], valid_loss=[2.5, "
        "1.5], train_loss_cls=[1.0, 0.5], train_loss_bb=[1.0, 0.5])\n"
        "    fig, _ = Trainer.show_learning_curves(losses)\n"
        "    fig.savefig(os.path.join(root, 'loss_curves.png'))\n"
        "    image = png.read_png(os.path.join(root, 'loss_curves.png'))\n"
        "    assert image.shape == (480, 640, 4)\n"
        "    assert 'h5py' not in sys.modules\n"
        "    bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'flax', 'radargnn_tpu', 'matplotlib', 'PIL') and "
        "sys.modules[m] is not None]\n"
        "    assert not bad, bad\n"
        "    print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_nuscenes_pipeline_imports_without_h5py_matplotlib_or_devkit():
    """A fresh interpreter where h5py, matplotlib and the nuScenes devkit
    cannot be imported (the card's machine has none of them) imports every
    module of the nuScenes pipeline, the e2e and the CLI, selects the
    nuScenes dataset creation and evaluator, reads the vendored split
    tables, and draws a prediction plot with the port's own figure code;
    neither JAX, the JAX package, matplotlib nor PIL is loaded."""
    code = (
        "import os, sys\n"
        "for m in ('h5py', 'matplotlib', 'nuscenes'):\n"
        "    sys.modules[m] = None\n"
        "import importlib\n"
        "for m in ('quaternion', 'db', 'splits', 'splits_vendored', "
        "'conversion', 'dataset_creation', 'detection_eval', 'submission', "
        "'evaluation'):\n"
        "    importlib.import_module('radargnn_tpu_torch.data.nuscenes.' + m)\n"
        "from radargnn_tpu_torch.benchmarks import nuscenes_e2e\n"
        "from radargnn_tpu_torch.cli import create_dataset, evaluate, main\n"
        "from radargnn_tpu_torch.configs import NuScenesSplitConfiguration\n"
        "from radargnn_tpu_torch.data.nuscenes import splits, "
        "splits_vendored\n"
        "from radargnn_tpu_torch.postprocess.evaluation import "
        "evaluation_selector\n"
        "assert create_dataset.dataset_selector('nuscenes').__name__ == "
        "'NuScenesGraphDataset'\n"
        "assert evaluation_selector('nuscenes').__name__ == "
        "'NuscenesEvaluator'\n"
        "assert splits.val == splits_vendored.val and len(splits.val) == 150\n"
        "split = NuScenesSplitConfiguration('v1.0-trainval').sequence_dict\n"
        "assert (len(split['train']), len(split['validate'])) == (700, 150)\n"
        "import io, numpy as np\n"
        "from radargnn_tpu_torch.postprocess.extraction import BoxArray\n"
        "from radargnn_tpu_torch.postprocess.visualization import "
        "PredictionVisualizer\n"
        "from radargnn_tpu_torch.utils import png\n"
        "corners = np.array([[[0, 0], [2, 0], [2, 1], [0, 1]]], float)\n"
        "fig, _ = PredictionVisualizer.plot_detections("
        "{'boxes': BoxArray(corners, False), 'scores': np.array([0.9]), "
        "'labels': np.array([1])}, {'pos': np.random.default_rng(0)"
        ".uniform(0, 3, (50, 2)), 'labels': np.ones(50)}, "
        "label_names=['background', 'car'])\n"
        "path = os.path.join(__import__('tempfile').mkdtemp(), 'p.png')\n"
        "fig.savefig(path)\n"
        "assert png.read_png(path).shape == (480, 640, 4)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'jaxlib', 'flax', 'radargnn_tpu', 'h5py', 'matplotlib', 'PIL', "
        "'nuscenes') and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=_REPO)
    env.pop("NUSCENES_SPLITS_JSON", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_radius_configuration_replaces_three_fields():
    """The radius path reads the flagship YAML and replaces exactly the
    graph algorithm, its settings and the run cap; its tiling spec is the
    windowed tuple with contiguous runs."""
    k_arch, k_graph, _, none = smoke.flagship_configs("knn")
    arch, graph, _, replaced = smoke.flagship_configs("radius")
    assert none == {} and set(replaced) == {
        "graph_construction_algorithm", "graph_construction_settings",
        "fused_run_cap"}
    assert (graph.graph_construction_algorithm, graph.r, graph.k) == \
        ("radius", 3.0, None)
    assert arch.fused_run_cap is None and k_arch.fused_run_cap == 4
    assert dataclasses.replace(arch, fused_run_cap=4) == k_arch
    assert dataclasses.replace(
        graph, graph_construction_algorithm="knn",
        graph_construction_settings=k_graph.graph_construction_settings) \
        == k_graph
    assert smoke.fused_csr_tiling(arch, k=graph.k) == (256, 512, 3, 0.05)


def test_csr_configuration_replaces_one_field():
    """The CSR path reads the flagship YAML and replaces fused_tiling alone;
    its tiling spec is the CSR pair, and on the radius graph it replaces
    that field beside the radius path's three."""
    k_arch, k_graph, _, _ = smoke.flagship_configs("knn")
    arch, graph, _, replaced = smoke.flagship_configs("knn", tiling="csr")
    assert replaced == {"fused_tiling": "csr"} and graph == k_graph
    assert dataclasses.replace(arch, fused_tiling="auto") == k_arch
    assert smoke.fused_csr_tiling(arch, k=graph.k) == (256, 512)
    _, _, _, r_replaced = smoke.flagship_configs("radius", tiling="csr")
    assert set(r_replaced) == {
        "graph_construction_algorithm", "graph_construction_settings",
        "fused_run_cap", "fused_tiling"}
    with pytest.raises(ValueError, match="tiling"):
        smoke.flagship_configs("knn", tiling="windowed")


def test_csr_bounds_count_the_edge_products_in_float32():
    """B5 keeps e @ W_e and the edge gradients in float32: at the flagship's
    wide layer (14,080 nodes, 309,760 slots of which 281,600 valid, 605
    tiles) 4.18 GFLOP at 67 TFLOP/s outside the tensor cores (62 µs) beside
    2.93 GFLOP of bf16 products and ~107 MB: bound by operations, 0.065 ms;
    the backward twice the products, 0.131 ms."""
    n, e_pad, t, valid = 14080, 309760, 605, 281600
    f = smoke._kernel_bound(224, 16, 464, n, e_pad, t, valid, 2, True)
    assert f["flops"] == 2.0 * (n * 224 * 464 + valid * 16 * 464)
    assert f["bound_by"] == "operations"
    assert 0.064 < f["bound_ms"] < 0.066
    assert f["bytes"] == (n * 224 * 2 + 224 * 464 * 2 + e_pad * 16 * 4
                          + 16 * 464 * 4 + 2 * (e_pad + t) * 4
                          + 3 * n * 464 * 4)
    b = smoke._bwd_bound(224, 16, 464, n, e_pad, t, valid, 2, True)
    assert b["bound_by"] == "operations"
    assert 0.130 < b["bound_ms"] < 0.132


def test_segmax_bound_is_the_3xtf32_floor():
    """B8 forms each float32 product as three TF32 products on the tensor
    cores: at 464 -> 464 over the flagship kNN batch's 281,600 valid slots
    (121 GFLOP) its bound is 3 x 121 GFLOP at 495 TFLOP/s, 0.735 ms, bound
    by operations; the float32 floor outside the tensor cores, 1.81 ms,
    stands beside it."""
    valid, e_pad, t, n = 281600, 309760, 605, 14080
    b = smoke._segmax_bound(valid, e_pad, 464, 464, t, n)
    assert b["product_flops"] == 2.0 * valid * 464 * 464
    assert b["flops"] == 3 * b["product_flops"]
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == b["tf32x3_bound_ms"]
    assert 0.734 < b["bound_ms"] < 0.736
    assert 1.80 < b["f32_bound_ms"] < 1.82
    assert b["bytes"] == 4.0 * (e_pad * 464 + 464 * 464 + 464 + e_pad + t
                                + n * 464)


def test_linear_bound_is_the_3xtf32_floor():
    """B9 forms its products as B8 does, three TF32 products on the tensor
    cores: at 14,080 x 224 -> 464 its bound is 3 x 2.93 GFLOP at 495
    TFLOP/s, 0.0178 ms, bound by operations (its 39 MB take 0.0117 ms);
    the float32 floor outside the tensor cores, 0.0437 ms, stands beside
    it. At 4096 x 256 -> 512 the floors are 6.5 us against 3.9 us of
    bytes."""
    rows = smoke.check_linear_kernel(
        torch.device("cpu"), [(14080, 224, 464, False, 224 ** -0.5),
                              (4096, 256, 512, True, 0.05)], 0, 1,
        out=lambda *_: None)
    wide, small = rows
    assert wide["product_flops"] == 2.0 * 14080 * 224 * 464
    assert wide["bound_by"] == "operations"
    assert wide["bound_ms"] == wide["tf32x3_bound_ms"]
    assert 0.0177 < wide["bound_ms"] < 0.0179
    assert 0.0116 < wide["bytes_ms"] < 0.0118
    assert 0.0436 < wide["f32_bound_ms"] < 0.0438
    assert 0.0064 < small["bound_ms"] < 0.0066
    assert 0.0038 < small["bytes_ms"] < 0.0040
    assert wide["library_ms"] is None and wide["ms"] is None


def _includes(name):
    with open(os.path.join(_PKG, "csrc", name)) as f:
        return re.findall(r'^#include "([^"]+)"', f.read(), re.MULTILINE)


def test_kernel_sources_and_their_shared_headers():
    """The port's CUDA sources: every include resolves, every header is
    reached by some kernel source, and the shared headers reach the
    kernels that share them, and no other: the gather-max walk
    (csr_walk.cuh) B5 and B6, each with the operand policy it defines; the
    CSR slot rule (csr_slot.cuh) B5's forward and backward; the v1 operand
    (hoisted_v1.cuh) B6 and B7; the 3xTF32 products (tf32x3.cuh) B8 and
    B9; the float32 SIMT tile B9 left is gone."""
    csrc = os.path.join(_PKG, "csrc")
    files = sorted(os.listdir(csrc))
    sources = [f for f in files if f.endswith(".cu")]
    headers = {f for f in files if f.endswith(".cuh")}
    reach = {}
    for src in sources:
        seen, todo = set(), [src]
        while todo:
            for inc in _includes(todo.pop()):
                assert inc in headers, (src, inc)
                if inc not in seen:
                    seen.add(inc)
                    todo.append(inc)
        reach[src] = seen
    assert set().union(*reach.values()) == headers
    shared = {"csr_walk.cuh": {"csr_fwd_v2.cu", "hoisted_fwd_v1.cu"},
              "csr_slot.cuh": {"csr_fwd_v2.cu", "csr_bwd_v2.cu"},
              "hoisted_v1.cuh": {"hoisted_fwd_v1.cu", "hoisted_bwd_v1.cu"},
              "tf32x3.cuh": {"msg_segmax.cu", "fused_linear.cu"}}
    for header, users in shared.items():
        assert {s for s in sources if header in reach[s]} == users, header
    assert "sgemm_tile.cuh" not in headers
    assert sorted(s[:-3] for s in sources) == sorted(
        set(smoke.KERNEL_NAMES) - {"dense_proj_v4", "dense_fwd_v4_bf16_max",
                                   "windowed_fwd_v3_bf16_max",
                                   "windowed_fwd_v3_bf16_landing"})


def test_walk_phase_cuts_find_their_code():
    """`benchmarks.walk_phases` cuts each phase out of a copy of the
    walk's header by replacing its code: every cut finds its code once in
    csr_walk.cuh as it stands, and the shipped header is untouched."""
    from radargnn_tpu_torch.benchmarks import walk_phases

    header = os.path.join(_PKG, "csrc", "csr_walk.cuh")
    with open(header) as f:
        before = f.read()
    for cut, edits in walk_phases.CUTS.items():
        for old, _ in edits:
            assert before.count(old) == 1, (cut, old)
        src = walk_phases._variant_source("hoisted_fwd_v1.cu", cut)
        with open(os.path.join(os.path.dirname(src), "csr_walk.cuh")) as f:
            assert (f.read() == before) == (not edits), cut
    with open(header) as f:
        assert f.read() == before


def test_backward_bound_counts_the_sender_sums_once_per_node():
    """B2's bound: d_x and dW_s from the per-sender sums of d_op (N rows),
    d_e and dW_e per valid slot. At the flagship's wide layer that is 13.8
    GFLOP (14 µs at the bf16 peak) against ~95 MB (~28 µs at 3.35 TB/s):
    bound by bytes. B3's landing there reads ~281,600 rows."""
    n, e_pad, t, valid = 14080, 337920, 220, 267178
    b = smoke._bwd_bound(224, 16, 464, n, e_pad, t, valid)
    assert b["flops"] == 4.0 * (n * 224 * 464 + valid * 16 * 464)
    assert 13.7e9 < b["flops"] < 13.9e9
    assert b["bound_by"] == "bytes"
    assert 0.027 < b["bound_ms"] < 0.030
    s = smoke._segsum_bound(224, valid, 14422, n)
    assert s["bound_by"] == "bytes"
    assert s["bytes"] == (valid * 224 * 2 + 14422 * 224 * 4
                          + (valid + 14422) * 4 + (n + 1) * 4 + n * 224 * 4)


def test_kernel_bound_counts_the_projection_once_per_node():
    """The bound counts x @ W_s once per node and e @ W_e once per valid
    slot; at the flagship's wide layer (N 14,080, 337,920 slots of which
    267,178 valid, 220 tiles) that is 6.89 GFLOP, so the bytes bound it
    (~29 µs at 3.35 TB/s)."""
    n, e_pad, t, valid = 14080, 337920, 220, 267178
    b = smoke._kernel_bound(224, 16, 464, n, e_pad, t, valid)
    assert b["flops"] == 2.0 * (n * 224 * 464 + valid * 16 * 464)
    assert b["slot_flops"] == 2.0 * valid * (224 + 16) * 464
    assert b["bound_by"] == "bytes"
    assert b["bound_ms"] == pytest.approx(b["bytes"] / smoke.PEAK_HBM_BYTES
                                          * 1e3)
    assert 0.028 < b["bound_ms"] < 0.030


def test_chip_smoke_fails_without_a_card(tmp_path):
    """Without CUDA, chip_smoke.py exits non-zero and prints no result; so
    does a copy that stands alone in a directory without the package."""
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((_REPO, "chip_smoke.py"), (tmp_path, str(alone))):
        proc = subprocess.run([sys.executable, script], cwd=cwd, env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout


def test_trace_train_sorts_kernels_into_kinds():
    """Kernel names as the profiler gives them; the dense and windowed
    backward's passes are one template, told apart by its receivers."""
    from radargnn_tpu_torch.trace_train import kind_of

    def routed(name, recv):
        return (f"void radargnn::{name}<radargnn::{recv}>(radargnn::{recv}, "
                "unsigned int const*, float const*)")

    assert kind_of("dense_proj_kernel") == \
        "dense_proj_v4 (projection: B1, B4, B5)"
    assert kind_of("dense_fwd_v4_kernel") == "dense_fwd_v4 (B1 gather-max)"
    assert kind_of(routed("de_pass_kernel", "DenseReceivers")) == \
        "dense_bwd_v4 d_e pass (B2)"
    assert kind_of(routed("dwe_pass_kernel", "DenseReceivers")) == \
        "dense_bwd_v4 dW_e pass (B2)"
    assert kind_of(routed("send_pass_kernel", "DenseReceivers")) == \
        "dense_bwd_v4 sender sums (B2)"
    for name, kind in (("de_pass_kernel", "d_e pass"),
                       ("dwe_pass_kernel", "dW_e pass"),
                       ("send_pass_kernel", "sender sums")):
        assert kind_of(routed(name, "WindowReceivers")) == \
            f"windowed_bwd_v3 {kind} (B4)"
    assert kind_of("radargnn::reduce_pass_kernel(float const*)") == \
        "dW_e reduce (B2, B4)"
    assert kind_of("windowed_fwd_v3_kernel") == \
        "windowed_fwd_v3 (B4 gather-max)"
    assert kind_of("csr_fwd_v2_kernel") == "csr_fwd_v2 (B5)"
    assert kind_of("csr_route_kernel") == "csr_bwd_v2 route + edge side (B5)"
    assert kind_of("csr_reduce_kernel") == "csr_bwd_v2 dW_e, dW_s reduce (B5)"
    assert kind_of("csr_dws_partials_kernel") == \
        "csr_bwd_v2 dW_s partials (B5)"
    assert kind_of("csr_slot_products_kernel") == \
        "csr_bwd_v2 slot products (B5)"
    assert kind_of("segment_sum_csr_kernel") == "segment_sum_csr (B3)"
    assert kind_of("sm90_xmma_gemm_f32f32_f32f32") == "GEMMs (cuBLAS)"
    assert kind_of("vectorized_elementwise_kernel<FillFunctor<float>>") \
        .startswith("fills")
    assert kind_of("something new") == "other"


def test_trace_busy_time_is_the_union_of_kernel_intervals():
    from radargnn_tpu_torch.trace_serving import _busy_us
    assert _busy_us([]) == 0.0
    assert _busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17.0
    assert _busy_us([(3, 4), (0, 10)]) == 10.0


# the three training paths: (graph, tiling) as trace_train takes them
_DRIFT_PATHS = {"dense": ("knn", None), "windowed": ("radius", None),
                "csr": ("knn", "csr")}


@pytest.mark.usefixtures("few_threads")
@pytest.mark.parametrize("path", list(_DRIFT_PATHS))
def test_drift_witness_reassociates_the_csr_plain_path(path):
    """trace_train's drift mode at a tiny size on the CPU, on each path
    (the dense, the windowed and the CSR one), where the kernel path is the
    plain path: their gap is 0, and the witness (the plain path with its
    float32 sums re-associated) moves the losses by rounding only. The
    wrappers are put back after it, and the line carries the spread of
    both gaps and the first step's gradients by layer."""
    from radargnn_tpu_torch import trace_train
    from radargnn_tpu_torch.ops import csr_aggregate as ca
    wrappers = {(m, n): getattr(m, n) for m, n in smoke.KERNEL_WRAPPERS
                + ((ca, "csr_bwd"),)}
    before = torch.are_deterministic_algorithms_enabled()
    graph, tiling = _DRIFT_PATHS[path]
    got = trace_train.drift(1, steps=2, points=200, graphs=2, graph=graph,
                            tiling=tiling, device="cpu")
    assert torch.are_deterministic_algorithms_enabled() == before
    assert all(getattr(m, n) is f for (m, n), f in wrappers.items())
    (run,) = got["runs"]
    assert run["kernel_vs_plain"] == 0.0
    assert 0.0 < run["witness_vs_plain"] < 1e-2
    assert (got["graph"], got["tiling"], got["card"]) == (graph, tiling,
                                                          None)
    for gap in ("kernel_vs_plain", "witness_vs_plain"):
        assert got[gap] == {"median": run[gap], "p90": run[gap],
                            "max": run[gap]}
    assert got["median_ratio"] == 0.0
    layers = got["step0_grad_rel_diff_median"]
    assert len(layers) == 7 and all(
        v["kernel_vs_plain"] == 0.0 and v["witness_vs_plain"] > 0.0
        for v in layers.values())


def test_bf16_model_hands_the_csr_backward_a_bf16_exact_g():
    """In the bf16 flagship model the layer after each CSR aggregation
    takes its output in bf16, so the g that reaches the CSR backward holds
    bf16 values: on this path v2's float32 edge-side d_op equals the
    rounded one, and only the kernel checks with a real-valued g tell the
    two apart (PERF.md)."""
    from unittest import mock
    from radargnn_tpu_torch.ops import csr_aggregate as ca
    seen = []

    def spy(*args, landing=None, y_s=None, **kw):
        g = args[-1]
        seen.append(bool(g.abs().max() > 0)
                    and torch.equal(g, g.bfloat16().float()))
        return ca.csr_bwd_plain(*args, **kw)

    arch, _, loader = smoke.flagship_serving("cpu", 200, 2, 1, 0,
                                             tiling="csr")
    assert arch.compute_dtype == "bfloat16"
    with mock.patch.object(ca, "csr_bwd", spy):
        smoke.flagship_training("cpu", arch, loader[0], 0, 1)
    assert seen == [True] * len(arch.conv_layer_dimensions)
