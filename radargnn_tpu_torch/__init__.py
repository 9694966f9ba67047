"""radargnn_tpu_torch — the PyTorch + CUDA port of radargnn_tpu.

A second package beside the JAX reference (`radargnn_tpu`), mirroring its
module paths. It imports torch, numpy, scipy and yaml, never JAX or the JAX
package. Plain tensor code is PyTorch; every TPU kernel on a ported path is
a kernel written by hand for Hopper (`csrc/`), built at first use.

Ported so far — the DetNet serving path with the dense kNN tiling:
    configs          — YAML -> typed dataclass configuration system
    native, ops.knn  — host kNN / geometry helpers (g++ + numpy fallback)
    graph, data      — graph construction, synthetic frames, padded batches
    ops              — dense tiler, segment max, dense aggregation (+ kernel)
    models           — MLPs, masked BatchNorm, conv layers, DetNet
    postprocess      — boxes, Predictor
    weights          — flax variables <-> state_dict bridge
    smoke            — the on-card end-to-end check run by chip_smoke.py

Entry points run on the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
