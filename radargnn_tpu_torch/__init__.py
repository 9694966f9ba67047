"""radargnn_tpu_torch — the PyTorch + CUDA port of radargnn_tpu.

A second package beside the JAX reference (`radargnn_tpu`), mirroring its
module paths. It imports torch, numpy, scipy and yaml, never JAX or the JAX
package. Plain tensor code is PyTorch; every TPU kernel on a ported path is
a kernel written by hand for Hopper (`csrc/`), built at first use.

Ported so far — DetNet serving, training and evaluation under the dense,
windowed and CSR tilings:
    configs          — YAML -> typed dataclass configuration system
    native, ops.knn  — host kNN / geometry helpers (g++ + numpy fallback)
    graph, data      — graph construction, synthetic frames, padded batches
    ops              — tilers, segment max, the aggregations (+ kernels)
    models           — MLPs, masked BatchNorm, conv layers, DetNet
    train            — losses, schedules, checkpoints, Trainer
    postprocess      — boxes, Predictor, NMS, extraction, mAP, metrics,
                       evaluators
    weights          — flax variables <-> state_dict bridge
    smoke            — the on-card end-to-end check run by chip_smoke.py
    benchmarks       — bench (the train step and the request), and
                       kernel_check, kernel_bench and the probes, the
                       kernels' own entry points on the card

Entry points run on the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
