"""On-card check of the PyTorch port (radargnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It prints the card's name and power limit and builds the port's seven
CUDA kernels from the sources in the checkout (dense forward and backward,
segment-sum landing, windowed forward and backward, CSR forward and
backward; one nvcc each, in parallel). It holds each kernel against its
plain PyTorch version at every layer shape of the flagship RadarScenes
DetNet (the windowed kernels on the radius batch and on the kNN batch
under the windowed tiling, the CSR kernels on the kNN batch and on the
radius batch under the CSR tiling), and checks that two backward runs give
the same bits. Then, for three paths, the kNN graph (dense tiling), the
radius graph (windowed tiling; the flagship configuration with three
fields replaced, printed) and the kNN graph under the CSR tiling (the
flagship configuration with fused_tiling "csr", printed), it serves a few
batches of 5 x 2816-point synthetic frames through the port's Predictor
and trains the same DetNet for a few steps through the port's Trainer
(the flagship configuration, deterministic algorithms on), checks that
every conv layer launched the path's kernels, that each path matches the
same model on the plain path and that a second training run gives the
same losses, and prints the kernels' times beside their bounds. The last
line is one JSON object with "ok" and the device; any failed phase exits
non-zero.
"""

import json
import os
import sys

# cuBLAS reads its workspace setting when it creates its first handle; the
# training phase runs with torch's deterministic algorithms, which need it
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import torch  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from radargnn_tpu_torch import smoke

    summary = smoke.run("cuda")
    print(json.dumps({"kernels": summary["kernels"]}))
    print(summary["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
