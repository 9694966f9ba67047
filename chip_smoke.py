"""On-card check of the PyTorch port (radargnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It prints the card's name and power limit and builds the port's eleven CUDA
sources from the checkout (dense forward: the node projection and the
gather-max; dense backward; segment-sum landing; windowed forward and
backward; CSR forward and backward; fused linear; message segment-max; v1
hoisted forward and backward; one nvcc each, in parallel). It holds each of
the twelve kernels against its plain PyTorch version at every layer shape
of the flagship RadarScenes DetNet (the dense kernels on the kNN batch, the
windowed kernels on the radius batch and on the kNN batch under the
windowed tiling: the forward's routing bits on real-valued inputs and,
with the backward, exactly on dyadic ones; the CSR kernels on the kNN
batch and on the radius batch under the CSR tiling), and checks that two
backward runs give the same bits. Then, for three paths, the kNN graph (dense
tiling), the radius graph (windowed tiling; the flagship configuration with
three fields replaced, printed) and the kNN graph under the CSR tiling (the
flagship configuration with fused_tiling "csr", printed), it serves a few
batches of 5 x 2816-point synthetic frames through the port's Predictor and
trains the same DetNet for a few steps through the port's Trainer (the
flagship configuration, deterministic algorithms on), checks that every
conv layer launched the path's kernels, that each path matches the same
model on the plain path and that a second training run gives the same
losses. A fourth phase holds the four kernels that no model path runs
against their plain versions at the flagship's widths on the kNN batch (the
v1 pair at the five layer shapes under 128 x 256 receiver-CSR tiles, its
backward exact on dyadic inputs and bitwise repeatable; the message
segment-max at 464 -> 464, on seeded and on wide-range messages; the fused
linear at 4096 x 256 -> 512 and over the batch's nodes at 224 -> 464,
timed against torch.addmm in alternating rounds by a child process with
cuBLAS's default workspace), then drives their entry points,
radargnn_tpu_torch.benchmarks.kernel_check (prints KERNEL CHECK OK) and
kernel_bench (two JSON lines at 450,560 edges), and checks that each of the
four launched. A fifth phase runs the evaluation stage on the card: the kNN
requests through Predictor.predict, the Postprocessor (NMS) and the
RadarscenesEvaluator under the flagship configuration's POSTPROCESSING, on
the real predictions and on oracle predictions built from the frames'
ground truth (mAP 1.0), each held to the same chain on the CPU (kept
indices, mAP, F1, confusion matrix), with the rotated IoU of an oracle
frame's boxes on the card against the CPU's. A sixth runs the port's bench
(python -m radargnn_tpu_torch.benchmarks.bench, 4 steps, one pair) in child
processes: train and infer on the dense tiling, train on the CSR and the
windowed tilings. It prints the kernels' times beside their bounds. The
last line is one JSON object with "ok" and the device; any failed phase
exits non-zero.
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
