"""On-card check of the PyTorch port (radargnn_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It prints the card's name and power limit, builds the port's CUDA kernel from
the sources in the checkout, holds it against its plain PyTorch version at
every layer shape of the flagship RadarScenes DetNet, serves a few batches of
5 x 2816-point synthetic frames through the port's Predictor, checks that
every conv layer launched the kernel and that the outputs match the same
model on the plain path, and prints the kernel's times beside its bound. The
last line is one JSON object with "ok" and the device; any failed phase
exits non-zero.
"""

import json
import sys

import torch


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
