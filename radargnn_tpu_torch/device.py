"""Device resolution for the port's entry points: the card by default, the
CPU only when the caller asks for it."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card, and raises when
    there is none rather than falling back to the CPU.

    For a CUDA device it also switches TF32 off for matmuls and cuDNN: the
    port's float32 products (models.mlp.matmul_f32) must stay float32."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
