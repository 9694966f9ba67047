"""Fused linear: y = x @ w + b, with an optional ReLU, in float32.

Port of `fused_linear` / `fused_linear_reference`
(`radargnn_tpu/ops/pallas_kernels.py`). On the card it is the hand-written
kernel `csrc/fused_linear.cu` (replaces `_linear_kernel`): a float32 SIMT
GEMM with a bias/ReLU epilogue. On the CPU the wrapper takes the plain
version. The JAX package runs Mosaic's default float32 dot on a TPU, one
bf16 pass; the port keeps float32 products and sums, which is the JAX
function's contract wherever it is exact (interpret mode).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from radargnn_tpu_torch.build import load_library


def fused_linear_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       relu: bool = False) -> torch.Tensor:
    """Plain torch version (`fused_linear_reference`): the same function on
    the same inputs, float32."""
    y = x.float() @ w.float() + b.float()
    return torch.relu(y) if relu else y


fused_linear_reference = fused_linear_plain


def _bind(lib: ctypes.CDLL) -> None:
    lib.fused_linear.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    lib.fused_linear.restype = ctypes.c_int


def load_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/fused_linear.cu` once."""
    return load_library("fused_linear.cu", _bind)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_linear kernel: {msg}")


def check_float32_operands(check, floats: dict,
                           ints: Optional[dict] = None) -> torch.device:
    """The checks the float32 kernels share (fused_linear, msg_segmax, the
    hoisted v1 pair): every tensor on one CUDA device and contiguous,
    `floats` float32 and `ints` int32; `check(cond, msg)` raises. Returns
    the device."""
    ints = ints or {}
    dev = next(iter(floats.values())).device
    for names, dtype, label in ((floats, torch.float32, "float32"),
                                (ints, torch.int32, "int32")):
        for name, ten in names.items():
            check(ten.device == dev and dev.type == "cuda",
                  f"{name} must be on {dev} (a CUDA device)")
            check(ten.is_contiguous(), f"{name} must be contiguous")
            check(ten.dtype == dtype, f"{name} must be {label}")
    return dev


def fused_linear_cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                      relu: bool = False) -> torch.Tensor:
    """Launches `csrc/fused_linear.cu` on the current stream; raises on
    inputs the kernel does not take. Counts its launches in
    `fused_linear_cuda.launches`."""
    dev = check_float32_operands(_check, dict(x=x, w=w, b=b))
    _check(x.ndim == 2 and w.ndim == 2 and b.ndim == 1,
           "x and w must be matrices and b a vector")
    m, k = x.shape
    n = w.shape[1]
    _check(w.shape[0] == k and b.shape == (n,),
           f"w {tuple(w.shape)} / b {tuple(b.shape)} do not match x "
           f"{tuple(x.shape)}")
    y = torch.empty((m, n), dtype=torch.float32, device=dev)
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.fused_linear(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                               y.data_ptr(), m, k, n, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"fused_linear launch failed: cudaError {err}")
    fused_linear_cuda.launches += 1
    return y


fused_linear_cuda.launches = 0


def fused_linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 relu: bool = False, tile: int = 512) -> torch.Tensor:
    """y = x @ w + b (+ReLU), [E, Din] @ [Din, H], float32: a CUDA tensor
    launches the kernel (or raises), a CPU tensor takes the plain version.
    `tile`, the TPU kernel's row block in VMEM, is accepted for the JAX
    signature and has no effect: the card's tile is the kernel's own."""
    del tile
    fn = fused_linear_cuda if x.is_cuda else fused_linear_plain
    return fn(x, w, b, relu)
