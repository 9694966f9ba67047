"""Segment sum over segment-sorted rows (CSR): the deterministic landing of
the fused backwards' d_x (dense, windowed and CSR paths).

Port of `pallas_segment_sum_csr` (`radargnn_tpu/ops/pallas_kernels.py`),
`out[n] = sum of the rows whose segment is n`, in float32. Here the rows
come in through an index: `order` lists them grouped by segment and
segment n owns `order[row_ptr[n]:row_ptr[n+1]]` (the TPU version takes the
rows pre-permuted into segment-sorted tiles instead). The rows may come
from two sources, `a` (bf16 or float32) and `b` (float32), numbered one
after the other, so the dense backward lands its per-slot rows and its
overflow rows in one pass.

On the card this is the hand-written kernel `csrc/segment_sum_csr.cu`
(replaces `_segsum_kernel`): one warp per segment, sums in a fixed order,
no atomics, so a run is bitwise repeatable. On the CPU it is the plain
version (`index_add_`, sequential there).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from radargnn_tpu_torch.build import load_library


class SenderLanding(NamedTuple):
    """Where a fused backward lands d_x: the rows (valid slots of the flat
    slot layout, then valid overflow rows where the layout has them)
    grouped by global sender, stable within a sender, and each sender's
    range in `order`."""

    order: torch.Tensor       # [M] int32, row indices
    row_ptr: torch.Tensor     # [N + 1] int32


def sender_landing(senders_local: np.ndarray, tile_win: np.ndarray,
                   ovf_s: np.ndarray, ovf_valid: np.ndarray, *,
                   slots_per_tile: int, node_block: int, num_nodes: int):
    """Host build of a batch's sender-sorted landing (numpy): row i <
    len(senders_local) is slot i (sender tile_win[i // slots_per_tile] *
    node_block + senders_local[i], empty when senders_local < 0), the rows
    after it are the overflow rows (sender ovf_s, empty where not
    ovf_valid). Returns (order int32, row_ptr int32 [num_nodes + 1])."""
    sloc = np.asarray(senders_local).astype(np.int64)
    win = np.repeat(np.asarray(tile_win).astype(np.int64) * node_block,
                    slots_per_tile)
    send = np.concatenate([np.where(sloc >= 0, win + sloc, -1),
                           np.where(ovf_valid, ovf_s, -1).astype(np.int64)])
    return rows_by_sender(send, num_nodes)


def rows_by_sender(send: np.ndarray, num_nodes: int):
    """(order, row_ptr) int32 of the rows with a sender (send >= 0), grouped
    by sender and stable within one."""
    send = np.asarray(send).astype(np.int64)
    rows = np.flatnonzero(send >= 0)
    order = rows[np.argsort(send[rows], kind="stable")]
    return order.astype(np.int32), _row_ptr(send[rows], num_nodes)


def _row_ptr(send: np.ndarray, num_nodes: int) -> np.ndarray:
    counts = np.bincount(send, minlength=num_nodes)
    if counts.size > num_nodes:
        raise ValueError(f"a sender lies past the {num_nodes} nodes")
    return np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)


def csr_landing(ssum_perm: np.ndarray, ssum_senders: np.ndarray,
                num_nodes: int):
    """The landing of the CSR path, read off its sender-sorted second tiling
    (`prepare_csr_tiles` over the receiver tiles' senders, in the flat
    global layout): `order` is ssum_perm at the tiling's valid slots, in
    tile order, so the landing sums each sender's rows in the order the
    TPU's `_segsum_kernel` visits them. Returns (order, row_ptr) int32."""
    ssum_senders = np.asarray(ssum_senders).astype(np.int64)
    valid = ssum_senders >= 0
    send = ssum_senders[valid]
    if np.any(np.diff(send) < 0):
        raise ValueError("the sender-sorted tiling is not sorted by sender")
    order = np.asarray(ssum_perm)[valid].astype(np.int32)
    return order, _row_ptr(send, num_nodes)


def segment_ids(row_ptr: torch.Tensor) -> torch.Tensor:
    """The segment of each entry of `order`, int64 [M]."""
    n = row_ptr.numel() - 1
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device),
        (row_ptr[1:] - row_ptr[:-1]).long())


def segment_sum_csr_plain(a: torch.Tensor, order: torch.Tensor,
                          row_ptr: torch.Tensor,
                          b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of the kernel: the same function on the same
    inputs, float32 [N, d]."""
    rows = a.float() if b is None else torch.cat([a.float(), b.float()])
    out = torch.zeros((row_ptr.numel() - 1, rows.shape[1]),
                      dtype=torch.float32, device=rows.device)
    return out.index_add_(0, segment_ids(row_ptr), rows[order.long()])


def _bind(lib: ctypes.CDLL) -> None:
    lib.segment_sum_csr.argtypes = (
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]
        + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.segment_sum_csr.restype = ctypes.c_int


def load_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/segment_sum_csr.cu` once per
    process."""
    return load_library("segment_sum_csr.cu", _bind)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"segment_sum_csr kernel: {msg}")


def segment_sum_csr_cuda(a: torch.Tensor, order: torch.Tensor,
                         row_ptr: torch.Tensor,
                         b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launches `csrc/segment_sum_csr.cu` on the current stream; raises on
    inputs the kernel does not take. Counts its launches in
    `segment_sum_csr_cuda.launches`."""
    dev = a.device
    tensors = dict(a=a, order=order, row_ptr=row_ptr)
    if b is not None:
        tensors["b"] = b
    for name, ten in tensors.items():
        _check(ten.device == dev and dev.type == "cuda",
               f"{name} must be on {dev} (a CUDA device)")
        _check(ten.is_contiguous(), f"{name} must be contiguous")
    _check(a.dtype in (torch.bfloat16, torch.float32),
           "a must be bf16 or float32")
    _check(b is None or b.dtype == torch.float32, "b must be float32")
    _check(order.dtype == torch.int32 and row_ptr.dtype == torch.int32,
           "order and row_ptr must be int32")
    d = a.shape[1]
    _check(a.ndim == 2 and (b is None or b.shape[1] == d),
           "a and b must be [rows, d] with one d")
    _check(d % 8 == 0, f"d must be a multiple of 8 (got {d})")
    for name in ("a", "b"):
        if name in tensors:
            _check(tensors[name].data_ptr() % 16 == 0,
                   f"{name} must be 16-byte aligned")
    n_seg = row_ptr.numel() - 1
    out = torch.empty((n_seg, d), dtype=torch.float32, device=dev)
    lib = load_kernel()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_sum_csr(
            a.data_ptr(), int(a.dtype == torch.bfloat16), a.shape[0],
            None if b is None else b.data_ptr(), order.data_ptr(),
            row_ptr.data_ptr(), out.data_ptr(), n_seg, d, stream)
    if err != 0:
        raise RuntimeError(f"segment_sum_csr launch failed: cudaError {err}")
    segment_sum_csr_cuda.launches += 1
    return out


segment_sum_csr_cuda.launches = 0


def segment_sum_csr(a: torch.Tensor, order: torch.Tensor,
                    row_ptr: torch.Tensor,
                    b: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's wrapper: a CUDA tensor launches the kernel (or raises),
    a CPU tensor takes the plain version."""
    fn = segment_sum_csr_cuda if a.is_cuda else segment_sum_csr_plain
    return fn(a, order, row_ptr, b)
