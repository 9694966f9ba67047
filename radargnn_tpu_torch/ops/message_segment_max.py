"""Fused message matmul + segment max over receiver-CSR tiles, in float32.

Port of `fused_message_segment_max` and
`fused_message_segment_max_reference` (`radargnn_tpu/ops/pallas_kernels.py`):
with edges pre-permuted by `ops.windowed_tiles.prepare_csr_tiles`
(receivers sorted, each node block's edges padded to whole tiles, -1 on an
empty slot),

    out[n] = max over the slots with receiver n of (m_in[slot] @ w + b)

and 0 for a receiver without a slot; an all-negative maximum stays
negative. The messages `m` never reach device memory.

On the card it is the hand-written kernel `csrc/msg_segmax.cu` (replaces
`_msg_segmax_scan_kernel` and `_msg_segmax_kernel`); on the CPU the wrapper
takes the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from radargnn_tpu_torch.build import load_library
from radargnn_tpu_torch.ops.dense_aggregate import _MAX_SMEM, _NEG
from radargnn_tpu_torch.ops.fused_linear import check_float32_operands
from radargnn_tpu_torch.ops.segment import segment_max
from radargnn_tpu_torch.ops.windowed_aggregate import slot_counts

VARIANTS = ("scan", "onehot")


def msg_segmax_plain(m_in, w, b, padded_recv, tile_blocks, *,
                     num_nodes: int, node_block: int,
                     edge_tile: int) -> torch.Tensor:
    """Plain torch version of the kernel: the same function on the same
    tiled inputs, float32 [num_nodes, H]. A slot counts where its receiver
    lies in its tile's node block."""
    m = m_in.float() @ w.float() + b.float()
    valid = slot_counts(padded_recv, tile_blocks, num_nodes, node_block,
                        edge_tile)
    rc = torch.where(valid, padded_recv.long(), 0)
    m = torch.where(valid[:, None], m, _NEG)
    out = torch.full((num_nodes, m.shape[1]), _NEG, dtype=torch.float32,
                     device=m.device)
    out = out.scatter_reduce_(0, rc[:, None].expand_as(m), m, "amax")
    return torch.where(out <= _NEG / 2, 0.0, out)


def fused_message_segment_max_reference(m_in, w, b, receivers, mask,
                                        num_nodes: int) -> torch.Tensor:
    """The reference on the untiled edges (any order): segment_max of
    m_in @ w + b, empty receivers 0."""
    return segment_max(m_in.float() @ w.float() + b.float(), receivers,
                       num_nodes, mask)


def _bind(lib: ctypes.CDLL) -> None:
    lib.msg_segmax.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 \
        + [ctypes.c_void_p]
    lib.msg_segmax.restype = ctypes.c_int
    lib.msg_segmax_smem_bytes.argtypes = [ctypes.c_int]
    lib.msg_segmax_smem_bytes.restype = ctypes.c_size_t


def load_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/msg_segmax.cu` once."""
    return load_library("msg_segmax.cu", _bind)


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"msg_segmax kernel: {msg}")


def _vec4(t: torch.Tensor, width: int) -> int:
    """1 where rows of `width` floats of `t` may be read in 16-byte loads."""
    return int(width % 4 == 0 and t.data_ptr() % 16 == 0)


def msg_segmax_cuda(m_in, w, b, padded_recv, tile_blocks, *, num_nodes: int,
                    node_block: int, edge_tile: int) -> torch.Tensor:
    """Launches `csrc/msg_segmax.cu` on the current stream; raises on inputs
    the kernel does not take. Counts its launches in
    `msg_segmax_cuda.launches`."""
    dev = check_float32_operands(
        _check, dict(m_in=m_in, w=w, b=b),
        dict(padded_receivers=padded_recv, tile_blocks=tile_blocks))
    _check(m_in.ndim == 2 and w.ndim == 2 and b.ndim == 1,
           "m_in and w must be matrices and b a vector")
    e_pad, d_in = m_in.shape
    h = w.shape[1]
    t = tile_blocks.shape[0]
    _check(w.shape[0] == d_in and b.shape == (h,),
           f"w {tuple(w.shape)} / b {tuple(b.shape)} do not match m_in "
           f"{tuple(m_in.shape)}")
    _check(e_pad == t * edge_tile and padded_recv.shape == (e_pad,),
           f"{e_pad} slots do not match {t} tiles x {edge_tile}")
    lib = load_kernel()
    _check(lib.msg_segmax_smem_bytes(node_block) <= _MAX_SMEM,
           f"node_block {node_block} needs more shared memory than a block "
           "has")
    out = torch.empty((num_nodes, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.msg_segmax(m_in.data_ptr(), w.data_ptr(), b.data_ptr(),
                             padded_recv.data_ptr(), tile_blocks.data_ptr(),
                             out.data_ptr(), d_in, h, t, num_nodes,
                             node_block, edge_tile,
                             _vec4(m_in, d_in), _vec4(w, h), stream)
    if err != 0:
        raise RuntimeError(f"msg_segmax launch failed: cudaError {err}")
    msg_segmax_cuda.launches += 1
    return out


msg_segmax_cuda.launches = 0


def msg_segmax(m_in, w, b, padded_recv, tile_blocks, *, num_nodes: int,
               node_block: int, edge_tile: int) -> torch.Tensor:
    """The kernel's wrapper: a CUDA tensor launches the kernel (or raises),
    a CPU tensor takes the plain version."""
    fn = msg_segmax_cuda if m_in.is_cuda else msg_segmax_plain
    return fn(m_in, w, b, padded_recv, tile_blocks, num_nodes=num_nodes,
              node_block=node_block, edge_tile=edge_tile)


def fused_message_segment_max(m_in: torch.Tensor, w: torch.Tensor,
                              b: torch.Tensor, padded_receivers: torch.Tensor,
                              tile_blocks: torch.Tensor, num_nodes: int,
                              node_block: int = 128, edge_tile: int = 128,
                              variant: str = "scan") -> torch.Tensor:
    """out[n] = max over edges e with receiver n of (m_in[e] @ w + b), with
    the JAX package's signature less `interpret` (the port has no
    interpret mode).

    Inputs must be pre-permuted with `prepare_csr_tiles`. Empty segments
    give 0. `variant` names the TPU kernel's two landings, "scan" (a
    segmented log-roll max with a one-hot mean landing) and "onehot" (a
    chunked one-hot max); both compute this function and are ways to land
    rows on a TPU's matrix unit, which do not carry over, so both run the
    one kernel here."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: one of {VARIANTS}")
    return msg_segmax(m_in, w, b, padded_receivers, tile_blocks,
                      num_nodes=num_nodes, node_block=node_block,
                      edge_tile=edge_tile)
