"""Hoisted max aggregation (v1) over receiver-CSR tiles, forward and
backward, in float32: the node-level-projection form.

Port of `make_fused_hoisted_aggregate` and
`make_fused_hoisted_aggregate_pallas_bwd`
(`radargnn_tpu/ops/pallas_kernels.py`). With the sender projection
y_s = x @ W_s computed once per node by the caller, and the tiles of
`ops.windowed_tiles.prepare_csr_tiles` (each slot with its sender
`senders_t`, the permuted senders, and its receiver, -1 on an empty slot),

    inner[n] = max over the slots with receiver n of
               (y_s[senders_t] + e_t @ w_e + b)
    out[n]   = offset[n] + inner[n] for non-empty n, else 0.

Unlike v2-v4, v1 puts b inside the operand, so the backward's routing
compares the operand with the bias against `inner`.

The forward of both factories is the hand-written kernel
`csrc/hoisted_fwd_v1.cu` (replaces `_hoisted_scan_kernel`); it gathers the
rows of y_s itself, where the JAX package gathers them in XLA, and lands
the exact max, where the TPU kernel lands a mean of equal maxima (about
1e-7 relative from it). The backward of `make_fused_hoisted_aggregate` is
the JAX package's XLA backward in torch ops; that of
`make_fused_hoisted_aggregate_pallas_bwd` is the hand-written kernel
`csrc/hoisted_bwd_v1.cu` (replaces `_hoisted_bwd_kernel`), with d_y_s
landed by sender through `ops.segment_sum` (B3), deterministically. Both
route g to every slot within 1e-5 |inner| + 1e-5 of its receiver's max
(a tied slot takes the full g), gated to slots with a receiver.

Types: float32 throughout, the JAX function's contract wherever it is
exact (interpret mode); the bf16 gather of y_s that
`make_fused_hoisted_aggregate_pallas_bwd` makes on a TPU is a TPU
bandwidth choice the port does not make. On the CPU the wrappers take
their plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from radargnn_tpu_torch.build import load_library
from radargnn_tpu_torch.ops import segment_sum
from radargnn_tpu_torch.ops.dense_aggregate import _MAX_SMEM, _NEG, _routes
from radargnn_tpu_torch.ops.fused_linear import check_float32_operands
from radargnn_tpu_torch.ops.windowed_aggregate import slot_counts


def _slot_operands(y_s, e_t, w_e, b, senders_t, recv, tile_blocks,
                   num_nodes: int, node_block: int, edge_tile: int):
    """Every slot's operand (y_s[sender] + e_t @ w_e) + b [E_pad, H], its
    receiver (0 where it does not count) and whether it counts (its
    receiver in its tile's node block, its sender a row of y_s)."""
    s = senders_t.long()
    valid = slot_counts(recv, tile_blocks, num_nodes, node_block,
                        edge_tile) & (s >= 0) & (s < y_s.shape[0])
    op = (y_s[torch.where(valid, s, 0)] + e_t @ w_e) + b
    return op, torch.where(valid, recv.long(), 0), valid


def hoisted_fwd_plain(y_s, e_t, w_e, b, senders_t, recv, tile_blocks,
                      offset, *, node_block: int, edge_tile: int,
                      emit_inner: bool = False):
    """Plain torch version of the forward kernel: the same function on the
    same float32 inputs. Returns out, or (out, inner) with `emit_inner`."""
    num_nodes, h = offset.shape
    op, rc, valid = _slot_operands(y_s, e_t, w_e, b, senders_t, recv,
                                   tile_blocks, num_nodes, node_block,
                                   edge_tile)
    op = torch.where(valid[:, None], op, _NEG)
    inner = torch.full((num_nodes, h), _NEG, dtype=torch.float32,
                       device=op.device)
    inner = inner.scatter_reduce_(0, rc[:, None].expand_as(op), op, "amax")
    out = torch.where(inner > _NEG / 2, offset + inner, 0.0)
    return (out, inner) if emit_inner else out


def hoisted_bwd_plain(y_s, e_t, w_e, b, senders_t, recv, tile_blocks,
                      inner_z, g_pass, *, node_block: int, edge_tile: int):
    """Plain torch version of the backward kernel on the same inputs
    (inner_z, g_pass [num_nodes, H] with 0 at empty receivers). Returns
    (d_op [E_pad, H], d_e [E_pad, d_e], dW_e [d_e, H], d_b [H])."""
    op, rc, valid = _slot_operands(y_s, e_t, w_e, b, senders_t, recv,
                                   tile_blocks, inner_z.shape[0], node_block,
                                   edge_tile)
    d_op = torch.where(valid[:, None] & _routes(op, inner_z[rc]),
                       g_pass[rc], 0.0)
    return d_op, d_op @ w_e.t(), e_t.t() @ d_op, d_op.sum(dim=0)


# ---------------------------------------------------------------------------
# the CUDA kernels: build at first use, bind through ctypes
# ---------------------------------------------------------------------------

def _bind_fwd(lib: ctypes.CDLL) -> None:
    lib.hoisted_fwd_v1.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.hoisted_fwd_v1.restype = ctypes.c_int
    lib.hoisted_fwd_v1_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.hoisted_fwd_v1_smem_bytes.restype = ctypes.c_size_t


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.hoisted_bwd_v1.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.hoisted_bwd_v1.restype = ctypes.c_int
    lib.hoisted_bwd_v1_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.hoisted_bwd_v1_smem_bytes.restype = ctypes.c_size_t
    lib.hoisted_bwd_v1_max_de.argtypes = []
    lib.hoisted_bwd_v1_max_de.restype = ctypes.c_int


def load_fwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/hoisted_fwd_v1.cu` once."""
    return load_library("hoisted_fwd_v1.cu", _bind_fwd)


def load_bwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/hoisted_bwd_v1.cu` once."""
    return load_library("hoisted_bwd_v1.cu", _bind_bwd)


def _checker(kernel: str):
    def check(cond: bool, msg: str) -> None:
        if not cond:
            raise ValueError(f"{kernel} kernel: {msg}")
    return check


def _check_operands(check, y_s, e_t, w_e, b, senders_t, recv, tile_blocks,
                    node_tensors: dict, *, edge_tile: int) -> torch.device:
    """The checks both v1 kernels share: one CUDA device, contiguous,
    float32 operands and int32 layout, matching shapes; `node_tensors` are
    the float32 [num_nodes, H] inputs."""
    dev = check_float32_operands(
        check, dict(y_s=y_s, e_t=e_t, w_e=w_e, b=b, **node_tensors),
        dict(senders_t=senders_t, padded_recv=recv, tile_blocks=tile_blocks))
    check(y_s.ndim == 2 and e_t.ndim == 2 and w_e.ndim == 2 and b.ndim == 1,
          "y_s, e_t and w_e must be matrices and b a vector")
    h = y_s.shape[1]
    e_pad, de = e_t.shape
    t = tile_blocks.shape[0]
    check(w_e.shape == (de, h) and b.shape == (h,) and de > 0,
          f"w_e {tuple(w_e.shape)} / b {tuple(b.shape)} do not match "
          f"d_e={de}, H={h}")
    check(e_pad == t * edge_tile and senders_t.shape == (e_pad,)
          and recv.shape == (e_pad,),
          f"{e_pad} slots do not match {t} tiles x {edge_tile}")
    shapes = {tuple(ten.shape) for ten in node_tensors.values()}
    check(len(shapes) == 1 and next(iter(shapes))[1:] == (h,),
          f"{', '.join(node_tensors)} must be one [num_nodes, {h}] shape")
    return dev


def hoisted_fwd_cuda(y_s, e_t, w_e, b, senders_t, recv, tile_blocks, offset,
                     *, node_block: int, edge_tile: int,
                     emit_inner: bool = False):
    """Launches `csrc/hoisted_fwd_v1.cu` on the current stream (VJP mode
    with `emit_inner`: it also writes `inner`); raises on inputs the kernel
    does not take. Counts its launches in `hoisted_fwd_cuda.launches`."""
    check = _checker("hoisted_fwd_v1")
    dev = _check_operands(check, y_s, e_t, w_e, b, senders_t, recv,
                          tile_blocks, dict(offset=offset),
                          edge_tile=edge_tile)
    n_y, h = y_s.shape
    de = e_t.shape[1]
    num_nodes = offset.shape[0]
    t = tile_blocks.shape[0]
    lib = load_fwd_kernel()
    check(lib.hoisted_fwd_v1_smem_bytes(de, node_block) <= _MAX_SMEM,
          f"d_e={de}, node_block={node_block} need more shared memory than "
          "a block has")
    out = torch.empty((num_nodes, h), dtype=torch.float32, device=dev)
    inner = torch.empty_like(out) if emit_inner else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hoisted_fwd_v1(
            y_s.data_ptr(), e_t.data_ptr(), w_e.data_ptr(), b.data_ptr(),
            senders_t.data_ptr(), recv.data_ptr(), tile_blocks.data_ptr(),
            offset.data_ptr(), out.data_ptr(),
            None if inner is None else inner.data_ptr(), n_y, de, h, t,
            num_nodes, node_block, edge_tile, stream)
    if err != 0:
        raise RuntimeError(f"hoisted_fwd_v1 launch failed: cudaError {err}")
    hoisted_fwd_cuda.launches += 1
    return (out, inner) if emit_inner else out


hoisted_fwd_cuda.launches = 0


def hoisted_fwd(y_s, e_t, w_e, b, senders_t, recv, tile_blocks, offset, *,
                node_block: int, edge_tile: int, emit_inner: bool = False):
    """The forward kernel's wrapper: a CUDA tensor launches the kernel (or
    raises), a CPU tensor takes the plain version."""
    fn = hoisted_fwd_cuda if y_s.is_cuda else hoisted_fwd_plain
    return fn(y_s, e_t, w_e, b, senders_t, recv, tile_blocks, offset,
              node_block=node_block, edge_tile=edge_tile,
              emit_inner=emit_inner)


def hoisted_bwd_cuda(y_s, e_t, w_e, b, senders_t, recv, tile_blocks,
                     inner_z, g_pass, *, node_block: int, edge_tile: int):
    """Launches the two passes of `csrc/hoisted_bwd_v1.cu` on the current
    stream; raises on inputs the kernels do not take. Returns what
    `hoisted_bwd_plain` returns. Counts its launches in
    `hoisted_bwd_cuda.launches` (one per backward)."""
    check = _checker("hoisted_bwd_v1")
    dev = _check_operands(check, y_s, e_t, w_e, b, senders_t, recv,
                          tile_blocks, dict(inner_z=inner_z, g_pass=g_pass),
                          edge_tile=edge_tile)
    n_y, h = y_s.shape
    e_pad, de = e_t.shape
    num_nodes = inner_z.shape[0]
    t = tile_blocks.shape[0]
    lib = load_bwd_kernel()
    check(edge_tile % 4 == 0,
          f"edge_tile must be a multiple of 4 (got {edge_tile})")
    check(lib.hoisted_bwd_v1_smem_bytes(de, edge_tile) <= _MAX_SMEM
          and de <= lib.hoisted_bwd_v1_max_de(),
          f"d_e={de}, edge_tile={edge_tile} need more shared memory or "
          "threads than a block has")
    f32 = torch.float32
    d_op = torch.empty((e_pad, h), dtype=f32, device=dev)
    d_e = torch.empty((e_pad, de), dtype=f32, device=dev)
    part = torch.empty((t, de + 1, h), dtype=f32, device=dev)
    dw_e = torch.empty((de, h), dtype=f32, device=dev)
    d_b = torch.empty((h,), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.hoisted_bwd_v1(
            y_s.data_ptr(), e_t.data_ptr(), w_e.data_ptr(), b.data_ptr(),
            senders_t.data_ptr(), recv.data_ptr(), tile_blocks.data_ptr(),
            inner_z.data_ptr(), g_pass.data_ptr(), d_op.data_ptr(),
            d_e.data_ptr(), part.data_ptr(), dw_e.data_ptr(), d_b.data_ptr(),
            n_y, de, h, t, num_nodes, node_block, edge_tile, stream)
    if err != 0:
        raise RuntimeError(f"hoisted_bwd_v1 launch failed: cudaError {err}")
    hoisted_bwd_cuda.launches += 1
    return d_op, d_e, dw_e, d_b


hoisted_bwd_cuda.launches = 0


def hoisted_bwd(y_s, e_t, w_e, b, senders_t, recv, tile_blocks, inner_z,
                g_pass, *, node_block: int, edge_tile: int):
    """The backward kernel's wrapper: a CUDA tensor launches it (or
    raises), a CPU tensor takes the plain version."""
    fn = hoisted_bwd_cuda if y_s.is_cuda else hoisted_bwd_plain
    return fn(y_s, e_t, w_e, b, senders_t, recv, tile_blocks, inner_z,
              g_pass, node_block=node_block, edge_tile=edge_tile)


# ---------------------------------------------------------------------------
# autograd Functions and the two factories
# ---------------------------------------------------------------------------

def _land_by_sender(d_op, senders_t, recv, n_y: int) -> torch.Tensor:
    """d_y_s: the rows of d_op summed at their senders, over the slots with
    a receiver (d_op is 0 on the others), through segment_sum_csr (B3) in a
    fixed order. B3 takes widths in multiples of 8: d_op is zero-padded to
    one and the result cut back."""
    order, row_ptr = segment_sum.rows_by_sender(
        torch.where(recv >= 0, senders_t, -1).cpu().numpy(), n_y)
    h = d_op.shape[1]
    pad = -h % 8
    if pad:
        d_op = torch.nn.functional.pad(d_op, (0, pad))
    dev = d_op.device
    return segment_sum.segment_sum_csr(
        d_op, torch.from_numpy(order).to(dev),
        torch.from_numpy(row_ptr).to(dev))[:, :h]


def _prep(y_s, e_t, w_e, b, offset):
    return tuple(a.float().contiguous() for a in (y_s, e_t, w_e, b, offset))


class _HoistedFn(torch.autograd.Function):
    """The v1 aggregation with the JAX package's custom VJP; `kernel_bwd`
    picks the backward: the XLA one in torch ops, or the kernel's."""

    @staticmethod
    def forward(ctx, y_s, e_t, w_e, b, offset, senders_t, recv, tile_blocks,
                geo, kernel_bwd):
        node_block, edge_tile = geo
        ops = _prep(y_s, e_t, w_e, b, offset)
        layout = (senders_t, recv, tile_blocks)
        out, inner = hoisted_fwd(*ops[:4], *layout, ops[4],
                                 node_block=node_block, edge_tile=edge_tile,
                                 emit_inner=True)
        ctx.geo, ctx.kernel_bwd = geo, kernel_bwd
        ctx.dtypes = tuple(a.dtype for a in (y_s, e_t, w_e, b, offset))
        ctx.save_for_backward(*ops[:4], *layout, inner)
        return out

    @staticmethod
    def backward(ctx, g):
        y_s, e_t, w_e, b, senders_t, recv, blocks, inner = ctx.saved_tensors
        has = inner > _NEG / 2
        g_pass = torch.where(has, g.float(), 0.0)
        if ctx.kernel_bwd:
            node_block, edge_tile = ctx.geo
            d_op, d_e, d_we, d_b = hoisted_bwd(
                y_s, e_t, w_e, b, senders_t, recv, blocks,
                torch.where(has, inner, 0.0), g_pass, node_block=node_block,
                edge_tile=edge_tile)
            d_ys = _land_by_sender(d_op, senders_t, recv, y_s.shape[0])
        else:
            # the XLA backward of make_fused_hoisted_aggregate
            valid = recv >= 0
            recv_c = torch.where(valid, recv, 0).long()
            s = senders_t.long()
            operand = (y_s[s] + e_t @ w_e) + b
            sel = valid[:, None] & _routes(operand, inner[recv_c])
            d_op = torch.where(sel, g_pass[recv_c], 0.0)
            d_ys = torch.zeros_like(y_s).index_add_(0, s, d_op)
            d_e, d_we, d_b = d_op @ w_e.t(), e_t.t() @ d_op, d_op.sum(dim=0)
        grads = (d_ys, d_e, d_we, d_b, g_pass)
        return tuple(gr.to(dt) for gr, dt in zip(grads, ctx.dtypes)) \
            + (None,) * 5


def _factory(num_nodes: int, node_block: int, edge_tile: int,
             kernel_bwd: bool):
    geo = (node_block, edge_tile)

    def fused(y_s, e_t, w_e, b, senders_t, padded_recv, tile_blocks, offset):
        if offset.shape[0] != num_nodes:
            raise ValueError(f"offset has {offset.shape[0]} rows, the "
                             f"aggregate {num_nodes}")
        layout = tuple(a.contiguous() for a in (senders_t, padded_recv,
                                                tile_blocks))
        needs_grad = torch.is_grad_enabled() and any(
            t.requires_grad for t in (y_s, e_t, w_e, b, offset))
        if not needs_grad:
            ops = _prep(y_s, e_t, w_e, b, offset)
            return hoisted_fwd(*ops[:4], *layout, ops[4],
                               node_block=node_block, edge_tile=edge_tile)
        return _HoistedFn.apply(y_s, e_t, w_e, b, offset, *layout, geo,
                                kernel_bwd)
    return fused


def make_fused_hoisted_aggregate(num_nodes: int, node_block: int = 128,
                                 edge_tile: int = 256):
    """The v1 aggregation (module docstring) with the kernel forward and the
    JAX package's XLA backward in torch ops: `fused(y_s, e_t, w_e, b,
    senders_t, padded_recv, tile_blocks, offset)`, differentiable in y_s,
    e_t, w_e, b and offset."""
    return _factory(num_nodes, node_block, edge_tile, kernel_bwd=False)


def make_fused_hoisted_aggregate_pallas_bwd(num_nodes: int,
                                            node_block: int = 128,
                                            edge_tile: int = 256):
    """The v1 aggregation with kernels for the forward and the backward
    (the JAX package's name: its backward is a Pallas kernel there, the
    hand-written `csrc/hoisted_bwd_v1.cu` here); the signature of
    `make_fused_hoisted_aggregate`."""
    return _factory(num_nodes, node_block, edge_tile, kernel_bwd=True)
