"""Windowed hoisted max aggregation, forward and backward.

Port of `make_fused_hoisted_aggregate_v3` (`radargnn_tpu/ops/pallas_kernels.py`)
on its default variant (strict routing, no `bf16_max`, `stream_m`,
`sender_dx`, `bf16_landing` or `precomp_*`; `precomp_eq` streams the TPU's
gather one-hots and changes nothing here). With the tile layout of
`ops.windowed_tiles` (receiver-sorted tiles of `edge_tile` slots, each in
one node block, per-tile sender windows, an overflow list),

    inner[n] = max over the in-window slots and overflow edges with
               receiver n of (x[sender] @ w_s + e @ w_e)
    out[n]   = offset[n] + inner[n] for non-empty n, else 0.

A slot counts where its receiver lies in its tile's node block (the empty
slots carry receiver -1); its sender row is zero where it has none
(senders_local -1), as the TPU kernel's one-hot gather gives.

On the card the slot part runs in the hand-written kernels
`csrc/windowed_fwd_v3.cu` (replaces `_fused_fwd_kernel_v3`) and
`csrc/windowed_bwd_v3.cu` (replaces `_fused_bwd_kernel_v3`); the overflow
part is the dense aggregation's torch code (`dense_aggregate`), which
computes the JAX package's sorted-receiver scatter-max and overflow
backward. As there, the gather operands are bf16 on the accelerator and
float32 where the JAX package runs its kernels in interpret mode (the
CPU).

The gradient is `WindowedAggregateFn`, the custom VJP of the JAX package:
the forward runs in VJP mode and saves `inner`; the backward routes g to
every valid slot whose recomputed operand lies within 1e-5 |inner| + 1e-5
of its receiver's max (a tied slot takes the full g), computes d_e per
slot, dW_s, dW_e and the per-slot d_xg in the kernels, and lands d_x with
the overflow rows by sender in one deterministic pass of
`ops.segment_sum` over the batch's landing (`graph/batch.py`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from radargnn_tpu_torch.build import load_library
from radargnn_tpu_torch.models.mlp import matmul_f32
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops.dense_aggregate import _NEG, _check, _routes


def chunk_rows(edge_tile: int) -> int:
    """Slots per mma row block of the kernels (R of the slot-row loop): 64,
    or the largest of 32 / 16 that divides a smaller tile."""
    return math.gcd(edge_tile, 64)


def slot_counts(recv, tile_blocks, num_nodes: int, node_block: int,
                edge_tile: int) -> torch.Tensor:
    """Whether each slot counts: its receiver lies in its tile's node block
    (the empty slots carry receiver -1). The CSR layout's rule too."""
    base = tile_blocks.long().repeat_interleave(edge_tile) * node_block
    r = recv.long()
    return (r >= base) & (r < base + node_block) & (r < num_nodes)


def _slot_geometry(recv, sloc, tile_win, tile_blocks, x_rows: int,
                   num_nodes: int, node_block: int, edge_tile: int):
    """Per slot: its global sender (0 where it has none), whether it has
    one, and whether it counts (its receiver in its tile's node block)."""
    win = tile_win.long().repeat_interleave(edge_tile) * node_block
    sender = win + sloc.long().clamp(min=0)
    has_sender = (sloc >= 0) & (sender < x_rows)
    valid = slot_counts(recv, tile_blocks, num_nodes, node_block, edge_tile)
    return torch.where(has_sender, sender, 0), has_sender, valid


def _slot_operands(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                   tile_blocks, num_nodes: int, node_block: int,
                   edge_tile: int):
    """The gathered sender rows x_g [E_pad, d] (zero where a slot has no
    sender), every slot's operand op [E_pad, H] float32, its receiver
    (0 where it does not count) and whether it counts."""
    sender, has_sender, valid = _slot_geometry(
        recv, sloc, tile_win, tile_blocks, x_c.shape[0], num_nodes,
        node_block, edge_tile)
    x_g = torch.where(has_sender[:, None], x_c[sender], 0)
    op = matmul_f32(x_g, w_s_c, x_c.dtype) \
        + matmul_f32(e_t_c, w_e_c, e_t_c.dtype)
    return x_g, op, torch.where(valid, recv.long(), 0), valid


def windowed_fwd_plain(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                       tile_blocks, inner_o, offset, *, node_block: int,
                       edge_tile: int, emit_inner: bool = False):
    """Plain torch version of the windowed forward kernel: the same function
    on the same inputs (x_c, w_s_c, e_t_c, w_e_c in the gather dtype;
    inner_o, offset float32 [num_nodes, H]), products in float32. Returns
    out, or (out, inner) with `emit_inner`."""
    num_nodes, h = offset.shape
    _, op, rc, valid = _slot_operands(x_c, w_s_c, e_t_c, w_e_c, recv, sloc,
                                      tile_win, tile_blocks, num_nodes,
                                      node_block, edge_tile)
    op = torch.where(valid[:, None], op, _NEG)
    acc = torch.full((num_nodes, h), _NEG, dtype=torch.float32,
                     device=op.device)
    acc = acc.scatter_reduce_(0, rc[:, None].expand_as(op), op, "amax")
    inner = torch.maximum(acc, inner_o)
    out = torch.where(inner > _NEG / 2, offset + inner, 0.0)
    return (out, inner) if emit_inner else out


def windowed_bwd_plain(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                       tile_blocks, inner_z, g_pass, *, node_block: int,
                       edge_tile: int):
    """Plain torch version of the windowed backward kernels on the same
    inputs (gather dtype operands; inner_z, g_pass float32 [num_nodes, H]
    with 0 at empty receivers). Returns (d_xg [E_pad, d] and d_e
    [E_pad, de] in the gather dtype, dW_s [d, H] and dW_e [de, H]
    float32); d_op is rounded to the gather dtype, as the TPU kernel
    rounds it to its grad dtype."""
    cd = x_c.dtype
    x_g, op, rc, valid = _slot_operands(
        x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win, tile_blocks,
        inner_z.shape[0], node_block, edge_tile)
    d_op = torch.where(valid[:, None] & _routes(op, inner_z[rc]),
                       g_pass[rc], 0.0).to(cd)
    return (matmul_f32(d_op, w_s_c.t(), cd).to(cd),
            matmul_f32(d_op, w_e_c.t(), cd).to(cd),
            matmul_f32(x_g.t(), d_op, cd), matmul_f32(e_t_c.t(), d_op, cd))


# ---------------------------------------------------------------------------
# the CUDA kernels: build at first use, bind through ctypes
# ---------------------------------------------------------------------------

def _bind_fwd(lib: ctypes.CDLL) -> None:
    lib.windowed_fwd_v3.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.windowed_fwd_v3.restype = ctypes.c_int
    lib.windowed_fwd_v3_smem_bytes.argtypes = [ctypes.c_int] * 4
    lib.windowed_fwd_v3_smem_bytes.restype = ctypes.c_size_t


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.windowed_bwd_v3.argtypes = (
        [ctypes.c_void_p] * 16 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.windowed_bwd_v3.restype = ctypes.c_int
    lib.windowed_bwd_v3_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.windowed_bwd_v3_smem_bytes.restype = ctypes.c_size_t


def load_fwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/windowed_fwd_v3.cu` once."""
    return load_library("windowed_fwd_v3.cu", _bind_fwd)


def load_bwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/windowed_bwd_v3.cu` once."""
    return load_library("windowed_bwd_v3.cu", _bind_bwd)


def _check_operands(kernel: str, x_c, w_s_c, e_t_c, w_e_c, recv, sloc,
                    tile_win, tile_blocks, node_tensors: dict, *,
                    edge_tile: int) -> None:
    """The checks both windowed kernels share: `check_slot_operands`, then
    the tile layout's shapes; `node_tensors` are the float32
    [num_nodes, H] inputs."""
    da.check_slot_operands(kernel, x_c, w_s_c, e_t_c, w_e_c,
                           dict(recv=recv, senders_local=sloc,
                                tile_win=tile_win, tile_blocks=tile_blocks),
                           node_tensors)
    h = w_s_c.shape[1]
    e_pad = e_t_c.shape[0]
    t = tile_win.shape[0]
    _check(e_pad == t * edge_tile and recv.shape == (e_pad,)
           and sloc.shape == (e_pad,) and tile_blocks.shape == (t,),
           f"{e_pad} slots do not match {t} tiles x {edge_tile}", kernel)
    shapes = {tuple(ten.shape) for ten in node_tensors.values()}
    _check(len(shapes) == 1 and next(iter(shapes))[1:] == (h,),
           f"{', '.join(node_tensors)} must be one [num_nodes, {h}] shape",
           kernel)
    _check(edge_tile % 16 == 0,
           f"edge_tile must be a multiple of 16 (got {edge_tile})", kernel)


def windowed_fwd_cuda(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                      tile_blocks, inner_o, offset, *, node_block: int,
                      edge_tile: int, emit_inner: bool = False):
    """Launches `csrc/windowed_fwd_v3.cu` on the current stream (VJP mode
    with `emit_inner`: it also writes `inner`); raises on inputs the kernel
    does not take. Counts its launches in `windowed_fwd_cuda.launches`."""
    kernel = "windowed_fwd_v3"
    _check_operands(kernel, x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                    tile_blocks, dict(inner_o=inner_o, offset=offset),
                    edge_tile=edge_tile)
    dev = x_c.device
    n_x, d = x_c.shape
    de = e_t_c.shape[1]
    num_nodes, h = offset.shape
    t = tile_win.shape[0]
    r_chunk = chunk_rows(edge_tile)
    lib = load_fwd_kernel()
    _check(lib.windowed_fwd_v3_smem_bytes(d, de, r_chunk, node_block)
           <= da._MAX_SMEM,
           f"d={d}, node_block={node_block} need more shared memory than a "
           "block has", kernel)
    out = torch.empty((num_nodes, h), dtype=torch.float32, device=dev)
    inner = torch.empty_like(out) if emit_inner else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.windowed_fwd_v3(
            x_c.data_ptr(), w_s_c.data_ptr(), e_t_c.data_ptr(),
            w_e_c.data_ptr(), recv.data_ptr(), sloc.data_ptr(),
            tile_win.data_ptr(), tile_blocks.data_ptr(), inner_o.data_ptr(),
            offset.data_ptr(), out.data_ptr(),
            None if inner is None else inner.data_ptr(),
            n_x, d, de, h, t, num_nodes, node_block, edge_tile, r_chunk,
            stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    windowed_fwd_cuda.launches += 1
    return (out, inner) if emit_inner else out


windowed_fwd_cuda.launches = 0


def windowed_fwd(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                 tile_blocks, inner_o, offset, *, node_block: int,
                 edge_tile: int, emit_inner: bool = False):
    """The windowed forward kernel's wrapper: a CUDA tensor launches the
    kernel (or raises), a CPU tensor takes the plain version."""
    fn = windowed_fwd_cuda if x_c.is_cuda else windowed_fwd_plain
    return fn(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win, tile_blocks,
              inner_o, offset, node_block=node_block, edge_tile=edge_tile,
              emit_inner=emit_inner)


def windowed_bwd_cuda(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                      tile_blocks, inner_z, g_pass, *, node_block: int,
                      edge_tile: int):
    """Launches the four passes of `csrc/windowed_bwd_v3.cu` on the current
    stream; raises on inputs the kernels do not take. Returns what
    `windowed_bwd_plain` returns. Counts its launches in
    `windowed_bwd_cuda.launches` (one per backward)."""
    kernel = "windowed_bwd_v3"
    h = inner_z.shape[1]
    # any conv width: H zero-padded to a multiple of 8 for the kernels'
    # 16-byte row loads (a padded column's g is 0, so it routes nothing)
    w_s_c, w_e_c, inner_z, g_pass = da.pad_width(w_s_c, w_e_c, inner_z,
                                                 g_pass)
    _check_operands(kernel, x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                    tile_blocks, dict(inner_z=inner_z, g_pass=g_pass),
                    edge_tile=edge_tile)
    dev = x_c.device
    n_x, d = x_c.shape
    e_pad, de = e_t_c.shape
    num_nodes, hw = inner_z.shape
    t = tile_win.shape[0]
    r_chunk = chunk_rows(edge_tile)
    lib = load_bwd_kernel()
    _check(lib.windowed_bwd_v3_smem_bytes(d, de, r_chunk) <= da._MAX_SMEM,
           f"d={d} needs more shared memory than a block has", kernel)
    hp = -(-hw // 64) * 64
    n_part = da.weight_partials(e_pad)
    bf16, f32 = torch.bfloat16, torch.float32
    d_op = torch.empty((e_pad, hp), dtype=bf16, device=dev)
    partial = torch.empty((n_part, d + de, hp), dtype=f32, device=dev)
    d_xg = torch.empty((e_pad, d), dtype=bf16, device=dev)
    d_e = torch.empty((e_pad, de), dtype=bf16, device=dev)
    dw_s = torch.empty((d, hw), dtype=f32, device=dev)
    dw_e = torch.empty((de, hw), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.windowed_bwd_v3(
            x_c.data_ptr(), w_s_c.data_ptr(), e_t_c.data_ptr(),
            w_e_c.data_ptr(), recv.data_ptr(), sloc.data_ptr(),
            tile_win.data_ptr(), tile_blocks.data_ptr(), inner_z.data_ptr(),
            g_pass.data_ptr(), d_op.data_ptr(), partial.data_ptr(),
            d_xg.data_ptr(), d_e.data_ptr(), dw_s.data_ptr(),
            dw_e.data_ptr(), n_x, d, de, hw, t, num_nodes, node_block,
            edge_tile, r_chunk, n_part, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    windowed_bwd_cuda.launches += 1
    return d_xg, d_e, dw_s[:, :h], dw_e[:, :h]


windowed_bwd_cuda.launches = 0


def windowed_bwd(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win,
                 tile_blocks, inner_z, g_pass, *, node_block: int,
                 edge_tile: int):
    """The windowed backward kernels' wrapper: a CUDA tensor launches them
    (or raises), a CPU tensor takes the plain version."""
    fn = windowed_bwd_cuda if x_c.is_cuda else windowed_bwd_plain
    return fn(x_c, w_s_c, e_t_c, w_e_c, recv, sloc, tile_win, tile_blocks,
              inner_z, g_pass, node_block=node_block, edge_tile=edge_tile)


# ---------------------------------------------------------------------------
# autograd Function and entry point
# ---------------------------------------------------------------------------

def _forward(x, w_s, e_t, w_e, offset, e_ovf, layout, ovf_s, ovf_r, geo,
             emit_inner: bool):
    """The forward on gather-dtype operands; returns (the kernel wrapper's
    result, the padded operands the backward reuses)."""
    node_block, edge_tile = geo
    inner_o, padded = da.gather_operands(x, w_s, e_t, w_e, e_ovf, ovf_s,
                                         ovf_r, offset.shape[0])
    res = windowed_fwd(*padded, *layout, inner_o,
                       offset.float().contiguous(), node_block=node_block,
                       edge_tile=edge_tile, emit_inner=emit_inner)
    return res, padded


class WindowedAggregateFn(torch.autograd.Function):
    """The windowed aggregation with its custom VJP (module docstring)."""

    @staticmethod
    def forward(ctx, x, w_s, e_t, w_e, offset, e_ovf, recv, senders_local,
                tile_win, tile_blocks, ovf_s, ovf_r, order, row_ptr, geo):
        layout = (recv, senders_local, tile_win, tile_blocks)
        (out, inner), padded = _forward(x, w_s, e_t, w_e, offset, e_ovf,
                                        layout, ovf_s, ovf_r, geo,
                                        emit_inner=True)
        ctx.geo = geo
        ctx.dtypes = (x.dtype, e_t.dtype, e_ovf.dtype, offset.dtype)
        ctx.save_for_backward(x, w_s, w_e, e_ovf, *padded, *layout, ovf_s,
                              ovf_r, order, row_ptr, inner)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, w_s, w_e, e_ovf, x_p, w_s_p, e_p, w_e_p, recv, sloc, t_win,
         t_blocks, ovf_s, ovf_r, order, row_ptr, inner) = ctx.saved_tensors
        node_block, edge_tile = ctx.geo

        def slot_backward(inner_z, g_pass):
            return windowed_bwd(x_p, w_s_p, e_p, w_e_p, recv, sloc, t_win,
                                t_blocks, inner_z, g_pass,
                                node_block=node_block, edge_tile=edge_tile)

        return da.fused_backward(g, inner, slot_backward, x, w_s, w_e, e_ovf,
                                 ovf_s, ovf_r, order, row_ptr,
                                 ctx.dtypes) + (None,) * 9


def windowed_aggregate(x, w_s, e_t, w_e, offset, e_ovf, recv_t, tile_blocks,
                       tile_win, senders_local, ovf_s, ovf_r, *,
                       node_block: int, edge_tile: int,
                       landing=None) -> torch.Tensor:
    """The windowed fused aggregation (module docstring), with the argument
    order of the JAX package's fused function (less part_mask: the landing
    replaces it). Differentiable in x, w_s, e_t, w_e, offset and e_ovf; the
    backward needs `landing` (an `ops.segment_sum.SenderLanding` over this
    layout, the batch's `FlatTiling.landing`)."""
    layout = tuple(a.contiguous() for a in (recv_t, senders_local, tile_win,
                                            tile_blocks))
    geo = (node_block, edge_tile)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w_s, e_t, w_e, offset, e_ovf))
    if not needs_grad:
        out, _ = _forward(x, w_s, e_t, w_e, offset, e_ovf, layout, ovf_s,
                          ovf_r, geo, emit_inner=False)
        return out
    if landing is None:
        raise ValueError("the windowed aggregation's backward needs the "
                         "batch's sender landing (FlatTiling.landing, built "
                         "by stack_samples)")
    return WindowedAggregateFn.apply(x, w_s, e_t, w_e, offset, e_ovf,
                                     *layout, ovf_s, ovf_r, landing.order,
                                     landing.row_ptr, geo)
