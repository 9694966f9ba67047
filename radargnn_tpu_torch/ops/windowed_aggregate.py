"""Windowed hoisted max aggregation, forward and backward.

Port of `make_fused_hoisted_aggregate_v3` (`radargnn_tpu/ops/pallas_kernels.py`)
on its strict routing and its `bf16_max` routing, with or without
`bf16_landing` (the windowed maxima landed in bf16). Its other variants
compute nothing new here: `stream_m` streams the forward's bf16 operand
into the backward, which routes on the forward's bits here anyway;
`precomp_land` and `precomp_eq` stream the TPU's one-hots. With the tile layout of `ops.windowed_tiles`
(receiver-sorted tiles of `edge_tile` slots, each in one node block, per-tile
sender windows, an overflow list),

    inner[n] = max over the in-window slots and overflow edges with
               receiver n of (x[sender] @ w_s + e @ w_e)
    out[n]   = offset[n] + inner[n] for non-empty n, else 0.

A slot counts where its receiver lies in its tile's node block (the empty
slots carry receiver -1); its sender row is zero where it has none
(senders_local -1), as the TPU kernel's one-hot gather gives.

On the card this is three launches of the port's own, which replace
`_fused_fwd_kernel_v3` and `_fused_bwd_kernel_v3`, in the dense
aggregation's form (`ops.dense_aggregate`, whose pieces it shares); the
TPU kernels' one-hot gathers and per-slot products are not carried over:

  * the node projection `y_s = x @ w_s` once per node, [N, hp] float32
    (`dense_aggregate.dense_proj`, `csrc/dense_fwd_v4.cu`), since
    x[s] @ w_s = y_s[s];
  * the gather-max (`windowed_fwd`, `csrc/windowed_fwd_v3.cu`): op[slot] =
    y_s[sender] + e_t[slot] @ w_e, the max over a receiver's counting
    slots (in every tile of its node block) and its overflow maxima, the
    offset epilogue; with `bf16_landing` the slots' maximum is rounded to
    bf16 (to nearest even) before the overflow maxima, which stay float32,
    are merged (the TPU kernel's bf16 landing, :1363-1372, then :1925-1929;
    rounding is monotone, so rounding the maximum is rounding each run's).
    In VJP mode it also writes `inner` and one routing bit
    per (slot, column), set where the slot counts and |op - inner| <= 1e-5
    |inner| + 1e-5: the strict routing of the TPU kernel, under which every
    tied slot takes the full g (with `bf16_max`, where bf16(op) ==
    bf16(inner), and the overflow rows alike: the TPU kernel's bf16_cmp
    branch);
  * the backward (`windowed_bwd`, `csrc/windowed_bwd_v3.cu`, on the dense
    backward's passes): d_op[slot] = bf16(g[recv[slot]]) where the slot's
    bit is set, else 0; d_e = d_op @ w_e^T and dW_e over the tiles, and the
    H-wide sender sums d_ys (the slots' d_op) and d_yo (the overflow rows)
    in one sender-major pass over the batch's landing order. Fixed
    summation orders, no atomics; d_op is never written to memory.

d_x = (d_ys + d_yo) @ w_s^T and dW_s = x^T @ (d_ys + d_yo) are then
node-wide float32 products: the port's windowed backward always has the
JAX package's `sender_dx` form (its wrapper :1974-1981, whose d_ys stays
float32, and the overflow part at :2002-2004). It agrees with the JAX VJP
with and without `sender_dx` up to summation and rounding order: without
it, the TPU kernel multiplies each slot's d_op by w_s^T and lands the
products at the senders. The routing comes from the forward's bits, so the
backward sees the forward's op bit for bit without recomputing it. The
overflow edges' operand is y_s[ovf_s] + e_ovf @ w_e, scatter-maxed in
torch (XLA in the JAX package). As there, the gather operands are bf16 on
the accelerator and float32 where the JAX package runs its kernels in
interpret mode (the CPU), where every wrapper takes its plain version.
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
    """Slots per row of the backward kernels' walk over a tile (R): 64, or
    the largest of 32 / 16 that divides a smaller tile."""
    return math.gcd(edge_tile, 64)


def slot_counts(recv, tile_blocks, num_nodes: int, node_block: int,
                edge_tile: int) -> torch.Tensor:
    """Whether each slot counts: its receiver lies in its tile's node block
    (the empty slots carry receiver -1). The CSR layout's rule too."""
    base = tile_blocks.long().repeat_interleave(edge_tile) * node_block
    r = recv.long()
    return (r >= base) & (r < base + node_block) & (r < num_nodes)


def windowed_fwd_plain(y_s, e_t_c, w_e_c, recv, sloc, tile_win, tile_blocks,
                       inner_o, offset, *, node_block: int, edge_tile: int,
                       emit_inner: bool = False, bf16_max: bool = False,
                       bf16_landing: bool = False):
    """Plain torch version of the gather-max kernel: the same function on
    the same inputs (y_s [N, hp] float32; e_t_c, w_e_c in the gather dtype;
    inner_o, offset float32 [num_nodes, H]). Returns out, or (out, inner,
    bits) with `emit_inner`: bits [E_pad, hp / 32] int32, one per (slot,
    column), set where the slot counts and its op routes (`_routes`, bf16
    with `bf16_max`). `bf16_landing` rounds the slots' maxima to bf16
    before the overflow maxima are merged."""
    num_nodes, h = offset.shape
    win = tile_win.long().repeat_interleave(edge_tile) * node_block
    sender = win + sloc.long().clamp(min=0)
    has_sender = (sloc >= 0) & (sender < y_s.shape[0])
    y = y_s[torch.where(has_sender, sender, 0), :h]
    op = torch.where(has_sender[:, None], y, 0.0) \
        + matmul_f32(e_t_c, w_e_c, e_t_c.dtype)
    valid = slot_counts(recv, tile_blocks, num_nodes, node_block, edge_tile)
    rc = torch.where(valid, recv.long(), 0)
    acc = torch.full((num_nodes, h), _NEG, dtype=torch.float32,
                     device=op.device)
    acc = acc.scatter_reduce_(0, rc[:, None].expand_as(op),
                              torch.where(valid[:, None], op, _NEG), "amax")
    if bf16_landing:
        acc = land_bf16(acc)
    inner = torch.maximum(acc, inner_o)
    out = torch.where(inner > _NEG / 2, offset + inner, 0.0)
    if not emit_inner:
        return out
    sel = valid[:, None] & _routes(op, inner[rc], bf16_max)
    return out, inner, da.pack_bits(sel)


def land_bf16(acc: torch.Tensor) -> torch.Tensor:
    """The bf16 landing of the slots' maxima: each rounded to bf16 (to
    nearest even) where a slot landed, _NEG where none did."""
    return torch.where(acc > _NEG / 2, acc.to(torch.bfloat16).float(), acc)


def windowed_bwd_plain(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order,
                       row_ptr, *, edge_tile: int):
    """Plain torch version of the windowed backward kernels on the same
    inputs (bits from the forward; g_pass float32 [num_nodes, H], 0 at
    empty receivers; e_t_c, w_e_c in the gather dtype; d_op_o [Eo, H]
    float32, the overflow rows): `dense_aggregate.routed_bwd_plain` with
    the receivers listed beside the slots. Returns (d_e [E_pad, de] in the
    gather dtype, dW_e [de, H], d_ys and d_yo [num_nodes, H] float32)."""
    del edge_tile          # the kernels' walk; the function does not use it
    return da.routed_bwd_plain(bits, g_pass, e_t_c, w_e_c, d_op_o,
                               recv.long().clamp(min=0), order, row_ptr)


# ---------------------------------------------------------------------------
# the CUDA kernels: build at first use, bind through ctypes
# ---------------------------------------------------------------------------

def _bind_fwd(lib: ctypes.CDLL) -> None:
    lib.windowed_fwd_v3.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 10 + [ctypes.c_void_p])
    lib.windowed_fwd_v3.restype = ctypes.c_int
    lib.windowed_fwd_v3_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.windowed_fwd_v3_smem_bytes.restype = ctypes.c_size_t


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.windowed_bwd_v3.argtypes = (
        da.ROUTED_BWD_ARGTYPES + [ctypes.c_void_p, ctypes.c_int,
                                  ctypes.c_void_p])
    lib.windowed_bwd_v3.restype = ctypes.c_int


def load_fwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/windowed_fwd_v3.cu` once."""
    return load_library("windowed_fwd_v3.cu", _bind_fwd)


def load_bwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/windowed_bwd_v3.cu` once."""
    return load_library("windowed_bwd_v3.cu", _bind_bwd)


def _check_layout(kernel: str, e_pad: int, recv, sloc, tile_win,
                  tile_blocks, edge_tile: int) -> None:
    """The tile layout's shapes: T tiles of edge_tile slots (a multiple of
    16), each slot with its receiver and, where given, its sender."""
    t = tile_win.shape[0] if tile_win is not None else e_pad // edge_tile
    _check(edge_tile % 16 == 0,
           f"edge_tile must be a multiple of 16 (got {edge_tile})", kernel)
    _check(e_pad == t * edge_tile and recv.shape == (e_pad,)
           and (sloc is None or sloc.shape == (e_pad,))
           and (tile_blocks is None or tile_blocks.shape == (t,)),
           f"{e_pad} slots do not match {t} tiles x {edge_tile}", kernel)


def windowed_fwd_cuda(y_s, e_t_c, w_e_c, recv, sloc, tile_win, tile_blocks,
                      inner_o, offset, *, node_block: int, edge_tile: int,
                      emit_inner: bool = False, bf16_max: bool = False,
                      bf16_landing: bool = False):
    """Launches the gather-max of `csrc/windowed_fwd_v3.cu` on the current
    stream (VJP mode with `emit_inner`: it also writes `inner` and the
    routing bits, by the bf16 test with `bf16_max`; `bf16_landing` lands
    the slots' maxima in bf16); raises on inputs the kernel does not take.
    Counts its launches in `windowed_fwd_cuda.launches`, those with
    `bf16_max` in `windowed_fwd_cuda.bf16_launches` too and those with
    `bf16_landing` in `windowed_fwd_cuda.landing_launches`."""
    kernel = "windowed_fwd_v3"
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    da._check_tensors(kernel, dict(y_s=f32, e_t=bf16, w_e=bf16, recv=i32,
                                   senders_local=i32, tile_win=i32,
                                   tile_blocks=i32, inner_o=f32, offset=f32),
                      y_s=y_s, e_t=e_t_c, w_e=w_e_c, recv=recv,
                      senders_local=sloc, tile_win=tile_win,
                      tile_blocks=tile_blocks, inner_o=inner_o,
                      offset=offset)
    e_pad, de = e_t_c.shape
    num_nodes, h = offset.shape
    hp = da.col_pad(h)
    _check_layout(kernel, e_pad, recv, sloc, tile_win, tile_blocks,
                  edge_tile)
    _check(inner_o.shape == offset.shape and w_e_c.shape == (de, h)
           and y_s.shape[1] == hp and de % 8 == 0,
           f"y_s {tuple(y_s.shape)}, w_e {tuple(w_e_c.shape)}, inner_o "
           f"{tuple(inner_o.shape)} do not match H={h}, de={de} (a multiple "
           "of 8)", kernel)
    da._check_aligned(kernel, y_s=y_s, e_t=e_t_c)
    lib = load_fwd_kernel()
    _check(lib.windowed_fwd_v3_smem_bytes(de, node_block) <= da._MAX_SMEM,
           f"de={de}, node_block={node_block} need more shared memory than "
           "a block has", kernel)
    dev = y_s.device
    out = torch.empty((num_nodes, h), dtype=f32, device=dev)
    inner = bits = None
    if emit_inner:
        inner = torch.empty_like(out)
        # the kernel writes the words of the slots that count
        bits = torch.zeros((e_pad, hp // 32), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        err = lib.windowed_fwd_v3(
            y_s.data_ptr(), e_t_c.data_ptr(), w_e_c.data_ptr(),
            recv.data_ptr(), sloc.data_ptr(), tile_win.data_ptr(),
            tile_blocks.data_ptr(), inner_o.data_ptr(), offset.data_ptr(),
            out.data_ptr(), None if inner is None else inner.data_ptr(),
            None if bits is None else bits.data_ptr(), y_s.shape[0], de, h,
            hp, tile_win.shape[0], num_nodes, node_block, edge_tile,
            int(bf16_max), int(bf16_landing), da._stream(dev))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    windowed_fwd_cuda.launches += 1
    windowed_fwd_cuda.bf16_launches += int(bf16_max)
    windowed_fwd_cuda.landing_launches += int(bf16_landing)
    return (out, inner, bits) if emit_inner else out


windowed_fwd_cuda.launches = 0
windowed_fwd_cuda.bf16_launches = 0
windowed_fwd_cuda.landing_launches = 0


def windowed_fwd(y_s, e_t_c, w_e_c, recv, sloc, tile_win, tile_blocks,
                 inner_o, offset, *, node_block: int, edge_tile: int,
                 emit_inner: bool = False, bf16_max: bool = False,
                 bf16_landing: bool = False):
    """The gather-max kernel's wrapper: a CUDA tensor launches the kernel
    (or raises), a CPU tensor takes the plain version."""
    fn = windowed_fwd_cuda if y_s.is_cuda else windowed_fwd_plain
    return fn(y_s, e_t_c, w_e_c, recv, sloc, tile_win, tile_blocks, inner_o,
              offset, node_block=node_block, edge_tile=edge_tile,
              emit_inner=emit_inner, bf16_max=bf16_max,
              bf16_landing=bf16_landing)


def windowed_bwd_cuda(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order,
                      row_ptr, *, edge_tile: int):
    """Launches the four passes of `csrc/windowed_bwd_v3.cu` on the current
    stream; raises on inputs the kernels do not take. Returns what
    `windowed_bwd_plain` returns. Counts its launches in
    `windowed_bwd_cuda.launches` (one per backward)."""
    kernel = "windowed_bwd_v3"
    da._check_tensors(kernel, dict(bits=torch.int32, recv=torch.int32),
                      bits=bits, recv=recv)
    _check_layout(kernel, e_t_c.shape[0], recv, None, None, None, edge_tile)
    r = chunk_rows(edge_tile)
    res = da.routed_bwd_launch(
        kernel, load_bwd_kernel, bits, g_pass, e_t_c, w_e_c, d_op_o, order,
        row_ptr, r_tile=r, k=edge_tile // r, extra=(recv.data_ptr(),
                                                    g_pass.shape[0]))
    windowed_bwd_cuda.launches += 1
    return res


windowed_bwd_cuda.launches = 0


def windowed_bwd(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order, row_ptr,
                 *, edge_tile: int):
    """The windowed backward kernels' wrapper: a CUDA tensor launches them
    (or raises), a CPU tensor takes the plain version."""
    fn = windowed_bwd_cuda if bits.is_cuda else windowed_bwd_plain
    return fn(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order, row_ptr,
              edge_tile=edge_tile)


# ---------------------------------------------------------------------------
# autograd Function and entry point
# ---------------------------------------------------------------------------

def _forward(x, w_s, e_t, w_e, offset, e_ovf, layout, ovf_s, ovf_r, geo,
             emit_inner: bool):
    """The forward on gather-dtype operands: the projection, the overflow
    operands and maxima, the gather-max. Returns (the gather-max wrapper's
    result, the overflow operands, the depth-padded (e_t, w_e))."""
    node_block, edge_tile, bf16_max, bf16_landing = geo
    y_s, op_o, inner_o, e_p, w_e_p = da.project_operands(
        x, w_s, e_t, w_e, e_ovf, ovf_s, ovf_r, offset.shape[0])
    res = windowed_fwd(y_s, e_p, w_e_p, *layout, inner_o,
                       offset.float().contiguous(), node_block=node_block,
                       edge_tile=edge_tile, emit_inner=emit_inner,
                       bf16_max=bf16_max, bf16_landing=bf16_landing)
    return res, op_o, (e_p, w_e_p)


class WindowedAggregateFn(torch.autograd.Function):
    """The windowed aggregation with its custom VJP (module docstring)."""

    @staticmethod
    def forward(ctx, x, w_s, e_t, w_e, offset, e_ovf, recv, senders_local,
                tile_win, tile_blocks, ovf_s, ovf_r, order, row_ptr, geo):
        layout = (recv, senders_local, tile_win, tile_blocks)
        (out, inner, bits), op_o, padded = _forward(
            x, w_s, e_t, w_e, offset, e_ovf, layout, ovf_s, ovf_r, geo,
            emit_inner=True)
        ctx.edge_tile, ctx.bf16_max = geo[1:3]
        ctx.dtypes = (x.dtype, e_t.dtype, e_ovf.dtype, offset.dtype)
        ctx.save_for_backward(x, w_s, w_e, e_ovf, *padded, bits, op_o, recv,
                              ovf_r, order, row_ptr, inner)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, w_s, w_e, e_ovf, e_p, w_e_p, bits, op_o, recv, ovf_r, order,
         row_ptr, inner) = ctx.saved_tensors

        def slot_backward(g_pass, d_op_o):
            return windowed_bwd(bits, g_pass, e_p, w_e_p, d_op_o, recv,
                                order, row_ptr, edge_tile=ctx.edge_tile)

        return da.routed_backward(g, inner, op_o, ovf_r, x, w_s, w_e, e_ovf,
                                  ctx.dtypes, slot_backward,
                                  round_sums=False,
                                  bf16_max=ctx.bf16_max) + (None,) * 9


def windowed_aggregate(x, w_s, e_t, w_e, offset, e_ovf, recv_t, tile_blocks,
                       tile_win, senders_local, ovf_s, ovf_r, *,
                       node_block: int, edge_tile: int, landing=None,
                       bf16_max: bool = False,
                       bf16_landing: bool = False) -> torch.Tensor:
    """The windowed fused aggregation (module docstring), with the argument
    order of the JAX package's fused function (less part_mask: the landing
    replaces it). Differentiable in x, w_s, e_t, w_e, offset and e_ovf; the
    backward needs `landing` (an `ops.segment_sum.SenderLanding` over this
    layout, the batch's `FlatTiling.landing`). `bf16_max` routes the
    backward by bf16 equality (the forward is unchanged); `bf16_landing`
    lands the forward's windowed maxima in bf16 (the JAX package allows it
    only with `bf16_max`, and so does the layer that calls this)."""
    layout = tuple(a.contiguous() for a in (recv_t, senders_local, tile_win,
                                            tile_blocks))
    geo = (node_block, edge_tile, bool(bf16_max), bool(bf16_landing))
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w_s, e_t, w_e, offset, e_ovf))
    if not needs_grad:
        out, _, _ = _forward(x, w_s, e_t, w_e, offset, e_ovf, layout, ovf_s,
                             ovf_r, geo, emit_inner=False)
        return out
    if landing is None:
        raise ValueError("the windowed aggregation's backward needs the "
                         "batch's sender landing (FlatTiling.landing, built "
                         "by stack_samples)")
    return WindowedAggregateFn.apply(x, w_s, e_t, w_e, offset, e_ovf,
                                     *layout, ovf_s, ovf_r, landing.order,
                                     landing.row_ptr, geo)
