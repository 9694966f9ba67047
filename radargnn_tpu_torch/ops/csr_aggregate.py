"""CSR-tiled hoisted max aggregation (v2), forward and backward.

Port of `make_fused_hoisted_aggregate_v2` (`radargnn_tpu/ops/pallas_kernels.py`),
the path of `fused_tiling: "csr"`. With the receiver-CSR tiles of
`ops.windowed_tiles.prepare_csr_tiles` (every valid edge in a tile of
`edge_tile` slots, the tiles of a node block consecutive, each slot with
its global sender and receiver, -1 for an empty slot),

    inner[n] = max over the slots with receiver n of
               (x[senders_t] @ w_s + e_t @ w_e)
    out[n]   = offset[n] + inner[n] for non-empty n, else 0.

A slot counts where its receiver lies in its tile's node block. There is
no overflow list and no sender window: senders are global and unordered.

v2's contract differs from the dense and windowed kernels in its types:
on the accelerator only x and w_s go to bf16; the edge features and w_e
stay float32, and so do the edge-side gradients d_e and dW_e. The backward
keeps two forms of d_op: the float32 one drives d_e and dW_e, the
bf16-rounded one d_xg (bf16) and dW_s. Where the JAX package runs its
kernels in interpret mode (the CPU) everything is float32.

On the card the forward is two launches: the node projection y_s = x @ w_s
once per node (`dense_aggregate.dense_proj`, `csrc/dense_fwd_v4.cu`), since
x[s] @ w_s = y_s[s], then the gather-max of `csrc/csr_fwd_v2.cu` (replaces
`_fused_fwd_kernel_v2`) over op = y_s[sender] + e_t @ w_e, the edge side
in float32; the backward runs `csrc/csr_bwd_v2.cu` (replaces
`_fused_bwd_kernel_v2`). The gradient is `CsrAggregateFn`, the custom VJP
of the JAX package: the forward runs in VJP mode and saves `inner` and
y_s; the backward routes g to every valid slot whose recomputed operand
lies within 1e-5 |inner| + 1e-5 of its receiver's max (a tied slot takes
the full g), and lands d_x by sender in one deterministic pass of
`ops.segment_sum` over the batch's landing, which `graph/batch.py` builds
from the sender-sorted second tiling (`ssum_*`), as
`pallas_segment_sum_csr` lands it on the TPU. The backward rebuilds the
operand from the forward's y_s by the forward's fma chain, so it sees the
forward's operand bit for bit. `csr_fwd_plain` and
`csr_bwd_projected_plain` are that projected form in plain torch;
`csr_bwd_plain` keeps the TPU kernel's per-slot form, x[sender] @ w_s for
every slot.
"""

from __future__ import annotations

import ctypes

import torch

from radargnn_tpu_torch.build import load_library
from radargnn_tpu_torch.models.mlp import matmul_f32
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum
from radargnn_tpu_torch.ops.dense_aggregate import _NEG, _check, _routes
from radargnn_tpu_torch.ops.windowed_aggregate import slot_counts


def _slot_operands(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks,
                   num_nodes: int, node_block: int, edge_tile: int):
    """The gathered sender rows x_g [E_pad, d] (zero where a slot does not
    count), every slot's operand op [E_pad, H] float32 (the x part in the
    gather dtype, the edge part in float32), its receiver (0 where it does
    not count) and whether it counts."""
    valid = slot_counts(recv, tile_blocks, num_nodes, node_block, edge_tile)
    x_g = torch.where(valid[:, None], x_c[senders.long()], 0)
    op = matmul_f32(x_g, w_s_c, x_c.dtype) \
        + matmul_f32(e_c, w_e_c, torch.float32)
    return x_g, op, torch.where(valid, recv.long(), 0), valid


def csr_fwd_plain(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks,
                  offset, *, node_block: int, edge_tile: int,
                  emit_inner: bool = False, y_s=None):
    """Plain torch version of the CSR forward kernels (the projection and
    the gather-max): the same function on the same inputs (x_c, w_s_c in
    the gather dtype; e_c, w_e_c, offset float32), on the operand of
    `projected_operands` (`y_s`, where given, is
    `dense_aggregate.dense_proj(x_c, w_s_c)`). Returns out, or (out, inner)
    with `emit_inner`."""
    num_nodes, h = offset.shape
    _, op, rc, valid = projected_operands(x_c, w_s_c, e_c, w_e_c, senders,
                                          recv, tile_blocks, num_nodes,
                                          node_block, edge_tile, y_s)
    op = torch.where(valid[:, None], op, _NEG)
    inner = torch.full((num_nodes, h), _NEG, dtype=torch.float32,
                       device=op.device)
    inner = inner.scatter_reduce_(0, rc[:, None].expand_as(op), op, "amax")
    out = torch.where(inner > _NEG / 2, offset + inner, 0.0)
    return (out, inner) if emit_inner else out


def projected_operands(x_c, w_s_c, e_c, w_e_c, senders, recv,
                       tile_blocks, num_nodes: int, node_block: int,
                       edge_tile: int, y_s=None):
    """What `_slot_operands` returns, with op formed as the kernels form
    it: the node projection y_s = x @ w_s once per node
    (`dense_aggregate.dense_proj_plain`, or `y_s` where given), then
    y_s[sender] + e_t @ w_e (the edge part in float32; the x part 0 where
    the sender is not a row of x)."""
    valid = slot_counts(recv, tile_blocks, num_nodes, node_block, edge_tile)
    h = w_s_c.shape[1]
    snd = senders.long()
    if y_s is None:
        y_s = da.dense_proj_plain(x_c, w_s_c)
    has = valid & (snd >= 0) & (snd < x_c.shape[0])
    snd = torch.where(has, snd, 0)
    x_g = torch.where(has[:, None], x_c[snd], 0)
    op = torch.where(has[:, None], y_s[snd, :h], 0.0) \
        + matmul_f32(e_c, w_e_c, torch.float32)
    return x_g, op, torch.where(valid, recv.long(), 0), valid


def routed_d_op(operands, inner_z, g_pass) -> torch.Tensor:
    """d_op [E_pad, H] float32 from (x_g, op, receiver, valid): the
    receiver's g where the slot counts and its op routes against the
    receiver's max (`_routes`; a tied slot takes the full g), else 0."""
    _, op, rc, valid = operands
    return torch.where(valid[:, None] & _routes(op, inner_z[rc]),
                       g_pass[rc], 0.0)


def _bwd_from_operands(operands, x_c, w_s_c, e_c, w_e_c, inner_z, g_pass):
    """The CSR backward's products from (x_g, op, receiver, valid)."""
    cd = x_c.dtype
    x_g = operands[0]
    d_op = routed_d_op(operands, inner_z, g_pass)
    d_op_c = d_op.to(cd)
    f32 = torch.float32
    return (matmul_f32(d_op_c, w_s_c.t(), cd).to(cd),
            matmul_f32(d_op, w_e_c.t(), f32),
            matmul_f32(x_g.t(), d_op_c, cd), matmul_f32(e_c.t(), d_op, f32))


def csr_bwd_plain(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks,
                  inner_z, g_pass, *, node_block: int, edge_tile: int):
    """Plain torch version of the CSR backward kernels on the same inputs
    (inner_z, g_pass float32 [num_nodes, H] with 0 at empty receivers).
    Returns (d_xg [E_pad, d] in the gather dtype, d_e [E_pad, de] float32,
    dW_s [d, H] and dW_e [de, H] float32): d_xg and dW_s from d_op rounded
    to the gather dtype, d_e and dW_e from the float32 d_op, as the TPU
    kernel computes them. dW_s sums over the slots here, where the kernels
    sum over the batch's sender landing."""
    return _bwd_from_operands(
        _slot_operands(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks,
                       inner_z.shape[0], node_block, edge_tile),
        x_c, w_s_c, e_c, w_e_c, inner_z, g_pass)


def csr_bwd_projected_plain(x_c, w_s_c, e_c, w_e_c, senders, recv,
                            tile_blocks, inner_z, g_pass, *,
                            node_block: int, edge_tile: int, y_s=None):
    """`csr_bwd_plain` on the operand the backward kernel rebuilds from the
    node projection (`projected_operands`; `y_s` the forward's, where
    given): the kernel's steps in plain torch, the same function."""
    return _bwd_from_operands(
        projected_operands(x_c, w_s_c, e_c, w_e_c, senders, recv,
                           tile_blocks, inner_z.shape[0], node_block,
                           edge_tile, y_s),
        x_c, w_s_c, e_c, w_e_c, inner_z, g_pass)


# ---------------------------------------------------------------------------
# the CUDA kernels: build at first use, bind through ctypes
# ---------------------------------------------------------------------------

# fixed node chunks the CSR backward's dW_s sums over on the card (each
# gives one partial; the partials are then summed in order)
DWS_PARTIALS = 32


def _bind_fwd(lib: ctypes.CDLL) -> None:
    lib.csr_fwd_v2.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.csr_fwd_v2.restype = ctypes.c_int
    lib.csr_fwd_v2_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.csr_fwd_v2_smem_bytes.restype = ctypes.c_size_t


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.csr_bwd_v2.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.csr_bwd_v2.restype = ctypes.c_int
    lib.csr_bwd_v2_smem_bytes.argtypes = [ctypes.c_int] * 2
    lib.csr_bwd_v2_smem_bytes.restype = ctypes.c_size_t
    lib.csr_bwd_v2_we_part_floats.argtypes = [ctypes.c_int] * 3
    lib.csr_bwd_v2_we_part_floats.restype = ctypes.c_size_t
    lib.csr_bwd_v2_dws.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                                   + [ctypes.c_void_p])
    lib.csr_bwd_v2_dws.restype = ctypes.c_int


def fwd_smem_bytes(de: int, node_block: int) -> int:
    """Shared memory of the gather-max kernel, in bytes: the [node_block x
    64] accumulator of ordered keys (row stride 65, padded to 16 bytes) and
    the float32 W_e slice [de x 68]; `csr_fwd_v2_smem_bytes` of the
    source."""
    return (4 * node_block * 65 + 15) // 16 * 16 + 4 * de * 68


def load_fwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/csr_fwd_v2.cu` once."""
    return load_library("csr_fwd_v2.cu", _bind_fwd)


def load_bwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/csr_bwd_v2.cu` once."""
    return load_library("csr_bwd_v2.cu", _bind_bwd)


def _check_operands(kernel: str, x_c, w_s_c, e_c, w_e_c, senders, recv,
                    tile_blocks, node_tensors: dict, *,
                    edge_tile: int) -> None:
    """The checks both CSR kernels share: `check_slot_operands` with
    float32 edge operands, then the tile layout's shapes; `node_tensors`
    are the float32 [num_nodes, H] inputs."""
    da.check_slot_operands(kernel, x_c, w_s_c, e_c, w_e_c,
                           dict(senders=senders, recv=recv,
                                tile_blocks=tile_blocks),
                           node_tensors, edge_dtype=torch.float32)
    h = w_s_c.shape[1]
    e_pad = e_c.shape[0]
    t = tile_blocks.shape[0]
    _check(e_pad == t * edge_tile and senders.shape == (e_pad,)
           and recv.shape == (e_pad,),
           f"{e_pad} slots do not match {t} tiles x {edge_tile}", kernel)
    shapes = {tuple(ten.shape) for ten in node_tensors.values()}
    _check(len(shapes) == 1 and next(iter(shapes))[1:] == (h,),
           f"{', '.join(node_tensors)} must be one [num_nodes, {h}] shape",
           kernel)
    _check(edge_tile % 16 == 0,
           f"edge_tile must be a multiple of 16 (got {edge_tile})", kernel)


def _check_projection(kernel: str, y_s, x_c, hp: int) -> None:
    """A given y_s is x @ w_s as `dense_aggregate.dense_proj` returns it:
    float32 [n_x, hp] on x's device, contiguous and 16-byte aligned."""
    da._check_tensors(kernel, dict(y_s=torch.float32), y_s=y_s)
    _check(y_s.shape == (x_c.shape[0], hp) and y_s.device == x_c.device,
           f"y_s {tuple(y_s.shape)} is not x @ w_s [{x_c.shape[0]}, {hp}] "
           f"on {x_c.device}", kernel)
    da._check_aligned(kernel, y_s=y_s)


def csr_fwd_cuda(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks,
                 offset, *, node_block: int, edge_tile: int,
                 emit_inner: bool = False, y_s=None):
    """Launches the CSR forward on the current stream: the node projection
    (`dense_proj_v4`, unless `y_s` is given: `dense_aggregate.dense_proj(
    x_c, w_s_c)`, as `CsrAggregateFn` keeps it for the backward), then the
    gather-max of `csrc/csr_fwd_v2.cu` (VJP mode with `emit_inner`: it also
    writes `inner`); raises on inputs the kernels do not take, before any
    launch. Counts the gather-max's launches in `csr_fwd_cuda.launches`
    (the projection counts in its own)."""
    kernel = "csr_fwd_v2"
    de = e_c.shape[1]
    # the accumulator holds the whole node block (RADARGNN_FUSED_NODE_BLOCK)
    _check(fwd_smem_bytes(de, node_block) <= da._MAX_SMEM,
           f"de={de}, node_block={node_block} need more shared memory than "
           "a block has", kernel)
    _check_operands(kernel, x_c, w_s_c, e_c, w_e_c, senders, recv,
                    tile_blocks, dict(offset=offset), edge_tile=edge_tile)
    n_x = x_c.shape[0]
    num_nodes, h = offset.shape
    hp = da.col_pad(h)
    if y_s is not None:
        _check_projection(kernel, y_s, x_c, hp)
    lib = load_fwd_kernel()
    if y_s is None:
        y_s = da.dense_proj(x_c, w_s_c)
    out = torch.empty((num_nodes, h), dtype=torch.float32, device=y_s.device)
    inner = torch.empty_like(out) if emit_inner else None
    with torch.cuda.device(y_s.device):
        err = lib.csr_fwd_v2(
            y_s.data_ptr(), e_c.data_ptr(), w_e_c.data_ptr(),
            senders.data_ptr(), recv.data_ptr(), tile_blocks.data_ptr(),
            offset.data_ptr(), out.data_ptr(),
            None if inner is None else inner.data_ptr(), n_x, de, h, hp,
            tile_blocks.shape[0], num_nodes, node_block, edge_tile,
            da._stream(y_s.device))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    csr_fwd_cuda.launches += 1
    return (out, inner) if emit_inner else out


csr_fwd_cuda.launches = 0


def csr_fwd(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks, offset, *,
            node_block: int, edge_tile: int, emit_inner: bool = False,
            y_s=None):
    """The CSR forward kernels' wrapper: a CUDA tensor launches them (or
    raises), a CPU tensor takes the plain version."""
    fn = csr_fwd_cuda if x_c.is_cuda else csr_fwd_plain
    return fn(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks, offset,
              node_block=node_block, edge_tile=edge_tile,
              emit_inner=emit_inner, y_s=y_s)


def csr_bwd_cuda(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks,
                 inner_z, g_pass, *, node_block: int, edge_tile: int,
                 landing=None, y_s=None):
    """Launches the CSR backward on the current stream: the node
    projection (`dense_proj_v4`, `csrc/dense_fwd_v4.cu`; none where `y_s`,
    the forward's, is given: the same kernel on the same inputs gives the
    same bits), the routing pass, slot products and dW_e reduce of
    `csrc/csr_bwd_v2.cu`, the sender sums of bf16(d_op) over `landing` (the
    batch's `SenderLanding`, by the B3 kernel `csrc/segment_sum_csr.cu`)
    and dW_s from them (`csr_bwd_v2`'s dW_s passes); raises on inputs the
    kernels do not take. Returns what `csr_bwd_plain` returns. Scratch: y_s
    [N, hp] (where not given) and the sender sums [N, hp] float32, d_op
    [E_pad, hp] bf16, the routing blocks' dW_e partials and the dW_s
    partials [n_part, d, hp] float32, hp = H rounded up to 64. Counts its
    launches in `csr_bwd_cuda.launches` (one per backward; the projection
    and the sender sums count in their own kernels' counters)."""
    return _csr_bwd_launch(x_c, w_s_c, e_c, w_e_c, senders, recv,
                           tile_blocks, inner_z, g_pass, node_block,
                           edge_tile, landing, y_s)[:4]


def _csr_bwd_launch(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks,
                    inner_z, g_pass, node_block, edge_tile, landing,
                    y_s=None):
    """`csr_bwd_cuda`'s launches; returns its outputs and the routed
    bf16(d_op) [E_pad, H] (nonzero where a slot took its receiver's g)."""
    kernel = "csr_bwd_v2"
    h = inner_z.shape[1]
    # any conv width: H zero-padded to a multiple of 8 for the kernels'
    # 16-byte row loads (a padded column's g is 0, so it routes nothing)
    w_s_c, w_e_c, inner_z, g_pass = da.pad_width(w_s_c, w_e_c, inner_z,
                                                 g_pass)
    _check_operands(kernel, x_c, w_s_c, e_c, w_e_c, senders, recv,
                    tile_blocks, dict(inner_z=inner_z, g_pass=g_pass),
                    edge_tile=edge_tile)
    da._check_aligned(kernel, inner_z=inner_z, g_pass=g_pass)
    _check(landing is not None and landing.row_ptr.numel() - 1
           == x_c.shape[0],
           "needs the batch's sender landing over x's nodes (the sender "
           "sums that make dW_s)", kernel)
    dev = x_c.device
    n_x, d = x_c.shape
    e_pad, de = e_c.shape
    num_nodes, hw = inner_z.shape
    lib = load_bwd_kernel()
    _check(lib.csr_bwd_v2_smem_bytes(de, hw) <= da._MAX_SMEM,
           f"de={de}, H={hw} need more shared memory than a block has",
           kernel)
    hp = da.col_pad(hw)
    if y_s is None:
        y_s = da.dense_proj(x_c, w_s_c)
    else:
        _check_projection(kernel, y_s, x_c, hp)
    bf16, f32 = torch.bfloat16, torch.float32
    d_op = torch.empty((e_pad, hp), dtype=bf16, device=dev)
    we_part = torch.empty((lib.csr_bwd_v2_we_part_floats(e_pad, de, hp),),
                          dtype=f32, device=dev)
    d_xg = torch.empty((e_pad, d), dtype=bf16, device=dev)
    d_e = torch.empty((e_pad, de), dtype=f32, device=dev)
    dw_e = torch.empty((de, hw), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.csr_bwd_v2(
            y_s.data_ptr(), w_s_c.data_ptr(), e_c.data_ptr(),
            w_e_c.data_ptr(), senders.data_ptr(), recv.data_ptr(),
            tile_blocks.data_ptr(), inner_z.data_ptr(), g_pass.data_ptr(),
            d_op.data_ptr(), we_part.data_ptr(), d_xg.data_ptr(),
            d_e.data_ptr(), dw_e.data_ptr(), n_x, d, de, hw, num_nodes,
            node_block, edge_tile, e_pad, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    # the H columns of d_op (zero past them); the sums' columns past H are
    # written 0
    sums = segment_sum.segment_sum_csr(d_op, landing.order, landing.row_ptr,
                                       width=hw)
    n_part = DWS_PARTIALS
    partial = torch.empty((n_part, d, hp), dtype=f32, device=dev)
    dw_s = torch.empty((d, hw), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        err = lib.csr_bwd_v2_dws(x_c.data_ptr(), sums.data_ptr(),
                                 partial.data_ptr(), dw_s.data_ptr(), n_x, d,
                                 hw, n_part,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} dW_s launch failed: cudaError {err}")
    csr_bwd_cuda.launches += 1
    return d_xg, d_e, dw_s[:, :h], dw_e[:, :h], d_op[:, :h]


csr_bwd_cuda.launches = 0


def csr_bwd(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks, inner_z,
            g_pass, *, node_block: int, edge_tile: int, landing=None,
            y_s=None):
    """The CSR backward kernels' wrapper: a CUDA tensor launches them (or
    raises; they need the batch's sender `landing`, and take the forward's
    `y_s` where given), a CPU tensor takes the plain version (the TPU
    kernel's per-slot form, which needs neither)."""
    args = (x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks, inner_z,
            g_pass)
    if x_c.is_cuda:
        return csr_bwd_cuda(*args, node_block=node_block,
                            edge_tile=edge_tile, landing=landing, y_s=y_s)
    return csr_bwd_plain(*args, node_block=node_block, edge_tile=edge_tile)


# ---------------------------------------------------------------------------
# autograd Function and entry point
# ---------------------------------------------------------------------------

def csr_operands(x, w_s, e_t, w_e):
    """The kernels' operands, depth-padded contiguous copies (zeros add
    nothing to a product): x and w_s in the gather dtype, e_t and w_e in
    float32, as `_prep` of the JAX package casts them."""
    cd = da.gather_dtype(x.device)
    x_p, w_s_p = da._pad_depth(x.to(cd), w_s.to(cd))
    e_p, w_e_p = da._pad_depth(e_t.float(), w_e.float())
    return x_p, w_s_p, e_p, w_e_p


class CsrAggregateFn(torch.autograd.Function):
    """The CSR aggregation with its custom VJP (module docstring)."""

    @staticmethod
    def forward(ctx, x, w_s, e_t, w_e, offset, senders, recv, tile_blocks,
                order, row_ptr, geo):
        node_block, edge_tile = geo
        padded = csr_operands(x, w_s, e_t, w_e)
        layout = (senders, recv, tile_blocks)
        # the node projection, gathered by the forward and rebuilt from by
        # the backward
        y_s = da.dense_proj(*padded[:2])
        out, inner = csr_fwd(*padded, *layout, offset.float().contiguous(),
                             node_block=node_block, edge_tile=edge_tile,
                             emit_inner=True, y_s=y_s)
        ctx.geo = geo
        ctx.dtypes = (x.dtype, w_s.dtype, e_t.dtype, w_e.dtype, offset.dtype)
        ctx.widths = (x.shape[1], e_t.shape[1])
        ctx.save_for_backward(*padded, *layout, order, row_ptr, inner, y_s)
        return out

    @staticmethod
    def backward(ctx, g):
        (x_p, w_s_p, e_p, w_e_p, senders, recv, blocks, order, row_ptr,
         inner, y_s) = ctx.saved_tensors
        node_block, edge_tile = ctx.geo
        x_dtype, w_s_dtype, e_dtype, w_e_dtype, offset_dtype = ctx.dtypes
        d, de = ctx.widths
        has = inner > _NEG / 2
        g_pass = torch.where(has, g.float(), 0.0)
        inner_z = torch.where(has, inner, 0.0)
        landing = segment_sum.SenderLanding(order, row_ptr)
        d_xg, d_e, d_ws, d_we = csr_bwd(
            x_p, w_s_p, e_p, w_e_p, senders, recv, blocks, inner_z, g_pass,
            node_block=node_block, edge_tile=edge_tile, landing=landing,
            y_s=y_s)
        d_x = segment_sum.segment_sum_csr(d_xg, *landing)[:, :d]
        return (d_x.to(x_dtype), d_ws[:d].to(w_s_dtype),
                d_e[:, :de].to(e_dtype), d_we[:de].to(w_e_dtype),
                g_pass.to(offset_dtype)) + (None,) * 6


def csr_aggregate(x, w_s, e_t, w_e, senders_t, padded_recv, tile_blocks,
                  offset, *, node_block: int, edge_tile: int,
                  landing=None) -> torch.Tensor:
    """The CSR fused aggregation (module docstring), with the argument order
    of the JAX package's fused function, less the sender-sorted tiling
    (ssum_perm, ssum_seg, ssum_blocks): the landing built from it on the
    host replaces it. Differentiable in x, w_s, e_t, w_e and offset; the
    backward needs `landing` (an `ops.segment_sum.SenderLanding` over these
    slots, the batch's `FlatTiling.landing`)."""
    layout = tuple(a.contiguous() for a in (senders_t, padded_recv,
                                            tile_blocks))
    geo = (node_block, edge_tile)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w_s, e_t, w_e, offset))
    if not needs_grad:
        return csr_fwd(*csr_operands(x, w_s, e_t, w_e), *layout,
                       offset.float().contiguous(), node_block=node_block,
                       edge_tile=edge_tile)
    if landing is None:
        raise ValueError("the CSR aggregation's backward needs the batch's "
                         "sender landing (FlatTiling.landing, built by "
                         "stack_samples from the sender-sorted tiling)")
    return CsrAggregateFn.apply(x, w_s, e_t, w_e, offset, *layout,
                                landing.order, landing.row_ptr, geo)
