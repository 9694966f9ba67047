"""Dense fixed-degree hoisted max aggregation, forward and backward.

Port of `make_fused_dense_aggregate` (`radargnn_tpu/ops/pallas_kernels.py`):
with the slot layout of `ops.dense_tiles`,

    inner[n] = max over n's in-window slots and overflow edges of
               (x[sender] @ w_s + e @ w_e)
    out[n]   = offset[n] + inner[n] for non-empty n, else 0.

On the card the slot part of the forward runs in the hand-written kernel
`csrc/dense_fwd_v4.cu` (it replaces `_fused_fwd_kernel_v4`); the overflow
part stays plain torch (`dense_overflow_inner`), as it is XLA in the JAX
package. As there, the gather operands are bf16 on the accelerator and
float32 where the JAX package runs its kernels in interpret mode (the CPU).

The gradient is `DenseAggregateFn`, the custom VJP of the JAX package
(:2713-2796): the forward runs in VJP mode and saves `inner`; the backward
routes g to every valid slot whose recomputed operand lies within
1e-5 |inner| + 1e-5 of its receiver's max (a tied slot takes the full g),
in the hand-written kernels of `csrc/dense_bwd_v4.cu` (they replace
`_fused_bwd_kernel_v4`): d_e per slot, dW_s, dW_e and the per-slot d_xg.
The overflow backward is torch, as XLA in the JAX package. d_x is the
d_xg rows and the overflow rows summed at their senders, landed in one
deterministic pass by `ops.segment_sum` over the batch's sender-sorted
order (`graph/batch.py` builds it once per batch).

The overflow code, the operand preparation (`gather_operands`), the VJP
body (`fused_backward`) and the kernels' input checks
(`check_slot_operands`) serve the windowed aggregation too
(`ops.windowed_aggregate`); the depth padding and the checks serve the
CSR aggregation (`ops.csr_aggregate`).
"""

from __future__ import annotations

import ctypes

import torch

from radargnn_tpu_torch.build import load_library
from radargnn_tpu_torch.models.mlp import matmul_f32
from radargnn_tpu_torch.ops import segment_sum

_NEG = -3.0e38          # finite -inf stand-in: offset + inner stays finite
_MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90
_ROUTE_RTOL = _ROUTE_ATOL = 1e-5    # strict max routing, as in the JAX package


def _sender_index(senders_local: torch.Tensor, tile_win: torch.Tensor,
                  te: int, node_block: int) -> torch.Tensor:
    """Global sender of every slot (0 for empty slots), int64."""
    win = tile_win.long().repeat_interleave(te) * node_block
    return win + senders_local.long().clamp(min=0)


def _routes(op: torch.Tensor, inner: torch.Tensor) -> torch.Tensor:
    """Which operands take their receiver's gradient: within the strict
    tolerance of the receiver's max."""
    return (op - inner).abs() <= _ROUTE_RTOL * inner.abs() + _ROUTE_ATOL


def dense_fwd_plain(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win,
                    inner_o, offset, *, r_tile: int, k: int, node_block: int,
                    emit_inner: bool = False):
    """Plain torch version of the dense forward kernel: the same function
    on the same inputs (x_c, w_s_c, e_t_c, w_e_c in the gather dtype;
    inner_o, offset float32), products in float32. Returns out, or
    (out, inner) with `emit_inner`."""
    te = r_tile * k
    h = w_s_c.shape[1]
    sender = _sender_index(senders_local, tile_win, te, node_block)
    op = matmul_f32(x_c[sender], w_s_c, x_c.dtype) \
        + matmul_f32(e_t_c, w_e_c, e_t_c.dtype)
    op = torch.where((senders_local >= 0)[:, None], op, _NEG)
    acc = op.reshape(-1, k, r_tile, h).amax(dim=1).reshape(-1, h)
    inner = torch.maximum(acc, inner_o)
    out = torch.where(inner > _NEG / 2, offset + inner, 0.0)
    return (out, inner) if emit_inner else out


def dense_bwd_plain(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win,
                    inner_z, g_pass, *, r_tile: int, k: int,
                    node_block: int):
    """Plain torch version of the dense backward kernels on the same inputs
    (gather dtype operands; inner_z, g_pass float32 [N, H] with 0 at empty
    receivers). Returns (d_xg [E_pad, d] and d_e [E_pad, de] in the gather
    dtype, dW_s [d, H] and dW_e [de, H] float32); d_op is rounded to the
    gather dtype, as the TPU kernel rounds it to its grad dtype."""
    cd = x_c.dtype
    h = w_s_c.shape[1]
    valid = (senders_local >= 0)[:, None]
    sender = _sender_index(senders_local, tile_win, r_tile * k, node_block)
    x_g = torch.where(valid, x_c[sender], 0)
    op = matmul_f32(x_g, w_s_c, cd) + matmul_f32(e_t_c, w_e_c, cd)
    inner3 = inner_z.reshape(-1, 1, r_tile, h)
    d_op = torch.where(_routes(op.reshape(-1, k, r_tile, h), inner3),
                       g_pass.reshape(-1, 1, r_tile, h), 0.0)
    d_op = torch.where(valid, d_op.reshape(-1, h), 0.0).to(cd)
    return (matmul_f32(d_op, w_s_c.t(), cd).to(cd),
            matmul_f32(d_op, w_e_c.t(), cd).to(cd),
            matmul_f32(x_g.t(), d_op, cd), matmul_f32(e_t_c.t(), d_op, cd))


# ---------------------------------------------------------------------------
# the CUDA kernels: build at first use, bind through ctypes
# ---------------------------------------------------------------------------

def _bind_fwd(lib: ctypes.CDLL) -> None:
    lib.dense_fwd_v4.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p])
    lib.dense_fwd_v4.restype = ctypes.c_int
    lib.dense_fwd_v4_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.dense_fwd_v4_smem_bytes.restype = ctypes.c_size_t


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.dense_bwd_v4.argtypes = (
        [ctypes.c_void_p] * 14 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.dense_bwd_v4.restype = ctypes.c_int
    lib.dense_bwd_v4_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.dense_bwd_v4_smem_bytes.restype = ctypes.c_size_t


def load_fwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/dense_fwd_v4.cu` once."""
    return load_library("dense_fwd_v4.cu", _bind_fwd)


def load_bwd_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds `csrc/dense_bwd_v4.cu` once."""
    return load_library("dense_bwd_v4.cu", _bind_bwd)


def _check(cond: bool, msg: str, kernel: str = "dense_fwd_v4") -> None:
    if not cond:
        raise ValueError(f"{kernel} kernel: {msg}")


def check_slot_operands(kernel: str, x_c, w_s_c, e_t_c, w_e_c,
                        index_tensors: dict, node_tensors: dict,
                        edge_dtype: torch.dtype = torch.bfloat16) -> None:
    """The checks every fused slot kernel (dense, windowed and CSR) needs:
    all on one CUDA device and contiguous; x and w_s bf16, e_t and w_e
    `edge_dtype` (bf16, or float32 for the CSR kernels), with matching
    widths, each a multiple of 8 and 16-byte aligned (the 16-byte row
    loads); `index_tensors` int32; `node_tensors` float32."""
    dev = x_c.device
    tensors = dict(x=x_c, w_s=w_s_c, e_t=e_t_c, w_e=w_e_c, **index_tensors,
                   **node_tensors)
    for name, ten in tensors.items():
        _check(ten.device == dev and dev.type == "cuda",
               f"{name} must be on {dev} (a CUDA device)", kernel)
        _check(ten.is_contiguous(), f"{name} must be contiguous", kernel)
    edge_label = "bf16" if edge_dtype == torch.bfloat16 else "float32"
    for names, dtype, label in (
            (("x", "w_s"), torch.bfloat16, "bf16"),
            (("e_t", "w_e"), edge_dtype, edge_label),
            (node_tensors, torch.float32, "float32"),
            (index_tensors, torch.int32, "int32")):
        for name in names:
            _check(tensors[name].dtype == dtype, f"{name} must be {label}",
                   kernel)
    d, h = w_s_c.shape
    de = e_t_c.shape[1]
    _check(x_c.shape[1] == d and w_e_c.shape == (de, h),
           f"w_s {tuple(w_s_c.shape)} / w_e {tuple(w_e_c.shape)} do not "
           f"match d={x_c.shape[1]}, de={de}", kernel)
    _check(d % 8 == 0 and de % 8 == 0,
           f"feature widths must be multiples of 8 (d={d}, de={de})", kernel)
    _check(x_c.data_ptr() % 16 == 0 and e_t_c.data_ptr() % 16 == 0,
           "x and e_t must be 16-byte aligned", kernel)


def _check_operands(kernel: str, x_c, w_s_c, e_t_c, w_e_c, senders_local,
                    tile_win, node_tensors: dict, *, r_tile: int,
                    k: int) -> None:
    """The checks both dense kernels share: `check_slot_operands`, then the
    slot layout's shapes; `node_tensors` are the float32 [T*R, H]
    inputs."""
    check_slot_operands(kernel, x_c, w_s_c, e_t_c, w_e_c,
                        dict(senders_local=senders_local, tile_win=tile_win),
                        node_tensors)
    h = w_s_c.shape[1]
    e_pad = e_t_c.shape[0]
    te = r_tile * k
    t = tile_win.shape[0]
    _check(e_pad == t * te and senders_local.shape == (e_pad,),
           f"{e_pad} slots do not match {t} tiles x {te}", kernel)
    for name, ten in node_tensors.items():
        _check(ten.shape == (t * r_tile, h),
               f"{name} must be [{t * r_tile}, {h}]", kernel)
    _check(r_tile % 16 == 0 and 16 <= r_tile <= 128,
           f"r_tile must be a multiple of 16 in [16, 128] (got {r_tile})",
           kernel)


def dense_fwd_cuda(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win,
                   inner_o, offset, *, r_tile: int, k: int, node_block: int,
                   emit_inner: bool = False):
    """Launches `csrc/dense_fwd_v4.cu` on the current stream (VJP mode with
    `emit_inner`: it also writes `inner`); raises on inputs the kernel does
    not take. Counts its launches in `dense_fwd_cuda.launches`."""
    _check_operands("dense_fwd_v4", x_c, w_s_c, e_t_c, w_e_c, senders_local,
                    tile_win, dict(inner_o=inner_o, offset=offset),
                    r_tile=r_tile, k=k)
    dev = x_c.device
    n_x, d = x_c.shape
    de = e_t_c.shape[1]
    h = w_s_c.shape[1]
    t = tile_win.shape[0]
    lib = load_fwd_kernel()
    _check(lib.dense_fwd_v4_smem_bytes(d, de, r_tile) <= _MAX_SMEM,
           f"d={d} needs more shared memory than a block has")
    out = torch.empty((t * r_tile, h), dtype=torch.float32, device=dev)
    inner = torch.empty_like(out) if emit_inner else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dense_fwd_v4(
            x_c.data_ptr(), w_s_c.data_ptr(), e_t_c.data_ptr(),
            w_e_c.data_ptr(), senders_local.data_ptr(), tile_win.data_ptr(),
            inner_o.data_ptr(), offset.data_ptr(), out.data_ptr(),
            None if inner is None else inner.data_ptr(),
            n_x, d, de, h, t, r_tile, k, node_block, stream)
    if err != 0:
        raise RuntimeError(f"dense_fwd_v4 launch failed: cudaError {err}")
    dense_fwd_cuda.launches += 1
    return (out, inner) if emit_inner else out


dense_fwd_cuda.launches = 0


def dense_fwd(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win, inner_o,
              offset, *, r_tile: int, k: int, node_block: int,
              emit_inner: bool = False):
    """The dense forward kernel's wrapper: a CUDA tensor launches the
    kernel (or raises), a CPU tensor takes the plain version."""
    fn = dense_fwd_cuda if x_c.is_cuda else dense_fwd_plain
    return fn(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win, inner_o,
              offset, r_tile=r_tile, k=k, node_block=node_block,
              emit_inner=emit_inner)


def weight_partials(num_slots: int) -> int:
    """Number of fixed slot chunks the backward sums dW over (each gives
    one partial; the partials are then summed in order)."""
    return max(1, min(64, -(-num_slots // 2048)))


def dense_bwd_cuda(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win,
                   inner_z, g_pass, *, r_tile: int, k: int, node_block: int):
    """Launches the four passes of `csrc/dense_bwd_v4.cu` on the current
    stream; raises on inputs the kernels do not take. Returns what
    `dense_bwd_plain` returns. Counts its launches in
    `dense_bwd_cuda.launches` (one per backward)."""
    kernel = "dense_bwd_v4"
    _check_operands(kernel, x_c, w_s_c, e_t_c, w_e_c, senders_local,
                    tile_win, dict(inner_z=inner_z, g_pass=g_pass),
                    r_tile=r_tile, k=k)
    dev = x_c.device
    n_x, d = x_c.shape
    e_pad, de = e_t_c.shape
    h = w_s_c.shape[1]
    t = tile_win.shape[0]
    _check(h % 8 == 0, f"h must be a multiple of 8 (got {h})", kernel)
    lib = load_bwd_kernel()
    _check(lib.dense_bwd_v4_smem_bytes(d, de, r_tile) <= _MAX_SMEM,
           f"d={d} needs more shared memory than a block has", kernel)
    hp = -(-h // 64) * 64
    n_part = weight_partials(e_pad)
    bf16, f32 = torch.bfloat16, torch.float32
    d_op = torch.empty((e_pad, hp), dtype=bf16, device=dev)
    partial = torch.empty((n_part, d + de, hp), dtype=f32, device=dev)
    d_xg = torch.empty((e_pad, d), dtype=bf16, device=dev)
    d_e = torch.empty((e_pad, de), dtype=bf16, device=dev)
    dw_s = torch.empty((d, h), dtype=f32, device=dev)
    dw_e = torch.empty((de, h), dtype=f32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dense_bwd_v4(
            x_c.data_ptr(), w_s_c.data_ptr(), e_t_c.data_ptr(),
            w_e_c.data_ptr(), senders_local.data_ptr(), tile_win.data_ptr(),
            inner_z.data_ptr(), g_pass.data_ptr(), d_op.data_ptr(),
            partial.data_ptr(), d_xg.data_ptr(), d_e.data_ptr(),
            dw_s.data_ptr(), dw_e.data_ptr(), n_x, d, de, h, t, r_tile, k,
            node_block, n_part, stream)
    if err != 0:
        raise RuntimeError(f"dense_bwd_v4 launch failed: cudaError {err}")
    dense_bwd_cuda.launches += 1
    return d_xg, d_e, dw_s, dw_e


dense_bwd_cuda.launches = 0


def dense_bwd(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win, inner_z,
              g_pass, *, r_tile: int, k: int, node_block: int):
    """The dense backward kernels' wrapper: a CUDA tensor launches them (or
    raises), a CPU tensor takes the plain version."""
    fn = dense_bwd_cuda if x_c.is_cuda else dense_bwd_plain
    return fn(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win, inner_z,
              g_pass, r_tile=r_tile, k=k, node_block=node_block)


# ---------------------------------------------------------------------------
# overflow part, autograd Function and entry point
# ---------------------------------------------------------------------------

def _overflow_operand(x_c, w_s_c, e_ovf_c, w_e_c, ovf_s) -> torch.Tensor:
    """The overflow edges' operands [Eo, H] float32: the overflow senders
    gathered at node width and projected, plus their edge projection."""
    return matmul_f32(x_c[ovf_s.long()], w_s_c, x_c.dtype) \
        + matmul_f32(e_ovf_c, w_e_c, e_ovf_c.dtype)


def dense_overflow_inner(x_c, w_s_c, e_ovf_c, w_e_c, ovf_s, ovf_r,
                         num_nodes: int) -> torch.Tensor:
    """Raw per-node maxima of the overflow edges, [num_nodes, H] float32,
    _NEG for receivers without overflow edges: gather the overflow senders
    at node width, project, and scatter-max (padding entries, ovf_r < 0,
    carry _NEG and so never win)."""
    mask = ovf_r >= 0
    y = _overflow_operand(x_c, w_s_c, e_ovf_c, w_e_c, ovf_s)
    y = torch.where(mask[:, None], y, _NEG)
    idx = torch.where(mask, ovf_r, 0).long()[:, None].expand_as(y)
    out = torch.full((num_nodes, y.shape[1]), _NEG, dtype=torch.float32,
                     device=y.device)
    return out.scatter_reduce_(0, idx, y, "amax", include_self=False)


def gather_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, as on the TPU; float32 on the CPU, as in the JAX
    package's interpret mode (the reference the CPU tests hold it to)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def _pad_depth(a: torch.Tensor, w: torch.Tensor):
    """Zero-pads a's columns and w's rows to a multiple of 8, the kernels'
    16-byte row loads (zeros add nothing to a @ w); contiguous copies."""
    pad = -a.shape[1] % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    return a.contiguous(), w.contiguous()


def gather_operands(x, w_s, e_t, w_e, e_ovf, ovf_s, ovf_r,
                    num_nodes: int):
    """A fused forward's operands in the gather dtype: the overflow maxima
    inner_o [num_nodes, H] float32 and the depth-padded (x, w_s, e_t, w_e)
    the kernels (and the backward) take."""
    cd = gather_dtype(x.device)
    x_c, w_s_c, w_e_c = x.to(cd), w_s.to(cd), w_e.to(cd)
    inner_o = dense_overflow_inner(x_c, w_s_c, e_ovf.to(cd), w_e_c,
                                   ovf_s, ovf_r, num_nodes)
    x_p, w_s_p = _pad_depth(x_c, w_s_c)
    e_p, w_e_p = _pad_depth(e_t.to(cd), w_e_c)
    return inner_o, (x_p, w_s_p, e_p, w_e_p)


def fused_backward(g, inner, slot_backward, x, w_s, w_e, e_ovf, ovf_s,
                   ovf_r, order, row_ptr, dtypes) -> tuple:
    """The custom VJP's body that both fused aggregations share: g and
    inner zeroed at empty receivers, the kernels' slot part
    `slot_backward(inner_z, g_pass) -> (d_xg, d_e_t, dW_s, dW_e)` (padded
    widths, d_xg and d_e_t in the gather dtype), the overflow backward in
    torch (XLA in the JAX package), and d_x: the d_xg rows and the
    overflow rows summed at their senders in one landing over the batch's
    sender order. Returns the gradients of (x, w_s, e_t, w_e, offset,
    e_ovf) in their inputs' dtypes."""
    x_dtype, e_dtype, e_ovf_dtype, offset_dtype = dtypes
    d, de = x.shape[1], w_e.shape[0]
    has = inner > _NEG / 2
    g_pass = torch.where(has, g.float(), 0.0)
    inner_z = torch.where(has, inner, 0.0)
    d_xg, d_e_t, d_ws, d_we = slot_backward(inner_z, g_pass)

    # the overflow operand is recomputed as the forward computed it, in the
    # gather dtype; the products with d_op_o take the unrounded float32
    # operands
    cd = d_xg.dtype
    mask = ovf_r >= 0
    recv = torch.where(mask, ovf_r, 0).long()
    op_o = _overflow_operand(x.to(cd), w_s.to(cd), e_ovf.to(cd), w_e.to(cd),
                             ovf_s)
    d_op_o = torch.where(mask[:, None] & _routes(op_o, inner_z[recv]),
                         g_pass[recv], 0.0)
    d_xo = d_op_o @ w_s.float().t()
    pad = d_xg.shape[1] - d
    if pad:
        d_xo = torch.nn.functional.pad(d_xo, (0, pad))
    d_x = segment_sum.segment_sum_csr(d_xg, order, row_ptr,
                                      d_xo.contiguous())[:, :d]
    x_o = x.float()[ovf_s.long()]
    d_ws = d_ws[:d] + x_o.t() @ d_op_o
    d_we = d_we[:de] + e_ovf.float().t() @ d_op_o
    d_e_ovf = (d_op_o @ w_e.float().t()).to(e_ovf_dtype)
    return (d_x.to(x_dtype), d_ws.to(w_s.dtype), d_e_t[:, :de].to(e_dtype),
            d_we.to(w_e.dtype), g_pass.to(offset_dtype), d_e_ovf)


def _forward(x, w_s, e_t, w_e, offset, e_ovf, tile_win, senders_local,
             ovf_s, ovf_r, geo, emit_inner: bool):
    """The forward on gather-dtype operands; returns (the kernel wrapper's
    result, the padded operands the backward reuses)."""
    r_tile, k, node_block = geo
    inner_o, padded = gather_operands(x, w_s, e_t, w_e, e_ovf, ovf_s, ovf_r,
                                      offset.shape[0])
    res = dense_fwd(*padded, senders_local.contiguous(),
                    tile_win.contiguous(), inner_o,
                    offset.float().contiguous(), r_tile=r_tile, k=k,
                    node_block=node_block, emit_inner=emit_inner)
    return res, padded


class DenseAggregateFn(torch.autograd.Function):
    """The dense aggregation with its custom VJP (module docstring)."""

    @staticmethod
    def forward(ctx, x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                senders_local, ovf_s, ovf_r, order, row_ptr, geo):
        (out, inner), padded = _forward(x, w_s, e_t, w_e, offset, e_ovf,
                                        tile_win, senders_local, ovf_s,
                                        ovf_r, geo, emit_inner=True)
        ctx.geo = geo
        ctx.dtypes = (x.dtype, e_t.dtype, e_ovf.dtype, offset.dtype)
        ctx.save_for_backward(x, w_s, w_e, e_ovf, *padded,
                              senders_local.contiguous(),
                              tile_win.contiguous(), ovf_s, ovf_r, order,
                              row_ptr, inner)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, w_s, w_e, e_ovf, x_p, w_s_p, e_p, w_e_p, sloc, t_win, ovf_s,
         ovf_r, order, row_ptr, inner) = ctx.saved_tensors
        r_tile, k, node_block = ctx.geo

        def slot_backward(inner_z, g_pass):
            return dense_bwd(x_p, w_s_p, e_p, w_e_p, sloc, t_win, inner_z,
                             g_pass, r_tile=r_tile, k=k,
                             node_block=node_block)

        return fused_backward(g, inner, slot_backward, x, w_s, w_e, e_ovf,
                              ovf_s, ovf_r, order, row_ptr,
                              ctx.dtypes) + (None,) * 7


def dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                    senders_local, ovf_s, ovf_r, *, r_tile: int, k: int,
                    node_block: int, landing=None) -> torch.Tensor:
    """The dense fused aggregation (module docstring), with the argument
    order of the JAX package's fused function (less part_mask: the landing
    replaces it). Differentiable in x, w_s, e_t, w_e, offset and e_ovf;
    the backward needs `landing` (an `ops.segment_sum.SenderLanding`, the
    batch's `FlatTiling.landing`)."""
    num_nodes = offset.shape[0]
    if num_nodes % r_tile:
        raise ValueError(f"num_nodes {num_nodes} not divisible by "
                         f"r_tile {r_tile}")
    geo = (r_tile, k, node_block)
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w_s, e_t, w_e, offset, e_ovf))
    if not needs_grad:
        out, _ = _forward(x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                          senders_local, ovf_s, ovf_r, geo, emit_inner=False)
        return out
    if landing is None:
        raise ValueError("the dense aggregation's backward needs the batch's "
                         "sender landing (FlatTiling.landing, built by "
                         "stack_samples)")
    return DenseAggregateFn.apply(x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                                  senders_local, ovf_s, ovf_r, landing.order,
                                  landing.row_ptr, geo)
