"""Dense fixed-degree hoisted max aggregation, forward and backward.

Port of `make_fused_dense_aggregate` (`radargnn_tpu/ops/pallas_kernels.py`):
with the slot layout of `ops.dense_tiles`,

    inner[n] = max over n's in-window slots and overflow edges of
               (x[sender] @ w_s + e @ w_e)
    out[n]   = offset[n] + inner[n] for non-empty n, else 0.

On the card this is three launches of the port's own, which replace
`_fused_fwd_kernel_v4` and `_fused_bwd_kernel_v4`; the TPU kernels' one-hot
gathers and per-slot products are not carried over:

  * the node projection `y_s = x @ w_s` once per node, [N, hp] float32
    (hp = H rounded up to 64, zero past H; `dense_proj`,
    `csrc/dense_fwd_v4.cu`), since x[s] @ w_s = y_s[s];
  * the gather-max (`dense_fwd`, same file): op[slot] = y_s[sender] +
    e_t[slot] @ w_e, the max over a receiver's K slots and its overflow
    maxima, the offset epilogue. In VJP mode it also writes `inner` and one
    routing bit per (slot, column), set where the slot is valid and
    |op - inner| <= 1e-5 |inner| + 1e-5: the strict routing of the TPU
    kernel, under which every tied slot takes the full g (with `bf16_max`,
    where bf16(op) == bf16(inner): the TPU kernel's bf16_cmp branch, under
    which every slot within a bf16 rounding of the max takes the full g);
  * the backward (`dense_bwd`, `csrc/dense_bwd_v4.cu`): d_op[slot] =
    bf16(g[receiver]) where the slot's bit is set, else 0; d_e = d_op @
    w_e^T and dW_e in a receiver-major pass over the tiles, and the H-wide
    sender sums d_ys[s] = the sum of d_op over s's slots and d_yo[s] = the
    sum of its overflow rows, in one sender-major pass over the batch's
    landing order (`graph/batch.py` builds it once per batch). Fixed
    summation orders, no atomics.

d_x = bf16(d_ys) @ w_s^T + d_yo @ w_s^T and dW_s = bf16(x)^T @ bf16(d_ys)
+ x^T @ d_yo are then node-wide products, the JAX package's `sender_dx`
form (its wrapper :2742-2754, the overflow part in float32 as at
:2787-2789). Under `ovf_ssum` (`ovf_landing` given: the batch's
sender-sorted overflow tiling) the overflow part of d_x is the JAX
package's instead (:2770-2781): each overflow row's bf16(bf16(d_op_o) @
bf16(w_s)^T), summed at its sender by the segment-sum kernel
(`ops.segment_sum`, B3) over that tiling. The routing comes from the forward's bits, so the backward
sees the forward's op bit for bit without recomputing it. The overflow
edges' operand is y_s[ovf_s] + e_ovf @ w_e, scatter-maxed in torch (XLA in
the JAX package); the forward saves it for the overflow backward. As in
the JAX package, the gather operands are bf16 on the accelerator and
float32 where the JAX package runs its kernels in interpret mode (the CPU),
where every wrapper takes its plain version.

The windowed aggregation (`ops.windowed_aggregate`) has the same form
and shares its pieces: the projection and the overflow operands
(`project_operands`), the routing bits (`pack_bits`), the backward's
plain body (`routed_bwd_plain`), launcher (`routed_bwd_launch`) and VJP
body (`routed_backward`), and the kernels' input checks; the depth and
width padding and the checks also serve the CSR aggregation
(`ops.csr_aggregate`). The JAX package's overflow form
(`dense_overflow_inner`: gather, project, scatter-max) is kept for the
tests and the smoke's inputs.
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


def col_pad(h: int) -> int:
    """H rounded up to the kernels' 64-column slices: y_s's row width, and
    32 times the routing bits' words per slot."""
    return -(-h // 64) * 64


def _slot_receivers(e_pad: int, r_tile: int, k: int,
                    device) -> torch.Tensor:
    """Receiver of every slot of the dense layout, int64: slot t*TE + j*R +
    r holds an in-edge of receiver t*R + r."""
    slot = torch.arange(e_pad, device=device)
    return slot // (r_tile * k) * r_tile + slot % r_tile


def _sender_index(senders_local: torch.Tensor, tile_win: torch.Tensor,
                  te: int, node_block: int) -> torch.Tensor:
    """Global sender of every slot (0 for empty slots), int64."""
    win = tile_win.long().repeat_interleave(te) * node_block
    return win + senders_local.long().clamp(min=0)


def _routes(op: torch.Tensor, inner: torch.Tensor,
            bf16_max: bool = False) -> torch.Tensor:
    """Which operands take their receiver's gradient: within the strict
    tolerance of the receiver's max, or with `bf16_max` equal to it once
    both are rounded to bf16 (to nearest even, as the TPU kernel's
    astype(bfloat16))."""
    if bf16_max:
        return op.to(torch.bfloat16) == inner.to(torch.bfloat16)
    return (op - inner).abs() <= _ROUTE_RTOL * inner.abs() + _ROUTE_ATOL


def pack_bits(sel: torch.Tensor) -> torch.Tensor:
    """[E, H] bool -> [E, col_pad(H) / 32] int32 words: bit b of word w is
    column 32 w + b (zero past H)."""
    e, h = sel.shape
    sel = torch.nn.functional.pad(sel, (0, col_pad(h) - h))
    bit = 2 ** torch.arange(32, dtype=torch.int64, device=sel.device)
    words = (sel.reshape(e, -1, 32).long() * bit).sum(-1)
    return torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(
        torch.int32)


def unpack_bits(bits: torch.Tensor, h: int) -> torch.Tensor:
    """The inverse of `pack_bits`: [E, W] int32 -> [E, h] bool."""
    shifts = torch.arange(32, dtype=torch.int32, device=bits.device)
    sel = (bits[:, :, None] >> shifts) & 1
    return sel.reshape(bits.shape[0], -1)[:, :h].bool()


def dense_proj_plain(x_c, w_s_c) -> torch.Tensor:
    """Plain torch version of the projection kernel: y_s = x @ w_s in
    float32 from operands in the gather dtype, [N, col_pad(H)], zero past
    H."""
    h = w_s_c.shape[1]
    y = matmul_f32(x_c, w_s_c, x_c.dtype)
    return torch.nn.functional.pad(y, (0, col_pad(h) - h))


def dense_fwd_plain(y_s, e_t_c, w_e_c, senders_local, tile_win, inner_o,
                    offset, *, r_tile: int, k: int, node_block: int,
                    emit_inner: bool = False, bf16_max: bool = False):
    """Plain torch version of the gather-max kernel: the same function on
    the same inputs (y_s [N, hp] float32; e_t_c, w_e_c in the gather dtype;
    inner_o, offset float32 [N, H]). Returns out, or (out, inner, bits)
    with `emit_inner`: bits [E_pad, hp / 32] int32, one per (slot,
    column), set where the slot is valid and its op routes (`_routes`,
    bf16 with `bf16_max`)."""
    te = r_tile * k
    h = offset.shape[1]
    sender = _sender_index(senders_local, tile_win, te, node_block)
    op = y_s[sender, :h] + matmul_f32(e_t_c, w_e_c, e_t_c.dtype)
    valid = (senders_local >= 0)[:, None]
    op = torch.where(valid, op, _NEG)
    acc = op.reshape(-1, k, r_tile, h).amax(dim=1).reshape(-1, h)
    inner = torch.maximum(acc, inner_o)
    out = torch.where(inner > _NEG / 2, offset + inner, 0.0)
    if not emit_inner:
        return out
    inner3 = inner.reshape(-1, 1, r_tile, h)
    sel = _routes(op.reshape(-1, k, r_tile, h), inner3,
                  bf16_max).reshape(-1, h)
    return out, inner, pack_bits(valid & sel)


def routed_bwd_plain(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order,
                     row_ptr):
    """Plain torch version of the bits-routed backward kernels (the dense
    and the windowed one) on the same inputs: bits from the forward;
    g_pass float32 [N, H], 0 at empty receivers; e_t_c, w_e_c in the gather
    dtype; d_op_o [Eo, H] float32, the overflow rows; `recv` int64, every
    slot's receiver (any node where the slot has no bits). d_op is g at the
    slot's receiver where the bit is set, rounded to the gather dtype, as
    the TPU kernel rounds it to its grad dtype. Returns (d_e [E_pad, de] in
    the gather dtype, dW_e [de, H] float32, d_ys and d_yo [N, H] float32:
    the slots' d_op and the overflow rows summed at their senders over the
    landing)."""
    cd = e_t_c.dtype
    h = g_pass.shape[1]
    d_op = torch.where(unpack_bits(bits, h), g_pass[recv], 0.0).to(cd)
    # one landing of [slot rows | 0] and [0 | overflow rows]
    sums = segment_sum.segment_sum_csr_plain(
        torch.nn.functional.pad(d_op.float(), (0, h)), order, row_ptr,
        torch.nn.functional.pad(d_op_o, (h, 0)))
    return (matmul_f32(d_op, w_e_c.t(), cd).to(cd),
            matmul_f32(e_t_c.t(), d_op, cd), sums[:, :h], sums[:, h:])


def dense_bwd_plain(bits, g_pass, e_t_c, w_e_c, d_op_o, order, row_ptr, *,
                    r_tile: int, k: int):
    """Plain torch version of the dense backward kernels: `routed_bwd_plain`
    with the dense layout's receivers."""
    recv = _slot_receivers(e_t_c.shape[0], r_tile, k, g_pass.device)
    return routed_bwd_plain(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order,
                            row_ptr)


# ---------------------------------------------------------------------------
# the CUDA kernels: build at first use, bind through ctypes
# ---------------------------------------------------------------------------

def _bind_fwd(lib: ctypes.CDLL) -> None:
    lib.dense_proj_v4.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.dense_proj_v4.restype = ctypes.c_int
    lib.dense_proj_v4_smem_bytes.argtypes = [ctypes.c_int]
    lib.dense_proj_v4_smem_bytes.restype = ctypes.c_size_t
    lib.dense_fwd_v4.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.dense_fwd_v4.restype = ctypes.c_int
    lib.dense_fwd_v4_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.dense_fwd_v4_smem_bytes.restype = ctypes.c_size_t


def _bind_bwd(lib: ctypes.CDLL) -> None:
    lib.dense_bwd_v4.argtypes = ROUTED_BWD_ARGTYPES + [ctypes.c_void_p]
    lib.dense_bwd_v4.restype = ctypes.c_int
    lib.dense_bwd_v4_smem_bytes.argtypes = [ctypes.c_int] * 2
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


_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float32: "float32",
                torch.int32: "int32"}


def _check_tensors(kernel: str, dtypes: dict, **tensors) -> None:
    """All on one CUDA device and contiguous, each of its dtype."""
    dev = next(iter(tensors.values())).device
    for name, ten in tensors.items():
        _check(ten.device == dev and dev.type == "cuda",
               f"{name} must be on {dev} (a CUDA device)", kernel)
        _check(ten.is_contiguous(), f"{name} must be contiguous", kernel)
        _check(ten.dtype == dtypes[name],
               f"{name} must be {_DTYPE_NAMES[dtypes[name]]}", kernel)


def _check_aligned(kernel: str, **tensors) -> None:
    """16-byte aligned data (the kernels' 16-byte copies and row loads)."""
    for name, ten in tensors.items():
        _check(ten.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned",
               kernel)


def check_slot_operands(kernel: str, x_c, w_s_c, e_t_c, w_e_c,
                        index_tensors: dict, node_tensors: dict,
                        edge_dtype: torch.dtype = torch.bfloat16) -> None:
    """The checks every fused slot kernel (dense, windowed and CSR) needs:
    all on one CUDA device and contiguous; x and w_s bf16, e_t and w_e
    `edge_dtype` (bf16, or float32 for the CSR kernels), with matching
    widths, each a multiple of 8 and 16-byte aligned (the 16-byte row
    loads); `index_tensors` int32; `node_tensors` float32."""
    dtypes = dict(x=torch.bfloat16, w_s=torch.bfloat16, e_t=edge_dtype,
                  w_e=edge_dtype, **dict.fromkeys(index_tensors, torch.int32),
                  **dict.fromkeys(node_tensors, torch.float32))
    _check_tensors(kernel, dtypes, x=x_c, w_s=w_s_c, e_t=e_t_c, w_e=w_e_c,
                   **index_tensors, **node_tensors)
    d, h = w_s_c.shape
    de = e_t_c.shape[1]
    _check(x_c.shape[1] == d and w_e_c.shape == (de, h),
           f"w_s {tuple(w_s_c.shape)} / w_e {tuple(w_e_c.shape)} do not "
           f"match d={x_c.shape[1]}, de={de}", kernel)
    _check(d % 8 == 0 and de % 8 == 0,
           f"feature widths must be multiples of 8 (d={d}, de={de})", kernel)
    _check_aligned(kernel, x=x_c, e_t=e_t_c)


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def pad_width(*tensors):
    """Zero-pads the last dimension of each tensor to a multiple of 8, the
    backward kernels' 16-byte loads of H-wide rows (a padded column's g is
    0, so it routes nothing); copies only where a pad is needed."""
    pad = -tensors[0].shape[-1] % 8
    if not pad:
        return tensors
    return tuple(torch.nn.functional.pad(t, (0, pad)).contiguous()
                 for t in tensors)


def dense_proj_cuda(x_c, w_s_c) -> torch.Tensor:
    """Launches the projection of `csrc/dense_fwd_v4.cu` on the current
    stream; raises on inputs it does not take. Counts its launches in
    `dense_proj_cuda.launches`."""
    kernel = "dense_proj_v4"
    bf16 = torch.bfloat16
    h = w_s_c.shape[1]
    (w_s_c,) = pad_width(w_s_c)         # 16-byte rows of the W_s slice
    _check_tensors(kernel, dict(x=bf16, w_s=bf16), x=x_c, w_s=w_s_c)
    n, d = x_c.shape
    _check(w_s_c.shape[0] == d and d % 8 == 0,
           f"x [{n}, {d}] and w_s {tuple(w_s_c.shape)}: d must match and be "
           "a multiple of 8", kernel)
    _check_aligned(kernel, x=x_c, w_s=w_s_c)
    lib = load_fwd_kernel()
    _check(lib.dense_proj_v4_smem_bytes(d) <= _MAX_SMEM,
           f"d={d} needs more shared memory than a block has", kernel)
    y_s = torch.empty((n, col_pad(h)), dtype=torch.float32,
                      device=x_c.device)
    with torch.cuda.device(x_c.device):
        err = lib.dense_proj_v4(x_c.data_ptr(), w_s_c.data_ptr(),
                                y_s.data_ptr(), n, d, w_s_c.shape[1],
                                y_s.shape[1], _stream(x_c.device))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    dense_proj_cuda.launches += 1
    return y_s


dense_proj_cuda.launches = 0


def dense_proj(x_c, w_s_c) -> torch.Tensor:
    """The projection's wrapper: a CUDA tensor launches the kernel (or
    raises), a CPU tensor takes the plain version."""
    fn = dense_proj_cuda if x_c.is_cuda else dense_proj_plain
    return fn(x_c, w_s_c)


def dense_fwd_cuda(y_s, e_t_c, w_e_c, senders_local, tile_win, inner_o,
                   offset, *, r_tile: int, k: int, node_block: int,
                   emit_inner: bool = False, bf16_max: bool = False):
    """Launches the gather-max of `csrc/dense_fwd_v4.cu` on the current
    stream (VJP mode with `emit_inner`: it also writes `inner` and the
    routing bits, by the bf16 test with `bf16_max`); raises on inputs the
    kernel does not take. Counts its launches in `dense_fwd_cuda.launches`,
    and those with `bf16_max` in `dense_fwd_cuda.bf16_launches` too."""
    kernel = "dense_fwd_v4"
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    _check_tensors(kernel, dict(y_s=f32, e_t=bf16, w_e=bf16,
                                senders_local=i32, tile_win=i32,
                                inner_o=f32, offset=f32),
                   y_s=y_s, e_t=e_t_c, w_e=w_e_c,
                   senders_local=senders_local, tile_win=tile_win,
                   inner_o=inner_o, offset=offset)
    e_pad, de = e_t_c.shape
    num_nodes, h = offset.shape
    te, t = r_tile * k, tile_win.shape[0]
    hp = col_pad(h)
    _check(e_pad == t * te and senders_local.shape == (e_pad,)
           and num_nodes == t * r_tile,
           f"{e_pad} slots, {num_nodes} receivers do not match {t} tiles x "
           f"{r_tile} x {k}", kernel)
    _check(inner_o.shape == offset.shape and w_e_c.shape == (de, h)
           and y_s.shape[1] == hp and de % 8 == 0,
           f"y_s {tuple(y_s.shape)}, w_e {tuple(w_e_c.shape)}, inner_o "
           f"{tuple(inner_o.shape)} do not match H={h}, de={de} (a multiple "
           "of 8)", kernel)
    _check(r_tile % 8 == 0 and 8 <= r_tile <= 128,
           f"r_tile must be a multiple of 8 in [8, 128] (got {r_tile})",
           kernel)
    _check_aligned(kernel, y_s=y_s, e_t=e_t_c)
    lib = load_fwd_kernel()
    _check(lib.dense_fwd_v4_smem_bytes(de, r_tile, k) <= _MAX_SMEM,
           f"de={de}, {r_tile} x {k} slots need more shared memory than a "
           "block has", kernel)
    dev = y_s.device
    out = torch.empty((num_nodes, h), dtype=f32, device=dev)
    inner = bits = None
    if emit_inner:
        inner = torch.empty_like(out)
        # the kernel writes the words of the slots that hold an edge
        bits = torch.zeros((e_pad, hp // 32), dtype=i32, device=dev)
    with torch.cuda.device(dev):
        err = lib.dense_fwd_v4(
            y_s.data_ptr(), e_t_c.data_ptr(), w_e_c.data_ptr(),
            senders_local.data_ptr(), tile_win.data_ptr(),
            inner_o.data_ptr(), offset.data_ptr(), out.data_ptr(),
            None if inner is None else inner.data_ptr(),
            None if bits is None else bits.data_ptr(),
            y_s.shape[0], de, h, hp, t, r_tile, k, node_block,
            int(bf16_max), _stream(dev))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    dense_fwd_cuda.launches += 1
    dense_fwd_cuda.bf16_launches += int(bf16_max)
    return (out, inner, bits) if emit_inner else out


dense_fwd_cuda.launches = 0
dense_fwd_cuda.bf16_launches = 0


def dense_fwd(y_s, e_t_c, w_e_c, senders_local, tile_win, inner_o, offset,
              *, r_tile: int, k: int, node_block: int,
              emit_inner: bool = False, bf16_max: bool = False):
    """The gather-max kernel's wrapper: a CUDA tensor launches the kernel
    (or raises), a CPU tensor takes the plain version."""
    fn = dense_fwd_cuda if y_s.is_cuda else dense_fwd_plain
    return fn(y_s, e_t_c, w_e_c, senders_local, tile_win, inner_o, offset,
              r_tile=r_tile, k=k, node_block=node_block,
              emit_inner=emit_inner, bf16_max=bf16_max)


def routed_bwd_launch(kernel: str, load, bits, g_pass, e_t_c, w_e_c, d_op_o,
                      order, row_ptr, *, r_tile: int, k: int, extra=(),
                      smem_bytes=None):
    """The checks, scratch and launch both bits-routed backwards (dense
    and windowed, `csrc/routed_bwd.cuh`) share: `load` builds and binds the
    library whose entry point is named `kernel`, `extra` are its layout's
    arguments after the common ones (the windowed receivers), and
    `smem_bytes(lib, hp)` the shared memory its passes need where that
    depends on the shapes. The caller checks the layout's own shapes.
    Returns what `routed_bwd_plain` returns."""
    f32, bf16, i32 = torch.float32, torch.bfloat16, torch.int32
    num_nodes, h = g_pass.shape
    g_pass, w_e_c, d_op_o = pad_width(g_pass, w_e_c, d_op_o)
    _check_tensors(kernel, dict(bits=i32, g_pass=f32, e_t=bf16, w_e=bf16,
                                d_op_o=f32, order=i32, row_ptr=i32),
                   bits=bits, g_pass=g_pass, e_t=e_t_c, w_e=w_e_c,
                   d_op_o=d_op_o, order=order, row_ptr=row_ptr)
    e_pad, de = e_t_c.shape
    hg = g_pass.shape[1]
    hp = col_pad(h)
    te = r_tile * k
    t = e_pad // te
    _check(e_pad == t * te and bits.shape == (e_pad, hp // 32)
           and row_ptr.shape == (num_nodes + 1,),
           f"bits {tuple(bits.shape)}, g_pass [{num_nodes}, {h}], "
           f"{e_pad} slots do not match tiles of {r_tile} x {k}", kernel)
    _check(w_e_c.shape == (de, hg) and d_op_o.shape[1] == hg
           and de % 8 == 0,
           f"w_e {tuple(w_e_c.shape)}, d_op_o {tuple(d_op_o.shape)} do not "
           f"match H={h}, de={de} (a multiple of 8)", kernel)
    _check(r_tile % 8 == 0 and 8 <= r_tile <= 128,
           f"r_tile must be a multiple of 8 in [8, 128] (got {r_tile})",
           kernel)
    _check_aligned(kernel, bits=bits, g_pass=g_pass, w_e=w_e_c,
                   d_op_o=d_op_o)
    lib = load()
    _check(smem_bytes is None or smem_bytes(lib, hp) <= _MAX_SMEM,
           f"H={h} needs more shared memory than a block has", kernel)
    dev = bits.device
    de16 = -(-de // 16) * 16
    d_e = torch.empty((e_pad, de), dtype=bf16, device=dev)
    we_part = torch.empty((t, de16, hp), dtype=f32, device=dev)
    dw_e = torch.empty((de, hg), dtype=f32, device=dev)
    d_ys = torch.empty((num_nodes, hg), dtype=f32, device=dev)
    d_yo = torch.empty_like(d_ys)
    with torch.cuda.device(dev):
        err = getattr(lib, kernel)(
            bits.data_ptr(), g_pass.data_ptr(), e_t_c.data_ptr(),
            w_e_c.data_ptr(), d_op_o.data_ptr(), order.data_ptr(),
            row_ptr.data_ptr(), d_e.data_ptr(), we_part.data_ptr(),
            dw_e.data_ptr(), d_ys.data_ptr(), d_yo.data_ptr(), e_pad, t,
            r_tile, k, de, hg, hp, num_nodes, *extra, _stream(dev))
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    return d_e, dw_e[:, :h], d_ys[:, :h], d_yo[:, :h]


# the argument types of a routed backward's entry point before its layout's
ROUTED_BWD_ARGTYPES = ([ctypes.c_void_p] * 12 + [ctypes.c_longlong]
                       + [ctypes.c_int] * 7)


def dense_bwd_cuda(bits, g_pass, e_t_c, w_e_c, d_op_o, order, row_ptr, *,
                   r_tile: int, k: int):
    """Launches the four passes of `csrc/dense_bwd_v4.cu` on the current
    stream; raises on inputs the kernels do not take. Returns what
    `dense_bwd_plain` returns. Counts its launches in
    `dense_bwd_cuda.launches` (one per backward)."""
    kernel = "dense_bwd_v4"
    _check(g_pass.shape[0] * k == e_t_c.shape[0],
           f"g_pass [{g_pass.shape[0]}, ...] does not match "
           f"{e_t_c.shape[0]} slots of {r_tile} x {k} tiles", kernel)
    res = routed_bwd_launch(
        kernel, load_bwd_kernel, bits, g_pass, e_t_c, w_e_c, d_op_o, order,
        row_ptr, r_tile=r_tile, k=k,
        smem_bytes=lambda lib, hp: lib.dense_bwd_v4_smem_bytes(hp, r_tile))
    dense_bwd_cuda.launches += 1
    return res


dense_bwd_cuda.launches = 0


def dense_bwd(bits, g_pass, e_t_c, w_e_c, d_op_o, order, row_ptr, *,
              r_tile: int, k: int):
    """The dense backward kernels' wrapper: a CUDA tensor launches them (or
    raises), a CPU tensor takes the plain version."""
    fn = dense_bwd_cuda if bits.is_cuda else dense_bwd_plain
    return fn(bits, g_pass, e_t_c, w_e_c, d_op_o, order, row_ptr,
              r_tile=r_tile, k=k)


# ---------------------------------------------------------------------------
# overflow part, the pieces the windowed path shares, autograd Function and
# entry point
# ---------------------------------------------------------------------------

def _overflow_operand(x_c, w_s_c, e_ovf_c, w_e_c, ovf_s) -> torch.Tensor:
    """The windowed path's overflow operands [Eo, H] float32: the overflow
    senders gathered at node width and projected, plus their edge
    projection."""
    return matmul_f32(x_c[ovf_s.long()], w_s_c, x_c.dtype) \
        + matmul_f32(e_ovf_c, w_e_c, e_ovf_c.dtype)


def overflow_maxima(op_o: torch.Tensor, ovf_r: torch.Tensor,
                    num_nodes: int) -> torch.Tensor:
    """Scatter-max of the overflow operands [Eo, H] to raw per-node maxima
    [num_nodes, H] float32, _NEG for receivers without overflow edges
    (padding entries, ovf_r < 0, carry _NEG and so never win)."""
    mask = ovf_r >= 0
    y = torch.where(mask[:, None], op_o, _NEG)
    idx = torch.where(mask, ovf_r, 0).long()[:, None].expand_as(y)
    out = torch.full((num_nodes, y.shape[1]), _NEG, dtype=torch.float32,
                     device=y.device)
    return out.scatter_reduce_(0, idx, y, "amax", include_self=False)


def dense_overflow_inner(x_c, w_s_c, e_ovf_c, w_e_c, ovf_s, ovf_r,
                         num_nodes: int) -> torch.Tensor:
    """The JAX package's `dense_overflow_inner` (the windowed path's
    overflow): gather the overflow senders at node width, project, and
    scatter-max."""
    return overflow_maxima(
        _overflow_operand(x_c, w_s_c, e_ovf_c, w_e_c, ovf_s), ovf_r,
        num_nodes)


def dense_overflow_operand(y_s, e_ovf_c, w_e_c, ovf_s) -> torch.Tensor:
    """The dense path's overflow operands [Eo, H] float32 from the node
    projection, y_s[ovf_s] + e_ovf @ w_e: the slots' operand function."""
    return y_s[ovf_s.long(), :w_e_c.shape[1]] \
        + matmul_f32(e_ovf_c, w_e_c, e_ovf_c.dtype)


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


def project_operands(x, w_s, e_t, w_e, e_ovf, ovf_s, ovf_r, num_nodes: int):
    """The projection and the overflow side of a bits-routed forward
    (dense and windowed), on operands in the gather dtype: y_s = x @ w_s
    (`dense_proj`), the overflow operands op_o = y_s[ovf_s] + e_ovf @ w_e
    and their maxima inner_o [num_nodes, H] float32, and the depth-padded
    (e_t, w_e) the gather-max kernels take. Returns (y_s, op_o, inner_o,
    e_p, w_e_p)."""
    cd = gather_dtype(x.device)
    x_p, w_s_p = _pad_depth(x.to(cd), w_s.to(cd))
    e_p, w_e_p = _pad_depth(e_t.to(cd), w_e.to(cd))
    y_s = dense_proj(x_p, w_s_p)
    op_o = dense_overflow_operand(y_s, e_ovf.to(cd), w_e.to(cd), ovf_s)
    return y_s, op_o, overflow_maxima(op_o, ovf_r, num_nodes), e_p, w_e_p


def _forward(x, w_s, e_t, w_e, offset, e_ovf, tile_win, senders_local,
             ovf_s, ovf_r, geo, emit_inner: bool):
    """The forward on gather-dtype operands: the projection, the overflow
    operands and maxima, the gather-max. Returns (the gather-max wrapper's
    result, the overflow operands, the depth-padded (e_t, w_e))."""
    r_tile, k, node_block, bf16_max = geo
    y_s, op_o, inner_o, e_p, w_e_p = project_operands(
        x, w_s, e_t, w_e, e_ovf, ovf_s, ovf_r, offset.shape[0])
    res = dense_fwd(y_s, e_p, w_e_p, senders_local.contiguous(),
                    tile_win.contiguous(), inner_o,
                    offset.float().contiguous(), r_tile=r_tile, k=k,
                    node_block=node_block, emit_inner=emit_inner,
                    bf16_max=bf16_max)
    return res, op_o, (e_p, w_e_p)


def routed_backward(g, inner, op_o, ovf_r, x, w_s, w_e, e_ovf, dtypes,
                    slot_backward, round_sums: bool, bf16_max: bool = False,
                    ovf_landing=None) -> tuple:
    """The custom VJP body of a bits-routed aggregation (dense and
    windowed): g and inner zeroed at empty receivers; the overflow rows
    routed on the forward's own operands (bf16 with `bf16_max`, as the
    slots' bits); the kernels' part `slot_backward(g_pass, d_op_o) ->
    (d_e_t, dW_e, d_ys, d_yo)` (padded depth, d_e_t in the gather dtype);
    then d_x and dW_s as node-wide products of the sender sums. With
    `round_sums` (the dense path) the slots' sums meet W_s and x in the
    gather dtype and the overflow's in float32, as the JAX package's dense
    `sender_dx` wrapper forms them, or with `ovf_landing` (the dense
    path's `ovf_ssum`: (order, row_ptr) of the overflow rows by sender)
    the overflow part of d_x is each row's bf16(bf16(d_op_o) @
    bf16(w_s)^T) landed by the segment-sum kernel, as its wrapper forms it
    under that flag; without `round_sums` (the windowed path), (d_ys +
    d_yo) @ W_s^T and x^T (d_ys + d_yo) in float32, as its windowed
    wrapper does. Returns the gradients of (x, w_s, e_t, w_e, offset,
    e_ovf) in their inputs' dtypes."""
    x_dtype, e_dtype, e_ovf_dtype, offset_dtype = dtypes
    de = w_e.shape[0]
    has = inner > _NEG / 2
    g_pass = torch.where(has, g.float(), 0.0)
    inner_z = torch.where(has, inner, 0.0)
    mask = ovf_r >= 0
    recv = torch.where(mask, ovf_r, 0).long()
    d_op_o = torch.where(
        mask[:, None] & _routes(op_o, inner_z[recv], bf16_max),
        g_pass[recv], 0.0)
    d_e_t, d_we, d_ys, d_yo = slot_backward(g_pass, d_op_o)
    if round_sums:
        cd = d_e_t.dtype
        d_x = matmul_f32(d_ys, w_s.t(), cd)
        if ovf_landing is None:
            d_x = d_x + d_yo @ w_s.float().t()
        else:
            d_xo = matmul_f32(d_op_o, w_s.t(), cd).to(cd)
            d_x = d_x + segment_sum.segment_sum_csr(d_xo, *ovf_landing)
        d_ws = matmul_f32(x.t(), d_ys, cd) + x.float().t() @ d_yo
    else:
        d_y = d_ys + d_yo
        d_x = d_y @ w_s.float().t()
        d_ws = x.float().t() @ d_y
    d_we = d_we[:de] + e_ovf.float().t() @ d_op_o
    d_e_ovf = (d_op_o @ w_e.float().t()).to(e_ovf_dtype)
    return (d_x.to(x_dtype), d_ws.to(w_s.dtype), d_e_t[:, :de].to(e_dtype),
            d_we.to(w_e.dtype), g_pass.to(offset_dtype), d_e_ovf)


class DenseAggregateFn(torch.autograd.Function):
    """The dense aggregation with its custom VJP (module docstring)."""

    @staticmethod
    def forward(ctx, x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                senders_local, ovf_s, ovf_r, order, row_ptr, geo,
                ovf_order=None, ovf_row_ptr=None):
        (out, inner, bits), op_o, padded = _forward(
            x, w_s, e_t, w_e, offset, e_ovf, tile_win, senders_local, ovf_s,
            ovf_r, geo, emit_inner=True)
        ctx.geo = geo
        ctx.dtypes = (x.dtype, e_t.dtype, e_ovf.dtype, offset.dtype)
        ctx.ovf_ssum = ovf_order is not None
        ovf_landing = (ovf_order, ovf_row_ptr) if ctx.ovf_ssum else ()
        ctx.save_for_backward(x, w_s, w_e, e_ovf, *padded, bits, op_o,
                              ovf_r, order, row_ptr, inner, *ovf_landing)
        return out

    @staticmethod
    def backward(ctx, g):
        (x, w_s, w_e, e_ovf, e_p, w_e_p, bits, op_o, ovf_r, order, row_ptr,
         inner, *ovf_landing) = ctx.saved_tensors
        r_tile, k, _, bf16_max = ctx.geo

        def slot_backward(g_pass, d_op_o):
            return dense_bwd(bits, g_pass, e_p, w_e_p, d_op_o, order,
                             row_ptr, r_tile=r_tile, k=k)

        return routed_backward(g, inner, op_o, ovf_r, x, w_s, w_e, e_ovf,
                               ctx.dtypes, slot_backward, round_sums=True,
                               bf16_max=bf16_max,
                               ovf_landing=ovf_landing or None) \
            + (None,) * 9


def dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                    senders_local, ovf_s, ovf_r, *, r_tile: int, k: int,
                    node_block: int, landing=None, bf16_max: bool = False,
                    ovf_landing=None) -> torch.Tensor:
    """The dense fused aggregation (module docstring), with the argument
    order of the JAX package's fused function (less part_mask: the landing
    replaces it). Differentiable in x, w_s, e_t, w_e, offset and e_ovf;
    the backward needs `landing` (an `ops.segment_sum.SenderLanding`, the
    batch's `FlatTiling.landing`). `bf16_max` routes the backward by bf16
    equality (the forward is unchanged); `ovf_landing` (the batch's
    `FlatTiling.ovf_landing`, built under `ovf_ssum`) lands the overflow
    part of d_x through the segment-sum kernel, as the JAX package's
    `ovf_ssum` does."""
    num_nodes = offset.shape[0]
    if num_nodes % r_tile:
        raise ValueError(f"num_nodes {num_nodes} not divisible by "
                         f"r_tile {r_tile}")
    geo = (r_tile, k, node_block, bool(bf16_max))
    needs_grad = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w_s, e_t, w_e, offset, e_ovf))
    if not needs_grad:
        out, _, _ = _forward(x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                             senders_local, ovf_s, ovf_r, geo,
                             emit_inner=False)
        return out
    if landing is None:
        raise ValueError("the dense aggregation's backward needs the batch's "
                         "sender landing (FlatTiling.landing, built by "
                         "stack_samples)")
    return DenseAggregateFn.apply(x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                                  senders_local, ovf_s, ovf_r, landing.order,
                                  landing.row_ptr, geo,
                                  *(ovf_landing or ()))
