"""Dense fixed-degree hoisted max aggregation (forward, serving).

Port of the forward of `make_fused_dense_aggregate`
(`radargnn_tpu/ops/pallas_kernels.py`): with the slot layout of
`ops.dense_tiles`,

    inner[n] = max over n's in-window slots and overflow edges of
               (x[sender] @ w_s + e @ w_e)
    out[n]   = offset[n] + inner[n] for non-empty n, else 0.

On the card the slot part runs in the hand-written kernel
`csrc/dense_fwd_v4.cu` (it replaces `_fused_fwd_kernel_v4`); the overflow part
stays plain torch (`dense_overflow_inner`), as it is XLA in the JAX package.
As there, the gather operands are bf16 on the accelerator and float32 where
the JAX package runs its kernels in interpret mode (the CPU).

Only the forward is ported: the entry point refuses inputs that require
grad (the backward kernel is ROADMAP.md item B2, the training slice).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Optional

import torch

from radargnn_tpu_torch.build import nvcc_shared
from radargnn_tpu_torch.models.mlp import matmul_f32

_NEG = -3.0e38          # finite -inf stand-in: offset + inner stays finite


def _sender_index(senders_local: torch.Tensor, tile_win: torch.Tensor,
                  te: int, node_block: int) -> torch.Tensor:
    """Global sender of every slot (0 for empty slots), int64."""
    win = tile_win.long().repeat_interleave(te) * node_block
    return win + senders_local.long().clamp(min=0)


def dense_fwd_plain(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win,
                    inner_o, offset, *, r_tile: int, k: int,
                    node_block: int) -> torch.Tensor:
    """Plain torch version of the dense forward kernel: the same function
    on the same inputs (x_c, w_s_c, e_t_c, w_e_c in the gather dtype;
    inner_o, offset float32), products in float32."""
    te = r_tile * k
    h = w_s_c.shape[1]
    sender = _sender_index(senders_local, tile_win, te, node_block)
    op = matmul_f32(x_c[sender], w_s_c, x_c.dtype) \
        + matmul_f32(e_t_c, w_e_c, e_t_c.dtype)
    op = torch.where((senders_local >= 0)[:, None], op, _NEG)
    acc = op.reshape(-1, k, r_tile, h).amax(dim=1).reshape(-1, h)
    inner = torch.maximum(acc, inner_o)
    return torch.where(inner > _NEG / 2, offset + inner, 0.0)


# ---------------------------------------------------------------------------
# the CUDA kernel: build at first use, bind through ctypes
# ---------------------------------------------------------------------------

_LIB: Optional[ctypes.CDLL] = None
_LIB_LOCK = threading.Lock()
_MAX_SMEM = 232448      # bytes of shared memory a block may use on sm_90


def load_kernel() -> ctypes.CDLL:
    """Builds (nvcc, sm_90a) and binds the kernel library once per process."""
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _ = nvcc_shared("dense_fwd_v4.cu")
            lib = ctypes.CDLL(path)
            lib.dense_fwd_v4.argtypes = (
                [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8
                + [ctypes.c_void_p])
            lib.dense_fwd_v4.restype = ctypes.c_int
            lib.dense_fwd_v4_smem_bytes.argtypes = [ctypes.c_int] * 3
            lib.dense_fwd_v4_smem_bytes.restype = ctypes.c_size_t
            _LIB = lib
    return _LIB


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"dense_fwd_v4 kernel: {msg}")


def dense_fwd_cuda(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win,
                   inner_o, offset, *, r_tile: int, k: int,
                   node_block: int) -> torch.Tensor:
    """Launches `csrc/dense_fwd_v4.cu` on the current stream; raises on
    inputs the kernel does not take. Counts its launches in
    `dense_fwd_cuda.launches`."""
    dev = x_c.device
    tensors = dict(x=x_c, w_s=w_s_c, e_t=e_t_c, w_e=w_e_c,
                   senders_local=senders_local, tile_win=tile_win,
                   inner_o=inner_o, offset=offset)
    for name, ten in tensors.items():
        _check(ten.device == dev and dev.type == "cuda",
               f"{name} must be on {dev} (a CUDA device)")
        _check(ten.is_contiguous(), f"{name} must be contiguous")
    for name in ("x", "w_s", "e_t", "w_e"):
        _check(tensors[name].dtype == torch.bfloat16, f"{name} must be bf16")
    for name in ("inner_o", "offset"):
        _check(tensors[name].dtype == torch.float32, f"{name} must be float32")
    for name in ("senders_local", "tile_win"):
        _check(tensors[name].dtype == torch.int32, f"{name} must be int32")
    n_x, d = x_c.shape
    h = w_s_c.shape[1]
    e_pad, de = e_t_c.shape
    te = r_tile * k
    t = tile_win.shape[0]
    _check(w_s_c.shape == (d, h) and w_e_c.shape == (de, h),
           f"w_s {tuple(w_s_c.shape)} / w_e {tuple(w_e_c.shape)} do not "
           f"match d={d}, de={de}, h={h}")
    _check(e_pad == t * te and senders_local.shape == (e_pad,),
           f"{e_pad} slots do not match {t} tiles x {te}")
    _check(inner_o.shape == (t * r_tile, h) and offset.shape == inner_o.shape,
           f"inner_o/offset must be [{t * r_tile}, {h}]")
    _check(d % 8 == 0 and de % 8 == 0,
           f"feature widths must be multiples of 8 (d={d}, de={de})")
    _check(r_tile % 16 == 0 and 16 <= r_tile <= 128,
           f"r_tile must be a multiple of 16 in [16, 128] (got {r_tile})")
    _check(x_c.data_ptr() % 16 == 0 and e_t_c.data_ptr() % 16 == 0,
           "x and e_t must be 16-byte aligned")
    lib = load_kernel()
    _check(lib.dense_fwd_v4_smem_bytes(d, de, r_tile) <= _MAX_SMEM,
           f"d={d} needs more shared memory than a block has")
    out = torch.empty((t * r_tile, h), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.dense_fwd_v4(
            x_c.data_ptr(), w_s_c.data_ptr(), e_t_c.data_ptr(),
            w_e_c.data_ptr(), senders_local.data_ptr(), tile_win.data_ptr(),
            inner_o.data_ptr(), offset.data_ptr(), out.data_ptr(),
            n_x, d, de, h, t, r_tile, k, node_block, stream)
    if err != 0:
        raise RuntimeError(f"dense_fwd_v4 launch failed: cudaError {err}")
    dense_fwd_cuda.launches += 1
    return out


dense_fwd_cuda.launches = 0


def dense_fwd(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win, inner_o,
              offset, *, r_tile: int, k: int, node_block: int) -> torch.Tensor:
    """The dense forward kernel's wrapper: a CUDA tensor launches the
    kernel (or raises), a CPU tensor takes the plain version."""
    fn = dense_fwd_cuda if x_c.is_cuda else dense_fwd_plain
    return fn(x_c, w_s_c, e_t_c, w_e_c, senders_local, tile_win, inner_o,
              offset, r_tile=r_tile, k=k, node_block=node_block)


# ---------------------------------------------------------------------------
# overflow part and entry point
# ---------------------------------------------------------------------------

def dense_overflow_inner(x_c, w_s_c, e_ovf_c, w_e_c, ovf_s, ovf_r,
                         num_nodes: int) -> torch.Tensor:
    """Raw per-node maxima of the overflow edges, [num_nodes, H] float32,
    _NEG for receivers without overflow edges: gather the overflow senders
    at node width, project, and scatter-max (padding entries, ovf_r < 0,
    carry _NEG and so never win)."""
    mask = ovf_r >= 0
    y = matmul_f32(x_c[ovf_s.long()], w_s_c, x_c.dtype) \
        + matmul_f32(e_ovf_c, w_e_c, e_ovf_c.dtype)
    y = torch.where(mask[:, None], y, _NEG)
    idx = torch.where(mask, ovf_r, 0).long()[:, None].expand_as(y)
    out = torch.full((num_nodes, y.shape[1]), _NEG, dtype=torch.float32,
                     device=y.device)
    return out.scatter_reduce_(0, idx, y, "amax", include_self=False)


def gather_dtype(device: torch.device) -> torch.dtype:
    """bf16 on the card, as on the TPU; float32 on the CPU, as in the JAX
    package's interpret mode (the reference the CPU tests hold it to)."""
    return torch.bfloat16 if device.type == "cuda" else torch.float32


def dense_aggregate(x, w_s, e_t, w_e, offset, e_ovf, tile_win,
                    senders_local, ovf_s, ovf_r, *, r_tile: int, k: int,
                    node_block: int) -> torch.Tensor:
    """Forward of the dense fused aggregation (module docstring), with the
    argument order of the JAX package's fused function (less part_mask,
    which only the backward reads)."""
    if any(t.requires_grad for t in (x, w_s, e_t, w_e, offset, e_ovf)) \
            and torch.is_grad_enabled():
        raise NotImplementedError(
            "the dense aggregation is ported for serving only; its backward "
            "kernel is ROADMAP.md item B2 (training slice). Run under "
            "torch.no_grad().")
    num_nodes = offset.shape[0]
    if num_nodes % r_tile:
        raise ValueError(f"num_nodes {num_nodes} not divisible by "
                         f"r_tile {r_tile}")
    cd = gather_dtype(x.device)
    x_c, w_s_c, w_e_c = x.to(cd), w_s.to(cd), w_e.to(cd)
    inner_o = dense_overflow_inner(x_c, w_s_c, e_ovf.to(cd), w_e_c,
                                   ovf_s, ovf_r, num_nodes)
    x_c, w_s_c = _pad_depth(x_c, w_s_c)
    e_t_c, w_e_c = _pad_depth(e_t.to(cd), w_e_c)
    return dense_fwd(x_c, w_s_c, e_t_c, w_e_c, senders_local.contiguous(),
                     tile_win.contiguous(), inner_o,
                     offset.float().contiguous(),
                     r_tile=r_tile, k=k, node_block=node_block)


def _pad_depth(a: torch.Tensor, w: torch.Tensor):
    """Zero-pads a's columns and w's rows to a multiple of 8, the kernel's
    16-byte row loads (zeros add nothing to a @ w); contiguous copies."""
    pad = -a.shape[1] % 8
    if pad:
        a = torch.nn.functional.pad(a, (0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    return a.contiguous(), w.contiguous()
