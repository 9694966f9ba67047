"""The drift witness: the fused aggregations' plain versions with their
float32 sums re-associated.

A kernel and its plain version compute one function from the same
operands, with the same rounding points and dtypes; they differ in the
order in which they add their float32 sums. Each function here is the
plain version of the kernel wrapper of its name, with every sum that the
kernel orders differently from the plain version added in another order
(reversed), and nothing else changed: the routing rule is the plain
version's (strict float32, or bf16 with `bf16_max`, ties routed as
`dense_aggregate._routes` routes them). `smoke._witness_kernels()` puts
these where `smoke._plain_kernels()` puts the plain versions, so a
training run on them is the plain path re-associated, and its distance
from the plain path is the drift that re-association alone produces
(`trace_train --drift`).

The sums re-associated, by wrapper, and the kernel sum each stands for:

  * `dense_proj`: y_s = x @ W_s, the depth d_in reversed (the node
    projection `dense_proj_v4`);
  * `dense_fwd`, `windowed_fwd`: the edge product e_t @ W_e, the depth d_e
    reversed (the gather-max's per-slot product, B1 and B4);
  * `dense_bwd`, `windowed_bwd` (`routed_bwd`): d_e = d_op @ W_e^T, the
    depth H reversed (the `de_pass`); dW_e = e_t^T @ d_op, the slots in
    reverse order (the `dwe_pass` per-tile partials and the
    `reduce_pass`); the sender sums d_ys and d_yo, each sender's rows in
    reverse order (the `send_pass` over the landing), B2 and B4;
  * `segment_sum_csr`: each segment's rows in reverse order (B3);
  * `csr_fwd`: the projection as `dense_proj`'s where no y_s is given, the
    edge product's depth d_e reversed (B5's forward: y_s, then its
    float32 edge chain);
  * `csr_bwd`: the per-slot operand with both depths reversed, as the
    forward's (B5's routing pass forms it); d_xg = d_op @ W_s^T and d_e =
    d_op @ W_e^T, the depth H reversed (B5's slot products and routing
    pass); dW_s = x_g^T @ d_op and dW_e = e_t^T @ d_op, the slots in
    reverse order (B5's dW_s partials over the landing's sender sums, its
    dW_e partials). Its d_x landing is `segment_sum_csr`'s.

The overflow rows' forward and backward and the node-wide products after
the landing run in torch on the kernel path too, so they stay as they are.
"""

from __future__ import annotations

from typing import Optional

import torch

from radargnn_tpu_torch.models.mlp import matmul_f32
from radargnn_tpu_torch.ops import csr_aggregate as ca
from radargnn_tpu_torch.ops import dense_aggregate as da
from radargnn_tpu_torch.ops import segment_sum as ss
from radargnn_tpu_torch.ops import windowed_aggregate as wa


def depth_reversed(a: torch.Tensor, w: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """`matmul_f32(a, w, dtype)` with its depth summed in reverse order."""
    return matmul_f32(a.flip(1), w.flip(0), dtype)


def slots_reversed(a: torch.Tensor, b: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    """`matmul_f32(a.t(), b, dtype)`, a sum over the rows (slots), with the
    rows summed in reverse order."""
    return matmul_f32(a.flip(0).t(), b.flip(0), dtype)


def reversed_segments(order: torch.Tensor,
                      row_ptr: torch.Tensor) -> torch.Tensor:
    """`order` with each segment's entries (order[row_ptr[n]:row_ptr[n+1]])
    in reverse order."""
    rp = row_ptr.long()
    seg = ss.segment_ids(row_ptr)
    pos = torch.arange(order.numel(), device=order.device)
    return order[rp[seg] + rp[seg + 1] - 1 - pos]


def dense_proj(x_c, w_s_c) -> torch.Tensor:
    return da.dense_proj_plain(x_c.flip(1), w_s_c.flip(0))


def dense_fwd(y_s, e_t_c, w_e_c, *layout, **kw):
    return da.dense_fwd_plain(y_s, e_t_c.flip(1), w_e_c.flip(0), *layout,
                              **kw)


def windowed_fwd(y_s, e_t_c, w_e_c, *layout, **kw):
    return wa.windowed_fwd_plain(y_s, e_t_c.flip(1), w_e_c.flip(0), *layout,
                                 **kw)


def routed_bwd(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order, row_ptr):
    """`dense_aggregate.routed_bwd_plain` re-associated: the same d_op, its
    products and landing summed in reverse order."""
    cd = e_t_c.dtype
    h = g_pass.shape[1]
    d_op = torch.where(da.unpack_bits(bits, h), g_pass[recv], 0.0).to(cd)
    sums = ss.segment_sum_csr_plain(
        torch.nn.functional.pad(d_op.float(), (0, h)),
        reversed_segments(order, row_ptr), row_ptr,
        torch.nn.functional.pad(d_op_o, (h, 0)))
    return (depth_reversed(d_op, w_e_c.t(), cd).to(cd),
            slots_reversed(e_t_c, d_op, cd), sums[:, :h], sums[:, h:])


def dense_bwd(bits, g_pass, e_t_c, w_e_c, d_op_o, order, row_ptr, *,
              r_tile: int, k: int):
    recv = da._slot_receivers(e_t_c.shape[0], r_tile, k, g_pass.device)
    return routed_bwd(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order,
                      row_ptr)


def windowed_bwd(bits, g_pass, e_t_c, w_e_c, d_op_o, recv, order, row_ptr,
                 *, edge_tile: int):
    del edge_tile
    return routed_bwd(bits, g_pass, e_t_c, w_e_c, d_op_o,
                      recv.long().clamp(min=0), order, row_ptr)


def segment_sum_csr(a: torch.Tensor, order: torch.Tensor,
                    row_ptr: torch.Tensor, b: Optional[torch.Tensor] = None,
                    width: Optional[int] = None) -> torch.Tensor:
    return ss.segment_sum_csr_plain(a, reversed_segments(order, row_ptr),
                                    row_ptr, b, width)


def csr_fwd(x_c, w_s_c, e_c, w_e_c, *layout, y_s=None, **kw):
    if y_s is None:
        y_s = dense_proj(x_c, w_s_c)
    return ca.csr_fwd_plain(x_c, w_s_c, e_c.flip(1), w_e_c.flip(0), *layout,
                            y_s=y_s, **kw)


def csr_bwd(x_c, w_s_c, e_c, w_e_c, senders, recv, tile_blocks, inner_z,
            g_pass, *, node_block: int, edge_tile: int):
    operands = ca._slot_operands(x_c.flip(1), w_s_c.flip(0), e_c.flip(1),
                                 w_e_c.flip(0), senders, recv, tile_blocks,
                                 inner_z.shape[0], node_block, edge_tile)
    cd, f32 = x_c.dtype, torch.float32
    x_g = operands[0].flip(1)
    d_op = ca.routed_d_op(operands, inner_z, g_pass)
    d_op_c = d_op.to(cd)
    return (depth_reversed(d_op_c, w_s_c.t(), cd).to(cd),
            depth_reversed(d_op, w_e_c.t(), f32),
            slots_reversed(x_g, d_op_c, cd), slots_reversed(e_c, d_op, f32))
