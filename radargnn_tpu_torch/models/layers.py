"""Message-passing convolution layers (MPNNConv, RadarPointGNNConv).

Port of `radargnn_tpu/models/layers.py` on its hoisted path. Message order
follows PyG flow="source_to_target": for an edge (s, r) the message is
pre_mlp([x_r ‖ x_s ‖ e]) and it aggregates at the receiver r. With a single
linear pre-MLP and max aggregation the receiver projection and the bias are
constant per receiver and commute with the max:

    aggr_r = (x @ W_r)[r] + b + max_e((x @ W_s)[s] + e @ W_e)

(0 for receivers without in-edges). With a dense tiling (kNN graphs) the
max runs in the dense aggregation (`ops.dense_aggregate`), with a windowed
tiling (radius graphs, or any graph under `fused_tiling: "windowed"`) in
the windowed aggregation (`ops.windowed_aggregate`), with the CSR tiling
(`fused_tiling: "csr"`) in the CSR aggregation (`ops.csr_aggregate`),
each a pair of CUDA kernels on the card; without a tiling it is a masked
segment max over the edge list.

The multi-layer pre-MLP (`SplitPreMLP`) and halo partitioning are not
ported yet and raise (ROADMAP.md).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from radargnn_tpu_torch.models.mlp import (
    LinearReluStack, TorchLinear, compute_dtype, matmul_f32,
)
from radargnn_tpu_torch.ops.csr_aggregate import csr_aggregate
from radargnn_tpu_torch.ops.dense_aggregate import dense_aggregate
from radargnn_tpu_torch.ops.segment import hoisted_segment_max
from radargnn_tpu_torch.ops.windowed_aggregate import windowed_aggregate

# tiling geometry, the JAX package's defaults: node blocks of the sender
# windows, slots per windowed tile, receivers per dense tile, dense slots
# per receiver over the kNN k (+4 keeps the over-degree spill ~2.4% at the
# flagship degree profile), and window width in node blocks
FUSED_NODE_BLOCK = 256
FUSED_EDGE_TILE = 512
FUSED_DENSE_R_TILE = 64
FUSED_DENSE_EXTRA_SLOTS = 4
FUSED_WINDOW_BLOCKS = 3


def fused_csr_tiling(model_config, k=None):
    """`stack_samples` tiling spec for a GNNArchitectureConfig, or None when
    the fused path is off. `fused_tiling` "dense" (or "auto" with the kNN
    degree `k` given) returns the dense tiling dict; "windowed" (or "auto"
    without `k`: radius graphs) the windowed tuple (node_block, edge_tile,
    window_blocks, fused_overflow_fraction[, fused_run_cap]); "csr" the
    CSR tuple (node_block, edge_tile), for any graph."""
    if not getattr(model_config, "use_fused_aggregation", False):
        return None
    mode = getattr(model_config, "fused_tiling", "windowed")
    if mode == "auto":
        mode = "dense" if k is not None else "windowed"
    if mode == "csr":
        return (FUSED_NODE_BLOCK, FUSED_EDGE_TILE)
    if mode == "windowed":
        tiling = (FUSED_NODE_BLOCK, FUSED_EDGE_TILE, FUSED_WINDOW_BLOCKS,
                  getattr(model_config, "fused_overflow_fraction", 0.05))
        run_cap = getattr(model_config, "fused_run_cap", None)
        return tiling if run_cap is None else tiling + (run_cap,)
    if mode != "dense":
        raise ValueError(f'unknown fused_tiling "{mode}": "auto", "dense", '
                         '"windowed" or "csr"')
    if k is None:
        raise ValueError('fused_tiling "dense" needs the kNN degree k '
                         "(graph_construction.k); pass it to "
                         "fused_csr_tiling")
    # the dense overflow carries the over-degree spill ON TOP of the window
    # overflow the config fraction budgets for, hence the +0.03
    return {"mode": "dense", "node_block": FUSED_NODE_BLOCK,
            "r_tile": FUSED_DENSE_R_TILE,
            "k": int(k) + FUSED_DENSE_EXTRA_SLOTS,
            "window_blocks": FUSED_WINDOW_BLOCKS,
            "ovf_frac": getattr(model_config, "fused_overflow_fraction",
                                0.05) + 0.03}


def _fused_hoisted_max(x, w_s, w_e, offset, tiling) -> torch.Tensor:
    """Hoisted max aggregation over the batch's tiling: the dense
    aggregation for a dense tiling, the windowed one for a tiling with
    sender windows, the CSR one otherwise (each backward lands d_x through
    the batch's sender landing)."""
    if tiling.win is None:
        return csr_aggregate(x, w_s, tiling.edge_feat, w_e, tiling.senders,
                             tiling.receivers, tiling.blocks, offset,
                             node_block=tiling.node_block,
                             edge_tile=tiling.edge_tile,
                             landing=tiling.landing)
    sloc, t_win, _, ovf_s, ovf_r, ovf_e = tiling.win
    if tiling.dense is not None:
        r_tile, k = tiling.dense
        return dense_aggregate(x, w_s, tiling.edge_feat, w_e, offset, ovf_e,
                               t_win, sloc, ovf_s, ovf_r, r_tile=r_tile, k=k,
                               node_block=tiling.node_block,
                               landing=tiling.landing)
    return windowed_aggregate(x, w_s, tiling.edge_feat, w_e, offset, ovf_e,
                              tiling.receivers, tiling.blocks, t_win, sloc,
                              ovf_s, ovf_r, node_block=tiling.node_block,
                              edge_tile=tiling.edge_tile,
                              landing=tiling.landing)


def _check_hoisted(pre_layers: int, aggr: str) -> None:
    if pre_layers != 1 or aggr != "max":
        raise NotImplementedError(
            "only the hoisted configuration (conv_pre_mlp_layer_number 1, "
            "aggregation 'max') is ported; the SplitPreMLP path waits for "
            "ROADMAP.md item A3")


class PreMLP(nn.Module):
    """Holds the single pre-MLP Linear under the `pre_mlp.lin_0` name."""

    def __init__(self, fan_in: int, features: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.lin_0 = TorchLinear(fan_in, features, generator=generator)


class MPNNConv(nn.Module):
    """General MPNN layer with edge features.

    message  m_sr = pre_mlp([x_r ‖ x_s ‖ e_sr])   (edge encoder optional)
    aggregate     = max over incoming edges
    update   h_r  = post_mlp([x_r ‖ aggr_r])
    """

    def __init__(self, in_channels: int, edge_dim: int, out_channels: int,
                 aggr: str = "max", pre_layers: int = 1,
                 post_layers: int = 1, use_edge_encoder: bool = False,
                 dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_hoisted(pre_layers, aggr)
        self.in_channels = in_channels
        # width of the edge features the aggregation reads
        self.edge_feat_dim = in_channels if use_edge_encoder else edge_dim
        self.dtype = compute_dtype(dtype)
        if use_edge_encoder:
            self.edge_encoder = TorchLinear(edge_dim, in_channels, dtype,
                                            generator)
            pre_mlp_dim = 3 * in_channels
        else:
            self.edge_encoder = None
            pre_mlp_dim = 2 * in_channels + edge_dim
        self.pre_mlp = PreMLP(pre_mlp_dim, pre_mlp_dim, generator)
        self.post_mlp = LinearReluStack(in_channels + pre_mlp_dim,
                                        [out_channels] * post_layers, dtype,
                                        generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                tiling=None):
        num_nodes = x.shape[0]
        if self.edge_encoder is not None:
            edge_attr = self.edge_encoder(edge_attr)
            if tiling is not None:
                win = tiling.win
                if win is not None:
                    # the overflow edges ride the same encoder
                    win = win[:5] + (self.edge_encoder(win[5]),)
                tiling = tiling._replace(
                    edge_feat=self.edge_encoder(tiling.edge_feat), win=win)
        lin = self.pre_mlp.lin_0
        d = self.in_channels
        w = lin.weight.t()                          # [in, out], flax layout
        w_r, w_s, w_e = w[:d], w[d:2 * d], w[2 * d:]
        y_r = matmul_f32(x, w_r, self.dtype)
        if tiling is not None:
            aggr = _fused_hoisted_max(x, w_s, w_e, y_r + lin.bias, tiling)
        else:
            y_s = matmul_f32(x, w_s, self.dtype).to(self.dtype)
            y_e = matmul_f32(edge_attr, w_e, self.dtype).to(self.dtype)
            aggr = hoisted_segment_max(y_s[senders.long()] + y_e, receivers,
                                       num_nodes, edge_mask, y_r + lin.bias)
        return self.post_mlp(torch.cat([x, aggr], dim=-1))


class RadarPointGNNConv(nn.Module):
    """Residual Radar-PointGNN variant: message pre_mlp([x_s ‖ e]); update
    post_mlp([x ‖ m]) + x. Output dim equals input dim."""

    def __init__(self, node_dim: int, edge_dim: int, aggr: str = "max",
                 pre_layers: int = 1, post_layers: int = 1,
                 dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        _check_hoisted(pre_layers, aggr)
        self.in_channels = self.node_dim = node_dim
        self.edge_feat_dim = edge_dim
        self.dtype = compute_dtype(dtype)
        pre_mlp_dim = node_dim + edge_dim
        self.pre_mlp = PreMLP(pre_mlp_dim, pre_mlp_dim, generator)
        self.post_mlp = LinearReluStack(node_dim + pre_mlp_dim,
                                        [node_dim] * post_layers, dtype,
                                        generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                tiling=None):
        num_nodes = x.shape[0]
        lin = self.pre_mlp.lin_0
        w = lin.weight.t()
        w_s, w_e = w[:self.node_dim], w[self.node_dim:]
        # no receiver term: the bias alone is the hoisted offset
        offset = lin.bias.expand(num_nodes, -1)
        if tiling is not None:
            aggr = _fused_hoisted_max(x, w_s, w_e, offset, tiling)
        else:
            operand = matmul_f32(x, w_s, self.dtype).to(self.dtype)[
                senders.long()] \
                + matmul_f32(edge_attr, w_e, self.dtype).to(self.dtype)
            aggr = hoisted_segment_max(operand, receivers, num_nodes,
                                       edge_mask, offset)
        h = self.post_mlp(torch.cat([x, aggr], dim=-1))
        return h + x
