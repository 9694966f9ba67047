"""Message-passing convolution layers (MPNNConv, RadarPointGNNConv).

Port of `radargnn_tpu/models/layers.py`. Message order follows PyG
flow="source_to_target": for an edge (s, r) the message is
pre_mlp([x_r ‖ x_s ‖ e]) and it aggregates at the receiver r. With a single
linear pre-MLP and max aggregation (the hoisted configuration) the
receiver projection and the bias are constant per receiver and commute
with the max:

    aggr_r = (x @ W_r)[r] + b + max_e((x @ W_s)[s] + e @ W_e)

(0 for receivers without in-edges). With a dense tiling (kNN graphs) the
max runs in the dense aggregation (`ops.dense_aggregate`), with a windowed
tiling (radius graphs, or any graph under `fused_tiling: "windowed"`) in
the windowed aggregation (`ops.windowed_aggregate`), with the CSR tiling
(`fused_tiling: "csr"`) in the CSR aggregation (`ops.csr_aggregate`),
each a pair of CUDA kernels on the card; without a tiling it is a masked
segment max over the edge list. The dense and windowed backwards route by
bf16 equality under `bf16_max` (the config's `fused_bf16_max`, or
RADARGNN_FUSED_BF16_MAX); the CSR path routes strictly, as the JAX
package's v2 kernels take no such flag.

Any other configuration (a pre-MLP of several layers, or a mean, add or
sum aggregation) computes every message with `SplitPreMLP` and reduces it
with the segment family (`ops.segment`, `_AggregationMixin`), as the JAX
package does.

Under halo partitioning (`halo=`, a rank's `parallel.halo_windowed.
HaloBundle`) the hoisted max runs through `halo_hoisted_max_batched`: the
rank's node rows, one exchange of the boundary senders over the mesh's
model axis, then the dense or the windowed aggregation per rank. It needs
the hoisted configuration (and, for MPNNConv, no conv edge encoder), as
in the JAX package, whose message for each conv `_check_halo` gives.
RadarPointGNNConv's offset there is its pre-MLP bias broadcast over the
rank's rows, as on one card.
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import torch
from torch import nn

from radargnn_tpu_torch.models.mlp import (
    LinearReluStack, TorchLinear, compute_dtype, matmul_f32,
)
from radargnn_tpu_torch.models.split_mlp import PreMLPParams, SplitPreMLP
from radargnn_tpu_torch.ops.csr_aggregate import csr_aggregate
from radargnn_tpu_torch.ops.dense_aggregate import dense_aggregate
from radargnn_tpu_torch.ops.segment import hoisted_segment_max, \
    segment_reduce
from radargnn_tpu_torch.ops.windowed_aggregate import windowed_aggregate
from radargnn_tpu_torch.parallel.halo_windowed import (
    halo_hoisted_max_batched,
)

# The JAX package's env knobs (radargnn_tpu/models/layers.py), read at
# import with its names and defaults, so both packages tile a frame alike
# and accept or refuse it alike. Geometry: node blocks of the sender
# windows, slots per windowed tile, window width in node blocks, receivers
# per dense tile, dense slots per receiver over the kNN k (+4 keeps the
# over-degree spill ~2.4% at the flagship degree profile), and the spread
# tiling's run cap ("" / unset: the config's fused_run_cap; "0": contiguous
# runs).
FUSED_NODE_BLOCK = int(os.environ.get("RADARGNN_FUSED_NODE_BLOCK", 256))
FUSED_EDGE_TILE = int(os.environ.get("RADARGNN_FUSED_EDGE_TILE", 512))
FUSED_WINDOW_BLOCKS = int(os.environ.get("RADARGNN_FUSED_WINDOW_BLOCKS", 3))
FUSED_DENSE_R_TILE = int(os.environ.get("RADARGNN_FUSED_DENSE_R_TILE", 64))
FUSED_DENSE_EXTRA_SLOTS = int(
    os.environ.get("RADARGNN_FUSED_DENSE_EXTRA_SLOTS", 4))
_RUN_CAP_ENV = os.environ.get("RADARGNN_FUSED_RUN_CAP")
# bf16-equality max routing of the dense and windowed backwards: None
# follows the config's fused_bf16_max, "1" forces it on, any other value
# off (strict routing)
BF16_MAX_ENV = os.environ.get("RADARGNN_FUSED_BF16_MAX")
# the dense backward lands the overflow part of d_x through the segment-sum
# kernel over the batch's sender-sorted overflow tiling, which
# fused_csr_tiling then asks the batch to carry (the JAX package's
# ovf_ssum; off by default, as there)
OVF_SSUM = os.environ.get("RADARGNN_FUSED_OVF_SSUM", "0") == "1"
# the windowed kernels' variant knobs, read as the JAX package reads them
# ("1" on, any other value off). They act only on the single-card windowed
# path under bf16_max (windowed_landing); the dense, CSR and halo paths
# ignore them. Of the three only bf16_landing changes what is computed
# (the forward's windowed maxima landed in bf16, a launch flag of B4's
# gather-max). stream_m streams the TPU forward's bf16 operand into its
# backward, which then routes on the forward's own values: the port's B4
# backward routes on the forward's bits and has the sender-sum form
# always, so it computes that already. precomp_land streams the TPU
# landing's one-hot from HBM and counts only together with bf16_landing,
# whose values it gives.
STREAM_M = os.environ.get("RADARGNN_FUSED_STREAM_M", "0") == "1"
BF16_LANDING = os.environ.get("RADARGNN_FUSED_BF16_LANDING", "0") == "1"
PRECOMP_LAND = os.environ.get("RADARGNN_FUSED_PRECOMP_LAND", "0") == "1"
# RADARGNN_FUSED_SENDER_DX (the sender-sum backward) changes nothing here:
# the dense and windowed backward have that form always (their d_x and
# dW_s are node-wide products of the H-wide sender sums), and the CSR
# path's JAX kernels ignore it.
# RADARGNN_FUSED_{PRECOMP_EQ,PRECOMP_EQT,EQ_MIN_WIDTH,DENSE_XLA_MAX_WIDTH}
# choose how the TPU streams its one-hot gathers and whether narrow dense
# layers run as XLA; they compute the same forward (the XLA fallback's
# autodiff splits g among exactly tied slots, where the kernels give each
# the full g), a gather here is an indexed load, and the port reads none
# of them (ROADMAP.md B (iii)).


def windowed_landing(bf16_max: bool) -> bool:
    """Whether the single-card windowed forward lands its maxima in bf16:
    RADARGNN_FUSED_BF16_LANDING under `bf16_max` routing. A variant knob
    set without `bf16_max` warns as the JAX package does and runs the
    baseline kernels."""
    if (STREAM_M or BF16_LANDING or PRECOMP_LAND) and not bf16_max:
        warnings.warn(
            "RADARGNN_FUSED_{STREAM_M,BF16_LANDING,PRECOMP_LAND} require "
            "bf16_max routing (fused_bf16_max=True or "
            "RADARGNN_FUSED_BF16_MAX=1); ignoring the variant knobs and "
            "running the baseline kernels", stacklevel=3)
        return False
    return BF16_LANDING


def bf16_max_routing(flag: bool) -> bool:
    """Whether the fused backwards route by bf16 equality: the config's
    `fused_bf16_max` (`flag`), unless RADARGNN_FUSED_BF16_MAX overrides
    it."""
    return flag if BF16_MAX_ENV is None else BF16_MAX_ENV == "1"


def fused_csr_tiling(model_config, k=None):
    """`stack_samples` tiling spec for a GNNArchitectureConfig, or None when
    the fused path is off. `fused_tiling` "dense" (or "auto" with the kNN
    degree `k` given) returns the dense tiling dict; "windowed" (or "auto"
    without `k`: radius graphs) the windowed tuple (node_block, edge_tile,
    window_blocks, fused_overflow_fraction[, fused_run_cap]); "csr" the
    CSR tuple (node_block, edge_tile), for any graph. The geometry follows
    the env knobs as in the JAX package (RADARGNN_FUSED_OVF_SSUM asks the
    dense tiling for its sender-sorted overflow tiling)."""
    if not getattr(model_config, "use_fused_aggregation", False):
        return None
    mode = getattr(model_config, "fused_tiling", "windowed")
    if mode == "auto":
        mode = "dense" if k is not None else "windowed"
    if mode not in ("dense", "windowed", "csr"):
        raise ValueError(f'unknown fused_tiling "{mode}": "auto", "dense", '
                         '"windowed" or "csr"')
    if mode == "csr":
        return (FUSED_NODE_BLOCK, FUSED_EDGE_TILE)
    if mode == "windowed":
        tiling = (FUSED_NODE_BLOCK, FUSED_EDGE_TILE, FUSED_WINDOW_BLOCKS,
                  getattr(model_config, "fused_overflow_fraction", 0.05))
        run_cap = getattr(model_config, "fused_run_cap", None)
        if _RUN_CAP_ENV:
            run_cap = int(_RUN_CAP_ENV) or None
        return tiling if run_cap is None else tiling + (run_cap,)
    if k is None:
        raise ValueError('fused_tiling "dense" needs the kNN degree k '
                         "(graph_construction.k); pass it to "
                         "fused_csr_tiling")
    # the dense overflow carries the over-degree spill ON TOP of the window
    # overflow the config fraction budgets for, hence the +0.03
    return {"mode": "dense", "node_block": FUSED_NODE_BLOCK,
            "r_tile": FUSED_DENSE_R_TILE,
            "k": int(k) + FUSED_DENSE_EXTRA_SLOTS,
            "window_blocks": FUSED_WINDOW_BLOCKS, "ovf_ssum": OVF_SSUM,
            "ovf_frac": getattr(model_config, "fused_overflow_fraction",
                                0.05) + 0.03}


def _fused_hoisted_max(x, w_s, w_e, offset, tiling,
                       bf16_max: bool) -> torch.Tensor:
    """Hoisted max aggregation over the batch's tiling: the dense
    aggregation for a dense tiling, the windowed one for a tiling with
    sender windows, the CSR one otherwise (each backward lands d_x through
    the batch's sender landing). The dense and windowed backwards route
    by bf16 equality with `bf16_max`; the dense one lands its overflow d_x
    through the batch's overflow landing where the batch has one and
    OVF_SSUM is on. The windowed forward lands its maxima in bf16 where
    `windowed_landing` says so."""
    if tiling.win is None:
        return csr_aggregate(x, w_s, tiling.edge_feat, w_e, tiling.senders,
                             tiling.receivers, tiling.blocks, offset,
                             node_block=tiling.node_block,
                             edge_tile=tiling.edge_tile,
                             landing=tiling.landing)
    sloc, t_win, _, ovf_s, ovf_r, ovf_e = tiling.win
    if tiling.dense is not None:
        r_tile, k = tiling.dense
        return dense_aggregate(
            x, w_s, tiling.edge_feat, w_e, offset, ovf_e, t_win, sloc,
            ovf_s, ovf_r, r_tile=r_tile, k=k, node_block=tiling.node_block,
            landing=tiling.landing, bf16_max=bf16_max,
            ovf_landing=tiling.ovf_landing if OVF_SSUM else None)
    return windowed_aggregate(x, w_s, tiling.edge_feat, w_e, offset, ovf_e,
                              tiling.receivers, tiling.blocks, t_win, sloc,
                              ovf_s, ovf_r, node_block=tiling.node_block,
                              edge_tile=tiling.edge_tile,
                              landing=tiling.landing, bf16_max=bf16_max,
                              bf16_landing=windowed_landing(bf16_max))


def _check_halo(conv) -> None:
    """Refuses a conv the halo partition cannot take, with the JAX
    package's message for its type (MPNNConv also names the conv edge
    encoder, which RadarPointGNNConv does not have)."""
    if isinstance(conv, MPNNConv):
        if not conv.hoisted or conv.edge_encoder is not None:
            raise ValueError("halo partitioning requires the hoisted "
                             "configuration: single linear pre-MLP, max "
                             "aggregation, no conv edge encoder")
    elif not conv.hoisted:
        raise ValueError("halo partitioning requires the hoisted "
                         "configuration: single linear pre-MLP and max "
                         "aggregation")


def is_hoisted(pre_layers: int, aggr: str) -> bool:
    """Whether a conv takes the hoisted max path (and the fused kernels
    where the batch is tiled): one linear pre-MLP and max aggregation."""
    return pre_layers == 1 and aggr == "max"


class _AggregationMixin:
    """The masked aggregation of full messages: max in the compute dtype
    (exact in bf16), sum and mean in float32; a float32 result."""

    def _aggregate(self, m, receivers, num_nodes, edge_mask):
        data = m
        if self.dtype != torch.float32 and self.aggr == "max":
            data = m.to(self.dtype)
        return segment_reduce(self.aggr, data, receivers, num_nodes,
                              edge_mask).float()


class MPNNConv(_AggregationMixin, nn.Module):
    """General MPNN layer with edge features.

    message  m_sr = pre_mlp([x_r ‖ x_s ‖ e_sr])   (edge encoder optional)
    aggregate     = perm-invariant reduce (default max) over incoming edges
    update   h_r  = post_mlp([x_r ‖ aggr_r])
    """

    def __init__(self, in_channels: int, edge_dim: int, out_channels: int,
                 aggr: str = "max", pre_layers: int = 1,
                 post_layers: int = 1, use_edge_encoder: bool = False,
                 dtype: str = "float32", bf16_max: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr = aggr
        self.hoisted = is_hoisted(pre_layers, aggr)
        self.bf16_max = bf16_max
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
        if self.hoisted:
            self.pre_mlp = PreMLPParams(pre_mlp_dim, pre_mlp_dim, generator)
        else:
            self.pre_mlp = SplitPreMLP(
                [pre_mlp_dim] * pre_layers, in_channels, self.edge_feat_dim,
                include_receiver=True, dtype=dtype, generator=generator)
        self.post_mlp = LinearReluStack(in_channels + pre_mlp_dim,
                                        [out_channels] * post_layers, dtype,
                                        generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                tiling=None, halo=None):
        num_nodes = x.shape[0]
        if halo is not None:
            _check_halo(self)
        if self.edge_encoder is not None:
            edge_attr = self.edge_encoder(edge_attr)
            if tiling is not None and self.hoisted:
                win = tiling.win
                if win is not None:
                    # the overflow edges ride the same encoder
                    win = win[:5] + (self.edge_encoder(win[5]),)
                tiling = tiling._replace(
                    edge_feat=self.edge_encoder(tiling.edge_feat), win=win)
        if not self.hoisted:
            m = self.pre_mlp(x, senders, receivers, edge_attr)
            aggr = self._aggregate(m, receivers, num_nodes, edge_mask)
            return self.post_mlp(torch.cat([x, aggr], dim=-1))
        lin = self.pre_mlp.lin_0
        d = self.in_channels
        w = lin.weight.t()                          # [in, out], flax layout
        w_r, w_s, w_e = w[:d], w[d:2 * d], w[2 * d:]
        offset = matmul_f32(x, w_r, self.dtype) + lin.bias
        if halo is not None:
            aggr = halo_hoisted_max_batched(x, w_s, w_e, offset, halo,
                                            bf16_max_routing(self.bf16_max))
        elif tiling is not None:
            aggr = _fused_hoisted_max(x, w_s, w_e, offset, tiling,
                                      bf16_max_routing(self.bf16_max))
        else:
            y_s = matmul_f32(x, w_s, self.dtype).to(self.dtype)
            y_e = matmul_f32(edge_attr, w_e, self.dtype).to(self.dtype)
            aggr = hoisted_segment_max(y_s[senders.long()] + y_e, receivers,
                                       num_nodes, edge_mask, offset)
        return self.post_mlp(torch.cat([x, aggr], dim=-1))


class RadarPointGNNConv(_AggregationMixin, nn.Module):
    """Residual Radar-PointGNN variant: message pre_mlp([x_s ‖ e]); update
    post_mlp([x ‖ m]) + x. Output dim equals input dim."""

    def __init__(self, node_dim: int, edge_dim: int, aggr: str = "max",
                 pre_layers: int = 1, post_layers: int = 1,
                 dtype: str = "float32", bf16_max: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.aggr = aggr
        self.hoisted = is_hoisted(pre_layers, aggr)
        self.bf16_max = bf16_max
        self.in_channels = self.node_dim = node_dim
        self.edge_feat_dim = edge_dim
        self.dtype = compute_dtype(dtype)
        pre_mlp_dim = node_dim + edge_dim
        if self.hoisted:
            self.pre_mlp = PreMLPParams(pre_mlp_dim, pre_mlp_dim, generator)
        else:
            self.pre_mlp = SplitPreMLP(
                [pre_mlp_dim] * pre_layers, node_dim, edge_dim,
                include_receiver=False, dtype=dtype, generator=generator)
        self.post_mlp = LinearReluStack(node_dim + pre_mlp_dim,
                                        [node_dim] * post_layers, dtype,
                                        generator)

    def forward(self, x, senders, receivers, edge_attr, edge_mask=None,
                tiling=None, halo=None):
        num_nodes = x.shape[0]
        if halo is not None:
            _check_halo(self)
        if not self.hoisted:
            m = self.pre_mlp(x, senders, receivers, edge_attr)
            aggr = self._aggregate(m, receivers, num_nodes, edge_mask)
            return self.post_mlp(torch.cat([x, aggr], dim=-1)) + x
        lin = self.pre_mlp.lin_0
        w = lin.weight.t()
        w_s, w_e = w[:self.node_dim], w[self.node_dim:]
        # no receiver term: the bias alone is the hoisted offset, a
        # stride-0 view whose gradient autograd sums over the rows into the
        # bias (under a halo bundle, this rank's rows; the trainer sums the
        # ranks). The aggregations copy it before a launch: the wrappers
        # make it contiguous, and the halo paths pad it to the augmented
        # rows (`parallel.halo_dense.augmented_rows`)
        offset = lin.bias.expand(num_nodes, -1)
        if halo is not None:
            aggr = halo_hoisted_max_batched(x, w_s, w_e, offset, halo,
                                            bf16_max_routing(self.bf16_max))
        elif tiling is not None:
            aggr = _fused_hoisted_max(x, w_s, w_e, offset, tiling,
                                      bf16_max_routing(self.bf16_max))
        else:
            operand = matmul_f32(x, w_s, self.dtype).to(self.dtype)[
                senders.long()] \
                + matmul_f32(edge_attr, w_e, self.dtype).to(self.dtype)
            aggr = hoisted_segment_max(operand, receivers, num_nodes,
                                       edge_mask, offset)
        h = self.post_mlp(torch.cat([x, aggr], dim=-1))
        return h + x
