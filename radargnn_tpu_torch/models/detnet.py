"""DetNet — end-to-end detection + semantic-segmentation GNN.

Port of `radargnn_tpu/models/detnet.py`: optional node/edge embedding MLPs ->
conv layers, each followed by masked BatchNorm + ReLU (edge features are
reused un-re-embedded at every layer) -> two MLP heads (classification
logits and box regression). The model runs on the flattened padded
GraphBatch ([G·N, Dn] nodes, [G·E, De] edges, global edge indices) with
validity masks.

With a tiling, dense, windowed or CSR (`batch.flat_tiling()`), and the
hoisted configuration (a single linear pre-MLP, max aggregation, either
conv type), the edge features arrive in slot order and the embedding runs
in that layout; the
overflow edge features of the dense and windowed tilings ride the same
embedding, with their own mask (and so their own BatchNorm statistics, as
in the JAX package). Those two tilings round the edge features to the
compute dtype once; the CSR tiling keeps them float32, as its kernels take
them. Any other configuration takes the unfused path, tiled batch or not,
as in the JAX package. `fused_bf16_max` (or RADARGNN_FUSED_BF16_MAX) makes
the dense and windowed backwards route by bf16 equality.

Under halo partitioning (`halo=`, a rank's `HaloBundle`; a batch's rank
shard through `forward_batch(batch, mesh)`) the node arrays are the rank's
shard-major rows and the edge features arrive in the bundle, in each
shard's slot and overflow order: the edge embedding runs there (each with
its mask), the features are rounded to the compute dtype once, and every
conv layer aggregates through the bundle. The BatchNorm statistics are the
batch's over the ranks that hold its rows (`models.mlp.batch_stats_over`,
which the trainer sets).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from radargnn_tpu_torch.configs import GNNArchitectureConfig
from radargnn_tpu_torch.device import DeviceLike, resolve_device
from radargnn_tpu_torch.graph.batch import GraphBatch
from radargnn_tpu_torch.models.layers import (
    MPNNConv, RadarPointGNNConv, is_hoisted,
)
from radargnn_tpu_torch.models.mlp import MLP, MaskedBatchNorm, compute_dtype


class DetNet(nn.Module):
    """Graph network for per-point classification + bounding-box regression.

    Built on `device` (the CUDA card by default; raises when there is none
    and no device was given), with weights drawn from `seed` through a CPU
    torch.Generator, so a seed gives the same weights on every device."""

    def __init__(self, config: GNNArchitectureConfig,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(seed)
        cfg = self.config = config
        bf16_max = getattr(cfg, "fused_bf16_max", False)
        dtype = getattr(cfg, "compute_dtype", "float32")
        bn = cfg.batch_norm_in_mlps

        x_dim = cfg.node_feature_dimension
        if cfg.initial_node_feature_embedding:
            dims = list(cfg.node_feature_embedding_layer_dimensions)
            self.node_emb_mlp = MLP(x_dim, dims[-1], dims[:-1], bn, dtype, gen)
            x_dim = dims[-1]
        e_dim = cfg.edge_feature_dimension
        if cfg.initial_edge_feature_embedding:
            dims = list(cfg.edge_feature_embedding_layer_dimensions)
            self.edge_emb_mlp = MLP(e_dim, dims[-1], dims[:-1], bn, dtype, gen)
            e_dim = dims[-1]

        self.num_conv = len(cfg.conv_layer_dimensions)
        for i, layer_dim in enumerate(cfg.conv_layer_dimensions):
            if cfg.conv_layer_type == "MPNNConv":
                conv = MPNNConv(x_dim, e_dim, layer_dim,
                                aggr=cfg.aggregation_function,
                                pre_layers=cfg.conv_pre_mlp_layer_number,
                                post_layers=cfg.conv_post_mlp_layer_number,
                                use_edge_encoder=cfg.conv_use_edge_encoder,
                                dtype=dtype, bf16_max=bf16_max,
                                generator=gen)
                x_dim = layer_dim
            elif cfg.conv_layer_type == "RadarPointGNNConv":
                conv = RadarPointGNNConv(
                    x_dim, e_dim, aggr=cfg.aggregation_function,
                    pre_layers=cfg.conv_pre_mlp_layer_number,
                    post_layers=cfg.conv_post_mlp_layer_number,
                    dtype=dtype, bf16_max=bf16_max, generator=gen)
            else:
                raise ValueError(
                    f"{cfg.conv_layer_type} is invalid GNN conv layer type. "
                    f"Chose either MPNNConv or RadarPointGNNConv")
            self.add_module(f"conv_{i}", conv)
            self.add_module(f"bn_{i}", MaskedBatchNorm(x_dim))

        cls_dims = list(cfg.classification_head_layer_dimensions)
        self.classification_head = MLP(x_dim, cls_dims[-1], cls_dims[:-1],
                                       bn, dtype, gen)
        reg_dims = list(cfg.regression_head_layer_dimensions)
        self.regression_head = MLP(x_dim, reg_dims[-1], reg_dims[:-1], bn,
                                   dtype, gen)
        self.to(device)

    @property
    def fused(self) -> bool:
        """Whether the model takes a tiled batch's fused path: the config
        asks for it and is the hoisted configuration (any other takes the
        unfused path even where the loader tiled the batch)."""
        cfg = self.config
        return bool(getattr(cfg, "use_fused_aggregation", False)) \
            and is_hoisted(cfg.conv_pre_mlp_layer_number,
                           cfg.aggregation_function)

    def forward(self, node_feat, edge_feat, senders, receivers,
                node_mask: Optional[torch.Tensor] = None,
                edge_mask: Optional[torch.Tensor] = None, tiling=None,
                halo=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """Flat forward; BatchNorm uses batch statistics in training mode."""
        cfg = self.config
        dtype = getattr(cfg, "compute_dtype", "float32")
        x, e = node_feat, edge_feat
        if not self.fused or halo is not None:
            tiling = None

        if halo is not None:
            de = halo.e_t.shape[-1]
            e_t = halo.e_t.reshape(-1, de)
            e_ovf = halo.e_ovf.reshape(-1, de)
            if cfg.initial_edge_feature_embedding:
                e_t = self.edge_emb_mlp(e_t, (halo.recv_t >= 0).reshape(-1))
                e_ovf = self.edge_emb_mlp(e_ovf,
                                          (halo.ovf_r >= 0).reshape(-1))
            if dtype != "float32":
                cd = compute_dtype(dtype)
                e_t, e_ovf = e_t.to(cd), e_ovf.to(cd)
            halo = halo.replace_edge_feat(
                e_t.reshape(halo.e_t.shape[:-1] + (-1,)),
                e_ovf.reshape(halo.e_ovf.shape[:-1] + (-1,)))
            e = e_t

        if cfg.initial_node_feature_embedding:
            x = self.node_emb_mlp(x, node_mask)

        if tiling is not None:
            edge_mask = tiling.receivers >= 0
            e = tiling.edge_feat
            win = tiling.win
            if cfg.initial_edge_feature_embedding:
                e = self.edge_emb_mlp(e, edge_mask)
            if win is not None:
                sloc, t_win, pmask, ovf_s, ovf_r, ovf_e = win
                if cfg.initial_edge_feature_embedding:
                    ovf_e = self.edge_emb_mlp(ovf_e, ovf_r >= 0)
                if dtype != "float32":
                    # the edge features are rounded to the compute dtype
                    # once, for every layer
                    cd = compute_dtype(dtype)
                    e, ovf_e = e.to(cd), ovf_e.to(cd)
                win = (sloc, t_win, pmask, ovf_s, ovf_r, ovf_e)
            tiling = tiling._replace(edge_feat=e, win=win)
        elif cfg.initial_edge_feature_embedding and halo is None:
            e = self.edge_emb_mlp(e, edge_mask)

        for i in range(self.num_conv):
            x = getattr(self, f"conv_{i}")(x, senders, receivers, e,
                                           edge_mask, tiling, halo)
            x = getattr(self, f"bn_{i}")(x, node_mask)
            x = torch.relu(x)

        cls = self.classification_head(x, node_mask)
        bb = self.regression_head(x, node_mask)
        return cls, bb

    def forward_batch(self, batch: GraphBatch, mesh=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Runs on a GraphBatch (its tiling when the config asks for the
        fused path; a rank's shard of a halo batch through its halo bundle
        over `mesh`); returns flat [G·N, ...] outputs (a rank's rows for a
        halo shard)."""
        if batch.is_halo:
            return self(batch.flat_nodes(), batch.flat_edges(),
                        batch.flat_senders(), batch.flat_receivers(),
                        batch.node_mask.reshape(-1),
                        batch.edge_mask.reshape(-1),
                        halo=batch.flat_halo(mesh))
        tiling = batch.flat_tiling() if self.fused else None
        return self(batch.flat_nodes(), batch.flat_edges(),
                    batch.flat_senders(), batch.flat_receivers(),
                    batch.node_mask.reshape(-1), batch.edge_mask.reshape(-1),
                    tiling=tiling)
