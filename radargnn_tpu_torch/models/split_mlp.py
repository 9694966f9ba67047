"""Split-projection pre-MLP: the first layer projects node features before
the edge gather.

Port of `radargnn_tpu/models/split_mlp.py`. The message MLP of the
reference runs on the gathered edge tensor, pre_mlp([x_r ‖ x_s ‖ e]).
Because its first Linear is linear in the concatenated blocks,

    concat[x_r, x_s, e] @ W == (x @ W_r)[recv] + (x @ W_s)[send] + e @ W_e

with W split by rows, so both node projections run once per node instead
of once per edge, with the same parameters (`pre_mlp.lin_0.weight` holds
the whole first layer, as the flax kernel `pre_mlp/lin_0/kernel` does);
only the float32 summation order differs. The layers after the first are
ordinary Linears (`lin_1`, ...) with a ReLU before each, none after the
last. With a bf16 compute dtype every product takes bf16 operands and sums
in float32 (`models.mlp.matmul_f32`), as the JAX package asks with
`preferred_element_type=float32`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from radargnn_tpu_torch.models.mlp import TorchLinear, compute_dtype, \
    matmul_f32


class PreMLPParams(nn.Module):
    """The pre-MLP's first Linear under the `pre_mlp.lin_0` name, read by
    the hoisted max aggregation as its split blocks."""

    def __init__(self, fan_in: int, features: int,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.lin_0 = TorchLinear(fan_in, features, generator=generator)


class SplitPreMLP(nn.Module):
    """The conv pre-MLP with its first layer as split projections.

    layer_sizes: the output size of each Linear (the reference's shape:
    all of them the pre-MLP width); include_receiver: True for MPNNConv
    ([x_r ‖ x_s ‖ e]), False for RadarPointGNNConv ([x_s ‖ e])."""

    def __init__(self, layer_sizes: Sequence[int], node_dim: int,
                 edge_dim: int, include_receiver: bool = True,
                 dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.node_dim = node_dim
        self.include_receiver = include_receiver
        self.dtype = compute_dtype(dtype)
        self.num_linear = len(layer_sizes)
        fan_in = (2 if include_receiver else 1) * node_dim + edge_dim
        self.lin_0 = TorchLinear(fan_in, layer_sizes[0], generator=generator)
        for i, size in enumerate(layer_sizes[1:], start=1):
            self.add_module(f"lin_{i}", TorchLinear(layer_sizes[i - 1], size,
                                                    dtype, generator))

    def forward(self, x: torch.Tensor, senders: torch.Tensor,
                receivers: torch.Tensor,
                edge_attr: torch.Tensor) -> torch.Tensor:
        d = self.node_dim
        w = self.lin_0.weight.t()                   # [fan_in, out], flax layout

        def mm(a, w_part):
            return matmul_f32(a, w_part, self.dtype)

        if self.include_receiver:
            m = (mm(x, w[:d])[receivers.long()]
                 + mm(x, w[d:2 * d])[senders.long()]
                 + mm(edge_attr, w[2 * d:]) + self.lin_0.bias)
        else:
            m = (mm(x, w[:d])[senders.long()] + mm(edge_attr, w[d:])
                 + self.lin_0.bias)
        for i in range(1, self.num_linear):
            m = getattr(self, f"lin_{i}")(torch.relu(m))
        return m
