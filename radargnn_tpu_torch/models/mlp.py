"""MLP building blocks with torch-default initialization and masked BatchNorm.

Port of `radargnn_tpu/models/mlp.py`. The layer stack of the reference's
`get_mlp`:

    hidden=[]          : Linear(in, out)
    hidden=[h]         : Linear(in,h) · [BN] · ReLU · Linear(h,out)
    hidden=[h1,h2,...] : Linear(in,h1) · ([BN]·ReLU·Linear)* · [BN]·ReLU·Linear(.,out)

BatchNorm is *masked*: statistics come from valid (un-padded) rows only.
Training mode normalizes with batch statistics and, when grad is enabled,
updates the running estimates with torch momentum (running <- (1-m)·running
+ m·batch, unbiased variance in the running estimate, biased in the
normalization), eps 1e-5.

Parameters follow torch's layout (`weight` [out, in]); the weight bridge
(`radargnn_tpu_torch.weights`) maps them to and from the flax tree.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
from torch import nn


def compute_dtype(name: str) -> torch.dtype:
    """The matmul input dtype named by a config ("float32" | "bfloat16")."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def matmul_f32(a: torch.Tensor, w: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a @ w with both operands rounded to `dtype` and a float32 result.

    The JAX package asks for bf16 inputs with `preferred_element_type=f32`.
    torch.matmul of two bf16 tensors returns bf16, so both operands are
    rounded to `dtype` and then upcast: the float32 product of bf16 values
    is exact, and the sum accumulates in float32. The entry points switch
    TF32 off (device.resolve_device) so the card keeps full float32."""
    return torch.matmul(a.to(dtype).float(), w.to(dtype).float())


def _uniform(shape, bound: float, generator: torch.Generator) -> torch.Tensor:
    return torch.empty(shape).uniform_(-bound, bound, generator=generator)


class TorchLinear(nn.Module):
    """Linear layer with torch-default init U(±1/√fan_in) for weight and bias;
    matmul inputs in `dtype`, float32 result."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: str = "float32",
                 generator: Optional[torch.Generator] = None,
                 use_bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(in_features)
        self.weight = nn.Parameter(
            _uniform((out_features, in_features), bound, generator))
        self.bias = nn.Parameter(_uniform((out_features,), bound, generator)) \
            if use_bias else None
        self.dtype = compute_dtype(dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = matmul_f32(x, self.weight.t(), self.dtype)
        if self.bias is not None:
            y = y + self.bias
        return y


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the leading (node/edge) axis with a validity mask."""

    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.training:
            if mask is None:
                n = torch.tensor(float(x.shape[0]), device=x.device)
                mean = x.mean(0)
                var = (x - mean).square().mean(0)
            else:
                m = mask.to(x.dtype)[:, None]
                n = m.sum().clamp(min=1.0)
                mean = (x * m).sum(0) / n
                var = ((x - mean).square() * m).sum(0) / n
            # the running estimates move only in a training step: serving
            # with batch statistics (Predictor, under no_grad) leaves them,
            # as the JAX Predictor drops the updated batch_stats
            if torch.is_grad_enabled():
                with torch.no_grad():
                    unbiased = var * n / (n - 1.0).clamp(min=1.0)
                    self.running_mean.mul_(1 - self.momentum).add_(
                        self.momentum * mean)
                    self.running_var.mul_(1 - self.momentum).add_(
                        self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + self.eps) * self.weight \
            + self.bias


class MLP(nn.Module):
    """The reference `get_mlp` layer stack (module docstring)."""

    def __init__(self, in_size: int, out_size: int,
                 hidden_layer_sizes: Sequence[int] = (),
                 batch_norm: bool = False, dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        sizes: List[int] = list(hidden_layer_sizes) + [out_size]
        self.num_linear = len(sizes)
        self.batch_norm = batch_norm
        fan_in = in_size
        for i, size in enumerate(sizes):
            self.add_module(f"lin_{i}", TorchLinear(fan_in, size, dtype,
                                                    generator))
            if batch_norm and i < len(sizes) - 1:
                self.add_module(f"bn_{i}", MaskedBatchNorm(size))
            fan_in = size

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.lin_0(x)
        for i in range(1, self.num_linear):
            if self.batch_norm:
                x = getattr(self, f"bn_{i - 1}")(x, mask)
            x = torch.relu(x)
            x = getattr(self, f"lin_{i}")(x)
        return x


class LinearReluStack(nn.Module):
    """Linear · (ReLU · Linear)^(n-1) — the conv pre/post MLP shape."""

    def __init__(self, in_size: int, layer_sizes: Sequence[int],
                 dtype: str = "float32",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_linear = len(layer_sizes)
        fan_in = in_size
        for i, size in enumerate(layer_sizes):
            self.add_module(f"lin_{i}", TorchLinear(fan_in, size, dtype,
                                                    generator))
            fan_in = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_linear):
            if i > 0:
                x = torch.relu(x)
            x = getattr(self, f"lin_{i}")(x)
        return x
