"""Dense building blocks (port of `equihgnn_tpu/nn/mlp.py`).

`TorchLinear` keeps torch.nn.Linear's default init law, U(±1/√fan_in) for
weight and bias, drawn from an explicit `torch.Generator`. `MLP` follows
the reference MLP: [Linear → ReLU → Norm → Dropout]×(L-1) → Linear.
Normalization is "ln" (LayerNorm, f32 statistics) or "None"; the masked
BatchNorm ("bn"), PReLU and the input norm are not ported yet (no ported
model uses them).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.uniform_(-bound, bound, generator=generator)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> torch.Tensor:
    with torch.no_grad():
        return t.normal_(0.0, std, generator=generator)


class TorchLinear(nn.Module):
    """y = x Wᵀ + b with W [out, in]. Weight init U(±1/√fan_in), or
    N(0, weight_std²) when `weight_std` is given; bias U(±1/√fan_in).
    `bias=False` makes a layer without a bias parameter (flax's
    `use_bias=False`)."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, weight_std: float | None = None,
                 bias: bool = True):
        super().__init__()
        bound = 1.0 / math.sqrt(max(in_features, 1))
        w = torch.empty(out_features, in_features)
        if weight_std is None:
            uniform_(w, bound, generator)
        else:
            normal_(w, weight_std, generator)
        self.weight = nn.Parameter(w)
        if bias:
            self.bias = nn.Parameter(uniform_(torch.empty(out_features), bound, generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


def make_norm(kind: str, dim: int) -> nn.Module:
    """The reference's Normalization strings: "ln" or "None"."""
    if kind == "ln":
        return nn.LayerNorm(dim, eps=1e-5)
    if kind == "None":
        return nn.Identity()
    raise ValueError(f"normalization {kind!r} is not supported by the PyTorch port yet")


class MLP(nn.Module):
    """Reference-equivalent MLP (`reference equihgnn/models/layers/mlp.py:6-118`)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 num_layers: int, dropout: float = 0.5, normalization: str = "ln", *,
                 generator: torch.Generator):
        super().__init__()
        self.num_layers = num_layers
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) + [out_channels]
        for i in range(num_layers):
            self.add_module(
                f"lin_{i}", TorchLinear(dims[i], dims[i + 1], generator=generator)
            )
        for i in range(num_layers - 1):
            self.add_module(f"norm_{i}", make_norm(normalization, hidden_channels))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_layers - 1):
            x = getattr(self, f"lin_{i}")(x)
            x = getattr(self, f"norm_{i}")(F.relu(x))
            x = self.dropout(x)
        return getattr(self, f"lin_{self.num_layers - 1}")(x)
