"""Dense building blocks (port of `equihgnn_tpu/nn/mlp.py`).

`TorchLinear` keeps torch.nn.Linear's default init law, U(±1/√fan_in) for
weight and bias, drawn from an explicit `torch.Generator`. `MLP` follows
the reference MLP: an optional input norm, then [Linear → ReLU → Norm →
Dropout]×(L-1) → Linear. Normalization is "ln" (LayerNorm), "bn"
(`MaskedBatchNorm`: BatchNorm1d over the rows a mask keeps, so the padding
rows of a batch take no part in its statistics) or "None". `prelu` is the
reference's learnable-slope activation, one slope for all channels, and
`leaky_relu` JAX's.

In a compute dtype below float32 (bfloat16) the parameters stay float32,
as in JAX: each `TorchLinear` casts its weight and bias to the input's
dtype (`equihgnn_tpu/nn/mlp.py:53,63`), and the norms take their
statistics in float32 and cast the result back (`:125,143`).
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
    `xavier=True` is ViSNet's `_Proj` init (`equihgnn_tpu/nn/visnet.py:46`):
    weight U(±√(6/(fan_in + fan_out))), bias zero. `bias=False` makes a
    layer without a bias parameter (flax's `use_bias=False`). On input of
    another dtype (bfloat16) the weight and bias are cast to it."""

    def __init__(self, in_features: int, out_features: int, *,
                 generator: torch.Generator, weight_std: float | None = None,
                 bias: bool = True, xavier: bool = False):
        super().__init__()
        bound = 1.0 / math.sqrt(max(in_features, 1))
        w = torch.empty(out_features, in_features)
        if xavier:
            uniform_(w, math.sqrt(6.0 / (in_features + out_features)), generator)
        elif weight_std is None:
            uniform_(w, bound, generator)
        else:
            normal_(w, weight_std, generator)
        self.weight = nn.Parameter(w)
        if bias and xavier:
            self.bias = nn.Parameter(torch.zeros(out_features))
        elif bias:
            self.bias = nn.Parameter(uniform_(torch.empty(out_features), bound, generator))
        else:
            self.register_parameter("bias", None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == self.weight.dtype:
            return F.linear(x, self.weight, self.bias)
        # another compute dtype: the product, then the bias add, each rounded
        # to it, as JAX's `jnp.dot(x, W) + b` (`equihgnn_tpu/nn/mlp.py:53,63`)
        y = F.linear(x, self.weight.to(x.dtype))
        return y if self.bias is None else y + self.bias.to(x.dtype)


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """The logistic function; below float32 `jax.nn.sigmoid` as XLA's CPU
    backend computes it, 1/(1 + exp(−x)) with the exponential, the sum and
    the reciprocal each rounded to x's dtype."""
    if x.dtype == torch.float32:
        return torch.sigmoid(x)
    return 1 / (1 + torch.exp(-x))


def silu(x: torch.Tensor) -> torch.Tensor:
    """SiLU; below float32 `jax.nn.silu` as XLA's CPU backend computes it,
    x · 1/(1 + exp(−x)) with every op rounded to x's dtype (`F.silu` rounds
    once: 0.61 of ViSNet's bf16 values came out the same)."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * sigmoid(x)


def leaky_relu(x: torch.Tensor, negative_slope: float) -> torch.Tensor:
    """x where x ≥ 0, else slope·x: `jax.nn.leaky_relu`, whose gradient at
    0 is 1 (`F.leaky_relu`'s is the slope). The 2-D baselines' GAT and the
    Equiformer's attention logits call it."""
    return torch.where(x >= 0, x, x * negative_slope)


def prelu(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The reference's PReLU with one learnable slope for all channels
    (`equihgnn_tpu/nn/mlp.py:67-75`): x where x ≥ 0, else alpha·x (the
    gradient at 0 is x's, as in JAX). `models/common.py` `Activation` holds
    the slope."""
    return torch.where(x >= 0, x, alpha.to(x.dtype) * x)


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the rows of a padded array that `mask` keeps
    (`equihgnn_tpu/nn/mlp.py:78-125`). In training mode the statistics are
    taken in f32 over the kept rows only: the biased variance normalizes,
    clamped at 0, and the running variance takes the unbiased one,
    var·cnt / max(cnt − 1, 1); momentum 0.1 (new = 0.9·old + 0.1·batch),
    eps 1e-5. In eval mode the running buffers normalize. Statistics are
    per process: JAX's cross-replica `axis_name` waits for data
    parallelism (ROADMAP item 10)."""

    MOMENTUM, EPS = 0.1, 1e-5

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.register_buffer("running_mean", torch.zeros(dim))
        self.register_buffer("running_var", torch.ones(dim))

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        xf = x.float()
        if self.training:
            m = (torch.ones(x.shape[:-1], device=x.device) if mask is None
                 else mask.to(torch.float32))
            rows = tuple(range(x.ndim - 1))
            cnt = torch.clamp(m.sum(), min=1.0)
            mw = m[..., None]
            mean = (xf * mw).sum(rows) / cnt
            var = torch.clamp((xf * xf * mw).sum(rows) / cnt - mean * mean, min=0.0)
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.mul_(1.0 - self.MOMENTUM).add_(self.MOMENTUM * mean)
                self.running_var.mul_(1.0 - self.MOMENTUM).add_(self.MOMENTUM * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (xf - mean) * torch.rsqrt(var + self.EPS)
        return (y * self.weight + self.bias).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """`nn.LayerNorm` whose statistics and affine map are taken in float32
    and cast back to the input's dtype once, as flax's LayerNorm with
    float32 parameters followed by `.astype(x.dtype)` (`equihgnn_tpu/nn/
    mlp.py:143`, `nn/egnn.py:190-195`); on float32 input it is
    `nn.LayerNorm`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.float()).to(x.dtype)


def make_norm(kind: str, dim: int) -> nn.Module:
    """The reference's Normalization strings: "bn", "ln" or "None"."""
    if kind == "bn":
        return MaskedBatchNorm(dim)
    if kind == "ln":
        return LayerNorm(dim, eps=1e-5)
    if kind == "None":
        return nn.Identity()
    raise ValueError(f"unknown normalization {kind!r}")


class MLP(nn.Module):
    """Reference-equivalent MLP (`reference equihgnn/models/layers/mlp.py:6-118`)."""

    def __init__(self, in_channels: int, hidden_channels: int, out_channels: int,
                 num_layers: int, dropout: float = 0.5, normalization: str = "ln",
                 input_norm: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.num_layers = num_layers
        self.masked = normalization == "bn"  # only the BatchNorm takes the mask
        self.norm_in = make_norm(normalization, in_channels) if input_norm else None
        dims = [in_channels] + [hidden_channels] * (num_layers - 1) + [out_channels]
        for i in range(num_layers):
            self.add_module(
                f"lin_{i}", TorchLinear(dims[i], dims[i + 1], generator=generator)
            )
        for i in range(num_layers - 1):
            self.add_module(f"norm_{i}", make_norm(normalization, hidden_channels))
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor, mask: torch.Tensor | None = None) -> torch.Tensor:
        """`mask` [rows] keeps the rows whose statistics a "bn" norm takes."""
        # the norms are called in line: the MLP runs a few dozen times a
        # forward, which the host launches one small kernel at a time
        if self.norm_in is not None:
            x = self.norm_in(x, mask) if self.masked else self.norm_in(x)
        for i in range(self.num_layers - 1):
            x = F.relu(getattr(self, f"lin_{i}")(x))
            norm = getattr(self, f"norm_{i}")
            x = self.dropout(norm(x, mask) if self.masked else norm(x))
        return getattr(self, f"lin_{self.num_layers - 1}")(x)
