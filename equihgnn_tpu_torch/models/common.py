"""Shared model helpers (port of `equihgnn_tpu/models/common.py`): what a
configuration may ask of the port, the compute-dtype cast, activation,
graph pooling, readout."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from equihgnn_tpu_torch.ops.segment import segment_sum


# the models that run `compute_dtype="bfloat16"` (in their encoder only, as in JAX)
BF16_METHODS = ("se3_transformer_equihnns",)


def check_compute(cfg, method: str) -> None:
    """Raise on what the port does not run yet (ROADMAP item 11): `remat`,
    and a `compute_dtype` other than float32, except bfloat16 on the models
    of `BF16_METHODS`."""
    dt = cfg.compute_dtype
    if dt not in (None, "float32") and not (dt == "bfloat16" and method in BF16_METHODS):
        raise NotImplementedError(
            f"compute_dtype={dt!r} on {method}: the PyTorch port runs bfloat16 only on "
            f"{', '.join(BF16_METHODS)}; the rest is ROADMAP item 11")
    if cfg.remat:
        raise NotImplementedError("remat is not ported yet: ROADMAP item 11")


def cast_compute(cfg, *tensors):
    """Cast activations to the configured compute dtype, a no-op by default
    (`equihgnn_tpu/models/common.py:68-74`); None passes through. JAX's
    `TrunkFull` and `TrunkM` call it (ROADMAP item 2); the SE(3)-Transformer
    casts its own inputs, as in JAX."""
    if cfg.compute_dtype is None:
        return tensors if len(tensors) > 1 else tensors[0]
    dt = getattr(torch, cfg.compute_dtype)
    out = tuple(None if t is None else t.to(dt) for t in tensors)
    return out if len(out) > 1 else out[0]


class Activation(nn.Module):
    """{Id, relu} (`reference equihgnn/models/mhnn.py:23-24`); PReLU is not
    ported yet."""

    def __init__(self, kind: str = "relu"):
        super().__init__()
        if kind not in ("Id", "relu"):
            raise ValueError(f"activation {kind!r} is not supported by the PyTorch port yet")
        self.kind = kind

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(x) if self.kind == "relu" else x


def global_add_pool(x, graph_id, num_graphs: int, mask=None):
    """Masked per-graph sum (`torch_geometric.nn.global_add_pool` equivalent)."""
    return segment_sum(x, graph_id, num_graphs, mask=mask)


def flat_pred(x: torch.Tensor) -> torch.Tensor:
    """`.view(-1)` of a [G, 1] head output; predictions always float32."""
    return x.reshape(-1).to(torch.float32)
