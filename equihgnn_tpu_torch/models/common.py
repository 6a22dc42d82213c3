"""Shared model helpers (port of `equihgnn_tpu/models/common.py`):
activation, graph pooling, readout."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from equihgnn_tpu_torch.ops.segment import segment_sum


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
