"""Hypergraph trunk `TrunkS` (port of `equihgnn_tpu/models/trunks.py:99-150`,
the reference's MHNNS forward, `equihnn_egnn.py:154-168`): one shared
MHNNSConv applied `all_num_layers` times with an α-mix against the encoder
output, then a node sum-pool and the output MLP."""

from __future__ import annotations

import torch
from torch import nn

from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import Activation, flat_pred, global_add_pool
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn.hgconv import MHNNSConv
from equihgnn_tpu_torch.nn.mlp import MLP


class TrunkS(nn.Module):
    """Shared MHNNSConv trunk (MHNNS-style)."""

    def __init__(self, num_target: int, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__()
        self.num_layers = cfg.all_num_layers
        self.act = Activation(cfg.activation)
        self.drop = nn.Dropout(cfg.dropout)
        # ONE module, applied all_num_layers times (the reference shares it)
        self.conv = MHNNSConv(
            cfg.mlp_hidden,
            mlp1_layers=cfg.mlp1_layers,
            mlp2_layers=cfg.mlp2_layers,
            mlp3_layers=cfg.mlp3_layers,
            aggr=cfg.aggregate,
            dropout=cfg.dropout,
            normalization=cfg.normalization,
            generator=generator,
        )
        self.mlp_out = MLP(
            cfg.mlp_hidden, cfg.output_hidden, num_target, cfg.output_num_layers,
            dropout=cfg.dropout, normalization=cfg.normalization, generator=generator,
        )

    def forward(self, x: torch.Tensor, batch: HyperGraphBatch) -> torch.Tensor:
        x0 = x
        for _ in range(self.num_layers):
            x = self.drop(x)
            x = self.conv(x, batch.vertex_idx, batch.hedge_idx, batch.inc_mask,
                          x0, batch.num_hedges)
            x = self.act(x)
        x = self.drop(x)
        xg = global_add_pool(x, batch.atom_graph_id, batch.num_graphs, mask=batch.atom_mask)
        return flat_pred(self.mlp_out(xg))
