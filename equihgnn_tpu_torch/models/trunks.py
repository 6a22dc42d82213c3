"""Hypergraph trunks (port of `equihgnn_tpu/models/trunks.py`), which every
hybrid composes after its encoder:

  * `TrunkFull` (`:36-96`, the reference's MHNN forward,
    `equihnn_egnn.py:69-96`): a hyperedge-type embedding, one shared
    MHNNConv applied `all_num_layers` times, then the atom sum-pool beside
    the conjugated-hyperedge pool and the output MLP;
  * `TrunkS` (`:99-150`, MHNNS, `equihnn_egnn.py:154-168`): one shared
    MHNNSConv with an α-mix against the encoder output, then the atom
    sum-pool and the output MLP;
  * `TrunkM` (`:153-211`, MHNNM, `equihnn_egnn.py:236-261`): a MHNNConv and
    a masked BatchNorm per layer, then the atom sum-pool and the output MLP.

Between conv applications come the activation and dropout on the atom and
hyperedge features (one activation module, so one PReLU slope, for both);
the last application gets dropout only.
"""

from __future__ import annotations

import torch
from torch import nn

from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import (
    Activation,
    cast_compute,
    conjugated_hedge_pool,
    flat_pred,
    global_add_pool,
)
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn.encoders import HedgeEncoder
from equihgnn_tpu_torch.nn.hgconv import MHNNConv, MHNNSConv
from equihgnn_tpu_torch.nn.mlp import MLP, MaskedBatchNorm


def _mhnn_conv(cfg: ModelConfig, generator: torch.Generator) -> MHNNConv:
    return MHNNConv(
        cfg.mlp_hidden, mlp1_layers=cfg.mlp1_layers, mlp2_layers=cfg.mlp2_layers,
        mlp3_layers=cfg.mlp3_layers, mlp4_layers=cfg.mlp4_layers, aggr=cfg.aggregate,
        dropout=cfg.dropout, normalization=cfg.normalization, generator=generator,
    )


def _mlp_out(in_dim: int, hidden: int, num_target: int, cfg: ModelConfig,
             generator: torch.Generator) -> MLP:
    return MLP(in_dim, hidden, num_target, cfg.output_num_layers, dropout=cfg.dropout,
               normalization=cfg.normalization, generator=generator)


class _MHNNTrunk(nn.Module):
    """What TrunkFull and TrunkM share: the hyperedge embedding, the
    activation and dropout between convs."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.act = Activation(cfg.activation)
        self.drop = nn.Dropout(cfg.dropout)
        self.bond_encoder = HedgeEncoder(cfg.mlp_hidden, generator=generator)

    @staticmethod
    def _conv(conv: MHNNConv, x, e, batch: HyperGraphBatch):
        return conv(x, e, batch.vertex_idx, batch.hedge_idx, batch.inc_mask,
                    atom_mask=batch.atom_mask, hedge_mask=batch.hedge_mask)

    def _between(self, i: int, x, e):
        if i == self.cfg.all_num_layers - 1:
            return self.drop(x), self.drop(e)
        return self.drop(self.act(x)), self.drop(self.act(e))


class TrunkFull(_MHNNTrunk):
    """Shared MHNNConv trunk with conjugated readout (MHNN-style)."""

    def __init__(self, num_target: int, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__(cfg, generator)
        self.conv = _mhnn_conv(cfg, generator)  # ONE module, applied all_num_layers times
        self.mlp_out = _mlp_out(2 * cfg.mlp_hidden, 2 * cfg.output_hidden, num_target, cfg,
                                generator)

    def forward(self, x: torch.Tensor, batch: HyperGraphBatch) -> torch.Tensor:
        e = cast_compute(self.cfg, self.bond_encoder(batch.hedge_feat))
        for i in range(self.cfg.all_num_layers):
            x, e = self._between(i, *self._conv(self.conv, x, e, batch))
        xg = global_add_pool(x, batch.atom_graph_id, batch.num_graphs, mask=batch.atom_mask)
        eg = conjugated_hedge_pool(e, batch)
        return flat_pred(self.mlp_out(torch.cat([xg, eg], -1), batch.graph_mask))


class TrunkM(_MHNNTrunk):
    """Per-layer MHNNConv + BatchNorm trunk (MHNNM-style)."""

    def __init__(self, num_target: int, cfg: ModelConfig, *, generator: torch.Generator):
        super().__init__(cfg, generator)
        for i in range(cfg.all_num_layers):
            self.add_module(f"layers_{i}", _mhnn_conv(cfg, generator))
            self.add_module(f"batch_norms_{i}", MaskedBatchNorm(cfg.mlp_hidden))
        self.mlp_out = _mlp_out(cfg.mlp_hidden, cfg.output_hidden, num_target, cfg, generator)

    def forward(self, x: torch.Tensor, batch: HyperGraphBatch) -> torch.Tensor:
        e = cast_compute(self.cfg, self.bond_encoder(batch.hedge_feat))
        for i in range(self.cfg.all_num_layers):
            x, e = self._conv(getattr(self, f"layers_{i}"), x, e, batch)
            x = getattr(self, f"batch_norms_{i}")(x, batch.atom_mask)
            x, e = self._between(i, x, e)
        xg = global_add_pool(x, batch.atom_graph_id, batch.num_graphs, mask=batch.atom_mask)
        return flat_pred(self.mlp_out(xg, batch.graph_mask))


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
        self.mlp_out = _mlp_out(cfg.mlp_hidden, cfg.output_hidden, num_target, cfg, generator)

    def forward(self, x: torch.Tensor, batch: HyperGraphBatch) -> torch.Tensor:
        x0 = x
        for _ in range(self.num_layers):
            x = self.drop(x)
            x = self.conv(x, batch.vertex_idx, batch.hedge_idx, batch.inc_mask,
                          x0, batch.num_hedges, atom_mask=batch.atom_mask)
            x = self.act(x)
        x = self.drop(x)
        xg = global_add_pool(x, batch.atom_graph_id, batch.num_graphs, mask=batch.atom_mask)
        return flat_pred(self.mlp_out(xg, batch.graph_mask))
