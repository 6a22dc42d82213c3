"""EGNN-encoded hypergraph model `egnn_equihnns`.

Port of `equihgnn_tpu/models/equihnn_egnn.py` (`_EGNNBase.encode` `:24-60`,
`EGNNEquiHNNS` `:73-80`), itself the reference's `equihnn_egnn.py:97-169`:
atom embeddings, one EGNN layer (k = 16, valid_radius 5.0 against the
squared distance) on per-molecule neighbourhoods, then the MHNNS trunk.

The port runs in float32 and in eval mode. Configurations it does not
support yet raise here: `compute_dtype` other than float32,
`cross_molecule_knn=True`, BatchNorm ("bn") and PReLU.
"""

from __future__ import annotations

import torch
from torch import nn

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.models.trunks import TrunkS
from equihgnn_tpu_torch.nn.egnn import EGNN
from equihgnn_tpu_torch.nn.encoders import AtomEncoder


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.compute_dtype not in (None, "float32"):
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r}: the PyTorch port runs float32 only"
        )
    if cfg.cross_molecule_knn:
        raise NotImplementedError(
            "cross_molecule_knn=True (the flat batch-wide kNN path) is not ported yet"
        )


class _EGNNBase(nn.Module):
    def __init__(self, num_target: int, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        _check_supported(cfg)
        self.num_target, self.cfg = num_target, cfg
        self.atom_encoder = AtomEncoder(cfg.mlp_hidden, generator=generator)
        self.egnn_layer = EGNN(
            dim=cfg.mlp_hidden, num_nearest_neighbors=16, valid_radius=5.0,
            generator=generator,
        )

    def encode(self, batch: HyperGraphBatch) -> torch.Tensor:
        if batch.pos is None or batch.slot_index is None:
            raise ValueError(
                "egnn_equihnn* models need 3-D coordinates and the slot view: "
                "build batches with with_pos=True and max_atoms_per_graph > 0"
            )
        x = self.atom_encoder(batch.atom_feat)
        x, _ = self.egnn_layer(
            x, batch.pos,
            slot_index=batch.slot_index,
            slot_mask=batch.slot_mask,
            atom_slot=batch.atom_slot,
            atom_row=batch.atom_row,
            slot_gid=batch.slot_gid,
        )
        return x


@registry.register_model("egnn_equihnns")
class EGNNEquiHNNS(_EGNNBase):
    """Weights are drawn on the CPU from `generator` (seed 0 when None),
    so one seed gives the same model on every device, then moved to
    `device`."""

    def __init__(self, num_target: int, cfg: ModelConfig, device="cpu",
                 generator: torch.Generator | None = None):
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        super().__init__(num_target, cfg, gen)
        self.trunk = TrunkS(num_target, cfg, generator=gen)
        self.to(device)

    def forward(self, batch: HyperGraphBatch) -> torch.Tensor:
        """[num_graphs] float32 predictions (padding graph included)."""
        return self.trunk(self.encode(batch), batch)
