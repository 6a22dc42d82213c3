"""EGNN-encoded hypergraph models: `egnn_equihnn`, `egnn_equihnns`,
`egnn_equihnnm`.

Port of `equihgnn_tpu/models/equihnn_egnn.py` (`_EGNNBase.encode` `:24-60`,
the models `:63-90`), itself the reference's `equihnn_egnn.py:12-261`:
atom embeddings, one EGNN layer (k = 16, valid_radius 5.0 against the
squared distance) on per-molecule neighbourhoods, then the MHNN, MHNNS or
MHNNM trunk.

The port runs in float32, for serving (`model.eval()`) and training
(`model.train()`: dropout in the trunk and its MLPs, batch statistics in
the masked BatchNorms; the EGNN has none, as in every model the reference
builds). Gradients reach the same parameters as in JAX; the EGNN's
coordinate branch (`coors_mlp_*`, `coors_norm`) gets none in either
framework, because `encode` drops the EGNN's coordinates. Configurations
the port does not support yet raise here: `compute_dtype` other than
float32, `remat`, `cross_molecule_knn=True`.
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import HybridModel
from equihgnn_tpu_torch.models.trunks import TrunkFull, TrunkM, TrunkS
from equihgnn_tpu_torch.nn.egnn import EGNN
from equihgnn_tpu_torch.nn.encoders import AtomEncoder


class _EGNNBase(HybridModel):
    def build_encoder(self, cfg, generator):
        if cfg.cross_molecule_knn:
            raise NotImplementedError(
                "cross_molecule_knn=True (the flat batch-wide kNN path) is not ported yet")
        self.atom_encoder = AtomEncoder(cfg.mlp_hidden, generator=generator)
        self.egnn_layer = EGNN(
            dim=cfg.mlp_hidden, num_nearest_neighbors=16, valid_radius=5.0,
            generator=generator,
        )

    def encode(self, batch: HyperGraphBatch):
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


@registry.register_model("egnn_equihnn")
class EGNNEquiHNN(_EGNNBase):
    METHOD, TRUNK = "egnn_equihnn", TrunkFull


@registry.register_model("egnn_equihnns")
class EGNNEquiHNNS(_EGNNBase):
    METHOD, TRUNK = "egnn_equihnns", TrunkS


@registry.register_model("egnn_equihnnm")
class EGNNEquiHNNM(_EGNNBase):
    METHOD, TRUNK = "egnn_equihnnm", TrunkM
