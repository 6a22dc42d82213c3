"""EGNN-encoded hypergraph models: `egnn_equihnn`, `egnn_equihnns`,
`egnn_equihnnm`.

Port of `equihgnn_tpu/models/equihnn_egnn.py` (`_EGNNBase.encode` `:24-60`,
the models `:63-90`), itself the reference's `equihnn_egnn.py:12-261`:
atom embeddings, one EGNN layer (k = 16, valid_radius 5.0 against the
squared distance), then the MHNN, MHNNS or MHNNM trunk. The EGNN runs on
per-molecule neighbourhoods in the dense slot view; with
`cross_molecule_knn=True` (the reference's batch-as-one-point-cloud kNN),
or on a batch without the slot view, on JAX's flat path.

The port runs in float32 or bfloat16, for serving (`model.eval()`) and training
(`model.train()`: dropout in the trunk and its MLPs, batch statistics in
the masked BatchNorms; the EGNN has none, as in every model the reference
builds). Gradients reach the same parameters as in JAX; the EGNN's
coordinate branch (`coors_mlp_*`, `coors_norm`) gets none in either
framework, because `encode` drops the EGNN's coordinates. With `remat` the
EGNN layer is checkpointed, as JAX remats it (`equihnn_egnn.py:38`): kernel
B runs again in the backward pass. With `compute_dtype="bfloat16"` the
atom embedding and the positions are cast (`equihnn_egnn.py:34`): the
neighbours are ranked on bf16 squared distances, the EGNN runs kernels B
and C in bf16, and the trunk computes in bf16 up to its float32
prediction.
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import HybridModel, cast_compute
from equihgnn_tpu_torch.models.trunks import TrunkFull, TrunkM, TrunkS
from equihgnn_tpu_torch.nn.egnn import EGNN
from equihgnn_tpu_torch.nn.encoders import AtomEncoder


class _EGNNBase(HybridModel):
    def build_encoder(self, cfg, generator):
        self.atom_encoder = AtomEncoder(cfg.mlp_hidden, generator=generator)
        self.egnn_layer = EGNN(
            dim=cfg.mlp_hidden, num_nearest_neighbors=16, valid_radius=5.0,
            cross_molecule=cfg.cross_molecule_knn, generator=generator,
        )

    def encode(self, batch: HyperGraphBatch):
        if batch.pos is None:
            raise ValueError(
                "egnn_equihnn* models need 3-D coordinates: build batches with "
                "with_pos=True (use a *_hg_3d dataset)"
            )
        x, pos = cast_compute(self.cfg, self.atom_encoder(batch.atom_feat), batch.pos)
        x, _ = self.remat_encoder(
            self.egnn_layer, x, pos,
            slot_index=batch.slot_index,
            slot_mask=batch.slot_mask,
            atom_slot=batch.atom_slot,
            atom_row=batch.atom_row,
            slot_gid=batch.slot_gid,
            mask=batch.atom_mask,
            graph_id=batch.atom_graph_id,
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
