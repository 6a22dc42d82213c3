"""Equiformer-encoded hypergraph model `equiformer_equihnns`.

Port of `equihgnn_tpu/models/equihnn_equiformer.py:21-57`, itself the
reference's `equihnn_equiformer.py:12-93` (which ships only the S
variant): AtomEncoder → Equiformer(dim = (MLP_hidden, MLP_hidden), dim_in
= (MLP_hidden,), heads 1, depth 1, dim_head 48, degrees 0 and 1,
valid_radius 5 Å, k = 16, MLP attention, attend_self) → its type-0 output
→ the MHNNS trunk.

The port serves (`model.eval()`) and trains (`model.train()`: the
Equiformer has no dropout; `--dropout` reaches the trunk) in float32. The
Equiformer runs no kernel (JAX computes it with XLA einsums); the trunk
runs kernel A. With `remat` the Equiformer is checkpointed, as JAX remats
it (`equihnn_equiformer.py:36`). A `compute_dtype` other than float32
raises (ROADMAP item 11).
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import HybridModel
from equihgnn_tpu_torch.models.trunks import TrunkS
from equihgnn_tpu_torch.nn.encoders import AtomEncoder
from equihgnn_tpu_torch.nn.equiformer import Equiformer


@registry.register_model("equiformer_equihnns")
class EquiformerEquiHNNS(HybridModel):
    METHOD, TRUNK = "equiformer_equihnns", TrunkS

    def build_encoder(self, cfg, generator):
        h = cfg.mlp_hidden
        self.atom_encoder = AtomEncoder(h, generator=generator)
        self.equiformer_layer = Equiformer(
            dim=(h, h), dim_in=(h,), heads=1, depth=1, dim_head=48, valid_radius=5.0,
            num_neighbors=16, attend_self=True, dtype=cfg.compute_dtype, generator=generator)

    def encode(self, batch: HyperGraphBatch):
        if batch.pos is None or batch.slot_index is None:
            raise ValueError(
                "equiformer_equihnns needs 3-D coordinates and the slot view: "
                "build batches with with_pos=True and max_atoms_per_graph > 0"
            )
        x = self.atom_encoder(batch.atom_feat)
        x, _type1 = self.remat_encoder(self.equiformer_layer, x, batch.pos, batch.atom_row,
                                       batch.slot_index, batch.slot_mask, batch.atom_slot,
                                       slot_gid=batch.slot_gid)
        return x
