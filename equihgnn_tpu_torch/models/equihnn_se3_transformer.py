"""SE(3)-Transformer-encoded hypergraph model `se3_transformer_equihnns`.

Port of `equihgnn_tpu/models/equihnn_se3_transformer.py:21-55`, itself the
reference's `equihnn_se3_transformer.py:12-91`: AtomEncoder →
SE3Transformer(dim = MLP_hidden, heads 2, depth 2, dim_head 32,
num_degrees 2, valid_radius 5 Å, k = 16, attend_self) → its type-0
output → the MHNNS trunk.

The port serves (`model.eval()`) and trains (`model.train()`: the encoder
has no dropout; `--dropout` reaches the trunk) in float32, where the
pooled ConvSE3 units run kernels J and K on the card, and with
`compute_dtype="bfloat16"`, which as in JAX reaches the encoder only (its
output is cast back to float32; the AtomEncoder, the trunk, the
parameters and the loss stay float32), where each pooled unit takes the
route JAX's gate gives it at the call's shapes: kernels J and K in
bfloat16 where JAX fuses the unit (`MLP_hidden` 128 or 256 at the
batches' molecule rows), kernels L and M where it does not (a width that
is no multiple of 128, 384 and 512). With `remat` the SE(3)-Transformer
is checkpointed, as JAX remats it (`equihnn_se3_transformer.py:35`),
around the per-J path's checkpoints: kernel J (per-J: L) runs again in
the backward pass. Another `compute_dtype` raises (ROADMAP item 11).
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import HybridModel
from equihgnn_tpu_torch.models.trunks import TrunkS
from equihgnn_tpu_torch.nn.encoders import AtomEncoder
from equihgnn_tpu_torch.nn.se3_transformer import SE3Transformer


@registry.register_model("se3_transformer_equihnns")
class SE3TransformerEquiHNNS(HybridModel):
    METHOD, TRUNK = "se3_transformer_equihnns", TrunkS

    def build_encoder(self, cfg, generator):
        h = cfg.mlp_hidden
        self.atom_encoder = AtomEncoder(h, generator=generator)
        self.se3_transformer_layer = SE3Transformer(
            dim=h, heads=2, depth=2, dim_head=32, num_degrees=2, valid_radius=5.0,
            num_neighbors=16, dtype=cfg.compute_dtype, generator=generator)

    def encode(self, batch: HyperGraphBatch):
        if batch.pos is None or batch.slot_index is None:
            raise ValueError(
                "se3_transformer_equihnns needs 3-D coordinates and the slot view: "
                "build batches with with_pos=True and max_atoms_per_graph > 0"
            )
        x = self.atom_encoder(batch.atom_feat)
        return self.remat_encoder(self.se3_transformer_layer, x, batch.pos, batch.atom_row,
                                  batch.slot_index, batch.slot_mask, batch.atom_slot,
                                  slot_gid=batch.slot_gid)
