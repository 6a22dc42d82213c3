"""FAFormer-encoded hypergraph models: `faformer_equihnn`,
`faformer_equihnns`, `faformer_equihnnm`.

Port of `equihgnn_tpu/models/equihnn_fa_former.py` (`_FAFormerBase.encode`
`:24-61`, the models `:64-91`), itself the reference's
`equihnn_fa_former.py:12-283`: AtomEncoder → FAFormer(d_input = d_model =
d_edge_model = MLP_hidden, n_layers=2, n_heads=2, k=16, valid_radius=5.0,
swiglu) → the MHNN, MHNNS or MHNNM trunk.

The port serves (`model.eval()`) and trains (`model.train()`) them in
float32 and bfloat16. The FAFormer keeps its class defaults, proj_drop =
attn_drop = 0.1, as the JAX model does: `--dropout` reaches the trunk only.
The port's batches hold one molecule per slot row (`data/batching.py`), so
the encoder takes the per-row frame and neighbour path and gets no
`slot_gid`. With `remat` the FAFormer call is checkpointed, as JAX remats
it (`equihnn_fa_former.py:53-58`): the recompute replays the same dropout
(the global generators' states are restored for it, and kernel D's mask
seeds come from the CPU generator), and kernel D runs again in the
backward pass. With `compute_dtype="bfloat16"` the atom embedding and
the positions are cast after the AtomEncoder (`cast_compute`, JAX's
`:34`): the FAFormer (built with `dtype=compute_dtype`, which its layers
round their residual streams to; kernels D and E in bf16) and the trunk
(kernel A in bf16) compute in bf16, the parameters stay f32 and the
prediction is f32.
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import HybridModel, cast_compute
from equihgnn_tpu_torch.models.trunks import TrunkFull, TrunkM, TrunkS
from equihgnn_tpu_torch.nn.encoders import AtomEncoder
from equihgnn_tpu_torch.nn.faformer import FAFormer


class _FAFormerBase(HybridModel):
    def build_encoder(self, cfg, generator):
        h = cfg.mlp_hidden
        self.atom_encoder = AtomEncoder(h, generator=generator)
        self.fa_former = FAFormer(
            d_input=h, d_model=h, d_edge_model=h, n_layers=2, n_heads=2, n_neighbors=16,
            valid_radius=5.0, activation="swiglu", dtype=cfg.compute_dtype, generator=generator,
        )

    def encode(self, batch: HyperGraphBatch):
        if batch.pos is None or batch.slot_index is None:
            raise ValueError(
                "faformer_equihnn* models need 3-D coordinates and the slot view: "
                "build batches with with_pos=True and max_atoms_per_graph > 0"
            )
        x, pos = cast_compute(self.cfg, self.atom_encoder(batch.atom_feat), batch.pos)
        x, _ = self.remat_encoder(self.fa_former, x, pos, batch.atom_row,
                                  batch.slot_index, batch.slot_mask, batch.atom_slot)
        return x


@registry.register_model("faformer_equihnn")
class FAFormerEquiHNN(_FAFormerBase):
    METHOD, TRUNK = "faformer_equihnn", TrunkFull


@registry.register_model("faformer_equihnns")
class FAFormerEquiHNNS(_FAFormerBase):
    METHOD, TRUNK = "faformer_equihnns", TrunkS


@registry.register_model("faformer_equihnnm")
class FAFormerEquiHNNM(_FAFormerBase):
    METHOD, TRUNK = "faformer_equihnnm", TrunkM
