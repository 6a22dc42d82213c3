"""ViSNet-encoded hypergraph models: `visnet_equihnn`, `visnet_equihnns`,
`visnet_equihnnm`.

Port of `equihgnn_tpu/models/equihnn_visnet.py` (`_ViSNetBase.encode`
`:20-46`, the models `:49-76`), itself the reference's
`equihnn_visnet.py:11-243`: a ViSNet block (hidden_channels = MLP_hidden,
lmax 2, 6 layers, 8 heads, 32 RBFs, cutoff 5 Å, max_num_neighbors 16)
embeds the OGB atom features itself and encodes the 3-D structure into
per-atom scalars; then the MHNN, MHNNS or MHNNM trunk.

The port serves (`model.eval()`) and trains (`model.train()`: ViSNet has
no dropout; `--dropout` reaches the trunk) in float32, and with
`compute_dtype="bfloat16"` ViSNet's layer loop runs in bf16 (kernels F-I
in bf16 on the card) while its readout, and so the trunk, stay f32, as in
JAX (`equihnn_visnet.py:34`); `TrunkFull` and `TrunkM` cast their
hyperedge embedding to bf16 and meet the f32 atom features in their first
concatenation, which promotes it back.
ViSNet keeps JAX's `remat_layers=None`: each layer is recomputed in the
backward pass on the CPU, never on the card, where kernels F-I run. With
`remat` the whole ViSNet block is checkpointed besides, as JAX remats it
(`equihnn_visnet.py:31`): kernels F and H run again in the backward pass.
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import HybridModel
from equihgnn_tpu_torch.models.trunks import TrunkFull, TrunkM, TrunkS
from equihgnn_tpu_torch.nn.visnet import ViSNet


class _ViSNetBase(HybridModel):
    def build_encoder(self, cfg, generator):
        self.visnet_layer = ViSNet(hidden_channels=cfg.mlp_hidden, lmax=2, max_num_neighbors=16,
                                   dtype=cfg.compute_dtype, generator=generator)

    def encode(self, batch: HyperGraphBatch):
        if batch.pos is None or batch.slot_index is None:
            raise ValueError(
                "visnet_equihnn* models need 3-D coordinates and the slot view: "
                "build batches with with_pos=True and max_atoms_per_graph > 0"
            )
        return self.remat_encoder(self.visnet_layer, batch.atom_feat, batch.pos,
                                  batch.atom_row, batch.slot_index, batch.slot_mask,
                                  batch.atom_slot, slot_gid=batch.slot_gid)


@registry.register_model("visnet_equihnn")
class VisNetEquiHNN(_ViSNetBase):
    METHOD, TRUNK = "visnet_equihnn", TrunkFull


@registry.register_model("visnet_equihnns")
class VisNetEquiHNNS(_ViSNetBase):
    METHOD, TRUNK = "visnet_equihnns", TrunkS


@registry.register_model("visnet_equihnnm")
class VisNetEquiHNNM(_ViSNetBase):
    METHOD, TRUNK = "visnet_equihnnm", TrunkM
