"""FAFormer-encoded hypergraph model `faformer_equihnns`.

Port of `equihgnn_tpu/models/equihnn_fa_former.py` (`_FAFormerBase.encode`
`:24-61`, `FAFormerEquiHNNS` `:74-81`), itself the reference's
`equihnn_fa_former.py:12-283`: AtomEncoder → FAFormer(d_input = d_model =
d_edge_model = MLP_hidden, n_layers=2, n_heads=2, k=16, valid_radius=5.0,
swiglu) → the MHNNS trunk.

The port runs in float32, for serving (`model.eval()`) and training
(`model.train()`). The FAFormer keeps its class defaults, proj_drop =
attn_drop = 0.1, as the JAX model does: `--dropout` reaches the trunk only.
The port's batches hold one molecule per slot row (`data/batching.py`), so
the encoder takes the per-row frame and neighbour path and gets no
`slot_gid`. `faformer_equihnn` (TrunkFull) and `faformer_equihnnm`
(TrunkM) wait for ROADMAP item 2. Configurations the port does not support
yet raise here: `compute_dtype` other than float32, `remat`.
"""

from __future__ import annotations

import torch
from torch import nn

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import check_compute
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.models.trunks import TrunkS
from equihgnn_tpu_torch.nn.encoders import AtomEncoder
from equihgnn_tpu_torch.nn.faformer import FAFormer


@registry.register_model("faformer_equihnns")
class FAFormerEquiHNNS(nn.Module):
    """Weights are drawn on the CPU from `generator` (seed 0 when None),
    so one seed gives the same model on every device, then moved to
    `device`."""

    def __init__(self, num_target: int, cfg: ModelConfig, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_compute(cfg, "faformer_equihnns")
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.num_target, self.cfg = num_target, cfg
        h = cfg.mlp_hidden
        self.atom_encoder = AtomEncoder(h, generator=gen)
        self.fa_former = FAFormer(
            d_input=h, d_model=h, d_edge_model=h, n_layers=2, n_heads=2, n_neighbors=16,
            valid_radius=5.0, activation="swiglu", generator=gen,
        )
        self.trunk = TrunkS(num_target, cfg, generator=gen)
        self.to(device)

    def encode(self, batch: HyperGraphBatch) -> torch.Tensor:
        if batch.pos is None or batch.slot_index is None:
            raise ValueError(
                "faformer_equihnn* models need 3-D coordinates and the slot view: "
                "build batches with with_pos=True and max_atoms_per_graph > 0"
            )
        x = self.atom_encoder(batch.atom_feat)
        x, _ = self.fa_former(x, batch.pos, batch.atom_row, batch.slot_index,
                              batch.slot_mask, batch.atom_slot)
        return x

    def forward(self, batch: HyperGraphBatch) -> torch.Tensor:
        """[num_graphs] float32 predictions (padding graph included)."""
        return self.trunk(self.encode(batch), batch)
