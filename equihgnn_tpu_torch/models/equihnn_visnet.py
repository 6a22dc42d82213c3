"""ViSNet-encoded hypergraph model `visnet_equihnns`.

Port of `equihgnn_tpu/models/equihnn_visnet.py` (`_ViSNetBase.encode`
`:20-46`, `VisNetEquiHNNS` `:59-66`), itself the reference's
`equihnn_visnet.py:11-243`: a ViSNet block (hidden_channels = MLP_hidden,
lmax 2, 6 layers, 8 heads, 32 RBFs, cutoff 5 Å, max_num_neighbors 16)
embeds the OGB atom features itself and encodes the 3-D structure into
per-atom scalars; then the MHNNS trunk.

The port runs in float32, for serving (`model.eval()`) and training
(`model.train()`: ViSNet has no dropout; `--dropout` reaches the trunk).
ViSNet keeps JAX's `remat_layers=None`: each layer is recomputed in the
backward pass on the CPU, never on the card, where kernels F-I run.
`visnet_equihnn` (TrunkFull) and `visnet_equihnnm` (TrunkM) wait for
ROADMAP item 2. Configurations the port does not support yet raise here:
`compute_dtype` other than float32, `remat`.
"""

from __future__ import annotations

import torch
from torch import nn

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import check_compute
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.models.trunks import TrunkS
from equihgnn_tpu_torch.nn.visnet import ViSNet


@registry.register_model("visnet_equihnns")
class VisNetEquiHNNS(nn.Module):
    """Weights are drawn on the CPU from `generator` (seed 0 when None),
    so one seed gives the same model on every device, then moved to
    `device`."""

    def __init__(self, num_target: int, cfg: ModelConfig, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_compute(cfg, "visnet_equihnns")
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.num_target, self.cfg = num_target, cfg
        self.visnet_layer = ViSNet(hidden_channels=cfg.mlp_hidden, lmax=2, max_num_neighbors=16,
                                   generator=gen)
        self.trunk = TrunkS(num_target, cfg, generator=gen)
        self.to(device)

    def encode(self, batch: HyperGraphBatch) -> torch.Tensor:
        if batch.pos is None or batch.slot_index is None:
            raise ValueError(
                "visnet_equihnn* models need 3-D coordinates and the slot view: "
                "build batches with with_pos=True and max_atoms_per_graph > 0"
            )
        return self.visnet_layer(batch.atom_feat, batch.pos, batch.atom_row, batch.slot_index,
                                 batch.slot_mask, batch.atom_slot, slot_gid=batch.slot_gid)

    def forward(self, batch: HyperGraphBatch) -> torch.Tensor:
        """[num_graphs] float32 predictions (padding graph included)."""
        return self.trunk(self.encode(batch), batch)
