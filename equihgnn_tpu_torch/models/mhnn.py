"""The MHNN family: `mhnn`, `mhnns`, `mhnnm`.

Port of `equihgnn_tpu/models/mhnn.py` (`_MHNNBase` `:20-28`, `MHNN` `:31`,
`MHNNS` `:44`, `MHNNM` `:56`), itself the reference's `mhnn.py:11-218`:
the OGB atom embedding, then the hypergraph trunk (`TrunkFull`, `TrunkS`
or `TrunkM`). No coordinates are read: these models train on
`synthetic_hg` and serve from any SDF. With `compute_dtype="bfloat16"`
the atom embedding is cast (`equihgnn_tpu/models/mhnn.py:28`) and the
trunk computes in bf16 up to its float32 prediction.
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import HyperGraphBatch
from equihgnn_tpu_torch.models.common import HybridModel, cast_compute
from equihgnn_tpu_torch.models.trunks import TrunkFull, TrunkM, TrunkS
from equihgnn_tpu_torch.nn.encoders import AtomEncoder


class _MHNNBase(HybridModel):
    def build_encoder(self, cfg, generator):
        self.atom_encoder = AtomEncoder(cfg.mlp_hidden, generator=generator)

    def encode(self, batch: HyperGraphBatch):
        return cast_compute(self.cfg, self.atom_encoder(batch.atom_feat))


@registry.register_model("mhnn")
class MHNN(_MHNNBase):
    """Shared-parameter bipartite MHNN with conjugated-hyperedge readout
    (`reference mhnn.py:11-81`)."""

    METHOD, TRUNK = "mhnn", TrunkFull


@registry.register_model("mhnns")
class MHNNS(_MHNNBase):
    """Simple/fast shared-parameter variant (`reference mhnn.py:84-141`)."""

    METHOD, TRUNK = "mhnns", TrunkS


@registry.register_model("mhnnm")
class MHNNM(_MHNNBase):
    """Per-layer parameters + BatchNorm variant (`reference mhnn.py:144-218`)."""

    METHOD, TRUNK = "mhnnm", TrunkM
