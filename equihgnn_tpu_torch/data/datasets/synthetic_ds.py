"""Registered synthetic datasets `synthetic_hg` and `synthetic_hg_3d`
(RDKit-free, offline).

Copy of `SyntheticHGraph` and `SyntheticHGraph3D` from
`equihgnn_tpu/data/datasets/synthetic_ds.py`: QM9-like hypergraphs, without
(`synthetic_hg`) or with (`synthetic_hg_3d`) 3-D coordinates, and 16 random
regression targets, drawn by `data/synthetic.py` from `seed` (default 0),
`size` molecules (default 4096). The same size and seed give the same
molecules as the JAX package. Without coordinates no positions or atomic
numbers are drawn, so `synthetic_hg` and `synthetic_hg_3d` differ from the
first molecule on, in JAX as here.
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.datasets.base import MolDataset
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset


class _SyntheticBase(MolDataset):
    hyper = True
    num_targets = 16
    default_size = 4096

    def process(self):
        return make_synthetic_dataset(
            int(self.kwargs.get("size") or self.default_size),
            seed=int(self.kwargs.get("seed") or 0),
            with_pos=self.has_pos,
            num_targets=self.num_targets,
        )


@registry.register_data("synthetic_hg")
class SyntheticHGraph(_SyntheticBase):
    name = "synthetic_hg"
    has_pos = False


@registry.register_data("synthetic_hg_3d")
class SyntheticHGraph3D(_SyntheticBase):
    name = "synthetic_hg_3d"
    has_pos = True
