"""Registered synthetic datasets `synthetic_hg`, `synthetic_hg_3d`,
`synthetic_g` and `synthetic_g_3d` (RDKit-free, offline).

Copy of `equihgnn_tpu/data/datasets/synthetic_ds.py`: QM9-like hypergraphs
(`synthetic_hg*`, `hyper = True`) or plain graphs (`synthetic_g*`, for the
2-D baselines), without or with (`*_3d`) 3-D coordinates, and 16 random
regression targets, drawn by `data/synthetic.py` from `seed` (default 0),
`size` molecules (default 4096). The same size and seed give the same
molecules as the JAX package. Without coordinates no positions or atomic
numbers are drawn, so the sets with and without coordinates differ from
the first molecule on, in JAX as here.
"""

from __future__ import annotations

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.datasets.base import MolDataset
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset


class _SyntheticBase(MolDataset):
    num_targets = 16
    default_size = 4096

    def process(self):
        return make_synthetic_dataset(
            int(self.kwargs.get("size") or self.default_size),
            seed=int(self.kwargs.get("seed") or 0),
            hyper=self.hyper,
            with_pos=self.has_pos,
            num_targets=self.num_targets,
        )


@registry.register_data("synthetic_hg")
class SyntheticHGraph(_SyntheticBase):
    name = "synthetic_hg"
    hyper = True
    has_pos = False


@registry.register_data("synthetic_hg_3d")
class SyntheticHGraph3D(_SyntheticBase):
    name = "synthetic_hg_3d"
    hyper = True
    has_pos = True


@registry.register_data("synthetic_g")
class SyntheticGraph(_SyntheticBase):
    name = "synthetic_g"
    hyper = False
    has_pos = False


@registry.register_data("synthetic_g_3d")
class SyntheticGraph3D(_SyntheticBase):
    name = "synthetic_g_3d"
    hyper = False
    has_pos = True
