"""Dataset registry of the port — importing this package registers every
ported dataset name (today: `synthetic_hg`, `synthetic_hg_3d`). The other
names of `equihgnn_tpu/data/datasets/__init__.py` (QM9, OPV, PCQM4Mv2,
Molecule3D, the 2-D synthetic sets) are not ported yet."""

from equihgnn_tpu_torch.data.datasets.base import MolDataset  # noqa: F401
from equihgnn_tpu_torch.data.datasets.synthetic_ds import (  # noqa: F401
    SyntheticHGraph,
    SyntheticHGraph3D,
)
