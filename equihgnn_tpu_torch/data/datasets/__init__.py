"""Dataset registry of the port — importing this package registers every
ported dataset name: `synthetic_hg`, `synthetic_hg_3d` (hypergraphs) and
`synthetic_g`, `synthetic_g_3d` (plain graphs, for the 2-D baselines). The
other names of `equihgnn_tpu/data/datasets/__init__.py` (QM9, OPV,
PCQM4Mv2, Molecule3D) are not ported yet."""

from equihgnn_tpu_torch.data.datasets.base import MolDataset  # noqa: F401
from equihgnn_tpu_torch.data.datasets.synthetic_ds import (  # noqa: F401
    SyntheticGraph,
    SyntheticGraph3D,
    SyntheticHGraph,
    SyntheticHGraph3D,
)
