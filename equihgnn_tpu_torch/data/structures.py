"""Host samples and the padded device batch of the PyTorch port.

`HyperGraphSample` and the feature vocabularies are copied from
`equihgnn_tpu/data/structures.py`. `HyperGraphBatch` is that module's batch
as a plain dataclass of torch tensors, cut to the fields the serving path
reads: the atoms, the incidence arrays, the hyperedge mask, the graph mask,
the coordinates and the dense slot view of the EGNN encoder. The JAX
batch's slot-incidence tables are a TPU layout and have no counterpart.

Padding convention (as in the JAX package): a batch holds `num_graphs`
slots and the LAST slot is the padding graph that absorbs every padded
atom, hyperedge and incidence entry, so every index stays in range and
every reduction is exact after masking.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

# OGB-compatible feature vocabularies (`equihgnn_tpu/data/structures.py`).
ATOM_FEATURE_DIMS = (119, 4, 12, 12, 10, 6, 6, 2, 2)
NUM_ATOM_FEATURES = len(ATOM_FEATURE_DIMS)  # 9
# Hyperedge feature: bond type 0..4 or 5 for a conjugated-group hyperedge.
NUM_HEDGE_TYPES = 6
CONJ_HEDGE_TYPE = 5


@dataclass
class HyperGraphSample:
    """One molecule as a hypergraph (host-side, numpy, ragged)."""

    atom_feat: np.ndarray  # [n_atoms, 9] int
    vertex_idx: np.ndarray  # [nnz] int   incidence: which atom
    hedge_idx: np.ndarray  # [nnz] int    incidence: which hyperedge
    hedge_feat: np.ndarray  # [n_hedges] int (bond type / 5=conjugated)
    y: np.ndarray  # [num_targets] float
    pos: np.ndarray | None = None  # [n_atoms, 3] float
    z: np.ndarray | None = None  # [n_atoms] int atomic numbers
    smi: str | None = None

    @property
    def n_atoms(self) -> int:
        return int(self.atom_feat.shape[0])

    @property
    def n_hedges(self) -> int:
        return int(self.hedge_feat.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.vertex_idx.shape[0])


@dataclass
class HyperGraphBatch:
    """Static-shape padded batch of molecular hypergraphs (torch tensors).

    Index arrays are int64, masks bool, coordinates float32.
    """

    atom_feat: torch.Tensor  # [N_pad, 9] int64
    atom_mask: torch.Tensor  # [N_pad] bool
    atom_graph_id: torch.Tensor  # [N_pad] int64 (padding → num_graphs - 1)
    vertex_idx: torch.Tensor  # [nnz_pad] int64 into atoms
    hedge_idx: torch.Tensor  # [nnz_pad] int64 into hyperedges, non-decreasing
    inc_mask: torch.Tensor  # [nnz_pad] bool
    hedge_mask: torch.Tensor  # [E_pad] bool
    graph_mask: torch.Tensor  # [num_graphs] bool
    pos: torch.Tensor | None = None  # [N_pad, 3] float32
    # dense slot view for the EGNN encoder: one row per molecule slot
    slot_index: torch.Tensor | None = None  # [R, A_max] flat atom index
    slot_mask: torch.Tensor | None = None  # [R, A_max] bool
    slot_gid: torch.Tensor | None = None  # [R, A_max] molecule id (-1 pad)
    atom_slot: torch.Tensor | None = None  # [N_pad] slot within row
    atom_row: torch.Tensor | None = None  # [N_pad] row index

    @classmethod
    def from_numpy(cls, **arrays) -> "HyperGraphBatch":
        """Wrap numpy arrays: integer arrays become int64, floats float32."""

        def conv(a):
            if a is None:
                return None
            a = np.asarray(a)
            if a.dtype == np.bool_:
                return torch.from_numpy(a)
            if np.issubdtype(a.dtype, np.integer):
                return torch.from_numpy(a.astype(np.int64))
            return torch.from_numpy(a.astype(np.float32))

        return cls(**{k: conv(v) for k, v in arrays.items()})

    def to(self, device) -> "HyperGraphBatch":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name).to(device)
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None
            },
        )

    @property
    def num_atoms(self) -> int:
        return self.atom_feat.shape[-2]

    @property
    def num_hedges(self) -> int:
        return self.hedge_mask.shape[-1]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[-1]
