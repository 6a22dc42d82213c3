"""Host samples and the padded device batches of the PyTorch port.

`HyperGraphSample`, `GraphSample` and the feature vocabularies are copied
from `equihgnn_tpu/data/structures.py`. `HyperGraphBatch` is that module's
batch as a plain dataclass of torch tensors, cut to the fields the serving and
training paths read: the atoms, the incidence arrays, the hyperedges'
features, mask, graph ids and orders (`hedge_feat`, `hedge_mask`,
`hedge_graph_id`, `e_order`: the MHNN trunk's hyperedge encoder and its
conjugated readout), the graph mask, the targets, the coordinates and the
dense slot view of the geometric encoders. The JAX
batch's slot-incidence tables are a TPU layout and have no counterpart.
`GraphBatch` is the plain-graph batch of the 2-D baselines, cut to its flat
fields: the dense per-molecule edge slots (`slot_index`, `eslot_*`) exist
for JAX's one-hot GAT on the TPU and have no counterpart either.

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
BOND_FEATURE_DIMS = (5, 6, 2)
NUM_ATOM_FEATURES = len(ATOM_FEATURE_DIMS)  # 9
NUM_BOND_FEATURES = len(BOND_FEATURE_DIMS)  # 3
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

    def e_order(self) -> np.ndarray:
        """Member count per hyperedge (`reference equihgnn/data/utils.py:57-61`)."""
        return np.bincount(self.hedge_idx, minlength=self.n_hedges).astype(np.int32)


@dataclass
class GraphSample:
    """One molecule as a plain directed-both-ways graph (host-side, ragged);
    the output of `mol2graph` (`reference equihgnn/data/utils.py:192-238`)."""

    atom_feat: np.ndarray  # [n_atoms, 9] int
    edge_src: np.ndarray  # [n_edges] int
    edge_dst: np.ndarray  # [n_edges] int
    edge_feat: np.ndarray  # [n_edges, 3] int (1 column in the QM9 graph variants)
    y: np.ndarray  # [num_targets] float
    pos: np.ndarray | None = None
    z: np.ndarray | None = None
    smi: str | None = None

    @property
    def n_atoms(self) -> int:
        return int(self.atom_feat.shape[0])

    @property
    def n_edges(self) -> int:
        return int(self.edge_src.shape[0])


class _TensorBatch:
    """What the trainer and `predict` use of a padded batch: wrapping numpy
    arrays, moving and pinning every tensor field, the static sizes."""

    @classmethod
    def from_numpy(cls, **arrays):
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

    def _map(self, fn):
        return dataclasses.replace(
            self,
            **{
                f.name: fn(getattr(self, f.name))
                for f in dataclasses.fields(self)
                if getattr(self, f.name) is not None
            },
        )

    def to(self, device, non_blocking: bool = False):
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def pin_memory(self):
        """A copy in page-locked host memory, so that `to(cuda,
        non_blocking=True)` copies without blocking the host."""
        return self._map(torch.Tensor.pin_memory)

    @property
    def num_atoms(self) -> int:
        return self.atom_feat.shape[-2]

    @property
    def num_graphs(self) -> int:
        return self.graph_mask.shape[-1]


@dataclass
class HyperGraphBatch(_TensorBatch):
    """Static-shape padded batch of molecular hypergraphs (torch tensors).

    Index arrays are int64, masks bool, coordinates float32.
    """

    atom_feat: torch.Tensor  # [N_pad, 9] int64
    atom_mask: torch.Tensor  # [N_pad] bool
    atom_graph_id: torch.Tensor  # [N_pad] int64 (padding → num_graphs - 1)
    vertex_idx: torch.Tensor  # [nnz_pad] int64 into atoms
    hedge_idx: torch.Tensor  # [nnz_pad] int64 into hyperedges, non-decreasing
    inc_mask: torch.Tensor  # [nnz_pad] bool
    hedge_feat: torch.Tensor  # [E_pad] int64 (bond type, 5 = conjugated; 0 on padding)
    hedge_mask: torch.Tensor  # [E_pad] bool
    hedge_graph_id: torch.Tensor  # [E_pad] int64 (padding → num_graphs - 1)
    e_order: torch.Tensor  # [E_pad] int64 members per hyperedge (0 on padding)
    graph_mask: torch.Tensor  # [num_graphs] bool
    y: torch.Tensor  # [num_graphs] float32 targets (0 on padding graphs)
    pos: torch.Tensor | None = None  # [N_pad, 3] float32
    # dense slot view for the EGNN encoder: one row per molecule slot
    slot_index: torch.Tensor | None = None  # [R, A_max] flat atom index
    slot_mask: torch.Tensor | None = None  # [R, A_max] bool
    slot_gid: torch.Tensor | None = None  # [R, A_max] molecule id (-1 pad)
    atom_slot: torch.Tensor | None = None  # [N_pad] slot within row
    atom_row: torch.Tensor | None = None  # [N_pad] row index

    @property
    def num_hedges(self) -> int:
        return self.hedge_mask.shape[-1]


@dataclass
class GraphBatch(_TensorBatch):
    """Static-shape padded batch of plain molecular graphs (torch tensors):
    int64 indices, bool masks, float32 coordinates. Padded edges point at
    the last atom with `edge_mask` False; padded atoms belong to the last
    graph, the padding graph."""

    atom_feat: torch.Tensor  # [N_pad, 9] int64
    atom_mask: torch.Tensor  # [N_pad] bool
    atom_graph_id: torch.Tensor  # [N_pad] int64 (padding → num_graphs - 1)
    edge_src: torch.Tensor  # [M_pad] int64 (padding → N_pad - 1)
    edge_dst: torch.Tensor  # [M_pad] int64 (padding → N_pad - 1)
    edge_mask: torch.Tensor  # [M_pad] bool
    edge_feat: torch.Tensor  # [M_pad, 3 or 1] int64
    y: torch.Tensor  # [num_graphs] float32 targets (0 on padding graphs)
    graph_mask: torch.Tensor  # [num_graphs] bool
    pos: torch.Tensor | None = None  # [N_pad, 3] float32
    z: torch.Tensor | None = None  # [N_pad] int64 atomic numbers
