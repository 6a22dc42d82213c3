"""Padding of ragged molecule samples into static-shape batches.

Copy of `spec_for_samples`, `pad_hypergraph_batch` and `iter_batches` from
`equihgnn_tpu/data/batching.py`, cut to what serving needs: hypergraph
batches with one slot row per molecule. Row packing (`pack_slots`) and the
slot-incidence tables are TPU layouts and are not carried over.

A `BatchSpec` fixes (num_graphs, N_pad, E_pad, nnz_pad, A_max). The LAST
graph slot is reserved as the padding graph: padded atoms, hyperedges and
incidence entries all point into it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from equihgnn_tpu_torch.data.structures import (
    NUM_ATOM_FEATURES,
    HyperGraphBatch,
    HyperGraphSample,
)


@dataclass(frozen=True)
class BatchSpec:
    """Static capacities of a padded batch."""

    num_graphs: int  # including the reserved padding graph
    num_atoms: int
    num_hedges: int
    nnz: int  # incidence entries
    max_atoms_per_graph: int = 0  # A_max for the dense slot view

    @property
    def max_real_graphs(self) -> int:
        return self.num_graphs - 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def spec_for_samples(
    samples: Sequence[HyperGraphSample],
    batch_size: int,
    atom_multiple: int = 8,
    headroom: float = 1.05,
) -> BatchSpec:
    """Derive a safe static spec from dataset statistics.

    Capacities are sized so that `batch_size` average molecules fit with
    `headroom`, but never below the largest single molecule plus one.
    """
    n_atoms = np.array([s.n_atoms for s in samples])
    n_edge = np.array([s.n_hedges for s in samples])
    nnz = np.array([s.nnz for s in samples])
    cap = lambda arr: _round_up(
        max(int(batch_size * float(arr.mean()) * headroom), int(arr.max()) + 1),
        atom_multiple,
    )
    return BatchSpec(
        num_graphs=batch_size + 1,
        num_atoms=cap(n_atoms),
        num_hedges=cap(n_edge),
        nnz=cap(nnz),
        max_atoms_per_graph=_round_up(int(n_atoms.max()), atom_multiple),
    )


def pad_hypergraph_batch(
    samples: Sequence[HyperGraphSample],
    spec: BatchSpec,
    with_pos: bool = False,
) -> HyperGraphBatch:
    """Pack molecules into one padded `HyperGraphBatch` (CPU tensors).

    Raises ValueError when the molecules overflow `spec`, or when the
    assembled `hedge_idx` is not non-decreasing: the hyperedge-direction
    reduction runs a sorted-segment-sum kernel that relies on sorted ids,
    and this host check is where that contract is enforced.
    """
    if len(samples) > spec.max_real_graphs:
        raise ValueError(
            f"{len(samples)} molecules > spec capacity {spec.max_real_graphs}"
        )
    G, N, E, Z = spec.num_graphs, spec.num_atoms, spec.num_hedges, spec.nnz
    A = spec.max_atoms_per_graph
    pad_gid = G - 1

    atom_feat = np.zeros((N, NUM_ATOM_FEATURES), dtype=np.int64)
    atom_mask = np.zeros((N,), dtype=bool)
    atom_graph_id = np.full((N,), pad_gid, dtype=np.int64)
    vertex_idx = np.full((Z,), N - 1, dtype=np.int64)
    hedge_idx = np.full((Z,), E - 1, dtype=np.int64)
    inc_mask = np.zeros((Z,), dtype=bool)
    hedge_mask = np.zeros((E,), dtype=bool)
    graph_mask = np.zeros((G,), dtype=bool)
    pos = np.zeros((N, 3), dtype=np.float32) if with_pos else None
    slot_index = np.zeros((G, A), dtype=np.int64) if A else None
    slot_mask = np.zeros((G, A), dtype=bool) if A else None
    slot_gid = np.full((G, A), -1, dtype=np.int64) if A else None
    # padded atoms point at the padding row, never at molecule 0's slots
    atom_slot = np.zeros((N,), dtype=np.int64) if A else None
    atom_row = np.full((N,), G - 1, dtype=np.int64) if A else None

    a0 = e0 = z0 = 0
    for g, s in enumerate(samples):
        na, ne, nz = s.n_atoms, s.n_hedges, s.nnz
        if a0 + na > N or e0 + ne > E or z0 + nz > Z:
            raise ValueError(
                f"Batch overflows spec {spec}: graph {g} needs "
                f"(+{na} atoms, +{ne} hedges, +{nz} nnz) at offsets ({a0},{e0},{z0})"
            )
        atom_feat[a0 : a0 + na] = s.atom_feat
        atom_mask[a0 : a0 + na] = True
        atom_graph_id[a0 : a0 + na] = g
        if A:
            if na > A:
                raise ValueError(f"Molecule with {na} atoms exceeds A_max={A}")
            slot_index[g, :na] = np.arange(a0, a0 + na)
            slot_mask[g, :na] = True
            slot_gid[g, :na] = g
            atom_slot[a0 : a0 + na] = np.arange(na)
            atom_row[a0 : a0 + na] = g
        vertex_idx[z0 : z0 + nz] = s.vertex_idx + a0
        hedge_idx[z0 : z0 + nz] = s.hedge_idx + e0
        inc_mask[z0 : z0 + nz] = True
        hedge_mask[e0 : e0 + ne] = True
        graph_mask[g] = True
        if with_pos:
            if s.pos is None:
                raise ValueError("with_pos=True but sample has no coordinates")
            pos[a0 : a0 + na] = s.pos
        a0, e0, z0 = a0 + na, e0 + ne, z0 + nz

    if np.any(np.diff(hedge_idx) < 0):
        raise ValueError(
            "hedge_idx is not non-decreasing: each sample's incidence must be "
            "sorted by hyperedge id (data/featurize.py sorts it)"
        )
    return HyperGraphBatch.from_numpy(
        atom_feat=atom_feat,
        atom_mask=atom_mask,
        atom_graph_id=atom_graph_id,
        vertex_idx=vertex_idx,
        hedge_idx=hedge_idx,
        inc_mask=inc_mask,
        hedge_mask=hedge_mask,
        graph_mask=graph_mask,
        pos=pos,
        slot_index=slot_index,
        slot_mask=slot_mask,
        slot_gid=slot_gid,
        atom_slot=atom_slot,
        atom_row=atom_row,
    )


def iter_batches(
    samples: Sequence[HyperGraphSample],
    spec: BatchSpec,
    *,
    with_pos: bool = False,
) -> Iterator[HyperGraphBatch]:
    """Greedy packer, in input order: fill each batch until a capacity
    would overflow."""
    cur: list = []
    a = e = z = 0
    for s in samples:
        na, ne, nz = s.n_atoms, s.n_hedges, s.nnz
        over = (
            len(cur) >= spec.max_real_graphs
            or a + na > spec.num_atoms
            or e + ne > spec.num_hedges
            or z + nz > spec.nnz
        )
        if over and cur:
            yield pad_hypergraph_batch(cur, spec, with_pos=with_pos)
            cur, a, e, z = [], 0, 0, 0
        cur.append(s)
        a, e, z = a + na, e + ne, z + nz
    if cur:
        yield pad_hypergraph_batch(cur, spec, with_pos=with_pos)
