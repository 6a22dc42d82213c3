"""Padding of ragged molecule samples into static-shape batches.

Copy of `spec_for_samples`, `pad_hypergraph_batch`, `pad_graph_batch` and
`iter_batches` from `equihgnn_tpu/data/batching.py`, cut to what serving
and training need: hypergraph batches with one slot row per molecule,
plain-graph batches (flat fields only), their targets, and the shuffled
epoch order. Row packing (`pack_slots`), the slot-incidence tables and the
plain graphs' per-molecule edge slots are TPU layouts and are not carried
over.

A `BatchSpec` fixes (num_graphs, N_pad, E_pad, nnz_pad, A_max); for plain
graphs E_pad counts edge slots. The LAST graph slot is reserved as the
padding graph: padded atoms, hyperedges and incidence entries all point
into it; padded edges point at the last atom.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Sequence

import numpy as np

from equihgnn_tpu_torch.data.structures import (
    NUM_ATOM_FEATURES,
    NUM_BOND_FEATURES,
    GraphBatch,
    GraphSample,
    HyperGraphBatch,
    HyperGraphSample,
)


@dataclass(frozen=True)
class BatchSpec:
    """Static capacities of a padded batch."""

    num_graphs: int  # including the reserved padding graph
    num_atoms: int
    num_hedges: int  # hyperedge slots (hypergraph) / edge slots (graph)
    nnz: int  # incidence entries (hypergraph only)
    max_atoms_per_graph: int = 0  # A_max for the dense slot view

    @property
    def max_real_graphs(self) -> int:
        return self.num_graphs - 1


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def spec_for_samples(
    samples: Sequence[HyperGraphSample] | Sequence[GraphSample],
    batch_size: int,
    atom_multiple: int = 8,
    headroom: float = 1.05,
) -> BatchSpec:
    """Derive a safe static spec from dataset statistics.

    Capacities are sized so that `batch_size` average molecules fit with
    `headroom`, but never below the largest single molecule plus one.
    """
    n_atoms = np.array([s.n_atoms for s in samples])
    if isinstance(samples[0], GraphSample):
        n_edge = nnz = np.array([s.n_edges for s in samples])
    else:
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
    target: int | None = None,
    with_pos: bool = False,
) -> HyperGraphBatch:
    """Pack molecules into one padded `HyperGraphBatch` (CPU tensors).

    `target` selects a single column of `y` (the `OneTarget` transform);
    pass None if `y` is already scalar per molecule.

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
    hedge_feat = np.zeros((E,), dtype=np.int64)
    hedge_mask = np.zeros((E,), dtype=bool)
    hedge_graph_id = np.full((E,), pad_gid, dtype=np.int64)
    e_order = np.zeros((E,), dtype=np.int64)
    y = np.zeros((G,), dtype=np.float32)
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
        hedge_feat[e0 : e0 + ne] = s.hedge_feat
        hedge_mask[e0 : e0 + ne] = True
        hedge_graph_id[e0 : e0 + ne] = g
        e_order[e0 : e0 + ne] = s.e_order()
        yv = s.y if target is None else np.asarray(s.y).reshape(-1)[target]
        y[g] = np.asarray(yv, dtype=np.float32).reshape(())
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
        hedge_feat=hedge_feat,
        hedge_mask=hedge_mask,
        hedge_graph_id=hedge_graph_id,
        e_order=e_order,
        graph_mask=graph_mask,
        y=y,
        pos=pos,
        slot_index=slot_index,
        slot_mask=slot_mask,
        slot_gid=slot_gid,
        atom_slot=atom_slot,
        atom_row=atom_row,
    )


def pad_graph_batch(
    samples: Sequence[GraphSample],
    spec: BatchSpec,
    target: int | None = None,
    with_pos: bool = False,
    edge_feat_width: int | None = None,
) -> GraphBatch:
    """Pack plain molecular graphs into one padded `GraphBatch` (CPU
    tensors). The edge features keep the samples' width: 3 columns from
    `mol2graph`, 1 (the bond type) in the QM9 graph variants
    (`reference equihgnn/data/qm9.py:309-319`); `edge_feat_width` sets it
    for a batch of no molecules."""
    if len(samples) > spec.max_real_graphs:
        raise ValueError(
            f"{len(samples)} molecules > spec capacity {spec.max_real_graphs}"
        )
    G, N, M = spec.num_graphs, spec.num_atoms, spec.num_hedges
    pad_gid = G - 1
    ef_width = edge_feat_width or (
        samples[0].edge_feat.shape[1] if samples and samples[0].edge_feat.size
        else NUM_BOND_FEATURES
    )

    atom_feat = np.zeros((N, NUM_ATOM_FEATURES), dtype=np.int64)
    atom_mask = np.zeros((N,), dtype=bool)
    atom_graph_id = np.full((N,), pad_gid, dtype=np.int64)
    edge_src = np.full((M,), N - 1, dtype=np.int64)
    edge_dst = np.full((M,), N - 1, dtype=np.int64)
    edge_mask = np.zeros((M,), dtype=bool)
    edge_feat = np.zeros((M, ef_width), dtype=np.int64)
    y = np.zeros((G,), dtype=np.float32)
    graph_mask = np.zeros((G,), dtype=bool)
    pos = np.zeros((N, 3), dtype=np.float32) if with_pos else None
    z = np.zeros((N,), dtype=np.int64) if with_pos else None

    a0 = m0 = 0
    for g, s in enumerate(samples):
        na, nm = s.n_atoms, s.n_edges
        if a0 + na > N or m0 + nm > M:
            raise ValueError(
                f"Batch overflows spec {spec}: graph {g} needs (+{na} atoms, +{nm} edges) "
                f"at offsets ({a0},{m0})"
            )
        atom_feat[a0 : a0 + na] = s.atom_feat
        atom_mask[a0 : a0 + na] = True
        atom_graph_id[a0 : a0 + na] = g
        edge_src[m0 : m0 + nm] = s.edge_src + a0
        edge_dst[m0 : m0 + nm] = s.edge_dst + a0
        edge_mask[m0 : m0 + nm] = True
        edge_feat[m0 : m0 + nm] = s.edge_feat
        yv = s.y if target is None else np.asarray(s.y).reshape(-1)[target]
        y[g] = np.asarray(yv, dtype=np.float32).reshape(())
        graph_mask[g] = True
        if with_pos:
            if s.pos is None:
                raise ValueError("with_pos=True but sample has no coordinates")
            pos[a0 : a0 + na] = s.pos
            if s.z is not None:
                z[a0 : a0 + na] = s.z
        a0, m0 = a0 + na, m0 + nm

    return GraphBatch.from_numpy(
        atom_feat=atom_feat,
        atom_mask=atom_mask,
        atom_graph_id=atom_graph_id,
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_mask=edge_mask,
        edge_feat=edge_feat,
        y=y,
        graph_mask=graph_mask,
        pos=pos,
        z=z,
    )


def iter_batches(
    samples: Sequence[HyperGraphSample] | Sequence[GraphSample],
    spec: BatchSpec,
    *,
    hyper: bool = True,
    target: int | None = None,
    with_pos: bool = False,
    shuffle: bool = False,
    rng: np.random.Generator | None = None,
) -> Iterator[HyperGraphBatch] | Iterator[GraphBatch]:
    """Greedy packer: fill each batch until a capacity would overflow. With
    `hyper` (the default) the samples are `HyperGraphSample`s and the
    batches `HyperGraphBatch`es; else `GraphSample`s and `GraphBatch`es.
    With `shuffle`, the order is drawn from `rng` (a fresh generator if
    None)."""
    order = np.arange(len(samples))
    if shuffle:
        (rng or np.random.default_rng()).shuffle(order)
    pad = pad_hypergraph_batch if hyper else pad_graph_batch
    cur: list = []
    a = e = z = 0
    for i in order:
        s = samples[int(i)]
        if hyper:
            na, ne, nz = s.n_atoms, s.n_hedges, s.nnz
        else:
            na, ne, nz = s.n_atoms, s.n_edges, 0
        over = (
            len(cur) >= spec.max_real_graphs
            or a + na > spec.num_atoms
            or e + ne > spec.num_hedges
            or z + nz > spec.nnz
        )
        if over and cur:
            yield pad(cur, spec, target=target, with_pos=with_pos)
            cur, a, e, z = [], 0, 0, 0
        cur.append(s)
        a, e, z = a + na, e + ne, z + nz
    if cur:
        yield pad(cur, spec, target=target, with_pos=with_pos)
