"""Synthetic molecule-like samples for tests and the full-size requests
of `chip_smoke.py`.

Copy of `random_hypergraph_sample`, `random_graph_sample` and
`make_synthetic_dataset` from `equihgnn_tpu/data/synthetic.py`, with
import paths changed: random QM9-like molecules (4-29 atoms, tree + ring
bond skeletons, an occasional conjugated hyperedge, 3-D coordinates), as
hypergraphs or as plain graphs whose bonds run both ways, (i, j) then
(j, i). The same seed draws the same molecules as the JAX package.
"""

from __future__ import annotations

import numpy as np

from equihgnn_tpu_torch.data.structures import CONJ_HEDGE_TYPE, GraphSample, HyperGraphSample

_ATOM_VOCAB = np.array([119, 4, 12, 12, 10, 6, 6, 2, 2])
_QM9_Z = np.array([1, 6, 7, 8, 9])  # H C N O F
_QM9_Z_P = np.array([0.51, 0.35, 0.06, 0.07, 0.01])


def _random_atom_feats(rng: np.random.Generator, n: int) -> np.ndarray:
    f = np.stack(
        [rng.integers(0, v, size=n) for v in _ATOM_VOCAB], axis=1
    ).astype(np.int32)
    return f


def _random_tree_bonds(rng: np.random.Generator, n: int):
    """Random spanning tree + a few ring-closing extra bonds."""
    src, dst = [], []
    for i in range(1, n):
        j = int(rng.integers(0, i))
        src.append(j)
        dst.append(i)
    n_extra = int(rng.integers(0, max(1, n // 6) + 1))
    for _ in range(n_extra):
        i, j = rng.integers(0, n, size=2)
        if i != j:
            src.append(int(min(i, j)))
            dst.append(int(max(i, j)))
    return np.array(src), np.array(dst)


def random_hypergraph_sample(
    rng: np.random.Generator,
    min_atoms: int = 4,
    max_atoms: int = 29,
    num_targets: int = 16,
    with_pos: bool = True,
) -> HyperGraphSample:
    n = int(rng.integers(min_atoms, max_atoms + 1))
    src, dst = _random_tree_bonds(rng, n)
    nb = len(src)

    # bond hyperedges: order 2, bond-type feature in 0..3
    vertex_idx = np.empty(2 * nb, dtype=np.int64)
    hedge_idx = np.empty(2 * nb, dtype=np.int64)
    vertex_idx[0::2], vertex_idx[1::2] = src, dst
    hedge_idx[0::2] = hedge_idx[1::2] = np.arange(nb)
    hedge_feat = rng.integers(0, 4, size=nb).astype(np.int64)

    # occasionally one conjugated group hyperedge over a contiguous atom run
    if n >= 6 and rng.random() < 0.6:
        k = int(rng.integers(3, min(n, 10)))
        start = int(rng.integers(0, n - k + 1))
        members = np.arange(start, start + k)
        vertex_idx = np.concatenate([vertex_idx, members])
        hedge_idx = np.concatenate([hedge_idx, np.full(k, nb)])
        hedge_feat = np.concatenate([hedge_feat, [CONJ_HEDGE_TYPE]])

    pos = None
    zvec = None
    if with_pos:
        pos = (rng.standard_normal((n, 3)) * 1.5).astype(np.float32)
        zvec = rng.choice(_QM9_Z, size=n, p=_QM9_Z_P).astype(np.int32)

    y = rng.standard_normal(num_targets).astype(np.float32)
    return HyperGraphSample(
        atom_feat=_random_atom_feats(rng, n),
        vertex_idx=vertex_idx.astype(np.int64),
        hedge_idx=hedge_idx.astype(np.int64),
        hedge_feat=hedge_feat,
        y=y,
        pos=pos,
        z=zvec,
    )


def random_graph_sample(
    rng: np.random.Generator,
    min_atoms: int = 4,
    max_atoms: int = 29,
    num_targets: int = 16,
    with_pos: bool = True,
) -> GraphSample:
    n = int(rng.integers(min_atoms, max_atoms + 1))
    src, dst = _random_tree_bonds(rng, n)
    # directed both ways, as mol2graph does (`reference data/utils.py:213-218`)
    edge_src = np.concatenate([src, dst]).astype(np.int64)
    edge_dst = np.concatenate([dst, src]).astype(np.int64)
    nb = len(src)
    ef = np.stack(
        [
            rng.integers(0, 5, size=nb),
            rng.integers(0, 6, size=nb),
            rng.integers(0, 2, size=nb),
        ],
        axis=1,
    ).astype(np.int64)
    edge_feat = np.concatenate([ef, ef], axis=0)
    # interleave to match (i,j),(j,i) adjacency ordering
    order = np.empty(2 * nb, dtype=np.int64)
    order[0::2] = np.arange(nb)
    order[1::2] = np.arange(nb) + nb
    edge_src, edge_dst, edge_feat = edge_src[order], edge_dst[order], edge_feat[order]

    pos = (rng.standard_normal((n, 3)) * 1.5).astype(np.float32) if with_pos else None
    zvec = rng.choice(_QM9_Z, size=n, p=_QM9_Z_P).astype(np.int32) if with_pos else None
    y = rng.standard_normal(num_targets).astype(np.float32)
    return GraphSample(
        atom_feat=_random_atom_feats(rng, n),
        edge_src=edge_src,
        edge_dst=edge_dst,
        edge_feat=edge_feat,
        y=y,
        pos=pos,
        z=zvec,
    )


def make_synthetic_dataset(
    n: int,
    seed: int = 0,
    hyper: bool = True,
    with_pos: bool = True,
    num_targets: int = 16,
    min_atoms: int = 4,
    max_atoms: int = 29,
) -> list[HyperGraphSample] | list[GraphSample]:
    rng = np.random.default_rng(seed)
    gen = random_hypergraph_sample if hyper else random_graph_sample
    return [
        gen(
            rng,
            min_atoms=min_atoms,
            max_atoms=max_atoms,
            num_targets=num_targets,
            with_pos=with_pos,
        )
        for _ in range(n)
    ]
