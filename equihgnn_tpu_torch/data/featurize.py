"""Molecule → (hyper)graph featurization (host-side, numpy).

Copy of `mol_to_hypergraph`, `mol_to_graph`, `mol_from_smiles`,
`smiles_to_hypergraph` and their helpers from
`equihgnn_tpu/data/featurize.py`, with import paths changed:
OGB-compatible 9-dim atom and 3-dim bond features; as a hypergraph, one
order-2 hyperedge per bond (feature = bond type) and one hyperedge per
conjugated group (feature = 5); as a plain graph (`mol2graph`), each bond
in both directions with its 3 bond features.
Molecules from the first-party SDF reader (`data/chem.py`) and SMILES
parser (`data/smiles.py`) carry their own conjugation perception; RDKit
is imported only for RDKit molecules, and parses SMILES where installed.
"""

from __future__ import annotations

import numpy as np

from equihgnn_tpu_torch.data.structures import CONJ_HEDGE_TYPE, GraphSample, HyperGraphSample


def _require_rdkit():
    try:
        from rdkit import Chem  # noqa: F401

        return Chem
    except ImportError as e:  # pragma: no cover - env without rdkit
        raise ImportError(
            "RDKit is required to featurize RDKit molecules; molecules from "
            "the first-party SDF reader (data/sdf.py) need none."
        ) from e


# --------------------------------------------------------------- OGB features
_CHIRALITY = ["CHI_UNSPECIFIED", "CHI_TETRAHEDRAL_CW", "CHI_TETRAHEDRAL_CCW", "CHI_OTHER"]
_HYBRIDIZATION = ["SP", "SP2", "SP3", "SP3D", "SP3D2", "misc"]
_BOND_TYPE = ["SINGLE", "DOUBLE", "TRIPLE", "AROMATIC", "misc"]
_BOND_STEREO = [
    "STEREONONE", "STEREOZ", "STEREOE", "STEREOCIS", "STEREOTRANS", "STEREOANY",
]


def _safe_index(lst, x):
    try:
        return lst.index(x)
    except ValueError:
        return len(lst) - 1


def atom_to_feature_vector(atom) -> list[int]:
    """OGB `atom_to_feature_vector` (vocab (119,4,12,12,10,6,6,2,2))."""
    num = atom.GetAtomicNum()
    return [
        num - 1 if 1 <= num <= 118 else 118,
        _safe_index(_CHIRALITY, str(atom.GetChiralTag())),
        _safe_index(list(range(11)) + ["misc"], atom.GetTotalDegree()),
        _safe_index(list(range(-5, 6)) + ["misc"], atom.GetFormalCharge()),
        _safe_index(list(range(9)) + ["misc"], atom.GetTotalNumHs()),
        _safe_index(list(range(5)) + ["misc"], atom.GetNumRadicalElectrons()),
        _safe_index(_HYBRIDIZATION, str(atom.GetHybridization())),
        int(atom.GetIsAromatic()),
        int(atom.IsInRing()),
    ]


def bond_to_feature_vector(bond) -> list[int]:
    """OGB `bond_to_feature_vector` (vocab (5,6,2))."""
    return [
        _safe_index(_BOND_TYPE, str(bond.GetBondType())),
        _safe_index(_BOND_STEREO, str(bond.GetStereo())),
        int(bond.GetIsConjugated()),
    ]


def conjugated_groups(mol):
    """(node_idx, hedge_idx) membership of conjugated π-systems (`he_conj`)."""
    if hasattr(mol, "GetAtomConjGrpIdx"):
        reso = mol
    else:
        Chem = _require_rdkit()
        reso = Chem.ResonanceMolSupplier(mol)
    num_he = reso.GetNumConjGrps()
    n_idx, e_idx = [], []
    for i in range(mol.GetNumAtoms()):
        g = reso.GetAtomConjGrpIdx(i)
        # -1 < g < num_he: some RDKit builds return huge unsigned values for
        # non-conjugated atoms
        if -1 < g < num_he:
            n_idx.append(i)
            e_idx.append(g)
    return n_idx, e_idx


def mol_to_hypergraph(mol, y=None, pos=None, z=None) -> HyperGraphSample:
    """≡ `mol2hgraph`: bond hyperedges (order 2) + conjugated-group hyperedges.

    A bond-less molecule gives a sample with no hyperedges.
    """
    atom_feat = np.array(
        [atom_to_feature_vector(a) for a in mol.GetAtoms()], dtype=np.int32
    )
    bonds = mol.GetBonds()
    n_idx: list[int] = []
    e_idx: list[int] = []
    hedge_feat: list[int] = []
    for i, bond in enumerate(bonds):
        n_idx += [bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()]
        e_idx += [i, i]
        hedge_feat.append(bond_to_feature_vector(bond)[0])

    if bonds:
        he_n, he_e = conjugated_groups(mol)
        if he_n:
            num_bond = len(bonds)
            n_idx += he_n
            e_idx += [g + num_bond for g in he_e]
            hedge_feat += len(set(he_e)) * [CONJ_HEDGE_TYPE]

    vertex_idx = np.asarray(n_idx, dtype=np.int64)
    hedge_idx = np.asarray(e_idx, dtype=np.int64)
    # Stably sort incidence by hyperedge id: conjugated-group ids come in
    # discovery order, so the conjugated tail of e_idx can be non-monotonic.
    # The hyperedge-direction reduction runs the sorted-segment-sum kernel
    # (ops/kernels/segment_sum.py), which needs sorted ids; the reduction
    # is permutation-invariant, so sorting here changes no result.
    order = np.argsort(hedge_idx, kind="stable")
    vertex_idx, hedge_idx = vertex_idx[order], hedge_idx[order]

    return HyperGraphSample(
        atom_feat=atom_feat,
        vertex_idx=vertex_idx,
        hedge_idx=hedge_idx,
        hedge_feat=np.asarray(hedge_feat, dtype=np.int64),
        y=np.asarray(y, dtype=np.float32) if y is not None else np.zeros(1, np.float32),
        pos=None if pos is None else np.asarray(pos, dtype=np.float32),
        z=None if z is None else np.asarray(z, dtype=np.int32),
    )


def mol_from_smiles(smiles: str):
    """RDKit's MolFromSmiles when installed; else the first-party parser
    (`data/smiles.py`). Returns None on unparsable input either way."""
    try:
        Chem = _require_rdkit()
    except ImportError:
        from equihgnn_tpu_torch.data.smiles import parse_smiles

        return parse_smiles(smiles)
    return Chem.MolFromSmiles(smiles)


def smiles_to_hypergraph(smiles: str, y=None) -> HyperGraphSample | None:
    """≡ `smi2hgraph` (`reference utils.py:64-105`); None if unparsable."""
    mol = mol_from_smiles(smiles)
    if mol is None:
        return None
    s = mol_to_hypergraph(mol, y=y)
    s.smi = smiles
    return s


def mol_to_graph(mol, y=None, pos=None, z=None) -> GraphSample:
    """≡ `mol2graph` (`reference utils.py:192-238`): directed both ways."""
    atom_feat = np.array(
        [atom_to_feature_vector(a) for a in mol.GetAtoms()], dtype=np.int32
    )
    src, dst, feats = [], [], []
    for bond in mol.GetBonds():
        i, j = bond.GetBeginAtomIdx(), bond.GetEndAtomIdx()
        f = bond_to_feature_vector(bond)
        src += [i, j]
        dst += [j, i]
        feats += [f, f]
    return GraphSample(
        atom_feat=atom_feat,
        edge_src=np.asarray(src, dtype=np.int64),
        edge_dst=np.asarray(dst, dtype=np.int64),
        edge_feat=(
            np.asarray(feats, dtype=np.int64)
            if feats
            else np.zeros((0, 3), dtype=np.int64)
        ),
        y=np.asarray(y, dtype=np.float32) if y is not None else np.zeros(1, np.float32),
        pos=None if pos is None else np.asarray(pos, dtype=np.float32),
        z=None if z is None else np.asarray(z, dtype=np.int32),
    )
