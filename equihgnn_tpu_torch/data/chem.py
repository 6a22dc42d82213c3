"""Copy of `equihgnn_tpu/data/chem.py`, unchanged (pure Python + numpy).

First-party molecular perception: the minimal slice of RDKit the data
layer depends on, re-derived from first principles so REAL molecules can flow
through the featurizer in an RDKit-free image.

The reference keeps RDKit host-side for three things the hypergraph build
needs (`reference equihgnn/data/utils.py:35-147`):

  1. per-atom features (hybridization, aromaticity, implicit H counts, ...)
  2. bond enumeration with types/stereo/conjugation flags
  3. conjugated-group ids from ``Chem.ResonanceMolSupplier``
     (``GetAtomConjGrpIdx``) — the conjugated π-system hyperedges

This module implements the perception rules behind 2 and 3 and enough of 1
to featurize a molecule parsed from a raw SDF (`data/sdf.py`):

* **Conjugation** replicates RDKit's ``setConjugation``
  (rdkit GraphMol/Conjugation.cpp): for every atom, every PAIR of its bonds
  with at least one multiple (double/triple/aromatic) member is marked
  conjugated when all three involved atoms are "conjugation candidates"
  (in a multiple bond, or carrying non-bonding electrons). Consequences the
  tests assert on real structures: an isolated C=C or C=O is NOT conjugated
  (no qualifying bond pair), amide N–C=O IS (N lone pair), the biphenyl
  inter-ring single bond IS (both ends aromatic), 1,4-pentadiene's sp³ CH2
  breaks the system in two.
* **Conjugated groups** are connected components of the conjugated-bond
  subgraph, ids in first-bond discovery order — the semantics of
  ``ResonanceMolSupplier``'s per-atom ``GetAtomConjGrpIdx`` that ``he_conj``
  consumes (`utils.py:35-54`); atoms in no conjugated bond get -1.
* **Implicit hydrogens** come from default-valence bookkeeping, so
  heavy-atom-only SDF blocks featurize with correct ``GetTotalNumHs``.
* **Hybridization** is the σ-frame rule (triple/allene → SP, any
  double/aromatic → SP2, else SP3). Known divergence: RDKit promotes some
  conjugated lone-pair heteroatoms (amide N) to SP2; tests only assert the
  unambiguous cases.

Objects expose the exact attribute surface `data/featurize.py`
consumes (GetAtoms / GetBonds / GetAtomConjGrpIdx duck-type, mirrored by
tests/fake_rdkit.py).
"""

from __future__ import annotations

import numpy as np

# valence electrons of the neutral atom (main group)
VALENCE_ELECTRONS = {
    1: 1, 5: 3, 6: 4, 7: 5, 8: 6, 9: 7,
    14: 4, 15: 5, 16: 6, 17: 7, 35: 7, 53: 7,
    32: 4, 33: 5, 34: 6, 50: 4, 52: 6,
}
# default total valence (bond order sum incl. H) used for implicit-H counts
DEFAULT_VALENCE = {
    1: 1, 5: 3, 6: 4, 7: 3, 8: 2, 9: 1,
    14: 4, 15: 3, 16: 2, 17: 1, 35: 1, 53: 1,
    32: 4, 33: 3, 34: 2, 50: 4, 52: 2,
}
SYMBOLS = {
    1: "H", 5: "B", 6: "C", 7: "N", 8: "O", 9: "F",
    14: "Si", 15: "P", 16: "S", 17: "Cl", 35: "Br", 53: "I",
    # bracket-atom elements (OPV chemistry + common salts); metals appear
    # only as bracket atoms whose H count is explicit, so DEFAULT_VALENCE
    # entries are not needed for them
    32: "Ge", 33: "As", 34: "Se", 50: "Sn", 52: "Te",
    3: "Li", 11: "Na", 12: "Mg", 13: "Al", 19: "K", 20: "Ca",
    26: "Fe", 29: "Cu", 30: "Zn",
}
ATOMIC_NUM = {v: k for k, v in SYMBOLS.items()}

BOND_ORDER = {"SINGLE": 1.0, "DOUBLE": 2.0, "TRIPLE": 3.0, "AROMATIC": 1.5}


class Atom:
    """RDKit-``Atom``-shaped view over a `Mol` row (perceived lazily)."""

    def __init__(self, mol: "Mol", idx: int):
        self._m, self._i = mol, idx

    def GetIdx(self):
        return self._i

    def GetAtomicNum(self):
        return self._m.z[self._i]

    def GetSymbol(self):
        return SYMBOLS.get(self._m.z[self._i], "X")

    def GetChiralTag(self):
        return "CHI_UNSPECIFIED"

    def GetTotalDegree(self):
        return len(self._m._adj[self._i]) + self.GetTotalNumHs()

    def GetFormalCharge(self):
        return self._m.charge[self._i]

    def GetTotalNumHs(self):
        return self._m._implicit_h[self._i] + sum(
            1 for j in self._m._adj[self._i] if self._m.z[j] == 1
        )

    def GetNumRadicalElectrons(self):
        return 0

    def GetHybridization(self):
        return self._m._hybrid[self._i]

    def GetIsAromatic(self):
        return self._m._aromatic_atom[self._i]

    def IsInRing(self):
        return self._m._in_ring[self._i]


class Bond:
    def __init__(self, mol: "Mol", idx: int):
        self._m, self._i = mol, idx

    def GetBeginAtomIdx(self):
        return self._m.bonds[self._i][0]

    def GetEndAtomIdx(self):
        return self._m.bonds[self._i][1]

    def GetBondType(self):
        return self._m.bond_types[self._i]

    def GetStereo(self):
        return "STEREONONE"

    def GetIsConjugated(self):
        return bool(self._m._conj_bond[self._i])


class Conformer:
    def __init__(self, pos):
        self.pos = np.asarray(pos, dtype=np.float64)

    def GetPositions(self):
        return self.pos


class Mol:
    """A molecule from explicit (z, bonds, bond_types[, charge, pos]) with
    perception (rings, aromatic flags, implicit H, conjugation, groups) run
    eagerly at construction."""

    def __init__(self, z, bonds, bond_types, charge=None, pos=None,
                 explicit_h=None):
        self.z = [int(a) for a in z]
        self.bonds = [(int(i), int(j)) for i, j in bonds]
        self.bond_types = list(bond_types)
        self.charge = list(charge) if charge is not None else [0] * len(self.z)
        self.conformer = Conformer(pos) if pos is not None else None
        # SMILES bracket atoms carry a FIXED H count ([nH] = exactly 1):
        # explicit_h[i] is None for valence-derived atoms, an int otherwise
        self._explicit_h = (
            list(explicit_h) if explicit_h is not None else [None] * len(self.z)
        )
        n = len(self.z)
        self._adj = [[] for _ in range(n)]
        self._abond = [[] for _ in range(n)]  # bond indices per atom
        for bi, (i, j) in enumerate(self.bonds):
            self._adj[i].append(j)
            self._adj[j].append(i)
            self._abond[i].append(bi)
            self._abond[j].append(bi)
        self._perceive()

    # ------------------------------------------------------------ perception
    def _heavy_order(self, i):
        """bond-order sum of atom i over explicit bonds (aromatic = 1.5)."""
        return sum(BOND_ORDER[self.bond_types[b]] for b in self._abond[i])

    def _perceive(self):
        n = len(self.z)
        self._aromatic_atom = [False] * n
        for (i, j), t in zip(self.bonds, self.bond_types):
            if t == "AROMATIC":
                self._aromatic_atom[i] = True
                self._aromatic_atom[j] = True

        # implicit H: default valence minus explicit bond order (aromatic
        # ring sum 2×1.5=3 rounds up to the kekulized 3); charge shifts the
        # default valence for the common N+/O- cases
        self._implicit_h = []
        for i in range(n):
            if self._explicit_h[i] is not None:
                self._implicit_h.append(int(self._explicit_h[i]))
                continue
            dv = DEFAULT_VALENCE.get(self.z[i], 0) + (
                self.charge[i] if self.z[i] in (7, 8, 15, 16) else 0
            )
            used = self._heavy_order(i)
            used = int(np.ceil(used - 1e-9))
            self._implicit_h.append(max(0, dv - used))

        # ring membership: an edge is in a ring iff removing it keeps its
        # ends connected (cycle-edge test; O(B·(V+E)) on molecule sizes)
        self._in_ring = [False] * n
        ring_bond = [False] * len(self.bonds)
        for bi, (i, j) in enumerate(self.bonds):
            seen = {i}
            stack = [i]
            while stack:
                u = stack.pop()
                if u == j:
                    break
                for b2 in self._abond[u]:
                    if b2 == bi:
                        continue
                    v = (
                        self.bonds[b2][1]
                        if self.bonds[b2][0] == u
                        else self.bonds[b2][0]
                    )
                    if v not in seen:
                        seen.add(v)
                        stack.append(v)
            if j in seen:
                ring_bond[bi] = True
                self._in_ring[i] = True
                self._in_ring[j] = True
        self._ring_bond = ring_bond

        # hybridization (σ-frame rule; see module docstring for the known
        # divergence on conjugated lone-pair heteroatoms)
        self._hybrid = []
        for i in range(n):
            tys = [self.bond_types[b] for b in self._abond[i]]
            nd = sum(1 for t in tys if t == "DOUBLE")
            if "TRIPLE" in tys or nd >= 2:
                self._hybrid.append("SP")
            elif nd == 1 or "AROMATIC" in tys:
                self._hybrid.append("SP2")
            else:
                self._hybrid.append("SP3")

        self._set_conjugation()
        self._conj_groups()

    def _lone_electrons(self, i):
        """non-bonding electrons (RDKit countAtomElec equivalent)."""
        ve = VALENCE_ELECTRONS.get(self.z[i], 0) - self.charge[i]
        order = int(np.ceil(self._heavy_order(i) - 1e-9)) + self._implicit_h[i]
        # count H neighbors already in bonds
        return max(0, ve - order)

    def _is_conj_candidate(self, i):
        if self.z[i] <= 1:
            return False
        tys = [self.bond_types[b] for b in self._abond[i]]
        multiple = any(t in ("DOUBLE", "TRIPLE", "AROMATIC") for t in tys)
        return multiple or self._lone_electrons(i) > 0

    def _set_conjugation(self):
        """rdkit Conjugation.cpp ``markConjAtomBonds`` pair rule."""
        nb = len(self.bonds)
        self._conj_bond = [False] * nb
        cand = [self._is_conj_candidate(i) for i in range(len(self.z))]
        for at in range(len(self.z)):
            if not cand[at]:
                continue
            bs = self._abond[at]
            for x in range(len(bs)):
                for y in range(x + 1, len(bs)):
                    b1, b2 = bs[x], bs[y]
                    t1, t2 = self.bond_types[b1], self.bond_types[b2]
                    if not (
                        t1 in ("DOUBLE", "TRIPLE", "AROMATIC")
                        or t2 in ("DOUBLE", "TRIPLE", "AROMATIC")
                    ):
                        continue
                    o1 = (
                        self.bonds[b1][1]
                        if self.bonds[b1][0] == at
                        else self.bonds[b1][0]
                    )
                    o2 = (
                        self.bonds[b2][1]
                        if self.bonds[b2][0] == at
                        else self.bonds[b2][0]
                    )
                    if cand[o1] and cand[o2]:
                        self._conj_bond[b1] = True
                        self._conj_bond[b2] = True

    def _conj_groups(self):
        """connected components of the conjugated-bond subgraph; ids in
        first-bond discovery order (ResonanceMolSupplier semantics)."""
        n = len(self.z)
        self.conj_grp = [-1] * n
        gid = 0
        for bi in range(len(self.bonds)):
            if not self._conj_bond[bi]:
                continue
            i, j = self.bonds[bi]
            if self.conj_grp[i] != -1 or self.conj_grp[j] != -1:
                continue
            # flood from this bond over conjugated bonds
            stack = [i, j]
            while stack:
                u = stack.pop()
                if self.conj_grp[u] != -1:
                    continue
                self.conj_grp[u] = gid
                for b2 in self._abond[u]:
                    if self._conj_bond[b2]:
                        v = (
                            self.bonds[b2][1]
                            if self.bonds[b2][0] == u
                            else self.bonds[b2][0]
                        )
                        if self.conj_grp[v] == -1:
                            stack.append(v)
            gid += 1
        self.num_conj_grps = gid

    # ------------------------------------------------- featurize.py surface
    def GetAtoms(self):
        return [Atom(self, i) for i in range(len(self.z))]

    def GetBonds(self):
        return [Bond(self, i) for i in range(len(self.bonds))]

    def GetNumAtoms(self):
        return len(self.z)

    def GetConformer(self):
        if self.conformer is None:
            raise ValueError("molecule has no conformer")
        return self.conformer

    # ResonanceMolSupplier duck-type (featurize.conjugated_groups falls back
    # to this when rdkit's supplier is unavailable)
    def GetNumConjGrps(self):
        return self.num_conj_grps

    def GetAtomConjGrpIdx(self, i):
        return self.conj_grp[i]
