"""First-party SMILES parser producing `equihgnn_tpu_torch.data.chem.Mol`.

Copy of `equihgnn_tpu/data/smiles.py`, with import paths changed (pure
Python on `data/chem.py`); its notes follow.

Completes the RDKit-free real-molecule path: SDF records already parse via
`data/sdf.py`; this covers the SMILES-featurized datasets (OPV 2-D,
`reference equihgnn/data/opv3d.py:146-455` via `smi2hgraph`,
`utils.py:64-105`) and SMILES input to `equihgnn_tpu_torch.predict`.

Supported: the organic subset (B C N O P S F Cl Br I and aromatic
b c n o p s), bracket atoms `[isotope? symbol @? H<n>? +/-<n>? :class?]`
(incl. two-letter aromatics `se`/`as` and `*`), branches, ring closures
(`1`..`9`, `%nn`, with optional bond symbol on either side), explicit bonds
`- = # :` (plus `/ \\` read as single — stereo is dropped), and `.`
disconnection.

Aromatic-bond resolution: an UNSPECIFIED bond between two aromatic atoms is
AROMATIC iff it lies in a ring, else SINGLE — so biphenyl's inter-ring bond
stays single while fused-ring bonds stay aromatic (matching RDKit's
perception on kekulizable inputs). Known divergences from MolFromSmiles,
accepted and asserted nowhere: no Hückel validation (inputs are trusted,
like the datasets' sanitize=False SDF reads), no chirality/stereo
perception (OGB chirality feature reads CHI_UNSPECIFIED), and a bond inside
a non-aromatic ring joining two aromatic atoms (biphenylene's bridges) is
marked aromatic.

Bracket atoms carry a FIXED hydrogen count (`[nH]` = exactly one, `[Se]` =
zero) per the SMILES spec; organic-subset atoms get implicit H from the
default-valence bookkeeping in `chem.Mol`.
"""

from __future__ import annotations

from equihgnn_tpu_torch.data.chem import ATOMIC_NUM, Mol

_ORGANIC = {"B": 5, "C": 6, "N": 7, "O": 8, "P": 15, "S": 16,
            "F": 9, "Cl": 17, "Br": 35, "I": 53}
_AROM_ORGANIC = {"b": 5, "c": 6, "n": 7, "o": 8, "p": 15, "s": 16}
_BOND_SYMS = {"-": "SINGLE", "=": "DOUBLE", "#": "TRIPLE", ":": "AROMATIC",
              "/": "SINGLE", "\\": "SINGLE"}


class SmilesError(ValueError):
    pass


def parse_smiles(smiles: str):
    """SMILES → `Mol`, or None if unparsable (MolFromSmiles-like)."""
    try:
        return _parse(smiles)
    except (SmilesError, KeyError, IndexError, ValueError):
        return None


def _parse(s: str) -> Mol:
    z: list[int] = []
    charge: list[int] = []
    hcount: list[int | None] = []  # None = derive from valence
    aromatic: list[bool] = []
    bonds: list[tuple[int, int]] = []
    bond_sym: list[str | None] = []

    prev: int | None = None
    stack: list[int | None] = []
    pending: str | None = None
    ring: dict[int, tuple[int, str | None]] = {}

    def add_atom(zi: int, arom: bool, ch: int = 0, hc: int | None = None):
        nonlocal prev, pending
        idx = len(z)
        z.append(zi)
        charge.append(ch)
        hcount.append(hc)
        aromatic.append(arom)
        if prev is not None:
            bonds.append((prev, idx))
            bond_sym.append(pending)
        prev = idx
        pending = None

    def close_ring(num: int):
        nonlocal pending
        if prev is None:
            raise SmilesError("ring closure before any atom")
        if num in ring:
            other, sym0 = ring.pop(num)
            sym = sym0 or pending
            if sym0 and pending and sym0 != pending:
                raise SmilesError("conflicting ring-closure bond symbols")
            if other == prev:
                raise SmilesError("self ring closure")
            bonds.append((other, prev))
            bond_sym.append(sym)
        else:
            ring[num] = (prev, pending)
        pending = None

    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c == "(":
            if prev is None:
                raise SmilesError("branch before any atom")
            stack.append(prev)
            i += 1
        elif c == ")":
            if not stack:
                raise SmilesError("unmatched ')'")
            prev = stack.pop()
            i += 1
        elif c == ".":
            prev = None
            pending = None
            i += 1
        elif c in _BOND_SYMS:
            pending = c
            i += 1
        elif c == "%":
            close_ring(int(s[i + 1 : i + 3]))
            i += 3
        elif c.isdigit():
            close_ring(int(c))
            i += 1
        elif c == "[":
            j = s.index("]", i)
            _bracket(s[i + 1 : j], add_atom)
            i = j + 1
        elif c == "*":
            add_atom(0, False)
            i += 1
        else:
            two = s[i : i + 2]
            if two in ("Cl", "Br"):
                add_atom(_ORGANIC[two], False)
                i += 2
            elif c in _ORGANIC:
                add_atom(_ORGANIC[c], False)
                i += 1
            elif c in _AROM_ORGANIC:
                add_atom(_AROM_ORGANIC[c], True)
                i += 1
            else:
                raise SmilesError(f"unexpected character {c!r}")
    if ring or stack:
        raise SmilesError("unclosed ring bond or branch")
    if not z:
        raise SmilesError("empty molecule")

    types = _resolve_bond_types(len(z), bonds, bond_sym, aromatic)
    mol = Mol(z, bonds, types, charge=charge, explicit_h=hcount)
    # lowercase atoms are aromatic even when their ring bonds were written
    # explicitly; overlay onto the bond-derived flags
    for i_, a in enumerate(aromatic):
        if a:
            mol._aromatic_atom[i_] = True
    return mol


def _bracket(body: str, add_atom):
    """[isotope? symbol chiral? H<n>? charge? :class?]"""
    i, n = 0, len(body)
    while i < n and body[i].isdigit():  # isotope (dropped)
        i += 1
    if i >= n:
        raise SmilesError("empty bracket atom")
    arom = body[i].islower()
    sym = body[i]
    if i + 1 < n and body[i + 1].islower() and (
        sym.upper() + body[i + 1]
    ) in ATOMIC_NUM and not (sym == "n" and body[i + 1] == "h"):
        # two-letter element, possibly aromatic ('se', 'as'); 'nh' is not one
        sym = sym + body[i + 1]
        i += 2
    elif sym == "*":
        i += 1
    else:
        i += 1
    zi = 0 if sym == "*" else ATOMIC_NUM[sym.capitalize() if len(sym) == 1
                                         else sym.capitalize()]
    hc = 0
    ch = 0
    while i < n:
        c = body[i]
        if c == "@":
            i += 1  # chirality dropped (CHI_UNSPECIFIED downstream)
        elif c == "H":
            i += 1
            num = ""
            while i < n and body[i].isdigit():
                num += body[i]
                i += 1
            hc = int(num) if num else 1
        elif c in "+-":
            sign = 1 if c == "+" else -1
            i += 1
            num = ""
            while i < n and body[i].isdigit():
                num += body[i]
                i += 1
            if num:
                ch = sign * int(num)
            else:
                ch = sign
                while i < n and body[i] == c:  # ++ / -- forms
                    ch += sign
                    i += 1
        elif c == ":":
            i += 1
            while i < n and body[i].isdigit():  # atom class dropped
                i += 1
        else:
            raise SmilesError(f"unexpected bracket token {c!r}")
    add_atom(zi, arom, ch, hc)


def _resolve_bond_types(n_atoms, bonds, bond_sym, aromatic):
    """Explicit symbols map directly; unspecified bonds between two aromatic
    atoms are AROMATIC iff the bond is in a ring (cycle-edge test)."""
    adj_b: list[list[int]] = [[] for _ in range(n_atoms)]
    for bi, (i, j) in enumerate(bonds):
        adj_b[i].append(bi)
        adj_b[j].append(bi)

    def in_ring(bi):
        i, j = bonds[bi]
        seen = {i}
        stack = [i]
        while stack:
            u = stack.pop()
            if u == j:
                return True
            for b2 in adj_b[u]:
                if b2 == bi:
                    continue
                a, b = bonds[b2]
                v = b if a == u else a
                if v not in seen:
                    seen.add(v)
                    stack.append(v)
        return j in seen

    types = []
    for bi, sym in enumerate(bond_sym):
        if sym is not None:
            types.append(_BOND_SYMS[sym])
        else:
            i, j = bonds[bi]
            if aromatic[i] and aromatic[j] and in_ring(bi):
                types.append("AROMATIC")
            else:
                types.append("SINGLE")
    return types


def MolFromSmiles(smiles: str, **_kw):  # rdkit.Chem duck-type
    return parse_smiles(smiles)
