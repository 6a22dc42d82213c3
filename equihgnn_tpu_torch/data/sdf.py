"""Copy of `equihgnn_tpu/data/sdf.py` with its import path changed.

Minimal MDL SDF (V2000) reader producing `data.chem.Mol` objects, so a
dataset ``process()`` body can run on REAL raw files in an RDKit-free image.

Replaces the slice of ``Chem.SDMolSupplier`` the reference data layer uses
(`reference equihgnn/data/qm9.py:146-230` iterates supplier output and
featurizes each mol). Supported: counts line, atom block (coords + symbol),
bond block (types 1/2/3/4 → SINGLE/DOUBLE/TRIPLE/AROMATIC), ``M  CHG``
property lines, ``$$$$`` record separator. Malformed records yield ``None``
(the supplier's behavior the skip-semantics replicate — SURVEY §5.3).

Aromatic rings should use bond type 4; heteroatoms whose valence the
aromatic 1.5-order bookkeeping cannot infer (pyrrole-type N–H) need their H
explicit (see chem.py docstring).
"""

from __future__ import annotations

from equihgnn_tpu_torch.data.chem import ATOMIC_NUM, Mol

_BOND_TYPE = {1: "SINGLE", 2: "DOUBLE", 3: "TRIPLE", 4: "AROMATIC"}


def parse_sdf_record(lines: list[str]):
    """One molfile record (without ``$$$$``) → `Mol` or ``None``."""
    try:
        counts = lines[3]
        na, nb = int(counts[0:3]), int(counts[3:6])
        z, pos, charge = [], [], []
        for ln in lines[4 : 4 + na]:
            x, y, zc = float(ln[0:10]), float(ln[10:20]), float(ln[20:30])
            sym = ln[31:34].strip()
            z.append(ATOMIC_NUM[sym])
            pos.append((x, y, zc))
            charge.append(0)
        bonds, btypes = [], []
        for ln in lines[4 + na : 4 + na + nb]:
            i, j, t = int(ln[0:3]) - 1, int(ln[3:6]) - 1, int(ln[6:9])
            if not (0 <= i < na and 0 <= j < na) or i == j:
                raise ValueError("bad bond indices")
            bonds.append((i, j))
            btypes.append(_BOND_TYPE[t])
        for ln in lines[4 + na + nb :]:
            if ln.startswith("M  CHG"):
                fields = ln.split()
                n = int(fields[2])
                for k in range(n):
                    charge[int(fields[3 + 2 * k]) - 1] = int(fields[4 + 2 * k])
            elif ln.startswith("M  END"):
                break
        return Mol(z, bonds, btypes, charge=charge, pos=pos)
    except (ValueError, KeyError, IndexError):
        return None


def read_sdf(path: str):
    """Iterate `Mol | None` records of an .sdf file (``SDMolSupplier``-like:
    one entry per record, ``None`` for records that fail to parse)."""
    with open(path) as fh:
        text = fh.read()
    out = []
    for rec in text.split("$$$$"):
        lines = rec.lstrip("\n").split("\n")
        if len(lines) < 4 or not lines[3][:6].strip():
            continue
        out.append(parse_sdf_record(lines))
    return out


def read_titles(path: str):
    """First (title) line of each record, aligned with `read_sdf` output."""
    with open(path) as fh:
        text = fh.read()
    titles = []
    for rec in text.split("$$$$"):
        lines = rec.lstrip("\n").split("\n")
        if len(lines) < 4 or not lines[3][:6].strip():
            continue
        titles.append(lines[0].strip())
    return titles
