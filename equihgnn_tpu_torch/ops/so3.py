"""SO(3) representation constants: real irreps and Clebsch-Gordan tensors.

A numpy/scipy copy of the part of `equihgnn_tpu/ops/so3.py` that the port
needs (`so3_generators` `:54`, `_product_generators` `:66`,
`_casimir_basis` `:76`, `real_clebsch_gordan` `:89`, `sh_norm_constants`
`:178`), computed once on the host in float64. The port keeps its own copy
because it imports nothing of the JAX package.

The l = 1 real irrep is fixed to the (y, z, x) vector basis; the l-block of
(l−1) ⊗ 1 (a Casimir eigenspace) defines both CG(l−1, 1, l) and the
generators of l; a general CG(l1, l2, l3) is the unit-norm nullspace of the
intertwining constraint, with the first significant element positive.
"""

from __future__ import annotations

from functools import lru_cache
from math import sqrt

import numpy as np

# permutation xyz → (y, z, x) for the l = 1 real basis
_P_YZX = np.array([[0.0, 1.0, 0.0], [0.0, 0.0, 1.0], [1.0, 0.0, 0.0]])

# so(3) generators in the xyz vector basis: (G_a)_{bc} = −ε_{abc}
_G = np.zeros((3, 3, 3))
for _a, _b, _c, _s in [(0, 1, 2, -1.0), (0, 2, 1, 1.0), (1, 0, 2, 1.0), (1, 2, 0, -1.0),
                       (2, 0, 1, -1.0), (2, 1, 0, 1.0)]:
    _G[_a, _b, _c] = _s


@lru_cache(maxsize=None)
def so3_generators(l: int) -> np.ndarray:
    """[3, 2l+1, 2l+1] antisymmetric generators of the real l-irrep."""
    if l == 0:
        return np.zeros((3, 1, 1))
    if l == 1:
        return np.einsum("ij,ajk,lk->ail", _P_YZX, _G, _P_YZX)
    B = _casimir_basis(l)
    K = _product_generators(l - 1, 1)
    return np.einsum("pi,apq,qj->aij", B, K, B)


def _product_generators(l1: int, l2: int) -> np.ndarray:
    """Generators of the product rep l1 ⊗ l2, [3, d1·d2, d1·d2]."""
    k1, k2 = so3_generators(l1), so3_generators(l2)
    d1, d2 = k1.shape[-1], k2.shape[-1]
    out = (np.einsum("apq,rs->aprqs", k1, np.eye(d2))
           + np.einsum("pq,ars->aprqs", np.eye(d1), k2))
    return out.reshape(3, d1 * d2, d1 * d2)


@lru_cache(maxsize=None)
def _casimir_basis(l: int) -> np.ndarray:
    """Orthonormal basis of the l-block inside (l−1) ⊗ 1."""
    K = _product_generators(l - 1, 1)
    casimir = -sum(K[a] @ K[a] for a in range(3))
    w, v = np.linalg.eigh(casimir)
    B = v[:, np.abs(w - l * (l + 1)) < 1e-6]
    if B.shape[1] != 2 * l + 1:
        raise ArithmeticError(f"l={l}: found {B.shape[1]} of {2 * l + 1} basis vectors")
    return B


@lru_cache(maxsize=None)
def real_clebsch_gordan(l1: int, l2: int, l3: int) -> np.ndarray:
    """Real CG tensor Q [2l1+1, 2l2+1, 2l3+1], unit Frobenius norm; zeros
    where (l1, l2, l3) violates the triangle rule."""
    d1, d2, d3 = 2 * l1 + 1, 2 * l2 + 1, 2 * l3 + 1
    if not abs(l1 - l2) <= l3 <= l1 + l2:
        return np.zeros((d1, d2, d3))
    if l2 == 1 and l3 == l1 + 1:  # the recursion anchor
        return _casimir_basis(l3).reshape(d1, d2, d3)
    kp = _product_generators(l1, l2)
    k3 = so3_generators(l3)
    mats = []
    for a in range(3):
        t1 = np.einsum("qp,ce->pcqe", kp[a], np.eye(d3))
        t2 = np.einsum("pq,ce->pcqe", np.eye(d1 * d2), k3[a])
        mats.append((t1 - t2).reshape(d1 * d2 * d3, d1 * d2 * d3))
    _, s, vh = np.linalg.svd(np.concatenate(mats, axis=0))
    n_null = int(np.sum(s < 1e-8))
    null = vh[s.size - n_null:] if n_null else vh[-1:]
    if null.shape[0] != 1:
        raise ArithmeticError(f"CG({l1},{l2},{l3}): nullspace dim {null.shape[0]} != 1")
    Q = null[0].reshape(d1, d2, d3)
    Q = Q / np.linalg.norm(Q)
    flat = Q.reshape(-1)
    if flat[np.argmax(np.abs(flat) > 1e-6)] < 0:
        Q = -Q
    return Q


@lru_cache(maxsize=None)
def sh_norm_constants(lmax: int) -> tuple:
    """Rescales the CG recursion so that ‖Y_l(r̂)‖ = √(2l+1)."""
    consts = [1.0, 1.0]
    y_prev = np.array([0.0, sqrt(3), 0.0])  # Y_1(ẑ) in the (y, z, x) basis
    y1 = y_prev.copy()
    for l in range(2, lmax + 1):
        y = np.einsum("abc,a,b->c", real_clebsch_gordan(l - 1, 1, l), y_prev, y1)
        c = sqrt(2 * l + 1) / np.linalg.norm(y)
        consts.append(float(c))
        y_prev = y * c
    return tuple(consts)
