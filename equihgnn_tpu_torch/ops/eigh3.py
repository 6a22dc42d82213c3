"""Closed-form eigendecomposition of batched symmetric 3×3 matrices.

Port of `equihgnn_tpu/ops/eigh3.py` (`eigvalsh3x3` `:33`, `_eigvec` `:59`,
`eigh3x3` `:80`): the trigonometric method (Smith 1961) for the
eigenvalues and row-pair cross products for the eigenvectors, with every
fallback branch of the JAX function — the isotropic test (`iso`), the `ex`
fallback vector, the `alt` re-orthogonalisation — and its column order.

Not `torch.linalg.eigh`: FAFormer's frame mean over the 8 sign flips is
blind to the eigenvectors' signs, but not to the basis chosen inside a
degenerate eigenspace (one or two valid neighbours, collinear neighbours,
all-masked padding). There only the same fallback choices give the JAX
package's numbers.

Eigenvalues ascending, eigenvectors as COLUMNS (v_j = vecs[..., :, j]).
"""

from __future__ import annotations

import torch

_EPS = 1e-20
_TWO_PI_3 = 2.0943951023931953


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )


def _unit(v: torch.Tensor) -> torch.Tensor:
    return v / torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=_EPS))


def eigvalsh3x3(A: torch.Tensor) -> torch.Tensor:
    """Ascending eigenvalues of symmetric [..., 3, 3] (trigonometric method)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01**2 + a02**2 + a12**2
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detb = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detb / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lam_hi = q + 2.0 * p * torch.cos(phi)
    lam_lo = q + 2.0 * p * torch.cos(phi + _TWO_PI_3)
    lam_mid = 3.0 * q - lam_hi - lam_lo
    iso = p2 < 1e-12 * torch.clamp(q * q, min=1.0)  # (near-)isotropic: all = q
    lam = torch.stack([lam_lo, lam_mid, lam_hi], dim=-1)
    return torch.where(iso[..., None], q[..., None], lam)


def _eigvec(A: torch.Tensor, lam: torch.Tensor, fallback: torch.Tensor) -> torch.Tensor:
    """Null-space direction of (A − λI) via the largest row-pair cross."""
    M = A - lam[..., None, None] * torch.eye(3, dtype=A.dtype, device=A.device)
    c01 = _cross(M[..., 0, :], M[..., 1, :])
    c02 = _cross(M[..., 0, :], M[..., 2, :])
    c12 = _cross(M[..., 1, :], M[..., 2, :])
    n01 = torch.sum(c01 * c01, dim=-1)
    n02 = torch.sum(c02 * c02, dim=-1)
    n12 = torch.sum(c12 * c12, dim=-1)
    best = torch.where(
        ((n01 >= n02) & (n01 >= n12))[..., None],
        c01,
        torch.where((n02 >= n12)[..., None], c02, c12),
    )
    nbest = torch.maximum(n01, torch.maximum(n02, n12))
    # degenerate eigenvalue: the fallback, fixed by the caller
    return _unit(torch.where((nbest > _EPS)[..., None], best, fallback))


def eigh3x3(A: torch.Tensor):
    """(eigenvalues ascending [..., 3], eigenvectors as columns [..., 3, 3])."""
    lam = eigvalsh3x3(A)
    ex = A.new_tensor([1.0, 0.0, 0.0]).expand(A.shape[:-2] + (3,))
    # extreme eigenvalues are the best separated → most stable null spaces
    v0 = _eigvec(A, lam[..., 0], ex)
    v2 = _eigvec(A, lam[..., 2], ex)
    # re-orthogonalize v2 against v0 (safe under near-degeneracy), then the
    # middle vector completes the right-handed orthonormal basis
    v2 = v2 - torch.sum(v2 * v0, dim=-1, keepdim=True) * v0
    n2 = torch.sum(v2 * v2, dim=-1, keepdim=True)
    alt = _cross(v0, A.new_tensor([0.0, 1.0, 0.0]).expand(v0.shape))
    v2 = torch.where(n2 > 1e-12, v2 / torch.sqrt(torch.clamp(n2, min=_EPS)), alt)
    v2 = _unit(v2)
    v1 = _cross(v2, v0)
    return lam, torch.stack([v0, v1, v2], dim=-1)
