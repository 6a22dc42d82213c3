"""Real spherical harmonics of any degree (port of `equihgnn_tpu/ops/sh.py`).

Y_l is built by the CG recursion Y_l ∝ Q^{(l−1,1,l)} (Y_{l−1} ⊗ Y_1) with
the host constants of `ops/so3.py`, l = 1 in the (y, z, x) basis, so that
it is equivariant under that module's real irreps. Component
normalization: ‖Y_l(r̂)‖ = √(2l+1). This is the SE(3)-Transformer's
convention, not ViSNet's `spherical_harmonics_l2`.
"""

from __future__ import annotations

from functools import lru_cache
from math import sqrt

import numpy as np
import torch

from equihgnn_tpu_torch.ops.so3 import real_clebsch_gordan, sh_norm_constants


@lru_cache(maxsize=None)
def cg_const(l1: int, l2: int, l3: int) -> np.ndarray:
    """`real_clebsch_gordan` in float32 (cached: callers copy it)."""
    return real_clebsch_gordan(l1, l2, l3).astype(np.float32)


def spherical_harmonics(lmax: int, vec: torch.Tensor, normalize: bool = True) -> list:
    """vec [..., 3] → [Y_0, ..., Y_lmax], each [..., 2l+1].

    With `normalize` the vectors are made unit first; a zero vector maps to
    zero harmonics for l ≥ 1 (the self-edge convention), with a defined
    gradient.
    """
    v = vec
    if normalize:
        n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True) + 1e-24)
        v = torch.where(n > 1e-10, v / n, torch.zeros((), dtype=v.dtype, device=v.device))
    ys = [torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)]
    if lmax == 0:
        return ys
    y1 = v[..., [1, 2, 0]] * sqrt(3.0)
    ys.append(y1)
    consts = sh_norm_constants(lmax)
    for l in range(2, lmax + 1):
        q = torch.tensor(cg_const(l - 1, 1, l), dtype=v.dtype, device=v.device)
        ys.append(torch.einsum("abc,...a,...b->...c", q, ys[l - 1], y1) * consts[l])
    return ys
