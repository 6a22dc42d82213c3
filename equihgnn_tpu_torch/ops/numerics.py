"""Numerically safe primitives (port of `equihgnn_tpu/ops/numerics.py`).

`safe_norm` is the smooth ‖x‖ ≈ √(Σx² + ε²), whose gradient is defined at
the exact zeros that padded slots hold.
"""

from __future__ import annotations

import torch


def safe_norm(x: torch.Tensor, dim: int = -1, keepdim: bool = False,
              eps: float = 1e-12) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=dim, keepdim=keepdim) + eps * eps)
