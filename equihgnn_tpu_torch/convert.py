"""Weight bridge: JAX (flax) parameters → the port's state dict.

The port's module tree mirrors the flax tree of `equihgnn_tpu`, so a flax
path maps to a state-dict key by three rules:

  * `kernel` (flax [in, out]) → `weight` (torch.nn.Linear [out, in]),
    transposed; EGNN's split `kernel_i`/`kernel_j`/`kernel_d` →
    `weight_i`/`weight_j`/`weight_d`, transposed the same way;
  * a LayerNorm's `scale` → `weight`; other `scale`s (CoorsNorm) keep
    their name;
  * the `LayerNorm_0` level that flax's `_Norm` wrapper adds is dropped.

The JAX side flattens its `params` with
`flax.traverse_util.flatten_dict(params, sep="/")`; this module imports
nothing of JAX.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch
from torch import nn

_KERNELS = {"kernel": "weight", "kernel_i": "weight_i", "kernel_j": "weight_j",
            "kernel_d": "weight_d"}


def _port_key(path: str, expected: Mapping[str, torch.Tensor]) -> tuple[str, bool]:
    """(state-dict key, transpose?) for one flax path."""
    parts = [p for p in path.split("/") if p != "LayerNorm_0"]
    leaf, prefix = parts[-1], ".".join(parts[:-1])
    if leaf in _KERNELS:
        return f"{prefix}.{_KERNELS[leaf]}", True
    if leaf == "scale" and f"{prefix}.scale" not in expected:
        return f"{prefix}.weight", False
    return f"{prefix}.{leaf}", False


def params_from_jax(flat: Mapping[str, np.ndarray], model: nn.Module) -> dict[str, torch.Tensor]:
    """Convert flattened flax params for `model` into its state dict.

    Raises KeyError on a flax key with no place in `model` and on a
    parameter of `model` that `flat` does not provide, and ValueError on a
    shape mismatch. Load the result with `model.load_state_dict(...)`.
    """
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for path, value in flat.items():
        key, transpose = _port_key(path, expected)
        if key not in expected:
            raise KeyError(f"unused JAX parameter {path!r} (no port key {key!r})")
        arr = np.asarray(value, dtype=np.float32)
        t = torch.tensor(arr.T if transpose else arr)  # a contiguous copy
        if tuple(t.shape) != tuple(expected[key].shape):
            raise ValueError(
                f"{path!r} → {key!r}: shape {tuple(t.shape)} != {tuple(expected[key].shape)}"
            )
        out[key] = t
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"JAX parameters missing for port keys {missing}")
    return out
