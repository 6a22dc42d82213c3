"""Weight bridge: JAX (flax) parameters → the port's state dict.

The port's module tree mirrors the flax tree of `equihgnn_tpu`, so a flax
path maps to a state-dict key by three rules:

  * `kernel` (flax [in, out]) → `weight` (torch.nn.Linear [out, in]),
    transposed; EGNN's split `kernel_i`/`kernel_j`/`kernel_d` →
    `weight_i`/`weight_j`/`weight_d`, transposed the same way;
  * a LayerNorm's or BatchNorm's `scale` → `weight`; other `scale`s
    (CoorsNorm) keep their name;
  * the levels that flax wrappers add are dropped: `LayerNorm_0` and
    `MaskedBatchNorm_0` (`_Norm`), `PReLU_0` (`Activation`).

Raw `self.param`s that no rule touches map untransposed under their own
names (the SE(3)-Transformer's; the Equiformer's `w{d}` [in, out],
`scale{d}` [dim, 1], `radial_{din}_{dout}_out_W` [f, o, i] and `_out_b`
[o, i]; and the 2-D baselines' `eps`, `root_emb`, `att_src`, `att_dst`,
`att_edge`, `att`, `bias`, `lin_edge_kernel`).

A flax `LSTMCell` (`.../lstm/{ii,if,ig,io}/kernel`, no bias, and
`.../lstm/{hi,hf,hg,ho}/{kernel,bias}`) maps to the port's `LSTMCell`
(`models/baseline_2d.py`) in `torch.nn.LSTMCell`'s layout: `weight_ih`
the four input kernels transposed and stacked in the order i, f, g, o,
`weight_hh` the same of the hidden kernels, `bias_hh` the hidden biases
stacked; flax has no input bias, and the port no `bias_ih`.

A BatchNorm's running statistics live in flax's `batch_stats` collection
as `.../mean` and `.../var`; passed as `batch_stats`, they map to the
buffers `running_mean` and `running_var`.

The JAX side flattens its collections with
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
_WRAPPERS = ("LayerNorm_0", "MaskedBatchNorm_0", "PReLU_0")
_STATS = {"mean": "running_mean", "var": "running_var"}
_GATES = "ifgo"  # torch.nn.LSTMCell's order of the stacked gates


def _lstm_tensors(flat: Mapping[str, np.ndarray]):
    """(the flat params without the LSTM cells' Denses, [(flax path,
    stacked array, port key)] of their stacked weights and biases)."""
    rest, cells = {}, {}
    for path, value in flat.items():
        parts = path.split("/")
        if len(parts) >= 3 and parts[-3] == "lstm":
            cells.setdefault("/".join(parts[:-2]), {})[(parts[-2], parts[-1])] = value
        else:
            rest[path] = value
    stacked = []
    for cell, leaves in cells.items():
        prefix = cell.replace("/", ".") + "."
        want = {(f"{side}{g}", "kernel") for side in "ih" for g in _GATES}
        want |= {(f"h{g}", "bias") for g in _GATES}
        if set(leaves) != want:
            odd = sorted("/".join(k) for k in set(leaves) ^ want)
            raise KeyError(f"LSTM cell {cell!r}: unused or missing Dense keys {odd}")
        for side, name in (("i", "weight_ih"), ("h", "weight_hh")):
            w = np.concatenate([np.asarray(leaves[(f"{side}{g}", "kernel")]).T for g in _GATES])
            stacked.append((f"{cell}/{side}*/kernel", w, prefix + name))
        b = np.concatenate([np.asarray(leaves[(f"h{g}", "bias")]) for g in _GATES])
        stacked.append((f"{cell}/h*/bias", b, prefix + "bias_hh"))
    return rest, stacked


def _port_key(path: str, expected: Mapping[str, torch.Tensor]) -> tuple[str, bool]:
    """(state-dict key, transpose?) for one flax path."""
    parts = [p for p in path.split("/") if p not in _WRAPPERS]
    leaf, prefix = parts[-1], "".join(p + "." for p in parts[:-1])
    if leaf in _KERNELS:
        return f"{prefix}{_KERNELS[leaf]}", True
    if leaf == "scale" and f"{prefix}scale" not in expected:
        return f"{prefix}weight", False
    return f"{prefix}{leaf}", False


def _stats_key(path: str) -> tuple[str, bool]:
    parts = [p for p in path.split("/") if p not in _WRAPPERS]
    leaf = _STATS.get(parts[-1], parts[-1])  # an unknown leaf stays unused
    return "".join(p + "." for p in parts[:-1]) + leaf, False


def params_from_jax(flat: Mapping[str, np.ndarray], model: nn.Module,
                    batch_stats: Mapping[str, np.ndarray] | None = None,
                    ) -> dict[str, torch.Tensor]:
    """Convert flattened flax params (and `batch_stats`, flattened the same
    way) for `model` into its state dict, buffers included.

    Raises KeyError on a flax key with no place in `model` and on a
    parameter or buffer of `model` that neither collection provides, and
    ValueError on a shape mismatch. Load the result with
    `model.load_state_dict(...)`.
    """
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    flat, lstm = _lstm_tensors(flat)
    items = [(path, value, _port_key(path, expected)) for path, value in flat.items()]
    items += [(path, value, (key, False)) for path, value, key in lstm]
    items += [(path, value, _stats_key(path)) for path, value in (batch_stats or {}).items()]
    for path, value, (key, transpose) in items:
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
