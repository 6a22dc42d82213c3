"""Neighbour gather on the dense slot view (port of `nbr_gather`,
`equihgnn_tpu/ops/gather.py:27-51`).

`out[g, a, kk] = x[g, nbr_idx[g, a, kk]]`, zeroed where `nbr_mask` is
False. The forward is one `index_select` over the flattened [G·A, F] rows,
so that its backward is `index_add_`; the advanced-indexing form `x[g, idx]`
differentiates through PyTorch's sort-based `indexing_backward_kernel`,
half of the egnn train step on the card (PERF.md §5). JAX's one-hot-matmul
VJP was a TPU workaround (XLA TPU scatters were near-serial) and is not
ported.
"""

from __future__ import annotations

import torch


def nbr_gather(x: torch.Tensor, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """x [G, A, *F], nbr_idx [G, A, k] int64 slot indices, nbr_mask
    [G, A, k] bool → [G, A, k, *F]."""
    g, a, k = nbr_idx.shape
    feat = x.shape[2:]
    rows = torch.arange(g, device=x.device)[:, None, None] * a
    flat_idx = (rows + nbr_idx).reshape(-1)
    out = x.reshape(g * a, -1).index_select(0, flat_idx).view((g, a, k) + feat)
    m = nbr_mask.reshape(nbr_mask.shape + (1,) * len(feat))
    return torch.where(m, out, torch.zeros((), dtype=out.dtype, device=out.device))
