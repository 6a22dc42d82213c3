"""Neighbour gather on the dense slot view (port of `nbr_gather`,
`equihgnn_tpu/ops/gather.py:27-51`).

`out[g, a, kk] = x[g, nbr_idx[g, a, kk]]`, zeroed where `nbr_mask` is
False. The forward is one `index_select` over the flattened [G·A, F] rows,
so that its backward is `index_add_`; the advanced-indexing form `x[g, idx]`
differentiates through PyTorch's sort-based `indexing_backward_kernel`,
half of the egnn train step on the card (PERF.md §5). JAX's one-hot-matmul
VJP was a TPU workaround (XLA TPU scatters were near-serial) and is not
ported. Below float32 the gather's backward sums in float32 and rounds
once (`index_select`), as the one-hot matmul's transpose does in JAX.
"""

from __future__ import annotations

import torch


class _IndexSelectF32Sum(torch.autograd.Function):
    """`x.index_select(dim, idx)` whose backward adds the gradients of the
    rows that share a source in float32 and rounds the sum once to x's type
    (PyTorch's own backward, `index_add_` in x's type, rounds every add)."""

    @staticmethod
    def forward(ctx, x, dim, idx):
        ctx.save_for_backward(idx)
        ctx.dim, ctx.shape = dim, x.shape
        return x.index_select(dim, idx)

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        acc = torch.zeros(ctx.shape, dtype=torch.float32, device=grad.device)
        return acc.index_add_(ctx.dim, idx, grad.float()).to(grad.dtype), None, None


def index_select(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    """`x.index_select(dim, idx)`; below float32 its backward sums in float32."""
    if x.dtype == torch.float32 or not torch.is_grad_enabled():
        return x.index_select(dim, idx)
    return _IndexSelectF32Sum.apply(x, dim, idx)


def nbr_gather(x: torch.Tensor, nbr_idx: torch.Tensor, nbr_mask: torch.Tensor) -> torch.Tensor:
    """x [G, A, *F], nbr_idx [G, A, k] int64 slot indices, nbr_mask
    [G, A, k] bool → [G, A, k, *F]."""
    g, a, k = nbr_idx.shape
    feat = x.shape[2:]
    rows = torch.arange(g, device=x.device)[:, None, None] * a
    flat_idx = (rows + nbr_idx).reshape(-1)
    out = index_select(x.reshape(g * a, -1), 0, flat_idx).view((g, a, k) + feat)
    m = nbr_mask.reshape(nbr_mask.shape + (1,) * len(feat))
    return torch.where(m, out, torch.zeros((), dtype=out.dtype, device=out.device))
