"""Bipartite hypergraph convolution `MHNNSConv`, flat path.

Port of `equihgnn_tpu/nn/hgconv.py` `MHNNSConv` (`:173-261`, the flat
branch `:242-261`), itself the reference's `conv.py:104-182`. The V→E
reduction runs over hyperedge ids sorted by the batch builder and goes to
the sorted-segment-sum kernel; the E→V reduction over unsorted vertex ids
stays on `index_add_`. Padded incidence entries are zeroed by `inc_mask`
before every reduction. The JAX package's dense slot-incidence one-hot
path is a TPU workaround for slow scatters and has no counterpart.

`mlp*_layers <= 0` replicates the reference's identity slice: W2 becomes
`X[..., hid_dim:]` (the second half of the concat), W1 and W3 become the
identity.
"""

from __future__ import annotations

import torch
from torch import nn

from equihgnn_tpu_torch.nn.mlp import MLP
from equihgnn_tpu_torch.ops.segment import masked_segment_reduce


def _maybe_mlp(in_dim, hid_dim, layers, dropout, normalization, generator):
    if layers <= 0:
        return None
    return MLP(in_dim, hid_dim, hid_dim, layers, dropout=dropout,
               normalization=normalization, generator=generator)


class MHNNSConv(nn.Module):
    """Simple/fast variant with residual mixing (`reference conv.py:104-182`)."""

    ALPHA = 0.5  # weight of x0 in the residual mix (the reference's alpha)

    def __init__(self, hid_dim: int, mlp1_layers: int = 1, mlp2_layers: int = 1,
                 mlp3_layers: int = 1, aggr: str = "mean", dropout: float = 0.0,
                 normalization: str = "None", *, generator: torch.Generator):
        super().__init__()
        d = self.hid_dim = hid_dim
        self.aggr = aggr
        self.W1 = _maybe_mlp(d, d, mlp1_layers, dropout, normalization, generator)
        self.W2 = _maybe_mlp(2 * d, d, mlp2_layers, dropout, normalization, generator)
        self.W3 = _maybe_mlp(d, d, mlp3_layers, dropout, normalization, generator)

    def forward(
        self,
        x: torch.Tensor,  # [N_pad, d]
        vertex_idx: torch.Tensor,  # [nnz_pad]
        hedge_idx: torch.Tensor,  # [nnz_pad], non-decreasing
        inc_mask: torch.Tensor,  # [nnz_pad] bool
        x0: torch.Tensor,  # [N_pad, d] initial features for the residual mix
        num_hedges: int,  # E_pad
    ) -> torch.Tensor:
        d = self.hid_dim
        xw = x if self.W1 is None else self.W1(x)
        xe = masked_segment_reduce(
            xw[vertex_idx], hedge_idx, num_hedges, self.aggr, mask=inc_mask,
            sorted_ids=True,
        )
        xev = torch.cat([x[vertex_idx], xe[hedge_idx]], dim=-1)
        xev = xev[..., d:] if self.W2 is None else self.W2(xev)
        xv = masked_segment_reduce(xev, vertex_idx, x.shape[-2], self.aggr, mask=inc_mask)
        x = (1.0 - self.ALPHA) * xv + self.ALPHA * x0
        return x if self.W3 is None else self.W3(x)
