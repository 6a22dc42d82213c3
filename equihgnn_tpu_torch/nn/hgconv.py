"""Bipartite hypergraph convolutions `MHNNConv` and `MHNNSConv`, flat path.

Port of `equihgnn_tpu/nn/hgconv.py` `MHNNConv` (`:75-170`, the flat branch
`:153-169`) and `MHNNSConv` (`:173-261`, the flat branch `:242-261`),
themselves the reference's `conv.py:8-182`. The V→E reduction runs over
hyperedge ids sorted by `pad_hypergraph_batch` and goes to the
sorted-segment-sum kernel (kernel A); the E→V reduction over unsorted
vertex ids stays on `index_add_`. Padded incidence entries are zeroed by
`inc_mask` before every reduction. The JAX package's dense slot-incidence
one-hot path is a TPU workaround for slow scatters and has no counterpart.

Each MLP gets the mask of the rows it runs over (incidence entries,
hyperedges or atoms), which only a "bn" norm reads. A padded hyperedge has
no kept incidence entry, so its V→E message is 0 here, as JAX's dense path
makes it by zeroing with `hedge_mask`; its row of `e` is masked out of
every later reduction and statistic.

`mlp*_layers <= 0` replicates the reference's identity slice: an MLP over
a concatenation [a, b] becomes `b` (`inp[..., d:]`); in `MHNNSConv`, W1 and
W3 become the identity.
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


class MHNNConv(nn.Module):
    """Full V→E→V bipartite pass with 4 MLPs (`reference conv.py:8-101`)."""

    def __init__(self, hid_dim: int, mlp1_layers: int = 1, mlp2_layers: int = 1,
                 mlp3_layers: int = 1, mlp4_layers: int = 1, aggr: str = "mean",
                 dropout: float = 0.0, normalization: str = "None", *,
                 generator: torch.Generator):
        super().__init__()
        d = self.hid_dim = hid_dim
        self.aggr = aggr
        for name, layers in (("W1", mlp1_layers), ("W2", mlp2_layers),
                             ("W3", mlp3_layers), ("W4", mlp4_layers)):
            setattr(self, name, _maybe_mlp(2 * d, d, layers, dropout, normalization, generator))

    def _mlp(self, w, inp, mask):
        return inp[..., self.hid_dim:] if w is None else w(inp, mask)

    def forward(
        self,
        x: torch.Tensor,  # [N_pad, d] atom features
        e: torch.Tensor,  # [E_pad, d] hyperedge features
        vertex_idx: torch.Tensor,  # [nnz_pad]
        hedge_idx: torch.Tensor,  # [nnz_pad], non-decreasing
        inc_mask: torch.Tensor,  # [nnz_pad] bool
        atom_mask: torch.Tensor | None = None,  # [N_pad] bool
        hedge_mask: torch.Tensor | None = None,  # [E_pad] bool
    ) -> tuple[torch.Tensor, torch.Tensor]:
        def entries(x, e):  # [x[v], e[h]] per incidence entry
            return torch.cat([x.index_select(0, vertex_idx), e.index_select(0, hedge_idx)], -1)

        mve = self._mlp(self.W1, entries(x, e), inc_mask)
        me = masked_segment_reduce(mve, hedge_idx, e.shape[-2], self.aggr, mask=inc_mask,
                                   sorted_ids=True)
        e = self._mlp(self.W2, torch.cat([e, me], -1), hedge_mask)
        mev = self._mlp(self.W3, entries(x, e), inc_mask)
        mv = masked_segment_reduce(mev, vertex_idx, x.shape[-2], self.aggr, mask=inc_mask)
        return self._mlp(self.W4, torch.cat([x, mv], -1), atom_mask), e


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
        atom_mask: torch.Tensor | None = None,  # [N_pad] bool
    ) -> torch.Tensor:
        d = self.hid_dim
        xw = x if self.W1 is None else self.W1(x, atom_mask)
        xe = masked_segment_reduce(
            xw[vertex_idx], hedge_idx, num_hedges, self.aggr, mask=inc_mask,
            sorted_ids=True,
        )
        xev = torch.cat([x[vertex_idx], xe[hedge_idx]], dim=-1)
        xev = xev[..., d:] if self.W2 is None else self.W2(xev, inc_mask)
        xv = masked_segment_reduce(xev, vertex_idx, x.shape[-2], self.aggr, mask=inc_mask)
        x = (1.0 - self.ALPHA) * xv + self.ALPHA * x0
        return x if self.W3 is None else self.W3(x, atom_mask)
