"""OGB-compatible atom and bond embeddings (port of `AtomEncoder` and
`BondEncoder`, `equihgnn_tpu/nn/encoders.py:50-77`): one table per
categorical feature, summed, stored as one flat table with per-feature
offsets. Tables are initialized xavier-uniform, as OGB does. `HedgeEncoder`
(`equihgnn_tpu/nn/encoders.py:80-94`) embeds a hyperedge's type for the
MHNN trunks."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from equihgnn_tpu_torch.data.structures import (
    ATOM_FEATURE_DIMS,
    BOND_FEATURE_DIMS,
    NUM_BOND_FEATURES,
    NUM_HEDGE_TYPES,
)
from equihgnn_tpu_torch.nn.mlp import normal_, uniform_


class _MultiEmbeddingSum(nn.Module):
    """sum_i Embed_i(x[..., i]) with per-feature vocab sizes."""

    def __init__(self, vocab_sizes, emb_dim: int, *, generator: torch.Generator):
        super().__init__()
        offsets = np.concatenate([[0], np.cumsum(vocab_sizes)[:-1]])
        self.register_buffer(
            "offsets", torch.as_tensor(offsets, dtype=torch.int64), persistent=False
        )
        total = int(np.sum(vocab_sizes))
        bound = math.sqrt(6.0 / (total + emb_dim))
        self.embedding = nn.Parameter(
            uniform_(torch.empty(total, emb_dim), bound, generator)
        )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.embedding[x + self.offsets].sum(dim=-2)


class AtomEncoder(nn.Module):
    """9 categorical atom features → summed embedding [..., emb_dim]."""

    def __init__(self, emb_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.atom = _MultiEmbeddingSum(ATOM_FEATURE_DIMS, emb_dim, generator=generator)

    def forward(self, atom_feat: torch.Tensor) -> torch.Tensor:
        return self.atom(atom_feat)


class BondEncoder(nn.Module):
    """The first `width` categorical bond features → summed embedding
    [..., emb_dim]: 3 from `mol2graph`, 1 (the bond type) in the QM9 graph
    variants, whose table then has the bond-type rows only, as in JAX. The
    width is fixed when the module is built; other input raises. The
    lookup is an `index_select`, whose backward is `index_add_`."""

    def __init__(self, emb_dim: int, width: int = NUM_BOND_FEATURES, *,
                 generator: torch.Generator):
        super().__init__()
        if not 1 <= width <= NUM_BOND_FEATURES:
            raise ValueError(f"bond feature width {width} not in 1..{NUM_BOND_FEATURES}")
        self.width = width
        self.bond = _MultiEmbeddingSum(BOND_FEATURE_DIMS[:width], emb_dim, generator=generator)

    def forward(self, bond_feat: torch.Tensor) -> torch.Tensor:
        if bond_feat.shape[-1] != self.width:
            raise ValueError(f"BondEncoder built for {self.width} bond feature column(s) got "
                             f"{bond_feat.shape[-1]}")
        table = self.bond.embedding
        rows = table.index_select(0, (bond_feat + self.bond.offsets).reshape(-1))
        return rows.view(bond_feat.shape + (table.shape[-1],)).sum(dim=-2)


class HedgeEncoder(nn.Module):
    """Hyperedge type (bond type 0-4, 5 = conjugated) → [..., emb_dim]: the
    reference's `nn.Embedding(6, hidden)` (`reference equihgnn/models/mhnn.py:33`),
    initialized N(0, 1) as torch's Embedding; looked up with `index_select`."""

    def __init__(self, emb_dim: int, *, generator: torch.Generator):
        super().__init__()
        self.embedding = nn.Parameter(
            normal_(torch.empty(NUM_HEDGE_TYPES, emb_dim), 1.0, generator)
        )

    def forward(self, hedge_feat: torch.Tensor) -> torch.Tensor:
        return self.embedding.index_select(0, hedge_feat.reshape(-1)).reshape(
            hedge_feat.shape + (-1,))
