"""OGB-compatible atom embedding (port of `AtomEncoder`,
`equihgnn_tpu/nn/encoders.py:50`): one table per categorical feature,
summed, stored as one flat table with per-feature offsets. Tables are
initialized xavier-uniform, as OGB does."""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from equihgnn_tpu_torch.data.structures import ATOM_FEATURE_DIMS
from equihgnn_tpu_torch.nn.mlp import uniform_


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
