"""Per-molecule k-nearest-neighbour selection in the dense slot layout.

Port of `knn_dense` (`equihgnn_tpu/ops/knn.py:92-129`). Ranking is by the
squared distance over [R, A] slot rows (O(R·A²)). The two options keep
JAX's names and defaults:

  * `squared_radius`: `valid_radius` (when given) is compared against the
    squared distance (True; the reference EGNN's quirk,
    `egnn_layer.py:256,283-285`) or against the distance, i.e. the squared
    distance against `valid_radius**2` (False, the default; FAFormer);
  * `exclude_self`: drop the self edge (FAFormer's `_build_graph`,
    `fa_former_layer.py:651-656`); EGNN keeps it.

`lax.top_k` returns ties lower index first; a stable ascending sort of the
same ranking does too, so invalid slots (all ranked `BIG`) resolve to the
same indices as in the JAX package.
"""

from __future__ import annotations

import torch

BIG = 1e5  # the reference's masked-fill value (`egnn_layer.py:262`)


def knn_dense(
    pos_d: torch.Tensor,  # [R, A, 3] row-major coordinates
    slot_mask: torch.Tensor,  # [R, A] bool
    k: int,
    valid_radius: float | None = None,
    squared_radius: bool = False,
    exclude_self: bool = False,
    slot_gid: torch.Tensor | None = None,  # [R, A] molecule id per slot
):
    """Returns (idx [R, A, k] int64 into the A axis, mask [R, A, k] bool,
    rank [R, A, k]: the squared distance, BIG where invalid); the neighbour
    axis is padded to k when A < k. All three are contiguous."""
    a = pos_d.shape[1]
    k_eff = min(k, a)
    diff = pos_d[:, :, None, :] - pos_d[:, None, :, :]
    sq = torch.sum(diff * diff, dim=-1)  # [R, A, A]
    invalid = ~(slot_mask[:, :, None] & slot_mask[:, None, :])
    if slot_gid is not None:
        invalid |= slot_gid[:, :, None] != slot_gid[:, None, :]
    if exclude_self:
        invalid |= torch.eye(a, dtype=torch.bool, device=pos_d.device)
    ranking = torch.where(invalid, torch.full_like(sq, BIG), sq)
    nbr_rank, nbr_idx = torch.sort(ranking, dim=-1, stable=True)
    nbr_rank = nbr_rank[..., :k_eff].contiguous()
    nbr_idx = nbr_idx[..., :k_eff].contiguous()
    nbr_mask = nbr_rank < BIG / 2
    if valid_radius is not None:
        nbr_mask &= nbr_rank <= (valid_radius if squared_radius else valid_radius**2)
    if k_eff < k:  # pad the neighbour axis to the static k
        pad = (0, k - k_eff)
        nbr_idx = torch.nn.functional.pad(nbr_idx, pad)
        nbr_mask = torch.nn.functional.pad(nbr_mask, pad)
        nbr_rank = torch.nn.functional.pad(nbr_rank, pad, value=BIG)
    return nbr_idx, nbr_mask, nbr_rank
