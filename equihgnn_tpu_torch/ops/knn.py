"""k-nearest-neighbour selection: per molecule in the dense slot layout,
or over the flat [N, 3] coordinates of a whole batch.

Port of `knn_dense` (`equihgnn_tpu/ops/knn.py:92-129`), whose ranking is by
the squared distance over [R, A] slot rows (O(R·A²)), and of `knn_graph`
(`:35-89`), over all N atoms (O(N²); `graph_id` keeps each atom's
neighbours in its molecule, None makes the batch one point cloud, as the
reference's EGNN sees it). The options keep JAX's names and defaults:

  * `squared_radius`: `valid_radius` (when given) is compared against the
    squared distance (True; the reference EGNN's quirk,
    `egnn_layer.py:256,283-285`) or against the distance, i.e. the squared
    distance against `valid_radius**2` (False, the default; FAFormer);
  * `exclude_self`: drop the self edge (FAFormer's `_build_graph`,
    `fa_former_layer.py:651-656`); EGNN keeps it.

`lax.top_k` returns ties lower index first; a stable ascending sort of the
same ranking does too, so invalid slots (all ranked `BIG`) resolve to the
same indices as in the JAX package. `knn_graph` ranks a chunk of rows at a
time (~`PAIRS_PER_CHUNK` pairs), so that its [rows, N] ranking and sort stay
small at any N.

On bfloat16 positions (the EGNN models' compute dtype) the differences are
bf16 and each squared distance is their squares' f32 sum rounded once to
bf16 (`sq_dist`), as XLA compiles JAX's `jnp.sum(diff * diff, -1)`: it
keeps the products before a reduction unrounded. bf16 squared distances tie
often; ties resolve lower index first on both sides.
"""

from __future__ import annotations

import torch

BIG = 1e5  # the reference's masked-fill value (`egnn_layer.py:262`)
PAIRS_PER_CHUNK = 1 << 24  # pairs knn_graph ranks and sorts at a time


def sq_dist(diff: torch.Tensor) -> torch.Tensor:
    """Σ diff² over the last axis; for bfloat16 differences the squares are
    summed in float32 and rounded once, as JAX's fused reduction does."""
    if diff.dtype == torch.bfloat16:
        d = diff.float()
        return torch.sum(d * d, dim=-1).to(diff.dtype)
    return torch.sum(diff * diff, dim=-1)


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
    sq = sq_dist(pos_d[:, :, None, :] - pos_d[:, None, :, :])  # [R, A, A]
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


def knn_graph(
    pos: torch.Tensor,  # [N, 3]
    k: int,
    mask: torch.Tensor | None = None,  # [N] bool
    graph_id: torch.Tensor | None = None,  # [N] molecule id; None: one point cloud
    valid_radius: float | None = None,
    squared_radius: bool = False,
    exclude_self: bool = False,
):
    """Returns (idx [N, k] int64, mask [N, k] bool, sqdist [N, k]: the
    squared distance to each neighbour). A pair is invalid (ranked `BIG`)
    where either point is masked, the molecules differ, or (with
    `exclude_self`) it is the point itself."""
    n = pos.shape[0]
    if k > n:
        raise ValueError(f"k = {k} neighbours of {n} points")
    chunk = max(1, PAIRS_PER_CHUNK // n)
    cols = torch.arange(n, device=pos.device)
    idx_parts, rank_parts = [], []
    with torch.no_grad():
        for r0 in range(0, n, chunk):
            r1 = min(n, r0 + chunk)
            ranking = sq_dist(pos[r0:r1, None, :] - pos[None, :, :])  # [rows, N]
            invalid = torch.zeros(ranking.shape, dtype=torch.bool, device=pos.device)
            if mask is not None:
                invalid |= ~(mask[r0:r1, None] & mask[None, :])
            if graph_id is not None:
                invalid |= graph_id[r0:r1, None] != graph_id[None, :]
            if exclude_self:
                invalid |= cols[r0:r1, None] == cols[None, :]
            ranking.masked_fill_(invalid, BIG)
            rank, idx = torch.sort(ranking, dim=-1, stable=True)
            rank_parts.append(rank[:, :k])
            idx_parts.append(idx[:, :k])
    nbr_idx = torch.cat(idx_parts).contiguous()
    nbr_rank = torch.cat(rank_parts)
    nbr_mask = nbr_rank < BIG / 2
    if valid_radius is not None:
        nbr_mask &= nbr_rank <= (valid_radius if squared_radius else valid_radius**2)
    diff = pos[:, None, :] - pos.index_select(0, nbr_idx.reshape(-1)).view(n, k, -1)
    return nbr_idx, nbr_mask, sq_dist(diff)
