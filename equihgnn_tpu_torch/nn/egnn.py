"""E(n)-equivariant graph layer (EGNN), on the dense per-molecule slot view
or on the flat batch.

Port of `equihgnn_tpu/nn/egnn.py` (`EGNN`: the dense path `:224-259`, the
flat path `:261-276`), itself the reference's single EGNN layer
(`reference equihgnn/models/layers/egnn_layer.py:145-366`). Semantics kept:

  * ranking and `rel_dist` use the **squared** distance, and `valid_radius`
    is compared against the squared distance (`egnn_layer.py:256,283-285`);
  * the radius mask is dead on the model path: the reference applies it
    only when called with a `mask`, which no EquiHNN model passes, so all
    k = 16 neighbours contribute (`apply_radius_mask=False`, the default);
  * the self edge is kept (distance 0);
  * edge MLP [Linear(2d+1 → 2(2d+1)), SiLU, Linear(→ m), SiLU] with layer 0
    split as Wi·x_i + Wj·x_j + wd·|r|² + b; coordinate MLP
    [Linear(m → 4m), SiLU, Linear(4m → 1)]; node MLP
    [Linear(d+m → 2d), SiLU, Linear(2d → d)] + residual; CoorsNorm; a
    LayerNorm on the node features; every Linear weight ~ N(0, 1e-3²).

On the dense path (a batch with the slot view, `cross_molecule=False`)
the edge MLP runs as one fused kernel (`ops/kernels/edge_mlp.py`), so the
[R, A, k, 2(2d+1)] pre-activation is never stored; `ui = x·Wiᵀ` and
`ujn = x·Wjᵀ` are plain matmuls at the node sites. The kernel takes
`pair_mask` and gives 0 at the masked edges (it skips the slots with no
kept edge): both consumers of the messages mask them anyway, and the
coordinate MLP between works row by row, so a masked edge's message reaches
no output and no gradient, and the layer's outputs and gradients are the
same bits with the mask as without it (`tests/test_torch_egnn.py`).
Dropout is 0 in every model that uses this layer, so it has none.

The flat path runs where JAX's does: with `cross_molecule=True` (the
reference's batch-as-one-point-cloud kNN, `knn_graph` with no molecule
ids) or on a batch without the slot view (then `graph_id` keeps the
neighbours in the molecule). Its pair mask is
`nbr_mask & mask[:, None] & mask[nbr_idx]`, and its edge MLP is JAX's
unfused composition (`_EdgeLinear0`, SiLU, `edge_mlp_1`, SiLU) with the
same parameters, gathered with `index_select`: JAX fuses the edge MLP only
on the dense view (`nn/egnn.py:139-143`), so no kernel runs on this path.

In bfloat16 (the models' compute dtype) the features and positions come
in bf16 and the parameters stay f32, as in JAX: each Linear casts its
weights to the input's dtype (`nn/egnn.py:64,155-156`), `ui`, `ujn` and
`rel_dist` are bf16 (kernels B and C in bf16), `node_norm` takes float32
statistics and casts back (`:190-195`), and the coordinate update promotes
to f32 at `coors_norm`'s f32 scale, as JAX's does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from equihgnn_tpu_torch.nn.mlp import LayerNorm, TorchLinear, normal_, uniform_
from equihgnn_tpu_torch.ops.kernels.edge_mlp import fused_edge_messages
from equihgnn_tpu_torch.ops.knn import knn_dense, knn_graph, sq_dist
from equihgnn_tpu_torch.ops.numerics import safe_norm

EGNN_WEIGHT_STD = 1e-3  # `egnn_layer.py:227-230`
M_DIM = 16  # message width m of every EGNN the reference builds


def _egnn_linear(in_features: int, out_features: int, generator) -> TorchLinear:
    return TorchLinear(in_features, out_features, generator=generator,
                       weight_std=EGNN_WEIGHT_STD)


class _EdgeLinear0(nn.Module):
    """`edge_mlp` layer 0 in distributed form (exact reassociation):

        W·cat(x_i, x_j, |r|²) + b = Wi·x_i + Wj·x_j + wd·|r|² + b

    weight_i / weight_j [F, d], weight_d [F, 1] ~ N(0, 1e-3²),
    bias [F] ~ U(±1/√(2d+1))."""

    def __init__(self, dim: int, features: int, *, generator: torch.Generator):
        super().__init__()
        for name, fan in (("weight_i", dim), ("weight_j", dim), ("weight_d", 1)):
            w = normal_(torch.empty(features, fan), EGNN_WEIGHT_STD, generator)
            self.register_parameter(name, nn.Parameter(w))
        bound = 1.0 / math.sqrt(2.0 * dim + 1.0)
        self.bias = nn.Parameter(uniform_(torch.empty(features), bound, generator))


class CoorsNorm(nn.Module):
    """`egnn_layer.py:71-81`: unit directions scaled by a learnable scalar."""

    def __init__(self, eps: float = 1e-8, scale_init: float = 1e-2):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.full((1,), scale_init))

    def forward(self, coors: torch.Tensor) -> torch.Tensor:
        norm = safe_norm(coors, dim=-1, keepdim=True)
        return coors / torch.clamp(norm, min=self.eps) * self.scale


class EGNN(nn.Module):
    """One E(n)-equivariant message-passing layer over the k nearest
    neighbours of each atom: within its molecule, or across the batch with
    `cross_molecule=True`."""

    def __init__(self, dim: int, num_nearest_neighbors: int = 16,
                 valid_radius: float = 5.0, apply_radius_mask: bool = False,
                 cross_molecule: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.dim, self.k = dim, num_nearest_neighbors
        self.valid_radius, self.apply_radius_mask = valid_radius, apply_radius_mask
        self.cross_molecule = cross_molecule
        f = 2 * (2 * dim + 1)
        self.edge_mlp_0 = _EdgeLinear0(dim, f, generator=generator)
        self.edge_mlp_1 = _egnn_linear(f, M_DIM, generator)
        self.coors_mlp_0 = _egnn_linear(M_DIM, 4 * M_DIM, generator)
        self.coors_mlp_1 = _egnn_linear(4 * M_DIM, 1, generator)
        self.coors_norm = CoorsNorm()
        self.node_norm = LayerNorm(dim, eps=1e-5)
        self.node_mlp_0 = _egnn_linear(dim + M_DIM, 2 * dim, generator)
        self.node_mlp_1 = _egnn_linear(2 * dim, dim, generator)

    def forward(
        self,
        feats: torch.Tensor,  # [N, d]
        coors: torch.Tensor,  # [N, 3]
        slot_index: torch.Tensor | None = None,  # [R, A] flat atom index per slot
        slot_mask: torch.Tensor | None = None,  # [R, A] bool
        atom_slot: torch.Tensor | None = None,  # [N] slot within row
        atom_row: torch.Tensor | None = None,  # [N] row index
        slot_gid: torch.Tensor | None = None,  # [R, A] molecule id per slot
        mask: torch.Tensor | None = None,  # [N] bool (the flat path's)
        graph_id: torch.Tensor | None = None,  # [N] molecule id (the flat path's)
    ):
        """Returns (feats [N, d], coors [N, 3]) after one layer: on the
        dense slot view when given (and not `cross_molecule`), else on the
        flat batch."""
        if slot_index is None or self.cross_molecule:
            return self._flat(feats, coors, mask, None if self.cross_molecule else graph_id)
        sm = slot_mask[..., None].to(feats.dtype)
        xd = feats[slot_index] * sm  # [R, A, d]
        pd = coors[slot_index] * sm  # [R, A, 3]
        nbr_idx, pair_mask, _ = knn_dense(
            pd, slot_mask, self.k,
            valid_radius=self.valid_radius if self.apply_radius_mask else None,
            squared_radius=True, slot_gid=slot_gid,
        )
        rows = torch.arange(pd.shape[0], device=pd.device)[:, None, None]
        rel_coors = pd[:, :, None, :] - pd[rows, nbr_idx]  # [R, A, k, 3]
        rel_dist = sq_dist(rel_coors)  # [R, A, k]

        e0 = self.edge_mlp_0
        m_ij = fused_edge_messages(
            torch.matmul(xd, e0.weight_i.t().to(xd.dtype)),
            torch.matmul(xd, e0.weight_j.t().to(xd.dtype)),
            rel_dist, nbr_idx, e0.weight_d[:, 0], e0.bias,
            self.edge_mlp_1.weight.t().contiguous(), self.edge_mlp_1.bias,
            edge_mask=pair_mask,
        )  # [R, A, k, m], 0 at the masked edges
        xd, coors_out = self._update(xd, pd, m_ij, rel_coors, pair_mask)
        # back to the flat layout (padded atoms read the padding row)
        return xd[atom_row, atom_slot], coors_out[atom_row, atom_slot]

    def _flat(self, feats, coors, mask, graph_id):
        """The flat path over [N, k] neighbour lists (`knn_graph`)."""
        nbr_idx, nbr_mask, _ = knn_graph(
            coors, self.k, mask=mask, graph_id=graph_id,
            valid_radius=self.valid_radius if self.apply_radius_mask else None,
            squared_radius=True,
        )
        n, k = nbr_idx.shape
        flat_idx = nbr_idx.reshape(-1)
        rel_coors = coors[:, None, :] - coors.index_select(0, flat_idx).view(n, k, 3)
        rel_dist = sq_dist(rel_coors)[..., None]  # [N, k, 1]
        pair_mask = nbr_mask
        if mask is not None:
            pair_mask = pair_mask & mask[:, None] & mask.index_select(0, flat_idx).view(n, k)
        e0, dt = self.edge_mlp_0, feats.dtype
        ui = torch.matmul(feats, e0.weight_i.t().to(dt))  # [N, F] at the node sites
        uj = torch.matmul(feats, e0.weight_j.t().to(dt)).index_select(0, flat_idx).view(n, k, -1)
        m_ij = ui[:, None, :] + uj + rel_dist * e0.weight_d[:, 0].to(dt) + e0.bias.to(dt)
        m_ij = F.silu(self.edge_mlp_1(F.silu(m_ij)))  # [N, k, m]
        return self._update(feats, coors, m_ij, rel_coors, pair_mask)

    def _update(self, x, coors, m_ij, rel_coors, pair_mask):
        """The coordinate and node updates from the messages m_ij [..., k, m]."""
        w = self.coors_mlp_1(F.silu(self.coors_mlp_0(m_ij)))[..., 0]  # [..., k]
        w = torch.where(pair_mask, w, 0.0)
        rc = self.coors_norm(rel_coors)  # f32 in bf16 too: the scale is f32
        coors_out = torch.einsum("...k,...kc->...c", w.to(rc.dtype), rc) + coors

        m_i = torch.where(pair_mask[..., None], m_ij, 0.0).sum(dim=-2)
        h = torch.cat([self.node_norm(x), m_i], dim=-1)
        h = self.node_mlp_1(F.silu(self.node_mlp_0(h)))
        return h + x, coors_out
