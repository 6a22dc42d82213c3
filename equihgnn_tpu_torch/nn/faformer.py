"""FAFormer: frame-averaging transformer over molecular point clouds.

Port of `equihgnn_tpu/nn/faformer.py` (the reference's
`fa_former_layer.py:9-716`) on the dense per-molecule slot view
[G, A, ...], one molecule per row:

  * frames (`_frame_stats`, `create_frame`, `create_frame_basis`,
    `invert_frame`): the 2³ sign flips of the eigenvectors of the
    stop-gradient (`.detach()`) covariance of the masked, centered
    coordinates, from the closed-form `ops/eigh3.py`;
  * `EdgeModule`: local frames over each atom's k-neighbourhood; the
    coordinate MLP runs on [frame coords ‖ squared norm];
  * `MLPAttnEdgeAggregation`: MLP attention over the kNN with edge
    features and a learnable gate on the coordinates;
  * `FAFFN`: frame-averaged coordinate features fused into the FFN;
  * SwiGLU MLPs with an inner LayerNorm. With `activation="swiglu"` (the
    only one a registered model uses) every frame-averaged MLP is a
    `_FrameSwiGLU`, which calls kernels D/E (`ops/kernels/frame_swiglu.py`)
    on the unsigned projection: the [.., 8, .., H] frame tensor is never
    built on the card.

The module tree mirrors the flax tree (`fc1`, `norm`, `fc2`, `layers_{i}`,
`self_attn/qkv_ln`, ...), so `convert.params_from_jax` maps it by rule.

Not ported yet, and raising NotImplementedError: the packed-row frames
(`slot_gid` given: several molecules per slot row; ROADMAP item 4) and the
faithful equivariant multi-head aggregation (`faithful_frame_agg=True`,
`W_frame_agg`). The default (`False`) replicates the reference's bug: with
n_heads > 1 the geometric context is the per-molecule centroid.

Dropout: `proj_drop` and `attn_drop` are active in `train()` mode through
`nn.Dropout` (torch's global generator); inside `_FrameSwiGLU` the kernels'
counter-based mask is seeded per call from the CPU generator (see
`ops/kernels/frame_swiglu.py`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from equihgnn_tpu_torch.nn.mlp import TorchLinear
from equihgnn_tpu_torch.ops.eigh3 import eigh3x3
from equihgnn_tpu_torch.ops.gather import nbr_gather
from equihgnn_tpu_torch.ops.kernels.frame_swiglu import SIGN_OPS, fused_frame_swiglu
from equihgnn_tpu_torch.ops.knn import knn_dense

_SIGN_OPS = torch.tensor(SIGN_OPS)  # [8, 3] (`fa_former_layer.py:70-83`)
_ACTS = {"gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu
         "silu": F.silu, "relu": F.relu}


def _basis_vectors(cov: torch.Tensor, deg: torch.Tensor) -> torch.Tensor:
    """cov [..., 3, 3] (stop-gradient), deg [..., 1, 1] bool → eigvec
    [..., 3, 3] (columns = PCA eigenvectors; identity where degenerate)."""
    cov = torch.where(deg, torch.eye(3, dtype=cov.dtype, device=cov.device), cov)
    return eigh3x3(cov)[1]


def _sign_expand(eigvec: torch.Tensor) -> torch.Tensor:
    """eigvec [..., 3, 3] → F_ops [..., 8, 3, 3]: the 2³ sign flips,
    F_ops[..., o, i, j] = ops[o, j] · eigvec[..., i, j]."""
    ops = _SIGN_OPS.to(dtype=eigvec.dtype, device=eigvec.device)
    return ops[:, None, :] * eigvec[..., None, :, :]


def _frame_stats(coords, mask, slot_gid=None):
    """Masked centering, stop-gradient covariance, degeneracy gate and
    eigenbasis: (x_centered [..., P, 3], eigvec [..., 3, 3], center [..., 3])."""
    if slot_gid is not None:
        raise NotImplementedError(
            "FAFormer frames over packed slot rows (slot_gid given) are not ported "
            "yet: ROADMAP item 4"
        )
    coords = coords.float()
    m = mask[..., None].float()
    cnt = torch.clamp(torch.sum(m, dim=-2), min=1.0)  # [..., 1]
    center = torch.sum(coords * m, dim=-2) / cnt  # [..., 3]
    x = (coords - center[..., None, :]) * m  # masked centering
    cov = torch.einsum("...pi,...pj->...ij", x, x).detach()
    deg = (torch.sum(m, dim=(-2, -1)) < 0.5)[..., None, None]
    return x, _basis_vectors(cov, deg), center


def create_frame(coords, mask, slot_gid=None):
    """coords [..., P, 3], mask [..., P] → (projected [..., 8, P, 3],
    F_ops [..., 8, 3, 3], center [..., 3]). Gradients flow through the
    coordinates but not the eigenvectors."""
    x, eigvec, center = _frame_stats(coords, mask, slot_gid)
    f_ops = _sign_expand(eigvec)
    # h[..., o, p, i] = Σ_j F_ops[..., o, j, i] x[..., p, j]
    h = torch.einsum("...oji,...pj->...opi", f_ops, x)
    return h.to(coords.dtype), f_ops, center


def create_frame_basis(coords, mask, slot_gid=None):
    """Unsigned frame projection Vᵀ(coords − center), [..., P, 3], and the
    center: `create_frame`'s h[..., o, p, i] = s_o[i]·vbar[p, i], from the
    same statistics."""
    x, eigvec, center = _frame_stats(coords, mask, slot_gid)
    vbar = torch.einsum("...ji,...pj->...pi", eigvec, x)
    return vbar.to(coords.dtype), center


def invert_frame(x, mask, f_ops, center):
    """Average frame-local vectors back to the global frame
    (`fa_former_layer.py:114-120`): x [..., 8, P, 3] → [..., P, 3]."""
    out = torch.einsum("...oij,...opj->...opi", f_ops, x).mean(dim=-3)
    out = (out + center[..., None, :]) * mask[..., None].to(out.dtype)
    return out.to(x.dtype)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=1e-5)


class _MLP(nn.Module):
    """MLPWrapper: fc1 → act → dropout → LayerNorm → (frame mean) → fc2 →
    dropout. `mean_axis` averages the sign frames between the halves, as
    JAX's `_MLP` does (exact: the mean commutes with the affine fc2)."""

    def __init__(self, in_features: int, hidden: int, out: int, activation: str = "gelu",
                 drop: float = 0.0, mean_axis: int | None = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.act, self.mean_axis = _ACTS[activation], mean_axis
        self.fc1 = TorchLinear(in_features, hidden, generator=generator)
        self.norm = _layer_norm(hidden)
        self.fc2 = TorchLinear(hidden, out, generator=generator)
        self.dropout = nn.Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm(self.dropout(self.act(self.fc1(x))))
        if self.mean_axis is not None:
            x = x.mean(dim=self.mean_axis)
        return self.dropout(self.fc2(x))


class _SwiGLU(nn.Module):
    """SwiGLU MLP with inner LayerNorm (`fa_former_layer.py:245-290`)."""

    def __init__(self, in_features: int, hidden: int, out: int, drop: float = 0.0,
                 mean_axis: int | None = None, *, generator: torch.Generator):
        super().__init__()
        self.mean_axis = mean_axis
        self.fc1 = TorchLinear(in_features, hidden, generator=generator)
        self.norm = _layer_norm(hidden // 2)
        self.fc2 = TorchLinear(hidden // 2, out, generator=generator)
        self.dropout = nn.Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = self.fc1(x).chunk(2, dim=-1)
        x = self.norm(self.dropout(F.silu(x1) * x2))
        if self.mean_axis is not None:
            x = x.mean(dim=self.mean_axis)
        return self.dropout(self.fc2(x))


class _FrameSwiGLU(nn.Module):
    """Frame-averaged `_SwiGLU` without the 8-frame tensor: x [..., C] with
    columns 0..2 the unsigned frame projection (`create_frame_basis`) and
    3.. frame-invariant. fc1 → SwiGLU → dropout → LayerNorm → frame mean is
    `fused_frame_swiglu` (kernels D/E on the card, the plain version on the
    CPU), at dropout `drop` in `train()` mode and 0 in `eval()`; then fc2
    and dropout. Same parameters as `_SwiGLU` (fc1, norm, fc2)."""

    def __init__(self, in_features: int, hidden: int, out: int, drop: float = 0.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.drop = drop
        self.fc1 = TorchLinear(in_features, hidden, generator=generator)
        self.norm = _layer_norm(hidden // 2)
        self.fc2 = TorchLinear(hidden // 2, out, generator=generator)
        self.dropout = nn.Dropout(drop)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        rate = self.drop if self.training else 0.0
        # the mask's seed, from the CPU generator (no device sync)
        seed = int(torch.randint(0, 2**31 - 1, ())) if rate > 0.0 else 0
        y = fused_frame_swiglu(
            x.reshape(-1, x.shape[-1]), self.fc1.weight.t().contiguous(), self.fc1.bias,
            self.norm.weight, self.norm.bias, drop_rate=rate, seed=seed,
        )
        y = y.view(x.shape[:-1] + (y.shape[-1],))
        return self.dropout(self.fc2(y))


def _mlp(in_features, hidden, out, activation, drop, mean_axis=None, *, generator):
    if activation == "swiglu":
        return _SwiGLU(in_features, hidden, out, drop=drop, mean_axis=mean_axis,
                       generator=generator)
    return _MLP(in_features, hidden, out, activation=activation, drop=drop,
                mean_axis=mean_axis, generator=generator)


class EdgeModule(nn.Module):
    """Local-frame edge features with attention gating
    (`fa_former_layer.py:340-400`)."""

    def __init__(self, d_model: int, d_edge_model: int, proj_drop: float = 0.0,
                 activation: str = "gelu", *, generator: torch.Generator):
        super().__init__()
        self.swiglu = activation == "swiglu"
        if self.swiglu:
            self.coord_mlp = _FrameSwiGLU(4, d_edge_model, d_edge_model, drop=proj_drop,
                                          generator=generator)
        else:
            self.coord_mlp = _mlp(4, d_edge_model, d_edge_model, activation, proj_drop,
                                  mean_axis=2, generator=generator)
        self.edge_mlp = _mlp(2 * d_model + d_edge_model, d_model, d_model, activation,
                             proj_drop, generator=generator)
        self.att_mlp = TorchLinear(d_model, 1, generator=generator)

    def forward(self, token, geo, nbr_idx, nbr_mask):
        # token [G, A, d], geo [G, A, 3], nbr_idx/nbr_mask [G, A, k]
        g, a, k = nbr_idx.shape
        radial = geo[:, :, None, :] - nbr_gather(geo, nbr_idx, nbr_mask)
        radial_norm = torch.sum(radial * radial, dim=-1, keepdim=True)
        if self.swiglu:  # unsigned basis; the sign expansion is the kernel's
            vbar, _ = create_frame_basis(radial, nbr_mask)  # [G, A, k, 3]
            frame_feats = self.coord_mlp(torch.cat([vbar, radial_norm], dim=-1))
        else:
            frames, _, _ = create_frame(radial, nbr_mask)  # [G, A, 8, k, 3]
            rn = radial_norm[:, :, None].expand(g, a, 8, k, 1)
            frame_feats = self.coord_mlp(torch.cat([frames, rn], dim=-1))
        # frame_feats [G, A, k, d_e]
        pair = torch.cat([token[:, :, None, :].expand(g, a, k, token.shape[-1]),
                          nbr_gather(token, nbr_idx, nbr_mask)], dim=-1)
        pair = self.edge_mlp(torch.cat([pair, frame_feats], dim=-1))
        return pair * torch.sigmoid(self.att_mlp(pair))


class FAFFN(nn.Module):
    """Frame-averaged coordinate features fused into the FFN
    (`fa_former_layer.py:293-337`)."""

    def __init__(self, d_model: int, proj_drop: float = 0.0, activation: str = "gelu",
                 mlp_ratio: float = 4.0, *, generator: torch.Generator):
        super().__init__()
        self.swiglu = activation == "swiglu"
        self.ln = _layer_norm(d_model)
        if self.swiglu:
            self.W_frame = _FrameSwiGLU(3, d_model, d_model, drop=proj_drop,
                                        generator=generator)
        else:
            self.W_frame = _mlp(3, d_model, d_model, activation, proj_drop, mean_axis=-3,
                                generator=generator)
        self.ffn = _mlp(2 * d_model, int(d_model * mlp_ratio), d_model, activation,
                        proj_drop, generator=generator)

    def forward(self, token, geo, slot_mask):
        token = self.ln(token)
        if self.swiglu:
            h = self.W_frame(create_frame_basis(geo, slot_mask)[0])
        else:
            h = self.W_frame(create_frame(geo, slot_mask)[0])  # frames [G, 8, A, 3]
        return self.ffn(torch.cat([token, h], dim=-1))  # h [G, A, d]


class MLPAttnEdgeAggregation(nn.Module):
    """MLP attention + multi-head geometric aggregation
    (`fa_former_layer.py:403-573`), with the reference's bug replicated: for
    n_heads > 1 the geometric context is the per-molecule centroid (see
    `equihgnn_tpu/nn/faformer.py`'s class docstring)."""

    def __init__(self, d_model: int, d_edge_model: int, n_heads: int,
                 proj_drop: float = 0.0, attn_drop: float = 0.0, activation: str = "gelu",
                 faithful_frame_agg: bool = False, *, generator: torch.Generator):
        super().__init__()
        if faithful_frame_agg:
            raise NotImplementedError(
                "faithful_frame_agg=True (W_frame_agg) is not ported yet: ROADMAP item 6"
            )
        self.n_heads = n_heads
        d, de, nh = d_model, d_edge_model, n_heads
        self.qkv_ln = _layer_norm(d)
        self.qkv_lin = TorchLinear(d, 3 * d, generator=generator)
        self.qkv_edge_ln = _layer_norm(de)
        self.qkv_edge_lin = TorchLinear(de, 2 * de, generator=generator)
        # W_gate init: weight 0, bias 1 → the gate starts at σ(1) (`:446-448`)
        self.W_gate = TorchLinear(d, 1, generator=generator)
        with torch.no_grad():
            self.W_gate.weight.zero_()
            self.W_gate.bias.fill_(1.0)
        self.mlp_attn = TorchLinear(d // nh, 1, generator=generator, bias=False)
        self.edge_attn = TorchLinear(de // nh, 1, generator=generator, bias=False)
        self.attn_dropout = nn.Dropout(attn_drop)
        self.W_output = _mlp(d + de, d, d, activation, proj_drop, generator=generator)

    def forward(self, token, geo, edge_feats, nbr_idx, nbr_mask, slot_mask):
        g, a, k = nbr_idx.shape
        nh = self.n_heads
        qkv = self.qkv_lin(self.qkv_ln(token))
        q_s, k_s, v_s = (t.reshape(g, a, nh, -1) for t in qkv.chunk(3, dim=-1))
        qv_e = self.qkv_edge_lin(self.qkv_edge_ln(edge_feats))
        q_e, v_e = (t.reshape(g, a, k, nh, -1) for t in qv_e.chunk(2, dim=-1))
        gate = torch.sigmoid(self.W_gate(token))

        # attention logits over the neighbours
        message = q_s[:, :, None] + nbr_gather(k_s, nbr_idx, nbr_mask)
        attn = self.mlp_attn(message)[..., 0] + self.edge_attn(q_e)[..., 0]  # [G, A, k, nh]
        attn = torch.where(nbr_mask[..., None], attn.float(), -1e9)
        attn = self.attn_dropout(torch.softmax(attn, dim=2).to(v_e.dtype))

        v_nb = nbr_gather(v_s, nbr_idx, nbr_mask)  # [G, A, k, nh, dh]
        scalar_ctx = torch.einsum("gakh,gakhd->gahd", attn, v_nb).reshape(g, a, -1)
        edge_ctx = torch.einsum("gakh,gakhd->gahd", attn, v_e).reshape(g, a, -1)
        scalar_out = self.W_output(torch.cat([scalar_ctx, edge_ctx], dim=-1)) + token

        if nh == 1:
            geo_ctx = torch.einsum("gakh,gakd->gad", attn, nbr_gather(geo, nbr_idx, nbr_mask))
        else:  # the reference-bug path: the per-molecule centroid
            mf = slot_mask[..., None].float()
            cnt = torch.clamp(torch.sum(mf, dim=-2, keepdim=True), min=1.0)
            center = torch.sum(geo.float() * mf, dim=-2, keepdim=True) / cnt
            geo_ctx = (center.expand(geo.shape) * mf).to(geo.dtype)
        return scalar_out, geo_ctx * gate + geo * (1.0 - gate)


class FAFormerEncoderLayer(nn.Module):
    """`fa_former_layer.py:576-618`."""

    def __init__(self, d_model: int, d_edge_model: int, n_heads: int,
                 proj_drop: float = 0.0, attn_drop: float = 0.0, activation: str = "gelu",
                 faithful_frame_agg: bool = False, *, generator: torch.Generator):
        super().__init__()
        self.self_attn = MLPAttnEdgeAggregation(
            d_model, d_edge_model, n_heads, proj_drop, attn_drop, activation,
            faithful_frame_agg, generator=generator)
        self.edge_module = EdgeModule(d_model, d_edge_model, proj_drop, activation,
                                      generator=generator)
        self.ffn = FAFFN(d_model, proj_drop, activation, generator=generator)

    def forward(self, token, geo, edge_feats, nbr_idx, nbr_mask, slot_mask):
        token, geo = self.self_attn(token, geo, edge_feats, nbr_idx, nbr_mask, slot_mask)
        edge_feats = edge_feats + self.edge_module(token, geo, nbr_idx, nbr_mask)
        token = token + self.ffn(token, geo, slot_mask)
        return token, geo, edge_feats


class FAFormer(nn.Module):
    """Top-level FAFormer (`fa_former_layer.py:621-716`) on the dense slot
    view; input and output in the flat [N, ...] atom layout."""

    def __init__(self, d_input: int = 64, d_model: int = 64, d_edge_model: int = 64,
                 n_layers: int = 3, n_heads: int = 4, n_neighbors: int = 16,
                 valid_radius: float = 1e6, proj_drop: float = 0.1, attn_drop: float = 0.1,
                 activation: str = "silu", faithful_frame_agg: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.n_layers, self.n_neighbors, self.valid_radius = n_layers, n_neighbors, valid_radius
        self.input_transform = TorchLinear(d_input, d_model, generator=generator)
        self.dropout = nn.Dropout(proj_drop)
        self.edge_module = EdgeModule(d_model, d_edge_model, proj_drop, activation,
                                      generator=generator)
        for i in range(n_layers):
            self.add_module(f"layers_{i}", FAFormerEncoderLayer(
                d_model, d_edge_model, n_heads, proj_drop, attn_drop, activation,
                faithful_frame_agg, generator=generator))

    def forward(
        self,
        features: torch.Tensor,  # [N, d_input]
        coords: torch.Tensor,  # [N, 3]
        graph_id: torch.Tensor,  # [N] slot row of each atom
        slot_index: torch.Tensor,  # [G, A] flat atom index per slot
        slot_mask: torch.Tensor,  # [G, A] bool
        atom_slot: torch.Tensor,  # [N] slot within its row
    ):
        """(token_embs [N, d_model], coords [N, 3]) after the encoder; one
        molecule per slot row."""
        g, a = slot_mask.shape
        sm = slot_mask[..., None].to(features.dtype)
        token = self.dropout(self.input_transform(features))
        flat = slot_index.reshape(-1)  # index_select: its backward is index_add_
        td = token.index_select(0, flat).view(g, a, -1) * sm  # [G, A, d]
        geo = coords.index_select(0, flat).view(g, a, 3) * sm  # [G, A, 3]

        nbr_idx, nbr_mask, _ = knn_dense(
            geo, slot_mask, min(self.n_neighbors, a), valid_radius=self.valid_radius,
            squared_radius=False, exclude_self=True,  # `_build_graph` (`:651-656`)
        )
        edge_feats = self.edge_module(td, geo, nbr_idx, nbr_mask)
        for i in range(self.n_layers):
            td, geo, edge_feats = getattr(self, f"layers_{i}")(
                td, geo, edge_feats, nbr_idx, nbr_mask, slot_mask)
        out = graph_id * a + atom_slot
        return (td.reshape(g * a, -1).index_select(0, out),
                geo.reshape(g * a, 3).index_select(0, out))
