"""ViSNet: vector-scalar interactive message passing.

Port of `equihgnn_tpu/nn/visnet.py` (the reference's
`visnet_layer.py:15-1053`) on the dense per-molecule slot view
[G, A, ...]: the radius graph with self loops is the k + 1 nearest slots
of each atom within the cutoff (`knn_dense`), with the self edge's zero
direction; `ExpNormalSmearing` RBFs with a cosine cutoff; real spherical
harmonics up to l = 2; `ViS_MP` layers; the `EquivariantScalar` readout of
two `GatedEquivariantBlock`s. Every projection is a `TorchLinear` with
ViSNet's init (xavier-uniform weight, zero bias), JAX's `_Proj`.

`ViS_MP`'s vector mix (the masked neighbour aggregation of `vec` and the
vector-rejection edge dot products) is `ops/kernels/vis_mix.py`: kernels
F-I on the card, the plain version on the CPU. The module tree mirrors the
flax tree (`vis_mp_layers_{i}/q_proj`, `output_network_{i}/update_net_0`,
...), so `convert.params_from_jax` maps it by rule; the non-trainable RBF
means and betas and the non-trainable vector-norm weight are constants, not
state-dict entries, as they are not flax parameters.

With `dtype="bfloat16"` (JAX's `ViSNet(dtype=...)`, `:429-433`) the layer
loop computes in bf16: x, vec, f_ij and d_ij are cast after the
EdgeEmbedding, and everything before that (positions, r_ij, the RBFs, both
AtomEncoders, `neighbor_combine`, `edge_proj`) stays f32. The parameters
stay f32, cast to the input's dtype where they meet it (`TorchLinear`,
`VecLayerNorm`'s weight, `:153`); the ViS_MP LayerNorm computes in f32 and
casts back (`:193-194`); the cosine cutoff of the attention is cast to its
dtype (`:234-236`); `out_norm` and `vec_out_norm` return f32 (`:466-470`),
so the readout runs in f32 and the encoder's output is f32. The port
rounds where XLA's CPU backend rounds JAX's bf16 ViSNet: every sum runs in
f32 and is rounded once, vec1·vec2 keeps its products in f32, SiLU rounds
at each op (`nn/mlp.py` `silu`), and the LayerNorms and the readout read the f32
residual sums x + dx and vec + dvec unrounded. The vector mix runs kernels
F-I in bf16 on the card.

Not ported, and raising NotImplementedError: `vertex=True` (`ViS_MP_Vertex`;
no registered model uses it, and the JAX fused path for it raises
NameError).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from equihgnn_tpu_torch.nn.encoders import AtomEncoder
from equihgnn_tpu_torch.nn.mlp import TorchLinear, silu
from equihgnn_tpu_torch.ops.gather import nbr_gather
from equihgnn_tpu_torch.ops.kernels.vis_mix import vis_vec_agg, vis_wdot
from equihgnn_tpu_torch.ops.knn import knn_dense
from equihgnn_tpu_torch.ops.numerics import safe_norm


def _proj(in_features: int, out_features: int, generator: torch.Generator,
          bias: bool = True) -> TorchLinear:
    return TorchLinear(in_features, out_features, generator=generator, bias=bias, xavier=True)


def _sum_of_products(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.sum(a * b, dim); below float32 the product is kept in f32 and
    the sum rounded once, as XLA's CPU backend computes `jnp.sum(a * b)` of
    two bf16 operands (as a dot; a product of three it rounds first)."""
    if a.dtype == torch.float32:
        return torch.sum(a * b, dim=dim)
    return torch.sum(a.float() * b.float(), dim=dim).to(a.dtype)


def cosine_cutoff(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """`visnet_layer.py:15-48`."""
    return 0.5 * (torch.cos(d * math.pi / cutoff) + 1.0) * (d < cutoff).to(d.dtype)


class ExpNormalSmearing(nn.Module):
    """`visnet_layer.py:51-115`. Trainable means and betas are parameters;
    otherwise they are constants."""

    def __init__(self, cutoff: float = 5.0, num_rbf: int = 32, trainable: bool = False):
        super().__init__()
        self.cutoff = cutoff
        start = math.exp(-cutoff)
        means = torch.from_numpy(np.linspace(start, 1.0, num_rbf).astype(np.float32))
        betas = torch.full((num_rbf,), (2.0 / num_rbf * (1.0 - start)) ** -2)
        if trainable:
            self.means, self.betas = nn.Parameter(means), nn.Parameter(betas)
        else:
            self.register_buffer("means", means, persistent=False)
            self.register_buffer("betas", betas, persistent=False)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        d = dist[..., None]
        alpha = 5.0 / self.cutoff
        return cosine_cutoff(d, self.cutoff) * torch.exp(
            -self.betas * (torch.exp(-alpha * d) - self.means) ** 2)


def spherical_harmonics_l2(vec: torch.Tensor, lmax: int = 2) -> torch.Tensor:
    """Real SH of unit vectors up to l = 2, ViSNet's convention
    (`visnet_layer.py:118-193`): [..., 3] → [..., 3] or [..., 8]."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    sh1 = [x, y, z]
    if lmax == 1:
        return torch.stack(sh1, dim=-1)
    if lmax != 2:
        raise ValueError(f"'lmax' needs to be 1 or 2 (got {lmax})")
    s3 = math.sqrt(3.0)
    sh2 = [s3 * x * z, s3 * x * y, y * y - 0.5 * (x * x + z * z), s3 * y * z,
           s3 / 2.0 * (z * z - x * x)]
    return torch.stack(sh1 + sh2, dim=-1)


class VecLayerNorm(nn.Module):
    """`visnet_layer.py:196-287` on vec [..., L, C]: norm_type None is a
    fixed channel weighting (the identity unless trainable); "max_min"
    rescales the per-channel norms to [0, 1], the l = 1 and l = 2 blocks
    apart when L = 8."""

    def __init__(self, hidden_channels: int, trainable: bool = False,
                 norm_type: str | None = None, eps: float = 1e-12):
        super().__init__()
        self.norm_type, self.eps = norm_type, eps
        if trainable:
            self.weight = nn.Parameter(torch.ones(hidden_channels))
        else:
            self.register_parameter("weight", None)

    def _max_min(self, vec: torch.Tensor) -> torch.Tensor:
        dist = safe_norm(vec, dim=-2, keepdim=True)  # [..., 1, C]
        direct = vec / torch.clamp(dist, min=self.eps)
        max_v = torch.amax(dist, dim=-1, keepdim=True)
        min_v = torch.amin(dist, dim=-1, keepdim=True)
        delta = max_v - min_v
        delta = torch.where(delta == 0, torch.ones_like(delta), delta)
        out = F.relu((dist - min_v) / delta) * direct
        all_zero = torch.all(dist == 0, dim=-1, keepdim=True).all(dim=-2, keepdim=True)
        return torch.where(all_zero, torch.zeros_like(out), out)

    def forward(self, vec: torch.Tensor) -> torch.Tensor:
        if self.norm_type == "max_min":
            if vec.shape[-2] == 8:
                vec = torch.cat([self._max_min(vec[..., :3, :]), self._max_min(vec[..., 3:, :])],
                                dim=-2)
            else:
                vec = self._max_min(vec)
        return vec if self.weight is None else vec * self.weight.to(vec.dtype)


class ViS_MP(nn.Module):
    """Vector-scalar attention message passing (`visnet_layer.py:472-679`)
    on the dense [G, A, k] edge layout; the last layer has no edge update."""

    def __init__(self, num_heads: int, hidden_channels: int, cutoff: float,
                 vecnorm_type: str | None, trainable_vecnorm: bool, last_layer: bool = False,
                 vertex: bool = False, *, generator: torch.Generator):
        super().__init__()
        if vertex:
            raise NotImplementedError("ViS_MP vertex=True (ViS_MP_Vertex) is not ported yet")
        h = hidden_channels
        self.num_heads, self.cutoff, self.last_layer = num_heads, cutoff, last_layer
        self.layernorm = nn.LayerNorm(h, eps=1e-5)
        self.vec_layernorm = VecLayerNorm(h, trainable_vecnorm, vecnorm_type)
        for name in ("q_proj", "k_proj", "v_proj", "dk_proj", "dv_proj"):
            setattr(self, name, _proj(h, h, generator))
        self.vec_proj = _proj(h, 3 * h, generator, bias=False)
        self.s_proj = _proj(h, 2 * h, generator)
        self.o_proj = _proj(h, 3 * h, generator)
        if not last_layer:
            self.w_trg_proj = _proj(h, h, generator, bias=False)
            self.w_src_proj = _proj(h, h, generator, bias=False)
            self.f_proj = _proj(h, h, generator)

    def forward(self, x, vec, nbr_idx, nbr_mask, r_ij, f_ij, d_ij):
        # x [G, A, h] (f32 or the compute dtype), vec [G, A, L, h],
        # nbr_idx/nbr_mask/r_ij [G, A, k], f_ij [G, A, k, h], d_ij [G, A, k, L]
        g, a, k = nbr_idx.shape
        nh = self.num_heads
        x = self.layernorm(x.float()).to(vec.dtype)  # f32 statistics, as JAX's LayerNorm
        vec = self.vec_layernorm(vec)
        q, kk, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        dk = silu(self.dk_proj(f_ij))
        dv = silu(self.dv_proj(f_ij))
        vec1, vec2, vec3 = self.vec_proj(vec).chunk(3, dim=-1)
        vec_dot = _sum_of_products(vec1, vec2, dim=-2)  # [G, A, h]

        k_j = nbr_gather(kk, nbr_idx, nbr_mask)  # [G, A, k, h]
        prod = q[:, :, None, :] * k_j * dk
        attn = prod.view(g, a, k, nh, -1).sum(-1)  # per-head reduce (bf16: f32 sums)
        attn = silu(attn) * cosine_cutoff(r_ij, self.cutoff).to(attn.dtype)[..., None]
        attn = torch.where(nbr_mask[..., None], attn, torch.zeros((), dtype=attn.dtype,
                                                                  device=attn.device))
        v_j = nbr_gather(v, nbr_idx, nbr_mask) * dv
        v_j = (v_j.view(g, a, k, nh, -1) * attn[..., None]).view(g, a, k, -1)
        s1, s2 = silu(self.s_proj(v_j)).chunk(2, dim=-1)  # s1: a strided view
        mk = nbr_mask[..., None].to(x.dtype)
        x_agg = torch.sum(v_j * mk, dim=2)  # [G, A, h]

        vec_agg = vis_vec_agg(vec, s1, s2 * mk, d_ij, nbr_idx, nbr_mask)
        o1, o2, o3 = self.o_proj(x_agg).chunk(3, dim=-1)
        dx = vec_dot * o2 + o3
        dvec = vec3 * o1[..., None, :] + vec_agg
        if self.last_layer:
            return dx, dvec, None
        # w1·w2 with w1 = u − (u·d)d, w2 = v − (v·(−d))(−d), u at the
        # target, v at the source (`visnet_layer.py:546-553,660-667`)
        w_dot = vis_wdot(d_ij, self.w_trg_proj(vec), self.w_src_proj(vec), nbr_idx, nbr_mask)
        return dx, dvec, silu(self.f_proj(f_ij)) * w_dot


class GatedEquivariantBlock(nn.Module):
    """torch_geometric's GatedEquivariantBlock (`visnet_layer.py:911-949`)."""

    def __init__(self, hidden_channels: int, out_channels: int,
                 scalar_activation: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.scalar_activation = scalar_activation
        self.vec1_proj = _proj(hidden_channels, hidden_channels, generator, bias=False)
        self.vec2_proj = _proj(hidden_channels, out_channels, generator, bias=False)
        self.update_net_0 = _proj(2 * hidden_channels, hidden_channels, generator)
        self.update_net_1 = _proj(hidden_channels, 2 * out_channels, generator)

    def forward(self, x, v):
        # x [..., h], v [..., L, h]
        vec1 = safe_norm(self.vec1_proj(v), dim=-2)
        vec2 = self.vec2_proj(v)
        h = F.silu(self.update_net_0(torch.cat([x, vec1], dim=-1)))
        x_out, gate = self.update_net_1(h).chunk(2, dim=-1)
        v_out = gate[..., None, :] * vec2
        return (F.silu(x_out) if self.scalar_activation else x_out), v_out


def edge_geometry(pd, slot_mask, k: int, cutoff: float, lmax: int, slot_gid=None):
    """radius_graph(loop=True) capped at k − 1 neighbours on the slot view
    pd [G, A, 3]: the k nearest slots, self included, within `cutoff`.
    Returns (nbr_idx, nbr_mask [G, A, k], r_ij [G, A, k] (0 where masked),
    is_self [G, A, k], d_ij [G, A, k, L]: the SH of the unit vectors i − j,
    0 on the self edge)."""
    g, a = slot_mask.shape
    nbr_idx, nbr_mask, sqd = knn_dense(pd, slot_mask, k, valid_radius=cutoff,
                                       squared_radius=False, exclude_self=False,
                                       slot_gid=slot_gid)
    zero = torch.zeros((), dtype=pd.dtype, device=pd.device)
    r_ij = torch.where(nbr_mask, torch.sqrt(torch.clamp(sqd, min=0.0)), zero)
    rows = torch.arange(g, device=pd.device)[:, None, None]
    edge_vec = pd[:, :, None, :] - pd[rows, nbr_idx]  # i − j
    is_self = nbr_idx == torch.arange(a, device=pd.device)[None, :, None]
    unit = edge_vec / safe_norm(edge_vec, dim=-1, keepdim=True)
    unit = torch.where(is_self[..., None], edge_vec, unit)  # the self edge stays 0
    return nbr_idx, nbr_mask, r_ij, is_self, spherical_harmonics_l2(unit, lmax)


class ViSNet(nn.Module):
    """Top-level ViSNet (`visnet_layer.py:754-1053`): per-atom scalars,
    input and output in the flat [N, ...] atom layout.

    `remat_layers` is JAX's: None recomputes each `ViS_MP` in the backward
    pass (`torch.utils.checkpoint`) only where the vector-mix kernels do
    not run, i.e. on CPU tensors; True always, False never. `dtype`
    ("bfloat16" or None) is the layer loop's compute dtype (see the module
    docstring).
    """

    def __init__(self, hidden_channels: int = 128, lmax: int = 2,
                 vecnorm_type: str | None = None, trainable_vecnorm: bool = False,
                 num_heads: int = 8, num_layers: int = 6, num_rbf: int = 32,
                 trainable_rbf: bool = False, cutoff: float = 5.0,
                 max_num_neighbors: int = 32, vertex: bool = False, std: float = 1.0,
                 remat_layers: bool | None = None, dtype: str | None = None, *,
                 generator: torch.Generator):
        super().__init__()
        h = hidden_channels
        self.compute_dtype = None if dtype in (None, "float32") else getattr(torch, dtype)
        self.lmax, self.cutoff, self.std = lmax, cutoff, std
        self.max_num_neighbors, self.num_layers = max_num_neighbors, num_layers
        self.remat_layers = remat_layers
        self.distance_expansion = ExpNormalSmearing(cutoff, num_rbf, trainable_rbf)
        self.embedding = AtomEncoder(h, generator=generator)
        self.neighbor_distance_proj = _proj(num_rbf, h, generator)
        self.neighbor_embedding = AtomEncoder(h, generator=generator)
        self.neighbor_combine = _proj(2 * h, h, generator)
        self.edge_proj = _proj(num_rbf, h, generator)
        for i in range(num_layers):
            self.add_module(f"vis_mp_layers_{i}", ViS_MP(
                num_heads, h, cutoff, vecnorm_type, trainable_vecnorm,
                last_layer=i == num_layers - 1, vertex=vertex, generator=generator))
        self.out_norm = nn.LayerNorm(h, eps=1e-5)
        self.vec_out_norm = VecLayerNorm(h, trainable_vecnorm, vecnorm_type)
        for i in range(2):
            self.add_module(f"output_network_{i}",
                            GatedEquivariantBlock(h, h, scalar_activation=True, generator=generator))

    def forward(
        self,
        atom_feat: torch.Tensor,  # [N, 9] OGB features (consumed as `z`)
        pos: torch.Tensor,  # [N, 3]
        graph_id: torch.Tensor,  # [N] slot row of each atom
        slot_index: torch.Tensor,  # [G, A]
        slot_mask: torch.Tensor,  # [G, A] bool
        atom_slot: torch.Tensor,  # [N]
        slot_gid: torch.Tensor | None = None,  # [G, A] molecule id per slot
    ) -> torch.Tensor:
        g, a = slot_mask.shape
        L = (self.lmax + 1) ** 2 - 1
        sm = slot_mask[..., None].to(pos.dtype)
        flat = slot_index.reshape(-1)
        zf = atom_feat.index_select(0, flat).view(g, a, -1)  # [G, A, 9]
        pd = pos.index_select(0, flat).view(g, a, 3) * sm

        nbr_idx, nbr_mask, r_ij, is_self, d_ij = edge_geometry(
            pd, slot_mask, self.max_num_neighbors + 1, self.cutoff, self.lmax, slot_gid)
        zero = torch.zeros((), dtype=pd.dtype, device=pd.device)
        f_rbf = torch.where(nbr_mask[..., None], self.distance_expansion(r_ij), zero)
        x = self.embedding(zf) * sm  # [G, A, h]

        # NeighborEmbedding (`visnet_layer.py:355-427`): its own AtomEncoder,
        # self edges excluded
        ne_mask = nbr_mask & ~is_self
        w = self.neighbor_distance_proj(f_rbf) * cosine_cutoff(r_ij, self.cutoff)[..., None]
        x_src = self.neighbor_embedding(zf) * sm
        x_nbr = torch.sum(torch.where(ne_mask[..., None], nbr_gather(x_src, nbr_idx, nbr_mask) * w,
                                      zero), dim=2)
        x = self.neighbor_combine(torch.cat([x, x_nbr], dim=-1))

        vec = torch.zeros((g, a, L, x.shape[-1]), dtype=x.dtype, device=x.device)
        # EdgeEmbedding (`visnet_layer.py:430-469`)
        f_ij = (x[:, :, None] + nbr_gather(x, nbr_idx, nbr_mask)) * self.edge_proj(f_rbf)
        if self.compute_dtype is not None:
            x, vec, f_ij, d_ij = (t.to(self.compute_dtype) for t in (x, vec, f_ij, d_ij))

        remat = self.remat_layers
        if remat is None:
            remat = x.device.type != "cuda"
        remat = remat and torch.is_grad_enabled()
        # What a LayerNorm (and the readout's cast) reads in bf16 is the f32
        # sum x + dx (vec + dvec), unrounded, as XLA hands it to a consumer
        # that casts it to f32; the residual stream itself is rounded. In
        # f32 both are the same tensor.
        x_ln = x
        for i in range(self.num_layers):
            layer = getattr(self, f"vis_mp_layers_{i}")
            args = (x_ln, vec, nbr_idx, nbr_mask, r_ij, f_ij, d_ij)
            dx, dvec, df = checkpoint(layer, *args, use_reentrant=False) if remat else layer(*args)
            x_ln = x.float() + dx.float()
            x = x_ln.to(x.dtype)
            if df is None:  # the last layer
                vec = vec.float() + dvec.float()
            else:
                vec = vec + dvec
                f_ij = f_ij + df

        x = self.out_norm(x_ln)
        vec = self.vec_out_norm(vec)
        # EquivariantScalar readout (f32) (`visnet_layer.py:911-949`)
        for i in range(2):
            x, vec = getattr(self, f"output_network_{i}")(x, vec)
        x = (x + torch.sum(vec) * 0.0) * self.std
        return x.reshape(g * a, -1).index_select(0, graph_id * a + atom_slot)
