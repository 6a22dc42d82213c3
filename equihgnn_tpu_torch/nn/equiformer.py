"""Equiformer: SE(3)-equivariant transformer over molecular point clouds.

Port of `equihgnn_tpu/nn/equiformer.py` (the reference's
`equiformer_layer.py:40-1398`) on the dense per-molecule slot view
[G, A, ...]. Features are fibers {degree: [G, A, channels, 2·degree + 1]}.
The depthwise tensor product is JAX's direct form,
    out[dout] = Σ_din R(‖r‖)·Σ_J CG^{(din,J,dout)} (x_din ⊗ Y_J(r̂)),
with the CG constants of `ops/so3.py` and the harmonics of `ops/sh.py`,
and R = W·h + b applied factorized, never materialized per edge:

  * `pool=True` (`tp_in`): the neighbour mean commutes with W, so the
    radial hidden h is contracted against the neighbours first,
    M[g, a, c, f, i] = Σ_k h[k, f]·t[k, i, c], laid out so that the W
    product is one GEMM over (f, i) with the (site, c) rows, and W is
    applied once a site;
  * `pool=False` (the attention's `to_attn_and_v`): W_aug = [W; b] acts on
    the channels at the node sites (u = W_aug·x), the radial hidden is
    scattered densely onto [G, A_j, A_i, f + 1] at each row's neighbours
    (zeros elsewhere), mixed with u by one batched product over f, and the
    result gathered back per edge by index, before CG×SH. JAX's one-hot
    [G, A, k, A] matmuls (a TPU workaround for scatter VJPs) are not
    ported: the scatter and the gather here use PyTorch's own backward.

No TPU kernel computes any of this: JAX runs it as XLA einsums (its
pooled product was measured slower through the pooled-M Pallas kernel on
the TPU, `equihgnn_tpu/nn/equiformer.py:242-249`), and the port as plain
PyTorch products.

The parameters keep JAX's names and layouts (`w{d}` [in, out], `scale{d}`
[dim, 1], `radial_{din}_{dout}_out_W` [f, o, i], `..._out_b` [o, i], the
radial trunk's `lin0`/`ln0`/`lin1`/`ln1`, `attn_head_gates`,
`to_attn_logits_{i}`), so that `convert.params_from_jax` maps them by its
rules. Float32 only: `dtype="bfloat16"` raises (ROADMAP item 11).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from equihgnn_tpu_torch.nn.mlp import TorchLinear, leaky_relu, normal_, uniform_
from equihgnn_tpu_torch.ops.gather import nbr_gather
from equihgnn_tpu_torch.ops.knn import knn_dense
from equihgnn_tpu_torch.ops.numerics import safe_norm
from equihgnn_tpu_torch.ops.sh import cg_const, spherical_harmonics

_cg = cg_const  # real_clebsch_gordan(l1, l2, l3) in float32 (`ops/so3.py`)


def to_order(degree: int) -> int:
    return 2 * degree + 1


def split_num_into_groups(num: int, groups: int) -> tuple:
    """`equiformer_layer.py:84-96`: `num` in `groups` near-equal parts, the
    larger first."""
    per = (num + groups - 1) // groups
    rem = num % groups
    if rem == 0:
        return (per,) * groups
    return (per,) * rem + ((per - 1),) * (groups - rem)


def _mix(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d, m], w [d, e] → [..., e, m]: one product over d."""
    return torch.matmul(x.transpose(-1, -2), w).transpose(-1, -2)


def _zero(t: torch.Tensor) -> torch.Tensor:
    return torch.zeros((), dtype=t.dtype, device=t.device)


class FiberLinear(nn.Module):
    """Per-degree channel mixing (`equiformer_layer.py:168-191`): `w{d}`
    [in, out], normal(1/√in) or zeros (`init_zero`)."""

    def __init__(self, fiber_in, fiber_out, init_zero: bool = False, *,
                 generator: torch.Generator):
        super().__init__()
        self.degrees = min(len(fiber_in), len(fiber_out))
        for d in range(self.degrees):
            w = torch.zeros(fiber_in[d], fiber_out[d])
            if not init_zero:
                normal_(w, 1.0 / math.sqrt(fiber_in[d]), generator)
            setattr(self, f"w{d}", nn.Parameter(w))

    def forward(self, x: dict) -> dict:
        return {d: _mix(x[d], getattr(self, f"w{d}")) for d in range(self.degrees)}


class FiberNorm(nn.Module):
    """RMS norm per degree (`equiformer_layer.py:194-225`): each channel's
    norm over m, their RMS over the channels, clamped at eps; statistics
    in float32; `scale{d}` [dim, 1]."""

    def __init__(self, fiber, eps: float = 1e-12):
        super().__init__()
        self.fiber, self.eps = tuple(fiber), eps
        for d, dim in enumerate(fiber):
            setattr(self, f"scale{d}", nn.Parameter(torch.ones(dim, 1)))

    def forward(self, x: dict) -> dict:
        out = {}
        for d, dim in enumerate(self.fiber):
            t = x[d]
            tf = t.float()
            l2 = safe_norm(tf, dim=-1, keepdim=True)
            rms = safe_norm(l2, dim=-2, keepdim=True) * dim ** -0.5
            out[d] = (tf / torch.clamp(rms, min=self.eps) * getattr(self, f"scale{d}")).to(t.dtype)
        return out


class FiberGate(nn.Module):
    """SiLU on the type-0 channels past the gates, a sigmoid gate from the
    leading type-0 channels on each higher degree (`:228-257`); no
    parameters."""

    def __init__(self, fiber):
        super().__init__()
        self.gate_dims = tuple(fiber[1:])

    def forward(self, x: dict) -> dict:
        t0 = x[0]
        n = sum(self.gate_dims)
        out = {0: F.silu(t0[..., n:, :])}
        start = 0
        for degree, gd in enumerate(self.gate_dims, start=1):
            out[degree] = x[degree] * torch.sigmoid(t0[..., start:start + gd, :])
            start += gd
        return out


class RadialTrunk(nn.Module):
    """Edge distance → radial hidden h (`equiformer_layer.py:451-479` without
    its last projection, which `DTP` applies factorized): [Lin → SiLU → LN]
    × 2, LayerNorms without bias, eps 1e-5."""

    def __init__(self, hidden: int = 64, *, generator: torch.Generator):
        super().__init__()
        self.lin0 = TorchLinear(1, hidden, generator=generator)
        self.ln0 = nn.LayerNorm(hidden, eps=1e-5, bias=False)
        self.lin1 = TorchLinear(hidden, hidden, generator=generator)
        self.ln1 = nn.LayerNorm(hidden, eps=1e-5, bias=False)

    def forward(self, edge_feat: torch.Tensor) -> torch.Tensor:
        h = self.ln0(F.silu(self.lin0(edge_feat)))
        return self.ln1(F.silu(self.lin1(h)))


def _edge_sh(sh: list, din: int, dout: int, nbr_mask: torch.Tensor) -> torch.Tensor:
    """w[g, a, k, b, c] = Σ_J Σ_m CG^{(din,J,dout)}[b, m, c]·Y_J[g, a, k, m],
    0 on masked edges: the CG×SH factor of one (din, dout) pair."""
    w = None
    for J in range(abs(din - dout), din + dout + 1):
        q = torch.tensor(_cg(din, J, dout), dtype=sh[J].dtype, device=sh[J].device)
        term = torch.einsum("bmc,gakm->gakbc", q, sh[J])
        w = term if w is None else w + term
    return torch.where(nbr_mask[..., None, None], w, _zero(w))


class DTP(nn.Module):
    """Depthwise tensor product over the neighbours (`equiformer_layer.py:
    260-448`), `equihgnn_tpu/nn/equiformer.py:167-337` (see the module
    docstring for the two factorized forms). `pool=True` returns the
    neighbour mean {d: [G, A, o, c]}; `pool=False` the per-edge outputs
    {d: [G, A, k, o, c]}, with the self-interaction as neighbour 0 (a
    degree the self branch lacks gets a zero token) when
    `self_interaction`."""

    def __init__(self, fiber_in, fiber_out, self_interaction: bool = True,
                 project_xi_xj: bool = True, project_out: bool = True, pool: bool = True,
                 radial_hidden_dim: int = 64, *, generator: torch.Generator):
        super().__init__()
        self.fiber_in, self.fiber_out = tuple(fiber_in), tuple(fiber_out)
        self.self_interaction, self.project_xi_xj = self_interaction, project_xi_xj
        self.project_out, self.pool, self.f = project_out, pool, radial_hidden_dim
        if project_xi_xj:
            self.to_xi = FiberLinear(fiber_in, fiber_in, generator=generator)
            self.to_xj = FiberLinear(fiber_in, fiber_in, generator=generator)
        f, bound = radial_hidden_dim, 1.0 / math.sqrt(radial_hidden_dim)
        for dout, dim_out in enumerate(self.fiber_out):
            split_out = split_num_into_groups(dim_out, len(self.fiber_in))
            for din, (dim_in, nc_out) in enumerate(zip(self.fiber_in, split_out)):
                name = f"radial_{din}_{dout}"
                self.add_module(name, RadialTrunk(f, generator=generator))
                setattr(self, f"{name}_out_W", nn.Parameter(
                    uniform_(torch.empty(f, nc_out, dim_in), bound, generator)))
                setattr(self, f"{name}_out_b", nn.Parameter(
                    uniform_(torch.empty(nc_out, dim_in), bound, generator)))
        if project_out:
            self.to_out = FiberLinear(fiber_out, fiber_out, generator=generator)
        if self_interaction:
            self.self_interact = FiberLinear(fiber_in, fiber_out, generator=generator)

    def forward(self, inp: dict, nbr_idx, nbr_mask, rel_dist, sh) -> dict:
        if self.project_xi_xj:
            xi, xj = self.to_xi(inp), self.to_xj(inp)
        else:
            xi = xj = inp
        cnt = torch.clamp(torch.sum(nbr_mask.float(), dim=2), min=1.0)[..., None, None]
        outputs = {}
        for dout in range(len(self.fiber_out)):
            chunks = []
            for din in range(len(self.fiber_in)):
                name = f"radial_{din}_{dout}"
                h = getattr(self, name)(rel_dist)
                h = torch.where(nbr_mask[..., None], h, _zero(h))
                W, b = getattr(self, f"{name}_out_W"), getattr(self, f"{name}_out_b")
                wsh = _edge_sh(sh, din, dout, nbr_mask)
                xi_d = xi[din] if self.project_xi_xj else None
                if self.pool:
                    chunks.append(self._pooled(xi_d, xj[din], nbr_idx, nbr_mask, h, W, b, wsh)
                                  / cnt.to(h.dtype))
                else:
                    chunks.append(self._unpooled(xi_d, xj[din], nbr_idx, nbr_mask, h, W, b, wsh))
            outputs[dout] = torch.cat(chunks, dim=-2)

        if self.project_out:
            # linear per degree: it commutes with the masked mean
            outputs = self.to_out(outputs)
        self_out = self.self_interact(inp) if self.self_interaction else None
        if self.pool:
            if self_out is not None:  # only the degrees the self branch has
                outputs = {d: outputs[d] + self_out[d] if d in self_out else outputs[d]
                           for d in outputs}
            return outputs
        if self_out is not None:
            outputs = {d: torch.cat([self_out[d][:, :, None] if d in self_out
                                     else torch.zeros_like(outputs[d][:, :, :1]), outputs[d]],
                                    dim=2)
                       for d in outputs}
        return outputs

    @staticmethod
    def _pooled(xi_d, xj_d, nbr_idx, nbr_mask, h, W, b, wsh):
        """Σ_k (W·h_k + b)·t_k = W·M + b·Σ_k t_k, M = Σ_k h_k ⊗ t_k, with t the
        CG×SH-contracted edge feature (0 on masked edges); [G, A, o, c],
        undivided."""
        g, a, k = nbr_idx.shape
        f, o, i = W.shape
        xg = nbr_gather(xj_d, nbr_idx, nbr_mask)  # [G, A, k, i, b]
        if xi_d is not None:
            xg = xg + xi_d[:, :, None]
        c = wsh.shape[-1]
        # t[g, a, c, k, i] = Σ_b w[g, a, k, b, c]·xg[g, a, k, i, b]
        t = None
        for bb in range(wsh.shape[-2]):
            term = wsh[..., bb, :].permute(0, 1, 3, 2)[..., None] * xg[..., bb][:, :, None]
            t = term if t is None else t + term
        m = torch.matmul(h.transpose(-1, -2)[:, :, None], t)  # [G, A, c, f, i]
        tbar = torch.sum(t, dim=3)  # [G, A, c, i]
        out = (m.reshape(g * a * c, f * i) @ W.permute(0, 2, 1).reshape(f * i, o)
               + tbar.reshape(g * a * c, i) @ b.t())
        return out.view(g, a, c, o).transpose(-1, -2)

    @staticmethod
    def _unpooled(xi_d, xj_d, nbr_idx, nbr_mask, h, W, b, wsh):
        """Per-edge (W·h_e + b)·(x_j + x_i), then CG×SH: [G, A, k, o, c]."""
        g, a, k = nbr_idx.shape
        f, o, i = W.shape
        f1 = f + 1
        h_aug = torch.cat([h, nbr_mask[..., None].to(h.dtype)], dim=-1)  # [G, A, k, f + 1]
        wp = torch.cat([W, b[None]], dim=0).permute(2, 1, 0).reshape(i, o * f1)  # [i, (o, f)]
        dev = nbr_idx.device
        rows = torch.arange(g, device=dev)[:, None, None]
        # (g, j, i) of each edge (i, k) with source j = nbr_idx[g, i, k]; a row's
        # k sources are distinct and h_aug is 0 on masked edges, so every
        # place is written once and the unwritten ones hold 0
        dst = ((rows * a + nbr_idx) * a + torch.arange(a, device=dev)[None, :, None]).reshape(-1)
        hd = h_aug.new_zeros((g * a * a, f1)).index_add(0, dst, h_aug.reshape(-1, f1))
        hd = hd.view(g, a, a, f1)  # [G, A_j, A_i, f + 1]
        out = None
        for bb in range(xj_d.shape[-1]):
            u = (xj_d[..., bb].reshape(g * a, i) @ wp).view(g, a, o, f1)
            vd = torch.matmul(hd, u.transpose(-1, -2))  # [G, A_j, A_i, o]
            v = vd.reshape(g * a * a, o).index_select(0, dst).view(g, a, k, o)
            if xi_d is not None:
                ui = (xi_d[..., bb].reshape(g * a, i) @ wp).view(g, a, o, f1)
                v = v + torch.matmul(h_aug, ui.transpose(-1, -2))
            term = v[..., None] * wsh[..., bb, None, :]  # [G, A, k, o, c]
            out = term if out is None else out + term
        return out


class FeedForward(nn.Module):
    """`equiformer_layer.py:485-529`: prenorm, (optionally the higher
    degrees' channel norms joined to type 0), project_in, gate,
    project_out (zeros at init)."""

    def __init__(self, fiber, mult: int = 4, include_htype_norms: bool = False,
                 init_out_zero: bool = True, *, generator: torch.Generator):
        super().__init__()
        fiber = tuple(fiber)
        fiber_hidden = tuple(d * mult for d in fiber)
        project_in_fiber = fiber
        if include_htype_norms:
            project_in_fiber = (sum(fiber),) + fiber[1:]
        project_in_hidden = (sum(fiber_hidden),) + fiber_hidden[1:]
        self.include_htype_norms, self.degrees = include_htype_norms, len(fiber)
        self.prenorm = FiberNorm(fiber)
        self.project_in = FiberLinear(project_in_fiber, project_in_hidden, generator=generator)
        self.gate = FiberGate(project_in_hidden)
        self.project_out = FiberLinear(fiber_hidden, fiber, init_zero=init_out_zero,
                                       generator=generator)

    def forward(self, x: dict) -> dict:
        out = self.prenorm(x)
        if self.include_htype_norms:
            htypes = [safe_norm(out[d], dim=-1, keepdim=True) for d in range(1, self.degrees)]
            out = {**out, 0: torch.cat([out[0], *htypes], dim=-2)}
        return self.project_out(self.gate(self.project_in(out)))


def _head_gates(linear: TorchLinear, features: dict, heads: tuple) -> list:
    """Per degree, the sigmoid head gates [G, A, h, 1, 1] from the
    prenormed type-0 features."""
    gall = torch.sigmoid(linear(features[0][..., 0]))
    gates, start = [], 0
    for h in heads:
        gates.append(gall[..., start:start + h, None, None])
        start += h
    return gates


def _attend(attn: torch.Tensor, v: torch.Tensor, h: int, dh: int, gate) -> torch.Tensor:
    """attn [G, A, K, h], v [G, A, K, h·dh, m] → [G, A, h·dh, m]."""
    g, a, kk, _, m = v.shape
    out = torch.einsum("gakh,gakhdm->gahdm", attn, v.reshape(g, a, kk, h, dh, m))
    if gate is not None:
        out = out * gate
    return out.reshape(g, a, h * dh, m)


class MLPAttention(nn.Module):
    """`equiformer_layer.py:743-955` (the model's `l2_dist_attention=False`):
    one unpooled DTP gives the logits branches, the values and their gates;
    logits from a LeakyReLU MLP, masked with −1e9 and softmaxed over the k
    (+ 1, self first) neighbours; per-head sigmoid gates; `to_out` zeros
    at init."""

    def __init__(self, fiber, dim_head: int = 64, heads: int = 8, attend_self: bool = True,
                 attn_leakyrelu_slope: float = 0.1, attn_hidden_dim_mult: int = 4,
                 radial_hidden_dim: int = 64, init_out_zero: bool = True,
                 gate_attn_head_outputs: bool = True, *, generator: torch.Generator):
        super().__init__()
        fiber = tuple(fiber)
        nd = len(fiber)
        self.heads, self.dim_head = (heads,) * nd, (dim_head,) * nd
        hidden_fiber = tuple(d * h for d, h in zip(self.dim_head, self.heads))
        type0_dim, htype_dims = hidden_fiber[0], sum(hidden_fiber[1:])
        value_gate_fiber = (type0_dim + htype_dims,) + hidden_fiber[1:]
        self.attn_hidden_dims = tuple(h * attn_hidden_dim_mult for h in self.heads)
        intermediate_fiber = ((sum(self.attn_hidden_dims) + type0_dim + htype_dims,)
                              + hidden_fiber[1:])
        self.attend_self, self.slope = attend_self, attn_leakyrelu_slope
        self.prenorm = FiberNorm(fiber)
        self.to_attn_and_v = DTP(fiber, intermediate_fiber, pool=False,
                                 self_interaction=attend_self,
                                 radial_hidden_dim=radial_hidden_dim, generator=generator)
        self.attn_head_gates = (TorchLinear(fiber[0], sum(self.heads), generator=generator)
                                if gate_attn_head_outputs else None)
        for i, (ahd, h) in enumerate(zip(self.attn_hidden_dims, self.heads)):
            self.add_module(f"to_attn_logits_{i}",
                            TorchLinear(ahd, h, bias=False, generator=generator))
        self.values_gate = FiberGate(value_gate_fiber)
        self.values_lin = FiberLinear(hidden_fiber, hidden_fiber, generator=generator)
        self.to_out = FiberLinear(hidden_fiber, fiber, init_zero=init_out_zero,
                                  generator=generator)

    def forward(self, features: dict, nbr_idx, nbr_mask, rel_dist, sh) -> dict:
        features = self.prenorm(features)
        inter = self.to_attn_and_v(features, nbr_idx, nbr_mask, rel_dist, sh)
        if self.attend_self:
            nbr_mask = F.pad(nbr_mask, (1, 0), value=True)
        t0 = inter[0]  # [G, A, K, dim, 1]
        branches, start = [], 0
        for ahd in self.attn_hidden_dims:
            branches.append(t0[..., start:start + ahd, 0])
            start += ahd
        inter = {**inter, 0: t0[..., start:, :]}
        gates = ([None] * len(self.heads) if self.attn_head_gates is None
                 else _head_gates(self.attn_head_gates, features, self.heads))
        attentions = []
        for i, (branch, dh) in enumerate(zip(branches, self.dim_head)):
            z = leaky_relu(branch, self.slope)
            logits = getattr(self, f"to_attn_logits_{i}")(z) * dh ** -0.5  # [G, A, K, h]
            logits = torch.where(nbr_mask[..., None], logits, torch.full((), -1e9,
                                                                         device=logits.device))
            attentions.append(torch.softmax(logits, dim=-2))
        values = self.values_lin(self.values_gate(inter))
        outputs = {d: _attend(attn, values[d], h, dh, gate) for d, (attn, h, dh, gate)
                   in enumerate(zip(attentions, self.heads, self.dim_head, gates))}
        return self.to_out(outputs)


class L2DistAttention(nn.Module):
    """Negative-L2 attention (`equiformer_layer.py:574-740`), which no
    registered model uses. As in JAX, every degree's logits are masked (the
    reference leaves degree 0's unmasked, `:713-718`): padded neighbours
    never attend."""

    def __init__(self, fiber, dim_head: int = 64, heads: int = 8, attend_self: bool = True,
                 radial_hidden_dim: int = 64, init_out_zero: bool = True,
                 gate_attn_head_outputs: bool = True, *, generator: torch.Generator):
        super().__init__()
        fiber = tuple(fiber)
        nd = len(fiber)
        self.heads, self.dim_head = (heads,) * nd, (dim_head,) * nd
        hidden_fiber = tuple(d * h for d, h in zip(self.dim_head, self.heads))
        kv_fiber = tuple(2 * d for d in hidden_fiber)
        self.attend_self = attend_self
        self.prenorm = FiberNorm(fiber)
        self.to_q = FiberLinear(fiber, hidden_fiber, generator=generator)
        self.to_kv = DTP(fiber, kv_fiber, pool=False, self_interaction=attend_self,
                         radial_hidden_dim=radial_hidden_dim, generator=generator)
        self.attn_head_gates = (TorchLinear(fiber[0], sum(self.heads), generator=generator)
                                if gate_attn_head_outputs else None)
        self.to_out = FiberLinear(hidden_fiber, fiber, init_zero=init_out_zero,
                                  generator=generator)

    def forward(self, features: dict, nbr_idx, nbr_mask, rel_dist, sh) -> dict:
        features = self.prenorm(features)
        queries = self.to_q(features)
        keyvalues = self.to_kv(features, nbr_idx, nbr_mask, rel_dist, sh)
        if self.attend_self:
            nbr_mask = F.pad(nbr_mask, (1, 0), value=True)
        gates = ([None] * len(self.heads) if self.attn_head_gates is None
                 else _head_gates(self.attn_head_gates, features, self.heads))
        outputs = {}
        for degree, (h, dh, gate) in enumerate(zip(self.heads, self.dim_head, gates)):
            q, kv = queries[degree], keyvalues[degree]
            g, a, _, m = q.shape
            kk = kv.shape[2]
            kv = kv.reshape(g, a, kk, h, 2 * dh, m)
            keys, v = kv[..., :dh, :], kv[..., dh:, :]
            d2 = q.reshape(g, a, 1, h, dh, m) - keys  # [G, A, K, h, dh, m]
            if degree == 0:  # one L2 over the channels (`:709-716`)
                sim = -torch.sqrt(torch.sum(d2 * d2, dim=(-2, -1)) + 1e-12) * dh ** -0.5
            else:  # an L2 over m per channel, summed over the channels
                dist = torch.sqrt(torch.sum(d2 * d2, dim=-1) + 1e-12)
                sim = -torch.sum(dist, dim=-1) * dh ** -0.5
            sim = torch.where(nbr_mask[..., None], sim, torch.full((), -1e9, device=sim.device))
            attn = torch.softmax(sim, dim=2)
            outputs[degree] = _attend(attn, v.reshape(g, a, kk, h * dh, m), h, dh, gate)
        return self.to_out(outputs)


class Equiformer(nn.Module):
    """The trunk (`equiformer_layer.py:960-1398`), dense layout: `tp_in`,
    `depth` × (attention + feed-forward) residual blocks, the final
    `FiberNorm`; returns the flat type-0 [N, dim0] and type-1 [N, dim1, 3]
    features of the atoms. The k = min(num_neighbors, A − 1) nearest
    other slots of a row within `valid_radius` are its neighbours."""

    def __init__(self, dim=(64, 64), dim_in=(64,), heads: int = 1, dim_head: int = 24,
                 depth: int = 2, valid_radius: float = 1e5, num_neighbors: int = 16,
                 radial_hidden_dim: int = 64, attend_self: bool = True,
                 embedding_grad_frac: float = 0.5, ff_include_htype_norms: bool = False,
                 gate_attn_head_outputs: bool = True, l2_dist_attention: bool = False,
                 dtype: str | None = None, *, generator: torch.Generator):
        super().__init__()
        if dtype not in (None, "float32"):
            raise NotImplementedError(
                f"Equiformer in {dtype}: the port runs it in float32 only, ROADMAP item 11")
        dim, dim_in = tuple(dim), tuple(dim_in)
        self.num_degrees, self.depth = len(dim), depth
        self.valid_radius, self.num_neighbors = valid_radius, num_neighbors
        self.embedding_grad_frac = embedding_grad_frac
        self.tp_in = DTP(dim_in, dim, radial_hidden_dim=radial_hidden_dim, generator=generator)
        attn_cls = L2DistAttention if l2_dist_attention else MLPAttention
        for i in range(depth):
            self.add_module(f"attn_{i}", attn_cls(
                dim, dim_head=dim_head, heads=heads, attend_self=attend_self,
                radial_hidden_dim=radial_hidden_dim,
                gate_attn_head_outputs=gate_attn_head_outputs, generator=generator))
            self.add_module(f"ff_{i}", FeedForward(
                dim, include_htype_norms=ff_include_htype_norms, generator=generator))
        self.norm = FiberNorm(dim)

    def forward(
        self,
        feats: torch.Tensor,  # [N, dim_in[0]] type-0
        coords: torch.Tensor,  # [N, 3]
        graph_id: torch.Tensor,  # [N] slot row of each atom
        slot_index: torch.Tensor,  # [G, A]
        slot_mask: torch.Tensor,  # [G, A] bool
        atom_slot: torch.Tensor,  # [N]
        slot_gid: torch.Tensor | None = None,  # [G, A] molecule id per slot
    ):
        g, a = slot_mask.shape
        frac = self.embedding_grad_frac
        feats = frac * feats + (1 - frac) * feats.detach()
        sm = slot_mask[..., None].to(feats.dtype)
        flat = slot_index.reshape(-1)
        fd = feats.index_select(0, flat).view(g, a, -1) * sm
        pd = coords.index_select(0, flat).view(g, a, 3) * sm
        k = min(self.num_neighbors, a - 1)
        nbr_idx, nbr_mask, sqd = knn_dense(pd, slot_mask, k, valid_radius=self.valid_radius,
                                           squared_radius=False, exclude_self=True,
                                           slot_gid=slot_gid)
        rel_pos = pd[:, :, None, :] - nbr_gather(pd, nbr_idx, torch.ones_like(nbr_mask))
        rel_dist = torch.where(nbr_mask, torch.sqrt(torch.clamp(sqd, min=0.0)),
                               _zero(sqd))[..., None]
        sh = spherical_harmonics(2 * (self.num_degrees - 1), rel_pos)
        args = (nbr_idx, nbr_mask, rel_dist, sh)

        x = self.tp_in({0: fd[..., None]}, *args)
        for i in range(self.depth):
            out = getattr(self, f"attn_{i}")(x, *args)
            x = {d: x[d] + out[d] for d in x}
            out = getattr(self, f"ff_{i}")(x)
            x = {d: x[d] + out[d] for d in x}
        x = self.norm(x)

        rows = graph_id * a + atom_slot
        type0 = x[0][..., 0].reshape(g * a, -1).index_select(0, rows)
        type1 = None
        if 1 in x:
            type1 = x[1].reshape(g * a, -1, 3).index_select(0, rows)
        return type0, type1
