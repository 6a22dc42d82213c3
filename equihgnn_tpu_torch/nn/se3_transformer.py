"""SE(3)-Transformer: TFN-convolution attention over molecular point clouds.

Port of `equihgnn_tpu/nn/se3_transformer.py` (the reference's
`se3_transformer_layer.py:42-1693`) on the dense per-molecule slot view
[G, A, ...]. Features are fibers {degree: [G, A, channels, 2·degree + 1]}.
The TFN kernel is the direct contraction
    K(r)[o·mo, i·mi] = Σ_J R_J(‖r‖)[o, i] · Σ_mJ CG^{(din,J,dout)}[mi, mJ, mo] Y_J(r̂)[mJ]
with the CG constants of `ops/so3.py` and the harmonics of `ops/sh.py`;
R_J = W_J·h + b_J with h the radial hidden, never materialized per edge.

  * The pooled units (conv_in, conv_out: the neighbour mean) contract h
    against the neighbours first and apply W_J once per node. In float32
    that is `ops/kernels/pooled_conv.py`, kernels J and K on the card, the
    plain version on the CPU; the bias term and Σ_k stay plain, as in JAX.
    In bfloat16 the route is JAX's, chosen at each call by its gate
    `pooled_conv_supported` from the shapes (A, k, C, I, F, O): where it
    holds (hidden 128 and 256 at the batches' A), the fused unit, kernels
    J and K in bfloat16 (M rounded to bfloat16 inside them); where it
    fails (hidden 384 and 512, a narrow width, a wide A), JAX's per-J
    path: in one checkpointed step per J, the pooled-M build M = Σ_k h_k ⊗
    t_k (`ops/kernels/pooled_m.py`, kernels L and M on the card), rounded
    to bfloat16, then the projection by W_J as one plain product. The two
    round otherwise (the fused unit adds each J's projection and its bias
    term to the sum in turn), so the port takes JAX's branch at every
    shape.
  * The unpooled units (the attention keys and values, one `stack=2`
    conv) apply W_J at the node sites, place the radial hidden densely on
    [A, A] by a scatter on the neighbour index and mix the two by a batched
    product, then gather by index and contract CG×SH. No TPU kernel
    computes them. The (stack, input-m) steps that JAX wraps in
    `jax.checkpoint` are `torch.utils.checkpoint`s here, on every device:
    they bound the backward's memory and change no number.

`dtype="bfloat16"` is JAX's `SE3Transformer.dtype`: the features, the
distances and the harmonics are cast at entry and every module computes
in their type, with the casts where JAX has them (parameters cast to the
input's type; LayerNorm statistics, NormSE3's norms and the attention's
softmax in float32); the type-0 output is cast back to float32. Each
operation rounds to bfloat16 as XLA's CPU backend does: op by op (so GELU
in bfloat16 is spelt out as `jax.nn.gelu` composes it), except that the
last operation before a cast to float32 or a sum is taken in float32
(XLA's excess precision). The port copies that where JAX has such a cast:
the radial trunk's bias adds, the attention's scaled logits, Σ_k t of the
pooled units, and across modules the values that NormSE3 and the type-0
output cast (the residual stream, the FFN's inner product and the
convolutions' outputs are carried in float32 for them, `exact`).

Every neighbour gather is an index gather (`index_select`), never a
one-hot matmul (a TPU workaround) nor `x[idx]` (whose backward is slow on
the card, `ops/gather.py`). flax's `nn.gelu` is the tanh approximation, and
so is every GELU here. The parameters keep JAX's names and layouts
(`w{d}` [in, out], `scale{d}`, `radial_trunks/lin0_w` [n, f], …,
`pair_{din}_{dout}/radial{_s}_out_W` [f, o, i, J]), so that
`convert.params_from_jax` maps them untransposed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from equihgnn_tpu_torch.nn.mlp import normal_, uniform_
from equihgnn_tpu_torch.ops.gather import index_select, nbr_gather
from equihgnn_tpu_torch.ops.kernels.pooled_conv import (
    live_sites,
    pooled_conv,
    pooled_conv_supported,
)
from equihgnn_tpu_torch.ops.kernels.pooled_m import pooled_m
from equihgnn_tpu_torch.ops.knn import knn_dense
from equihgnn_tpu_torch.ops.numerics import safe_norm
from equihgnn_tpu_torch.ops.sh import cg_const, spherical_harmonics


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """flax's `nn.gelu`, the tanh approximation. Below float32 it is JAX's
    composition (`jax.nn.gelu`), each operation rounded to x's type, with
    the constants in that type."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    const = lambda v: torch.tensor(v, dtype=x.dtype, device=x.device)  # noqa: E731
    inner = const(math.sqrt(2 / math.pi)) * (x + const(0.044715) * (x * x * x))
    return x * (const(0.5) * (1.0 + torch.tanh(inner)))


def _rounded(v: float, dtype: torch.dtype) -> float:
    """The Python scalar v as a tensor of `dtype` holds it: JAX casts a weak
    scalar to the array's type before it multiplies."""
    return torch.tensor(v, dtype=dtype).item()


def _js(din: int, dout: int) -> list[int]:
    return list(range(abs(din - dout), din + dout + 1))


def _sum_parts(parts: list, dtype: torch.dtype, exact: bool) -> torch.Tensor:
    """Σ parts, left to right, each rounded to `dtype` and every addition in
    `dtype`; with `exact`, the last addition is kept in float32, unrounded:
    what XLA passes to a consumer that casts it to float32 (a sole part, which
    reaches the cast through a slice in JAX, is rounded)."""
    acc = parts[0].to(dtype)
    for p in parts[1:-1]:
        acc = acc + p.to(dtype)
    if len(parts) > 1:
        last = parts[-1].to(dtype)
        acc = acc.float() + last.float() if exact else acc + last
    return acc


class LinearSE3(nn.Module):
    """Per-degree channel mixing (`se3_transformer_layer.py:104-119`)."""

    def __init__(self, fiber_in, fiber_out, *, generator: torch.Generator):
        super().__init__()
        self.degrees = min(len(fiber_in), len(fiber_out))
        for d in range(self.degrees):
            w = normal_(torch.empty(fiber_in[d], fiber_out[d]), 1.0 / math.sqrt(fiber_in[d]),
                        generator)
            setattr(self, f"w{d}", nn.Parameter(w))

    def forward(self, x: dict, exact: bool = False) -> dict:
        """In x's type; with `exact`, the product of x and the rounded weight
        in float32, unrounded (for a consumer that casts it to float32)."""
        out = {}
        for d in range(self.degrees):
            xd, w = x[d], getattr(self, f"w{d}").to(x[d].dtype)
            out[d] = torch.einsum("...dm,de->...em", *((xd.float(), w.float()) if exact else (xd, w)))
        return out


class NormSE3(nn.Module):
    """Norm-gated nonlinearity (`se3_transformer_layer.py:122-184`)."""

    def __init__(self, fiber, eps: float = 1e-12):
        super().__init__()
        self.eps = eps
        for d, chan in enumerate(fiber):
            setattr(self, f"scale{d}", nn.Parameter(torch.ones(chan)))
        self.degrees = len(fiber)

    def forward(self, x: dict, dtype: torch.dtype | None = None) -> dict:
        """In `dtype` (default: x's type). The norms are taken in float32 of x
        as given, so a float32 x may hold the unrounded last operation that
        produced it, as XLA passes it to the cast; the phase takes x rounded."""
        out = {}
        for d in range(self.degrees):
            dt = dtype or x[d].dtype
            norm = torch.clamp(safe_norm(x[d].float(), dim=-1, keepdim=True), min=self.eps)
            gate = _gelu(norm[..., 0] * getattr(self, f"scale{d}"))  # float32
            out[d] = gate.to(dt)[..., None] * (x[d].to(dt) / norm.to(dt))
        return out


class StackedRadialTrunk(nn.Module):
    """`n` independent radial hiddens [Lin(1→f) → LN → GELU → Lin(f→f) → LN
    → GELU] of the same distances, batched over the unit axis as in JAX;
    each LayerNorm is per unit, eps 1e-5."""

    def __init__(self, n: int, mid_dim: int = 128, *, generator: torch.Generator):
        super().__init__()
        f = mid_dim
        self.n, self.mid_dim = n, f
        self.lin0_w = nn.Parameter(uniform_(torch.empty(n, f), 1.0, generator))
        self.lin0_b = nn.Parameter(uniform_(torch.empty(n, f), 1.0, generator))
        self.lin1_w = nn.Parameter(uniform_(torch.empty(n, f, f), 1.0 / math.sqrt(f), generator))
        self.lin1_b = nn.Parameter(uniform_(torch.empty(n, f), 1.0 / math.sqrt(f), generator))
        for name in ("ln0", "ln1"):
            setattr(self, f"{name}_scale", nn.Parameter(torch.ones(n, f)))
            setattr(self, f"{name}_bias", nn.Parameter(torch.zeros(n, f)))

    def _ln(self, h32: torch.Tensor, name: str, dtype: torch.dtype) -> torch.Tensor:
        """Statistics, normalization and affine of the float32 h32, cast to
        `dtype`."""
        mu = torch.mean(h32, dim=-1, keepdim=True)
        var = torch.mean(torch.square(h32 - mu), dim=-1, keepdim=True)
        out = (h32 - mu) * torch.rsqrt(var + 1e-5)
        return (out * getattr(self, f"{name}_scale")[:, None, None, :]
                + getattr(self, f"{name}_bias")[:, None, None, :]).to(dtype)

    def forward(self, rel_dist: torch.Tensor) -> torch.Tensor:
        """[G, A, k, 1] → [n, G, A, k, f], in rel_dist's type. Each bias add
        feeds the LayerNorm's cast to float32 and is taken in float32: XLA
        drops the rounding of the last operation before such a cast."""
        g, a, k = rel_dist.shape[:3]
        dt = rel_dist.dtype
        rd = rel_dist.reshape(g, a * k, 1)
        h = (rd * self.lin0_w[:, None, None, :].to(dt)).float() + self.lin0_b[:, None, None, :].to(dt)
        h = _gelu(self._ln(h, "ln0", dt))
        h = (torch.einsum("ngqf,nfe->ngqe", h, self.lin1_w.to(dt)).float()
             + self.lin1_b[:, None, None, :].to(dt))
        h = _gelu(self._ln(h, "ln1", dt))
        return h.reshape(self.n, g, a, k, self.mid_dim)


class _ConvSE3Pair(nn.Module):
    """One (degree_in → degree_out) TFN unit (`se3_transformer.py:179-361`);
    the radial hidden h [S, G, A, k, f] and the CG-weighted SH w_sh
    [G, A, k, J, b, c] arrive precomputed from the conv."""

    def __init__(self, din: int, dout: int, nc_in: int, nc_out: int, pool: bool,
                 stack: int = 1, radial_mid_dim: int = 128, *, generator: torch.Generator):
        super().__init__()
        self.din, self.dout, self.nc_in, self.nc_out = din, dout, nc_in, nc_out
        self.pool, self.stack, self.f = pool, stack, radial_mid_dim
        nj = len(_js(din, dout))
        bound = 1.0 / math.sqrt(radial_mid_dim)
        for si in range(stack):
            sfx = f"_{si}" if stack > 1 else ""
            setattr(self, f"radial{sfx}_out_W", nn.Parameter(
                uniform_(torch.empty(radial_mid_dim, nc_out, nc_in, nj), bound, generator)))
            setattr(self, f"radial{sfx}_out_b", nn.Parameter(
                uniform_(torch.empty(nc_out, nc_in, nj), bound, generator)))

    def _params(self, dtype):
        sfx = [f"_{si}" if self.stack > 1 else "" for si in range(self.stack)]
        W = torch.stack([getattr(self, f"radial{x}_out_W") for x in sfx])  # [S, f, o, i, J]
        b = torch.stack([getattr(self, f"radial{x}_out_b") for x in sfx])  # [S, o, i, J]
        return W.to(dtype), b.to(dtype)

    def forward(self, xn, nbr_idx, nbr_mask, w_sh, h):
        W, bias = self._params(xn.dtype)
        if self.pool:
            return self._pooled(xn, nbr_idx, nbr_mask, w_sh, h, W, bias)
        return self._unpooled(xn, nbr_idx, nbr_mask, w_sh, h, W, bias)

    def _pooled(self, xn, nbr_idx, nbr_mask, w_sh, h, W, bias):
        """mean_k[(W·h_k + b)·t_k] = (W·Σ_k h_k⊗t_k + b·Σ_k t_k) / cnt, with t
        the CG×SH-contracted neighbour feature (`se3_transformer.py:240-258`).
        xg is zero on masked neighbours, so are t and Σ_k t; a site with no
        neighbour has t = 0 and is passed to J as not live (its output is 0
        either way), so that J skips its work. Below float32 the route is
        JAX's, chosen at each call from the shapes by its gate
        (`pooled_conv_supported`, `se3_transformer.py:232-234`): the fused
        unit where it holds, else the per-J path."""
        g, a, k = nbr_idx.shape
        c_out = 2 * self.dout + 1
        dt = xn.dtype
        xg = nbr_gather(xn, nbr_idx, nbr_mask)  # [G, A, k, i, b]
        cnt = torch.clamp(torch.sum(nbr_mask.float(), dim=2), min=1.0)[..., None, None]
        if dt != torch.float32 and not (self.stack == 1 and pooled_conv_supported(
                a, k, c_out, self.nc_in, self.f, self.nc_out, dt.itemsize)):
            return self._pooled_per_j(xg, w_sh, h, W, bias) / cnt[None].to(dt)
        live = live_sites(nbr_mask.any(-1))  # [G, A] and J's list of them, once per conv
        outs = []
        for si in range(self.stack):
            acc = 0.0
            for jidx in range(W.shape[-1]):
                # t rounded for J and K; Σ_k t of the unrounded products, as
                # XLA reduces them (the per-J path's `tc32`); the bias term a
                # float32 sum rounded once (in float32 every cast is a no-op)
                tc32 = torch.einsum("gakbc,gakib->gakci", w_sh[..., jidx, :, :].float(),
                                    xg.float())
                tcj, tsum = tc32.to(dt), torch.sum(tc32, dim=2).to(dt)  # tsum [G, A, c, i]
                bias_term = torch.einsum("oi,gaci->gaco", bias[si, ..., jidx].float(),
                                         tsum.float()).to(dt)
                acc = acc + pooled_conv(h[si], tcj.reshape(g, a, k, c_out * self.nc_in)
                                        .contiguous(), W[si, ..., jidx], c_out, live)
                acc = acc + bias_term
            outs.append(torch.transpose(acc, -1, -2))  # [G, A, o, c]
        return torch.stack(outs) / cnt[None].to(dt)  # [S, G, A, o, c]

    def _pooled_per_j(self, xg, w_sh, h, W, bias):
        """JAX's per-J path below float32 (`se3_transformer.py:260-306`): per
        J one checkpointed step that builds M [G, A, c·i, f] by `pooled_m`
        (kernel L; rounded to the input's type), projects it by W_J and adds
        the bias term; the sum over J, undivided, [S, G, A, o, c]."""
        g, a, k = xg.shape[:3]
        f, i = h.shape[-1], self.nc_in

        def one_j(wj, bj, wshj, hs, xg):
            # XLA sums the unrounded products into Σ_k t (a reduction takes
            # its input's last operation in float32) and rounds t for M
            tc32 = torch.einsum("gakbc,gakib->gakci", wshj.float(), xg.float())
            tc, tsum = tc32.to(xg.dtype), torch.sum(tc32, dim=2).to(xg.dtype)  # [G, A, c, i]
            c = tc.shape[-2]
            m2 = pooled_m(hs, tc.reshape(g, a, k, c * i).contiguous()).view(g, a, c, i, f)
            return (torch.einsum("foi,gacif->gaoc", wj, m2)
                    + torch.einsum("oi,gaci->gaoc", bj, tsum))

        outs = []
        for si in range(self.stack):
            res = None
            for jidx in range(W.shape[-1]):
                term = checkpoint(one_j, W[si, ..., jidx], bias[si, ..., jidx],
                                  w_sh[..., jidx, :, :], h[si], xg, use_reentrant=False)
                res = term if res is None else res + term
            outs.append(res)
        return torch.stack(outs)

    def _unpooled(self, xn, nbr_idx, nbr_mask, w_sh, h, W, bias):
        """Per-edge outputs v_e = (W·h_e + b)·x_j, then CG×SH per output column
        (`se3_transformer.py:308-361`)."""
        s, f, i = self.stack, self.f, self.nc_in
        g, a, k = nbr_idx.shape
        nj = W.shape[-1]
        p = nj * self.nc_out  # the (J, o) columns, J outer
        b_in = 2 * self.din + 1
        rows = torch.arange(g, device=nbr_idx.device)[:, None, None]
        src = (rows * a + nbr_idx).reshape(-1)  # (g, j) of each edge
        dst = ((rows * a + nbr_idx) * a
               + torch.arange(a, device=nbr_idx.device)[None, :, None]).reshape(-1)  # (g, j, i)
        # hd[s, g, j, i, f]: the radial hidden of edge (i, k) at its source
        # j = nbr_idx[g, i, k] (JAX's hd with i and j swapped, the layout the
        # product below takes without a copy); h is zero on masked edges, and
        # a row's k sources are distinct, so every place is written once
        hd = h.new_zeros((s, g * a * a, f)).index_add(1, dst, h.reshape(s, g * a * k, f))
        hd = hd.view(s, g, a, a, f)
        # W [S, f, o, i, J] → [S, i, J·o·f]; bias [S, o, i, J] → [S, i, J·o]
        Wp = W.permute(0, 3, 4, 2, 1).reshape(s, i, p * f)
        bp = bias.permute(0, 2, 3, 1).reshape(s, i, p)

        def one_b(Wp, bp, hds, xnb, wshb):
            # Wp [S', i, p·f]; bp [S', i, p]; hds [S', G, A, A, f]; xnb [G, A, i];
            # wshb [G, A, k, J, c]. Node side: u = W·x [S', G·A, p·f]; then per
            # source j, v[j, i, p] = Σ_f hd[j, i, f] · u[j, p, f]; gathered per edge
            sp = Wp.shape[0]
            x2 = xnb.reshape(1, g * a, i)
            u = torch.matmul(x2, Wp).view(sp, g, a, p, f)
            v = torch.matmul(hds, u.transpose(-1, -2))  # [S', G, A(j), A(i), p]
            vk = v.reshape(sp, g * a * a, p).index_select(1, dst)
            ubk = index_select(torch.matmul(x2, bp), 1, src)
            ek = (vk + ubk).view(sp, g, a, k, nj, self.nc_out)
            return torch.einsum("sgakJo,gakJc->sgakoc", ek, wshb)

        def ckpt_b(*args):
            return checkpoint(one_b, *args, use_reentrant=False)

        if s * nj <= 2 and b_in == 1:
            res = one_b(Wp, bp, hd, xn[..., 0], w_sh[..., 0, :])
        elif s * nj <= 2:
            res = sum(ckpt_b(Wp, bp, hd, xn[..., bi], w_sh[..., bi, :]) for bi in range(b_in))
        else:
            res = torch.cat([
                sum(ckpt_b(Wp[si:si + 1], bp[si:si + 1], hd[si:si + 1], xn[..., bi],
                           w_sh[..., bi, :]) for bi in range(b_in))
                for si in range(s)])
        inc = nbr_mask[None, ..., None, None]
        return torch.where(inc, res, torch.zeros((), dtype=res.dtype, device=res.device))


class ConvSE3(nn.Module):
    """TFN convolution (`se3_transformer_layer.py:187-308`): every (din,
    dout) pair a `_ConvSE3Pair`, all radial functions in one batched
    `StackedRadialTrunk`; `stack=s` computes s independently parametrized
    convs (the attention's keys and values) and returns a list."""

    def __init__(self, fiber_in, fiber_out, self_interaction: bool = True, pool: bool = True,
                 radial_mid_dim: int = 128, stack: int = 1, *, generator: torch.Generator):
        super().__init__()
        self.fiber_in, self.fiber_out = tuple(fiber_in), tuple(fiber_out)
        self.pool, self.stack = pool, stack
        self.self_interaction = pool and self_interaction
        self.pairs = [(din, dout) for dout in range(len(fiber_out)) for din in range(len(fiber_in))]
        self.radial_trunks = StackedRadialTrunk(len(self.pairs) * stack, radial_mid_dim,
                                                generator=generator)
        for din, dout in self.pairs:
            self.add_module(f"pair_{din}_{dout}", _ConvSE3Pair(
                din, dout, fiber_in[din], fiber_out[dout], pool, stack, radial_mid_dim,
                generator=generator))
        if self.self_interaction:
            for si in range(stack):
                self.add_module(f"self_interact{f'_{si}' if stack > 1 else ''}",
                                LinearSE3(fiber_in, fiber_out, generator=generator))

    def forward(self, inp: dict, nbr_idx, nbr_mask, rel_dist, wsh_map, exact: bool = False):
        """In the inputs' type; with `exact`, each output's last operation in
        float32, unrounded (`_sum_parts`)."""
        s, dt = self.stack, inp[0].dtype
        h_all = self.radial_trunks(rel_dist)
        h_all = torch.where(nbr_mask[None, ..., None], h_all,
                            torch.zeros((), dtype=h_all.dtype, device=h_all.device))
        h_all = h_all.reshape((len(self.pairs), s) + h_all.shape[1:])
        terms = {dout: [getattr(self, f"pair_{din}_{dout}")(
                    inp[din], nbr_idx, nbr_mask, wsh_map[(din, dout)],
                    h_all[self.pairs.index((din, dout))]) for din in range(len(self.fiber_in))]
                 for dout in range(len(self.fiber_out))}
        outputs = []
        for si in range(s):
            siw = (getattr(self, f"self_interact{f'_{si}' if s > 1 else ''}")(inp)
                   if self.self_interaction else {})
            outputs.append({dout: _sum_parts([t[si] for t in parts] + ([siw[dout]] if dout in siw
                                                                       else []), dt, exact)
                            for dout, parts in terms.items()})
        return outputs[0] if s == 1 else outputs


class FeedForwardSE3(nn.Module):
    """`se3_transformer_layer.py:380-394`."""

    def __init__(self, fiber, mult: int = 4, *, generator: torch.Generator):
        super().__init__()
        hidden = tuple(d * mult for d in fiber)
        self.project_in = LinearSE3(fiber, hidden, generator=generator)
        self.nonlin = NormSE3(hidden)
        self.project_out = LinearSE3(hidden, fiber, generator=generator)

    def forward(self, x: dict) -> dict:
        dt = x[0].dtype  # the nonlinearity casts project_in's product to float32
        return self.project_out(self.nonlin(self.project_in(x, exact=True), dt))


class AttentionSE3(nn.Module):
    """`se3_transformer_layer.py:415-608`: LinearSE3 queries, ConvSE3 keys and
    values (one stack=2 conv), self keys and values joined on the neighbour
    axis, logits masked with −1e9 before the softmax, which is float32."""

    def __init__(self, fiber, dim_head: int = 24, heads: int = 8, attend_self: bool = True, *,
                 generator: torch.Generator):
        super().__init__()
        self.heads, self.dim_head, self.attend_self = heads, dim_head, attend_self
        hidden_fiber = (dim_head * heads,) * len(fiber)
        self.to_q = LinearSE3(fiber, hidden_fiber, generator=generator)
        self.to_kv = ConvSE3(fiber, hidden_fiber, pool=False, self_interaction=False, stack=2,
                             generator=generator)
        if attend_self:
            self.to_self_k = LinearSE3(fiber, hidden_fiber, generator=generator)
            self.to_self_v = LinearSE3(fiber, hidden_fiber, generator=generator)
        self.to_out = LinearSE3(hidden_fiber, fiber, generator=generator)

    def forward(self, features: dict, nbr_idx, nbr_mask, rel_dist, wsh_map) -> dict:
        nh, dh = self.heads, self.dim_head
        queries = self.to_q(features)
        keys, values = self.to_kv(features, nbr_idx, nbr_mask, rel_dist, wsh_map)
        if self.attend_self:
            self_k, self_v = self.to_self_k(features), self.to_self_v(features)
            keys = {d: torch.cat([self_k[d][:, :, None], keys[d]], dim=2) for d in keys}
            values = {d: torch.cat([self_v[d][:, :, None], values[d]], dim=2) for d in values}
            nbr_mask = F.pad(nbr_mask, (1, 0), value=True)
        outputs = {}
        for d in features:
            q = queries[d]  # [G, A, h·dh, m]
            g, a, _, m = q.shape
            kk, vv = keys[d], values[d]  # [G, A, K, h·dh, m]
            kn = kk.shape[2]
            q = q.reshape(g, a, nh, dh, m)
            kk = kk.reshape(g, a, kn, nh, dh, m)
            vv = vv.reshape(g, a, kn, nh, dh, m)
            # the scale in q's type, the product in float32 (it feeds the cast)
            sim = torch.einsum("gahdm,gakhdm->gahk", q, kk).float() * _rounded(dh ** -0.5, q.dtype)
            sim = torch.where(nbr_mask[:, :, None, :], sim, torch.full((), -1e9, device=sim.device))
            attn = torch.softmax(sim, dim=-1).to(vv.dtype)
            out = torch.einsum("gahk,gakhdm->gahdm", attn, vv)
            outputs[d] = out.reshape(g, a, nh * dh, m)
        return self.to_out(outputs)


def se3_edges(pd, slot_mask, num_neighbors: int, valid_radius: float, num_degrees: int,
              slot_gid=None, dtype: torch.dtype = torch.float32):
    """The edge inputs every ConvSE3 shares (`se3_transformer.py:560-605`) of the
    slot coordinates pd [G, A, 3]: the k = min(num_neighbors, A − 1) nearest
    other slots within `valid_radius` (nbr_idx, nbr_mask [G, A, k]), rel_dist
    [G, A, k, 1] (0 where masked), and the CG-weighted harmonics of
    rel_pos = p_a − p_j, wsh_map {(din, dout): [G, A, k, J, b, c]} with
    w_sh[..., J, b, c] = Σ_m CG^{(din,J,dout)}[b, m, c] · Y_J[m]. rel_dist,
    the harmonics and the CG constants are computed in float32 and cast to
    `dtype`, in which the products are taken."""
    g, a = slot_mask.shape
    k = min(num_neighbors, a - 1)
    nbr_idx, nbr_mask, sqd = knn_dense(pd, slot_mask, k, valid_radius=valid_radius,
                                       squared_radius=False, exclude_self=True,
                                       slot_gid=slot_gid)
    zero = torch.zeros((), dtype=pd.dtype, device=pd.device)
    rel_pos = pd[:, :, None, :] - nbr_gather(pd, nbr_idx, torch.ones_like(nbr_mask))
    rel_dist = torch.where(nbr_mask, torch.sqrt(torch.clamp(sqd, min=0.0)), zero)[..., None]
    sh = [y.to(dtype) for y in spherical_harmonics(2 * (num_degrees - 1), rel_pos)]
    wsh_map = {}
    for din in range(num_degrees):
        for dout in range(num_degrees):
            wsh_map[(din, dout)] = torch.stack([
                torch.einsum("bmc,gakm->gakbc",
                             torch.tensor(cg_const(din, J, dout), dtype=dtype, device=pd.device),
                             sh[J])
                for J in _js(din, dout)], dim=3)
    return nbr_idx, nbr_mask, rel_dist.to(dtype), wsh_map


class SE3Transformer(nn.Module):
    """The trunk (`se3_transformer_layer.py:1117-1693`), dense layout: conv_in,
    `depth` pre-norm attention + FFN blocks, conv_out; returns float32 type-0
    features in the flat [N, dim] atom layout. `dtype` is the compute type
    (None: float32; "bfloat16"), the parameters stay float32. In bfloat16
    each pooled unit (I = O = dim, F = 128) takes kernels J and K where
    JAX's gate `pooled_conv_supported` fuses it at the call's shapes, and
    kernels L and M where it does not."""

    def __init__(self, dim: int = 64, heads: int = 2, depth: int = 2, dim_head: int = 32,
                 num_degrees: int = 2, valid_radius: float = 1e5, num_neighbors: int = 16,
                 attend_self: bool = True, dtype: str | None = None, *,
                 generator: torch.Generator):
        super().__init__()
        self.depth, self.num_degrees = depth, num_degrees
        self.valid_radius, self.num_neighbors = valid_radius, num_neighbors
        self.dtype = getattr(torch, dtype) if dtype is not None else torch.float32
        fiber_hidden = (dim,) * num_degrees
        self.conv_in = ConvSE3((dim,), fiber_hidden, generator=generator)
        for i in range(depth):
            self.add_module(f"attn_prenorm_{i}", NormSE3(fiber_hidden))
            self.add_module(f"attn_{i}", AttentionSE3(fiber_hidden, dim_head=dim_head, heads=heads,
                                                      attend_self=attend_self, generator=generator))
            self.add_module(f"ff_prenorm_{i}", NormSE3(fiber_hidden))
            self.add_module(f"ff_{i}", FeedForwardSE3(fiber_hidden, generator=generator))
        self.conv_out = ConvSE3(fiber_hidden, (dim,), generator=generator)

    def forward(
        self,
        feats: torch.Tensor,  # [N, dim] type-0
        coords: torch.Tensor,  # [N, 3]
        graph_id: torch.Tensor,  # [N] slot row of each atom
        slot_index: torch.Tensor,  # [G, A]
        slot_mask: torch.Tensor,  # [G, A] bool
        atom_slot: torch.Tensor,  # [N]
        slot_gid: torch.Tensor | None = None,  # [G, A] molecule id per slot
    ) -> torch.Tensor:
        g, a = slot_mask.shape
        sm = slot_mask[..., None].to(feats.dtype)
        flat = slot_index.reshape(-1)
        fd = feats.index_select(0, flat).view(g, a, -1) * sm
        pd = coords.index_select(0, flat).view(g, a, 3) * sm
        args = se3_edges(pd, slot_mask, self.num_neighbors, self.valid_radius, self.num_degrees,
                         slot_gid, self.dtype)
        # x, the residual stream, holds each value's last operation in
        # float32: the prenorms and the type-0 output cast it to float32, and
        # XLA leaves that operation unrounded there; every other use rounds it
        dt = self.dtype
        x = self.conv_in({0: fd.to(dt)[..., None]}, *args, exact=True)
        for i in range(self.depth):
            out = getattr(self, f"attn_{i}")(getattr(self, f"attn_prenorm_{i}")(x, dt), *args)
            x = {d: _sum_parts([x[d], out[d]], dt, exact=True) for d in out}
            out = getattr(self, f"ff_{i}")(getattr(self, f"ff_prenorm_{i}")(x, dt))
            x = {d: _sum_parts([x[d], out[d]], dt, exact=True) for d in out}
        x = self.conv_out({d: v.to(dt) for d, v in x.items()}, *args, exact=True)
        type0 = x[0][..., 0].float()  # [G, A, dim]
        return type0.reshape(g * a, -1).index_select(0, graph_id * a + atom_slot)
