"""2-D GNN baselines: `gin`, `gcn`, `gat` and `gatv2` on plain molecular graphs.

Port of `equihgnn_tpu/models/baseline_2d.py` (`reference
equihgnn/models/baseline_2d.py:19-206`) on its flat path: PyG's
MessagePassing scatters are masked segment reductions over the padded
`GraphBatch` edge lists (`index_select` gathers, `index_add_` sums,
`scatter_reduce` maxima), as JAX computes them with `jax.ops.segment_*`
outside any Pallas kernel, so no kernel of the port runs here. JAX's
dense per-molecule GAT (`baseline_2d.py:126-200`: one-hot matmuls, because
TPU scatters were near-serial) computes the same function and is not
ported.

  * `GINConv`: mlp((1 + eps)·x + Σ_j relu(x_j + e_ij)), a scalar `eps`
    (init 0), the MLP Linear → masked BatchNorm → ReLU → Linear;
  * `GCNConv`: the symmetric-normalized conv with deg counted over
    `edge_src` + 1 and a root term relu(x + root_emb) / deg (`root_emb`
    init N(0, 1));
  * `GATConv` (v1) and GATv2 (`v2=True`): PyG's GATConv / GATv2Conv with 4
    heads averaged (concat=False), edge features in the logits only, a self
    loop whose edge feature is the mean of the node's incoming ones
    (fill_value="mean"), LeakyReLU(0.2), a softmax over the incoming edges
    and the self loop; glorot weights, zero bias, and GATv2's `lin_l` /
    `lin_r` with torch's default bias;
  * `Set2Set`: 2 processing steps over an LSTM cell;
  * `GNN2D`: the atom and bond encoders, the convs each followed by a masked
    BatchNorm (ReLU and dropout between layers), JK "last" or "sum",
    `gnn_residual`, the poolings "sum", "mean", "max", "attention" (a gate
    MLP with a masked BatchNorm, then a per-graph softmax) and "set2set",
    and `graph_pred_linear`.

Weights are drawn on the CPU from an explicit `torch.Generator` (seed 0
when None) by JAX's initializers' laws, then moved to `device`.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.data.structures import NUM_BOND_FEATURES, GraphBatch
from equihgnn_tpu_torch.models.common import flat_pred, global_pool
from equihgnn_tpu_torch.nn.encoders import AtomEncoder, BondEncoder
from equihgnn_tpu_torch.nn.mlp import (
    MaskedBatchNorm,
    TorchLinear,
    leaky_relu,
    normal_,
    uniform_,
)
from equihgnn_tpu_torch.ops.segment import (
    segment_count,
    segment_max,
    segment_softmax,
    segment_sum,
)

POOLINGS = ("sum", "mean", "max", "attention", "set2set")


def _glorot(shape, fan_in: int, fan_out: int, generator) -> nn.Parameter:
    """flax `xavier_uniform`: U(±√(6 / (fan_in + fan_out)))."""
    bound = math.sqrt(6.0 / (fan_in + fan_out))
    return nn.Parameter(uniform_(torch.empty(shape), bound, generator))


def _glorot_linear(in_features: int, out_features: int, bias: bool, generator) -> TorchLinear:
    """JAX's `TorchLinear(kernel_init=xavier_uniform)`: a glorot weight, and
    torch's default bias U(±1/√fan_in)."""
    lin = TorchLinear(in_features, out_features, generator=generator, bias=bias)
    lin.weight = _glorot((out_features, in_features), in_features, out_features, generator)
    return lin


class LSTMCell(nn.Module):
    """flax's `nn.LSTMCell` (carry (c, h)) in `torch.nn.LSTMCell`'s layout:
    `weight_ih` [4d, in] and `weight_hh` [4d, d] stack the gates i, f, g, o;
    `bias_hh` [4d] is the hidden Denses' bias. flax's input Denses have no
    bias, so there is no `bias_ih` (a trainable one would double the bias's
    Adam step). Init as flax: input kernels lecun-normal (truncated at 2σ),
    hidden kernels orthogonal, one [d, d] block a gate, bias 0."""

    def __init__(self, in_features: int, features: int, *, generator: torch.Generator):
        super().__init__()
        std = math.sqrt(1.0 / in_features) / 0.87962566103423978
        w_ih, w_hh = torch.empty(4 * features, in_features), torch.empty(4 * features, features)
        for gate in range(4):
            rows = slice(gate * features, (gate + 1) * features)
            nn.init.trunc_normal_(w_ih[rows], std=std, a=-2 * std, b=2 * std,
                                  generator=generator)
            nn.init.orthogonal_(w_hh[rows], generator=generator)
        self.weight_ih, self.weight_hh = nn.Parameter(w_ih), nn.Parameter(w_hh)
        self.bias_hh = nn.Parameter(torch.zeros(4 * features))

    def forward(self, x: torch.Tensor, carry: tuple[torch.Tensor, torch.Tensor]):
        c, h = carry
        gates = F.linear(x, self.weight_ih) + F.linear(h, self.weight_hh, self.bias_hh)
        i, f, g, o = gates.chunk(4, dim=-1)
        c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        return c, torch.sigmoid(o) * torch.tanh(c)


class Set2Set(nn.Module):
    """Set2Set pooling (`torch_geometric.nn.aggr.Set2Set`, processing_steps
    2; `reference baseline_2d.py:160-161`): [G, 2d]."""

    def __init__(self, emb_dim: int, processing_steps: int = 2, *, generator):
        super().__init__()
        self.processing_steps = processing_steps
        self.lstm = LSTMCell(2 * emb_dim, emb_dim, generator=generator)

    def forward(self, x, graph_id, num_graphs: int, mask=None):
        d = x.shape[-1]
        c = h = x.new_zeros(num_graphs, d)
        q_star = x.new_zeros(num_graphs, 2 * d)
        for _ in range(self.processing_steps):
            c, h = self.lstm(q_star, (c, h))
            e = torch.sum(x * h.index_select(0, graph_id), dim=-1, keepdim=True)
            a = segment_softmax(e, graph_id, num_graphs, mask=mask)
            r = segment_sum(a * x, graph_id, num_graphs, mask=mask)
            q_star = torch.cat([h, r], dim=-1)
        return q_star


class GINConv(nn.Module):
    """`reference baseline_2d.py:19-46`: mlp((1 + eps)·x + Σ_j relu(x_j + e_ij))."""

    def __init__(self, emb_dim: int, *, generator):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(()))
        self.mlp_lin0 = TorchLinear(emb_dim, emb_dim, generator=generator)
        self.mlp_bn = MaskedBatchNorm(emb_dim)
        self.mlp_lin1 = TorchLinear(emb_dim, emb_dim, generator=generator)

    def forward(self, x, edge_src, edge_dst, edge_attr, edge_mask, atom_mask):
        msg = F.relu(x.index_select(0, edge_src) + edge_attr)
        agg = segment_sum(msg, edge_dst, x.shape[-2], mask=edge_mask)
        h = self.mlp_lin0((1.0 + self.eps) * x + agg)
        return self.mlp_lin1(F.relu(self.mlp_bn(h, atom_mask)))


class GCNConv(nn.Module):
    """`reference baseline_2d.py:49-74`: symmetric-normalized conv + root term."""

    def __init__(self, emb_dim: int, *, generator):
        super().__init__()
        self.linear = TorchLinear(emb_dim, emb_dim, generator=generator)
        self.root_emb = nn.Parameter(normal_(torch.empty(emb_dim), 1.0, generator))

    def forward(self, x, edge_src, edge_dst, edge_attr, edge_mask, atom_mask):
        n = x.shape[-2]
        x = self.linear(x)
        deg = segment_count(edge_src, n, mask=edge_mask) + 1.0
        dinv = torch.rsqrt(deg)
        norm = (dinv.index_select(0, edge_src) * dinv.index_select(0, edge_dst))[:, None]
        msg = norm * F.relu(x.index_select(0, edge_src) + edge_attr)
        out = segment_sum(msg, edge_dst, n, mask=edge_mask)
        return out + F.relu(x + self.root_emb) / deg[:, None]


class GATConv(nn.Module):
    """PyG's GATConv (`v2=False`) or GATv2Conv (`v2=True`) with heads=4,
    concat=False, edge_dim=emb_dim and mean-filled self loops, the self
    loop folded into the segment softmax (`baseline_2d.py:202-245`)."""

    def __init__(self, emb_dim: int, heads: int = 4, v2: bool = False,
                 negative_slope: float = 0.2, *, generator):
        super().__init__()
        h, f = heads, emb_dim
        self.heads, self.v2, self.negative_slope = heads, v2, negative_slope
        if v2:  # PyG's GATv2Conv: bias=True on lin_l / lin_r
            self.lin_l = _glorot_linear(emb_dim, h * f, True, generator)
            self.lin_r = _glorot_linear(emb_dim, h * f, True, generator)
            self.att = _glorot((1, h, f), h, f, generator)
        else:
            self.lin = _glorot_linear(emb_dim, h * f, False, generator)
            self.att_src = _glorot((1, h, f), h, f, generator)
            self.att_dst = _glorot((1, h, f), h, f, generator)
            self.att_edge = _glorot((1, h, f), h, f, generator)
        # [d_edge, h·f] as JAX's raw param; the edge features are emb_dim wide
        self.lin_edge_kernel = _glorot((emb_dim, h * f), emb_dim, h * f, generator)
        self.bias = nn.Parameter(torch.zeros(f))

    def forward(self, x, edge_src, edge_dst, edge_attr, edge_mask, atom_mask):
        n, h = x.shape[-2], self.heads
        lrelu = lambda v: leaky_relu(v, self.negative_slope)  # noqa: E731
        if self.v2:
            xs2, xd2 = self.lin_l(x), self.lin_r(x)
        else:
            xs2 = xd2 = self.lin(x)
        # the self loop's edge feature: the mean of the node's incoming ones
        mean_in = segment_sum(edge_attr, edge_dst, n, mask=edge_mask)
        cnt_in = segment_count(edge_dst, n, mask=edge_mask)[:, None]
        mean_in = mean_in / torch.clamp(cnt_in, min=1.0)
        xs, xd = xs2.reshape(n, h, -1), xd2.reshape(n, h, -1)
        eattr = (edge_attr @ self.lin_edge_kernel).reshape(-1, h, xs.shape[-1])
        eself = (mean_in @ self.lin_edge_kernel).reshape(n, h, -1)
        xs_e = xs.index_select(0, edge_src)
        if self.v2:
            z = lrelu(xs_e + xd.index_select(0, edge_dst) + eattr)
            logits = (z * self.att).sum(-1)
            self_logits = (lrelu(xs + xd + eself) * self.att).sum(-1)
        else:
            a_src, a_dst = (xs * self.att_src).sum(-1), (xd * self.att_dst).sum(-1)
            esc = (eattr * self.att_edge).sum(-1)
            logits = lrelu(a_src.index_select(0, edge_src) + a_dst.index_select(0, edge_dst)
                           + esc)
            self_logits = lrelu(a_src + a_dst + (eself * self.att_edge).sum(-1))

        emask = edge_mask[:, None]
        logits = torch.where(emask, logits, torch.finfo(logits.dtype).min)
        m = torch.maximum(segment_max(logits, edge_dst, n, mask=edge_mask), self_logits)
        ex = torch.exp(logits - m.index_select(0, edge_dst)) * emask.to(logits.dtype)
        ex_self = torch.exp(self_logits - m)
        denom = segment_sum(ex, edge_dst, n) + ex_self
        alpha = ex / torch.clamp(denom.index_select(0, edge_dst), min=1e-16)
        alpha_self = ex_self / torch.clamp(denom, min=1e-16)
        out = segment_sum(alpha[..., None] * xs_e, edge_dst, n, mask=edge_mask)
        out = out + alpha_self[..., None] * xs
        return out.mean(dim=1) + self.bias  # concat=False: the heads' mean


class GNN2D(nn.Module):
    """`reference baseline_2d.py:77-206`: encoders, convs, JK, pooling and
    a linear head. `gnn_type` picks the conv (default: the name the class
    is registered under; JAX's default is "gin" whatever the name);
    `bond_width` is the batches' bond feature columns (3, or 1 in the QM9
    graph variants)."""

    METHOD = "gin"

    def __init__(self, num_target: int, cfg, gnn_type: str | None = None,
                 bond_width: int = NUM_BOND_FEATURES, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()  # cfg.compute_dtype is taken and ignored, as in JAX
        gnn_type = gnn_type or self.METHOD
        num_layer, d = cfg.gnn_num_layer, cfg.gnn_emb_dim
        if num_layer < 2:
            raise ValueError("Number of GNN layers must be greater than 1.")
        if gnn_type not in ("gin", "gcn", "gat", "gatv2"):
            raise ValueError(f"Undefined GNN type called {gnn_type}")
        if cfg.gnn_jk not in ("last", "sum"):
            raise ValueError(f"Unknown JK mode {cfg.gnn_jk}")
        if cfg.gnn_graph_pooling not in POOLINGS:
            raise ValueError(f"Invalid graph pooling type {cfg.gnn_graph_pooling!r}")
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.cfg, self.gnn_type, self.num_layer = cfg, gnn_type, num_layer
        self.atom_encoder = AtomEncoder(d, generator=gen)
        self.bond_encoder = BondEncoder(d, bond_width, generator=gen)
        for layer in range(num_layer):
            if gnn_type == "gin":
                conv = GINConv(d, generator=gen)
            elif gnn_type == "gcn":
                conv = GCNConv(d, generator=gen)
            else:
                conv = GATConv(d, heads=4, v2=gnn_type == "gatv2", generator=gen)
            self.add_module(f"convs_{layer}", conv)
            self.add_module(f"batch_norms_{layer}", MaskedBatchNorm(d))
        self.dropout = nn.Dropout(cfg.dropout)
        pooling = cfg.gnn_graph_pooling
        if pooling == "attention":
            self.pool_gate_lin0 = TorchLinear(d, 2 * d, generator=gen)
            self.pool_gate_bn = MaskedBatchNorm(2 * d)
            self.pool_gate_lin1 = TorchLinear(2 * d, 1, generator=gen)
        elif pooling == "set2set":
            self.pool_set2set = Set2Set(d, processing_steps=2, generator=gen)
        pooled = 2 * d if pooling == "set2set" else d
        self.graph_pred_linear = TorchLinear(pooled, num_target, generator=gen)
        self.to(device)

    def forward(self, batch: GraphBatch) -> torch.Tensor:
        """[num_graphs] float32 predictions (padding graph included)."""
        cfg, mask = self.cfg, batch.atom_mask
        x = self.atom_encoder(batch.atom_feat)
        edge_attr = self.bond_encoder(batch.edge_feat)
        h_list = [x]
        for layer in range(self.num_layer):
            h = getattr(self, f"convs_{layer}")(
                h_list[layer], batch.edge_src, batch.edge_dst, edge_attr, batch.edge_mask, mask)
            h = getattr(self, f"batch_norms_{layer}")(h, mask)
            h = self.dropout(h if layer == self.num_layer - 1 else F.relu(h))
            if cfg.gnn_residual:
                h = h + h_list[layer]
            h_list.append(h)
        h_node = h_list[-1] if cfg.gnn_jk == "last" else sum(h_list)

        pooling, gid, g = cfg.gnn_graph_pooling, batch.atom_graph_id, batch.num_graphs
        if pooling == "attention":
            gate = self.pool_gate_bn(self.pool_gate_lin0(h_node), mask)
            gate = self.pool_gate_lin1(F.relu(gate))
            w = segment_softmax(gate, gid, g, mask=mask)
            hg = segment_sum(w * h_node, gid, g, mask=mask)
        elif pooling == "set2set":
            hg = self.pool_set2set(h_node, gid, g, mask=mask)
        else:
            hg = global_pool(h_node, gid, g, mask=mask, reduce=pooling)
        return flat_pred(self.graph_pred_linear(hg))


@registry.register_model("gin")
class GIN(GNN2D):
    METHOD = "gin"


@registry.register_model("gcn")
class GCN(GNN2D):
    METHOD = "gcn"


@registry.register_model("gat")
class GAT(GNN2D):
    METHOD = "gat"


@registry.register_model("gatv2")
class GATv2(GNN2D):
    METHOD = "gatv2"
