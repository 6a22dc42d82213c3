"""Shared model helpers (port of `equihgnn_tpu/models/common.py`): what a
configuration may ask of the port, the compute-dtype cast, activation,
graph pooling (sum, mean, max), the conjugated-hyperedge readout, the
prediction's shape, and `HybridModel`, whose `remat_encoder` is
`ModelConfig.remat`."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from equihgnn_tpu_torch.nn.mlp import prelu
from equihgnn_tpu_torch.ops.segment import masked_segment_reduce, segment_sum


# the models that run `compute_dtype="bfloat16"`: the SE(3)-Transformer in
# its encoder only, the MHNN family, the EGNN and the FAFormer models from the
# atom embedding to the prediction, the ViSNet models in ViSNet's layer loop
# (and TrunkFull/TrunkM's hyperedge embedding), as in JAX
BF16_METHODS = ("se3_transformer_equihnns", "mhnn", "mhnns", "mhnnm", "egnn_equihnn",
                "egnn_equihnns", "egnn_equihnnm", "faformer_equihnn", "faformer_equihnns",
                "faformer_equihnnm", "visnet_equihnn", "visnet_equihnns", "visnet_equihnnm")


def check_compute(cfg, method: str) -> None:
    """Raise on what the port does not run yet (ROADMAP item 11): a
    `compute_dtype` other than float32, except bfloat16 on the models of
    `BF16_METHODS`. The 2-D baselines do not call it: they take the flag
    and ignore it, as in JAX. `remat` runs on every model
    (`HybridModel.remat_encoder`; the MHNN family and the 2-D baselines take
    the flag and ignore it, as in JAX)."""
    dt = cfg.compute_dtype
    if dt not in (None, "float32") and not (dt == "bfloat16" and method in BF16_METHODS):
        raise NotImplementedError(
            f"compute_dtype={dt!r} on {method}: the PyTorch port runs bfloat16 only on "
            f"{', '.join(BF16_METHODS)}; the rest (the Equiformer) is ROADMAP item 11")


def cast_compute(cfg, *tensors):
    """Cast activations to the configured compute dtype, a no-op by default
    (`equihgnn_tpu/models/common.py:68-74`); None passes through. The MHNN
    family calls it on the atom embedding, the EGNN and FAFormer models on
    it and the positions, `TrunkFull` and `TrunkM` on the hyperedge embedding, as in
    JAX; the SE(3)-Transformer casts its own inputs."""
    if cfg.compute_dtype is None:
        return tensors if len(tensors) > 1 else tensors[0]
    dt = getattr(torch, cfg.compute_dtype)
    out = tuple(None if t is None else t.to(dt) for t in tensors)
    return out if len(out) > 1 else out[0]


class Activation(nn.Module):
    """{Id, relu, prelu} (`reference equihgnn/models/mhnn.py:23-24`). For
    "prelu" the module holds the one learnable slope `alpha` (init 0.25),
    which a trunk shares between its atom and hyperedge branches, as JAX's
    one `act` module does (`equihgnn_tpu/models/trunks.py:45,77-78`)."""

    def __init__(self, kind: str = "relu"):
        super().__init__()
        if kind not in ("Id", "relu", "prelu"):
            raise ValueError(f"unknown activation {kind!r}")
        self.kind = kind
        if kind == "prelu":
            self.alpha = nn.Parameter(torch.tensor(0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "relu":
            return F.relu(x)
        return prelu(x, self.alpha) if self.kind == "prelu" else x


def global_add_pool(x, graph_id, num_graphs: int, mask=None):
    """Masked per-graph sum (`torch_geometric.nn.global_add_pool` equivalent)."""
    return segment_sum(x, graph_id, num_graphs, mask=mask)


def global_pool(x, graph_id, num_graphs: int, mask=None, reduce: str = "sum"):
    """Masked per-graph "sum", "mean" or "max" (0 for a graph with no atom)."""
    return masked_segment_reduce(x, graph_id, num_graphs, reduce, mask=mask)


def conjugated_hedge_pool(e: torch.Tensor, batch) -> torch.Tensor:
    """Per-graph sum of the embeddings of conjugated hyperedges (more than
    two members), the reference's `global_add_pool(e[data.e_order > 2],
    he_batch)` (`reference equihgnn/models/mhnn.py:79`); a graph with no
    such hyperedge gets zeros, as in JAX."""
    conj = (batch.e_order > 2) & batch.hedge_mask
    return segment_sum(e, batch.hedge_graph_id, batch.num_graphs, mask=conj)


def flat_pred(x: torch.Tensor) -> torch.Tensor:
    """`.view(-1)` of a [G, 1] head output; predictions always float32."""
    return x.reshape(-1).to(torch.float32)


class HybridModel(nn.Module):
    """An encoder, then a hypergraph trunk (`models/trunks.py`). A subclass
    names its registered `METHOD` and its `TRUNK` class, builds its encoder
    in `build_encoder` and runs it in `encode`. Weights are drawn on the CPU
    from `generator` (seed 0 when None), encoder first, so one seed gives
    the same model on every device, then moved to `device`."""

    METHOD: str
    TRUNK: type

    def __init__(self, num_target: int, cfg, device="cpu",
                 generator: torch.Generator | None = None):
        super().__init__()
        check_compute(cfg, self.METHOD)
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.num_target, self.cfg = num_target, cfg
        self.build_encoder(cfg, gen)
        self.trunk = self.TRUNK(num_target, cfg, generator=gen)
        self.to(device)

    def build_encoder(self, cfg, generator: torch.Generator) -> None:
        raise NotImplementedError

    def encode(self, batch) -> torch.Tensor:
        raise NotImplementedError

    def remat_encoder(self, module: nn.Module, *args, **kwargs):
        """`module(*args, **kwargs)`; with `cfg.remat`, and autograd
        recording, a `torch.utils.checkpoint` of it (JAX's `nn.remat` of the
        encoder): its activations are recomputed in the backward pass, with
        the same dropout (the CPU and the inputs' CUDA generator states are
        restored for the recompute), and its kernels launch again there."""
        if self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(module, *args, use_reentrant=False, **kwargs)
        return module(*args, **kwargs)

    def forward(self, batch) -> torch.Tensor:
        """[num_graphs] float32 predictions (padding graph included)."""
        return self.trunk(self.encode(batch), batch)
