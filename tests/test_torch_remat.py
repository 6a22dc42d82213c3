"""`ModelConfig.remat` (`--remat`) in the port, on the CPU.

Each encoder wrapper checkpoints the module its JAX wrapper remats
(`torch.utils.checkpoint`, non-reentrant): the EGNN layer, the whole
ViSNet block (around its own per-layer checkpoints), the
SE(3)-Transformer (around the bf16 path's per-J checkpoints), the FAFormer
call and the Equiformer. A train step with remat gives the same
predictions and gradients as without, in training mode with dropout on
(FAFormer's 0.1 inside the checkpoint and the trunk's 0.1 outside it, from
the same seed): the recompute replays the same dropout. Predictions are
held to the same bits; gradients to 1e-5·max per tensor (autograd sums a
parameter's contributions in another order once the encoder's graph is
recomputed). The kernel wrappers' calls per train step are counted (on the
CPU each runs its plain version): remat adds the encoder's forward calls
to the backward pass, the counts `chip_smoke.py` expects of the card's
kernels. The MHNN family and the 2-D baselines take the flag and ignore
it, as in JAX.
"""

import numpy as np
import pytest
import torch

from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.data.batching import iter_batches, pad_graph_batch, spec_for_samples
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import egnn, faformer, se3_transformer, visnet
from equihgnn_tpu_torch.ops import segment
from equihgnn_tpu_torch.train.trainer import masked_mse

torch.set_num_threads(1)

CFG = dict(mlp_hidden=16, output_hidden=8, all_num_layers=3, output_num_layers=3,
           dropout=0.1)
# the wrappers of each kernel, by the module that calls them
WRAPPERS = {"A": (segment, "sorted_segment_sum"), "B": (egnn, "fused_edge_messages"),
            "D": (faformer, "fused_frame_swiglu"), "F": (visnet, "vis_vec_agg"),
            "H": (visnet, "vis_wdot"), "J": (se3_transformer, "pooled_conv"),
            "L": (se3_transformer, "pooled_m")}
# path → (method, config changes, the wrappers' calls in a train step without
# remat; with it each encoder kernel's forward calls come again in the backward)
PATHS = {
    "egnn": ("egnn_equihnns", {}, {"A": 3, "B": 1}),
    "egnn_full": ("egnn_equihnn", {}, {"A": 3, "B": 1}),
    "faformer": ("faformer_equihnns", {}, {"A": 3, "D": 5}),
    "visnet": ("visnet_equihnns", {}, {"A": 3, "F": 6, "H": 5}),
    "se3": ("se3_transformer_equihnns", {}, {"A": 3, "J": 4}),
    # the per-J checkpoints recompute L in the backward pass without remat too
    "se3_bf16": ("se3_transformer_equihnns", dict(compute_dtype="bfloat16"), {"A": 3, "L": 8}),
    # kernel D's bf16 dropout mask replayed in the recompute
    "faformer_bf16": ("faformer_equihnns", dict(compute_dtype="bfloat16"), {"A": 3, "D": 5}),
    "equiformer": ("equiformer_equihnns", {}, {"A": 3}),
}
ENCODER_FWD = {"egnn": {"B": 1}, "egnn_full": {"B": 1}, "faformer": {"D": 5},
               "visnet": {"F": 6, "H": 5}, "se3": {"J": 4}, "se3_bf16": {"L": 4},
               "faformer_bf16": {"D": 5}, "equiformer": {}}


def _batch(n=5, seed=23):
    samples = [s for s in make_synthetic_dataset(30, seed=seed, num_targets=1)
               if s.n_atoms <= 12][:n]
    return next(iter_batches(samples, spec_for_samples(samples, n), with_pos=True, target=0))


def _counting(monkeypatch):
    counts = dict.fromkeys(WRAPPERS, 0)
    for name, (mod, attr) in WRAPPERS.items():
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _name=name, **kw):
            counts[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, attr, counted)
    return counts


def _step(method, cfg, batch, remat, monkeypatch):
    """Predictions, parameter gradients and the wrappers' calls of one
    training-mode step (masked MSE) from seed 0's weights and seed 5's
    dropout. The Equiformer's zero-init output weights are drawn nonzero,
    so that its attention and feed-forward branches take part."""
    model = create_model(method, num_target=1, cfg=ModelConfig(**cfg, remat=remat),
                         generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("to_out.w0", "to_out.w1", "project_out.w0", "project_out.w1")):
                p.normal_(0.0, p.shape[0] ** -0.5, generator=gen)
    if hasattr(model, "visnet_layer"):
        model.visnet_layer.remat_layers = False  # as on the card: no per-layer checkpoints
    counts = _counting(monkeypatch)
    torch.manual_seed(5)
    preds = model.train()(batch)
    sq, cnt = masked_mse(preds, batch.y, batch.graph_mask)
    (sq / torch.clamp(cnt, min=1.0)).backward()
    monkeypatch.undo()
    grads = {n: p.grad for n, p in model.named_parameters()}
    return preds.detach(), grads, {k: v for k, v in counts.items() if v}


@pytest.mark.parametrize("path", list(PATHS))
def test_remat_gives_the_same_step(path, monkeypatch):
    method, over, calls = PATHS[path]
    cfg = {**CFG, **over}
    if path == "se3_bf16":
        cfg["dropout"] = 0.0  # the bf16 encoder has no dropout; the trunk's is held above
    batch = _batch()
    p0, g0, c0 = _step(method, cfg, batch, False, monkeypatch)
    p1, g1, c1 = _step(method, cfg, batch, True, monkeypatch)
    torch.testing.assert_close(p1, p0, rtol=0, atol=0)
    reached = 0
    for name, g in g0.items():
        if g is None:
            assert g1[name] is None, name
            continue
        reached += 1
        limit = 1e-5 * float(g.abs().max()) + 1e-7
        assert float((g1[name] - g).abs().max()) <= limit, name
    assert reached > 0.5 * len(g0)
    assert c0 == calls, c0
    want = {k: n + ENCODER_FWD[path].get(k, 0) for k, n in calls.items()}
    assert c1 == want, c1


def test_faformer_dropout_is_live():
    """The remat case above holds something: FAFormer's and the trunk's
    dropout change the step's predictions between two seeds."""
    batch = _batch()
    model = create_model("faformer_equihnns", num_target=1, cfg=ModelConfig(**CFG)).train()
    outs = []
    for seed in (5, 6):
        torch.manual_seed(seed)
        with torch.no_grad():
            outs.append(model(batch))
    assert float((outs[0] - outs[1]).abs().max()) > 1e-4


def test_remat_off_the_autograd_record_is_the_plain_forward(monkeypatch):
    """Serving (`inference_mode`) with remat runs the encoder once."""
    batch = _batch()
    model = create_model("egnn_equihnns", num_target=1,
                         cfg=ModelConfig(**CFG, remat=True)).eval()
    counts = _counting(monkeypatch)
    with torch.inference_mode():
        model(batch)
    assert counts["B"] == 1 and counts["A"] == 3


@pytest.mark.parametrize("method", ["mhnn", "gat"])
def test_models_without_an_encoder_accept_the_flag(method):
    """The MHNN family and the 2-D baselines build with remat and compute
    the same step as without it."""
    if method == "gat":
        samples = make_synthetic_dataset(5, seed=3, num_targets=1, hyper=False)
        batch = pad_graph_batch(samples, spec_for_samples(samples, 5), target=0)
    else:
        samples = make_synthetic_dataset(5, seed=3, num_targets=1, with_pos=False)
        batch = next(iter_batches(samples, spec_for_samples(samples, 5), target=0))
    outs = []
    for remat in (False, True):
        kw = {"gnn_type": method} if method == "gat" else {}
        model = create_model(method, num_target=1, cfg=ModelConfig(**CFG, remat=remat), **kw)
        torch.manual_seed(5)
        preds = model.train()(batch)
        preds.sum().backward()
        outs.append((preds.detach(), [p.grad for p in model.parameters()]))
    torch.testing.assert_close(outs[1][0], outs[0][0], rtol=0, atol=0)
    for a, b in zip(outs[0][1], outs[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            torch.testing.assert_close(b, a, rtol=0, atol=0)


def test_main_trains_with_remat(tmp_path, monkeypatch):
    from equihgnn_tpu_torch.main import build_parser, run

    monkeypatch.chdir(tmp_path)
    res = run(build_parser().parse_args(
        ["--data", "synthetic_hg_3d", "--method", "egnn_equihnns", "--device", "cpu",
         "--MLP_hidden", "16", "--output_hidden", "8", "--batch_size", "16",
         "--synthetic_size", "40", "--epochs", "2", "--lr", "1e-3", "--remat"]))
    assert len(res["history"]) == 2
    assert all(np.isfinite(h["train_loss"]) for h in res["history"])
