"""The port's training slice vs the JAX package, on the CPU.

Hidden 16, output hidden 8 over 3 layers, batches of 6-8 synthetic
molecules, numpy-seeded inputs fed to both frameworks. The JAX model runs
its EGNN through the Pallas edge MLP (interpret mode) and, with the
slot-incidence tables set to None, its trunk on the flat segment path, as
the port's does. Tolerances:

  * parameter gradients under masked MSE: per tensor, max |Δ| ≤
    1e-4·max |JAX| + 1e-6 (f32 sums in other orders);
  * three Adam steps (wd > 0): parameters within 1e-2·lr, losses within
    rtol 1e-5 (an Adam update is O(lr) whatever the gradient's size, so
    the tolerance scales with lr);
  * plateau, early stop, bootstrap metrics and splits: exact.

Then the port's `Trainer` and CLI by themselves: fit/test/resume as
`tests/test_train.py` and `tests/test_resume.py` check the JAX trainer,
same-seed reproducibility with dropout on, and serving a trained
`ckpt_best.pt` through `predict`.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.data.splits import (
    create_train_val_test_set_and_normalize as jax_splits,
)
from equihgnn_tpu.data.synthetic import make_synthetic_dataset
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.train import metrics as jax_metrics
from equihgnn_tpu.train import schedule as jax_schedule
from equihgnn_tpu.train.trainer import TrainConfig as JaxTrainConfig
from equihgnn_tpu.train.trainer import Trainer as JaxTrainer
from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import iter_batches, pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.data.datasets import MolDataset
from equihgnn_tpu_torch.data.splits import create_train_val_test_set_and_normalize
from equihgnn_tpu_torch.main import UNPORTED_FLAGS, build_parser, load_splits, run
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.train import metrics, schedule
from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer, _Prefetcher, masked_mse

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SDF = os.path.join(ROOT, "datasets", "real_sample", "sample.sdf")
CFG = dict(mlp_hidden=16, output_hidden=8, all_num_layers=3, output_num_layers=3,
           aggregate="mean", normalization="ln")
SLOT_TABLES = ("hedge_row", "hedge_slot", "hedge_slot_index", "hedge_slot_mask",
               "inc_slot_atom", "inc_slot_hedge", "inc_slot_mask")


def _jax_batch(samples, spec):
    jb = jax_pad(samples, spec, target=0, with_pos=True)
    return jax.tree.map(jnp.asarray, dataclasses.replace(jb, **{f: None for f in SLOT_TABLES}))


def _setup(n_batches=1, per_batch=6, seed=0):
    """Batches for both frameworks, the JAX model and its params with the
    EGNN layer redrawn at O(0.1) (its N(0, 1e-3²) init barely moves x)."""
    samples = make_synthetic_dataset(n_batches * per_batch, seed=23, num_targets=1)
    chunks = [samples[i * per_batch:(i + 1) * per_batch] for i in range(n_batches)]
    jspec, tspec = jax_spec(samples, batch_size=8), spec_for_samples(samples, batch_size=8)
    jbs = [_jax_batch(c, jspec) for c in chunks]
    tbs = [pad_hypergraph_batch(c, tspec, target=0, with_pos=True) for c in chunks]
    jmodel = jax_create_model("egnn_equihnns", num_target=1, cfg=JaxModelConfig(**CFG))
    params = jmodel.init(jax.random.PRNGKey(seed), jbs[0], deterministic=True)["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.startswith("egnn_layer/") and "norm" not in k:
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
    return jbs, tbs, jmodel, flat


def _port_model(flat):
    model = create_model("egnn_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    model.load_state_dict(params_from_jax(flat, model))
    return model


def test_model_grads_match_jax():
    (jb,), (tb,), jmodel, flat = _setup()

    def loss_fn(p):
        preds = jmodel.apply({"params": p}, jb, deterministic=False,
                             rngs={"dropout": jax.random.PRNGKey(0)})
        sq, cnt = jax_masked_mse(preds, jb.y, jb.graph_mask)
        return sq / jnp.maximum(cnt, 1.0)

    jloss, jgrads = jax.value_and_grad(loss_fn)(traverse_util.unflatten_dict(flat, sep="/"))
    model = _port_model(flat).train()
    want = params_from_jax(
        {k: np.asarray(v) for k, v in traverse_util.flatten_dict(jgrads, sep="/").items()}, model)
    sq, cnt = masked_mse(model(tb), tb.y, tb.graph_mask)
    loss = sq / torch.clamp(cnt, min=1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    reached = 0
    for name, p in model.named_parameters():
        w = want[name]
        if p.grad is None:  # the coordinate branch: zero in JAX too
            assert float(w.abs().max()) == 0.0, name
            continue
        err = float((p.grad - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()) + 1e-6, f"{name}: {err:.3e}"
        reached += bool(w.abs().max() > 0)
    # EGNN edge MLP, atom embedding and the trunk's W1 are all reached
    assert reached >= len(want) - 5


def test_three_adam_steps_match_jax():
    jbs, tbs, jmodel, flat = _setup(n_batches=3)
    lr, wd = 1e-3, 0.05
    jt = JaxTrainer(jmodel, JaxTrainConfig(lr=lr, weight_decay=wd, seed=0), jbs[0], std=1.0)
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    opt_state, stats, key = jt.tx.init(params), jt.batch_stats, jax.random.PRNGKey(1)
    tt = Trainer(_port_model(flat), TrainConfig(lr=lr, weight_decay=wd, seed=0), std=1.0,
                 device="cpu")
    tt.set_lr(lr)
    for jb, tb in zip(jbs, tbs):
        params, opt_state, stats, jloss, key = jt._step_fn(
            params, opt_state, stats, jb, np.float32(lr), key)
        tloss = tt.train_step(tb)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = params_from_jax(
        {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()},
        tt.model)
    got = tt.model.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-2 * lr, rtol=0,
                                   err_msg=name)
    # the coordinate branch has no gradient, yet wd decays it in both frameworks
    start = _port_model(flat).state_dict()
    for name in ("egnn_layer.coors_mlp_0.weight", "egnn_layer.coors_norm.scale"):
        assert float((got[name] - start[name]).abs().max()) > lr, name


def test_plateau_and_early_stop_match_jax():
    rng = np.random.default_rng(0)
    vals = np.concatenate([np.linspace(5, 3, 6), 3 + 0.01 * rng.random(30)]).tolist()
    a = schedule.ReduceLROnPlateau(1e-2, factor=0.5, patience=2, min_lr=1e-4)
    b = jax_schedule.ReduceLROnPlateau(1e-2, factor=0.5, patience=2, min_lr=1e-4)
    c, d = schedule.EarlyStopping(patience=4), jax_schedule.EarlyStopping(patience=4)
    for v in vals:
        assert a.step(v) == b.step(v)
        assert c.step(v) == d.step(v)
    assert a.lr < 1e-2 and c.should_stop


def test_bootstrap_and_accumulator_match_jax():
    rng = np.random.default_rng(1)
    preds, targets = rng.standard_normal(300), rng.standard_normal(300)
    assert metrics.bootstrap_metrics(preds, targets, 20, seed=3) == \
        jax_metrics.bootstrap_metrics(preds, targets, 20, seed=3)
    mask = rng.random(300) < 0.7
    a, b = metrics.EvalAccumulator(std=2.5), jax_metrics.EvalAccumulator(std=2.5)
    a.update(preds, targets, mask)
    b.update(preds, targets, mask)
    assert a.compute("val_", 10, seed=1) == b.compute("val_", 10, seed=1)


def test_splits_match_jax(tmp_path):
    got = create_train_val_test_set_and_normalize(
        target=3, data_name="synthetic_hg_3d", data_dir=str(tmp_path), size=60)
    want = jax_splits(target=3, data_name="synthetic_hg_3d", data_dir=str(tmp_path), size=60)
    assert got[3] == want[3]
    for gs, ws in zip(got[:3], want[:3]):
        assert len(gs) == len(ws) > 0
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g.y, w.y)
            np.testing.assert_array_equal(g.atom_feat, w.atom_feat)
            np.testing.assert_array_equal(g.pos, w.pos)
    assert [len(s) for s in got[:3]] == [48, 6, 6]


def test_partitioned_dataset_raises(monkeypatch):
    class Partitioned(MolDataset):
        partitioned = True

    monkeypatch.setitem(registry.mapping["data_name_mapping"], "opv_port_test", Partitioned)
    with pytest.raises(NotImplementedError):
        create_train_val_test_set_and_normalize(0, "opv_port_test", "unused")


def test_iter_batches_shuffle_matches_jax():
    from equihgnn_tpu.data.batching import iter_batches as jax_iter_batches

    samples = make_synthetic_dataset(30, seed=4, num_targets=3)
    spec = spec_for_samples(samples, batch_size=8)
    got = [(b.y.numpy(), b.atom_feat.numpy()) for b in iter_batches(
        samples, spec, target=2, with_pos=True, shuffle=True, rng=np.random.default_rng(9))]
    want = [(np.asarray(b.y), np.asarray(b.atom_feat)) for b in jax_iter_batches(
        samples, jax_spec(samples, batch_size=8), target=2, with_pos=True, shuffle=True,
        rng=np.random.default_rng(9))]
    assert len(got) == len(want) == 4
    for (gy, gf), (wy, wf) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gf, wf)


# ------------------------------------------------------- the port's trainer


def _learnable(n, seed=0):
    samples = make_synthetic_dataset(n, seed=seed, num_targets=1)
    for s in samples:  # learnable target: normalized atom count
        s.y = np.float32((s.n_atoms - 16.0) / 8.0)
    return samples


def _trainer(tmp_path, *, epochs, lr=3e-3, resume=False, dropout=0.0, seed=0, hidden=16,
             train_seed=None, method="egnn_equihnns"):
    cfg = ModelConfig(mlp_hidden=hidden, output_hidden=8, dropout=dropout)
    model = create_model(method, num_target=1, cfg=cfg,
                         generator=torch.Generator().manual_seed(seed))
    tcfg = TrainConfig(epochs=epochs, lr=lr, seed=seed if train_seed is None else train_seed,
                       log_dir=str(tmp_path), resume=resume,
                       num_bootstraps=5,
                       run_meta={"method": method,
                                 "model_config": dataclasses.asdict(cfg), "std": 1.0})
    return Trainer(model, tcfg, std=1.0, device="cpu")


def _loaders(train, val, spec):
    return (lambda e: iter_batches(train, spec, with_pos=True, shuffle=True,
                                   rng=np.random.default_rng(e)),
            lambda: iter_batches(val, spec, with_pos=True))


def test_fit_reduces_loss_checkpoints_and_serves(tmp_path):
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import featurize_sdf, predict_samples
    from equihgnn_tpu_torch.predict import run as predict_run

    samples = _learnable(96)
    spec = spec_for_samples(samples, batch_size=24)
    tr = _trainer(tmp_path, epochs=6)
    best = tr.fit(*_loaders(samples[:72], samples[72:], spec))
    hist = tr.history
    assert hist[-1]["train_loss"] < hist[0]["train_loss"] * 0.8
    assert hist[0]["train_steps"] >= 3 and hist[0]["train_graphs"] == 72
    assert best["val_mae_mean"] < np.inf
    for name in ("metrics.csv", "ckpt_best.pt", "ckpt_best.opt.pt", "ckpt_best.pt.meta.json",
                 "ckpt_last.pt"):
        assert os.path.exists(tmp_path / name), name
    m = tr.test(lambda: iter_batches(samples[72:], spec, with_pos=True))
    assert np.isfinite(m["test_mae_mean"])
    assert os.path.exists(tmp_path / "test_results.csv")

    # the best checkpoint serves through predict, equal to the restored model
    out = str(tmp_path / "preds.csv")
    predict_run(predict_parser().parse_args(
        ["--ckpt", str(tmp_path / "ckpt_best.pt"), "--sdf", SDF, "--out", out,
         "--device", "cpu"]))
    with open(out) as f:
        vals = np.array([float(r.split(",")[-1]) for r in f.read().splitlines()[1:]])
    assert vals.shape == (20,) and np.isfinite(vals).all()
    mols = [s for _, s in featurize_sdf(SDF)]
    want = predict_samples(tr.model.eval(), mols, 256, torch.device("cpu"))
    np.testing.assert_allclose(vals, want, rtol=1e-5, atol=1e-6)


def test_faformer_fit_reduces_loss_and_serves(tmp_path):
    """`faformer_equihnns` through the port's Trainer: the loss falls, the
    FAFormer's own dropout (0.1; cfg.dropout is 0 and reaches the trunk
    only) is active in train() mode, and ckpt_best.pt serves."""
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import featurize_sdf, predict_samples
    from equihgnn_tpu_torch.predict import run as predict_run

    samples = _learnable(192)
    spec = spec_for_samples(samples, batch_size=32)
    tr = _trainer(tmp_path, epochs=8, lr=1e-3, hidden=32, method="faformer_equihnns")
    tr.fit(*_loaders(samples[:144], samples[144:], spec))
    losses = [h["train_loss"] for h in tr.history]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0] * 0.8, losses

    batch = next(iter_batches(samples[:32], spec, with_pos=True, target=0))
    model = tr.model.train()
    with torch.no_grad():
        a, b = model(batch), model(batch)
        assert not torch.allclose(a, b)
        model.eval()
        torch.testing.assert_close(model(batch), model(batch), rtol=0, atol=0)

    out = str(tmp_path / "preds.csv")
    predict_run(predict_parser().parse_args(
        ["--ckpt", str(tmp_path / "ckpt_best.pt"), "--sdf", SDF, "--out", out,
         "--device", "cpu"]))
    with open(out) as f:
        vals = np.array([float(r.split(",")[-1]) for r in f.read().splitlines()[1:]])
    tr._restore_checkpoint("best")
    mols = [s for _, s in featurize_sdf(SDF)]
    want = predict_samples(tr.model.eval(), mols, 256, torch.device("cpu"))
    assert vals.shape == (20,) and np.isfinite(vals).all()
    np.testing.assert_allclose(vals, want, rtol=1e-5, atol=1e-6)


def test_resume_from_last(tmp_path):
    samples = _learnable(48)
    spec = spec_for_samples(samples, batch_size=12)
    loaders = _loaders(samples[:36], samples[36:], spec)

    t1 = _trainer(tmp_path, epochs=4, lr=1e-3)
    t1.fit(*loaders)
    assert len(t1.history) == 4
    t2 = _trainer(tmp_path, epochs=4, lr=1e-3, resume=True)  # done already
    t2.fit(*loaders)
    assert len(t2.history) == 0
    t3 = _trainer(tmp_path, epochs=6, lr=1e-3, resume=True)
    t3.fit(*loaders)
    assert [h["epoch"] for h in t3.history] == [4, 5]
    assert t3.history[0]["val_mae_raw"] < t1.history[0]["val_mae_raw"]


def test_fit_reproducible_same_seed(tmp_path):
    samples = _learnable(48)
    spec = spec_for_samples(samples, batch_size=16)

    def fit(train_seed=7):
        tr = _trainer(tmp_path, epochs=3, dropout=0.3, seed=7, train_seed=train_seed)
        tr.fit(*_loaders(samples, samples[32:], spec))
        return [h["train_loss"] for h in tr.history]

    a, b = fit(), fit()
    np.testing.assert_allclose(a, b, rtol=0, atol=0)
    # same weights, another dropout stream: dropout is on and follows the seed
    assert not np.allclose(a, fit(train_seed=8), rtol=1e-6, atol=0)


def test_prefetcher_basics():
    assert list(_Prefetcher(iter(range(7)), depth=2)) == list(range(7))

    def boom():
        yield 1
        raise RuntimeError("loader failed")

    pf = _Prefetcher(boom(), depth=2)
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="loader failed"):
        next(pf)

    pf = _Prefetcher(iter(range(100)), depth=1)  # producer blocked on a full queue
    assert next(pf) == 0
    pf.close()
    assert not pf._thread.is_alive()


# --------------------------------------------------------------- the CLI

CLI = ["--data", "synthetic_hg_3d", "--method", "egnn_equihnns"]


def test_main_trains_and_checkpoints(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args(CLI + [
        "--device", "cpu", "--synthetic_size", "80", "--batch_size", "16", "--epochs", "2",
        "--MLP_hidden", "16", "--output_hidden", "8", "--target", "2", "--wd", "1e-4"])
    res = run(args)
    assert res["log_dir"] == os.path.join("logs", "synthetic_hg_3d_2_egnn_equihnns", "version_0")
    assert np.isfinite(res["test_mae_mean"]) and len(res["history"]) == 2
    import json

    with open(os.path.join(res["log_dir"], "ckpt_best.pt.meta.json")) as f:
        meta = json.load(f)
    assert meta["method"] == "egnn_equihnns" and meta["target"] == 2
    assert meta["model_config"]["mlp_hidden"] == 16 and meta["std"] > 0


def test_visnet_main_trains_checkpoints_and_serves(tmp_path, monkeypatch):
    """`main.run --method visnet_equihnns` on the CPU, one tiny epoch; its
    `ckpt_best.pt` round-trips: `predict` serves it, equal to the saved
    weights loaded into a fresh model."""
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import featurize_sdf, load_checkpoint, predict_samples
    from equihgnn_tpu_torch.predict import run as predict_run

    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args([
        "--data", "synthetic_hg_3d", "--method", "visnet_equihnns", "--device", "cpu",
        "--synthetic_size", "40", "--batch_size", "16", "--epochs", "1", "--lr", "1e-4",
        "--MLP_hidden", "16", "--output_hidden", "8"])
    res = run(args)
    assert len(res["history"]) == 1 and np.isfinite(res["history"][0]["train_loss"])
    assert np.isfinite(res["test_mae_mean"])
    ckpt = os.path.join(res["log_dir"], "ckpt_best.pt")
    out = str(tmp_path / "preds.csv")
    predict_run(predict_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", SDF, "--out", out, "--device", "cpu"]))
    with open(out) as f:
        vals = np.array([float(r.split(",")[-1]) for r in f.read().splitlines()[1:]])
    meta, state = load_checkpoint(ckpt)
    assert meta["method"] == "visnet_equihnns"
    model = create_model("visnet_equihnns", num_target=1, cfg=ModelConfig(**meta["model_config"]))
    model.load_state_dict(state)
    mols = [s for _, s in featurize_sdf(SDF)]
    want = predict_samples(model.eval(), mols, 256, torch.device("cpu")) * meta["std"]
    assert vals.shape == (20,) and np.isfinite(vals).all()
    np.testing.assert_allclose(vals, want, rtol=1e-5, atol=1e-6)


def test_main_debug_cli_on_cpu(tmp_path):
    """The documented command, in a fresh interpreter."""
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "equihgnn_tpu_torch.main", *CLI, "--debug", "--device", "cpu"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert '"test_mae_mean"' in proc.stdout
    assert os.path.exists(tmp_path / "logs" / "synthetic_hg_3d_0_egnn_equihnns" / "version_0"
                          / "metrics.csv")


def test_main_cuda_raises_without_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args(CLI + ["--debug"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(args)
    assert not os.path.exists(tmp_path / "logs")


# --remat and --compute_dtype bfloat16 on egnn_equihnns are ported: each
# trains (remat's step: tests/test_torch_remat.py; bf16 against JAX:
# tests/test_torch_bf16_hypergraph.py)
@pytest.mark.parametrize("flag", sorted([*UNPORTED_FLAGS, "compute_dtype", "remat"]))
def test_unported_flags_raise(flag, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    extra = {"buckets": ["--buckets", "16,24"], "compute_dtype": ["--compute_dtype", "bfloat16"]}
    args = build_parser().parse_args(CLI + ["--device", "cpu"] + extra.get(flag, [f"--{flag}"]))
    if flag in ("remat", "compute_dtype"):
        args = build_parser().parse_args(
            CLI + ["--device", "cpu", "--debug", "--synthetic_size", "40", "--batch_size", "8",
                   "--MLP_hidden", "16", "--output_hidden", "8"]
            + (["--remat"] if flag == "remat" else extra[flag]))
        assert np.isfinite(run(args)["history"][0]["train_loss"])
        return
    with pytest.raises(NotImplementedError, match=flag):
        run(args)


def test_data_parallel_raises(tmp_path, monkeypatch):
    # the CLI is the one place that rejects it, before any data or log dir
    with pytest.raises(TypeError):
        TrainConfig(data_parallel=True)
    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args(CLI + ["--device", "cpu", "--data_parallel"])
    with pytest.raises(NotImplementedError, match="ROADMAP item 10"):
        run(args)
    assert not os.path.exists(tmp_path / "logs")


def test_main_run_leaves_splits_alone(tmp_path, monkeypatch):
    """The target column is selected per batch; the caller's samples keep
    every column, so a second run may pick another target."""
    monkeypatch.chdir(tmp_path)
    argv = CLI + ["--device", "cpu", "--synthetic_size", "40", "--batch_size", "8", "--debug",
                  "--MLP_hidden", "16", "--output_hidden", "8"]
    args = build_parser().parse_args(argv + ["--target", "2"])
    splits = load_splits(args)
    before = [np.array(s.y) for part in splits[:3] for s in part]
    assert before[0].shape == (16,)
    run(args, splits=splits)
    run(build_parser().parse_args(argv + ["--target", "5"]), splits=splits)
    after = [s.y for part in splits[:3] for s in part]
    for b, a in zip(before, after):
        np.testing.assert_array_equal(a, b)
