"""The MHNN family and the EGNN models with `compute_dtype="bfloat16"` in
the port against the JAX package's bfloat16 models, on the CPU, and the
plain bfloat16 versions of kernels A, B and C against JAX's Pallas
functions in bfloat16 (interpret mode).

Tolerances, each stated against what the two frameworks round:

  * kernel A's plain version (`index_add_` into f32, one rounding) against
    JAX's `sorted_segment_sum` on bf16 data: within one bf16 ulp (both
    round an f32 sum once; measured: the same bits);
  * kernel B's plain version against JAX's `fused_edge_messages` on bf16
    ui, ujn and dist: within one bf16 ulp (`bf16_ulp_distance`: an ulp of
    max(|value|, max/256)) and at least 99 % the same bits (measured: all);
    kernel C's (autograd through it): dui and ddist likewise; the f32
    parameter gradients within 1e-5 of max|JAX| (measured ~2e-7). dujn
    differs by design: JAX rounds dpre to bf16 before its one-hot scatter
    (`ohᵀ·dpre`, a TPU matrix-unit artefact), the port sums dpre in f32. It
    is held to JAX within 2^-8·Σ|dpre| + one ulp (the most JAX's rounding
    of the terms moves the sum), and to the f32 sum of dpre, recomputed
    here, within one ulp;
  * `knn_dense` on bf16 positions: the same neighbours, masks and ranks as
    JAX's (bf16 squared distances tie often; both break ties lower index
    first);
  * the six models at matched weights (numpy draws converted by
    `params_from_jax`), against JAX's own bf16-vs-f32 gap ("the gap") on
    the same batch: predictions (float32) within 2x the gap's max over the
    molecules (measured 0.29-1.21x); gradients of the masked MSE as the
    relative L2 distance over all parameters within 1.5x the gap's
    (measured 0.04-1.04x). Per-tensor limits are not held: bf16 moves the
    trunks' ReLU and BatchNorm inputs, and one rounding that differs (XLA's
    CPU scatter rounds at every add, the port's segment sums once) spreads
    through three layers; the gap itself is that large. That the port
    computes in bf16 at all is held on both sides: its own bf16-vs-f32
    distance is at least 0.3x the gap (measured 0.9-1.6x), and every
    module's output has JAX's dtype (`capture_intermediates` against
    forward hooks). Every parameter JAX reaches is reached;
  * one Adam step of `mhnns` against the JAX trainer's: where the port's
    and JAX's bf16 gradients agree in sign, the same move within 1e-2·lr;
    every element moved by at most lr in both.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_kernels_cuda import bf16_ulp_distance
from test_torch_mhnn import CFG, _flat, _unflat, jax_batch, jax_reference, random_variables

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.ops.knn import knn_dense as jax_knn_dense
from equihgnn_tpu.ops.pallas.edge_mlp import fused_edge_messages as jax_fused_edge_messages
from equihgnn_tpu.ops.pallas.segment_sum import sorted_segment_sum as jax_sorted_segment_sum
from equihgnn_tpu.train.trainer import TrainConfig as JaxTrainConfig
from equihgnn_tpu.train.trainer import Trainer as JaxTrainer
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
    fused_edge_messages_bwd_plain,
    fused_edge_messages_plain,
)
from equihgnn_tpu_torch.ops.kernels.segment_sum import sorted_segment_sum_plain
from equihgnn_tpu_torch.ops.knn import knn_dense
from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer, masked_mse

torch.set_num_threads(1)

SDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "datasets", "real_sample",
                   "sample.sdf")
METHODS = ("mhnn", "mhnns", "mhnnm", "egnn_equihnn", "egnn_equihnns", "egnn_equihnnm")
BF16 = dict(CFG, compute_dtype="bfloat16")


def _torch(x) -> torch.Tensor:
    """A JAX array as a torch tensor of the same dtype (bf16 or other)."""
    x = jnp.asarray(x)
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _bf16(rng, shape, scale=1.0):
    return jnp.asarray((scale * rng.standard_normal(shape)).astype(np.float32)).astype(jnp.bfloat16)


def _assert_bf16_matches(got, want, name, ulps=1.0, equal=0.99):
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, name
    same = float((got == want).float().mean())
    far = float(bf16_ulp_distance(got, want).max())
    assert same >= equal and far <= ulps, f"{name}: {same:.4f} equal, {far:.2f} ulps at most"


# ------------------------------------------------------------ kernel A


@pytest.mark.parametrize("m,s,d", [(700, 300, 40), (2000, 900, 16), (512, 200, 256)])
def test_sorted_segment_sum_plain_bf16_matches_jax(m, s, d):
    """Kernel A's plain version on bf16 data (empty segments included)
    against JAX's Pallas `sorted_segment_sum` in interpret mode."""
    rng = np.random.default_rng(m + d)
    ids = np.sort(rng.integers(0, s, m))
    data = _bf16(rng, (m, d))
    want = jax.jit(jax_sorted_segment_sum, static_argnums=2)(data, jnp.asarray(ids, jnp.int32), s)
    assert want.dtype == jnp.bfloat16
    got = sorted_segment_sum_plain(_torch(data), torch.from_numpy(ids), s)
    _assert_bf16_matches(got, _torch(want), "out")
    assert torch.all(got[torch.bincount(torch.from_numpy(ids), minlength=s) == 0] == 0)


# ------------------------------------------------------- kernels B and C


def _dpre(ui, ujn, dist, idx, wd, b0, w1, b1, dm):
    """dL/dpre [G, A, k, F] of the bf16 function, in f32, written out
    here: dz rounded to bf16, W1 rounded, f32 sums."""
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    g = torch.arange(ui.shape[0])[:, None, None]
    pre = ui.float()[:, :, None, :] + ujn.float()[g, idx] + dist.float()[..., None] * wd + b0
    z = r(torch.nn.functional.silu(pre)) @ r(w1) + b1
    s = torch.sigmoid(z)
    dz = dm.float() * s * (1 + z * (1 - s))
    sp = torch.sigmoid(pre)
    return (r(dz) @ r(w1).t()) * sp * (1 + pre * (1 - sp))


@pytest.mark.parametrize("g,a,k,f", [(3, 8, 5, 34), (2, 12, 16, 66)])
def test_edge_mlp_plain_bf16_matches_jax(g, a, k, f):
    """Kernel B's plain version and autograd through it (kernel C's plain
    version) against JAX's `fused_edge_messages` and its VJP on bf16 ui,
    ujn, dist and dm (30 % of dm's edges 0, as the model masks them)."""
    rng = np.random.default_rng(g * a + f)
    ui, ujn = _bf16(rng, (g, a, f)), _bf16(rng, (g, a, f))
    dist = jnp.asarray((4 * rng.random((g, a, k))).astype(np.float32)).astype(jnp.bfloat16)
    idx = jnp.asarray(rng.integers(0, a, (g, a, k)), jnp.int32)
    wd, b0 = (jnp.asarray((0.1 * rng.standard_normal(f)).astype(np.float32)) for _ in range(2))
    w1 = jnp.asarray((0.1 * rng.standard_normal((f, 16))).astype(np.float32))
    b1 = jnp.asarray((0.1 * rng.standard_normal(16)).astype(np.float32))
    dm = _bf16(rng, (g, a, k, 16)) * jnp.asarray(rng.random((g, a, k, 1)) < 0.7, jnp.bfloat16)
    params = (wd, b0, w1, b1)
    out, vjp = jax.vjp(lambda u, v, d, *p: jax_fused_edge_messages(u, v, d, idx, *p),
                       ui, ujn, dist, *params)
    want = vjp(dm)
    args = [_torch(ui), _torch(ujn), _torch(dist), _torch(idx).long(), *map(_torch, params)]
    got_out = fused_edge_messages_plain(*args)
    _assert_bf16_matches(got_out, _torch(out), "out")
    got = fused_edge_messages_bwd_plain(*args, _torch(dm))
    names = ("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1")
    for name, x, y in zip(names, got, map(_torch, want)):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        if name in ("dui", "ddist"):
            _assert_bf16_matches(x, y, name)
        elif name != "dujn":
            assert float((x - y).abs().max()) <= 1e-5 * float(y.abs().max()), name
    dpre = _dpre(*args, _torch(dm))
    rows = torch.arange(g)[:, None, None].expand(g, a, k).reshape(-1)
    flat = (rows * a + args[3].reshape(-1))
    own = torch.zeros(g * a, f).index_add_(0, flat, dpre.reshape(-1, f)).view(g, a, f)
    spread = torch.zeros(g * a, f).index_add_(0, flat, dpre.abs().reshape(-1, f)).view(g, a, f)
    dujn, jax_dujn = got[1], _torch(want[1])
    _assert_bf16_matches(dujn, own.to(torch.bfloat16), "dujn against its f32 sum", equal=0.95)
    top = float(jax_dujn.float().abs().max())
    ulp = torch.exp2(torch.floor(torch.log2(jax_dujn.float().abs().clamp(min=top / 256))) - 7)
    assert bool(((dujn.float() - jax_dujn.float()).abs() <= spread / 256 + ulp).all())


# ------------------------------------------------------------------ kNN


@pytest.mark.parametrize("scale", [0.5, 1.5, 6.0])
def test_knn_dense_bf16_matches_jax(scale):
    """`knn_dense` on bf16 slot positions (masked slots, two molecules a
    row) against JAX's: the same neighbour indices, masks and ranks, on
    rows where bf16 squared distances tie."""
    rng = np.random.default_rng(int(10 * scale))
    r, a, k = 40, 24, 16
    pos = jnp.asarray((scale * rng.standard_normal((r, a, 3))).astype(np.float32))
    pos = pos.astype(jnp.bfloat16)
    sm = rng.random((r, a)) < 0.8
    gid = (np.arange(a)[None, :] >= rng.integers(4, a, (r, 1))).astype(np.int32)
    want = jax.jit(lambda p: jax_knn_dense(p, jnp.asarray(sm), k, slot_gid=jnp.asarray(gid)))(pos)
    got = knn_dense(_torch(pos), torch.from_numpy(sm), k, slot_gid=torch.from_numpy(gid))
    assert torch.equal(got[0], _torch(want[0]).long())
    assert torch.equal(got[1], _torch(want[1]))
    assert got[2].dtype == torch.bfloat16 and torch.equal(got[2], _torch(want[2]))
    ranks = got[2][got[1]].float()
    assert len(torch.unique(ranks)) < 0.9 * len(ranks)  # ties are many


# -------------------------------------------------------------- the models


def _rel_l2(got: dict, want: dict, names) -> float:
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum()) for n in names)
    den = sum(float((want[n].double() ** 2).sum()) for n in names)
    return (num / den) ** 0.5


def _setup(method):
    """JAX's batch and the port's for 6 synthetic molecules (with
    coordinates for the EGNN models), and one set of numpy weights."""
    pos = method.startswith("egnn")
    samples = make_synthetic_dataset(6, seed=23, num_targets=1, with_pos=pos)
    jb = jax_batch(samples, jax_spec(samples, batch_size=8), pos)
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=pos)
    jm32 = jax_create_model(method, num_target=1, cfg=JaxModelConfig(**CFG))
    params, stats = random_variables(jm32, jb, 0)
    return samples, jb, tb, jm32, params, stats


def _port(method, cfg, params, stats):
    model = create_model(method, num_target=1, cfg=ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(params, model, batch_stats=stats))
    return model


def _port_run(model, tb):
    """(eval predictions, training-mode gradients of the masked MSE)."""
    with torch.no_grad():
        ev = model.eval()(tb)
    model.train()
    sq, cnt = masked_mse(model(tb), tb.y, tb.graph_mask)
    (sq / torch.clamp(cnt, min=1.0)).backward()
    return ev, {n: p.grad for n, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("method", METHODS)
def test_bf16_model_matches_jax(method):
    _, jb, tb, jm32, params, stats = _setup(method)
    jm16 = jax_create_model(method, num_target=1, cfg=JaxModelConfig(**BF16))
    ev32, _, _, g32, _ = jax_reference(jm32, jb, params, stats)
    ev16, _, _, g16, _ = jax_reference(jm16, jb, params, stats)
    model = _port(method, BF16, params, stats)
    ev, grads = _port_run(model, tb)
    ev_p32, grads_p32 = _port_run(_port(method, CFG, params, stats), tb)
    assert ev.dtype == torch.float32
    mask = tb.graph_mask.numpy()
    gap = float(np.abs(ev16 - ev32)[mask].max())
    err = float(np.abs(ev.numpy() - ev16)[mask].max())
    own = float(np.abs(ev.numpy() - ev_p32.numpy())[mask].max())
    assert err <= 2.0 * gap, f"predictions: {err:.3e} > 2 x the gap {gap:.3e}"
    assert own >= 0.3 * gap, f"predictions: the port's own bf16 change {own:.3e}, the gap {gap:.3e}"

    want16 = params_from_jax(g16, model, batch_stats=stats or None)
    want32 = params_from_jax(g32, model, batch_stats=stats or None)
    reached = [n for n, _ in model.named_parameters() if float(want16[n].abs().max()) > 0]
    for name in reached:
        assert name in grads and float(grads[name].abs().max()) > 0, name
    for name in set(grads) - set(reached):
        assert float(grads[name].abs().max()) == 0, name
    gap = _rel_l2(want16, want32, reached)
    err = _rel_l2(grads, want16, reached)
    own = _rel_l2(grads, grads_p32, reached)
    assert err <= 1.5 * gap, f"gradients: {err:.3e} > 1.5 x the gap {gap:.3e}"
    assert own >= 0.3 * gap, f"gradients: the port's own bf16 change {own:.3e}, the gap {gap:.3e}"


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [leaf for d in sorted(x) for leaf in _leaves(x[d])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


@pytest.mark.parametrize("method", METHODS)
def test_bf16_dtypes_match_jax_at_every_module_boundary(method):
    """The dtype and shape of each output of every module JAX's model and
    the port share (`capture_intermediates` against forward hooks, every
    call of a shared module), in the eval forward."""
    _, jb, tb, _, params, stats = _setup(method)
    jm16 = jax_create_model(method, num_target=1, cfg=JaxModelConfig(**BF16))
    variables = {"params": _unflat(params), **({"batch_stats": _unflat(stats)} if stats else {})}
    _, state = jax.jit(lambda v: jm16.apply(v, jb, deterministic=True, capture_intermediates=True,
                                            mutable=["intermediates"]))(variables)
    inter = traverse_util.flatten_dict(state["intermediates"], sep="/")
    want = {k[:-len("/__call__")].replace("/", "."): v for k, v in inter.items()}
    model = _port(method, BF16, params, stats).eval()
    got, hooks = {}, []
    for name, module in model.named_modules():
        hooks.append(module.register_forward_hook(
            lambda m, i, o, name=name: got.setdefault(name, []).append(o)))
    with torch.no_grad():
        model(tb)
    for h in hooks:
        h.remove()
    shared = sorted(set(want) & set(got))
    # JAX's LayerNorm module returns f32 and its caller casts
    # (`nn/egnn.py:190-195`); the port's `LayerNorm` casts itself
    cast_by_caller = {"egnn_layer.node_norm"}
    assert len(shared) > 20 and "trunk.mlp_out" in shared
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    seen = set()
    for name in shared:
        jl, tl = _leaves(list(want[name])), _leaves(got[name])
        assert len(jl) == len(tl), name
        for j, t in zip(jl, tl):
            expect = dt[jnp.dtype(j.dtype).type]
            if name in cast_by_caller:
                assert expect == torch.float32, name
                expect = torch.bfloat16
            assert t.dtype == expect and tuple(t.shape) == j.shape, (
                name, t.dtype, j.dtype, tuple(t.shape), j.shape)
            seen.add(t.dtype)
    assert seen == {torch.float32, torch.bfloat16}


def test_bf16_model_has_the_f32_parameters():
    """`params_from_jax` maps one flax tree into the float32 and the
    bfloat16 model alike: the same keys, shapes and float32 values."""
    _, _, _, _, params, stats = _setup("egnn_equihnnm")
    a = _port("egnn_equihnnm", CFG, params, stats).state_dict()
    b = _port("egnn_equihnnm", BF16, params, stats).state_dict()
    assert list(a) == list(b)
    for k in a:
        assert b[k].dtype == a[k].dtype and torch.equal(a[k], b[k]), k
    assert all(v.dtype != torch.bfloat16 for v in b.values())


def test_mhnns_bf16_adam_step_matches_jax():
    """One Adam step of `mhnns` in bf16 against the JAX trainer's step
    (weight decay 0). Adam's first step moves an element by lr·sign(g): the
    loss within 1e-2, every element moved by at most lr in both, and where
    the port's gradient (an independent backward of the same model) and
    JAX's bf16 gradient agree in sign, as they do on at least 95 % of the
    elements (measured 97.9 %; bf16 rounding decides the rest), the same
    move within 1e-2·lr."""
    samples, jb, tb, _, params, stats = _setup("mhnns")
    jm16 = jax_create_model("mhnns", num_target=1, cfg=JaxModelConfig(**BF16))
    lr = 1e-3
    jt = JaxTrainer(jm16, JaxTrainConfig(lr=lr, weight_decay=0.0, seed=0), jb, std=1.0)
    jp = _unflat(params)
    jp, _, _, jloss, _ = jt._step_fn(jp, jt.tx.init(jp), {}, jb, np.float32(lr),
                                     jax.random.PRNGKey(1))
    model = _port("mhnns", BF16, params, stats)
    g16 = params_from_jax(jax_reference(jm16, jb, params, stats)[3], model)
    _, own = _port_run(_port("mhnns", BF16, params, stats), tb)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    tt = Trainer(model, TrainConfig(lr=lr, weight_decay=0.0, seed=0), std=1.0, device="cpu")
    np.testing.assert_allclose(float(tt.train_step(tb)), float(jloss), rtol=1e-2)
    want = params_from_jax(_flat(jp), model)
    got = model.state_dict()
    agree = total = 0
    for name, w in want.items():
        same = torch.sign(own[name]) == torch.sign(g16[name])
        agree, total = agree + int(same.sum()), total + same.numel()
        for moved in (got[name] - start[name], w - start[name]):
            assert bool((moved.abs() <= lr * (1 + 1e-3)).all()), name
        np.testing.assert_allclose(got[name][same].numpy(), w[same].numpy(), atol=1e-2 * lr,
                                   rtol=0, err_msg=name)
    assert agree >= 0.95 * total, f"{agree} of {total} gradient signs agree"


@pytest.mark.parametrize("method,data", [("mhnns", "synthetic_hg"),
                                         ("egnn_equihnns", "synthetic_hg_3d")])
def test_bf16_trains_through_the_cli_and_serves(tmp_path, monkeypatch, method, data):
    """`main.run --compute_dtype bfloat16` on the CPU; the checkpoint keeps
    the compute dtype and float32 weights, and `predict.run` serves it in
    bf16 from the SDF: finite predictions, the model's own on the batch."""
    from equihgnn_tpu_torch.main import build_parser, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import load_checkpoint
    from equihgnn_tpu_torch.predict import run as predict_run

    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args([
        "--data", data, "--method", method, "--device", "cpu", "--synthetic_size", "24",
        "--synthetic_max_atoms", "9", "--batch_size", "8", "--epochs", "2",
        "--MLP_hidden", "16", "--output_hidden", "8", "--compute_dtype", "bfloat16"])
    res = run(args)
    losses = [h["train_loss"] for h in res["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpt = str(tmp_path / res["log_dir"] / "ckpt_best.pt")
    meta, state = load_checkpoint(ckpt)
    assert meta["model_config"]["compute_dtype"] == "bfloat16"
    assert all(v.dtype != torch.bfloat16 for v in state.values())
    out = str(tmp_path / "preds.csv")
    predict_run(predict_parser().parse_args(["--ckpt", ckpt, "--sdf", SDF, "--out", out,
                                             "--device", "cpu"]))
    with open(out) as f:
        vals = np.array([float(r["prediction"]) for r in csv.DictReader(f)])
    assert len(vals) == 20 and np.isfinite(vals).all()


@pytest.mark.parametrize("method", ["mhnns", "egnn_equihnns", "faformer_equihnns"])
def test_predict_compute_dtype_flag(tmp_path, method):
    """`predict.run --compute_dtype bfloat16` serves a float32 checkpoint in
    bf16: the predictions of the model built in bf16 with the checkpoint's
    weights, bit for bit (the weights are float32 in both), and without the
    flag the checkpoint's own f32 model's (FAFormer's bf16 path:
    `tests/test_torch_faformer_bf16.py`)."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.predict import (build_parser, featurize_sdf, load_checkpoint,
                                            predict_samples, run, save_checkpoint)

    cpu = torch.device("cpu")
    cfg = ModelConfig(**CFG)
    model = create_model(method, num_target=1, cfg=cfg, generator=torch.Generator().manual_seed(0))
    ckpt = save_checkpoint(str(tmp_path / "model.pt"), model, method, cfg)
    args = ["--ckpt", ckpt, "--sdf", SDF, "--device", "cpu"]
    samples = [s for _, s in featurize_sdf(SDF, True, method.startswith(("egnn", "faformer")))]
    _, state = load_checkpoint(ckpt)
    got = {}
    for dtype in ("bfloat16", None):
        out = str(tmp_path / f"{dtype}.csv")
        run(build_parser().parse_args(args + ["--out", out] +
                                      (["--compute_dtype", dtype] if dtype else [])))
        with open(out) as f:
            got[dtype] = np.array([float(r["prediction"]) for r in csv.DictReader(f)])
        ref = create_model(method, num_target=1, cfg=ModelConfig(**CFG, compute_dtype=dtype))
        ref.load_state_dict(state)
        want = predict_samples(ref.eval(), samples, 256, cpu)
        assert np.array_equal(got[dtype], want), dtype
    assert not np.array_equal(got["bfloat16"], got[None])
