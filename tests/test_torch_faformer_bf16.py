"""The FAFormer models with `compute_dtype="bfloat16"` in the port against
the JAX package's bfloat16 FAFormer, on the CPU, and the plain bfloat16
versions of kernels D and E against JAX's Pallas `fused_frame_swiglu` in
bfloat16 (interpret mode), which JAX's bf16 FAFormer runs (its x bf16,
computed in f32, out rounded once; the backward's dx rounded once, the
parameter gradients f32).

Tolerances, each stated against what the two frameworks round:

  * the plain bf16 D and E against JAX's fused function on bf16 x at C = 3
    and 4, H/2 = 32 and 128, dropout 0: out and dx within one bf16 ulp
    (`bf16_ulp_distance`) and at least 99 % the same bits (measured: all
    the same bits, f32 sums in other orders aside), the f32 parameter
    gradients per tensor within 1e-5 of max|JAX| (measured at most 5.8e-7);
  * `_SwiGLU`, `_FrameSwiGLU`, `EdgeModule`, `FAFFN` and
    `MLPAttnEdgeAggregation` at matched weights on bf16 inputs: within one
    ulp, at least 99 % the same bits (measured: the same bits), where the
    port rounds as XLA's CPU backend rounds JAX's bf16 modules
    (`nn/faformer.py`'s docstring lists the points);
  * the 2-layer FAFormer encoder: its token and coordinate outputs within
    0.5x of JAX's own bf16-vs-f32 distance ("the gap", max over the real
    atoms, against the port's f32 run; measured: tokens 0.16x and 0.29x,
    coordinates the same bits, on two batches): a frame whose
    covariance is nearly degenerate is decided by f32 rounding in both
    frameworks (ROADMAP §3), and one such neighbourhood moves the layers
    after it;
  * the three models (`faformer_equihnns`, `faformer_equihnn`,
    `faformer_equihnnm`) at matched weights, in eval mode (JAX's
    deterministic call, where its custom VJP runs the Pallas backward):
    predictions within 1.5x the gap's max over the molecules, and for
    equihnns and equihnnm gradients of the masked MSE as relative L2 over
    all parameters within 1.5x the gap's (the gap against the port's f32
    run, which `tests/test_torch_faformer.py` and
    `tests/test_torch_hybrid_faformer.py` hold to JAX's f32 model;
    measured: predictions 0.14x, 0.19x and 0.30x for equihnns, equihnn and
    equihnnm, gradients 0.36x and 0.13x for equihnns and equihnnm); that
    the port computes in bf16 at all: its own bf16-vs-f32 distance at least
    0.3x the gap; every module's output has JAX's dtype; every parameter
    JAX reaches is reached; the parameters stay float32.

JAX is jitted: interpret-mode Pallas run eagerly is ~5x slower.
"""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_bf16_hypergraph import _assert_bf16_matches, _leaves, _rel_l2, _torch
from test_torch_faformer import _dense_inputs, _fs_inputs, _port, _random_params, _t
from test_torch_faformer import _unflat as _unflat_params
from test_torch_mhnn import CFG, _flat, _unflat, jax_batch, random_variables

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.nn import faformer as jfa
from equihgnn_tpu.ops.pallas.frame_swiglu import fused_frame_swiglu as jax_fused
from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import faformer as tfa
from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
    frame_swiglu_bwd_plain,
    frame_swiglu_plain,
    fused_frame_swiglu,
    fused_frame_swiglu_bwd,
)
from equihgnn_tpu_torch.train.trainer import masked_mse

torch.set_num_threads(1)

SDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "datasets", "real_sample",
                   "sample.sdf")
METHODS = ("faformer_equihnns", "faformer_equihnn", "faformer_equihnnm")
BF16 = dict(CFG, compute_dtype="bfloat16")
GEN = dict(generator=torch.Generator().manual_seed(0))
BF = jnp.bfloat16


# ----------------------------------------------------- kernels D and E, plain


@pytest.mark.parametrize("p,c,h", [(37, 4, 64), (21, 3, 64), (45, 4, 256), (29, 3, 256)])
def test_plain_bf16_frame_swiglu_matches_the_pallas_kernels(p, c, h):
    """JAX's bf16 FAFormer calls `fused_frame_swiglu` on bf16 x with f32
    parameters; the port's plain bf16 D (forward) and E (autograd through
    it, and `frame_swiglu_bwd_plain`) give its bits or one ulp."""
    x, w1, b1, ls, lb = _fs_inputs(p, c, h, seed=p + c)
    xb = jnp.asarray(x).astype(BF)
    dout = jnp.asarray(np.random.default_rng(p).standard_normal((p, h // 2)).astype(np.float32)
                       ).astype(BF)
    params = tuple(map(jnp.asarray, (w1, b1, ls, lb)))

    @jax.jit
    def run(xv, *ps):
        out, vjp = jax.vjp(jax_fused, xv, *ps)
        return (out, *vjp(dout))

    want = [_torch(t) for t in run(xb, *params)]
    assert want[0].dtype == want[1].dtype == torch.bfloat16
    tx, tp = _torch(xb), [_t(a) for a in (w1, b1, ls, lb)]
    leaves = [tx.clone().requires_grad_()] + [t.clone().requires_grad_() for t in tp]
    out = fused_frame_swiglu(*leaves)
    out.backward(_torch(dout))
    got = [out.detach()] + [t.grad for t in leaves]
    written = frame_swiglu_bwd_plain(tx, *tp, _torch(dout))
    assert torch.equal(got[0], frame_swiglu_plain(tx, *tp))
    for name, x1, x2 in zip(("dx", "dw1", "db1", "dls", "dlb"), got[1:], written):
        assert x1.dtype == x2.dtype and torch.equal(x1, x2), name
    for name, x1, y in zip(("out", "dx", "dw1", "db1", "dls", "dlb"), got, want):
        if name in ("out", "dx"):
            _assert_bf16_matches(x1, y, name, equal=0.99)
            continue
        assert x1.dtype == y.dtype == torch.float32, name
        err, scale = float((x1 - y).abs().max()), float(y.abs().max())
        assert err <= 1e-5 * scale + 1e-7, f"{name}: {err:.3e} of {scale:.3e}"


def test_wrappers_take_the_plain_bf16_path_on_the_cpu_and_refuse_other_dtypes():
    """bf16 x with f32 parameters on the CPU: the plain bf16 version, no
    launch counted, x's gradient bf16 and the parameters' f32; bf16
    parameters, a float16 or float64 x, and a dout of another dtype raise
    TypeError; kernel E's entry takes CUDA tensors only."""
    x, w1, b1, ls, lb = (_t(a) for a in _fs_inputs(23, 4, 64, seed=3))
    xb = x.to(torch.bfloat16)
    counts = [(f.launches, f.launches_bf16) for f in (fused_frame_swiglu, fused_frame_swiglu_bwd)]
    leaf = xb.clone().requires_grad_()
    out = fused_frame_swiglu(leaf, w1, b1, ls, lb)
    assert out.dtype == torch.bfloat16 and torch.equal(out, frame_swiglu_plain(xb, w1, b1, ls, lb))
    out.float().sum().backward()
    assert leaf.grad.dtype == torch.bfloat16
    assert [(f.launches, f.launches_bf16)
            for f in (fused_frame_swiglu, fused_frame_swiglu_bwd)] == counts
    for bad in (dict(w1=w1.to(torch.bfloat16)), dict(ls=ls.to(torch.bfloat16)),
                dict(x=x.half()), dict(x=x.double()), dict(b1=b1.double())):
        args = {**dict(x=xb, w1=w1, b1=b1, ls=ls, lb=lb), **bad}
        with pytest.raises(TypeError, match="frame_swiglu takes"):
            fused_frame_swiglu(**args)
    with pytest.raises(TypeError, match="dout in x's dtype"):
        frame_swiglu_bwd_plain(xb, w1, b1, ls, lb, torch.zeros(23, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        fused_frame_swiglu_bwd(xb, w1, b1, ls, lb, torch.zeros(23, 32, dtype=torch.bfloat16))


# ------------------------------------------------------------ the modules


def _bf16_args(*arrays):
    return tuple(jnp.asarray(a).astype(BF) for a in arrays)


def _rounded(t):
    """A module output as JAX's caller sees it: the port's unrounded f32
    outputs (below f32) rounded to bf16."""
    return t.to(torch.bfloat16) if t.dtype == torch.float32 else t


def _module_case(name):
    """(JAX module, its bf16 args, the port's module, its args): the
    modules at hidden 16 on the dense inputs of `tests/test_torch_faformer.py`."""
    token, geo, idx, nmask, mask, edge = _dense_inputs(seed=2)
    d = token.shape[-1]
    ji, jn, jm = jnp.asarray(idx, jnp.int32), jnp.asarray(nmask), jnp.asarray(mask)
    ti, tn, tm = _t(idx), _t(nmask), _t(mask)
    tb, gb, eb = _bf16_args(token, geo, edge)
    if name == "_SwiGLU":
        x = _bf16_args(np.random.default_rng(0).standard_normal((3, 5, 7, 16)))[0]
        return jfa._SwiGLU(32, 16), (x,), tfa._SwiGLU(16, 32, 16, **GEN), (_torch(x),)
    if name.startswith("_FrameSwiGLU"):
        c = int(name[-1])
        x = _bf16_args(np.random.default_rng(c).standard_normal((3, 5, c)))[0]
        return (jfa._FrameSwiGLU(32, 12, drop=0.1), (x,),
                tfa._FrameSwiGLU(c, 32, 12, drop=0.1, **GEN), (_torch(x),))
    if name == "EdgeModule":
        return (jfa.EdgeModule(d, d, proj_drop=0.1, activation="swiglu"), (tb, gb, ji, jn),
                tfa.EdgeModule(d, d, 0.1, "swiglu", **GEN), (_torch(tb), _torch(gb), ti, tn))
    if name == "FAFFN":
        return (jfa.FAFFN(d, proj_drop=0.1, activation="swiglu"), (tb, gb, jm),
                tfa.FAFFN(d, 0.1, "swiglu", dtype=torch.bfloat16, **GEN),
                (_torch(tb), _torch(gb), tm))
    nh = int(name[-1])
    return (jfa.MLPAttnEdgeAggregation(d, d, nh, 0.1, 0.1, "swiglu"), (tb, gb, eb, ji, jn, jm),
            tfa.MLPAttnEdgeAggregation(d, d, nh, 0.1, 0.1, "swiglu", dtype=torch.bfloat16, **GEN),
            (_torch(tb), _torch(gb), _torch(eb), ti, tn, tm))


@pytest.mark.parametrize("name", ["_SwiGLU", "_FrameSwiGLU C=3", "_FrameSwiGLU C=4",
                                  "EdgeModule", "FAFFN", "MLPAttnEdgeAggregation nh=2",
                                  "MLPAttnEdgeAggregation nh=1"])
def test_bf16_module_matches_jax(name):
    """Each module on bf16 inputs against JAX's bf16 module at the same
    weights: the same bits or one ulp."""
    jm, jargs, tm, targs = _module_case(name)
    flat = _random_params(jm, *jargs)
    tm = _port(tm, flat)
    want = jax.jit(lambda v: jm.apply(v, *jargs))(_unflat_params(flat))
    with torch.no_grad():
        got = tm(*targs)
    want, got = _leaves(want), _leaves(got)
    assert len(want) == len(got)
    for j, t in zip(want, got):
        _assert_bf16_matches(_rounded(t), _torch(j), name, equal=0.99)


def _faformer_case(seed):
    """JAX's and the port's FAFormer at hidden 32 with 2 layers and matched
    weights, and their inputs: a batch of 6 synthetic molecules, bf16
    features and positions."""
    samples = make_synthetic_dataset(6, seed=seed, num_targets=1)
    jb = jax.tree.map(jnp.asarray, jax_pad(samples, jax_spec(samples, batch_size=8), target=0,
                                           with_pos=True))
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=True)
    d = 32
    feats = np.random.default_rng(5).standard_normal((jb.atom_feat.shape[0], d))
    kw = dict(d_input=d, d_model=d, d_edge_model=d, n_layers=2, n_heads=2, n_neighbors=16,
              valid_radius=5.0, activation="swiglu")
    jm = jfa.FAFormer(**kw)
    gid = jb.atom_graph_id if jb.atom_row is None else jb.atom_row
    fb, pb = _bf16_args(feats, jb.pos)
    jargs = (fb, pb, gid, jb.slot_index, jb.slot_mask, jb.atom_slot)
    jkw = dict(slot_gid=jb.slot_gid, num_graphs=jb.num_graphs)
    flat = _random_params(jm, *jargs, **jkw)
    tm, tm32 = (_port(tfa.FAFormer(**kw, dtype=dt, **GEN), flat) for dt in ("bfloat16", None))
    targs = (_torch(fb), _torch(pb), tb.atom_row, tb.slot_index, tb.slot_mask, tb.atom_slot)
    return jm, jargs, jkw, flat, tm, tm32, targs, np.asarray(jb.atom_mask)


@pytest.mark.parametrize("seed", [23, 7])
def test_bf16_faformer_encoder_matches_jax(seed):
    """The 2-layer FAFormer in bf16 against JAX's: tokens and coordinates
    within 0.5x of the gap (against the port's f32 run, which
    `tests/test_torch_faformer.py` holds to JAX's f32 FAFormer); the port
    computes in bf16 (its own bf16-vs-f32 change at least 0.3x the gap);
    bf16 outputs, f32 parameters."""
    jm, jargs, jkw, flat, tm, tm32, targs, mask = _faformer_case(seed)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, **jkw))(_unflat_params(flat), *jargs)
    with torch.no_grad():
        got = tm(*targs)
        got32 = tm32(targs[0].float(), targs[1].float(), *targs[2:])
    m = torch.from_numpy(mask)
    for name, t, t32, j in zip(("token", "coords"), got, got32, want):
        assert t.dtype == torch.bfloat16 and t32.dtype == torch.float32, name
        j, t, t32 = _torch(j).double()[m], t.double()[m], t32.double()[m]
        gap = float((j - t32).abs().max())
        err = float((t - j).abs().max())
        own = float((t - t32).abs().max())
        print(f"encoder seed {seed} {name}: {err / gap:.3f}x the gap, own {own / gap:.3f}x")
        assert err <= 0.5 * gap, f"{name}: {err:.3e} > 0.5 x the gap {gap:.3e}"
        assert own >= 0.3 * gap, f"{name}: the port's own bf16 change {own:.3e}, gap {gap:.3e}"
    assert all(p.dtype == torch.float32 for p in tm.parameters())


# -------------------------------------------------------------- the models


def _ported(method, cfg, params, stats):
    model = create_model(method, num_target=1, cfg=ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(params, model, batch_stats=stats))
    return model


# the models whose gradients are held to JAX's; faformer_equihnn's
# predictions only (its encoder is equihnns', and TrunkFull's bf16 gradients
# are held in `tests/test_torch_bf16_hypergraph.py`): JAX's jitted gradient
# through the interpreted Pallas kernels takes ~13 s more a model to compile
GRAD_METHODS = ("faformer_equihnns", "faformer_equihnnm")


@pytest.fixture(scope="module", params=METHODS)
def model_runs(request):
    """One method's JAX bf16 run in eval mode, jitted once: predictions,
    every module's outputs (`capture_intermediates`) and, for GRAD_METHODS,
    the masked-MSE gradients; and the port's bf16 and f32 runs at the same
    weights in eval mode."""
    method = request.param
    samples = make_synthetic_dataset(6, seed=23, num_targets=1, with_pos=True)
    jb = jax_batch(samples, jax_spec(samples, batch_size=8), True)
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=True)
    jm16 = jax_create_model(method, num_target=1, cfg=JaxModelConfig(**BF16))
    params, stats = random_variables(jm16, jb, 0)
    variables = {"params": _unflat(params), **({"batch_stats": _unflat(stats)} if stats else {})}

    def loss(p):
        out, state = jm16.apply({**variables, "params": p}, jb, deterministic=True,
                                capture_intermediates=True, mutable=["intermediates"])
        sq, cnt = jax_masked_mse(out, jb.y, jb.graph_mask)
        return sq / jnp.maximum(cnt, 1.0), (out, state)

    if method in GRAD_METHODS:
        (_, (pred16, state)), g16 = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            variables["params"])
    else:
        (_, (pred16, state)), g16 = jax.jit(loss)(variables["params"]), None
    inter = traverse_util.flatten_dict(state["intermediates"], sep="/")
    shapes = {k[:-len("/__call__")].replace("/", "."): v for k, v in inter.items()}

    def run(model):
        out = model(tb)
        sq, cnt = masked_mse(out, tb.y, tb.graph_mask)
        (sq / torch.clamp(cnt, min=1.0)).backward()
        return out.detach(), {n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None}

    model16 = _ported(method, BF16, params, stats).eval()
    return dict(method=method, tb=tb, params=params, stats=stats, model16=model16,
                port16=run(model16), port32=run(_ported(method, CFG, params, stats).eval()),
                pred16=np.asarray(pred16), shapes=shapes,
                g16=None if g16 is None else params_from_jax(_flat(g16), model16,
                                                             batch_stats=stats or None))


def test_bf16_model_matches_jax(model_runs):
    """Predictions, and for GRAD_METHODS the gradients, against JAX's bf16
    model, each within 1.5x the gap."""
    r = model_runs
    (pred, grads), (pred32, grads32) = r["port16"], r["port32"]
    assert pred.dtype == torch.float32
    mask = r["tb"].graph_mask.numpy()
    gap = float(np.abs(r["pred16"] - pred32.numpy())[mask].max())
    err = float(np.abs(pred.numpy() - r["pred16"])[mask].max())
    own = float(np.abs(pred.numpy() - pred32.numpy())[mask].max())
    assert err <= 1.5 * gap, f"predictions: {err:.3e} > 1.5 x the gap {gap:.3e}"
    assert own >= 0.3 * gap, f"predictions: the port's own bf16 change {own:.3e}, the gap {gap:.3e}"
    print(f"{r['method']}: predictions {err / gap:.3f}x the gap (own {own / gap:.3f}x)")
    if r["g16"] is None:
        return

    model, want = r["model16"], r["g16"]
    reached = [n for n, _ in model.named_parameters() if float(want[n].abs().max()) > 0]
    for name in reached:
        assert name in grads and float(grads[name].abs().max()) > 0, name
    for name in set(grads) - set(reached):
        assert float(grads[name].abs().max()) == 0, name
    assert {"fa_former.layers_0.edge_module.coord_mlp.fc1.weight",
            "fa_former.layers_1.ffn.W_frame.fc1.weight",
            "atom_encoder.atom.embedding"} <= set(reached)
    ggap = _rel_l2(want, grads32, reached)
    gerr = _rel_l2(grads, want, reached)
    gown = _rel_l2(grads, grads32, reached)
    print(f"{r['method']}: gradients {gerr / ggap:.3f}x the gap (own {gown / ggap:.3f}x)")
    assert gerr <= 1.5 * ggap, f"gradients: {gerr:.3e} > 1.5 x the gap {ggap:.3e}"
    assert gown >= 0.3 * ggap, f"gradients: the port's own bf16 change {gown:.3e}, gap {ggap:.3e}"


# modules whose output the port keeps unrounded (f32) below f32, where JAX's
# is bf16 and XLA reads it unrounded in the consumers that cast it to f32;
# the callers round it where JAX's ops read it rounded
UNROUNDED = ("edge_module", "self_attn", "layers_")


def test_bf16_dtypes_match_jax_at_every_module_boundary(model_runs):
    """The dtype and shape of each output of every module JAX's model and
    the port share, in the eval forward (the UNROUNDED modules: f32 where
    JAX's is bf16); and the bf16 model's parameters are the f32 model's,
    float32."""
    r = model_runs
    model = r["model16"]
    got, hooks = {}, []
    for name, module in model.named_modules():
        hooks.append(module.register_forward_hook(
            lambda m, i, o, name=name: got.setdefault(name, []).append(o) and None))
    with torch.no_grad():
        model(r["tb"])
    for h in hooks:
        h.remove()
    want = r["shapes"]
    shared = sorted(set(want) & set(got))
    assert len(shared) > 40 and "trunk" in shared and "fa_former" in shared
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.int32: torch.int64}
    seen = set()
    for name in shared:
        jl = [j for j in _leaves(list(want[name])) if j is not None]
        tl = [t for t in _leaves(got[name]) if t is not None]
        assert len(jl) == len(tl), name
        for j, t in zip(jl, tl):
            expect = dt[jnp.dtype(j.dtype).type]
            if name.startswith("fa_former.") and name.split(".")[-1].startswith(UNROUNDED):
                assert expect == torch.bfloat16, name
                expect = torch.float32
            assert t.dtype == expect and tuple(t.shape) == j.shape, (
                name, t.dtype, j.dtype, tuple(t.shape), j.shape)
            seen.add(t.dtype)
    assert seen == {torch.float32, torch.bfloat16}
    a, b = (_ported(r["method"], cfg, r["params"], r["stats"]).state_dict() for cfg in (CFG, BF16))
    assert list(a) == list(b)
    for k in a:
        assert b[k].dtype == a[k].dtype and torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------- the CLIs


@pytest.mark.parametrize("method", METHODS)
def test_bf16_faformer_trains_through_the_cli_and_serves(tmp_path, monkeypatch, method):
    """`main.run --compute_dtype bfloat16` on the CPU: finite losses; the
    checkpoint keeps the compute dtype and float32 weights;
    `predict.run --compute_dtype bfloat16` serves `ckpt_best.pt` from the
    SDF: 20 finite predictions, those of the bf16 model built from the
    checkpoint (times the target's scale), bit for bit."""
    from equihgnn_tpu_torch.main import build_parser, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import featurize_sdf, load_checkpoint, predict_samples
    from equihgnn_tpu_torch.predict import run as predict_run

    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args([
        "--data", "synthetic_hg_3d", "--method", method, "--device", "cpu",
        "--synthetic_size", "24", "--synthetic_max_atoms", "9", "--batch_size", "8",
        "--epochs", "2", "--MLP_hidden", "16", "--output_hidden", "8",
        "--compute_dtype", "bfloat16"])
    res = run(args)
    losses = [h["train_loss"] for h in res["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ckpt = str(tmp_path / res["log_dir"] / "ckpt_best.pt")
    meta, state = load_checkpoint(ckpt)
    assert meta["model_config"]["compute_dtype"] == "bfloat16"
    assert all(v.dtype != torch.bfloat16 for v in state.values())
    out = str(tmp_path / "preds.csv")
    predict_run(predict_parser().parse_args(["--ckpt", ckpt, "--sdf", SDF, "--out", out,
                                             "--device", "cpu", "--compute_dtype", "bfloat16"]))
    with open(out) as f:
        vals = np.array([float(r["prediction"]) for r in csv.DictReader(f)])
    assert len(vals) == 20 and np.isfinite(vals).all()
    model = create_model(method, num_target=1, cfg=ModelConfig(**meta["model_config"]))
    model.load_state_dict(state)
    samples = [s for _, s in featurize_sdf(SDF, True, True)]
    want = predict_samples(model.eval(), samples, 256, torch.device("cpu"))
    assert np.array_equal(vals, want * float(meta.get("std", 1.0)))
