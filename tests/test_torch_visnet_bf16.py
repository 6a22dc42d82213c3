"""The ViSNet models with `compute_dtype="bfloat16"` in the port against the
JAX package's bfloat16 ViSNet, on the CPU, and the plain bfloat16 versions
of kernels F-I against JAX's Pallas `vis_mix` kernels in bfloat16
(interpret mode), which JAX's ViSNet runs below float32.

Tolerances, each stated against what the two frameworks round:

  * the plain bf16 F-I (`vec_agg_plain`, `vec_agg_bwd_plain`, `wdot_plain`,
    `wdot_bwd_plain`) against JAX's `_vec_agg` / `_wdot` custom VJPs on
    bf16 inputs at A % 8 = 0, L = 8 and 3, h = 16 and 256 (two h blocks of
    JAX's grid, whose dd it sums over both), and with up to 8·k edges on
    one source slot and slots that are no edge's source (the per-source
    walk of kernels G and I; h = 16 and 64): every output and gradient
    within one bf16 ulp (`bf16_ulp_distance`) and at least 99 % the same
    bits (measured: 99.89-100 %; the f32 sums run in other orders);
  * at A % 8 ≠ 0, where JAX's gate sends bf16 to the XLA composition
    `_xla_mix` (which rounds every product and partial sum to bf16) and
    the port still computes the kernels' function (one rounding of an f32
    sum): both within 2^-5 of max |f32| of the f32 function on the same
    bf16 inputs, per tensor, forward and gradients (JAX's composition
    rounds ~L + 2 times, each within 2^-9; measured: JAX 2^-7.1, the port
    2^-8.2), and the port nearer to it than JAX in L2;
  * the ViSNet block with 2 layers and the three models
    (`visnet_equihnns`, `visnet_equihnn`, `visnet_equihnnm`) at matched
    weights (numpy draws converted by `params_from_jax`), against JAX's
    bf16 run in training mode (dropout 0): its bf16-vs-f32 distance ("the
    gap") is taken against the port's f32 run, which
    `tests/test_torch_visnet.py` and `tests/test_torch_hybrid_visnet.py`
    hold to JAX's f32 model within 1e-4 of the gradients' max (JAX's f32
    compile would double this file's time). Predictions within 2x the
    gap's max over the molecules, gradients of the masked MSE as relative
    L2 over all parameters within 1.5x the gap's (the bounds of
    `tests/test_torch_bf16_hypergraph.py`; measured: predictions 0.00-0.07x,
    gradients 0.02-0.11x, the port rounding where XLA's CPU backend rounds:
    SiLU op by op, LayerNorms reading the unrounded residual sum). That the
    port computes in bf16 at all: its own bf16-vs-f32 distance at least
    0.3x the gap (measured ~1.0x), and every module's output has JAX's
    dtype (`capture_intermediates` of `jax.eval_shape` against forward
    hooks); every parameter JAX reaches is reached; the parameters stay
    float32.

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
from test_torch_mhnn import CFG, _flat, _unflat, jax_batch, random_variables
from test_torch_visnet import _random_params, _visnet_args

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.nn import visnet as jvis
from equihgnn_tpu.ops.pallas.vis_mix import _vec_agg, _wdot, _xla_mix, vis_mix_supported
from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import visnet as tvis
from equihgnn_tpu_torch.ops.kernels.vis_mix import (
    vec_agg_bwd_plain,
    vec_agg_plain,
    vis_vec_agg,
    vis_vec_agg_bwd,
    vis_wdot,
    vis_wdot_bwd,
    wdot_bwd_plain,
    wdot_plain,
)
from equihgnn_tpu_torch.train.trainer import masked_mse

torch.set_num_threads(1)

SDF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "datasets", "real_sample",
                   "sample.sdf")
METHODS = ("visnet_equihnns", "visnet_equihnn", "visnet_equihnnm")
BF16 = dict(CFG, compute_dtype="bfloat16")
MIX_NAMES = ("vec_agg", "dvec", "ds1", "ds2m", "dd (G)", "w_dot", "dd (I)", "du", "dvv")


# ----------------------------------------------------- kernels F-I, plain


def _mix_inputs(g, a, k, L, h, seed):
    """bf16 vec, s1, s2m (masked), d, u, vv and the output gradients gva, gw;
    int indices and a mask with masked edges and an empty last row."""
    rng = np.random.default_rng(seed)

    def bf(*shape):
        return jnp.asarray(rng.standard_normal(shape).astype(np.float32)).astype(jnp.bfloat16)

    vec, u, vv, gva = bf(g, a, L, h), bf(g, a, L, h), bf(g, a, L, h), bf(g, a, L, h)
    s1, s2, gw, d = bf(g, a, k, h), bf(g, a, k, h), bf(g, a, k, h), bf(g, a, k, L)
    idx = rng.integers(0, a, (g, a, k))
    mask = rng.random((g, a, k)) > 0.25
    mask[-1] = False
    s2m = (s2 * jnp.asarray(mask)[..., None]).astype(jnp.bfloat16)
    return (vec, s1, s2m, d, u, vv, gva, gw), idx, mask


def _port_mix(args, idx, mask):
    """The port's plain bf16 F-I: (vec_agg, dvec, ds1, ds2m, dd of G, w_dot,
    dd of I, du, dvv)."""
    vec, s1, s2m, d, u, vv, gva, gw = map(_torch, args)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    return (vec_agg_plain(vec, s1, s2m, d, ti, tm),
            *vec_agg_bwd_plain(vec, s1, s2m, d, ti, tm, gva),
            wdot_plain(d, u, vv, ti, tm), *wdot_bwd_plain(d, u, vv, ti, tm, gw))


def _jax_mix(args, idx, mask, agg, wdot):
    """`agg(vec, s1, s2m, d)`, `wdot(d, u, vv)` and their VJPs for gva, gw,
    in MIX_NAMES' order."""

    @jax.jit
    def run(vec, s1, s2m, d, u, vv, gva, gw):
        va, vjp_a = jax.vjp(agg, vec, s1, s2m, d)
        wd, vjp_w = jax.vjp(wdot, d, u, vv)
        return (va, *vjp_a(gva), wd, *vjp_w(gw))

    return run(*args)


@pytest.mark.parametrize("L,h,crowd", [
    pytest.param(8, 16, 0, id="8-16"), pytest.param(8, 256, 0, id="8-256"),
    pytest.param(3, 16, 0, id="3-16"), pytest.param(3, 256, 0, id="3-256"),
    pytest.param(8, 64, 3, id="8-64-crowded"), pytest.param(8, 16, 5, id="8-16-one-source"),
    pytest.param(3, 16, 2, id="3-16-crowded")])
def test_plain_bf16_mix_matches_the_pallas_kernels(L, h, crowd):
    """JAX's ViSNet runs these kernels in bf16 (`vis_mix_supported` at A = 8);
    the port's plain bf16 versions give their bits or one ulp. With `crowd`,
    the walk's stress for the backwards (G's and I's yardstick on the card):
    the first `crowd` of every slot's k neighbours on source slot 0 (up to
    8·k edges on one source), the others on slots 1 and 2, so that slots 3-7
    are no edge's source; the last row is fully masked in every case."""
    g, a, k = 3, 8, 5
    assert vis_mix_supported(a, k, L, h, jnp.bfloat16)
    args, idx, mask = _mix_inputs(g, a, k, L, h, seed=L + h + 10 * crowd)
    if crowd:
        idx = np.random.default_rng(crowd).integers(1, 3, (g, a, k))
        idx[:, :, :crowd] = 0
        assert mask[:-1, :, :crowd].sum() > 2 * a
    assert not mask[-1].any()
    ji, jm = jnp.asarray(idx, jnp.int32), jnp.asarray(mask)
    want = _jax_mix(args, idx, mask, lambda *x: _vec_agg(*x, ji, jm),
                    lambda *x: _wdot(*x, ji, jm))
    got = _port_mix(args, idx, mask)
    for name, x, y in zip(MIX_NAMES, got, want):
        _assert_bf16_matches(x, _torch(y), name, equal=0.99)
    if crowd:  # dvec and dvv of the slots that are no edge's source
        assert bool((got[1][:, 3:] == 0).all()) and bool((got[8][:, 3:] == 0).all())


def test_plain_bf16_mix_off_the_gate_is_within_rounding_of_xla_mix():
    """At A = 7 JAX's gate sends bf16 to `_xla_mix`, which rounds every
    product and partial sum to bf16; the port computes the kernels'
    function. Both against the f32 function on the same bf16 inputs: within
    2^-5 of its max per tensor, and the port, rounding once, nearer in L2."""
    g, a, k, L, h = 3, 7, 5, 8, 16
    assert not vis_mix_supported(a, k, L, h, jnp.bfloat16)
    args, idx, mask = _mix_inputs(g, a, k, L, h, seed=7)
    ji, jm = jnp.asarray(idx, jnp.int32), jnp.asarray(mask)

    def agg(vec, s1, s2m, d):
        return _xla_mix(vec, s1, s2m, d, ji, jm)[0]

    def wdot(d, u, vv):
        return _xla_mix(jnp.zeros_like(u), jnp.zeros((g, a, k, h), u.dtype),
                        jnp.zeros((g, a, k, h), u.dtype), d, ji, jm, u, vv)[1]

    jax16 = _jax_mix(args, idx, mask, agg, wdot)
    ref32 = _jax_mix(tuple(x.astype(jnp.float32) for x in args), idx, mask, agg, wdot)
    got = _port_mix(args, idx, mask)
    for name, x, j16, r32 in zip(MIX_NAMES, got, jax16, ref32):
        x, j16, r32 = x.double(), _torch(j16).double(), _torch(r32).double()
        scale = float(r32.abs().max())
        for who, t in (("port", x), ("JAX", j16)):
            err = float((t - r32).abs().max())
            assert err <= 2 ** -5 * scale, f"{name} ({who}): {err:.3e} > 2^-5 x {scale:.3e}"
        assert float((x - r32).norm()) <= float((j16 - r32).norm()), name


def test_wrappers_take_the_plain_bf16_path_on_the_cpu_and_refuse_mixed_dtypes():
    """bf16 CPU tensors go through the wrappers' autograd.Functions with the
    plain bf16 forwards and backwards (no launch counted); a float32 tensor
    among bf16 ones raises TypeError, on the wrappers and the kernels' own
    backward entries alike."""
    args, idx, mask = _mix_inputs(2, 8, 5, 8, 32, seed=3)
    vec, s1, s2m, d, u, vv, gva, gw = map(_torch, args)
    ti, tm = torch.from_numpy(idx), torch.from_numpy(mask)
    fns = (vis_vec_agg, vis_vec_agg_bwd, vis_wdot, vis_wdot_bwd)
    before = [(f.launches, f.launches_bf16) for f in fns]
    leaves = [t.clone().requires_grad_() for t in (vec, s1, s2m, d, u, vv)]
    va = vis_vec_agg(*leaves[:4], ti, tm)
    wd = vis_wdot(leaves[3], leaves[4], leaves[5], ti, tm)
    assert va.dtype == wd.dtype == torch.bfloat16 and va.grad_fn is not None
    assert torch.equal(va, vec_agg_plain(vec, s1, s2m, d, ti, tm))
    assert torch.equal(wd, wdot_plain(d, u, vv, ti, tm))
    torch.autograd.backward((va, wd), (gva, gw))
    gd = vec_agg_bwd_plain(vec, s1, s2m, d, ti, tm, gva)
    gi = wdot_bwd_plain(d, u, vv, ti, tm, gw)
    for leaf, want in zip(leaves, (gd[0], gd[1], gd[2], gd[3] + gi[0], gi[1], gi[2])):
        assert leaf.grad.dtype == torch.bfloat16 and torch.equal(leaf.grad, want)
    assert [(f.launches, f.launches_bf16) for f in fns] == before
    with pytest.raises(TypeError, match="one dtype"):
        vis_vec_agg(vec, s1.float(), s2m, d, ti, tm)
    with pytest.raises(TypeError, match="one dtype"):
        vis_wdot(d.float(), u, vv, ti, tm)
    with pytest.raises(TypeError, match="one dtype"):
        vis_vec_agg(vec.double(), s1.double(), s2m.double(), d.double(), ti, tm)
    with pytest.raises(ValueError, match="unsupported device"):  # the kernels' entries
        vis_wdot_bwd(d, u, vv, ti, tm, gw)


# ------------------------------------------------------------ the modules


def test_visnet_block_with_two_layers_matches_jax():
    """The ViSNet block at hidden 16 with 2 ViS_MP layers in bf16 against
    JAX's (its Pallas kernels in interpret mode): the f32 output within 1e-2
    of the gap (measured 1e-4: the LayerNorms' f32 statistics), and the
    gradients of a smooth loss within 1.5x of it (relative L2; measured
    0.93x: the backward passes round their own ops, in JAX as in the port,
    and where the trunk's f32 gradients do not dominate, as in the models,
    that shows)."""
    samples = make_synthetic_dataset(6, seed=11)
    jb = jax.tree.map(jnp.asarray, jax_pad(samples, jax_spec(samples, batch_size=8), target=0,
                                           with_pos=True))
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=True)
    gid = jb.atom_graph_id if jb.atom_row is None else jb.atom_row
    jargs = (jb.atom_feat, jb.pos, gid, jb.slot_index, jb.slot_mask, jb.atom_slot)
    kw = dict(hidden_channels=16, lmax=2, max_num_neighbors=16, num_layers=2)
    jm = jvis.ViSNet(**kw, dtype="bfloat16")
    flat = _random_params(jm, *jargs, slot_gid=jb.slot_gid)
    m = np.asarray(jb.atom_mask)
    proj = np.random.default_rng(2).standard_normal((m.shape[0], 16)).astype(np.float32) * m[:, None]

    def loss(v):
        out = jm.apply(v, *jargs, slot_gid=jb.slot_gid)
        return jnp.sum(out * proj), out

    (_, want), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))({"params": _unflat(flat)})
    runs = {}
    for dtype in ("bfloat16", None):
        tm = tvis.ViSNet(**kw, dtype=dtype, generator=torch.Generator().manual_seed(0))
        tm.load_state_dict(params_from_jax(flat, tm))
        out = tm(*_visnet_args(tb), slot_gid=tb.slot_gid)
        torch.sum(out * torch.from_numpy(proj)).backward()
        runs[dtype] = out.detach(), {n: p.grad for n, p in tm.named_parameters()
                                     if p.grad is not None}
    (got, grads), (got32, grads32) = runs["bfloat16"], runs[None]
    assert got.dtype == torch.float32
    gap = float((torch.from_numpy(np.asarray(want)) - got32)[m].abs().max())
    err = float((got - torch.from_numpy(np.asarray(want)))[m].abs().max())
    assert 0 < gap and err <= 1e-2 * gap, f"{err:.3e} vs the gap {gap:.3e}"
    want_g = params_from_jax(_flat(jg["params"]), tm)
    names = [n for n in grads32 if float(want_g[n].abs().max()) > 0]
    assert len(names) > 20
    assert _rel_l2(grads, want_g, names) <= 1.5 * _rel_l2(want_g, grads32, names)


# -------------------------------------------------------------- the models


def _ported(method, cfg, params, stats):
    model = create_model(method, num_target=1, cfg=ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(params, model, batch_stats=stats))
    return model


@pytest.fixture(scope="module", params=METHODS)
def model_runs(request):
    """One method's JAX bf16 run (training mode, dropout 0: predictions and
    masked-MSE gradients, jitted once; the module outputs' dtypes from
    `jax.eval_shape` of the eval forward), and the port's bf16 and f32 runs
    at the same weights."""
    method = request.param
    samples = make_synthetic_dataset(6, seed=23, num_targets=1, with_pos=True)
    jb = jax_batch(samples, jax_spec(samples, batch_size=8), True)
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=True)
    jm16 = jax_create_model(method, num_target=1, cfg=JaxModelConfig(**BF16))
    params, stats = random_variables(jm16, jb, 0)
    variables = {"params": _unflat(params), **({"batch_stats": _unflat(stats)} if stats else {})}

    def loss(p):
        out, _ = jm16.apply({**variables, "params": p}, jb, deterministic=False,
                            mutable=["batch_stats"])
        sq, cnt = jax_masked_mse(out, jb.y, jb.graph_mask)
        return sq / jnp.maximum(cnt, 1.0), out

    (_, pred16), g16 = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    _, state = jax.eval_shape(lambda v: jm16.apply(v, jb, deterministic=True,
                                                   capture_intermediates=True,
                                                   mutable=["intermediates"]), variables)
    inter = traverse_util.flatten_dict(state["intermediates"], sep="/")
    shapes = {k[:-len("/__call__")].replace("/", "."): v for k, v in inter.items()}

    def port(cfg):
        return _ported(method, cfg, params, stats).train()

    def run(model):
        out = model(tb)
        sq, cnt = masked_mse(out, tb.y, tb.graph_mask)
        (sq / torch.clamp(cnt, min=1.0)).backward()
        return out.detach(), {n: p.grad for n, p in model.named_parameters()
                              if p.grad is not None}

    model16 = port(BF16)
    return dict(method=method, tb=tb, params=params, stats=stats, model16=model16,
                port16=run(model16), port32=run(port(CFG)), pred16=np.asarray(pred16),
                g16=params_from_jax(_flat(g16), model16, batch_stats=stats or None),
                shapes=shapes)


def test_bf16_model_matches_jax(model_runs):
    r = model_runs
    (pred, grads), (pred32, grads32) = r["port16"], r["port32"]
    assert pred.dtype == torch.float32
    mask = r["tb"].graph_mask.numpy()
    gap = float(np.abs(r["pred16"] - pred32.numpy())[mask].max())
    err = float(np.abs(pred.numpy() - r["pred16"])[mask].max())
    own = float(np.abs(pred.numpy() - pred32.numpy())[mask].max())
    assert err <= 2.0 * gap, f"predictions: {err:.3e} > 2 x the gap {gap:.3e}"
    assert own >= 0.3 * gap, f"predictions: the port's own bf16 change {own:.3e}, the gap {gap:.3e}"

    model, want = r["model16"], r["g16"]
    reached = [n for n, _ in model.named_parameters() if float(want[n].abs().max()) > 0]
    for name in reached:
        assert name in grads and float(grads[name].abs().max()) > 0, name
    for name in set(grads) - set(reached):
        assert float(grads[name].abs().max()) == 0, name
    assert {"visnet_layer.vis_mp_layers_1.w_src_proj.weight",
            "visnet_layer.embedding.atom.embedding"} <= set(reached)
    gap = _rel_l2(want, grads32, reached)
    err = _rel_l2(grads, want, reached)
    own = _rel_l2(grads, grads32, reached)
    assert err <= 1.5 * gap, f"gradients: {err:.3e} > 1.5 x the gap {gap:.3e}"
    assert own >= 0.3 * gap, f"gradients: the port's own bf16 change {own:.3e}, the gap {gap:.3e}"


def test_bf16_dtypes_match_jax_at_every_module_boundary(model_runs):
    """The dtype and shape of each output of every module JAX's model and
    the port share, every call of a shared module, in the eval forward; and
    the bf16 model's parameters are the f32 model's, float32."""
    r = model_runs
    model = r["model16"].eval()
    got, hooks = {}, []
    for name, module in model.named_modules():
        hooks.append(module.register_forward_hook(
            lambda m, i, o, name=name: got.setdefault(name, []).append(o)))
    with torch.no_grad():
        model(r["tb"])
    for h in hooks:
        h.remove()
    want = r["shapes"]
    shared = sorted(set(want) & set(got))
    # JAX's `vec_out_norm` returns bf16 and its caller casts it to f32
    # (`nn/visnet.py:466-470`), which XLA computes from the f32 sum vec +
    # dvec, unrounded: the port's takes that sum, and returns f32
    cast_by_caller = {"visnet_layer.vec_out_norm"}
    assert len(shared) > 40 and "trunk.mlp_out" in shared and "visnet_layer" in shared
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16, jnp.int32: torch.int64}
    seen = set()
    for name in shared:
        jl, tl = _leaves(list(want[name])), [t for t in _leaves(got[name]) if t is not None]
        jl = [j for j in jl if j is not None]
        assert len(jl) == len(tl), name
        for j, t in zip(jl, tl):
            expect = dt[jnp.dtype(j.dtype).type]
            if name in cast_by_caller:
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
    assert all(v.dtype != torch.bfloat16 for v in b.values())


# ---------------------------------------------------------------- the CLIs


def test_bf16_visnet_trains_through_the_cli_and_serves(tmp_path, monkeypatch):
    """`main.run --method visnet_equihnns --compute_dtype bfloat16` on the
    CPU: finite losses; the checkpoint keeps the compute dtype and float32
    weights; `predict.run --compute_dtype bfloat16` serves `ckpt_best.pt`
    from the SDF, 20 finite predictions."""
    from equihgnn_tpu_torch.main import build_parser, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import load_checkpoint
    from equihgnn_tpu_torch.predict import run as predict_run

    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args([
        "--data", "synthetic_hg_3d", "--method", "visnet_equihnns", "--device", "cpu",
        "--synthetic_size", "24", "--synthetic_max_atoms", "9", "--batch_size", "8",
        "--epochs", "2", "--MLP_hidden", "16", "--output_hidden", "8", "--lr", "1e-4",
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
