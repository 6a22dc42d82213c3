"""The port's MHNN family and its parts vs the JAX package and the reference
goldens, on the CPU: `MLP` with "bn" and the input norm, `MaskedBatchNorm`,
PReLU, the models `mhnn`, `mhnns`, `mhnnm`, a train step of `mhnnm`
against the JAX trainer, the batch fields the MHNN trunks read, the
`synthetic_hg` dataset, and the CLIs on `synthetic_hg`.

Tolerances: the goldens keep the JAX tests' (MLP atol 1e-5, rtol 1e-5;
models atol 2e-5, rtol 1e-4); against JAX atol 1e-5, rtol 1e-4 (f32 sums
in other orders); gradients per tensor max |Δ| ≤ 1e-4·max |JAX| + 1e-6;
after an Adam step parameters within 1e-2·lr (an update is O(lr) whatever
the gradient's size) and the running statistics within 1e-6·max |JAX|.
The models at hidden 16 on a batch of 6 synthetic molecules; the encoder
hybrids are held to JAX in `tests/test_torch_hybrids.py`.
"""

import csv
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.data.datasets.synthetic_ds import SyntheticHGraph as JaxSyntheticHGraph
from equihgnn_tpu.data.synthetic import make_synthetic_dataset as jax_synthetic
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.nn.mlp import MaskedBatchNorm as JaxMaskedBatchNorm
from equihgnn_tpu.nn.mlp import PReLU as JaxPReLU
from equihgnn_tpu.train.trainer import TrainConfig as JaxTrainConfig
from equihgnn_tpu.train.trainer import Trainer as JaxTrainer
from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import (
    BatchSpec,
    iter_batches,
    pad_hypergraph_batch,
    spec_for_samples,
)
from equihgnn_tpu_torch.data.datasets import SyntheticHGraph
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.models.common import Activation
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn.mlp import MLP, MaskedBatchNorm
from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer, masked_mse

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SDF = os.path.join(ROOT, "datasets", "real_sample", "sample.sdf")
GEN = dict(generator=torch.Generator().manual_seed(0))
SLOT_TABLES = ("hedge_row", "hedge_slot", "hedge_slot_index", "hedge_slot_mask",
               "inc_slot_atom", "inc_slot_hedge", "inc_slot_mask")


def _flat(tree):
    return {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}


def _unflat(flat):
    return traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")


def _variables(params, stats):
    out = {"params": _unflat(params)}
    if stats:
        out["batch_stats"] = _unflat(stats)
    return out


def _assert_grad_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    limit = 1e-4 * float(np.abs(want).max()) + 1e-6
    assert err <= limit, f"{name}: max |d| {err:.3e} > {limit:.3e}"


# ---------------------------------------------------------- MLP goldens


@pytest.mark.parametrize("name,norm,input_norm,num_layers", [
    ("mlp_None_in0_l2", "None", False, 2),
    ("mlp_ln_in0_l3", "ln", False, 3),
    ("mlp_ln_in1_l2", "ln", True, 2),
    ("mlp_bn_in0_l2", "bn", False, 2),
    ("mlp_None_in0_l1", "None", False, 1),
])
def test_mlp_golden(name, norm, input_norm, num_layers):
    """The reference MLP's goldens, through the JAX test's converter; "bn"
    also in training mode, with the running statistics after it."""
    from test_reference_goldens import _state, load, mlp_tree

    d = load(name)
    params, stats = mlp_tree(_state(d), num_layers, norm, input_norm)
    x = torch.from_numpy(d["in::x"])
    m = MLP(x.shape[-1], 48, 24, num_layers, dropout=0.0, normalization=norm,
            input_norm=input_norm, **GEN)
    m.load_state_dict(params_from_jax(_flat(params), m, batch_stats=_flat(stats)))
    with torch.no_grad():
        np.testing.assert_allclose(m.eval()(x).numpy(), d["out::y"], atol=1e-5, rtol=1e-5)
        if "out::y_train" not in d:
            return
        np.testing.assert_allclose(m.train()(x).numpy(), d["out::y_train"], atol=1e-5,
                                   rtol=1e-5)
    for buf in ("running_mean", "running_var"):
        np.testing.assert_allclose(getattr(m.norm_0, buf).numpy(),
                                   d[f"post::normalizations.1.{buf}"], atol=1e-5, rtol=1e-5)


# ------------------------------------------------- MaskedBatchNorm, PReLU


@pytest.mark.parametrize("mask_kind", ["some", "none_kept", "no_mask"])
def test_masked_batch_norm_matches_jax(mask_kind):
    """Outputs and gradients in training mode (batch statistics over the
    kept rows), the running statistics after that forward, and eval mode."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((37, 12)) * 2.0 + 0.5).astype(np.float32)
    mask = {"some": rng.random(37) < 0.6, "none_kept": np.zeros(37, bool),
            "no_mask": None}[mask_kind]
    scale, bias = (1.0 + 0.3 * rng.standard_normal((2, 12))).astype(np.float32)
    mean, var = rng.standard_normal(12).astype(np.float32), rng.uniform(0.5, 2, 12).astype(
        np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jm = JaxMaskedBatchNorm()
    jvars = {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean, "var": var}}
    jmask = None if mask is None else jnp.asarray(mask)

    def loss(params, x):
        y, mut = jm.apply({**jvars, "params": params}, x, mask=jmask,
                          use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(y * dy), (y, mut["batch_stats"])

    (_, (jy, jstats)), (jg, jgx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(jvars["params"], jnp.asarray(x))
    jeval = jm.apply(jvars, jnp.asarray(x), mask=jmask)

    tm = MaskedBatchNorm(12)
    tm.load_state_dict(params_from_jax({"scale": scale, "bias": bias}, tm,
                                       batch_stats={"mean": mean, "var": var}))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm.train()(tx, None if mask is None else torch.from_numpy(mask))
    (ty * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy), atol=1e-5, rtol=1e-4)
    _assert_grad_close(tx.grad, jgx, "x")
    _assert_grad_close(tm.weight.grad, jg["scale"], "scale")
    _assert_grad_close(tm.bias.grad, jg["bias"], "bias")
    for buf, key in (("running_mean", "mean"), ("running_var", "var")):
        want = np.asarray(jstats[key])
        np.testing.assert_allclose(getattr(tm, buf).numpy(), want,
                                   atol=1e-6 * float(np.abs(want).max()), rtol=0, err_msg=buf)
    with torch.no_grad():
        got = tm.eval()(torch.from_numpy(x), None if mask is None else torch.from_numpy(mask))
    # eval mode reads the updated buffers; JAX's eval above read the old ones
    want_eval = jm.apply({**jvars, "batch_stats": jstats}, jnp.asarray(x), mask=jmask)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_eval), atol=1e-5, rtol=1e-4)
    assert not np.allclose(np.asarray(want_eval), np.asarray(jeval))


def test_prelu_matches_jax():
    """`Activation("prelu")` against JAX's `PReLU`: values and gradients,
    x = 0 included (the gradient at 0 is x's)."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal(64).astype(np.float32)
    x[::7] = 0.0
    dy = rng.standard_normal(64).astype(np.float32)
    alpha = np.float32(-0.37)
    jm = JaxPReLU()

    def loss(a, x):
        return jnp.sum(jm.apply({"params": {"alpha": a}}, x) * dy)

    jy = jm.apply({"params": {"alpha": alpha}}, jnp.asarray(x))
    ja, jx = jax.grad(loss, argnums=(0, 1))(jnp.asarray(alpha), jnp.asarray(x))
    tm = Activation("prelu")
    assert float(tm.alpha.detach()) == 0.25 and tm.alpha.shape == ()
    tm.load_state_dict(params_from_jax({"PReLU_0/alpha": alpha}, tm))
    tx = torch.from_numpy(x).requires_grad_()
    ty = tm(tx)
    (ty * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_array_equal(ty.detach().numpy(), np.asarray(jy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jx), rtol=0, atol=0)
    np.testing.assert_allclose(float(tm.alpha.grad), float(ja), rtol=1e-5)


# ---------------------------------------------------------- model goldens


@pytest.mark.parametrize("name,method,kw", [
    ("mhnn", "mhnn", {}),
    ("mhnns", "mhnns", {}),
    ("mhnnm", "mhnnm", {}),
    ("mhnn_prelu_sum", "mhnn", dict(norm="None", act="prelu", aggr="sum")),
])
def test_model_golden(name, method, kw):
    """The reference MHNN family's goldens in eval mode and, where captured,
    in training mode (`out::y_train`: batch statistics)."""
    from test_reference_goldens import _model_cfg, _state, load, model_tree

    d = load(f"model_{name}")
    jcfg = _model_cfg(**kw)
    variables = model_tree(name, _state(d), jcfg)
    model = create_model(method, num_target=1, cfg=ModelConfig(**dataclasses.asdict(jcfg)))
    model.load_state_dict(params_from_jax(_flat(variables["params"]), model,
                                          batch_stats=_flat(variables.get("batch_stats", {}))))
    samples = make_synthetic_dataset(6, seed=17)
    spec = BatchSpec(num_graphs=8, num_atoms=256, num_hedges=128, nnz=512)
    batch = pad_hypergraph_batch(samples, spec, target=0)
    with torch.no_grad():
        out = model.eval()(batch).numpy()
        np.testing.assert_allclose(out[:6], d["out::y"], atol=2e-5, rtol=1e-4)
        if "out::y_train" in d:
            out_t = model.train()(batch).numpy()
            np.testing.assert_allclose(out_t[:6], d["out::y_train"], atol=2e-5, rtol=1e-4)
    assert ("out::y_train" in d) == (name == "mhnnm")


# ----------------------------------------------- the models against JAX


CFG = dict(mlp_hidden=16, output_hidden=8, all_num_layers=3, output_num_layers=3,
           dropout=0.0)


SLOT_VIEW = ("slot_index", "slot_mask", "slot_gid", "atom_slot", "atom_row")


def jax_batch(samples, spec, with_pos, slot_view=True):
    """JAX's padded batch on its flat segment path (the slot tables off);
    without `slot_view`, the encoders' dense slot view off too."""
    jb = jax_pad(samples, spec, target=0, with_pos=with_pos)
    off = SLOT_TABLES if slot_view else SLOT_TABLES + SLOT_VIEW
    return jax.tree.map(jnp.asarray, dataclasses.replace(jb, **{f: None for f in off}))


def random_variables(jmodel, jb, seed=0):
    """(params, batch_stats), flat: O(0.2) draws (norm scales around 1,
    the atom tables at O(0.1)), running means around 0, variances in
    [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), jb, deterministic=True))
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for k, v in traverse_util.flatten_dict(shapes["params"], sep="/").items():
        x = (rng.standard_normal(v.shape) * (0.1 if "atom" in k else 0.2)).astype(np.float32)
        params[k] = x + 1.0 if k.endswith("scale") else x
    for k, v in traverse_util.flatten_dict(shapes.get("batch_stats", {}), sep="/").items():
        stats[k] = (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var")
                    else rng.standard_normal(v.shape) * 0.2).astype(np.float32)
    return params, stats


def _jax_run(jmodel):
    """Jitted (params, stats, batch) → JAX's eval-mode predictions, and in
    training mode (dropout 0) its predictions, masked-MSE loss, parameter
    gradients and new statistics."""

    def run(params, stats, jb):
        variables = {"params": params, **({"batch_stats": stats} if stats else {})}
        ev = jmodel.apply(variables, jb, deterministic=True)

        def loss(p):
            out, mut = jmodel.apply({**variables, "params": p}, jb, deterministic=False,
                                    mutable=["batch_stats"])
            sq, cnt = jax_masked_mse(out, jb.y, jb.graph_mask)
            return sq / jnp.maximum(cnt, 1.0), (out, mut.get("batch_stats", {}))

        (lv, (tr, new)), g = jax.value_and_grad(loss, has_aux=True)(params)
        return ev, tr, lv, g, new

    return jax.jit(run)


def jax_reference(jmodel, jb, params, stats, run=None):
    out = (run or _jax_run(jmodel))(_unflat(params), _unflat(stats) if stats else {}, jb)
    ev, tr, lv, g, new = out
    return np.asarray(ev), np.asarray(tr), float(lv), _flat(g), _flat(new)


def jax_gradient_spread(run, jmodel, samples, spec, with_pos, params, stats, grads,
                        slot_view=True):
    """Per gradient element, the most JAX's own gradient moves under changes
    the model is invariant to: the batch's molecules in reverse order (other
    summation orders) and, with coordinates, translations by 1e-4 to 1e-3 Å."""
    batches = [jax_batch(samples[::-1], spec, with_pos, slot_view)]
    if with_pos:
        for t in ((1e-4, 0.7e-4, -0.3e-4), (0.0, 0.0, 1e-3)):
            moved = [dataclasses.replace(m, pos=(m.pos + np.float32(t)).astype(np.float32))
                     for m in samples]
            batches.append(jax_batch(moved, spec, with_pos, slot_view))
    spread = {k: np.zeros_like(v) for k, v in grads.items()}
    for jb in batches:
        other = jax_reference(jmodel, jb, params, stats, run)[3]
        for k in grads:
            spread[k] = np.maximum(spread[k], np.abs(other[k] - grads[k]))
    return spread


def vanishing(model) -> set[str]:
    """Parameters whose training-mode gradient is 0 in exact arithmetic:
    TrunkM's W4 feeds a BatchNorm that removes any shift shared by every
    atom, so the bias of W4's last Linear and that of the norm before it
    get f32 rounding only (~1e-7 of the largest gradient, in JAX as here)."""
    if not hasattr(model.trunk, "batch_norms_0"):
        return set()
    n, cfg = model.cfg.all_num_layers, model.cfg
    names = {f"trunk.layers_{i}.W4.lin_{cfg.mlp4_layers - 1}.bias" for i in range(n)}
    if cfg.mlp4_layers > 1 and cfg.normalization != "None":
        names |= {f"trunk.layers_{i}.W4.norm_{cfg.mlp4_layers - 2}.bias" for i in range(n)}
    return names


def check_against_jax(method, cfg, samples, with_pos, encoder_eval=None, seed=0,
                      grads=True, slot_view=True):
    """Build `method` in both frameworks at matched weights and hold the
    port to JAX: eval forward, training forward, loss, gradients (every
    parameter reached in JAX is reached here; their values with `grads`)
    and running statistics.

    A gradient tensor is held to 1e-4·max |JAX| + 1e-6, or, where it is
    determined less finely than that in f32 (TrunkM's batch statistics in
    training mode, FAFormer's frames), to that plus twice JAX's own change
    under the model's invariances (`jax_gradient_spread`). Without
    `slot_view`, both batches are built without the dense slot view."""
    jspec, tspec = jax_spec(samples, batch_size=8), spec_for_samples(samples, batch_size=8)
    if not slot_view:
        tspec = dataclasses.replace(tspec, max_atoms_per_graph=0)
    jb = jax_batch(samples, jspec, with_pos, slot_view)
    tb = pad_hypergraph_batch(samples, tspec, target=0, with_pos=with_pos)
    jmodel = jax_create_model(method, num_target=1, cfg=JaxModelConfig(**cfg))
    params, stats = random_variables(jmodel, jb, seed)
    run = _jax_run(jmodel)
    ev, tr, lv, jgrads, new = jax_reference(jmodel, jb, params, stats, run)
    model = create_model(method, num_target=1, cfg=ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(params, model, batch_stats=stats))
    with torch.no_grad():
        got = model.eval()(tb).numpy()
    assert got.shape == ev.shape == (9,)
    np.testing.assert_allclose(got, ev, atol=1e-5, rtol=1e-4)
    model.train()
    if encoder_eval:  # an encoder whose own dropout JAX's twin runs at rate 0
        getattr(model, encoder_eval).eval()
    preds = model(tb)
    np.testing.assert_allclose(preds.detach().numpy(), tr, atol=1e-5, rtol=1e-4)
    sq, cnt = masked_mse(preds, tb.y, tb.graph_mask)
    loss = sq / torch.clamp(cnt, min=1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), lv, rtol=1e-5)
    want = params_from_jax(jgrads, model, batch_stats=new or None)
    top = max(float(w.abs().max()) for w in want.values())
    reached, beyond = 0, {}
    for name, p in model.named_parameters():
        w = want[name]
        if name in vanishing(model):  # rounding in both: held to ~0, not to each other
            for g in (p.grad, w):
                assert float(g.abs().max()) <= 1e-5 * top, name
            reached += 1
            continue
        if float(w.abs().max()) == 0.0:
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, name
            continue
        assert p.grad is not None, name
        reached += 1
        if not grads:
            continue
        err, limit = float((p.grad - w).abs().max()), 1e-4 * float(w.abs().max()) + 1e-6
        if err > limit:
            beyond[name] = (err, limit)
    if beyond:  # held to JAX's own resolution of those gradients
        spread = params_from_jax(jax_gradient_spread(
            run, jmodel, samples, jspec, with_pos, params, stats, jgrads, slot_view), model,
            batch_stats=new or None)
        for name, (err, limit) in beyond.items():
            own = float(spread[name].max())
            assert err <= limit + 2 * own, (
                f"{name}: max |d| {err:.3e} > {limit:.3e} + 2 x JAX's own spread {own:.3e}")
    for name, buf in model.named_buffers():  # statistics of the training forward
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=name)
    return model, want, reached


# the recipe's ln/relu/mean, sum aggregation, and "bn" with PReLU. At "bn"
# with sum aggregation TrunkM's training-mode gradients are determined only
# to ~1e-3 of their max in f32 (JAX's own move by a few 1e-4 under a
# reversed molecule order, and between two compilations of the same step):
# there only which parameters are reached is held, beside the forwards and
# the statistics.
@pytest.mark.parametrize("method", ["mhnn", "mhnns", "mhnnm"])
@pytest.mark.parametrize("variant", [
    dict(normalization="ln", activation="relu", aggregate="mean"),
    dict(normalization="ln", activation="Id", aggregate="sum"),
    dict(normalization="bn", activation="prelu", aggregate="mean"),
    dict(normalization="bn", activation="prelu", aggregate="sum"),
], ids=["ln-relu-mean", "ln-Id-sum", "bn-prelu-mean", "bn-prelu-sum"])
def test_mhnn_family_matches_jax(method, variant):
    samples = make_synthetic_dataset(6, seed=23, num_targets=1, with_pos=False)
    sum_bn = variant["aggregate"] == "sum" and variant["normalization"] == "bn"
    model, want, reached = check_against_jax(method, {**CFG, **variant}, samples,
                                             with_pos=False, grads=not sum_bn)
    # every parameter is reached (the trunk's conv weights, the atom table,
    # the hyperedge table of the MHNNConv trunks, a PReLU's slope)
    assert reached == len(list(model.parameters()))
    if variant["activation"] == "prelu":
        assert "trunk.act.alpha" in want


# ------------------------------------------------------- a train step


def test_mhnnm_adam_step_matches_jax():
    """One Adam step of `mhnnm` with "bn" in every MLP against the JAX
    trainer's step: parameters and running statistics. Adam's first step
    moves an element by ~lr·sign(gradient), so where JAX's gradient is
    below 1e-3 of its tensor's max (or vanishes in exact arithmetic) the
    sign is rounding's, and such an element is held to have moved by at
    most lr in both frameworks; every other element to 1e-2·lr. The running
    statistics within 1e-6 of their max (the output MLP's 1e-5)."""
    cfg = {**CFG, "normalization": "bn"}
    samples = make_synthetic_dataset(6, seed=29, num_targets=1, with_pos=False)
    jb = jax_batch(samples, jax_spec(samples, batch_size=8), False)
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0)
    jmodel = jax_create_model("mhnnm", num_target=1, cfg=JaxModelConfig(**cfg))
    params, stats = random_variables(jmodel, jb, seed=1)
    # wd 0: the trainers' decay is held in tests/test_torch_train.py
    lr, wd = 1e-3, 0.0
    jt = JaxTrainer(jmodel, JaxTrainConfig(lr=lr, weight_decay=wd, seed=0), jb, std=1.0)
    jp = _unflat(params)
    jp, _, jstats, jloss, _ = jt._step_fn(jp, jt.tx.init(jp), _unflat(stats), jb,
                                          np.float32(lr), jax.random.PRNGKey(1))
    model = create_model("mhnnm", num_target=1, cfg=ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(params, model, batch_stats=stats))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    grads = params_from_jax(jax_reference(jmodel, jb, params, stats)[3], model,
                            batch_stats=stats)
    tt = Trainer(model, TrainConfig(lr=lr, weight_decay=wd, seed=0), std=1.0, device="cpu")
    tloss = tt.train_step(tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = params_from_jax(_flat(jp), model, batch_stats=_flat(jstats))
    got = model.state_dict()
    n_stats = n_sign = 0
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            assert not torch.equal(w, start[name]), name
            # 1e-6 of the largest; the output MLP's norms take the statistics
            # of 6 pooled per-graph sums, whose rounding reaches 4.2e-6: 1e-5
            rel = 1e-5 if name.startswith("trunk.mlp_out.") else 1e-6
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=rel * float(w.abs().max()), rtol=0, err_msg=name)
            continue
        g = grads[name].abs()
        by_sign = g <= 1e-3 * float(g.max()) if name not in vanishing(model) else g >= 0
        n_sign += int(by_sign.sum())
        for moved in (got[name] - start[name], w - start[name]):
            assert bool((moved.abs() <= lr * (1 + 1e-3))[by_sign].all()), name
        np.testing.assert_allclose(got[name][~by_sign].numpy(), w[~by_sign].numpy(),
                                   atol=1e-2 * lr, rtol=0, err_msg=name)
    # 3 batch_norms_i, 4 MLP norms in each of 3 convs, 2 in mlp_out; 2 buffers each
    assert n_stats == 2 * (3 + 12 + 2)
    assert n_sign < 0.1 * sum(p.numel() for p in model.parameters())  # 1,012 of 13,193


def _stats_path(key):
    """A port buffer's flax `batch_stats` path."""
    *mods, leaf = key.split(".")
    if not mods[-1].startswith("batch_norms_"):
        mods.append("MaskedBatchNorm_0")
    return "/".join(mods + [leaf.replace("running_", "")])


# ---------------------------------------------- batch fields, dataset, CLIs


def test_batch_fields_and_synthetic_hg_match_jax(tmp_path):
    ours = SyntheticHGraph(root=str(tmp_path), size=20, seed=5).samples
    theirs = JaxSyntheticHGraph(root=str(tmp_path / "jax"), size=20, seed=5).samples
    assert SyntheticHGraph.has_pos is False and len(ours) == len(theirs) == 20
    for a, b in zip(ours, theirs):
        for f in ("atom_feat", "vertex_idx", "hedge_idx", "hedge_feat", "y"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
        assert a.pos is None and b.pos is None
        np.testing.assert_array_equal(a.e_order(), b.e_order())
    # with_pos=False draws no coordinates, so the stream differs from the
    # first molecule's targets on, in both frameworks
    with3d = jax_synthetic(20, seed=5, with_pos=True)
    np.testing.assert_array_equal(ours[0].vertex_idx, with3d[0].vertex_idx)
    assert not np.array_equal(ours[0].y, with3d[0].y)
    for A in (True, False):  # with and without the slot view
        spec = spec_for_samples(ours[:7], batch_size=8)
        jspec = jax_spec(theirs[:7], batch_size=8)
        if not A:
            spec = dataclasses.replace(spec, max_atoms_per_graph=0)
            jspec = dataclasses.replace(jspec, max_atoms_per_graph=0)
        tb = pad_hypergraph_batch(ours[:7], spec, target=0)
        jb = jax_pad(theirs[:7], jspec, target=0)
        assert tb.pos is None and (tb.slot_index is not None) == A
        for name in ("hedge_feat", "hedge_graph_id", "e_order", "hedge_mask", "hedge_idx",
                     "atom_graph_id", "graph_mask", "y"):
            got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
            np.testing.assert_array_equal(got, want, err_msg=name)
            if got.dtype.kind in "iu":
                assert got.dtype == np.int64, name
        pad = ~tb.hedge_mask
        assert bool(pad.any()) and bool((tb.hedge_graph_id[pad] == tb.num_graphs - 1).all())
        assert int(tb.e_order.sum()) == int(tb.inc_mask.sum())
        batches = list(iter_batches(ours, spec, target=0))
        assert sum(int(b.graph_mask.sum()) for b in batches) == 20


def _predictions(path):
    with open(path) as f:
        return np.array([float(r["prediction"]) for r in csv.DictReader(f)])


def test_main_runs_mhnnm_on_synthetic_hg(tmp_path, monkeypatch):
    """`main.run --data synthetic_hg` trains `mhnnm` ("bn": the running
    statistics move) on the CPU; its checkpoint serves from the SDF."""
    from equihgnn_tpu_torch.main import build_parser, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import run as predict_run

    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args([
        "--data", "synthetic_hg", "--method", "mhnnm", "--device", "cpu", "--epochs", "2",
        "--batch_size", "16", "--synthetic_size", "64", "--MLP_hidden", "16",
        "--output_hidden", "8", "--normalization", "bn", "--activation", "prelu",
        "--lr", "1e-3"])
    res = run(args)
    assert len(res["history"]) == 2 and np.isfinite(res["test_mae_mean"])
    ckpt = os.path.join(res["log_dir"], "ckpt_best.pt")
    state = torch.load(ckpt, weights_only=True)
    assert float(state["trunk.batch_norms_0.running_var"].sub(1).abs().max()) > 0
    assert "trunk.act.alpha" in state
    out = str(tmp_path / "preds.csv")
    predict_run(predict_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", SDF, "--out", out, "--device", "cpu"]))
    vals = _predictions(out)
    assert len(vals) == 20 and np.isfinite(vals).all()


@pytest.mark.parametrize("method", ["mhnn", "mhnns", "mhnnm"])
def test_predict_serves_mhnn_from_the_sdf(tmp_path, method):
    """The serving CLI rebuilds the model from its checkpoint (buffers
    included) and serves the SDF; the same as the library path in eval mode."""
    from equihgnn_tpu_torch.predict import (
        build_parser,
        featurize_sdf,
        predict_samples,
        run,
        save_checkpoint,
    )

    cfg = ModelConfig(mlp_hidden=16, output_hidden=8, normalization="bn")
    model = create_model(method, num_target=1, cfg=cfg, **GEN)
    with torch.no_grad():  # running statistics away from their init
        for name, buf in model.named_buffers():
            if name.endswith(("running_mean", "running_var")):
                buf.add_(0.1 * torch.rand(buf.shape, generator=torch.Generator().manual_seed(2)))
    ckpt = save_checkpoint(str(tmp_path / "m.pt"), model, method, cfg, std=2.0)
    out = str(tmp_path / "preds.csv")
    run(build_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", SDF, "--out", out, "--device", "cpu", "--batch_size", "8"]))
    vals = _predictions(out)
    samples = [s for _, s in featurize_sdf(SDF)]
    want = predict_samples(model.eval(), samples, 8, torch.device("cpu")) * 2.0
    assert vals.shape == (20,) and np.isfinite(vals).all()
    np.testing.assert_allclose(vals, want, rtol=1e-6, atol=1e-6)
