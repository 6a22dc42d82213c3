"""`se3_transformer_equihnns` with `compute_dtype="bfloat16"` in the port
against the JAX package's bfloat16 model, on the CPU.

At `MLP_hidden` 16 JAX's fused pooled unit refuses the shape (O % 128), so
every pooled ConvSE3 unit takes the per-J path with `pooled_m` (JAX: its
Pallas kernel in interpret mode; the port: the plain version of kernels L
and M). Weights are numpy draws at the init's scales (`_init_like_params`
of `tests/test_torch_se3.py`), the f32 tree mapped by `params_from_jax`
into the bf16 model, which has the f32 model's parameters. JAX calls are
jitted and shared by the tests through one module-scoped fixture.

Tolerances, each set against the JAX package's own bfloat16-vs-float32 gap
on the same inputs and weights ("the gap"):

  * predictions: max |port − JAX| over the batch's molecules at most 1/4
    of the gap's max |JAX bf16 − JAX f32| (measured: 2.0e-3 against 2.8e-2
    of max |JAX|);
  * parameter gradients of the masked MSE, as the relative L2 distance over
    all parameters, ‖g_port − g_JAX‖ / ‖g_JAX‖: at most 0.7 of the gap's
    ‖g_JAX16 − g_JAX32‖ / ‖g_JAX32‖ (measured 0.31 against 0.54); over the
    layers next to the output (conv_out, ff_1 and the float32 trunk) at most
    1/4 of the gap (measured ~0.1 of it). Per-tensor limits are not held:
    at these weights JAX's own bfloat16 gradients of the first layers differ
    from its float32 ones by more than their norm (conv_in: 1.02), the
    encoder being ill-conditioned at init (ROADMAP §3), and the backward
    rounds where XLA and autograd each put it;
  * every parameter gets a gradient in both; the loss within rtol 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_se3 import CFG, _batches, _init_like_params, _np, _port, _unflat

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.synthetic import make_synthetic_dataset
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import se3_transformer as tse3
from equihgnn_tpu_torch.train.trainer import masked_mse

torch.set_num_threads(1)

BF16 = dict(CFG, compute_dtype="bfloat16")
LATE = ("se3_transformer_layer.conv_out", "se3_transformer_layer.ff_1", "trunk")
# module outputs (name: degrees) the port carries in float32 where JAX's are
# bfloat16: the unrounded last operation that XLA hands to a cast to float32
# (the prenorms' norms, the type-0 output's cast, the FFN's NormSE3;
# `nn/se3_transformer.py`)
CARRIED_F32 = {"conv_in": (0,), "conv_out": (0,), "ff_0.project_in": (0, 1),
               "ff_1.project_in": (0, 1)}


def _rel_l2(got: dict, want: dict, names) -> float:
    num = sum(float(((got[n].double() - want[n].double()) ** 2).sum()) for n in names)
    den = sum(float((want[n].double() ** 2).sum()) for n in names)
    return (num / den) ** 0.5


def _jax_grads(jm, jb, flat):
    def loss_fn(v):
        preds = jm.apply(v, jb, deterministic=True)
        sq, cnt = jax_masked_mse(preds, jb.y, jb.graph_mask)
        return sq / jnp.maximum(cnt, 1.0), preds

    (loss, preds), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(_unflat(flat))
    return float(loss), np.asarray(preds), {
        k: np.asarray(v) for k, v in traverse_util.flatten_dict(grads["params"], sep="/").items()}


@pytest.fixture(scope="module")
def case():
    """The batch of `test_torch_se3.model_case`; JAX's f32 and bf16 models'
    loss, predictions and gradients at one set of weights; and the port's
    bf16 model at those weights."""
    pool = make_synthetic_dataset(40, seed=23, num_targets=1)
    jb, tb = _batches([s for s in pool if s.n_atoms <= 14][:4], batch_size=4)
    jm32 = jax_create_model("se3_transformer_equihnns", num_target=1, cfg=JaxModelConfig(**CFG))
    jm16 = jax_create_model("se3_transformer_equihnns", num_target=1,
                            cfg=JaxModelConfig(**BF16))
    flat = _init_like_params(jm32, jb)
    model = _port(create_model("se3_transformer_equihnns", num_target=1,
                               cfg=ModelConfig(**BF16)), flat)
    return dict(jb=jb, tb=tb, jm16=jm16, flat=flat, model=model,
                jax32=_jax_grads(jm32, jb, flat), jax16=_jax_grads(jm16, jb, flat))


def test_bf16_model_forward_and_grads_match_jax(case):
    model, tb = case["model"], case["tb"]
    loss32, preds32, grads32 = case["jax32"]
    loss16, preds16, grads16 = case["jax16"]
    mask = _np(tb.graph_mask)
    preds = model(tb)
    assert preds.dtype == torch.float32  # the encoder's output is cast back
    gap = float(np.abs(preds16 - preds32)[mask].max())
    err = float(np.abs(_np(preds) - preds16)[mask].max())
    assert 0.0 < err <= gap / 4, f"predictions: max|port - JAX| {err:.3e}, the gap {gap:.3e}"

    sq, cnt = masked_mse(preds, tb.y, tb.graph_mask)
    loss = sq / torch.clamp(cnt, min=1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), loss16, rtol=1e-2)
    want16, want32 = (params_from_jax(g, model) for g in (grads16, grads32))
    got = {}
    for name, p in model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0.0, name
        assert float(want16[name].abs().max()) > 0.0, name
        got[name] = p.grad
    for what, names, share in (("all parameters", list(got), 0.7),
                               ("the layers next to the output",
                                [n for n in got if n.startswith(LATE)], 0.25)):
        gap = _rel_l2(want16, want32, names)
        err = _rel_l2(got, want16, names)
        assert err <= share * gap, f"gradients of {what}: {err:.3e} > {share} * {gap:.3e}"


def test_bf16_model_has_the_f32_parameters(case):
    f32 = create_model("se3_transformer_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    want = {k: (v.shape, v.dtype) for k, v in f32.state_dict().items()}
    assert {k: (v.shape, v.dtype) for k, v in case["model"].state_dict().items()} == want
    assert all(v.dtype == torch.float32 for v in case["model"].state_dict().values())


def _leaves(x) -> list:
    if isinstance(x, dict):
        return [leaf for d in sorted(x) for leaf in _leaves(x[d])]
    if isinstance(x, (list, tuple)):
        return [leaf for v in x for leaf in _leaves(v)]
    return [x]


def test_dtypes_match_jax_at_every_module_boundary(case):
    """The dtype of every output of every submodule of the encoder, JAX's
    from `capture_intermediates`, the port's from forward hooks."""
    jb, tb, jm16, model = case["jb"], case["tb"], case["jm16"], case["model"]
    _, state = jax.jit(lambda v: jm16.apply(v, jb, deterministic=True, capture_intermediates=True,
                                            mutable=["intermediates"]))(_unflat(case["flat"]))
    inter = traverse_util.flatten_dict(state["intermediates"], sep="/")
    want = {k[len("se3_transformer_layer/"):-len("/__call__")].replace("/", "."): v[0]
            for k, v in inter.items() if k.startswith("se3_transformer_layer/")}
    got, hooks = {}, []
    se3 = model.se3_transformer_layer
    for name, module in se3.named_modules():
        hooks.append(module.register_forward_hook(
            lambda m, i, o, name=name: got.__setitem__(name, o)))
    with torch.no_grad():
        model(tb)
    for h in hooks:
        h.remove()
    assert set(want) == set(got) and len(want) == 45
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    for name in sorted(want):
        jl, tl = _leaves(want[name]), _leaves(got[name])
        assert len(jl) == len(tl), name
        for n, (j, t) in enumerate(zip(jl, tl)):
            carried = n in CARRIED_F32.get(name, ())
            expect = torch.float32 if carried else dt[jnp.dtype(j.dtype).type]
            assert t.dtype == expect and tuple(t.shape) == j.shape, (name, n, t.dtype, j.dtype)
            assert j.dtype == jnp.bfloat16 or not carried, (name, n)
    assert got[""].dtype == torch.float32 and want[""].dtype == jnp.float32


def test_bf16_routes_pooled_units_through_pooled_m(case, monkeypatch):
    """Each of the 4 pooled units (conv_in 0 → 0, 0 → 1; conv_out 0 → 0,
    1 → 0) calls `pooled_m` once a forward in bfloat16, and again in the
    backward (the checkpointed step is recomputed); float32 calls
    `pooled_conv` 4 times and `pooled_m` never."""
    calls = {"pooled_m": 0, "pooled_conv": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(tse3, name, counted(name, getattr(tse3, name)))
    tb = case["tb"]
    with torch.no_grad():
        case["model"](tb)
    assert calls == {"pooled_m": 4, "pooled_conv": 0}
    case["model"].zero_grad()
    torch.sum(case["model"](tb)).backward()
    assert calls == {"pooled_m": 12, "pooled_conv": 0}
    f32 = create_model("se3_transformer_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    calls.update(pooled_m=0, pooled_conv=0)
    with torch.no_grad():
        f32(tb)
    assert calls == {"pooled_m": 0, "pooled_conv": 4}


@pytest.mark.parametrize("method,override", [
    ("se3_transformer_equihnns", dict(mlp_hidden=128)),  # JAX's fused unit takes this width
    ("egnn_equihnns", {}), ("faformer_equihnns", {}), ("visnet_equihnns", {}),
])
def test_bf16_elsewhere_raises(method, override, monkeypatch):
    """bfloat16 raised where the port did not run it yet (ROADMAP item 11);
    these models run it since and build: `egnn_equihnns`
    (`tests/test_torch_bf16_hypergraph.py`), `visnet_equihnns`
    (`tests/test_torch_visnet_bf16.py`), `faformer_equihnns`
    (`tests/test_torch_faformer_bf16.py`) and `se3_transformer_equihnns` at
    hidden 128, whose pooled units take JAX's route at each call
    (`tests/test_torch_se3_bf16_fused.py`): on this module's batch (A = 16)
    all four fused, through `pooled_conv`, none through `pooled_m`."""
    cfg = ModelConfig(**{**BF16, **override})
    model = create_model(method, num_target=1, cfg=cfg)
    assert model.cfg.compute_dtype == "bfloat16"
    if method != "se3_transformer_equihnns":
        return
    calls = {"pooled_m": 0, "pooled_conv": 0}
    for name in calls:
        monkeypatch.setattr(tse3, name, lambda *a, name=name, fn=getattr(tse3, name): (
            calls.__setitem__(name, calls[name] + 1), fn(*a))[1])
    _, tb = _batches([s for s in make_synthetic_dataset(40, seed=23, num_targets=1)
                      if s.n_atoms <= 14][:4], batch_size=4)
    with torch.no_grad():
        assert bool(torch.isfinite(model(tb)).all())
    assert calls == {"pooled_m": 0, "pooled_conv": 4}


def test_bf16_trains_through_the_cli_and_serves(tmp_path, monkeypatch):
    """`main.run` with --compute_dtype bfloat16 on the CPU; the checkpoint's
    meta carries the compute dtype, and `predict` serves it in bfloat16."""
    from equihgnn_tpu_torch.main import build_parser, run
    from equihgnn_tpu_torch.predict import load_checkpoint

    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args([
        "--data", "synthetic_hg_3d", "--method", "se3_transformer_equihnns", "--device", "cpu",
        "--synthetic_size", "24", "--synthetic_max_atoms", "9", "--batch_size", "8",
        "--epochs", "2", "--MLP_hidden", "16", "--output_hidden", "8",
        "--compute_dtype", "bfloat16", "--lr", "1e-3"])
    res = run(args)
    losses = [h["train_loss"] for h in res["history"]]
    assert len(losses) == 2 and np.isfinite(losses).all()
    meta, state = load_checkpoint(str(tmp_path / res["log_dir"] / "ckpt_best.pt"))
    assert meta["model_config"]["compute_dtype"] == "bfloat16"
    assert all(v.dtype == torch.float32 for v in state.values())
    model = create_model(meta["method"], num_target=1, cfg=ModelConfig(**meta["model_config"]))
    assert model.se3_transformer_layer.dtype == torch.bfloat16


def test_cast_compute_matches_jax():
    """`models/common.py` `cast_compute`: a no-op without a compute dtype,
    None passes through, one tensor gives one tensor, as in JAX."""
    from equihgnn_tpu.models.common import cast_compute as jax_cast
    from equihgnn_tpu_torch.models.common import cast_compute

    x = np.linspace(-3.0, 3.0, 7, dtype=np.float32) / 7.0
    for kw in ({}, {"compute_dtype": "bfloat16"}):
        got = cast_compute(ModelConfig(**kw), torch.from_numpy(x), None)
        want = jax_cast(JaxModelConfig(**kw), jnp.asarray(x), None)
        assert got[1] is None and want[1] is None
        assert str(got[0].dtype).split(".")[-1] == str(want[0].dtype)
        np.testing.assert_array_equal(got[0].float().numpy(), np.asarray(want[0], np.float32))
    t = torch.from_numpy(x)
    assert cast_compute(ModelConfig(), t) is t
