"""`se3_transformer_equihnns` in bfloat16 where JAX fuses its pooled units
(kernels J and K in bfloat16), against the JAX package on the CPU.

JAX routes each pooled ConvSE3 unit by its gate `pooled_conv_supported` at
the call's shapes: the fused unit (its Pallas `pooled_conv`) where it
holds, the per-J path with `pooled_m` where it fails; the port takes the
same branch (`nn/se3_transformer.py` `_ConvSE3Pair._pooled`). JAX's
interpret-mode `pooled_conv` unrolls its sites and takes ~50 s to trace at
C = 1, so where a case runs it at C = 1 or through the whole model, the
attribute `equihgnn_tpu.ops.pallas.pooled_conv.pooled_conv`, which JAX's
unit imports at each call, is the stand-in of
`tests/test_torch_pooled_conv_bf16.py` (held there to the Pallas kernel);
the unit at C = 3 runs the Pallas kernel itself.

Tolerances:

  * a pooled unit (forward, bfloat16 output): at least 0.999 of the
    elements JAX's bits, each within two bfloat16 ulps of max(|JAX|,
    max|JAX| / 256) (measured: 0 → 0 all the bits, 1 → 0 0.99957 with 2
    ulps at most, 0 → 1 at C = 3 0.99986 with two, 1 → 1 (three Js, the
    stand-in) all the bits: where the M build's
    float32 sums in another order round an M otherwise, J's output moves
    by an ulp, and the bias add and the division by the neighbour count,
    each rounded, can carry that to two of the unit's output);
  * the model at hidden 128 (every pooled unit fused, A = 16) at the
    weights of JAX's own init: predictions within 0.4 of JAX's own
    bfloat16-vs-float32 gap, the parameter gradients' relative L2 within
    0.7 of it (the layers next to the output within 0.6), the loss within
    rtol 1e-2. `tests/test_torch_se3_bf16.py` holds the hidden-16 model to
    1/4, 0.7 and 1/4; at hidden 128 the port's forward reads 0.251 / 0.216
    / 0.412 (the reasons: `test_fused_bf16_model_matches_jax`).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from test_torch_pooled_conv_bf16 import assert_bf16_bits, standin
from test_torch_se3 import (
    CFG,
    GEN,
    _batches,
    _edge_case,
    _jax_edges,
    _port,
    _random_params,
    _t,
    _unflat,
)
from test_torch_se3_bf16 import LATE, _rel_l2

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.synthetic import make_synthetic_dataset
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.nn import se3_transformer as jse3
from equihgnn_tpu.ops.pallas import pooled_conv as jpc
from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import se3_transformer as tse3
from equihgnn_tpu_torch.train.trainer import masked_mse

torch.set_num_threads(1)

BF16 = jnp.bfloat16
FUSED = dict(CFG, mlp_hidden=128, compute_dtype="bfloat16")


def _f(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _counted(monkeypatch) -> dict:
    """Calls of `pooled_conv` and `pooled_m` in the port's SE(3) module."""
    calls = {"pooled_conv": 0, "pooled_m": 0}

    def counted(name, fn):
        def call(*args):
            calls[name] += 1
            return fn(*args)
        return call

    for name in calls:
        monkeypatch.setattr(tse3, name, counted(name, getattr(tse3, name)))
    return calls


# ------------------------------------------------------------ a pooled unit


@pytest.mark.parametrize("din,dout", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_pooled_unit_matches_jax(din, dout, monkeypatch):
    """`_ConvSE3Pair` pooled in bfloat16 at I = O = 128, F = 32, k = 6 (the
    gate fuses it) against JAX's module on the same bfloat16 inputs: C = 1
    and 1 → 1 (C = 3, three Js: the interleaved acc + J's output + its
    bias term, each rounded, over several Js) through the stand-in, 0 → 1
    through JAX's Pallas kernel; one call of the port's `pooled_conv` a J,
    none of `pooled_m`."""
    c = 2 * dout + 1
    if c == 1 or din == 1:
        monkeypatch.setattr(jpc, "pooled_conv", standin)
    pos, mask = _edge_case(g=2, a=9, seed=1)
    k, i, f = 6, 128, 32
    onehot, jmask, _, _, _ = _jax_edges(pos, mask, k)
    idx, nmask, _, wsh = tse3.se3_edges(_t(pos), _t(mask), k, 5.0, 2, dtype=torch.bfloat16)
    g, a = mask.shape
    assert jpc.pooled_conv_supported(a, k, c, i, f, i, BF16)
    rng = np.random.default_rng(3 + din + dout)
    xn = torch.from_numpy(rng.standard_normal((g, a, i, 2 * din + 1)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((1, g, a, k, f)).astype(np.float32))
    xn, h = xn.bfloat16(), (h * nmask[None, ..., None]).bfloat16()
    jargs = tuple(jnp.asarray(t.float().numpy()).astype(BF16) for t in (xn, h, wsh[(din, dout)]))
    jm = jse3._ConvSE3Pair(din=din, dout=dout, nc_in=i, nc_out=i, pool=True, radial_mid_dim=f)
    jin = (jargs[0], onehot.astype(BF16), jmask, jargs[2], jargs[1])
    flat = {key: v * 0.3 for key, v in _random_params(jm, *jin).items()}
    want = jax.jit(lambda v: jm.apply(v, *jin))(_unflat(flat))
    tm = _port(tse3._ConvSE3Pair(din, dout, i, i, True, 1, f, **GEN), flat)
    calls = _counted(monkeypatch)
    with torch.no_grad():
        got = tm(xn, idx, nmask, wsh[(din, dout)], h)
    assert got.dtype == torch.bfloat16 and want.dtype == BF16
    assert calls == {"pooled_conv": len(tse3._js(din, dout)), "pooled_m": 0}
    assert_bf16_bits(got.float().numpy(), _f(want), f"unit {din} -> {dout}", ulps=2.0)


@pytest.mark.parametrize("din,dout,a,width", [(0, 1, 320, 128), (0, 1, 314, 128),
                                              (0, 0, 9, 384), (1, 0, 9, 384)])
def test_unit_routes_where_jax_does(din, dout, a, width, monkeypatch):
    """One molecule row (G = 1), k = min(16, A − 1), F = 128, I = O = width: the port's
    unit takes the per-J path (`pooled_m`, once a J) where JAX's gate
    refuses (C = 3 at A = 320 and hidden 128; hidden 384 at any A), and the
    fused unit (`pooled_conv`, once a J) where it holds (C = 3 at A = 314)."""
    c, f, k = 2 * dout + 1, 128, min(16, a - 1)
    fused = jpc.pooled_conv_supported(a, k, c, width, f, width, BF16)
    assert fused == (a == 314)
    rng = np.random.default_rng(a + width)
    pos = torch.from_numpy((rng.standard_normal((1, a, 3)) * 2.0).astype(np.float32))
    idx, nmask, _, wsh = tse3.se3_edges(pos, torch.ones(1, a, dtype=torch.bool), k, 5.0, 2,
                                        dtype=torch.bfloat16)
    unit = tse3._ConvSE3Pair(din, dout, width, width, True, 1, f, **GEN)
    xn = torch.randn(1, a, width, 2 * din + 1, generator=torch.Generator().manual_seed(1))
    h = torch.randn(1, 1, a, k, f, generator=torch.Generator().manual_seed(2)) * nmask[..., None]
    calls = _counted(monkeypatch)
    with torch.no_grad():
        out = unit(xn.bfloat16(), idx, nmask, wsh[(din, dout)], h.bfloat16())
    assert out.dtype == torch.bfloat16 and out.shape == (1, 1, a, width, c)
    assert bool(torch.isfinite(out.float()).all())
    nj = len(tse3._js(din, dout))
    assert calls == ({"pooled_conv": nj, "pooled_m": 0} if fused
                     else {"pooled_conv": 0, "pooled_m": nj})


# --------------------------------------------------------------- the model


@pytest.fixture(scope="module")
def case():
    """The batch of `tests/test_torch_se3.py` (A = 16 slots); JAX's f32 and
    bf16 models at hidden 128 with the stand-in in place of the Pallas
    unit, at the weights of JAX's own init (seed 0): their loss,
    predictions and gradients."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpc, "pooled_conv", standin)
    try:
        pool = make_synthetic_dataset(40, seed=23, num_targets=1)
        jb, tb = _batches([s for s in pool if s.n_atoms <= 14][:4], batch_size=4)
        models = {dt: jax_create_model("se3_transformer_equihnns", num_target=1,
                                       cfg=JaxModelConfig(**dict(FUSED, compute_dtype=dt)))
                  for dt in (None, "bfloat16")}
        init = jax.jit(lambda key: models[None].init(key, jb, deterministic=True))(
            jax.random.PRNGKey(0))
        flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(init["params"],
                                                                        sep="/").items()}
        out = {}
        for dt, jm in models.items():
            def loss_fn(v, jm=jm):
                preds = jm.apply(v, jb, deterministic=True)
                sq, cnt = jax_masked_mse(preds, jb.y, jb.graph_mask)
                return sq / jnp.maximum(cnt, 1.0), preds

            (loss, preds), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
                _unflat(flat))
            out[dt] = float(loss), np.asarray(preds), {
                k: np.asarray(v) for k, v in traverse_util.flatten_dict(grads["params"],
                                                                         sep="/").items()}
    finally:
        mp.undo()
    return dict(tb=tb, flat=flat, jax=out)


def test_fused_bf16_model_matches_jax(case, monkeypatch):
    """Predictions and masked-MSE gradients against JAX's bf16 model at the
    weights of JAX's own init, each within its share of JAX's own
    bf16-vs-f32 gap; every parameter reached in both; every pooled unit
    fused (4 calls of `pooled_conv` a forward, none again in the backward:
    the fused unit has no checkpoint), no `pooled_m`.

    Measured: predictions 0.251 of the gap apart (0.010 against 0.041),
    gradients 0.216 (the layers next to the output 0.412). At this width
    the port's bf16 forward lies farther from JAX's, relative to the gap,
    than at hidden 16 (`tests/test_torch_se3_bf16.py`: 0.07): it differs
    from JAX's in a few bits outside the pooled units (the radial trunks:
    0.9993 of JAX's bits, float32 sums in another order before a rounding),
    and the 128-channel attention carries them further. The pooled units
    are not the cause: their four units have one J each, where the fused
    unit and the per-J path round alike, and with both frameworks forced
    onto the per-J path the readings are the same to the last digit. At
    the scales of `tests/test_torch_se3.py`'s `_init_like_params` the
    model is chaotic at this width (the second attention's logits ~3e4, a
    hard argmax; a 1/256 change of one radial-trunk weight moved the
    predictions by 0.23, the gap being 0.085), and no comparison of
    predictions is held there."""
    tb = case["tb"]
    mask = tb.graph_mask.numpy()
    calls = _counted(monkeypatch)
    model = _port(create_model("se3_transformer_equihnns", num_target=1,
                               cfg=ModelConfig(**FUSED)), case["flat"])
    preds = model(tb)
    assert calls == {"pooled_conv": 4, "pooled_m": 0}
    assert preds.dtype == torch.float32
    loss16, preds16, grads16 = case["jax"]["bfloat16"]
    _, preds32, grads32 = case["jax"][None]
    gap = float(np.abs(preds16 - preds32)[mask].max())
    err = float(np.abs(preds.detach().numpy() - preds16)[mask].max())
    assert 0.0 < err <= 0.4 * gap, f"predictions: max|port - JAX| {err:.3e}, the gap {gap:.3e}"
    sq, cnt = masked_mse(preds, tb.y, tb.graph_mask)
    loss = sq / torch.clamp(cnt, min=1.0)
    loss.backward()
    assert calls == {"pooled_conv": 4, "pooled_m": 0}
    np.testing.assert_allclose(float(loss.detach()), loss16, rtol=1e-2)
    want16, want32 = (params_from_jax(g, model) for g in (grads16, grads32))
    got = {}
    for name, p in model.named_parameters():
        assert p.grad is not None and float(p.grad.abs().max()) > 0.0, name
        assert float(want16[name].abs().max()) > 0.0, name
        got[name] = p.grad
    for what, names, share in (("all parameters", list(got), 0.7),
                               ("the layers next to the output",
                                [n for n in got if n.startswith(LATE)], 0.6)):
        gap = _rel_l2(want16, want32, names)
        err = _rel_l2(got, want16, names)
        assert err <= share * gap, f"gradients of {what}: {err:.3e} > {share} * {gap:.3e}"


def test_fused_bf16_trains_through_the_cli_and_serves(tmp_path, monkeypatch):
    """`main.run --compute_dtype bfloat16 --MLP_hidden 128` on the CPU
    through the fused units (`pooled_conv` on every forward, `pooled_m`
    never); the checkpoint keeps the compute dtype, and `predict.run`
    serves the SDF sample's first six molecules from it in bfloat16."""
    from equihgnn_tpu_torch.main import build_parser, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import load_checkpoint
    from equihgnn_tpu_torch.predict import run as predict_run

    monkeypatch.chdir(tmp_path)
    calls = _counted(monkeypatch)
    args = build_parser().parse_args([
        "--data", "synthetic_hg_3d", "--method", "se3_transformer_equihnns", "--device", "cpu",
        "--synthetic_size", "16", "--synthetic_max_atoms", "9", "--batch_size", "8",
        "--epochs", "1", "--MLP_hidden", "128", "--output_hidden", "8",
        "--compute_dtype", "bfloat16", "--lr", "1e-3"])
    res = run(args)
    losses = [h["train_loss"] for h in res["history"]]
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert calls["pooled_conv"] > 0 and calls["pooled_m"] == 0
    ckpt = str(tmp_path / res["log_dir"] / "ckpt_best.pt")
    meta, _ = load_checkpoint(ckpt)
    assert meta["model_config"]["compute_dtype"] == "bfloat16"
    assert meta["model_config"]["mlp_hidden"] == 128
    sample = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "datasets",
                          "real_sample", "sample.sdf")
    with open(sample) as fh:  # its first 6 molecules (bf16 on the CPU is slow)
        blocks = fh.read().split("$$$$\n")[:6]
    sdf = tmp_path / "six.sdf"
    sdf.write_text("$$$$\n".join(blocks) + "$$$$\n")
    calls.update(pooled_conv=0)
    out = predict_run(predict_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", str(sdf), "--out", str(tmp_path / "preds.csv"),
         "--device", "cpu"]))
    assert calls == {"pooled_conv": 4, "pooled_m": 0}
    with open(out) as fh:
        rows = fh.read().strip().splitlines()[1:]
    vals = np.array([float(r.rsplit(",", 1)[-1]) for r in rows])
    assert len(vals) == 6 and np.isfinite(vals).all()
