"""Port's SE(3)-Transformer (`equihgnn_tpu_torch/nn/se3_transformer.py`,
`ops/sh.py`, `ops/so3.py`, `ops/kernels/pooled_conv.py`) and
`se3_transformer_equihnns` vs the JAX package, on the CPU.

Inputs are numpy-seeded and fed to both frameworks; weights come from
numpy at the JAX modules' parameter shapes (`jax.eval_shape` of the init)
and reach the port through `params_from_jax`. JAX calls are jitted; its
Pallas `pooled_conv` runs in interpret mode. Tolerances (f32, other
summation orders), each per tensor, max |Δ| against max |JAX|:

  * CG tensors, harmonics, norm constants: atol 1e-6;
  * modules and the pooled conv's forward: 1e-4·max |JAX| + 1e-6;
  * the pooled conv's VJP (dh, dtc, dW) and the model's parameter
    gradients: 1e-3·max |JAX| + 1e-6;
  * the model's predictions: 1e-4·max |JAX| + 1e-6;
  * three Adam steps: losses within rtol 1e-5 and parameters within
    1e-2·lr, as `tests/test_torch_train.py`, except at most 1e-4 of a
    tensor's elements (one at least), each within 3·lr: those whose
    gradient plus decay lies within rounding of 0, where Adam's update
    takes the gradient's sign (ROADMAP §3);
  * rotation and translation invariance of the port alone: rtol 1e-3,
    atol 1e-4, as `tests/test_se3_transformer.py`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from scipy.stats import ortho_group

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.data.synthetic import make_synthetic_dataset
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.nn import se3_transformer as jse3
from equihgnn_tpu.ops import sh as jsh
from equihgnn_tpu.ops import so3 as jso3
from equihgnn_tpu.ops.knn import knn_dense as jax_knn_dense
from equihgnn_tpu.ops.pallas import pooled_conv as jpc
from equihgnn_tpu.ops.pallas.pooled_conv import pooled_conv as jax_pooled_conv
from equihgnn_tpu.train.trainer import Trainer as JaxTrainer
from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import se3_transformer as tse3
from equihgnn_tpu_torch.ops import sh as tsh
from equihgnn_tpu_torch.ops import so3 as tso3
from equihgnn_tpu_torch.ops.kernels.pooled_conv import (
    pooled_conv,
    pooled_conv_bwd_plain,
    pooled_conv_plain,
)
from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer, masked_mse

torch.set_num_threads(1)

GEN = dict(generator=torch.Generator().manual_seed(0))
CFG = dict(mlp_hidden=16, output_hidden=8, all_num_layers=3, output_num_layers=3,
           aggregate="mean", normalization="ln")
SLOT_TABLES = ("hedge_row", "hedge_slot", "hedge_slot_index", "hedge_slot_mask",
               "inc_slot_atom", "inc_slot_hedge", "inc_slot_mask")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


def _assert_rel(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, f"{name}: shape {got.shape} != {want.shape}"
    err = float(np.abs(got - want).max()) if want.size else 0.0
    limit = tol * (float(np.abs(want).max()) if want.size else 0.0) + 1e-6
    assert err <= limit, f"{name}: max |d| {err:.3e} > {limit:.3e}"


def _random_params(jmodule, *args, seed=0, **kw):
    """Flat {flax path: numpy} at the module's parameter shapes, O(0.2)
    draws; scales (LayerNorm, NormSE3) around 1."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in traverse_util.flatten_dict(shapes["params"], sep="/").items():
        x = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        flat[k] = x + 1.0 if "scale" in k.rsplit("/", 1)[-1] else x
    return flat


def _unflat(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def _port(module, flat):
    module.load_state_dict(params_from_jax(flat, module))
    return module.eval()


# ------------------------------------------------------------- SO(3) math


def test_clebsch_gordan_and_harmonics_match_jax():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(3):
                np.testing.assert_allclose(tso3.real_clebsch_gordan(l1, l2, l3),
                                           jso3.real_clebsch_gordan(l1, l2, l3), atol=1e-6,
                                           err_msg=f"CG({l1},{l2},{l3})")
    np.testing.assert_allclose(tso3.sh_norm_constants(3), jso3.sh_norm_constants(3), atol=1e-6)
    rng = np.random.default_rng(0)
    v = (rng.standard_normal((40, 3)) * 2.0).astype(np.float32)
    v[0] = 0.0  # the zero vector maps to zero harmonics for l >= 1
    got = tsh.spherical_harmonics(2, _t(v))
    want = jsh.spherical_harmonics(2, jnp.asarray(v))
    for lv, (a_, b_) in enumerate(zip(got, want)):
        np.testing.assert_allclose(_np(a_), np.asarray(b_), atol=1e-6, err_msg=f"Y_{lv}")
    assert float(got[1][0].abs().max()) == float(got[2][0].abs().max()) == 0.0


# -------------------------------------------------------------- the modules


def _fiber_inputs(g=3, a=6, dims=(8, 8), seed=0):
    rng = np.random.default_rng(seed)
    return {d: rng.standard_normal((g, a, n, 2 * d + 1)).astype(np.float32)
            for d, n in enumerate(dims)}


@pytest.mark.parametrize("kind", ["linear", "norm", "radial"])
def test_small_modules_match_jax(kind):
    x = _fiber_inputs()
    rd = (np.random.default_rng(1).random((3, 6, 4, 1)) * 6).astype(np.float32)
    if kind == "linear":
        jm, tm, arg = jse3.LinearSE3((8, 8), (5, 7)), tse3.LinearSE3((8, 8), (5, 7), **GEN), x
    elif kind == "norm":
        x[1][0, 0] = 0.0  # a zero feature: zero phase
        jm, tm, arg = jse3.NormSE3((8, 8)), tse3.NormSE3((8, 8)), x
    else:
        jm, tm, arg = jse3.StackedRadialTrunk(n=3), tse3.StackedRadialTrunk(3, **GEN), rd
    jarg = jax.tree.map(jnp.asarray, arg)
    flat = _random_params(jm, jarg)
    tm = _port(tm, flat)
    want = jax.jit(lambda v: jm.apply(v, jarg))(_unflat(flat))
    with torch.no_grad():
        got = tm({d: _t(t) for d, t in arg.items()} if isinstance(arg, dict) else _t(arg))
    if isinstance(want, dict):
        assert set(got) == set(want)
        for d in want:
            _assert_rel(_np(got[d]), want[d], 1e-4, f"{kind} degree {d}")
    else:
        _assert_rel(_np(got), want, 1e-4, kind)


# ------------------------------------------------------- pooled conv (J, K)


def _pc_inputs(g=2, a=5, k=4, c=1, i=8, f=16, o=128, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, a, k, f)).astype(np.float32),
            rng.standard_normal((g, a, k, c * i)).astype(np.float32),
            (rng.standard_normal((f, o, i)) * 0.1).astype(np.float32),
            rng.standard_normal((g, a, c, o)).astype(np.float32))


def _check_pooled_conv(h, tc, w, dout, c, out, want):
    got = pooled_conv(_t(h), _t(tc), _t(w), c)  # the wrapper on CPU tensors: the plain version
    _assert_rel(_np(got), out, 1e-4, "out")
    for name, x, y in zip(("dh", "dtc", "dW"),
                          pooled_conv_bwd_plain(_t(h), _t(tc), _t(w), c, _t(dout)), want):
        _assert_rel(_np(x), y, 1e-3, name)
    # autograd through the wrapper's CPU path gives the same backward
    leaves = [_t(x).requires_grad_() for x in (h, tc, w)]
    pooled_conv(*leaves, c).backward(_t(dout))
    for name, leaf, y in zip(("dh", "dtc", "dW"), leaves, want):
        _assert_rel(_np(leaf.grad), y, 1e-3, f"autograd {name}")


def test_pooled_conv_plain_matches_pallas_kernel():
    """The plain versions of kernels J and K against JAX's `pooled_conv`
    (its Pallas kernels in interpret mode) and `jax.vjp`'s dh, dtc, dW, at a
    shape its TPU gate accepts (I % 4 = 0, F % 8 = 0, O % 128 = 0). C = 3
    only: the interpret-mode kernels unroll ~256 / C sites, and C = 1 takes
    50 s here; C = 1 is held to JAX's f32 composition below."""
    c = 3
    h, tc, w, dout = _pc_inputs(c=c, seed=c)
    out, vjp = jax.vjp(lambda *a: jax_pooled_conv(*a, c), *map(jnp.asarray, (h, tc, w)))
    _check_pooled_conv(h, tc, w, dout, c, out, vjp(jnp.asarray(dout)))


@pytest.mark.parametrize("c", [1, 5])
def test_pooled_conv_plain_matches_jax_f32_path(c):
    """The same against the einsums JAX's f32 model runs for a pooled unit
    (`se3_transformer.py:292-295`, the M build and its projection)."""
    h, tc, w, dout = _pc_inputs(k=6, c=c, i=12, f=16, o=24, seed=c)
    g, a, k, _ = h.shape

    def unit(h_, t_, w_):
        m = jnp.einsum("gakf,gakci->gafci", h_, t_.reshape(g, a, k, c, -1))
        return jnp.einsum("foi,gafci->gaco", w_, m)

    @jax.jit
    def fwd_vjp(h_, t_, w_, d_):
        out_, vjp = jax.vjp(unit, h_, t_, w_)
        return out_, vjp(d_)

    out, want = fwd_vjp(*map(jnp.asarray, (h, tc, w, dout)))
    _check_pooled_conv(h, tc, w, dout, c, out, want)


@pytest.mark.parametrize("k,c", [(0, 5), (3, 5), (16, 3)])
def test_pooled_conv_plain_any_k_and_c(k, c):
    """k = 0 (a batch of one-atom molecules) gives zeros; C = 5 and a
    ragged I, F, O against one einsum in float64."""
    h, tc, w, dout = _pc_inputs(g=3, a=4, k=k, c=c, i=5, f=7, o=9, seed=k)
    got = pooled_conv_plain(_t(h), _t(tc), _t(w), c)
    want = np.einsum("gakf,gakci,foi->gaco", h.astype(np.float64),
                     tc.reshape(3, 4, k, c, 5).astype(np.float64), w.astype(np.float64))
    _assert_rel(_np(got), want, 1e-5, "out")
    dh, dtc, dw = pooled_conv_bwd_plain(_t(h), _t(tc), _t(w), c, _t(dout))
    assert dh.shape == h.shape and dtc.shape == tc.shape and dw.shape == w.shape
    if k == 0:
        assert float(got.abs().max()) == float(dw.abs().max()) == 0.0


def test_pooled_conv_raises_on_other_devices():
    h, tc, w, _ = map(_t, _pc_inputs())
    with pytest.raises(ValueError, match="unsupported device"):
        pooled_conv(h.to("meta"), tc, w, 1)


# --------------------------------------------------------------- edge inputs


def _edge_case(g=3, a=9, seed=0, scale=2.0):
    """Slot coordinates of molecules of 2..a atoms, spread so that some
    neighbours lie beyond 5 Å."""
    rng = np.random.default_rng(seed)
    mask = np.arange(a)[None, :] < rng.integers(2, a + 1, size=g)[:, None]
    mask[0] = True
    pos = (rng.standard_normal((g, a, 3)) * scale).astype(np.float32) * mask[..., None]
    return pos, mask


def _jax_edges(pos, mask, k, num_degrees=2):
    """JAX's `SE3Transformer.__call__` edge block (`se3_transformer.py:560-605`)."""
    pd, sm = jnp.asarray(pos), jnp.asarray(mask)
    g_, a_ = sm.shape
    nbr_idx, nbr_mask, sqd = jax_knn_dense(pd, sm, k, valid_radius=5.0, squared_radius=False,
                                           exclude_self=True)
    rel_pos = pd[:, :, None, :] - pd[jnp.arange(g_)[:, None, None], nbr_idx]
    rel_dist = jnp.where(nbr_mask, jnp.sqrt(jnp.maximum(sqd, 0.0)), 0.0)[..., None]
    sh = jsh.spherical_harmonics(2 * (num_degrees - 1), rel_pos)
    onehot = ((nbr_idx[..., None] == jnp.arange(a_)[None, None, None, :])
              & nbr_mask[..., None]).astype(jnp.float32)
    wsh = {(di, do): jnp.stack([jnp.einsum("bmc,gakm->gakbc", jnp.asarray(jse3._cg(di, J, do)),
                                           sh[J]) for J in range(abs(di - do), di + do + 1)],
                               axis=3)
           for di in range(num_degrees) for do in range(num_degrees)}
    return onehot, nbr_mask, rel_dist, wsh, nbr_idx


def test_edge_inputs_match_jax():
    pos, mask = _edge_case()
    onehot, jmask, jrd, jwsh, jidx = _jax_edges(pos, mask, 8)
    idx, nmask, rd, wsh = tse3.se3_edges(_t(pos), _t(mask), 8, 5.0, 2)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(nmask), np.asarray(jmask))
    assert 0 < int(nmask.sum()) < int(np.asarray(jax_knn_dense(
        jnp.asarray(pos), jnp.asarray(mask), 8, exclude_self=True)[1]).sum())  # some beyond 5 Å
    _assert_rel(_np(rd), jrd, 1e-6, "rel_dist")
    for key in jwsh:
        _assert_rel(_np(wsh[key]), jwsh[key], 1e-5, f"wsh {key}")


def _conv_case(fiber_in, seed=0):
    pos, mask = _edge_case(seed=seed)
    k = 8
    jedges = _jax_edges(pos, mask, k)
    tedges = tse3.se3_edges(_t(pos), _t(mask), k, 5.0, 2)
    x = _fiber_inputs(g=pos.shape[0], a=pos.shape[1], dims=fiber_in, seed=seed + 7)
    return jedges, tedges, x


@pytest.mark.parametrize("fiber_in,fiber_out,pool,stack", [
    ((8,), (8, 8), True, 1),  # conv_in
    ((8, 8), (8,), True, 1),  # conv_out
    ((8, 8), (6, 6), False, 2),  # the attention's keys and values
])
def test_conv_se3_matches_jax(fiber_in, fiber_out, pool, stack):
    (onehot, jmask, jrd, jwsh, _), (idx, nmask, rd, wsh), x = _conv_case(fiber_in)
    jm = jse3.ConvSE3(fiber_in, fiber_out, pool=pool, self_interaction=pool, stack=stack)
    jx = {d: jnp.asarray(t) for d, t in x.items()}
    flat = _random_params(jm, jx, onehot, jmask, jrd, jwsh)
    tm = _port(tse3.ConvSE3(fiber_in, fiber_out, pool=pool, self_interaction=pool, stack=stack,
                            **GEN), flat)
    want = jax.jit(lambda v: jm.apply(v, jx, onehot, jmask, jrd, jwsh))(_unflat(flat))
    with torch.no_grad():
        got = tm({d: _t(t) for d, t in x.items()}, idx, nmask, rd, wsh)
    want = want if stack > 1 else [want]
    got = got if stack > 1 else [got]
    for si, (gs, ws) in enumerate(zip(got, want)):
        for d in ws:
            _assert_rel(_np(gs[d]), ws[d], 1e-4, f"stack {si} degree {d}")


def test_attention_se3_matches_jax():
    (onehot, jmask, jrd, jwsh, _), (idx, nmask, rd, wsh), x = _conv_case((8, 8), seed=3)
    jm = jse3.AttentionSE3((8, 8), dim_head=4, heads=2)
    jx = {d: jnp.asarray(t) for d, t in x.items()}
    flat = _random_params(jm, jx, onehot, jmask, jrd, jwsh)
    tm = _port(tse3.AttentionSE3((8, 8), dim_head=4, heads=2, **GEN), flat)
    want = jax.jit(lambda v: jm.apply(v, jx, onehot, jmask, jrd, jwsh))(_unflat(flat))
    with torch.no_grad():
        got = tm({d: _t(t) for d, t in x.items()}, idx, nmask, rd, wsh)
    for d in want:
        _assert_rel(_np(got[d]), want[d], 1e-4, f"degree {d}")


# ---------------------------------------------------------- the whole model


def _jax_batch(samples, spec):
    jb = jax_pad(samples, spec, target=0, with_pos=True)
    return jax.tree.map(jnp.asarray, dataclasses.replace(jb, **{f: None for f in SLOT_TABLES}))


def _batches(samples, batch_size):
    jspec, tspec = jax_spec(samples, batch_size=batch_size), spec_for_samples(samples, batch_size)
    return _jax_batch(samples, jspec), pad_hypergraph_batch(samples, tspec, target=0,
                                                            with_pos=True)


def _init_like_params(jm, jb, seed=0):
    """Numpy weights at the scales of the model's own init (normal(1/√in)
    for every matrix, U(±1) for the radial trunks' first layer, scales
    around 1): `_random_params`' O(0.2) draws make the attention logits
    O(100), so that the softmax saturates and its gradients drown in
    rounding, in JAX as in the port. `jax.eval_shape` gives the shapes
    without compiling the init."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb, deterministic=True))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in traverse_util.flatten_dict(shapes["params"], sep="/").items():
        leaf, z = k.rsplit("/", 1)[-1], rng.standard_normal(v.shape)
        if "scale" in leaf:
            x = 1.0 + 0.1 * z
        elif leaf in ("lin0_w", "lin0_b"):
            x = rng.uniform(-1.0, 1.0, v.shape)
        elif leaf == "lin1_w":
            x = z / np.sqrt(v.shape[-1])
        elif len(v.shape) >= 2:
            x = z / np.sqrt(v.shape[0])
        else:
            x = 0.1 * z
        flat[k] = x.astype(np.float32)
    return flat


@pytest.fixture(scope="module")
def model_case():
    """A batch of molecules of at most 14 atoms (A = 16 slots, so k = 15 <
    16), some of whose 15 nearest neighbours lie beyond 5 Å; the JAX model
    and weights at init scales."""
    pool = make_synthetic_dataset(40, seed=23, num_targets=1)
    jb, tb = _batches([s for s in pool if s.n_atoms <= 14][:4], batch_size=4)
    jm = jax_create_model("se3_transformer_equihnns", num_target=1, cfg=JaxModelConfig(**CFG))
    return jb, tb, jm, _init_like_params(jm, jb)


def test_model_forward_and_grads_match_jax(model_case):
    """Predictions and masked-MSE parameter gradients at matched weights:
    every parameter reaches the loss, in JAX as in the port, with equal
    gradients."""
    jb, tb, jm, flat = model_case
    g, a = tb.slot_mask.shape
    assert min(16, a - 1) < 16
    pd = tb.pos.index_select(0, tb.slot_index.reshape(-1)).view(g, a, 3) * tb.slot_mask[..., None]
    _, nmask, rd, _ = tse3.se3_edges(pd, tb.slot_mask, 16, 1e9, 2)
    assert bool((rd[..., 0][nmask] > 5.0).any())  # neighbours that the 5 Å radius masks

    def loss_fn(v):
        preds = jm.apply(v, jb, deterministic=True)
        sq, cnt = jax_masked_mse(preds, jb.y, jb.graph_mask)
        return sq / jnp.maximum(cnt, 1.0), preds

    (jloss, jpreds), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(_unflat(flat))
    model = _port(create_model("se3_transformer_equihnns", num_target=1, cfg=ModelConfig(**CFG)),
                  flat)
    want = params_from_jax({k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jgrads["params"], sep="/").items()}, model)
    preds = model(tb)
    _assert_rel(_np(preds), jpreds, 1e-4, "predictions")
    sq, cnt = masked_mse(preds, tb.y, tb.graph_mask)
    loss = sq / torch.clamp(cnt, min=1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    for name, p in model.named_parameters():
        assert float(want[name].abs().max()) > 0.0 and p.grad is not None, name
        _assert_rel(_np(p.grad), _np(want[name]), 1e-3, name)


def test_params_from_jax_covers_the_se3_tree(model_case):
    jb, _, jm, _ = model_case
    flat = _random_params(jm, jb, deterministic=True)
    model = create_model("se3_transformer_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    state = params_from_jax(flat, model)
    assert set(state) == set(model.state_dict()) and len(state) == len(flat)
    for key, shape in (("se3_transformer_layer.attn_1.to_kv.pair_1_1.radial_0_out_W",
                        (128, 64, 16, 3)),
                       ("se3_transformer_layer.conv_out.radial_trunks.lin1_w", (2, 128, 128)),
                       ("se3_transformer_layer.ff_0.nonlin.scale1", (64,)),
                       ("se3_transformer_layer.attn_0.to_q.w0", (16, 64))):
        assert tuple(state[key].shape) == shape, key
        np.testing.assert_array_equal(state[key].numpy(), flat[key.replace(".", "/")])


def test_rotation_translation_invariance(model_case):
    _, tb, _, flat = model_case
    model = _port(create_model("se3_transformer_equihnns", num_target=1, cfg=ModelConfig(**CFG)),
                  flat)
    R = ortho_group.rvs(3, random_state=21)
    R = torch.tensor(R * np.sign(np.linalg.det(R)), dtype=torch.float32)
    moved = dataclasses.replace(tb, pos=tb.pos @ R.T + torch.tensor([0.5, 1.5, -2.0]))
    with torch.no_grad():
        out1, out2 = model.encode(tb), model.encode(moved)
    m = tb.atom_mask
    torch.testing.assert_close(out2[m], out1[m], rtol=1e-3, atol=1e-4)


def test_three_adam_steps_match_jax(model_case):
    """Three steps of the JAX trainer's own step function (built by
    `Trainer._build_train_step`, without the trainer's eager init) and of
    the port's `Trainer.train_step`, on batches of small molecules."""
    from equihgnn_tpu.train.trainer import _adam_like

    _, _, jm, flat = model_case
    samples = [s for s in make_synthetic_dataset(60, seed=5, num_targets=1) if s.n_atoms <= 9]
    jspec, tspec = jax_spec(samples[:6], batch_size=4), spec_for_samples(samples[:6], 4)
    pairs = [(_jax_batch(samples[i * 2:(i + 1) * 2], jspec),
              pad_hypergraph_batch(samples[i * 2:(i + 1) * 2], tspec, target=0, with_pos=True))
             for i in range(3)]
    lr, wd = 1e-3, 0.05
    jt = JaxTrainer.__new__(JaxTrainer)
    jt.model, jt.tx, jt.batch_stats, jt.mesh = jm, _adam_like(wd), {}, None
    step = jt._build_train_step()
    params = traverse_util.unflatten_dict({k: jnp.asarray(v) for k, v in flat.items()}, sep="/")
    opt_state, stats, key = jt.tx.init(params), {}, jax.random.PRNGKey(1)
    model = create_model("se3_transformer_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    model.load_state_dict(params_from_jax(flat, model))
    tt = Trainer(model, TrainConfig(lr=lr, weight_decay=wd, seed=0), std=1.0, device="cpu")
    tt.set_lr(lr)
    for jb, tb in pairs:
        params, opt_state, stats, jloss, key = step(params, opt_state, stats, jb,
                                                    np.float32(lr), key)
        np.testing.assert_allclose(float(tt.train_step(tb)), float(jloss), rtol=1e-5)
    want = params_from_jax(
        {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()},
        tt.model)
    got = tt.model.state_dict()
    for name, w in want.items():
        d = (got[name] - w).abs()
        # Adam's first update is lr·g/(|g| + 1e-8), the sign of g: an element
        # whose gradient plus decay lies within rounding of 0 may step the
        # other way (ROADMAP §3); three steps move it by at most ~3·lr
        far = d > 1e-2 * lr
        assert int(far.sum()) <= max(1, w.numel() // 10_000), f"{name}: {int(far.sum())} elements"
        assert float(d.max()) <= 3 * lr, f"{name}: max |d| {float(d.max()):.3e}"


def test_one_atom_batch_has_no_neighbours():
    """A batch of methane alone has one slot a row, so k = min(16, A − 1) = 0:
    every neighbour sum is empty, as for methane in a wider batch, whose
    neighbours are all masked. Both give the same prediction."""
    import os

    from equihgnn_tpu_torch.predict import featurize_sdf, predict_samples

    sdf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "datasets",
                       "real_sample", "sample.sdf")
    mols = [m for _, m in featurize_sdf(sdf)][:4]
    assert mols[0].n_atoms == 1
    model = create_model("se3_transformer_equihnns", num_target=1,
                         cfg=ModelConfig(mlp_hidden=16, output_hidden=8)).eval()
    alone = predict_samples(model, mols[:1], 1, torch.device("cpu"))
    together = predict_samples(model, mols, 4, torch.device("cpu"))
    assert np.isfinite(alone).all()
    np.testing.assert_allclose(alone[0], together[0], rtol=1e-5, atol=1e-6)


def test_unported_options_raise(monkeypatch):
    """Another compute dtype raises. bfloat16 at hidden 256, where JAX fuses
    the pooled units, builds, and a pooled unit of it takes the route JAX's
    gate gives it at the call's shapes: the fused unit (`pooled_conv`) at
    A = 8, k = 7, C = 3 (`tests/test_torch_se3_bf16_fused.py` holds the
    route and the numbers). `remat` is ported: the model builds, and its
    encoder is a checkpoint (`tests/test_torch_remat.py` holds its step)."""
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        create_model("se3_transformer_equihnns", num_target=1,
                     cfg=ModelConfig(**{**CFG, "compute_dtype": "float16"}))
    model = create_model("se3_transformer_equihnns", num_target=1,
                         cfg=ModelConfig(**{**CFG, "compute_dtype": "bfloat16",
                                            "mlp_hidden": 256}))
    assert model.se3_transformer_layer.dtype == torch.bfloat16
    assert jpc.pooled_conv_supported(8, 7, 3, 256, 128, 256, jnp.bfloat16)
    calls = []
    monkeypatch.setattr(tse3, "pooled_conv", lambda *a: calls.append("J") or pooled_conv(*a))
    monkeypatch.setattr(tse3, "pooled_m", lambda *a: calls.append("L"))
    pos, mask = _edge_case(g=1, a=8, seed=2)
    idx, nmask, _, wsh = tse3.se3_edges(_t(pos), _t(mask), 7, 5.0, 2, dtype=torch.bfloat16)
    gen = torch.Generator().manual_seed(0)
    xn = torch.randn(1, 8, 256, 1, generator=gen).bfloat16()
    h = (torch.randn(1, 1, 8, 7, 128, generator=gen) * nmask[..., None]).bfloat16()
    with torch.no_grad():
        out = model.se3_transformer_layer.conv_in.pair_0_1(xn, idx, nmask, wsh[(0, 1)], h)
    assert calls == ["J"] and out.dtype == torch.bfloat16 and out.shape == (1, 1, 8, 256, 3)
    model = create_model("se3_transformer_equihnns", num_target=1,
                         cfg=ModelConfig(**CFG, remat=True))
    assert model.cfg.remat


def test_init_distributions():
    model = create_model("se3_transformer_equihnns", num_target=1,
                         cfg=ModelConfig(mlp_hidden=32, output_hidden=8),
                         generator=torch.Generator().manual_seed(0))
    se3 = model.se3_transformer_layer
    w = se3.attn_0.to_q.w0.detach()  # normal(1/√in), in = 32
    assert abs(float(w.std()) - 32 ** -0.5) < 0.02 and abs(float(w.mean())) < 0.02
    assert float(se3.conv_in.radial_trunks.lin0_w.detach().abs().max()) <= 1.0
    assert float(se3.conv_in.pair_0_0.radial_out_W.detach().abs().max()) <= 128 ** -0.5
    assert torch.all(se3.ff_0.nonlin.scale1 == 1.0)
    again = create_model("se3_transformer_equihnns", num_target=1,
                         cfg=ModelConfig(mlp_hidden=32, output_hidden=8),
                         generator=torch.Generator().manual_seed(0))
    for (n, a_), (_, b_) in zip(model.state_dict().items(), again.state_dict().items()):
        assert torch.equal(a_, b_), n
