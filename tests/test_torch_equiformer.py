"""Port's Equiformer (`equihgnn_tpu_torch/nn/equiformer.py`) and
`equiformer_equihnns` vs the JAX package, on the CPU.

Inputs are numpy-seeded and fed to both frameworks; weights are drawn from
numpy at the JAX modules' parameter shapes (`jax.eval_shape` of the init)
at the scales of the modules' own init (`init_like`), with the weights
that init to zero (`MLPAttention.to_out`, `FeedForward.project_out`) drawn
at FiberLinear's non-zero scale 1/√dim_in: at zero both branches add
exactly 0 and their inner weights get exactly zero gradient, so a
comparison at the init would hold nothing of them. The weights reach the
port through `params_from_jax`; JAX calls are jitted. Widths: fibers of 16
(8 for the modules), dim_head 8, k ≤ 6, molecules of 6 atoms and more.
Tolerances (f32, other summation orders), per tensor, max |Δ| against
max |JAX|:

  * CG tensors and the helpers: exact / atol 1e-6;
  * module and trunk outputs, predictions: 1e-5·max |JAX| + 1e-6;
  * gradients (of parameters and inputs): 1e-4·max |JAX| + 1e-6;
  * one Adam step: loss rtol 1e-5, parameters within 1e-2·lr, except the
    elements whose gradient lies below 1e-3 of its tensor's max, where
    Adam's first update is rounding's sign: those moved by at most lr;
  * rotation and translation: type 0 invariant and type 1 equivariant to
    rtol 1e-3, atol 1e-4, as `tests/test_equiformer.py`.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from scipy.stats import ortho_group

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.common.registry import registry as jax_registry
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.nn import equiformer as jeq
from equihgnn_tpu.ops.so3 import wigner_d_rotation
from equihgnn_tpu.train.trainer import _adam_like
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.common.registry import registry
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import equiformer as teq
from equihgnn_tpu_torch.ops.knn import knn_dense
from equihgnn_tpu_torch.ops.sh import spherical_harmonics
from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer, masked_mse
from test_torch_mhnn import _flat, _jax_run, jax_batch, jax_reference

torch.set_num_threads(1)

GEN = dict(generator=torch.Generator().manual_seed(0))
CFG = dict(mlp_hidden=16, output_hidden=8, all_num_layers=3, output_num_layers=3,
           dropout=0.0)


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


def init_like(shapes, seed=0):
    """Flat {flax path: numpy}: every `w{d}` normal(1/√in) (the zero-init
    ones too), TorchLinear kernels and the radial projections
    U(±1/√fan_in), norm scales 1 + 0.1·z, biases and tables 0.1·z."""
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in traverse_util.flatten_dict(shapes, sep="/").items():
        leaf, z = k.rsplit("/", 1)[-1], rng.standard_normal(v.shape)
        if leaf.startswith("scale"):
            x = 1.0 + 0.1 * z
        elif re.fullmatch(r"w\d+", leaf):
            x = z / np.sqrt(v.shape[0])
        elif leaf == "kernel" or leaf.endswith("_out_W"):
            x = rng.uniform(-1.0, 1.0, v.shape) / np.sqrt(v.shape[0])
        else:
            x = 0.1 * z
        flat[k] = x.astype(np.float32)
    return flat


def _unflat(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def _port(module, flat):
    module.load_state_dict(params_from_jax(flat, module))
    return module.eval()


# ------------------------------------------------------------ the inputs


def _edges(g=3, a=7, k=4, seed=0):
    """Random slot rows of 7, 5 and 3 atoms (the last has fewer than k + 1,
    so its padding slots meet each other at rel_pos = 0), their k nearest
    other slots within 1.6: (nbr_idx, nbr_mask, rel_dist, sh) as numpy."""
    rng = np.random.default_rng(seed)
    sm = np.arange(a)[None, :] < np.array([a, 5, 3])[:g, None]
    pd = (rng.standard_normal((g, a, 3)) * sm[..., None]).astype(np.float32)
    idx, mask, sqd = knn_dense(_t(pd), _t(sm), k, valid_radius=1.6, exclude_self=True)
    rows = torch.arange(g)[:, None, None]
    rel_pos = _t(pd)[:, :, None] - _t(pd)[rows, idx]
    rd = torch.where(mask, torch.sqrt(sqd.clamp(min=0)), torch.zeros(()))[..., None]
    assert bool(mask.any()) and not bool(mask.all())
    return [_np(idx), _np(mask), _np(rd), [_np(y) for y in spherical_harmonics(2, rel_pos)]]


def _fiber(dims, g=3, a=7, seed=1, extra=()):
    rng = np.random.default_rng(seed)
    return {d: rng.standard_normal((g, a) + tuple(extra) + (n, 2 * d + 1)).astype(np.float32)
            for d, n in enumerate(dims)}


def _jargs(x, edges):
    idx, mask, rd, sh = edges
    return ({d: jnp.asarray(v) for d, v in x.items()}, jnp.asarray(idx, jnp.int32),
            jnp.asarray(mask), jnp.asarray(rd), [jnp.asarray(y) for y in sh])


def _targs(x, edges):
    idx, mask, rd, sh = edges
    return ({d: _t(v) for d, v in x.items()}, _t(idx), _t(mask), _t(rd), [_t(y) for y in sh])


def _jax_out_and_grads(jm, flat, jargs, seed, rows=None, leaves=None):
    """JAX's outputs, and (in the same jitted call) the gradients of Σ out·P
    over the output leaves numbered in `leaves` (default: all), P fixed
    random, drawn from `seed`, 0 on the leading-axis rows that `rows` drops,
    w.r.t. the parameters and the first input; P."""
    shapes = jax.eval_shape(lambda: jm.apply(_unflat(flat), *jargs))
    rng = np.random.default_rng(seed)

    def draw(o):
        p = rng.standard_normal(o.shape).astype(np.float32)
        return p if rows is None else p * rows.reshape((-1,) + (1,) * (p.ndim - 1))

    proj = jax.tree.map(draw, shapes)

    def loss(v, x0):
        out = jm.apply(v, x0, *jargs[1:])
        pairs = list(zip(jax.tree.leaves(out), jax.tree.leaves(proj)))
        return sum(jnp.sum(a * b) for n, (a, b) in enumerate(pairs)
                   if leaves is None or n in leaves), out

    (_, out), (gp, gx) = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        _unflat(flat), jargs[0])
    return out, gp, gx, proj


def _hold_grads(tm, gp, name_ok=None):
    """Each parameter's gradient against JAX's, per tensor; one JAX leaves
    at 0 gets none here either. The number held."""
    want = params_from_jax({k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        gp["params"], sep="/").items()}, tm)
    reached = 0
    for name, p in tm.named_parameters():
        if float(want[name].abs().max()) == 0.0:
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, name
            continue
        reached += 1
        _assert_rel(_np(p.grad), _np(want[name]), 1e-4, name)
    return reached


def _module_case(jm, tm, jargs, targs, seed=2):
    """Outputs of both at init-like weights, and the gradients of Σ out·P
    w.r.t. every parameter and the first input."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs))["params"]
    flat = init_like(shapes, seed)
    tm = _port(tm, flat)
    out, gp, gx, proj = _jax_out_and_grads(jm, flat, jargs, seed + 1)
    feats = {k: v.requires_grad_() for k, v in targs[0].items()} if isinstance(targs[0], dict) \
        else targs[0].requires_grad_()
    got = tm(feats, *targs[1:])
    for key in (out if isinstance(out, dict) else [None]):
        w, g = (out, got) if key is None else (out[key], got[key])
        _assert_rel(_np(g), w, 1e-5, f"output {key}")
    leaves = jax.tree.leaves(got) if isinstance(got, dict) else [got]
    sum(torch.sum(a * _t(b)) for a, b in zip(leaves, jax.tree.leaves(proj))).backward()
    _hold_grads(tm, gp)
    for d, x in (feats.items() if isinstance(feats, dict) else [(0, feats)]):
        _assert_rel(_np(x.grad), gx[d] if isinstance(gx, dict) else gx, 1e-4, f"d input {d}")


# ------------------------------------------------------------ the modules


def test_helpers_match_jax():
    for l1 in range(3):
        for l2 in range(3):
            for l3 in range(abs(l1 - l2), min(l1 + l2, 2) + 1):
                np.testing.assert_allclose(teq._cg(l1, l2, l3), jeq._cg(l1, l2, l3), atol=1e-6)
    for n in (1, 7, 16, 52, 104, 256):
        for groups in (1, 2, 3):
            assert teq.split_num_into_groups(n, groups) == jeq.split_num_into_groups(n, groups)
    assert [teq.to_order(d) for d in range(4)] == [jeq.to_order(d) for d in range(4)]


@pytest.mark.parametrize("kind", ["linear", "linear_zero", "norm", "gate", "radial"])
def test_fiber_modules_match_jax(kind):
    x = _fiber((8, 8))
    if kind.startswith("linear"):
        zero = kind == "linear_zero"
        jm = jeq.FiberLinear((8, 8), (6, 4), init_zero=zero)
        tm = teq.FiberLinear((8, 8), (6, 4), init_zero=zero, **GEN)
        if zero:
            assert all(float(p.detach().abs().max()) == 0.0 for p in tm.parameters())
        args = (x,)
    elif kind == "norm":
        jm, tm = jeq.FiberNorm((8, 8)), teq.FiberNorm((8, 8))
        x[1][0, 0] = 0.0  # a channel of zeros: the safe norm's ε
        args = (x,)
    elif kind == "gate":
        x = _fiber((8 + 4, 4))
        jm, tm = jeq.FiberGate((8 + 4, 4)), teq.FiberGate((8 + 4, 4))
        want = jm.apply({}, {d: jnp.asarray(v) for d, v in x.items()})
        got = tm({d: _t(v) for d, v in x.items()})
        for d in want:
            _assert_rel(_np(got[d]), want[d], 1e-5, f"degree {d}")
        return
    else:
        jm, tm = jeq.RadialTrunk(8), teq.RadialTrunk(8, **GEN)
        rd = _edges()[2]
        _module_case(jm, tm, (jnp.asarray(rd),), (_t(rd),))
        return
    jargs = ({d: jnp.asarray(v) for d, v in args[0].items()},)
    _module_case(jm, tm, jargs, ({d: _t(v) for d, v in args[0].items()},))


@pytest.mark.parametrize("pool", [True, False], ids=["pool", "edges"])
@pytest.mark.parametrize("self_interaction", [True, False], ids=["self", "noself"])
@pytest.mark.parametrize("project_xi_xj", [True, False], ids=["xixj", "xj"])
def test_dtp_matches_jax(pool, self_interaction, project_xi_xj):
    """Both factorized forms at fibers (8, 8) → (10, 6) (split into (5, 5)
    and (3, 3) over the input degrees), outputs and gradients; the pooled
    form also from a lone degree 0, as `tp_in` takes it; `project_out` off
    where the self branch is."""
    fin = (8,) if pool and not self_interaction else (8, 8)
    kw = dict(self_interaction=self_interaction, project_xi_xj=project_xi_xj, pool=pool,
              project_out=not self_interaction, radial_hidden_dim=6)
    jm, tm = jeq.DTP(fin, (10, 6), **kw), teq.DTP(fin, (10, 6), **kw, **GEN)
    edges, x = _edges(), _fiber(fin)
    _module_case(jm, tm, _jargs(x, edges), _targs(x, edges))


@pytest.mark.parametrize("htype", [False, True], ids=["plain", "htype_norms"])
def test_feed_forward_matches_jax(htype):
    x = _fiber((8, 8))
    jm = jeq.FeedForward((8, 8), include_htype_norms=htype)
    tm = teq.FeedForward((8, 8), include_htype_norms=htype, **GEN)
    assert float(tm.project_out.w0.detach().abs().max()) == 0.0  # init_out_zero
    jx = {d: jnp.asarray(v) for d, v in x.items()}
    _module_case(jm, tm, (jx,), ({d: _t(v) for d, v in x.items()},))


@pytest.mark.parametrize("kind", ["mlp", "l2"])
def test_attention_matches_jax(kind):
    """MLPAttention (two heads, so the head gates and logits per head
    differ) and L2DistAttention, outputs and gradients."""
    kw = dict(dim_head=4, heads=2, radial_hidden_dim=6)
    if kind == "mlp":
        jm, tm = jeq.MLPAttention((8, 8), **kw), teq.MLPAttention((8, 8), **kw, **GEN)
    else:
        jm, tm = jeq.L2DistAttention((8, 8), **kw), teq.L2DistAttention((8, 8), **kw, **GEN)
    edges, x = _edges(seed=3), _fiber((8, 8), seed=4)
    _module_case(jm, tm, _jargs(x, edges), _targs(x, edges))


# ------------------------------------------------------------ the trunk


def _samples(n=5, seed=0):
    return make_synthetic_dataset(n, seed=seed, num_targets=1, min_atoms=6, max_atoms=12)


def _trunk_args(samples):
    spec = spec_for_samples(samples, len(samples))
    b = pad_hypergraph_batch(samples, spec, target=0, with_pos=True)
    feats = np.random.default_rng(7).standard_normal((b.num_atoms, 16)).astype(np.float32) * 0.3
    return b, (_t(feats), b.pos, b.atom_row, b.slot_index, b.slot_mask, b.atom_slot)


def _trunk_kw(l2=False):
    return dict(dim=(16, 16), dim_in=(16,), heads=1, depth=1, dim_head=8, valid_radius=2.0,
                num_neighbors=6, radial_hidden_dim=8, l2_dist_attention=l2)


def _trunk_pair(targs, seed=5, **kw):
    kw = {**_trunk_kw(), **kw}
    jm = jeq.Equiformer(**kw)
    jargs = tuple(jnp.asarray(_np(a)) for a in targs)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs))["params"]
    flat = init_like(shapes, seed)
    return jm, jargs, flat, _port(teq.Equiformer(**kw, **GEN), flat)


@pytest.mark.parametrize("l2", [False, True], ids=["mlp", "l2"])
def test_equiformer_trunk_matches_jax(l2):
    """The trunk (the MLP attention at depth 2 with the higher degrees'
    norms in the feed-forward, the L2 attention at depth 1), its type-0 and
    type-1 outputs, and the gradients of Σ type0·P w.r.t. every parameter
    and the atom features. Only type 0 is differentiated, the output the
    model reads: JAX's gradient through type 1 is NaN at tp_in's 0 → 1
    pair on this batch (a 0·∞ in the backward of an attention prenorm's
    division at the exactly-zero degree-1 fibers of padding slots), where
    the port's is finite."""
    b, targs = _trunk_args(_samples())
    kw = dict(depth=1 if l2 else 2, l2_dist_attention=l2, ff_include_htype_norms=not l2)
    jm, jargs, flat, tm = _trunk_pair(targs, **kw)
    m = _np(b.atom_mask)
    (out0, out1), gp, gf, (p0, _) = _jax_out_and_grads(jm, flat, jargs, 9, rows=m,
                                                       leaves=(0,))
    feats = targs[0].clone().requires_grad_()
    got0, got1 = tm(feats, *targs[1:])
    _assert_rel(_np(got0)[m], np.asarray(out0)[m], 1e-5, "type 0")
    _assert_rel(_np(got1)[m], np.asarray(out1)[m], 1e-5, "type 1")
    torch.sum(got0 * _t(p0)).backward()
    reached = _hold_grads(tm, gp)
    _assert_rel(_np(feats.grad), gf, 1e-4, "d feats")
    # unreached in both: what feeds only degree 1 of the last block
    unreached = {n for n, p in tm.named_parameters() if p.grad is None}
    assert reached + len(unreached) == len(list(tm.parameters()))
    assert all(re.search(r"radial_\d_1|w1$|scale1$|logits_1", n) for n in unreached)


def test_equivariance_and_translation():
    """Type 0 is invariant and type 1 equivariant (v' = v·D1ᵀ) under a random
    rotation and translation, with the attention and feed-forward branches
    live (their output weights nonzero)."""
    b, targs = _trunk_args(_samples())
    _, _, _, tm = _trunk_pair(targs, valid_radius=1e6)
    R = ortho_group.rvs(3, random_state=11)
    R = R * np.sign(np.linalg.det(R))
    moved = _t(_np(b.pos) @ R.T.astype(np.float32) + np.float32([1.0, -2.0, 0.5]))
    with torch.no_grad():
        t0a, t1a = tm(*targs)
        t0b, t1b = tm(targs[0], moved, *targs[2:])
    m = b.atom_mask
    torch.testing.assert_close(t0b[m], t0a[m], rtol=1e-3, atol=1e-4)
    D1 = torch.tensor(wigner_d_rotation(1, R).astype(np.float32))
    torch.testing.assert_close(t1b[m], torch.einsum("ndm,cm->ndc", t1a[m], D1),
                               rtol=1e-3, atol=1e-4)
    assert float(t1a[m].abs().max()) > 1e-2  # type 1 is not trivially 0


def test_no_cross_molecule_leakage():
    b, targs = _trunk_args(_samples())
    _, _, _, tm = _trunk_pair(targs, valid_radius=1e6)
    pos = b.pos.clone()
    gid = b.atom_graph_id
    pos[gid == 1] += 700.0
    with torch.no_grad():
        a0, _ = tm(*targs)
        b0, _ = tm(targs[0], pos, *targs[2:])
    sel = (gid != 1) & b.atom_mask
    torch.testing.assert_close(b0[sel], a0[sel], rtol=1e-4, atol=1e-5)


def test_short_rows_and_isolated_atoms_stay_finite():
    """A batch with rows of fewer than k + 1 atoms (k = min(16, A − 1):
    masked neighbours, padding slots at rel_pos = 0) and atoms with no neighbour within the radius: outputs and the
    gradients of every parameter and the atom features are finite, and
    an isolated atom's attention falls on its self token."""
    samples = [s for s in make_synthetic_dataset(30, seed=3, num_targets=1, min_atoms=3,
                                                 max_atoms=6)][:6]
    b, targs = _trunk_args(samples)
    g, a = b.slot_mask.shape
    assert int(b.slot_mask.sum(1).min()) < min(16, a - 1) + 1
    _, _, _, tm = _trunk_pair(targs, num_neighbors=16, valid_radius=1.2)
    feats = targs[0].clone().requires_grad_()
    t0, t1 = tm(feats, *targs[1:])
    (t0.sum() + t1.sum()).backward()
    assert bool(torch.isfinite(t0).all()) and bool(torch.isfinite(t1).all())
    assert bool(torch.isfinite(feats.grad).all())
    for name, p in tm.named_parameters():
        assert p.grad is None or bool(torch.isfinite(p.grad).all()), name
    pd = b.pos[b.slot_index] * b.slot_mask[..., None]
    _, mask, _ = knn_dense(pd, b.slot_mask, min(16, a - 1), valid_radius=1.2,
                           exclude_self=True)
    assert bool((b.slot_mask & ~mask.any(-1)).any())  # an isolated atom


# ------------------------------------------------------------ the model


def _model_case(seed=0):
    samples = make_synthetic_dataset(6, seed=23, num_targets=1, min_atoms=6, max_atoms=14)
    jb = jax_batch(samples, jax_spec(samples, batch_size=8), True)
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=True)
    jm = jax_create_model("equiformer_equihnns", num_target=1, cfg=JaxModelConfig(**CFG))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jb, deterministic=True))
    return samples, jb, tb, jm, init_like(shapes["params"], seed)


@pytest.fixture(scope="module")
def model_case():
    """The batches, the JAX model, init-like weights and JAX's reference
    (eval and training predictions, loss, gradients) at them."""
    samples, jb, tb, jm, flat = _model_case()
    return samples, jb, tb, jm, flat, jax_reference(jm, jb, flat, {}, _jax_run(jm))


def test_model_forward_and_grads_match_jax(model_case):
    """Eval forward, training forward, loss and the per-tensor gradients of
    every parameter at matched weights: every parameter JAX reaches is
    reached here, the rest (degree 1 of the last block) in neither."""
    _, jb, tb, jm, flat, (ev, tr, lv, jgrads, _) = model_case
    model = _port(create_model("equiformer_equihnns", num_target=1, cfg=ModelConfig(**CFG)),
                  flat)
    with torch.no_grad():
        _assert_rel(_np(model(tb)), ev, 1e-5, "eval predictions")
    preds = model.train()(tb)
    _assert_rel(_np(preds), tr, 1e-5, "training predictions")
    sq, cnt = masked_mse(preds, tb.y, tb.graph_mask)
    loss = sq / torch.clamp(cnt, min=1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), lv, rtol=1e-5)
    want = params_from_jax(jgrads, model)
    reached = 0
    for name, p in model.named_parameters():
        if float(want[name].abs().max()) == 0.0:
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, name
            continue
        reached += 1
        _assert_rel(_np(p.grad), _np(want[name]), 1e-4, name)
    assert float(want["equiformer_layer.attn_0.to_attn_logits_0.weight"].abs().max()) > 0
    assert float(want["equiformer_layer.tp_in.radial_0_1_out_W"].abs().max()) > 0
    # unreached in both: what feeds only degree 1 of the last block (the
    # model reads type 0)
    unreached = {n for n, p in model.named_parameters() if p.grad is None}
    assert reached + len(unreached) == len(list(model.parameters()))
    assert all(re.search(r"radial_\d_1|w1$|scale1$|logits_1", n) for n in unreached)


def test_adam_step_matches_jax(model_case):
    """One Adam step: the JAX trainer's optimizer (`_adam_like`, as its
    `_build_train_step` applies it: updates scaled by lr) on JAX's
    gradients, against the port's `Trainer.train_step` from the same
    weights."""
    _, _, tb, _, flat, (_, _, jloss, jgrads, _) = model_case
    lr = 1e-3
    tx = _adam_like(0.0)

    @jax.jit
    def step(p, g):
        updates, _ = tx.update(g, tx.init(p), p)
        return optax.apply_updates(p, jax.tree.map(lambda u: u * lr, updates))

    jp = step(_unflat(flat)["params"], _unflat(jgrads)["params"])
    model = _port(create_model("equiformer_equihnns", num_target=1, cfg=ModelConfig(**CFG)),
                  flat)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    grads = params_from_jax(jgrads, model)
    tloss = Trainer(model, TrainConfig(lr=lr, seed=0), std=1.0, device="cpu").train_step(tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = params_from_jax(_flat(jp), model)
    got = model.state_dict()
    for name, w in want.items():
        g = grads[name].abs()
        by_sign = g <= 1e-3 * float(g.max())
        for moved in (got[name] - start[name], w - start[name]):
            assert bool((moved.abs() <= lr * (1 + 1e-3))[by_sign].all()), name
        np.testing.assert_allclose(got[name][~by_sign].numpy(), w[~by_sign].numpy(),
                                   atol=1e-2 * lr, rtol=0, err_msg=name)


def test_params_from_jax_covers_the_equiformer_tree(model_case):
    """Every flax leaf of `equiformer_equihnns` maps to exactly one key of
    the port's state dict, and every key gets one, at its shape, by the
    converter's existing rules."""
    flat = model_case[4]
    model = create_model("equiformer_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    state = params_from_jax(flat, model)
    assert set(state) == set(model.state_dict()) and len(state) == len(flat)
    for key, shape, transposed in (
            ("equiformer_layer.tp_in.radial_0_1_out_W", (8 * 8, 16, 16), False),
            ("equiformer_layer.tp_in.radial_0_0.ln1.weight", (64,), False),
            ("equiformer_layer.tp_in.radial_0_0.lin0.weight", (64, 1), True),
            ("equiformer_layer.attn_0.to_attn_and_v.radial_1_0_out_b", (52, 16), False),
            ("equiformer_layer.attn_0.to_attn_logits_0.weight", (1, 4), True),
            ("equiformer_layer.ff_0.project_in.w1", (16, 64), False),
            ("equiformer_layer.norm.scale1", (16, 1), False)):
        path = key.replace(".", "/").replace("/weight", "/kernel" if transposed else "/scale")
        want = flat[path].T if transposed else flat[path]
        assert tuple(state[key].shape) == shape, key
        np.testing.assert_array_equal(state[key].numpy(), want)


def test_registry_equals_jax():
    import equihgnn_tpu.models  # noqa: F401  (registration)
    import equihgnn_tpu_torch.models  # noqa: F401

    names = set(registry.list_models())
    assert names == set(jax_registry.list_models()) and len(names) == 18


def test_bfloat16_raises():
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        create_model("equiformer_equihnns", num_target=1,
                     cfg=ModelConfig(**CFG, compute_dtype="bfloat16"))
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        teq.Equiformer(**_trunk_kw(), dtype="bfloat16", **GEN)


def test_served_from_the_sdf_and_trained_by_main(tmp_path, monkeypatch):
    """`predict --sdf` serves the model (20 finite rows), `--smiles` raises
    for it, as for every model with coordinates, and `main.run` trains it."""
    import os

    from equihgnn_tpu_torch import predict
    from equihgnn_tpu_torch.main import build_parser, run

    monkeypatch.chdir(tmp_path)
    res = run(build_parser().parse_args(
        ["--data", "synthetic_hg_3d", "--method", "equiformer_equihnns", "--device", "cpu",
         "--MLP_hidden", "16", "--output_hidden", "8", "--batch_size", "16",
         "--synthetic_size", "40", "--epochs", "1", "--lr", "1e-3"]))
    assert len(res["history"]) == 1 and np.isfinite(res["history"][-1]["train_loss"])
    sdf = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "datasets",
                       "real_sample", "sample.sdf")
    ckpt = os.path.join(res["log_dir"], "ckpt_best.pt")
    out = str(tmp_path / "pred.csv")
    predict.run(predict.build_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", sdf, "--out", out, "--device", "cpu"]))
    with open(out) as f:
        rows = f.read().strip().splitlines()[1:]
    assert len(rows) == 20 and all(np.isfinite(float(r.rsplit(",", 1)[-1])) for r in rows)
    smi = tmp_path / "m.smi"
    smi.write_text("CCO\n")
    with pytest.raises(ValueError):
        predict.run(predict.build_parser().parse_args(
            ["--ckpt", ckpt, "--smiles", str(smi), "--out", out, "--device", "cpu"]))

