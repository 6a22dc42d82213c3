"""Port's ViSNet (`equihgnn_tpu_torch/nn/visnet.py`,
`ops/kernels/vis_mix.py`) and `visnet_equihnns` vs the JAX package and the
reference golden, on the CPU.

Inputs are numpy-seeded and fed to both frameworks; weights come from
numpy at the JAX modules' parameter shapes (`jax.eval_shape` of the init)
and reach the port through `params_from_jax`. The JAX f32 model computes
the vector mix with `_xla_mix` (its Pallas kernels serve the bf16 path
only); the port's wrappers take their plain versions on CPU tensors, held
here to `_xla_mix` in f32 and to the Pallas kernels in interpret mode. JAX
calls are jitted. Tolerances (f32, other summation orders):

  * edge features: atol 1e-6 / rtol 1e-5; vector mix (plain vs `_xla_mix`):
    max |Δ| ≤ 1e-5·max |JAX| per tensor, forward and gradients;
  * plain vs the Pallas kernels (bf16 MXU operands on bf16-grid inputs):
    `tests/test_vis_mix_kernel.py`'s own 1e-2;
  * modules: atol 1e-5, rtol 1e-4; whole model forward 2e-5 / 1e-4;
    gradients max |Δ| ≤ 1e-4·max |JAX| + 1e-6 per tensor;
  * golden: the JAX test's atol 2e-4 / rtol 1e-3.
"""

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
from equihgnn_tpu.nn import visnet as jvis
from equihgnn_tpu.ops.knn import knn_dense as jax_knn_dense
from equihgnn_tpu.ops.pallas.vis_mix import _mix_edge, _mix_last, _wdot, _xla_mix
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import visnet as tvis
from equihgnn_tpu_torch.ops.kernels.vis_mix import (
    vec_agg_bwd_plain,
    vec_agg_plain,
    vis_vec_agg,
    vis_wdot,
    wdot_bwd_plain,
    wdot_plain,
)

torch.set_num_threads(1)

GEN = dict(generator=torch.Generator().manual_seed(0))
CFG = dict(mlp_hidden=16, output_hidden=8, all_num_layers=3, output_num_layers=3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return t.detach().numpy()


def _assert_rel(got, want, tol, name):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    limit = tol * float(np.abs(want).max()) + 1e-7
    assert err <= limit, f"{name}: max |d| {err:.3e} > {limit:.3e}"


def _random_params(jmodule, *args, seed=0, **kw):
    """Flat {flax path: numpy} at the module's parameter shapes, O(0.2)
    draws; LayerNorm scales around 1."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)
    flat = {}
    for k, v in traverse_util.flatten_dict(shapes["params"], sep="/").items():
        x = (rng.standard_normal(v.shape) * 0.2).astype(np.float32)
        flat[k] = x + 1.0 if k.endswith("scale") else x
    return flat


def _unflat(flat):
    return {"params": traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in flat.items()}, sep="/")}


def _port(module, flat):
    module.load_state_dict(params_from_jax(flat, module))
    return module.eval()


# --------------------------------------------------------- edge features


def test_cosine_cutoff_rbf_and_sh_match_jax():
    rng = np.random.default_rng(0)
    d = np.concatenate([[0.0, 2.5, 4.99, 5.0, 7.0], rng.random(40) * 6]).astype(np.float32)
    np.testing.assert_allclose(_np(tvis.cosine_cutoff(_t(d), 5.0)),
                               np.asarray(jvis.cosine_cutoff(jnp.asarray(d), 5.0)),
                               atol=1e-6, rtol=1e-5)
    for trainable in (False, True):
        jm = jvis.ExpNormalSmearing(5.0, 32, trainable)
        variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(d))
        tm = tvis.ExpNormalSmearing(5.0, 32, trainable)
        assert (len(list(tm.parameters())) == 2) == trainable
        assert not tm.state_dict() if not trainable else set(tm.state_dict()) == {"means", "betas"}
        if trainable:  # move them, so the mapping is seen
            flat = {k: np.asarray(v) * 1.1 for k, v in
                    traverse_util.flatten_dict(variables["params"], sep="/").items()}
            tm.load_state_dict(params_from_jax(flat, tm))
            variables = _unflat(flat)
        with torch.no_grad():
            got = tm(_t(d))
        np.testing.assert_allclose(_np(got), np.asarray(jm.apply(variables, jnp.asarray(d))),
                                   atol=1e-6, rtol=1e-5)
    v = rng.standard_normal((50, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    for lmax in (1, 2):
        np.testing.assert_allclose(_np(tvis.spherical_harmonics_l2(_t(v), lmax)),
                                   np.asarray(jvis.spherical_harmonics_l2(jnp.asarray(v), lmax)),
                                   atol=1e-6, rtol=1e-5)
    with pytest.raises(ValueError):
        tvis.spherical_harmonics_l2(_t(v), 3)


@pytest.mark.parametrize("norm_type,L,trainable", [
    (None, 8, False), (None, 8, True), ("max_min", 8, False), ("max_min", 3, True)])
def test_vec_layer_norm_matches_jax(norm_type, L, trainable):
    rng = np.random.default_rng(L)
    vec = rng.standard_normal((4, 5, L, 16)).astype(np.float32)
    vec[0] = 0.0  # an all-zero atom
    jm = jvis.VecLayerNorm(16, trainable=trainable, norm_type=norm_type)
    flat = _random_params(jm, jnp.asarray(vec)) if trainable else {}
    tm = tvis.VecLayerNorm(16, trainable, norm_type)
    if trainable:
        tm.load_state_dict(params_from_jax(flat, tm))
    else:
        assert not tm.state_dict()
    want = jm.apply(_unflat(flat) if trainable else {}, jnp.asarray(vec))
    with torch.no_grad():
        got = tm(_t(vec))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-6, rtol=1e-5)


# ------------------------------------------------------------ vector mix


def _mix_inputs(g=3, a=7, k=6, L=8, h=16, seed=0, bf16_grid=False):
    rng = np.random.default_rng(seed)
    q = (lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))) if bf16_grid \
        else (lambda x: x.astype(np.float32))
    vec, u, vv = (q(rng.standard_normal((g, a, L, h))) for _ in range(3))
    s1, s2 = q(rng.standard_normal((g, a, k, h))), q(rng.standard_normal((g, a, k, h)))
    d = q(rng.standard_normal((g, a, k, L)))
    idx = rng.integers(0, a, (g, a, k))
    mask = rng.random((g, a, k)) > 0.25
    mask[-1] = False  # an empty row, as the batch's padding row
    s2m = (s2 * mask[..., None]).astype(np.float32)
    return vec, s1, s2m, d, idx, mask, u, vv


def _linear_losses(g, a, k, L, h, seed=99):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, a, L, h)).astype(np.float32),
            rng.standard_normal((g, a, k, h)).astype(np.float32))


@pytest.mark.parametrize("L", [8, 3])
def test_plain_mix_matches_xla_mix(L):
    """The plain versions vs JAX's `_xla_mix` (the function the JAX f32
    model runs), forward and the six input gradients under a linear loss
    (exact cotangents; the w_dot values grow with L)."""
    vec, s1, s2m, d, idx, mask, u, vv = _mix_inputs(L=L, seed=L)
    r1, r2 = _linear_losses(*vec.shape[:2], idx.shape[-1], L, vec.shape[-1])
    leaves = [_t(x).requires_grad_() for x in (vec, s1, s2m, d, u, vv)]
    va = vis_vec_agg(*leaves[:4], _t(idx), _t(mask))
    wd = vis_wdot(leaves[3], leaves[4], leaves[5], _t(idx), _t(mask))
    (torch.sum(va * _t(r1)) + torch.sum(wd * _t(r2))).backward()

    jidx = jnp.asarray(idx, jnp.int32)

    def loss(vec, s1, s2m, d, u, vv):
        a_, w_ = _xla_mix(vec, s1, s2m, d, jidx, jnp.asarray(mask), u, vv)
        return jnp.sum(a_ * r1) + jnp.sum(w_ * r2), (a_, w_)

    (_, (ja, jw)), jg = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(6)), has_aux=True))(
        *map(jnp.asarray, (vec, s1, s2m, d, u, vv)))
    _assert_rel(_np(va), ja, 1e-5, "vec_agg")
    _assert_rel(_np(wd), jw, 1e-5, "w_dot")
    for name, leaf, want in zip(("vec", "s1", "s2m", "d", "u", "vv"), leaves, jg):
        _assert_rel(_np(leaf.grad), want, 1e-5, f"grad {name}")
    # masked edges and the empty row contribute nothing
    assert float(wd.detach()[torch.from_numpy(~mask)].abs().max()) == 0.0
    assert float(va.detach()[-1].abs().max()) == 0.0


@pytest.mark.parametrize("L", [8, 3])
def test_plain_backwards_match_xla_mix_vjp_at_a_wide_slot_axis(L):
    """`vec_agg_bwd_plain` and `wdot_bwd_plain` (the functions of kernels G
    and I) vs `jax.vjp` of JAX's f32 `_xla_mix` at A = 80 slots a row, k =
    17: on the card G and I refused rows this wide until they took every
    row F and H take (A ≤ 142 at L = 8, k = 17). Masked edges and an empty
    row; max |Δ| ≤ 1e-5·max |JAX| per tensor."""
    g, a, k, h = 2, 80, 17, 8
    vec, s1, s2m, d, idx, mask, u, vv = _mix_inputs(g=g, a=a, k=k, L=L, h=h, seed=80 + L)
    gva, gw = _linear_losses(g, a, k, L, h, seed=90 + L)
    jidx, jmask = jnp.asarray(idx, jnp.int32), jnp.asarray(mask)

    @jax.jit
    def vjps(vec, s1, s2m, d, u, vv):
        _, vjp = jax.vjp(lambda *x: _xla_mix(*x[:4], jidx, jmask, *x[4:]), vec, s1, s2m, d, u, vv)
        return vjp((gva, jnp.zeros_like(gw)))[:4], vjp((jnp.zeros_like(gva), gw))[3:]

    want_g, want_i = vjps(*map(jnp.asarray, (vec, s1, s2m, d, u, vv)))
    got_g = vec_agg_bwd_plain(*map(_t, (vec, s1, s2m, d, idx, mask, gva)))
    got_i = wdot_bwd_plain(*map(_t, (d, u, vv, idx, mask, gw)))
    for name, x, want in zip(("dvec", "ds1", "ds2m", "dd (G)", "dd (I)", "du", "dvv"),
                             (*got_g, *got_i), (*want_g, *want_i)):
        _assert_rel(_np(x), want, 1e-5, name)
    assert float(got_i[0][torch.from_numpy(~mask)].abs().max()) == 0.0  # masked edges: dd of I


def test_plain_mix_matches_pallas_kernels():
    """The plain versions vs JAX's Pallas kernels (`_mix_edge`, `_mix_last`,
    interpret mode) on bf16-grid inputs, at `test_vis_mix_kernel.py`'s 1e-2
    (the kernels round their MXU products to bf16)."""
    vec, s1, s2m, d, idx, mask, u, vv = _mix_inputs(a=8, k=5, seed=5, bf16_grid=True)
    r1, r2 = _linear_losses(3, 8, 5, 8, 16, seed=98)
    jidx, jmask = jnp.asarray(idx, jnp.int32), jnp.asarray(mask)
    args = tuple(map(jnp.asarray, (vec, s1, s2m, d, u, vv)))

    def edge_loss(vec, s1, s2m, d, u, vv):
        a_, w_ = _mix_edge(vec, s1, s2m, d, jidx, jmask, u, vv)
        return jnp.sum(a_ * r1) + jnp.sum(w_ * r2), (a_, w_)

    def last_loss(vec, s1, s2m, d):
        a_ = _mix_last(vec, s1, s2m, d, jidx, jmask)
        return jnp.sum(a_ * r1), a_

    (_, (ja, jw)), jg = jax.jit(jax.value_and_grad(edge_loss, argnums=tuple(range(6)),
                                                   has_aux=True))(*args)
    (_, ja_last), jg_last = jax.jit(jax.value_and_grad(last_loss, argnums=tuple(range(4)),
                                                       has_aux=True))(*args[:4])
    leaves = [_t(x).requires_grad_() for x in (vec, s1, s2m, d, u, vv)]
    va = vec_agg_plain(*leaves[:4], _t(idx), _t(mask))
    wd = wdot_plain(leaves[3], leaves[4], leaves[5], _t(idx), _t(mask))
    (torch.sum(va * _t(r1)) + torch.sum(wd * _t(r2))).backward()
    np.testing.assert_allclose(_np(va), np.asarray(ja), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(va), np.asarray(ja_last), atol=1e-2, rtol=1e-2)
    np.testing.assert_allclose(_np(wd), np.asarray(jw), atol=1e-2, rtol=1e-2)

    def normwise(got, want, name):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-9)
        assert err < 1e-2, f"{name}: normwise rel err {err:.3e}"

    for name, leaf, want in zip(("vec", "s1", "s2m", "d", "u", "vv"), leaves, jg):
        normwise(_np(leaf.grad), want, f"grad {name}")
    last = [_t(x).requires_grad_() for x in (vec, s1, s2m, d)]
    torch.sum(vec_agg_plain(*last, _t(idx), _t(mask)) * _t(r1)).backward()
    for name, leaf, want in zip(("vec", "s1", "s2m", "d"), last, jg_last):
        normwise(_np(leaf.grad), want, f"last-layer grad {name}")


def test_plain_and_pallas_wdot_are_plus_zero_at_masked_edges():
    """`wdot_plain` (kernel H's function) and JAX's `_wdot` (its Pallas
    kernel, interpret mode) give +0, sign bit clear, at every masked edge
    while d, u and vv there are non-zero: the value kernel H writes at a
    masked edge without reading d or vv. The other edges agree to 1e-5 of
    max |JAX| (bf16-grid inputs: the kernel's one-hot products are exact)."""
    _, _, _, d, idx, mask, u, vv = _mix_inputs(a=8, k=5, seed=12, bf16_grid=True)
    assert np.all(d[~mask] != 0) and np.all(u != 0) and np.all(vv != 0)
    want = np.asarray(jax.jit(_wdot)(jnp.asarray(d), jnp.asarray(u), jnp.asarray(vv),
                                     jnp.asarray(idx, jnp.int32), jnp.asarray(mask)))
    got = _np(wdot_plain(*map(_t, (d, u, vv, idx, mask))))
    for name, w in (("JAX _wdot", want), ("wdot_plain", got)):
        z = w[~mask]
        assert z.size and not np.any(z) and not np.any(np.signbit(z)), name
    _assert_rel(got, want, 1e-5, "w_dot")


def test_mix_wrappers_raise_on_other_devices():
    vec, s1, s2m, d, idx, mask, u, vv = map(_t, _mix_inputs())
    with pytest.raises(ValueError, match="unsupported device"):
        vis_vec_agg(vec.to("meta"), s1, s2m, d, idx, mask)
    with pytest.raises(ValueError, match="unsupported device"):
        vis_wdot(d, u.to("meta"), vv, idx, mask)


# ------------------------------------------------------------- the modules


def _edge_inputs(g=3, a=10, h=16, L=8, seed=0):
    """ViS_MP's inputs on real k + 1-nearest neighbourhoods (self included)."""
    rng = np.random.default_rng(seed)
    mask = np.arange(a)[None, :] < rng.integers(2, a + 1, size=g)[:, None]
    pos = (rng.standard_normal((g, a, 3)) * 1.5).astype(np.float32) * mask[..., None]
    idx, nmask, sqd = jax_knn_dense(jnp.asarray(pos), jnp.asarray(mask), 17, valid_radius=5.0,
                                    squared_radius=False, exclude_self=False)
    idx, nmask = np.asarray(idx).astype(np.int64), np.asarray(nmask)
    k = idx.shape[-1]
    r = np.where(nmask, np.sqrt(np.maximum(np.asarray(sqd), 0.0)), 0.0).astype(np.float32)
    x = rng.standard_normal((g, a, h)).astype(np.float32)
    vec = rng.standard_normal((g, a, L, h)).astype(np.float32)
    f = rng.standard_normal((g, a, k, h)).astype(np.float32)
    d = rng.standard_normal((g, a, k, L)).astype(np.float32)
    return x, vec, idx, nmask, r, f, d


@pytest.mark.parametrize("last_layer", [False, True])
def test_vis_mp_matches_jax(last_layer):
    """One ViS_MP layer at matched weights; A = 10 < k = 17, so the
    neighbour axis carries knn_dense's padded, masked edges."""
    x, vec, idx, nmask, r, f, d = _edge_inputs(seed=int(last_layer))
    jm = jvis.ViS_MP(num_heads=4, hidden_channels=16, cutoff=5.0, vecnorm_type=None,
                     trainable_vecnorm=False, last_layer=last_layer)
    jargs = (jnp.asarray(x), jnp.asarray(vec), jnp.asarray(idx, jnp.int32), jnp.asarray(nmask),
             jnp.asarray(r), jnp.asarray(f), jnp.asarray(d))
    flat = _random_params(jm, *jargs)
    tm = _port(tvis.ViS_MP(4, 16, 5.0, None, False, last_layer, **GEN), flat)
    want = jax.jit(lambda v: jm.apply(v, *jargs))(_unflat(flat))
    with torch.no_grad():
        got = tm(*(_t(t) for t in (x, vec, idx, nmask, r, f, d)))
    for name, a_, b_ in zip(("dx", "dvec", "df_ij"), got, want):
        if b_ is None:
            assert a_ is None and last_layer
            continue
        np.testing.assert_allclose(_np(a_), np.asarray(b_), atol=1e-5, rtol=1e-4, err_msg=name)


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="vertex"):
        tvis.ViS_MP(8, 16, 5.0, None, False, vertex=True, **GEN)
    # bfloat16 runs on the ViSNet models (tests/test_torch_visnet_bf16.py);
    # the Equiformer's is still to be ported
    assert create_model("visnet_equihnns", num_target=1,
                        cfg=ModelConfig(**CFG, compute_dtype="bfloat16")).cfg.compute_dtype
    with pytest.raises(NotImplementedError, match="ROADMAP item 11"):
        create_model("equiformer_equihnns", num_target=1,
                     cfg=ModelConfig(**CFG, compute_dtype="bfloat16"))
    # remat is ported (its step: tests/test_torch_remat.py)
    assert create_model("visnet_equihnns", num_target=1,
                        cfg=ModelConfig(**CFG, remat=True)).cfg.remat


def _visnet_args(b, pos=None):
    return (b.atom_feat, b.pos if pos is None else pos, b.atom_row, b.slot_index, b.slot_mask,
            b.atom_slot)


@pytest.fixture(scope="module")
def visnet_matched():
    """A ViSNet at hidden 16 with the model's 6 layers, its JAX twin, the
    flat weights and batches of both frameworks."""
    samples = make_synthetic_dataset(6, seed=11)
    jb = jax.tree.map(jnp.asarray, jax_pad(samples, jax_spec(samples, batch_size=8), target=0,
                                           with_pos=True))
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=True)
    jm = jvis.ViSNet(hidden_channels=16, lmax=2, max_num_neighbors=16, num_layers=6)
    gid = jb.atom_graph_id if jb.atom_row is None else jb.atom_row
    jargs = (jb.atom_feat, jb.pos, gid, jb.slot_index, jb.slot_mask, jb.atom_slot)
    flat = _random_params(jm, *jargs, slot_gid=jb.slot_gid)
    tm = _port(tvis.ViSNet(hidden_channels=16, lmax=2, max_num_neighbors=16, num_layers=6,
                           **GEN), flat)
    want = jax.jit(lambda v: jm.apply(v, *jargs, slot_gid=jb.slot_gid))(_unflat(flat))
    return jb, tb, tm, np.asarray(want)


def test_visnet_matches_jax(visnet_matched):
    jb, tb, tm, want = visnet_matched
    with torch.no_grad():
        got = _np(tm(*_visnet_args(tb), slot_gid=tb.slot_gid))
    m = np.asarray(jb.atom_mask)
    assert np.array_equal(m, _np(tb.atom_mask))
    assert got.shape == want.shape == (m.shape[0], 16)
    np.testing.assert_allclose(got[m], want[m], atol=1e-5, rtol=1e-4)


def test_visnet_rotation_translation_invariance(visnet_matched):
    _, tb, tm, _ = visnet_matched
    R = ortho_group.rvs(3, random_state=1)
    R = torch.tensor(R * np.sign(np.linalg.det(R)), dtype=torch.float32)
    with torch.no_grad():
        out1 = tm(*_visnet_args(tb))
        out2 = tm(*_visnet_args(tb, tb.pos @ R.T + torch.tensor([3.0, -1.0, 2.0])))
    m = tb.atom_mask
    torch.testing.assert_close(out2[m], out1[m], rtol=1e-3, atol=1e-4)


def test_visnet_no_cross_molecule_leakage(visnet_matched):
    _, tb, tm, _ = visnet_matched
    pos2 = tb.pos.clone()
    pos2[tb.atom_graph_id == 1] += 500.0
    with torch.no_grad():
        out1, out2 = tm(*_visnet_args(tb)), tm(*_visnet_args(tb, pos2))
    sel = (tb.atom_graph_id == 0) & tb.atom_mask
    torch.testing.assert_close(out2[sel], out1[sel], rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------- the whole model


@pytest.fixture(scope="module")
def matched():
    samples = make_synthetic_dataset(6, seed=23, num_targets=1)
    jb = jax.tree.map(jnp.asarray, jax_pad(samples, jax_spec(samples, batch_size=8), target=0,
                                           with_pos=True))
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=True)
    jm = jax_create_model("visnet_equihnns", num_target=1, cfg=JaxModelConfig(**CFG))
    flat = _random_params(jm, jb, deterministic=True)
    return jb, tb, jm, flat


def _assert_grad_close(got, want, name):
    err = float((got - want).abs().max())
    limit = 1e-4 * float(want.abs().max()) + 1e-6
    assert err <= limit, f"{name}: max |d| {err:.3e} > {limit:.3e}"


def test_model_forward_and_grads_match_jax(matched):
    """Forward, and the parameter gradients of the masked MSE: every
    parameter reached in JAX is reached in the port, with equal values."""
    from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
    from equihgnn_tpu_torch.train.trainer import masked_mse

    jb, tb, jm, flat = matched

    def loss_fn(v):
        preds = jm.apply(v, jb, deterministic=True)
        sq, cnt = jax_masked_mse(preds, jb.y, jb.graph_mask)
        return sq / jnp.maximum(cnt, 1.0), preds

    (jloss, jpreds), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(_unflat(flat))
    model = _port(create_model("visnet_equihnns", num_target=1, cfg=ModelConfig(**CFG)), flat)
    want = params_from_jax({k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jgrads["params"], sep="/").items()}, model)
    preds = model(tb)
    np.testing.assert_allclose(_np(preds), np.asarray(jpreds), atol=2e-5, rtol=1e-4)
    sq, cnt = masked_mse(preds, tb.y, tb.graph_mask)
    loss = sq / torch.clamp(cnt, min=1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    reached = 0
    for name, p in model.named_parameters():
        w = want[name]
        if float(w.abs().max()) == 0.0:
            assert p.grad is None or float(p.grad.abs().max()) == 0.0, name
            continue
        assert p.grad is not None, name
        _assert_grad_close(p.grad, w, name)
        reached += 1
    # layer 0 starts from vec = 0, so its vec_proj, w_src/w_trg (u = vv = 0)
    # and f_proj (w_dot = 0) get no gradient; nor does the readout's last
    # vec2_proj (its output enters only as sum(vec)·0). In JAX as here.
    unreached = {n for n in want if float(want[n].abs().max()) == 0.0}
    assert unreached == {f"visnet_layer.vis_mp_layers_0.{m}" for m in (
        "vec_proj.weight", "w_src_proj.weight", "w_trg_proj.weight", "f_proj.weight",
        "f_proj.bias")} | {"visnet_layer.output_network_1.vec2_proj.weight"}
    assert reached == len(want) - len(unreached)


def test_remat_layers_gives_the_same_gradients(matched):
    _, tb, _, flat = matched
    from equihgnn_tpu_torch.train.trainer import masked_mse

    grads = []
    for remat in (True, False):
        model = _port(create_model("visnet_equihnns", num_target=1, cfg=ModelConfig(**CFG)),
                      flat)
        model.visnet_layer.remat_layers = remat
        sq, cnt = masked_mse(model(tb), tb.y, tb.graph_mask)
        (sq / torch.clamp(cnt, min=1.0)).backward()
        grads.append({n: p.grad for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(g, grads[1][name], rtol=1e-6, atol=1e-8, msg=name)


def test_params_from_jax_covers_the_visnet_tree(matched):
    _, _, _, flat = matched
    model = create_model("visnet_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    state = params_from_jax(flat, model)
    assert set(state) == set(model.state_dict()) and len(state) == len(flat)
    assert "visnet_layer.vis_mp_layers_5.o_proj.weight" in state
    assert "visnet_layer.vis_mp_layers_5.f_proj.weight" not in state  # the last layer
    assert "visnet_layer.vis_mp_layers_0.vec_proj.bias" not in state
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in flat.items() if "neighbor_embedding" not in k}, model)


def test_proj_init_is_xavier_with_zero_bias():
    lin = tvis._proj(64, 192, torch.Generator().manual_seed(0))
    bound = float(np.sqrt(6.0 / (64 + 192)))
    assert float(lin.weight.abs().max()) <= bound and float(lin.weight.abs().max()) > 0.9 * bound
    assert torch.all(lin.bias == 0)
    assert tvis._proj(8, 8, torch.Generator(), bias=False).bias is None


# ---------------------------------------------------------------- golden


def test_visnet_model_golden():
    """Full `visnet_equihnns` vs the reference capture, through the JAX
    test's converters (`visnet_tree`, `model_tree`) and `params_from_jax`."""
    from equihgnn_tpu_torch.data.batching import BatchSpec
    from test_reference_goldens import _model_cfg, _state, _strip, load, model_tree, visnet_tree

    d = load("model_visnet_equihnns")
    st = _state(d)
    st_trunk = {k: v for k, v in st.items() if not k.startswith("visnet_layer.")}
    tree = model_tree("mhnns", st_trunk, _model_cfg())["params"]
    tree["visnet_layer"] = visnet_tree(_strip(st, "visnet_layer."))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}
    cfg = ModelConfig(all_num_layers=3, mlp_hidden=64, output_hidden=64, output_num_layers=2,
                      aggregate="mean", normalization="ln", activation="relu", dropout=0.0)
    model = _port(create_model("visnet_equihnns", num_target=1, cfg=cfg), flat)
    samples = [s for s in make_synthetic_dataset(40, seed=97) if s.n_atoms <= 16][:6]
    spec = BatchSpec(num_graphs=8, num_atoms=128, num_hedges=128, nnz=256,
                     max_atoms_per_graph=16)
    with torch.no_grad():
        out = model(pad_hypergraph_batch(samples, spec, target=0, with_pos=True))
    np.testing.assert_allclose(_np(out)[:6], d["out::y"], atol=2e-4, rtol=1e-3)
