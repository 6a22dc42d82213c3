"""Port's FAFormer (`equihgnn_tpu_torch/nn/faformer.py`, `ops/eigh3.py`,
`ops/gather.py`, `ops/kernels/frame_swiglu.py`) and `faformer_equihnns` vs
the JAX package and the reference goldens, on the CPU.

Inputs are numpy-seeded and fed to both frameworks; weights come from
numpy at the JAX modules' parameter shapes (`jax.eval_shape` of the init)
and reach the port through `params_from_jax`. JAX's `_FrameSwiGLU` runs its
fused Pallas kernel in interpret mode; the port's wrapper takes its plain
version (CPU tensors). JAX calls are jitted (interpret-mode Pallas runs
eagerly otherwise, ~5x slower). Tolerances (f32, other summation orders):

  * forward: atol 1e-5, rtol 1e-4 (modules), 2e-5 / 1e-4 (whole model);
  * gradients: per tensor, max |Δ| ≤ 1e-4·max |JAX| + 1e-6;
  * eigendecomposition: eigenvalues atol 1e-5·scale; projections onto the
    frame compared in absolute value (eigenvector signs are free, and the
    frame mean is blind to them);
  * goldens: their own tests' atol 5e-5 / rtol 1e-3 (module) and
    2e-4 / 1e-3 (model).

The JAX batches carry `slot_gid`, so JAX's FAFFN and geometric context take
the packed-row branch (per-molecule statistics through one-hot matmuls);
the port's rows hold one molecule each and take the per-row branch. Both
must agree.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.data.synthetic import make_synthetic_dataset
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.nn import faformer as jfa
from equihgnn_tpu.ops.eigh3 import eigh3x3 as jax_eigh3x3
from equihgnn_tpu.ops.knn import knn_dense as jax_knn_dense
from equihgnn_tpu.ops.pallas.frame_swiglu import fused_frame_swiglu as jax_fused
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import faformer as tfa
from equihgnn_tpu_torch.ops.eigh3 import eigh3x3
from equihgnn_tpu_torch.ops.gather import nbr_gather
from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
    drop_consts,
    dropout_keep,
    frame_swiglu_plain,
    fused_frame_swiglu,
)
from equihgnn_tpu_torch.ops.knn import knn_dense

torch.set_num_threads(1)

GEN = dict(generator=torch.Generator().manual_seed(0))
CFG = dict(mlp_hidden=32, output_hidden=8, all_num_layers=3, output_num_layers=3)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(t):
    return t.detach().numpy()


def _assert_grad_close(got, want, name):
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max())
    limit = 1e-4 * float(np.abs(want).max()) + 1e-6
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


# ----------------------------------------------------------- kNN, eigh, gather


def test_knn_dense_faformer_mode_matches_jax():
    """exclude_self=True, squared_radius=False (the radius against the
    distance), as FAFormer calls it."""
    rng = np.random.default_rng(3)
    r, a, k = 5, 12, 16
    pos = (rng.standard_normal((r, a, 3)) * 2.0).astype(np.float32)
    mask = np.arange(a)[None, :] < rng.integers(1, a + 1, size=r)[:, None]
    pos = pos * mask[..., None]
    idx, nmask, rank = knn_dense(_t(pos), _t(mask), k, valid_radius=2.5,
                                 squared_radius=False, exclude_self=True)
    jidx, jmask, jrank = jax_knn_dense(jnp.asarray(pos), jnp.asarray(mask), k,
                                       valid_radius=2.5, squared_radius=False,
                                       exclude_self=True)
    np.testing.assert_array_equal(_np(idx), np.asarray(jidx))
    np.testing.assert_array_equal(_np(nmask), np.asarray(jmask))
    np.testing.assert_allclose(_np(rank), np.asarray(jrank), rtol=1e-6)
    assert not bool((idx == torch.arange(a)[None, :, None])[nmask].any())  # no self edge
    # the radius bites: some in-molecule pairs are cut at 2.5 (not 2.5²)
    assert bool((rank < 2.5**2).any()) and bool(((rank > 2.5**2) & (rank < 1e4)).any())


def _point_sets():
    """[B, P, 3] point sets and masks whose covariances are random, exactly
    isotropic (a regular tetrahedron), rank 1 (collinear points; two
    points), rank 2 (coplanar), zero (one point) and empty."""
    rng = np.random.default_rng(0)
    p = 7
    full, sets, masks = np.ones(p, bool), [], []
    for _ in range(4):
        sets.append(rng.standard_normal((p, 3)))
        masks.append(full)
    tet = np.array([[1, 1, 1], [1, -1, -1], [-1, 1, -1], [-1, -1, 1]], float)
    sets.append(np.concatenate([tet, np.zeros((3, 3))]))
    masks.append(np.arange(p) < 4)
    sets.append(rng.standard_normal((p, 1)) * rng.standard_normal(3))
    masks.append(full)
    sets.append(rng.standard_normal((p, 3)))
    masks.append(np.arange(p) < 2)
    u, v = rng.standard_normal(3), rng.standard_normal(3)
    sets.append(rng.standard_normal((p, 1)) * u + rng.standard_normal((p, 1)) * v)
    masks.append(full)
    sets.append(rng.standard_normal((p, 3)))
    masks.append(np.arange(p) < 1)
    sets.append(rng.standard_normal((p, 3)))
    masks.append(np.zeros(p, bool))
    return np.stack(sets).astype(np.float32), np.stack(masks)


WELL_POSED = [0, 1, 2, 3, 4, 8, 9]  # random, isotropic, coplanar, one point, empty


def test_eigh3x3_matches_jax_on_random_matrices():
    rng = np.random.default_rng(1)
    b = rng.standard_normal((64, 3, 3)).astype(np.float32)
    a = b @ np.swapaxes(b, -1, -2)
    lam, vec = eigh3x3(_t(a))
    jlam, jvec = jax_eigh3x3(jnp.asarray(a))
    np.testing.assert_allclose(_np(lam), np.asarray(jlam), atol=1e-5 * np.abs(a).max())
    np.testing.assert_allclose(np.abs(_np(vec)), np.abs(np.asarray(jvec)), atol=1e-4)
    # a true eigendecomposition: A V = V diag(λ), Vᵀ V = I
    np.testing.assert_allclose(_np(vec.transpose(-1, -2) @ vec), np.eye(3)[None].repeat(64, 0),
                               atol=1e-5)
    np.testing.assert_allclose(_np(_t(a) @ vec), _np(vec * lam[:, None, :]), atol=1e-4)


def test_eigh3x3_fallbacks_match_jax():
    """The same covariances into both: the isotropic test, the `ex`
    fallback and the `alt` re-orthogonalisation give the same eigenvalues
    and, up to sign, the same eigenvectors."""
    pts, mask = _point_sets()
    m = mask[..., None].astype(np.float32)
    x = (pts - (pts * m).sum(1, keepdims=True) / np.maximum(m.sum(1, keepdims=True), 1)) * m
    cov = np.einsum("bpi,bpj->bij", x, x).astype(np.float32)
    cov[~mask.any(1)] = np.eye(3, dtype=np.float32)  # the degeneracy gate
    lam, vec = eigh3x3(_t(cov))
    jlam, jvec = jax_eigh3x3(jnp.asarray(cov))
    np.testing.assert_allclose(_np(lam), np.asarray(jlam), atol=1e-5 * np.abs(cov).max())
    np.testing.assert_allclose(np.abs(_np(vec)), np.abs(np.asarray(jvec)), atol=1e-5)
    # isotropic, one point, empty: the fallbacks give the identity basis
    np.testing.assert_allclose(_np(vec[[4, 8, 9]]), np.eye(3)[None].repeat(3, 0), atol=1e-6)


def test_frame_basis_matches_jax():
    """create_frame_basis on point sets whose frames are well posed. (With
    a rank-1 covariance, i.e. two points or collinear ones, the basis of
    the null space comes from rounding noise in the cross products, so any
    two implementations that sum in another order, JAX on another device
    included, get other frames there.)"""
    pts, mask = _point_sets()
    pts, mask = pts[WELL_POSED], mask[WELL_POSED]
    vbar, center = tfa.create_frame_basis(_t(pts), _t(mask))
    jvbar, jcenter = jfa.create_frame_basis(jnp.asarray(pts), jnp.asarray(mask))
    np.testing.assert_allclose(_np(center), np.asarray(jcenter), atol=1e-6)
    np.testing.assert_allclose(np.abs(_np(vbar)), np.abs(np.asarray(jvbar)), atol=1e-5)


def test_create_and_invert_frame_match_jax():
    rng = np.random.default_rng(7)
    coords = rng.standard_normal((3, 9, 3)).astype(np.float32)
    mask = rng.random((3, 9)) > 0.25
    h, f_ops, center = tfa.create_frame(_t(coords), _t(mask))
    jh, jf, jc = jfa.create_frame(jnp.asarray(coords), jnp.asarray(mask))
    assert h.shape == (3, 8, 9, 3) and f_ops.shape == (3, 8, 3, 3)
    np.testing.assert_allclose(np.abs(_np(h)), np.abs(np.asarray(jh)), atol=1e-5)
    np.testing.assert_allclose(np.abs(_np(f_ops)), np.abs(np.asarray(jf)), atol=1e-5)
    np.testing.assert_allclose(_np(center), np.asarray(jc), atol=1e-6)
    # h = s_o ⊙ vbar, and inverting the frames gives the coordinates back
    vbar, _ = tfa.create_frame_basis(_t(coords), _t(mask))
    signs = tfa._SIGN_OPS
    np.testing.assert_allclose(_np(h), _np(signs[None, :, None, :] * vbar[:, None]), atol=1e-6)
    back = tfa.invert_frame(h, _t(mask), f_ops, center)
    np.testing.assert_allclose(_np(back), coords * mask[..., None], atol=1e-5)
    # invert_frame alone, on the same arbitrary inputs
    xs = rng.standard_normal((3, 8, 9, 3)).astype(np.float32)
    fo = rng.standard_normal((3, 8, 3, 3)).astype(np.float32)
    got = tfa.invert_frame(_t(xs), _t(mask), _t(fo), center)
    want = jfa.invert_frame(jnp.asarray(xs), jnp.asarray(mask), jnp.asarray(fo), jc)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5)


def test_nbr_gather_matches_jax_and_backward():
    from equihgnn_tpu.ops.gather import nbr_gather as jax_gather

    rng = np.random.default_rng(2)
    g, a, k, f = 4, 6, 5, 3
    x = rng.standard_normal((g, a, 2, f)).astype(np.float32)
    idx = rng.integers(0, a, (g, a, k))
    mask = rng.random((g, a, k)) > 0.3
    ct = rng.standard_normal((g, a, k, 2, f)).astype(np.float32)
    xt = _t(x).requires_grad_()
    out = nbr_gather(xt, _t(idx), _t(mask))
    want, vjp = jax.vjp(lambda v: jax_gather(v, jnp.asarray(idx, jnp.int32), jnp.asarray(mask)),
                        jnp.asarray(x))
    np.testing.assert_array_equal(_np(out), np.asarray(want))
    out.backward(_t(ct))
    np.testing.assert_allclose(_np(xt.grad), np.asarray(vjp(jnp.asarray(ct))[0]), atol=1e-6)
    assert out.grad_fn.name() == "WhereBackward0"


# ---------------------------------------------------------- frame SwiGLU


def _fs_inputs(p, c, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((p, c)).astype(np.float32),
            (rng.standard_normal((c, h)) * 0.3).astype(np.float32),
            (rng.standard_normal(h) * 0.1).astype(np.float32),
            (1.0 + 0.2 * rng.standard_normal(h // 2)).astype(np.float32),
            (0.1 * rng.standard_normal(h // 2)).astype(np.float32))


@pytest.mark.parametrize("p,c,h", [(37, 4, 32), (21, 3, 64)])
def test_fused_frame_swiglu_matches_jax_kernel(p, c, h):
    """The port's wrapper (plain version on the CPU) vs JAX's fused Pallas
    kernel (interpret mode): forward and all five gradients."""
    args = _fs_inputs(p, c, h, seed=p + c)
    leaves = [_t(a).requires_grad_() for a in args]
    out = fused_frame_swiglu(*leaves)
    torch.sum(torch.sin(out)).backward()
    want = jax.jit(jax_fused)(*map(jnp.asarray, args))
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=1e-5, rtol=1e-4)
    jgrads = jax.jit(jax.grad(lambda *a: jnp.sum(jnp.sin(jax_fused(*a))), argnums=tuple(range(5))))(
        *map(jnp.asarray, args))
    for name, leaf, jg in zip(("x", "w1", "b1", "ls", "lb"), leaves, jgrads):
        _assert_grad_close(_np(leaf.grad), jg, name)


@pytest.mark.parametrize("c", [3, 4])
def test_frame_swiglu_module_matches_jax(c):
    """`_FrameSwiGLU` (fc1 → fused chain → fc2) vs JAX's module: forward and
    the gradients of its parameters and its input."""
    rng = np.random.default_rng(c)
    x = rng.standard_normal((3, 5, c)).astype(np.float32)
    jm = jfa._FrameSwiGLU(32, 12, drop=0.1)
    flat = _random_params(jm, jnp.asarray(x))
    tm = _port(tfa._FrameSwiGLU(c, 32, 12, drop=0.1, **GEN), flat)
    xt = _t(x).requires_grad_()
    out = tm(xt)
    torch.sum(out * out).backward()

    def loss(variables, xv):
        return jnp.sum(jm.apply(variables, xv, deterministic=True) ** 2)

    want = jax.jit(lambda v, xv: jm.apply(v, xv, deterministic=True))(_unflat(flat), jnp.asarray(x))
    np.testing.assert_allclose(_np(out), np.asarray(want), atol=1e-5, rtol=1e-4)
    gv, gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(_unflat(flat), jnp.asarray(x))
    gflat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(gv["params"], sep="/").items()}
    for key, w in params_from_jax(gflat, tm).items():
        _assert_grad_close(_np(dict(tm.named_parameters())[key].grad), w, key)
    _assert_grad_close(_np(xt.grad), gx, "x")


def test_plain_dropout_mask_and_scale():
    """The plain version's dropout: keep rate 1 − p, kept values scaled by
    1/(1 − p), one mask per seed, another for another seed, and the hash
    equal to a uint32 numpy implementation (the CUDA kernels' arithmetic)."""
    rate, p, hh = 0.1, 600, 32
    keep = dropout_keep(5, p, hh, rate)
    assert keep.shape == (p, 8, hh)
    assert abs(float(keep.float().mean()) - (1 - rate)) < 0.01
    assert torch.equal(keep, dropout_keep(5, p, hh, rate))
    assert float((keep != dropout_keep(6, p, hh, rate)).float().mean()) > 0.1

    def fmix(h):
        h = h ^ (h >> np.uint32(16))
        h = h * np.uint32(0x85EBCA6B)
        h = h ^ (h >> np.uint32(13))
        h = h * np.uint32(0xC2B2AE35)
        return h ^ (h >> np.uint32(16))

    with np.errstate(over="ignore"):
        s = fmix(np.uint32(5))
        pp = np.arange(p, dtype=np.uint32)[:, None, None]
        cc = np.arange(8 * hh, dtype=np.uint32).reshape(1, 8, hh)
        want = fmix(fmix(pp ^ s) ^ (cc * np.uint32(0x9E3779B9) + s)) >= np.uint32(
            drop_consts(rate)[0])
    np.testing.assert_array_equal(_np(keep), want)

    # the mask enters before the LayerNorm, kept values scaled by 1/(1 − p)
    args = [_t(a) for a in _fs_inputs(p, 4, 2 * hh, seed=9)]
    got = frame_swiglu_plain(*args, drop_rate=rate, seed=5)
    x, w1, b1, ls, lb = args
    sgn = torch.cat([tfa._SIGN_OPS, torch.ones(8, 1)], -1)
    pre = (x[:, None, :] * sgn) @ w1 + b1
    y = torch.nn.functional.silu(pre[..., :hh]) * pre[..., hh:]
    y = torch.where(keep, y / (1 - rate), 0.0)
    want = torch.nn.functional.layer_norm(y, (hh,), ls, lb, eps=1e-5).mean(1)
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=1e-4)
    assert not torch.allclose(got, frame_swiglu_plain(*args), atol=1e-3)


def test_frame_swiglu_module_dropout_follows_the_generator():
    tm = tfa._FrameSwiGLU(4, 32, 12, drop=0.1, **GEN).train()
    x = torch.randn(40, 4, generator=torch.Generator().manual_seed(1))
    torch.manual_seed(3)
    a = tm(x)
    torch.manual_seed(3)
    b = tm(x)
    c = tm(x)
    assert torch.equal(a, b) and not torch.allclose(a, c)
    tm.eval()
    torch.testing.assert_close(tm(x), tm(x))


# ------------------------------------------------------------- the modules


def _dense_inputs(g=3, a=10, d=16, k=16, seed=0):
    rng = np.random.default_rng(seed)
    mask = np.arange(a)[None, :] < rng.integers(3, a + 1, size=g)[:, None]
    geo = (rng.standard_normal((g, a, 3)) * 1.5).astype(np.float32) * mask[..., None]
    token = rng.standard_normal((g, a, d)).astype(np.float32) * mask[..., None]
    idx, nmask, _ = jax_knn_dense(jnp.asarray(geo), jnp.asarray(mask), min(k, a),
                                  valid_radius=5.0, squared_radius=False, exclude_self=True)
    edge = rng.standard_normal((g, a, min(k, a), d)).astype(np.float32)
    return token, geo, np.asarray(idx).astype(np.int64), np.asarray(nmask), mask, edge


@pytest.mark.parametrize("activation", ["swiglu", "silu"])
def test_edge_module_matches_jax(activation):
    token, geo, idx, nmask, _, _ = _dense_inputs()
    d = token.shape[-1]
    jm = jfa.EdgeModule(d, d, proj_drop=0.1, activation=activation)
    jargs = (jnp.asarray(token), jnp.asarray(geo), jnp.asarray(idx, jnp.int32), jnp.asarray(nmask))
    flat = _random_params(jm, *jargs)
    tm = _port(tfa.EdgeModule(d, d, 0.1, activation, **GEN), flat)
    want = jax.jit(lambda v: jm.apply(v, *jargs))(_unflat(flat))
    with torch.no_grad():
        got = tm(_t(token), _t(geo), _t(idx), _t(nmask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("activation", ["swiglu", "silu"])
def test_faffn_matches_jax(activation):
    token, geo, _, _, mask, _ = _dense_inputs(seed=1)
    d = token.shape[-1]
    jm = jfa.FAFFN(d, proj_drop=0.1, activation=activation)
    jargs = (jnp.asarray(token), jnp.asarray(geo), jnp.asarray(mask))
    flat = _random_params(jm, *jargs)
    tm = _port(tfa.FAFFN(d, 0.1, activation, **GEN), flat)
    want = jax.jit(lambda v: jm.apply(v, *jargs))(_unflat(flat))
    with torch.no_grad():
        got = tm(_t(token), _t(geo), _t(mask))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("n_heads", [2, 1])
def test_attn_edge_aggregation_matches_jax(n_heads):
    token, geo, idx, nmask, mask, edge = _dense_inputs(seed=2)
    d = token.shape[-1]
    jm = jfa.MLPAttnEdgeAggregation(d, d, n_heads, 0.1, 0.1, "swiglu")
    jargs = (jnp.asarray(token), jnp.asarray(geo), jnp.asarray(edge),
             jnp.asarray(idx, jnp.int32), jnp.asarray(nmask), jnp.asarray(mask))
    flat = _random_params(jm, *jargs)
    tm = _port(tfa.MLPAttnEdgeAggregation(d, d, n_heads, 0.1, 0.1, "swiglu", **GEN), flat)
    jtok, jgeo = jax.jit(lambda v: jm.apply(v, *jargs))(_unflat(flat))
    with torch.no_grad():
        tok, geo_out = tm(_t(token), _t(geo), _t(edge), _t(idx), _t(nmask), _t(mask))
    np.testing.assert_allclose(_np(tok), np.asarray(jtok), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(_np(geo_out), np.asarray(jgeo), atol=1e-5, rtol=1e-4)


def test_linear_without_bias_and_gate_init():
    m = tfa.MLPAttnEdgeAggregation(16, 16, 2, **GEN)
    assert m.mlp_attn.bias is None and m.edge_attn.bias is None
    assert "mlp_attn.bias" not in m.state_dict()
    assert torch.all(m.W_gate.weight == 0) and torch.all(m.W_gate.bias == 1)
    x = torch.randn(5, 8)
    torch.testing.assert_close(m.mlp_attn(x), x @ m.mlp_attn.weight.t())
    # a fresh flax tree of the same module has the same parameter names
    token, geo, idx, nmask, mask, edge = _dense_inputs(d=16)
    jm = jfa.MLPAttnEdgeAggregation(16, 16, 2, activation="gelu")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), *map(jnp.asarray, (token, geo, edge, idx, nmask, mask))))
    keys = set(traverse_util.flatten_dict(shapes["params"], sep="/"))
    assert "mlp_attn/kernel" in keys and "mlp_attn/bias" not in keys


def test_unported_paths_raise():
    with pytest.raises(NotImplementedError, match="faithful_frame_agg"):
        tfa.MLPAttnEdgeAggregation(16, 16, 2, faithful_frame_agg=True, **GEN)
    with pytest.raises(NotImplementedError, match="ROADMAP item 4"):
        tfa.create_frame_basis(torch.zeros(2, 4, 3), torch.ones(2, 4, dtype=torch.bool),
                               slot_gid=torch.zeros(2, 4, dtype=torch.int64))
    for override in (dict(compute_dtype="bfloat16"), dict(remat=True)):
        with pytest.raises(NotImplementedError):
            create_model("faformer_equihnns", num_target=1, cfg=ModelConfig(**CFG, **override))


# ---------------------------------------------------------------- goldens


def test_faformer_module_golden():
    from test_reference_goldens import _state, faformer_tree, load

    d = load("faformer_module")
    dim, k = 32, int(d["meta::k"])
    n = d["in::feats"].shape[0]
    flat = traverse_util.flatten_dict(faformer_tree(_state(d)), sep="/")
    tm = _port(tfa.FAFormer(d_input=dim, d_model=dim, d_edge_model=dim, n_layers=2, n_heads=2,
                            n_neighbors=k, valid_radius=5.0, activation="swiglu", **GEN), flat)
    ar = torch.arange(n)
    with torch.no_grad():
        tok, geo = tm(_t(d["in::feats"]), _t(d["in::coors"]), torch.zeros(n, dtype=torch.int64),
                      ar[None], torch.ones(1, n, dtype=torch.bool), ar)
    np.testing.assert_allclose(_np(tok), d["out::token"], atol=5e-5, rtol=1e-3)
    np.testing.assert_allclose(_np(geo), d["out::coords"], atol=5e-5, rtol=1e-3)


def test_faformer_model_golden():
    """Single-molecule batch: the reference's whole-batch point cloud and
    the per-molecule layout coincide only there (as the JAX test)."""
    from equihgnn_tpu_torch.data.batching import BatchSpec
    from test_reference_goldens import _model_cfg, _state, _strip, faformer_tree, load, model_tree

    d = load("model_faformer_equihnns")
    st = _state(d)
    jcfg = _model_cfg()
    tree = model_tree("mhnns", st, jcfg)["params"]
    tree["fa_former"] = faformer_tree(_strip(st, "fa_former."))
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(tree, sep="/").items()}
    cfg = ModelConfig(all_num_layers=3, mlp_hidden=64, output_hidden=64, output_num_layers=2,
                      aggregate="mean", normalization="ln", activation="relu", dropout=0.0)
    model = _port(create_model("faformer_equihnns", num_target=1, cfg=cfg), flat)
    samples = [s for s in make_synthetic_dataset(8, seed=17) if s.n_atoms >= 16][:1]
    spec = BatchSpec(num_graphs=2, num_atoms=64, num_hedges=64, nnz=128, max_atoms_per_graph=32)
    with torch.no_grad():
        out = model(pad_hypergraph_batch(samples, spec, target=0, with_pos=True))
    np.testing.assert_allclose(_np(out)[:1], d["out::y"], atol=2e-4, rtol=1e-3)


# ---------------------------------------------------------- the whole model


@pytest.fixture(scope="module")
def matched():
    """A multi-molecule batch for both frameworks, the JAX model and flat
    random parameters (the whole tree redrawn, so that W_gate moves)."""
    samples = make_synthetic_dataset(6, seed=23, num_targets=1)
    jb = jax.tree.map(jnp.asarray, jax_pad(samples, jax_spec(samples, batch_size=8), target=0,
                                           with_pos=True))
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0,
                              with_pos=True)
    jm = jax_create_model("faformer_equihnns", num_target=1, cfg=JaxModelConfig(**CFG))
    flat = _random_params(jm, jb, deterministic=True)
    flat = {k: (v * 0.5 if k.startswith("atom_encoder") else v) for k, v in flat.items()}
    return jb, tb, jm, flat


def test_model_matches_jax(matched):
    jb, tb, jm, flat = matched
    want = np.asarray(jax.jit(lambda v: jm.apply(v, jb, deterministic=True))(_unflat(flat)))
    model = _port(create_model("faformer_equihnns", num_target=1, cfg=ModelConfig(**CFG)), flat)
    with torch.no_grad():
        got = _np(model(tb))
    assert got.shape == want.shape == (9,)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-4)


def test_params_from_jax_covers_the_faformer_tree(matched):
    """Every flax parameter of `faformer_equihnns` has its port key and
    every port parameter its flax path; a key too many or too few raises."""
    _, _, _, flat = matched
    model = create_model("faformer_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    state = params_from_jax(flat, model)
    assert set(state) == set(model.state_dict()) and len(state) == len(flat)
    assert "fa_former.layers_1.self_attn.mlp_attn.weight" in state
    assert "fa_former.layers_0.ffn.W_frame.norm.weight" in state  # LayerNorm scale
    with pytest.raises(KeyError):
        params_from_jax({**flat, "fa_former/layers_0/self_attn/mlp_attn/bias":
                         np.zeros(1, np.float32)}, model)
    with pytest.raises(KeyError):
        params_from_jax({k: v for k, v in flat.items() if "W_gate" not in k}, model)


def test_model_grads_match_jax(matched):
    """Parameter gradients of the masked MSE, deterministic=True (the port
    in eval() mode, gradients on): every parameter reached in JAX is reached
    in the port."""
    from equihgnn_tpu.train.trainer import masked_mse as jax_masked_mse
    from equihgnn_tpu_torch.train.trainer import masked_mse

    jb, tb, jm, flat = matched

    def loss_fn(v):
        sq, cnt = jax_masked_mse(jm.apply(v, jb, deterministic=True), jb.y, jb.graph_mask)
        return sq / jnp.maximum(cnt, 1.0)

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(_unflat(flat))
    model = _port(create_model("faformer_equihnns", num_target=1, cfg=ModelConfig(**CFG)), flat)
    want = params_from_jax({k: np.asarray(v) for k, v in traverse_util.flatten_dict(
        jgrads["params"], sep="/").items()}, model)
    sq, cnt = masked_mse(model(tb), tb.y, tb.graph_mask)
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
        _assert_grad_close(_np(p.grad), w, name)
        reached += 1
    # the kernel D/E sites: 3 EdgeModules, 2 FAFFNs. The last layer's
    # EdgeModule updates edge features that nothing reads: no gradient in
    # either framework, and its backward never runs (kernel E: 4 launches
    # per train step, kernel D: 5 per forward)
    frame_keys = [n for n in want if "coord_mlp.fc1" in n or "W_frame.fc1" in n]
    unread = "fa_former.layers_1.edge_module."
    assert len(frame_keys) == 10
    for n in frame_keys:
        assert (float(want[n].abs().max()) > 0) == (not n.startswith(unread)), n
    assert {n for n in want if float(want[n].abs().max()) == 0} == {
        n for n in want if n.startswith(unread)}
    assert reached == len(want) - len([n for n in want if n.startswith(unread)])


# ------------------------- kernel E: positions whose output gradient is 0


def test_frame_swiglu_bwd_on_zeroed_positions_is_the_live_positions_backward():
    """Kernel E skips every position whose row of dout is 0. The function it
    must keep: the plain backward for dout zeroed on a mask equals the
    backward over the kept positions alone (each gradient within
    1e-5·max + 1e-7: the same terms summed in another order), with exactly
    0 in dx at every dropped position; and both agree with `jax.vjp` of
    JAX's fused frame SwiGLU (its Pallas backward in interpret mode) on the
    same zeroed dout, per tensor within 1e-4·max|JAX| + 1e-6."""
    from equihgnn_tpu_torch.ops.kernels.frame_swiglu import frame_swiglu_bwd_plain

    p, c, h = 41, 4, 64
    args = _fs_inputs(p, c, h, seed=8)
    rng = np.random.default_rng(9)
    keep = rng.random(p) < 0.5
    keep[:2] = (True, False)
    dout = rng.standard_normal((p, h // 2)).astype(np.float32) * keep[:, None]
    targs = [_t(a) for a in args]
    got = frame_swiglu_bwd_plain(*targs, _t(dout))
    kept = torch.from_numpy(keep)
    want = frame_swiglu_bwd_plain(targs[0][kept], *targs[1:], _t(dout)[kept])
    names = ("dx", "dw1", "db1", "dls", "dlb")
    for name, x, y in zip(names, (got[0][kept], *got[1:]), want):
        err, scale = float((x - y).abs().max()), float(y.abs().max())
        assert err <= 1e-5 * scale + 1e-7, f"{name}: {err:.3e} of {scale:.3e}"
    assert torch.all(got[0][~kept] == 0)
    jvjp = jax.jit(lambda *a: jax.vjp(jax_fused, *a[:5])[1](a[5]))
    for name, x, y in zip(names, got, jvjp(*map(jnp.asarray, args), jnp.asarray(dout))):
        _assert_grad_close(_np(x), y, name)


def test_frame_swiglu_dout_zeros_in_a_train_step(monkeypatch):
    """Where kernel E's skip applies, in one `faformer_equihnns` train step
    on the CPU (dropout on): the gradient that reaches the frame SwiGLU
    (dout, a row a position) is exactly 0 at every FAFFN padding slot and
    at every EdgeModule neighbour the kNN mask drops, but for the dropped
    neighbours of a real atom with no neighbour within the radius: its
    all-masked attention row softmaxes to 1/k over those edges, whose edge
    features then reach the loss (through v_e). One atom is moved 100 Å
    away so that the batch has such a row. No kept position has a zero
    row. (At batch 768 a CPU step of the recipe gave 64 such edges of
    221,911 dropped; PERF.md §6.)"""
    from equihgnn_tpu_torch.data.batching import iter_batches
    from equihgnn_tpu_torch.train.trainer import masked_mse

    seen, rows = {}, []
    kernel, knn = tfa.fused_frame_swiglu, tfa.knn_dense

    def knn_seen(*a, **kw):
        seen["knn"] = knn(*a, **kw)
        return seen["knn"]

    def kernel_seen(x, *a, **kw):
        out = kernel(x, *a, **kw)
        site = "EdgeModule" if x.shape[-1] == 4 else "FAFFN"
        out.register_hook(lambda g: rows.append((site, (g == 0).all(-1))))
        return out

    monkeypatch.setattr(tfa, "knn_dense", knn_seen)
    monkeypatch.setattr(tfa, "fused_frame_swiglu", kernel_seen)
    samples = make_synthetic_dataset(6, seed=31, num_targets=1)
    samples[0].pos[0] += 100.0  # a real atom with no neighbour within 5 Å
    batch = next(iter_batches(samples, spec_for_samples(samples, batch_size=8), with_pos=True,
                              target=0))
    model = create_model("faformer_equihnns", num_target=1, cfg=ModelConfig(**CFG),
                         generator=torch.Generator().manual_seed(3)).train()
    sq, cnt = masked_mse(model(batch), batch.y, batch.graph_mask)
    (sq / cnt.clamp(min=1.0)).backward()
    nbr_mask = seen["knn"][1]
    alone = batch.slot_mask & ~nbr_mask.any(-1)  # real slots with no kept neighbour
    assert int(alone.sum()) == 1
    leaks = (~nbr_mask & alone[..., None]).reshape(-1)
    kept = {"EdgeModule": nbr_mask.reshape(-1), "FAFFN": batch.slot_mask.reshape(-1)}
    assert sorted(site for site, _ in rows) == ["EdgeModule"] * 2 + ["FAFFN"] * 2
    for site, zero in rows:
        live = kept[site]
        assert not (live & zero).any(), site
        if site == "FAFFN":
            assert torch.equal(zero, ~live)
        else:  # every dropped neighbour is 0 but the lone atom's
            assert torch.equal(zero, ~live & ~leaks) and leaks.any()
