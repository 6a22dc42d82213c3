"""Kernel J's live sites and its 3xTF32 products, on the CPU.

`pooled_conv(h, tc, w, c, live)` keeps the output of the sites that
`live` [G, A] marks and gives 0 elsewhere; its backward is kernel K's on
dout · live. The SE(3)-Transformer passes `nbr_mask.any(-1)`: a site with
no neighbour has tc = 0 there, so the model's function is unchanged. Held
here, on the plain version (what the wrapper runs for CPU tensors):

  * against JAX's f32 composition of a pooled unit (the M build and its
    projection, `se3_transformer.py:292-295`) with tc and the output zeroed
    at the dead sites, and its `jax.vjp`: forward 1e-4·max |JAX| + 1e-6,
    gradients 1e-3·max |JAX| + 1e-6 per tensor (other summation orders), as
    `tests/test_torch_se3.py`; random, all-dead and all-live masks;
  * against the unmasked plain version where tc (and, for the gradients,
    h, as the model zeroes both) is 0 at the dead sites: the same bits;
  * the live-site list the wrapper hands kernels J and K (`live_sites`):
    ids in order, live first, the count as a one-element int32 tensor;
    passed in built (`LiveSites`), the same output and gradients as the
    bare mask, through autograd on the CPU;
  * kernel K's plain backward with the live sites
    (`pooled_conv_bwd_plain(h, tc, w, c, dout, live)`, a mask or a
    `LiveSites`) against `jax.vjp` of JAX's `pooled_conv` (its Pallas
    kernels in interpret mode, C = 3: C = 1 takes ~3x as long to trace) on
    dout · live, random, all-dead and all-live masks: 1e-3·max |JAX| + 1e-6
    per tensor, dh and dtc exactly 0 at the dead sites;
  * the 3xTF32 split of J's products (big = tf32(x), small = tf32(x − big),
    big·big + big·small + small·big summed in f32 per k8 step), emulated in
    torch by bit operations on the int32 view, at the model's contraction
    length I·F = 32,768: within J's gate (1e-4·max |ref| + 1e-6) of a
    float64 product, and one TF32 product not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equihgnn_tpu.ops.pallas.pooled_conv import pooled_conv as jax_pooled_conv
from equihgnn_tpu_torch.ops.kernels.pooled_conv import (
    live_sites,
    pooled_conv,
    pooled_conv_bwd_plain,
    pooled_conv_plain,
)

torch.set_num_threads(1)


def _inputs(g, a, k, c, i, f, o, mask, seed):
    rng = np.random.default_rng(seed)
    live = {"random": rng.random((g, a)) < 0.5, "all_dead": np.zeros((g, a), bool),
            "all_live": np.ones((g, a), bool)}[mask]
    h = rng.standard_normal((g, a, k, f)).astype(np.float32)
    tc = rng.standard_normal((g, a, k, c * i)).astype(np.float32) * live[..., None, None]
    w = (rng.standard_normal((f, o, i)) * 0.1).astype(np.float32)
    dout = rng.standard_normal((g, a, c, o)).astype(np.float32)
    return h, tc, w, dout, live


def _assert_rel(got, want, rel, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = float(np.abs(got - want).max()) if want.size else 0.0
    limit = rel * (float(np.abs(want).max()) if want.size else 0.0) + 1e-6
    assert err <= limit, f"{name}: max |d| {err:.3e} > {limit:.3e}"


@pytest.mark.parametrize("mask", ["random", "all_dead", "all_live"])
@pytest.mark.parametrize("c", [1, 3])
def test_live_plain_matches_jax_f32_path(c, mask):
    h, tc, w, dout, live = _inputs(2, 7, 5, c, 12, 16, 24, mask, seed=c)
    g, a, k, _ = h.shape
    lj = jnp.asarray(live)[..., None, None]

    def unit(h_, t_, w_):
        m = jnp.einsum("gakf,gakci->gafci", h_, t_.reshape(g, a, k, c, -1))
        return jnp.einsum("foi,gafci->gaco", w_, m) * lj

    @jax.jit
    def fwd_vjp(h_, t_, w_, d_):
        out_, vjp = jax.vjp(unit, h_, t_, w_)
        return out_, vjp(d_)

    out, want = fwd_vjp(*map(jnp.asarray, (h, tc, w, dout)))
    lt = torch.from_numpy(live)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (h, tc, w)]
    got = pooled_conv(*leaves, c, lt)  # the wrapper on CPU tensors: the plain version
    _assert_rel(got.detach().numpy(), out, 1e-4, "out")
    assert not got.detach()[~lt].any()
    got.backward(torch.from_numpy(dout))
    for name, leaf, y in zip(("dh", "dtc", "dW"), leaves, want):
        _assert_rel(leaf.grad.numpy(), y, 1e-3, f"autograd {name}")
    # kernel K's plain backward on dout · live is the same gradient
    masked = torch.from_numpy(dout) * lt[..., None, None]
    for name, x, y in zip(("dh", "dtc", "dW"), pooled_conv_bwd_plain(
            *map(torch.from_numpy, (h, tc, w)), c, masked), want):
        _assert_rel(x.numpy(), y, 1e-3, f"K on dout·live {name}")


@pytest.mark.parametrize("c", [1, 3])
def test_live_matches_unmasked_where_tc_is_zero_at_dead_sites(c):
    h, tc, w, dout, live = _inputs(3, 6, 4, c, 8, 8, 16, "random", seed=10 + c)
    lt = torch.from_numpy(live)
    args = [torch.from_numpy(x) for x in (h, tc, w)]
    assert torch.equal(pooled_conv(*args, c, lt), pooled_conv(*args, c))
    # the model zeroes h at the masked neighbours as well: then the gradients agree
    args[0] = args[0] * lt[..., None, None]
    grads = []
    for lv in (lt, None):
        leaves = [x.clone().requires_grad_() for x in args]
        pooled_conv(*leaves, c, lv).backward(torch.from_numpy(dout))
        grads.append([x.grad for x in leaves])
    for name, x, y in zip(("dh", "dtc", "dW"), *grads):
        torch.testing.assert_close(x, y, rtol=1e-6, atol=1e-6, msg=name)


@pytest.mark.parametrize("mask", ["random", "all_dead", "all_live", "empty"])
def test_live_sites(mask):
    rng = np.random.default_rng(3)
    live = {"random": rng.random((5, 9)) < 0.4, "all_dead": np.zeros((5, 9), bool),
            "all_live": np.ones((5, 9), bool), "empty": np.zeros((0, 9), bool)}[mask]
    lt = torch.from_numpy(live)
    sites = live_sites(lt)
    ids, count = sites.ids, sites.count
    flat = live.reshape(-1)
    assert sites.mask is lt
    assert ids.dtype == count.dtype == torch.int32 and count.shape == (1,)
    assert int(count[0]) == int(flat.sum())
    want = np.concatenate([np.flatnonzero(flat), np.flatnonzero(~flat)])
    np.testing.assert_array_equal(ids.numpy(), want)


@pytest.mark.parametrize("c", [1, 3])
def test_live_sites_passed_in_match_the_mask(c):
    """A `LiveSites` built once (as the model's conv passes it to each J)
    gives the bool mask's output and gradients, bit for bit."""
    h, tc, w, dout, live = _inputs(2, 9, 4, c, 8, 8, 16, "random", seed=20 + c)
    lt = torch.from_numpy(live)
    runs = []
    for lv in (lt, live_sites(lt)):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (h, tc, w)]
        out = pooled_conv(*leaves, c, lv)
        out.backward(torch.from_numpy(dout))
        runs.append([out.detach()] + [x.grad for x in leaves])
    for name, x, y in zip(("out", "dh", "dtc", "dW"), *runs):
        assert torch.equal(x, y), name


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away from
    zero, as `cvt.rna.tf32.f32`: on the int32 view of the bits."""
    b = x.view(torch.int32)
    r = (b + 0x1000) & ~0x1FFF
    return torch.where((b & 0x7F800000) == 0x7F800000, b, r).view(torch.float32)


def test_3xtf32_split_meets_kernel_j_gate_and_one_tf32_does_not():
    """M [rows, I·F] (each a K = 16 sum of Gaussian products, as the model's)
    times W [I·F, O] (JAX's init scale 1/√F): the f32 accumulator adds each
    k8 step's exact products, as the tensor cores' f32 sums do."""
    rng = np.random.default_rng(0)
    rows, k, f, i, o = 8, 16, 128, 256, 16
    h = rng.standard_normal((rows, k, f)).astype(np.float32)
    tc = rng.standard_normal((rows, k, i)).astype(np.float32)
    m = torch.from_numpy(np.einsum("rkf,rki->rif", h, tc).reshape(rows, i * f))
    w = torch.from_numpy(((rng.random((i * f, o)) * 2 - 1) / np.sqrt(f)).astype(np.float32))
    ref = m.double() @ w.double()
    mb, wb = _tf32(m), _tf32(w)
    ms, ws = _tf32(m - mb), _tf32(w - wb)
    assert torch.equal(_tf32(mb), mb) and torch.equal(_tf32(ms), ms)

    def summed(terms):
        n = m.shape[1]
        a = torch.cat([x.double().reshape(rows, n // 8, 8) for x, _ in terms], -1)
        b = torch.cat([y.double().reshape(n // 8, 8, o) for _, y in terms], 1)
        steps = torch.einsum("rsk,sko->sro", a, b)  # each k8 step, exact
        acc = torch.zeros(rows, o)
        for s in steps:
            acc = (acc.double() + s).float()
        return acc

    gate = 1e-4 * float(ref.abs().max()) + 1e-6
    three = float((summed([(ms, wb), (mb, ws), (mb, wb)]).double() - ref).abs().max())
    one = float((summed([(mb, wb)]).double() - ref).abs().max())
    assert three <= gate, f"3xTF32: max |d| {three:.3e} > {gate:.3e}"
    assert one > gate, f"one TF32 product: max |d| {one:.3e} within {gate:.3e}"


_PALLAS_C = 3


@jax.jit
def _pallas_vjp(h, tc, w, dout):
    """JAX's fused unit (Pallas, interpret mode here) and its VJP at dout."""
    out, vjp = jax.vjp(lambda *x: jax_pooled_conv(*x, _PALLAS_C), h, tc, w)
    return out, vjp(dout)


@pytest.mark.parametrize("form", ["mask", "sites"])
@pytest.mark.parametrize("mask", ["random", "all_dead", "all_live"])
def test_live_bwd_plain_matches_pallas_vjp(mask, form):
    """Kernel K's plain backward at the live sites against `jax.vjp` of JAX's
    `pooled_conv` on dout · live, at a shape its TPU gate accepts (I % 4,
    F % 8, O % 128); the dead sites' tc is not 0 here, so only the live
    masking zeroes their dh and dtc."""
    h, tc, w, dout, live = _inputs(2, 5, 4, _PALLAS_C, 8, 16, 128, mask, seed=30)
    rng = np.random.default_rng(31)
    tc = rng.standard_normal(tc.shape).astype(np.float32)
    masked = dout * live[..., None, None]
    out, want = _pallas_vjp(*map(jnp.asarray, (h, tc, w, masked)))
    lt = torch.from_numpy(live)
    got = pooled_conv_bwd_plain(*map(torch.from_numpy, (h, tc, w)), _PALLAS_C,
                                torch.from_numpy(dout), lt if form == "mask" else live_sites(lt))
    for name, x, y in zip(("dh", "dtc", "dW"), got, want):
        _assert_rel(x.numpy(), y, 1e-3, name)
    assert not got[0][~lt].any() and not got[1][~lt].any()
    # J's output, which this is the backward of: the live sites' rows of JAX's
    _assert_rel(pooled_conv_plain(*map(torch.from_numpy, (h, tc, w)), _PALLAS_C, lt).numpy(),
                np.asarray(out) * live[..., None, None], 1e-4, "out")


@pytest.mark.parametrize("mask", ["random", "all_dead", "all_live"])
@pytest.mark.parametrize("c", [1, 3])
def test_live_autograd_with_sites_matches_the_mask(c, mask):
    """Autograd through the wrapper's CPU path with a built `LiveSites`
    gives the bare mask's gradients bit for bit, those of the plain
    backward on dout · live (1e-5·max + 1e-6: other summation orders), and
    exactly 0 in dh and dtc at the dead sites
    (whose tc is not 0 here)."""
    h, tc, w, dout, live = _inputs(3, 7, 5, c, 8, 8, 16, mask, seed=40 + c)
    tc = np.random.default_rng(41).standard_normal(tc.shape).astype(np.float32)
    lt = torch.from_numpy(live)
    grads = []
    for lv in (lt, live_sites(lt)):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (h, tc, w)]
        pooled_conv(*leaves, c, lv).backward(torch.from_numpy(dout))
        grads.append([x.grad for x in leaves])
    plain = pooled_conv_bwd_plain(*map(torch.from_numpy, (h, tc, w)), c,
                                  torch.from_numpy(dout), lt)
    for name, x, y, z in zip(("dh", "dtc", "dW"), *grads, plain):
        assert torch.equal(x, y), name
        _assert_rel(x.numpy(), z.numpy(), 1e-5, name)  # other summation orders
    assert not grads[1][0][~lt].any() and not grads[1][1][~lt].any()
