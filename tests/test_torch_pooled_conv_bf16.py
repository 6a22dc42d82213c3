"""Kernels J and K in bfloat16 (`ops/kernels/pooled_conv.py`): the gate by
which the port routes a bfloat16 pooled unit, and the plain bfloat16
versions, against the JAX package on the CPU.

  * The gate: the port's copy of JAX's whole `pooled_conv_supported`
    (divisibility and VMEM) equals JAX's over a grid of shapes in bfloat16
    and float32, and fuses the recipe's units where JAX does.
  * The function: the plain bfloat16 J and K against JAX's Pallas
    `pooled_conv` (interpret mode) and its `jax.vjp` in bfloat16 at C = 3,
    I = O = 128: out, dh and dtc came out JAX's bits, dW 0.99997 of them
    (sums over every site that cancel, one ulp of max|dW| / 256 apart).
    Held: at least 0.999 of the elements the same bits, each within one
    bfloat16 ulp of max(|JAX|, max|JAX| / 256).
  * The stand-in: `standin`, a jnp function of the same rounding with its
    own VJP, which the model tests (`tests/test_torch_se3_bf16_fused.py`)
    put in the place of JAX's Pallas `pooled_conv` where its interpret-mode
    kernel would take minutes to trace (C = 1, the whole model), is held to
    the same kernel under the same limits (measured: out 0.99974, dW
    0.99998 the same bits, dh and dtc all).
  * K's yardstick: `chip_smoke.k_bf16_reference`, the cuBLAS composition
    timed beside kernel K on the card, computes K's function (float32,
    against the plain backward at the live sites).

Inputs are numpy-seeded; JAX calls are jitted.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equihgnn_tpu.ops.pallas import pooled_conv as jpc
from equihgnn_tpu_torch.ops.kernels.pooled_conv import (
    live_sites,
    pooled_conv,
    pooled_conv_bwd_plain,
    pooled_conv_plain,
    pooled_conv_supported,
)

torch.set_num_threads(1)

F32, BF16 = jnp.float32, jnp.bfloat16


# ------------------------------------------------------------- the stand-in


def _m(h, tc):
    """M [G, A, C·I, F] of JAX's kernel: f32 sums of the exact products, rounded."""
    return jnp.einsum("gakx,gakf->gaxf", tc, h, preferred_element_type=F32).astype(h.dtype)


def _standin_fwd(h, tc, w):
    g, a, _, f = h.shape
    i = w.shape[2]
    m = _m(h, tc).reshape(g, a, -1, i, f)
    out = jnp.einsum("gacif,foi->gaco", m, w, preferred_element_type=F32).astype(h.dtype)
    return out, (h, tc, w)


def _standin_bwd(res, dout):
    h, tc, w = res
    g, a, _, f = h.shape
    i = w.shape[2]
    m = _m(h, tc).reshape(g, a, -1, i, f)
    dm = jnp.einsum("gaco,foi->gacif", dout, w, preferred_element_type=F32).astype(h.dtype)
    dw = jnp.einsum("gacif,gaco->foi", m, dout, preferred_element_type=F32).astype(w.dtype)
    dm = dm.reshape(g, a, -1, f)
    dh = jnp.einsum("gakx,gaxf->gakf", tc, dm, preferred_element_type=F32).astype(h.dtype)
    dtc = jnp.einsum("gakf,gaxf->gakx", h, dm, preferred_element_type=F32).astype(tc.dtype)
    return dh, dtc, dw


@jax.custom_vjp
def _standin(h, tc, w):
    return _standin_fwd(h, tc, w)[0]


_standin.defvjp(_standin_fwd, _standin_bwd)


def standin(h, tc, w, c):
    """JAX's `pooled_conv(h, tc, w, c)` in bfloat16 as jnp einsums with its
    kernels' rounding: M rounded, out, dM, dh and dtc float32 sums rounded
    once, dW summed in float32 over every site and rounded once. For
    `monkeypatch.setattr(equihgnn_tpu.ops.pallas.pooled_conv, "pooled_conv",
    standin)`: JAX's `_ConvSE3Pair` imports it at each call."""
    return _standin(h, tc, w)


# ----------------------------------------------------------------- helpers


def bf16_ulps(got, want) -> np.ndarray:
    """|got − want| in bfloat16 ulps of max(|want|, max|want| / 256)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    top = float(np.abs(want).max()) if want.size else 0.0
    if top == 0.0:
        return np.abs(got - want)
    mag = np.maximum(np.abs(want), top / 256)
    return np.abs(got - want) / np.exp2(np.floor(np.log2(mag)) - 7)


def assert_bf16_bits(got, want, name, equal=0.999, ulps=1.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, f"{name}: {got.shape} != {want.shape}"
    same = float((got == want).mean())
    far = float(bf16_ulps(got, want).max()) if want.size else 0.0
    assert same >= equal and far <= ulps, f"{name}: {same:.5f} equal, {far:.2f} ulps at most"


def _f(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(F32))


def _tb(x) -> torch.Tensor:
    return torch.from_numpy(_f(x).copy()).bfloat16()


def _inputs(g=2, a=5, k=4, c=3, i=128, f=32, o=128, seed=0):
    """h, tc, W, dout in bfloat16 (jnp), numpy draws."""
    rng = np.random.default_rng(seed)
    arrs = (rng.standard_normal((g, a, k, f)), rng.standard_normal((g, a, k, c * i)),
            rng.standard_normal((f, o, i)) * 0.1, rng.standard_normal((g, a, c, o)))
    return [jnp.asarray(x.astype(np.float32)).astype(BF16) for x in arrs]


def _fwd_vjp(fn, c):
    @jax.jit
    def run(h, tc, w, dout):
        out, vjp = jax.vjp(lambda *x: fn(*x, c), h, tc, w)
        return out, vjp(dout)
    return run


@pytest.fixture(scope="module")
def pallas_c3():
    """JAX's Pallas `pooled_conv` (interpret mode) and its VJP in bfloat16
    at C = 3, I = O = 128, F = 32 (~15 s to trace)."""
    args = _inputs()
    out, grads = _fwd_vjp(jpc.pooled_conv, 3)(*args)
    return args, out, grads


# ----------------------------------------------------------------- the gate


GATE_A = (1, 9, 32, 64, 65, 176, 177, 312, 313, 320)
GATE_K = (0, 4, 16)
GATE_C = (1, 3, 5)
GATE_I = (16, 64, 128, 130, 256, 384, 512)
GATE_O = (64, 128, 256, 384, 512)


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32])
@pytest.mark.parametrize("f", [128, 32, 36])
def test_gate_equals_jax(dtype, f):
    """The port's `pooled_conv_supported` equals JAX's at every shape of the
    grid (10 A × 3 k × 3 C × 7 I × 5 O), for both element sizes; F = 36
    fails the divisibility half everywhere."""
    size = jnp.dtype(dtype).itemsize
    got, want = [], []
    for a in GATE_A:
        for k in GATE_K:
            for c in GATE_C:
                for i in GATE_I:
                    for o in GATE_O:
                        got.append(pooled_conv_supported(a, k, c, i, f, o, size))
                        want.append(jpc.pooled_conv_supported(a, k, c, i, f, o, dtype))
    assert got == want
    assert any(want) == (f % 8 == 0) and not all(want)


@pytest.mark.parametrize("hidden,c,largest_a", [(256, 1, 183), (256, 3, 64), (128, 3, 314),
                                                 (384, 1, 0), (384, 3, 0), (512, 1, 0)])
def test_gate_fuses_the_recipe_where_jax_does(hidden, c, largest_a):
    """In bfloat16 at k = 16, F = 128, I = O = hidden, JAX fuses a unit of
    C = 1 up to A = 183 and of C = 3 up to A = 64 at hidden 256 (the
    recipe's batches have A = 32), up to A = 314 at hidden 128 and C = 3,
    and never at hidden 384 or 512 (there JAX takes the per-J path)."""
    fused = [a for a in range(1, 400) if pooled_conv_supported(a, 16, c, hidden, 128, hidden, 2)]
    assert fused == list(range(1, largest_a + 1))
    assert fused == [a for a in range(1, 400)
                     if jpc.pooled_conv_supported(a, 16, c, hidden, 128, hidden, BF16)]


# --------------------------------------------------------- the plain versions


def test_plain_bf16_matches_pallas_kernel(pallas_c3):
    """The plain bfloat16 J (through the wrapper on CPU tensors) and K
    against JAX's Pallas kernels and their VJP at C = 3."""
    (h, tc, w, dout), out, grads = pallas_c3
    got = pooled_conv(_tb(h), _tb(tc), _tb(w), 3)
    assert got.dtype == torch.bfloat16
    assert_bf16_bits(got.float().numpy(), _f(out), "out")
    for name, x, y in zip(("dh", "dtc", "dW"),
                          pooled_conv_bwd_plain(_tb(h), _tb(tc), _tb(w), 3, _tb(dout)), grads):
        assert x.dtype == torch.bfloat16, name
        assert_bf16_bits(x.float().numpy(), _f(y), name)


def test_standin_matches_pallas_kernel(pallas_c3):
    (h, tc, w, dout), out, grads = pallas_c3
    got, got_grads = _fwd_vjp(standin, 3)(h, tc, w, dout)
    assert got.dtype == BF16
    assert_bf16_bits(_f(got), _f(out), "stand-in out")
    for name, x, y in zip(("dh", "dtc", "dW"), got_grads, grads):
        assert x.dtype == BF16, name
        assert_bf16_bits(_f(x), _f(y), f"stand-in {name}")


@pytest.mark.parametrize("c", [1, 5])
def test_plain_bf16_matches_standin(c):
    """At C = 1 and 5 (JAX's Pallas kernel in interpret mode takes ~50 s to
    trace at C = 1) the plain versions against the stand-in."""
    args = _inputs(g=3, a=4, k=6, c=c, i=16, f=24, o=128, seed=c)
    out, grads = _fwd_vjp(standin, c)(*args)
    h, tc, w, dout = map(_tb, args)
    assert_bf16_bits(pooled_conv_plain(h, tc, w, c).float().numpy(), _f(out), "out")
    for name, x, y in zip(("dh", "dtc", "dW"), pooled_conv_bwd_plain(h, tc, w, c, dout), grads):
        assert_bf16_bits(x.float().numpy(), _f(y), name)


def test_autograd_through_the_plain_bf16_forward_is_its_backward():
    """On CPU tensors the wrapper is the plain forward, which autograd
    traces: with live sites its gradients are `pooled_conv_bwd_plain`'s
    (dM, dh, dtc and dW rounded where it rounds; autograd's float32 sums
    run in other orders, so within one ulp), 0 at the dead sites."""
    h, tc, w, dout = map(_tb, _inputs(g=3, a=5, k=4, c=3, i=16, f=24, o=128, seed=4))
    live = torch.from_numpy(np.random.default_rng(5).random((3, 5)) < 0.5)
    leaves = [t.clone().requires_grad_() for t in (h, tc, w)]
    out = pooled_conv(*leaves, 3, live_sites(live))
    assert out.dtype == torch.bfloat16 and not out[~live].any()
    out.backward(dout)
    for name, leaf, y in zip(("dh", "dtc", "dW"), leaves,
                             pooled_conv_bwd_plain(h, tc, w, 3, dout, live)):
        assert leaf.grad.dtype == torch.bfloat16, name
        assert_bf16_bits(leaf.grad.float().numpy(), y.float().numpy(), name)
    assert not leaves[0].grad[~live].any() and not leaves[1].grad[~live].any()


def test_plain_refuses_mixed_types():
    h, tc, w, dout = map(_tb, _inputs(g=1, a=2, k=3, c=1, i=8, f=8, o=128))
    for args in ((h, tc.float(), w, 1), (h, tc, w.float(), 1), (h.double(), tc, w, 1),
                 (h.half(), tc.half(), w.half(), 1)):
        with pytest.raises(TypeError):
            pooled_conv(*args)
    with pytest.raises(TypeError):
        pooled_conv_bwd_plain(h, tc, w, 1, dout.float())


@pytest.mark.parametrize("c", [1, 3])
def test_k_reference_computes_k(c):
    """`chip_smoke.k_bf16_reference`, the cuBLAS composition timed beside
    kernel K as its yardstick (dM by one matmul, dh and dtc by two bmm, M by
    one bmm, dW by a matmul, at the live sites), computes K's function: in
    float32 it gives the plain backward's dh, dtc (at the live sites) and
    dW, the last in its own [I, F, O] layout."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    g, a, k, i, f, o = 2, 5, 4, 8, 16, 24
    h, tc, w, dout = (torch.from_numpy(_f(x).copy()).float()
                      for x in _inputs(g=g, a=a, k=k, c=c, i=i, f=f, o=o, seed=c))
    live = torch.from_numpy(np.random.default_rng(c).random((g, a)) < 0.6)
    dh, dtc, dw = smoke.k_bf16_reference(h, tc, w, c, dout, live)()
    want_dh, want_dtc, want_dw = pooled_conv_bwd_plain(h, tc, w, c, dout, live)
    idx = live.reshape(-1).nonzero().squeeze(1)
    torch.testing.assert_close(dh, want_dh.reshape(g * a, k, f)[idx], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dtc, want_dtc.reshape(g * a, k, c * i)[idx], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dw.view(i, f, o).permute(1, 2, 0), want_dw, rtol=1e-5, atol=1e-4)
