"""The plain version of kernels L and M (`equihgnn_tpu_torch/ops/kernels/pooled_m.py`)
against JAX's `pooled_m` (`equihgnn_tpu/ops/pallas/pooled_m.py`), on the CPU.

Inputs are numpy-seeded; JAX's Pallas kernels run in interpret mode (jitted),
at an A that is not a multiple of their 8-site tile. Tolerances:

  * float32: M and the VJP (dh, dtc) within rtol = atol = 1e-5 (the same f32
    sums in other orders);
  * bfloat16: M, dh and dtc are f32 sums rounded once to bfloat16 in both,
    so at least 99 % of the elements are equal and every element lies within
    one bfloat16 ulp of JAX's (a sum that lands within f32 rounding of a
    bfloat16 rounding boundary may round the other way).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equihgnn_tpu.ops.pallas.pooled_m import pooled_m as jax_pooled_m
from equihgnn_tpu_torch.ops.kernels.pooled_m import (
    pooled_m,
    pooled_m_bwd,
    pooled_m_bwd_plain,
    pooled_m_plain,
)

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _inputs(x, dtype, g=2, a=11, k=16, f=128, seed=0):
    """h, tc, and the output gradient dm, rounded to `dtype`, as numpy f32."""
    rng = np.random.default_rng(seed)
    jdt = DTYPES[dtype][1]
    arrays = (rng.standard_normal((g, a, k, f)), rng.standard_normal((g, a, k, x)),
              rng.standard_normal((g, a, x, f)))
    return [np.array(jnp.asarray(v, jnp.float32).astype(jdt).astype(jnp.float32))
            for v in arrays]


def _t(v, dtype):
    return torch.from_numpy(v).to(DTYPES[dtype][0])


def _ulps(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Distance in bfloat16 ulps: the bit patterns as ordered integers."""
    def ordered(t):
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -32768 - bits, bits)
    return (ordered(got) - ordered(want)).abs()


def _assert_match(got: torch.Tensor, want, dtype, name):
    want = torch.from_numpy(np.asarray(jnp.asarray(want).astype(jnp.float32)))
    assert got.dtype == DTYPES[dtype][0], f"{name}: {got.dtype}"
    assert got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}"
    if dtype == "float32":
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=name)
        return
    want = want.to(torch.bfloat16)
    equal = float((got == want).float().mean())
    ulps = int(_ulps(got, want).max())
    assert equal >= 0.99 and ulps <= 1, f"{name}: {equal:.4f} equal, {ulps} ulps at most"


@pytest.fixture(scope="module")
def jax_pm():
    @jax.jit
    def fwd_vjp(h, tc, dm):
        out, vjp = jax.vjp(jax_pooled_m, h, tc)
        return out, vjp(dm)

    return fwd_vjp


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("x", [9, 64, 192])
def test_plain_and_autograd_match_jax_pooled_m(jax_pm, x, dtype):
    """M, and (dh, dtc) of `pooled_m_bwd_plain` and of autograd through the
    wrapper's CPU path, against JAX's Pallas kernel and its custom VJP."""
    h, tc, dm = _inputs(x, dtype, seed=x)
    jdt = DTYPES[dtype][1]
    out, (dh, dtc) = jax_pm(*(jnp.asarray(v).astype(jdt) for v in (h, tc, dm)))
    assert out.dtype == dh.dtype == jdt
    _assert_match(pooled_m_plain(_t(h, dtype), _t(tc, dtype)), out, dtype, "M")
    for name, got, want in zip(("dh", "dtc"),
                               pooled_m_bwd_plain(_t(h, dtype), _t(tc, dtype), _t(dm, dtype)),
                               (dh, dtc)):
        _assert_match(got, want, dtype, name)
    leaves = [_t(v, dtype).requires_grad_() for v in (h, tc)]
    m = pooled_m(*leaves)
    _assert_match(m.detach(), out, dtype, "wrapper M")
    m.backward(_t(dm, dtype))
    for name, leaf, want in zip(("dh", "dtc"), leaves, (dh, dtc)):
        _assert_match(leaf.grad, want, dtype, f"autograd {name}")


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_vjp_is_zero_at_sites_with_no_neighbour(jax_pm, dtype):
    """`pooled_m_bwd_plain` against `jax.vjp` of JAX's `pooled_m` (interpret
    mode) where half the sites have h = tc = 0 (no neighbour within the
    radius) and dM there is large and non-zero: dh and dtc are exactly 0 at
    those sites in both, the value kernel M writes there without reading
    dM; the other sites as in `test_plain_and_autograd_match_jax_pooled_m`."""
    h, tc, dm = _inputs(64, dtype, seed=7)
    dead = np.random.default_rng(8).random(h.shape[:2]) < 0.5
    dead[0, 0], dead[0, 1] = True, False
    h[dead], tc[dead] = 0.0, 0.0
    dm = dm * 1e3 + np.sign(dm) * 1e3  # |dM| ≥ 1e3 everywhere
    jdt = DTYPES[dtype][1]
    _, (dh, dtc) = jax_pm(*(jnp.asarray(v).astype(jdt) for v in (h, tc, dm)))
    got = pooled_m_bwd_plain(_t(h, dtype), _t(tc, dtype), _t(dm, dtype))
    live = torch.from_numpy(~dead)
    for name, g_, want in zip(("dh", "dtc"), got, (dh, dtc)):
        _assert_match(g_, want, dtype, name)
        want = np.asarray(jnp.asarray(want).astype(jnp.float32))
        assert not np.any(want[dead]) and np.abs(want[~dead]).max() > 0, f"JAX {name}"
        assert not g_[~live].float().any() and g_[live].float().abs().max() > 0, name


def test_plain_takes_any_k():
    """K = 0 (no neighbour) gives zeros; a ragged K, F and X against float64."""
    rng = np.random.default_rng(3)
    for k, f, x in ((0, 8, 5), (3, 7, 9)):
        h = torch.from_numpy(rng.standard_normal((2, 3, k, f)).astype(np.float32))
        tc = torch.from_numpy(rng.standard_normal((2, 3, k, x)).astype(np.float32))
        want = np.einsum("gakf,gakx->gaxf", h.double().numpy(), tc.double().numpy())
        np.testing.assert_allclose(pooled_m_plain(h, tc).numpy(), want, rtol=1e-5, atol=1e-6)
        dh, dtc = pooled_m_bwd_plain(h, tc, torch.ones(2, 3, x, f))
        assert dh.shape == h.shape and dtc.shape == tc.shape


def test_wrapper_refuses_what_the_kernels_do_not_take():
    h, tc = torch.zeros(2, 3, 4, 8), torch.zeros(2, 3, 4, 5)
    with pytest.raises(ValueError, match="unsupported device"):
        pooled_m(h.to("meta"), tc.to("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        pooled_m_bwd(h, tc, torch.zeros(2, 3, 5, 8))  # kernel M only on the card
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        pooled_m(h.half(), tc.half())
    with pytest.raises(TypeError, match="tc is torch.bfloat16"):
        pooled_m(h, tc.bfloat16())
    with pytest.raises(ValueError, match="takes h"):
        pooled_m(h[0], tc[0])
    with pytest.raises(ValueError, match="tc must be"):
        pooled_m(h, torch.zeros(2, 3, 5, 5))
    with pytest.raises(ValueError, match="contiguous tc"):
        pooled_m(h, torch.zeros(2, 3, 5, 4).transpose(-1, -2))
    assert pooled_m.launches == pooled_m_bwd.launches == 0  # the CPU path launches nothing
