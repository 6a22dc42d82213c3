"""Port's fused EGNN edge messages vs the JAX Pallas kernel.

On the CPU the port's wrapper takes its plain PyTorch version; the JAX
side runs `fused_edge_messages` through Pallas interpret mode. Identical
inputs (numpy seed), weights at O(0.1) so that a wrong gather cannot hide
behind silu(b1). Tolerance atol 1e-5, rtol 1e-5: an F-term f32 sum taken
in another order. The CUDA kernel itself is compared with the plain
version on the card (chip_smoke.py, tests/test_torch_kernels_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equihgnn_tpu.ops.pallas.edge_mlp import fused_edge_messages as jax_fused_edge_messages
from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
    _check,
    fused_edge_messages,
    fused_edge_messages_plain,
)

torch.set_num_threads(1)


def _inputs(g=3, a=8, k=5, f=34, m=16, seed=0):
    rng = np.random.default_rng(seed)
    return (
        rng.standard_normal((g, a, f)).astype(np.float32),  # ui
        rng.standard_normal((g, a, f)).astype(np.float32),  # ujn
        (rng.random((g, a, k)) * 4.0).astype(np.float32),  # dist
        rng.integers(0, a, (g, a, k)).astype(np.int64),  # nbr_idx
        (rng.standard_normal(f) * 0.1).astype(np.float32),  # wd
        (rng.standard_normal(f) * 0.1).astype(np.float32),  # b0
        (rng.standard_normal((f, m)) * 0.1).astype(np.float32),  # w1
        (rng.standard_normal(m) * 0.1).astype(np.float32),  # b1
    )


@pytest.mark.parametrize(
    "shape",
    [
        dict(g=3, a=8, k=5, f=34, m=16),  # k not a multiple of 4, F not of 32
        dict(g=2, a=32, k=16, f=66, m=16),  # the model's k and m at hidden 16
        dict(g=2, a=6, k=4, f=10, m=6),  # another m (plain version only)
    ],
)
def test_plain_matches_jax_pallas(shape):
    args = _inputs(**shape)
    got = fused_edge_messages(*map(torch.from_numpy, args)).numpy()
    jargs = [jnp.asarray(x) for x in args]
    jargs[3] = jargs[3].astype(jnp.int32)
    want = np.asarray(jax_fused_edge_messages(*jargs))
    assert got.shape == want.shape == (shape["g"], shape["a"], shape["k"], shape["m"])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_cpu_wrapper_leaves_launch_counter_at_zero():
    fused_edge_messages.launches = 0
    args = tuple(map(torch.from_numpy, _inputs(seed=1)))
    got = fused_edge_messages(*args)
    assert torch.equal(got, fused_edge_messages_plain(*args))
    assert fused_edge_messages.launches == 0


def test_wrapper_rejects_other_devices():
    args = [torch.from_numpy(x).to("meta") for x in _inputs(seed=2)]
    with pytest.raises(ValueError, match="unsupported device"):
        fused_edge_messages(*args)


def _bad(case):
    ui, ujn, dist, idx, wd, b0, w1, b1 = map(torch.from_numpy, _inputs(seed=3))
    if case == "f64":
        ui = ui.double()
    elif case == "int32_idx":
        idx = idx.int()
    elif case == "m6":
        w1, b1 = w1[:, :6].contiguous(), b1[:6]
    elif case == "strided":
        ujn = ujn.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "dist_shape":
        dist = dist[..., :2]
    return ui, ujn, dist, idx, wd, b0, w1, b1


@pytest.mark.parametrize(
    "case,exc",
    [("f64", TypeError), ("int32_idx", TypeError), ("m6", ValueError),
     ("strided", ValueError), ("dist_shape", ValueError)],
)
def test_kernel_argument_checks(case, exc):
    """What the CUDA kernel does not take raises before any launch."""
    _check(*_inputs_as_torch())  # well-formed arguments pass
    with pytest.raises(exc):
        _check(*_bad(case))


def _inputs_as_torch():
    return tuple(map(torch.from_numpy, _inputs(seed=3)))
