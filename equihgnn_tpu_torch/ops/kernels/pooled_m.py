"""Kernels L and M: the pooled-M build of the SE(3)-Transformer's per-J
pooled ConvSE3 path, forward and backward (`csrc/pooled_m.cu`).

Replaces `equihgnn_tpu/ops/pallas/pooled_m.py` `pooled_m`: the forward
`_pm_fwd` (kernel L) and its custom VJP `_pm_bwd` (kernel M):

    M[g, a, x, f]  = Σ_k h[g, a, k, f] · tc[g, a, k, x]
    dh[g, a, k, f] = Σ_x tc[g, a, k, x] · dM[g, a, x, f]
    dtc[g, a, k, x] = Σ_f h[g, a, k, f] · dM[g, a, x, f]

h [G, A, K, F] and tc [G, A, K, X] are bf16 or f32, both of one type; M and
the gradients come out in that type, summed in f32 and rounded once, as
JAX's dots with `preferred_element_type=f32` and their `astype`. L and M
in bf16 (the model's path) run in persistent blocks that stream the sites
through a cp.async ring and sum the exact f32 products in order, as the
plain version does (the tensor cores' truncated sums missed L's gate: see
`csrc/pooled_m.cu`); M reads dM only at the sites whose h or tc is not all
±0, and writes +0 at the others (the plain version's value for a finite
dM). JAX's
VMEM gate (`pooled_m_supported`) is not ported: the kernels take any A and
any K ≥ 0 (K = 0 gives zeros), and the C entry refuses a shape whose site
does not fit a block's shared memory, on which the wrapper raises.

`pooled_m` is the wrapper. A CPU tensor goes to the plain version
(`pooled_m_plain`), which autograd traces: its backward is the two f32
dots of `pooled_m_bwd_plain`, each rounded once to the input's type. A CUDA tensor goes through
`_PooledM`, an `autograd.Function` whose forward is kernel L and whose
backward is kernel M (`pooled_m_bwd`); like JAX's custom VJP it saves only
(h, tc). Any other device, type, rank, shape or a non-contiguous operand
raises. `.launches` on `pooled_m` and `pooled_m_bwd` counts calls of the
C entries.
"""

from __future__ import annotations

import torch

from equihgnn_tpu_torch.ops.kernels import build

DTYPES = {torch.bfloat16: "bf16", torch.float32: "f32"}


# ------------------------------------------------------------ plain versions


def pooled_m_plain(h, tc):
    """`_ref` of `tests/test_pooled_m.py` (the einsum over k in f32),
    returned in h's type as `_fwd_kernel` emits it."""
    m = torch.einsum("gakf,gakx->gaxf", h.float(), tc.float())
    return m.to(h.dtype)


def pooled_m_bwd_plain(h, tc, dm):
    """(dh, dtc) of `_bwd_kernel`: the two dots in f32, each rounded once to
    its input's type."""
    dmf = dm.float()
    dh = torch.einsum("gakx,gaxf->gakf", tc.float(), dmf).to(h.dtype)
    dtc = torch.einsum("gakf,gaxf->gakx", h.float(), dmf).to(tc.dtype)
    return dh, dtc


# ----------------------------------------------------------------- checks


def _check(h, tc, dm=None):
    if h.ndim != 4 or tc.ndim != 4:
        raise ValueError(f"pooled_m takes h [G, A, K, F] and tc [G, A, K, X]; "
                         f"got {tuple(h.shape)}, {tuple(tc.shape)}")
    g, a, k, f = h.shape
    x = tc.shape[-1]
    if h.dtype not in DTYPES:
        raise TypeError(f"pooled_m takes bfloat16 or float32, got {h.dtype}")
    want = {"h": (g, a, k, f), "tc": (g, a, k, x), "dm": (g, a, x, f)}
    for name, t in (("h", h), ("tc", tc), ("dm", dm)):
        if t is None:
            continue
        if t.dtype != h.dtype:
            raise TypeError(f"pooled_m: {name} is {t.dtype}, h is {h.dtype}")
        if t.device != h.device:
            raise ValueError(f"{name} lies on {t.device}, h on {h.device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {list(want[name])}, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"pooled_m kernel takes a contiguous {name}")
    return g * a, k, f, x


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda_only(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


# --------------------------------------------------------------- kernels


def _launch_fwd(h, tc):
    s, k, f, x = _check(h, tc)
    out = torch.empty(h.shape[:2] + (x, f), dtype=h.dtype, device=h.device)
    lib = build.library()
    name = f"pooled_m_fwd_{DTYPES[h.dtype]}"
    with torch.cuda.device(h.device):
        code = getattr(lib, name)(h.data_ptr(), tc.data_ptr(), out.data_ptr(), s, k, f, x,
                                  _stream(h))
    build.check(lib, f"{name} at K = {k}, F = {f}, X = {x}", code)
    pooled_m.launches += 1
    return out


def pooled_m_bwd(h, tc, dm):
    """Kernel M: (dh, dtc) for the gradient `dm` [G, A, X, F] of M, on CUDA
    tensors only (`pooled_m_bwd_plain` is the same backward)."""
    _cuda_only("pooled_m_bwd", h)
    s, k, f, x = _check(h, tc, dm)
    dh, dtc = torch.empty_like(h), torch.empty_like(tc)
    lib = build.library()
    name = f"pooled_m_bwd_{DTYPES[h.dtype]}"
    with torch.cuda.device(h.device):
        code = getattr(lib, name)(h.data_ptr(), tc.data_ptr(), dm.data_ptr(), dh.data_ptr(),
                                  dtc.data_ptr(), s, k, f, x, _stream(h))
    build.check(lib, f"{name} at K = {k}, F = {f}, X = {x}", code)
    pooled_m_bwd.launches += 1
    return dh, dtc


class _PooledM(torch.autograd.Function):
    """Kernel L forward, kernel M backward (JAX `_pooled_m`'s custom VJP)."""

    @staticmethod
    def forward(ctx, h, tc):
        ctx.save_for_backward(h, tc)
        return _launch_fwd(h, tc)

    @staticmethod
    def backward(ctx, dm):
        return pooled_m_bwd(*ctx.saved_tensors, dm.contiguous())


def pooled_m(h, tc):
    """M[g, a, x, f] = Σ_k h[g, a, k, f] · tc[g, a, k, x], in h's type."""
    if h.device.type == "cpu":
        _check(h, tc)
        return pooled_m_plain(h, tc)
    _cuda_only("pooled_m", h)
    return _PooledM.apply(h, tc)


pooled_m.launches = 0
pooled_m_bwd.launches = 0
