"""Kernels D and E: FAFormer's frame-averaged SwiGLU, forward and backward
(`csrc/frame_swiglu.cu`).

Replaces `equihgnn_tpu/ops/pallas/frame_swiglu.py` `fused_frame_swiglu`:
its forward `_vjp_fwd`/`_fwd_kernel` (kernel D) and its custom VJP
`_vjp_bwd`/`_bwd_kernel` (kernel E):

    out = mean_o LN(drop(silu(pre_o[:, :H/2]) · pre_o[:, H/2:]))·γ + β,
    pre_o = (s_o ⊙ x[:, :3] ‖ x[:, 3:]) @ w1 + b1,

over the 8 sign rows s_o of `SIGN_OPS`, for x [P, C] (columns 0..2 the
unsigned frame projection, 3.. frame-invariant), w1 [C, H], b1 [H] and the
LayerNorm's γ, β [H/2] → [P, H/2].

`fused_frame_swiglu` is the wrapper. A CPU tensor goes to
`frame_swiglu_plain`, which materializes the [P, 8, H] frames with the sign
table (as JAX's non-fused branch, `nn/faformer.py:273-283`) and which
autograd traces. A CUDA tensor goes through `_FusedFrameSwiGLU`, an
`autograd.Function` whose forward is kernel D and whose backward is kernel E
(`fused_frame_swiglu_bwd`); like JAX's `_vjp_fwd` it saves only its inputs,
and kernel E recomputes the chain. Kernel E skips, exactly, every position
whose row of dout is all 0 (FAFormer passes 0 at its masked neighbours and
padding slots) and writes dx = 0 there. Any other device raises, and so does a
shape the kernels do not take (float32, C ∈ {3, 4}, H/2 ∈ {32, 64, 128,
256}): there is no fallback to the materialized frames on the card.
`fused_frame_swiglu.launches` and `fused_frame_swiglu_bwd.launches` count
kernel launches.

Dropout departs from JAX by design. The TPU kernel draws its mask from the
TPU's PRNG seeded by (seed, tile id), which no other device reproduces.
Here value (p, o, j) is kept iff a counter-based hash of (seed, p,
o·H/2 + j) is at least round(rate·2³²), independent of the launch layout:
kernel E regenerates kernel D's mask from the seed, and `dropout_keep`
computes the same bits with integer tensor ops, so the card can hold the
kernels against the plain version bit for bit in the mask. The seed is
drawn per call by the caller (`nn/faformer.py`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from equihgnn_tpu_torch.ops.kernels import build

# the 2³ sign flips, in the order of `equihgnn_tpu/nn/faformer.py` `_SIGN_OPS`
SIGN_OPS = [(sx, sy, sz) for sx in (-1.0, 1.0) for sy in (-1.0, 1.0) for sz in (-1.0, 1.0)]
LN_EPS = 1e-5
KERNEL_C = (3, 4)  # the kernels' x widths (csrc template instances)
KERNEL_HH = (32, 64, 128, 256)  # and their H/2

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x·c) mod 2³² for x in [0, 2³²) (an int64 tensor or a Python int),
    without leaving int64: x = hi·2¹⁶ + lo."""
    return (((x & 0xFFFF) * c) + (((x >> 16) * (c & 0xFFFF)) << 16)) & _M32


def _fmix32(h):
    """murmur3's 32-bit finalizer (csrc `fmix32`)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def drop_consts(drop_rate: float) -> tuple[int, float]:
    """(thresh, inv_keep): keep iff hash ≥ thresh, P(keep) = 1 − rate on the
    uint32 lattice, as JAX's `_drop_consts`."""
    thresh = min(2**32 - 1, int(round(drop_rate * 2.0**32)))
    return thresh, float(np.float32(1.0 / (1.0 - drop_rate)))


def dropout_keep(seed: int, n_pos: int, hh: int, drop_rate: float,
                 device=None) -> torch.Tensor:
    """[P, 8, H/2] bool keep mask of the kernels' dropout for `seed`."""
    thresh, _ = drop_consts(drop_rate)
    s = _fmix32(int(seed) & _M32)
    p = torch.arange(n_pos, dtype=torch.int64, device=device)[:, None, None]
    c = torch.arange(8 * hh, dtype=torch.int64, device=device).view(1, 8, hh)
    h = _fmix32(_fmix32(p ^ s) ^ ((_mul32(c, 0x9E3779B9) + s) & _M32))
    return h >= thresh


def frame_swiglu_plain(x, w1, b1, ls, lb, drop_rate: float = 0.0, seed: int = 0):
    """The same function in plain PyTorch: materializes [P, 8, H]."""
    p, c = x.shape
    hh = w1.shape[1] // 2
    sgn = torch.cat([torch.tensor(SIGN_OPS, dtype=x.dtype, device=x.device),
                     torch.ones(8, c - 3, dtype=x.dtype, device=x.device)], dim=-1)
    h = torch.matmul(x[:, None, :] * sgn, w1) + b1  # [P, 8, H]
    y = F.silu(h[..., :hh]) * h[..., hh:]
    if drop_rate > 0.0:
        _, inv_keep = drop_consts(drop_rate)
        keep = dropout_keep(seed, p, hh, drop_rate, x.device)
        y = torch.where(keep, y * inv_keep, torch.zeros((), dtype=y.dtype, device=y.device))
    y = F.layer_norm(y, (hh,), ls, lb, eps=LN_EPS)
    return y.mean(dim=1)


def frame_swiglu_bwd_plain(x, w1, b1, ls, lb, dout, drop_rate: float = 0.0, seed: int = 0):
    """(dx, dw1, db1, dls, dlb): autograd through `frame_swiglu_plain` for
    the output gradient `dout`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (x, w1, b1, ls, lb)]
        out = frame_swiglu_plain(*leaves, drop_rate=drop_rate, seed=seed)
        return torch.autograd.grad(out, leaves, dout)


def _check(x, w1, b1, ls, lb, dout=None):
    named = dict(x=x, w1=w1, b1=b1, ls=ls, lb=lb)
    if dout is not None:
        named["dout"] = dout
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"frame_swiglu kernel takes float32 {name}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} lies on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"frame_swiglu kernel takes a contiguous {name}")
    if x.ndim != 2 or w1.ndim != 2:
        raise ValueError(f"x [P, C] and w1 [C, H], got {tuple(x.shape)}, {tuple(w1.shape)}")
    p, c = x.shape
    h = w1.shape[1]
    if c not in KERNEL_C or w1.shape[0] != c or h % 2 or h // 2 not in KERNEL_HH:
        raise ValueError(
            f"frame_swiglu kernel takes C in {KERNEL_C} and H/2 in {KERNEL_HH}; got "
            f"x {tuple(x.shape)}, w1 {tuple(w1.shape)}"
        )
    if b1.shape != (h,) or ls.shape != (h // 2,) or lb.shape != (h // 2,):
        raise ValueError(f"b1 [{h}], ls/lb [{h // 2}]; got {tuple(b1.shape)}, "
                         f"{tuple(ls.shape)}, {tuple(lb.shape)}")
    if p >= 2**31:
        raise ValueError(f"P = {p} positions: the dropout hash indexes them in 32 bits")
    if dout is not None and dout.shape != (p, h // 2):
        raise ValueError(f"dout must be [{p}, {h // 2}], got {tuple(dout.shape)}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _drop_args(drop_rate: float, seed: int):
    if drop_rate <= 0.0:
        return 0, 0, 1.0, 0
    thresh, inv_keep = drop_consts(drop_rate)
    return 1, thresh, inv_keep, int(seed) & _M32


def _launch_fwd(x, w1, b1, ls, lb, drop_rate, seed):
    p, c = x.shape
    h = w1.shape[1]
    out = torch.empty((p, h // 2), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.frame_swiglu_fwd_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), ls.data_ptr(), lb.data_ptr(),
            out.data_ptr(), p, c, h, *_drop_args(drop_rate, seed), _stream(x),
        )
    build.check(lib, "frame_swiglu_fwd_f32", code)
    fused_frame_swiglu.launches += 1
    return out


def fused_frame_swiglu_bwd(x, w1, b1, ls, lb, dout, drop_rate: float = 0.0, seed: int = 0):
    """Kernel E: (dx, dw1, db1, dls, dlb) for the output gradient `dout`
    [P, H/2], on CUDA tensors only (on the CPU autograd differentiates
    `frame_swiglu_plain`; `frame_swiglu_bwd_plain` is the same backward).
    `drop_rate` and `seed` must be the forward's."""
    if x.device.type != "cuda":
        raise ValueError(f"fused_frame_swiglu_bwd: unsupported device {x.device}")
    _check(x, w1, b1, ls, lb, dout)
    p, c = x.shape
    h = w1.shape[1]
    lib = build.library()
    floats = ctypes.c_int64()
    with torch.cuda.device(x.device):
        code = lib.frame_swiglu_bwd_workspace_f32(p, c, h, ctypes.byref(floats))
    build.check(lib, "frame_swiglu_bwd_workspace_f32", code)
    opts = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((p, c), **opts)
    dparams = torch.empty(c * h + 2 * h, **opts)
    ws = torch.empty(floats.value, **opts)
    with torch.cuda.device(x.device):
        code = lib.frame_swiglu_bwd_f32(
            x.data_ptr(), w1.data_ptr(), b1.data_ptr(), ls.data_ptr(), dout.data_ptr(),
            dx.data_ptr(), dparams.data_ptr(), ws.data_ptr(), p, c, h,
            *_drop_args(drop_rate, seed), _stream(x),
        )
    build.check(lib, "frame_swiglu_bwd_f32", code)
    fused_frame_swiglu_bwd.launches += 1
    dw1, db1, dls, dlb = torch.split(dparams, [c * h, h, h // 2, h // 2])
    return dx, dw1.view(c, h), db1, dls, dlb


class _FusedFrameSwiGLU(torch.autograd.Function):
    """Kernel D forward, kernel E backward (JAX `_fused`'s custom VJP)."""

    @staticmethod
    def forward(ctx, x, w1, b1, ls, lb, drop_rate, seed):
        ctx.save_for_backward(x, w1, b1, ls, lb)
        ctx.drop = (drop_rate, seed)
        return _launch_fwd(x, w1, b1, ls, lb, drop_rate, seed)

    @staticmethod
    def backward(ctx, dout):
        grads = fused_frame_swiglu_bwd(*ctx.saved_tensors, dout.contiguous(), *ctx.drop)
        return (*grads, None, None)


def fused_frame_swiglu(x, w1, b1, ls, lb, *, drop_rate: float = 0.0, seed: int = 0):
    """mean_o LN(dropout(swiglu((s_o ⊙ x[:, :3] ‖ x[:, 3:]) @ w1 + b1)))·γ + β
    → [P, H/2]. `seed` picks the dropout mask when `drop_rate` > 0."""
    if x.device.type == "cpu":
        return frame_swiglu_plain(x, w1, b1, ls, lb, drop_rate, seed)
    if x.device.type != "cuda":
        raise ValueError(f"fused_frame_swiglu: unsupported device {x.device}")
    _check(x, w1, b1, ls, lb)
    return _FusedFrameSwiGLU.apply(x, w1, b1, ls, lb, float(drop_rate), int(seed))


fused_frame_swiglu.launches = 0
fused_frame_swiglu_bwd.launches = 0
