"""Kernels F-I: ViSNet's vector mix, forward and backward (`csrc/vis_mix.cu`).

Replaces `equihgnn_tpu/ops/pallas/vis_mix.py` `vis_vector_mix`: the vector
aggregation `_vec_agg_fwd` (kernel F) with its custom VJP `_vec_agg_bwd`
(kernel G), and the vector-rejection dot products `_wdot_fwd` (kernel H)
with `_wdot_bwd` (kernel I):

    vec_agg[g, i, l] = Σ_k m·s1[g, i, k]·vec[g, j, l] + Σ_k s2m[g, i, k]·d[g, i, k, l]
    w_dot[g, i, k]   = Σ_l u[g, i, l]·vvj_l − (Σ_l u[g, i, l]·d_l)(Σ_l d_l·vvj_l)(2 − Σ_l d_l²)

with j = nbr_idx[g, i, k], m = nbr_mask[g, i, k], vvj_l = m·vv[g, j, l] and
d_l = d[g, i, k, l]; every product runs over the h columns elementwise.
This is the function of JAX's `_xla_mix` (`vis_mix.py:306-333`), the
composition the JAX f32 model runs: the JAX kernels serve only its bf16
path, a gate that was a TPU workaround and is not ported.

Layouts are JAX's: vec, u, vv [G, A, L, h] (L = 3 or 8); s1, s2m
[G, A, k, h], s2m already masked by the caller; d [G, A, k, L]; nbr_idx
[G, A, k] int64 slot indices into the A axis; nbr_mask [G, A, k] bool.
`s1` may be a strided view: ViS_MP splits it from the [.., 2h] s_proj
output, and the kernels read it with its row stride rather than have the
wrapper copy 428 MB a layer at batch 768. Every other tensor is
contiguous, or the wrapper raises.

`vis_vec_agg` and `vis_wdot` are the wrappers. A CPU tensor goes to the
plain version (`vec_agg_plain`, `wdot_plain`), which autograd traces. A
CUDA tensor goes through `_VecAgg` / `_WDot`, `autograd.Function`s whose
forwards are kernels F / H and whose backwards are kernels G / I
(`vis_vec_agg_bwd`, `vis_wdot_bwd`); like JAX's custom VJPs they save only
their inputs. `d` gets a gradient from both (autograd adds them);
nbr_idx and nbr_mask get none. Any other device, type, shape or stride
raises, and so does a slot axis A whose row does not fit a block of F or H
(its shared memory; at L = 8, k = 17: A ≤ 142): the C entries refuse it,
G's and I's too, and the wrapper raises RuntimeError. H writes +0 at a
masked edge without reading d or vv (the plain version's value for finite
u and d). G and I run a row's
h / 32 chunks as a thread-block cluster and sum dd over its shared memory;
up to A = 70 (G) and 97 (I) at L = 8, k = 17 they stage the gathered
chunks in shared memory, above that they gather from device memory.
Contract: every index lies in [0, A), as `knn_dense` gives them (the
kernels treat one outside as masked; checking would cost a sync).
`.launches` on each of the four wrappers counts kernel launches.
"""

from __future__ import annotations

import torch

from equihgnn_tpu_torch.ops.gather import nbr_gather
from equihgnn_tpu_torch.ops.kernels import build

KERNEL_L = (3, 8)  # the kernels' L (csrc template instances)


# ------------------------------------------------------------ plain versions


def vec_agg_plain(vec, s1, s2m, d, nbr_idx, nbr_mask):
    """`_xla_mix`'s vec_agg with index gathers, one [G, A, k, h] gather per
    l (the TPU's one-hot matmuls are not ported)."""
    agg = torch.stack([torch.sum(s1 * nbr_gather(vec[:, :, l], nbr_idx, nbr_mask), dim=2)
                       for l in range(vec.shape[2])], dim=2)
    return agg + torch.einsum("gikh,gikl->gilh", s2m, d)


def wdot_plain(d, u, vv, nbr_idx, nbr_mask):
    """`_xla_mix`'s w_dot: u·vv_j − (u·d)(vv_j·d)(2 − |d|²) per edge."""
    uv = vd = 0.0
    for l in range(u.shape[2]):
        vvk = nbr_gather(vv[:, :, l], nbr_idx, nbr_mask)  # [G, A, k, h]
        uv = uv + u[:, :, None, l, :] * vvk
        vd = vd + d[..., l, None] * vvk
    ud = torch.einsum("gilh,gikl->gikh", u, d)
    dd = torch.sum(d * d, dim=-1)[..., None]
    return uv - ud * vd * (2.0 - dd)


def vec_agg_bwd_plain(vec, s1, s2m, d, nbr_idx, nbr_mask, gva):
    """(dvec, ds1, ds2m, dd): autograd through `vec_agg_plain` for `gva`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (vec, s1, s2m, d)]
        out = vec_agg_plain(*leaves, nbr_idx, nbr_mask)
        return torch.autograd.grad(out, leaves, gva)


def wdot_bwd_plain(d, u, vv, nbr_idx, nbr_mask, gw):
    """(dd, du, dvv): autograd through `wdot_plain` for `gw`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (d, u, vv)]
        out = wdot_plain(*leaves, nbr_idx, nbr_mask)
        return torch.autograd.grad(out, leaves, gw)


# ----------------------------------------------------------------- checks


def _s1_stride(s1: torch.Tensor) -> int:
    """Elements between consecutive [h] rows of s1 [G, A, k, h], which must
    be evenly spaced with unit column stride."""
    g, a, k, h = s1.shape
    r = s1.stride(2)
    if s1.stride(3) != 1 or r < h or s1.stride(1) != k * r or s1.stride(0) != a * k * r:
        raise ValueError(
            f"vis_mix kernels take s1 [G, A, k, h] with evenly strided rows, got strides "
            f"{s1.stride()} for shape {tuple(s1.shape)}"
        )
    return r


def _check(named, nbr_idx, nbr_mask, rows, edges, grad=None):
    """`named`: the float tensors, `rows` the names of the [G, A, L, h] ones,
    `edges` of the [G, A, k, h] ones; d is always [G, A, k, L]."""
    ref = named[rows[0]]
    if ref.ndim != 4:
        raise ValueError(f"{rows[0]} must be [G, A, L, h], got {tuple(ref.shape)}")
    g, a, L, h = ref.shape
    k = nbr_idx.shape[-1] if nbr_idx.ndim == 3 else -1
    if L not in KERNEL_L:
        raise ValueError(f"vis_mix kernels take L in {KERNEL_L}, got {L}")
    for name, t in dict(named, grad=grad).items():
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"vis_mix kernel takes float32 {name}, got {t.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name} lies on {t.device}, {rows[0]} on {ref.device}")
        want = ((g, a, L, h) if name in rows else (g, a, k, h) if name in edges
                else (g, a, k, L))
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got {tuple(t.shape)}")
        if name != "s1" and not t.is_contiguous():
            raise ValueError(f"vis_mix kernel takes a contiguous {name}")
    if nbr_idx.dtype != torch.int64 or nbr_mask.dtype != torch.bool:
        raise TypeError(f"nbr_idx int64 and nbr_mask bool, got {nbr_idx.dtype}, {nbr_mask.dtype}")
    for name, t in (("nbr_idx", nbr_idx), ("nbr_mask", nbr_mask)):
        if tuple(t.shape) != (g, a, k) or t.device != ref.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{g}, {a}, k] tensor on {ref.device}")
    return g, a, k, L, h


def _done(lib, name, code, a, k, L):
    """Raise on a CUDA error of the C entry `name`; a row that a block of F
    or H cannot stage (it grows with A) is refused there, by all four."""
    build.check(lib, f"{name} at A = {a}, k = {k}, L = {L}", code)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda_only(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


# --------------------------------------------------------------- kernels


def _launch_agg(vec, s1, s2m, d, nbr_idx, nbr_mask):
    g, a, k, L, h = _check(dict(vec=vec, s1=s1, s2m=s2m, d=d), nbr_idx, nbr_mask,
                           ("vec",), ("s1", "s2m"))
    stride = _s1_stride(s1)
    out = torch.empty_like(vec)
    lib = build.library()
    with torch.cuda.device(vec.device):
        code = lib.vis_vec_agg_fwd_f32(
            vec.data_ptr(), s1.data_ptr(), stride, s2m.data_ptr(), d.data_ptr(),
            nbr_idx.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(), g, a, k, L, h, _stream(vec))
    _done(lib, "vis_vec_agg_fwd_f32", code, a, k, L)
    vis_vec_agg.launches += 1
    return out


def vis_vec_agg_bwd(vec, s1, s2m, d, nbr_idx, nbr_mask, gva):
    """Kernel G: (dvec, ds1, ds2m, dd) for the output gradient `gva`
    [G, A, L, h], on CUDA tensors only (on the CPU autograd differentiates
    `vec_agg_plain`; `vec_agg_bwd_plain` is the same backward)."""
    _cuda_only("vis_vec_agg_bwd", vec)
    g, a, k, L, h = _check(dict(vec=vec, s1=s1, s2m=s2m, d=d), nbr_idx, nbr_mask,
                           ("vec", "grad"), ("s1", "s2m"), grad=gva)
    stride = _s1_stride(s1)
    opts = dict(dtype=torch.float32, device=vec.device)
    dvec = torch.empty((g, a, L, h), **opts)
    ds1, ds2m = torch.empty((g, a, k, h), **opts), torch.empty((g, a, k, h), **opts)
    dd = torch.empty((g, a, k, L), **opts)
    lib = build.library()
    with torch.cuda.device(vec.device):
        code = lib.vis_vec_agg_bwd_f32(
            vec.data_ptr(), s1.data_ptr(), stride, s2m.data_ptr(), d.data_ptr(),
            nbr_idx.data_ptr(), nbr_mask.data_ptr(), gva.data_ptr(), dvec.data_ptr(),
            ds1.data_ptr(), ds2m.data_ptr(), dd.data_ptr(), g, a, k, L, h, _stream(vec))
    _done(lib, "vis_vec_agg_bwd_f32", code, a, k, L)
    vis_vec_agg_bwd.launches += 1
    return dvec, ds1, ds2m, dd


def _launch_wdot(d, u, vv, nbr_idx, nbr_mask):
    g, a, k, L, h = _check(dict(u=u, vv=vv, d=d), nbr_idx, nbr_mask, ("u", "vv"), ())
    out = torch.empty((g, a, k, h), dtype=torch.float32, device=u.device)
    lib = build.library()
    with torch.cuda.device(u.device):
        code = lib.vis_wdot_fwd_f32(
            d.data_ptr(), u.data_ptr(), vv.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(),
            out.data_ptr(), g, a, k, L, h, _stream(u))
    _done(lib, "vis_wdot_fwd_f32", code, a, k, L)
    vis_wdot.launches += 1
    return out


def vis_wdot_bwd(d, u, vv, nbr_idx, nbr_mask, gw):
    """Kernel I: (dd, du, dvv) for the output gradient `gw` [G, A, k, h],
    on CUDA tensors only (`wdot_bwd_plain` is the same backward)."""
    _cuda_only("vis_wdot_bwd", u)
    g, a, k, L, h = _check(dict(u=u, vv=vv, d=d), nbr_idx, nbr_mask, ("u", "vv"),
                           ("grad",), grad=gw)
    opts = dict(dtype=torch.float32, device=u.device)
    du, dvv = torch.empty((g, a, L, h), **opts), torch.empty((g, a, L, h), **opts)
    dd = torch.empty((g, a, k, L), **opts)
    lib = build.library()
    with torch.cuda.device(u.device):
        code = lib.vis_wdot_bwd_f32(
            d.data_ptr(), u.data_ptr(), vv.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(),
            gw.data_ptr(), du.data_ptr(), dvv.data_ptr(), dd.data_ptr(), g, a, k, L, h,
            _stream(u))
    _done(lib, "vis_wdot_bwd_f32", code, a, k, L)
    vis_wdot_bwd.launches += 1
    return dd, du, dvv


class _VecAgg(torch.autograd.Function):
    """Kernel F forward, kernel G backward (JAX `_vec_agg`'s custom VJP)."""

    @staticmethod
    def forward(ctx, vec, s1, s2m, d, nbr_idx, nbr_mask):
        ctx.save_for_backward(vec, s1, s2m, d, nbr_idx, nbr_mask)
        return _launch_agg(vec, s1, s2m, d, nbr_idx, nbr_mask)

    @staticmethod
    def backward(ctx, gva):
        dvec, ds1, ds2m, dd = vis_vec_agg_bwd(*ctx.saved_tensors, gva.contiguous())
        return dvec, ds1, ds2m, dd, None, None


class _WDot(torch.autograd.Function):
    """Kernel H forward, kernel I backward (JAX `_wdot`'s custom VJP)."""

    @staticmethod
    def forward(ctx, d, u, vv, nbr_idx, nbr_mask):
        ctx.save_for_backward(d, u, vv, nbr_idx, nbr_mask)
        return _launch_wdot(d, u, vv, nbr_idx, nbr_mask)

    @staticmethod
    def backward(ctx, gw):
        dd, du, dvv = vis_wdot_bwd(*ctx.saved_tensors, gw.contiguous())
        return dd, du, dvv, None, None


def vis_vec_agg(vec, s1, s2m, d, nbr_idx, nbr_mask):
    """Σ_k s1·vec[j] (masked) + Σ_k s2m·d → [G, A, L, h]."""
    if vec.device.type == "cpu":
        return vec_agg_plain(vec, s1, s2m, d, nbr_idx, nbr_mask)
    _cuda_only("vis_vec_agg", vec)
    return _VecAgg.apply(vec, s1, s2m, d, nbr_idx, nbr_mask)


def vis_wdot(d, u, vv, nbr_idx, nbr_mask):
    """u·vv_j − (u·d)(vv_j·d)(2 − |d|²) per edge (vv_j masked) → [G, A, k, h]."""
    if u.device.type == "cpu":
        return wdot_plain(d, u, vv, nbr_idx, nbr_mask)
    _cuda_only("vis_wdot", u)
    return _WDot.apply(d, u, vv, nbr_idx, nbr_mask)


vis_vec_agg.launches = 0
vis_vec_agg_bwd.launches = 0
vis_wdot.launches = 0
vis_wdot_bwd.launches = 0
