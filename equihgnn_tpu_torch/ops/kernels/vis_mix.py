"""Kernels F-I: ViSNet's vector mix, forward and backward (`csrc/vis_mix.cu`).

Replaces `equihgnn_tpu/ops/pallas/vis_mix.py` `vis_vector_mix`: the vector
aggregation `_vec_agg_fwd` (kernel F) with its custom VJP `_vec_agg_bwd`
(kernel G), and the vector-rejection dot products `_wdot_fwd` (kernel H)
with `_wdot_bwd` (kernel I):

    vec_agg[g, i, l] = Σ_k m·s1[g, i, k]·vec[g, j, l] + Σ_k s2m[g, i, k]·d[g, i, k, l]
    w_dot[g, i, k]   = Σ_l u[g, i, l]·vvj_l − (Σ_l u[g, i, l]·d_l)(Σ_l d_l·vvj_l)(2 − Σ_l d_l²)

with j = nbr_idx[g, i, k], m = nbr_mask[g, i, k], vvj_l = m·vv[g, j, l] and
d_l = d[g, i, k, l]; every product runs over the h columns elementwise.

In float32 this is the function of JAX's `_xla_mix` (`vis_mix.py:306-333`),
the composition the JAX f32 model runs. In bfloat16 it is the function of
JAX's Pallas kernels, which JAX's ViSNet runs below f32
(`vis_mix_supported`, `vis_mix.py:287-290`, called at `nn/visnet.py:220`):
the inputs are read as bf16 and widened to f32, every product and sum is
f32, and each output is rounded once to bf16 (`:100-280`); in G and I the
per-edge terms of the transposed gather, dvecj = s1·gva[i] and dvvj =
gw·u[i] + dvd·d, are rounded to bf16 before their f32 sum over the edges
that share a source (the one-hot matmul's bf16 operand, `:165-166`,
`:260-261`), and dd is summed over all of h in f32 and rounded once
(`:486`, `:549`). The gate itself (A % 8, the h-block width, a VMEM
budget) is a TPU workaround and is not ported: in bf16 the port always
computes the kernels' function. At A % 8 ≠ 0, where JAX falls back to
`_xla_mix` in bf16, the port differs from JAX by rounding only; both
batchers round A up to a multiple of 8 (`atom_multiple=8`).

Layouts are JAX's: vec, u, vv [G, A, L, h] (L = 3 or 8); s1, s2m
[G, A, k, h], s2m already masked by the caller; d [G, A, k, L]; nbr_idx
[G, A, k] int64 slot indices into the A axis; nbr_mask [G, A, k] bool.
Every float tensor, and the output gradient, has one dtype, float32 or
bfloat16 (another mix raises TypeError). `s1` may be a strided view:
ViS_MP splits it from the [.., 2h] s_proj output, and the kernels read it
with its row stride rather than have the wrapper copy 428 MB a layer at
batch 768. Every other tensor is contiguous, or the wrapper raises.

`vis_vec_agg` and `vis_wdot` are the wrappers. A float32 CPU tensor goes
to the plain version (`vec_agg_plain`, `wdot_plain`), which autograd
traces. Any other goes through `_VecAgg` / `_WDot`, `autograd.Function`s
that save only their inputs, like JAX's custom VJPs: on the card their
forwards are kernels F / H and their backwards kernels G / I
(`vis_vec_agg_bwd`, `vis_wdot_bwd`), in either dtype; a bfloat16 CPU
tensor takes the plain versions of both (`vec_agg_bwd_plain`,
`wdot_bwd_plain` write out the bf16 backward's rounding, which autograd
through an f32 composition would not). `d` gets a gradient from both
(autograd adds them, in d's dtype, as JAX adds the two cotangents);
nbr_idx and nbr_mask get none. Any other device, type, shape or stride
raises, and so does a slot axis A whose row does not fit a block of F or H
(its shared memory; at L = 8, k = 17: A ≤ 142 in f32, A ≤ 170 in bf16):
the C entries refuse it, G's and I's too, and the wrapper raises
RuntimeError. The bf16 kernels take an even h (two columns a lane). H
writes +0 at a masked edge without reading d or vv (the plain version's
value for finite u and d). G and I run a row's column chunks as a
thread-block cluster and sum dd over its shared memory; at L = 8, k = 17
they stage the gathered chunks in shared memory up to A = 70 (G) and 97
(I) in f32, 77 and 109 in bf16, and gather from device memory above that;
I keeps a row's live gw rows in shared memory (in bf16 all of them up to A
= 30, 499 of 544 places at A = 32, none above A = 54).
Contract: every index lies in [0, A), as `knn_dense` gives them (the
kernels treat one outside as masked; checking would cost a sync).
`.launches` on each of the four wrappers counts kernel launches in either
dtype, `.launches_bf16` the bfloat16 ones.
"""

from __future__ import annotations

import torch

from equihgnn_tpu_torch.ops.gather import nbr_gather
from equihgnn_tpu_torch.ops.kernels import build

KERNEL_L = (3, 8)  # the kernels' L (csrc template instances)
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
_BF16 = torch.bfloat16


# ------------------------------------------------------------ plain versions


def _f32(*tensors):
    return [t.float() for t in tensors]


def _rounded(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and widened back: a term the kernels round."""
    return x.to(_BF16).float()


def _scatter_sources(terms: torch.Tensor, nbr_idx, nbr_mask) -> torch.Tensor:
    """[G, A, k, h] per-edge terms summed in f32 onto their source slots
    j = nbr_idx (masked edges dropped), in ascending edge order → [G, A, h]."""
    g, a, k = nbr_idx.shape
    rows = torch.arange(g, device=terms.device)[:, None, None] * a
    flat = (rows + nbr_idx).reshape(-1)
    terms = torch.where(nbr_mask[..., None], terms, torch.zeros((), device=terms.device))
    out = torch.zeros(g * a, terms.shape[-1], device=terms.device)
    return out.index_add_(0, flat, terms.reshape(g * a * k, -1)).view(g, a, -1)


def vec_agg_plain(vec, s1, s2m, d, nbr_idx, nbr_mask):
    """float32: `_xla_mix`'s vec_agg with index gathers, one [G, A, k, h]
    gather per l (the TPU's one-hot matmuls are not ported). bfloat16:
    kernel F's function, Σ_k (s1·vec[j] + s2m·d) in f32, k in order, rounded
    once (JAX's `_agg_fwd_kernel`)."""
    if vec.dtype == _BF16:
        vec, s1, s2m, d = _f32(vec, s1, s2m, d)
        acc = torch.zeros_like(vec)
        for kk in range(nbr_idx.shape[-1]):
            vecj = nbr_gather(vec, nbr_idx[:, :, kk:kk + 1], nbr_mask[:, :, kk:kk + 1])[:, :, 0]
            acc = acc + (s1[:, :, kk, None] * vecj + s2m[:, :, kk, None] * d[:, :, kk, :, None])
        return acc.to(_BF16)
    agg = torch.stack([torch.sum(s1 * nbr_gather(vec[:, :, l], nbr_idx, nbr_mask), dim=2)
                       for l in range(vec.shape[2])], dim=2)
    return agg + torch.einsum("gikh,gikl->gilh", s2m, d)


def wdot_plain(d, u, vv, nbr_idx, nbr_mask):
    """`_xla_mix`'s w_dot: u·vv_j − (u·d)(vv_j·d)(2 − |d|²) per edge. In
    bfloat16 the sums over l run in f32 in order, as JAX's
    `_wdot_fwd_kernel`, and w_dot is rounded once."""
    bf16 = u.dtype == _BF16
    if bf16:
        d, u, vv = _f32(d, u, vv)
    uv = vd = 0.0
    ud = dd = 0.0
    for l in range(u.shape[2]):
        vvk = nbr_gather(vv[:, :, l], nbr_idx, nbr_mask)  # [G, A, k, h]
        uv = uv + u[:, :, None, l, :] * vvk
        vd = vd + d[..., l, None] * vvk
        if bf16:
            ud = ud + u[:, :, None, l, :] * d[..., l, None]
            dd = dd + d[..., l, None] * d[..., l, None]
    if not bf16:
        ud = torch.einsum("gilh,gikl->gikh", u, d)
        dd = torch.sum(d * d, dim=-1)[..., None]
    w = uv - ud * vd * (2.0 - dd)
    return w.to(_BF16) if bf16 else w


def vec_agg_bwd_plain(vec, s1, s2m, d, nbr_idx, nbr_mask, gva):
    """(dvec, ds1, ds2m, dd) for `gva`. float32: autograd through
    `vec_agg_plain`. bfloat16: kernel G's function, JAX's `_agg_bwd_kernel`
    (see the module docstring)."""
    if vec.dtype != _BF16:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (vec, s1, s2m, d)]
            out = vec_agg_plain(*leaves, nbr_idx, nbr_mask)
            return torch.autograd.grad(out, leaves, gva)
    vec, s1, s2m, d, gva = _f32(vec, s1, s2m, d, gva)
    ds1 = ds2m = 0.0
    dvec, dd = torch.empty_like(vec), torch.empty_like(d)
    for l in range(vec.shape[2]):
        g_l = gva[:, :, None, l]  # [G, A, 1, h]
        vecj = nbr_gather(vec[:, :, l], nbr_idx, nbr_mask)
        ds1 = ds1 + vecj * g_l
        ds2m = ds2m + d[..., l, None] * g_l
        dvec[:, :, l] = _scatter_sources(_rounded(s1 * g_l), nbr_idx, nbr_mask)
        dd[..., l] = torch.sum(s2m * g_l, dim=-1)
    return dvec.to(_BF16), ds1.to(_BF16), ds2m.to(_BF16), dd.to(_BF16)


def wdot_bwd_plain(d, u, vv, nbr_idx, nbr_mask, gw):
    """(dd, du, dvv) for `gw`. float32: autograd through `wdot_plain`.
    bfloat16: kernel I's function, JAX's `_wdot_bwd_kernel` (see the
    module docstring)."""
    if u.dtype != _BF16:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (d, u, vv)]
            out = wdot_plain(*leaves, nbr_idx, nbr_mask)
            return torch.autograd.grad(out, leaves, gw)
    d, u, vv, gw = _f32(d, u, vv, gw)
    L = u.shape[2]
    vd = ud = dd = 0.0
    for l in range(L):  # JAX's pass 1: vd, ud and |d|² again
        d_l = d[..., l, None]
        vd = vd + d_l * nbr_gather(vv[:, :, l], nbr_idx, nbr_mask)
        ud = ud + u[:, :, None, l] * d_l
        dd = dd + d_l * d_l
    t = 2.0 - dd
    dud, dvd = -gw * vd * t, -gw * ud * t
    g_dd = torch.sum(gw * ud * vd, dim=-1)
    du, dvv, ddo = torch.empty_like(u), torch.empty_like(vv), torch.empty_like(d)
    for l in range(L):  # pass 2
        d_l, u_l = d[..., l, None], u[:, :, None, l]
        vvj = nbr_gather(vv[:, :, l], nbr_idx, nbr_mask)
        dvv[:, :, l] = _scatter_sources(_rounded(gw * u_l + dvd * d_l), nbr_idx, nbr_mask)
        du[:, :, l] = torch.sum(gw * vvj + dud * d_l, dim=2)
        ddo[..., l] = (torch.sum(dvd * vvj, dim=-1) + torch.sum(dud * u_l, dim=-1)
                       + 2.0 * d[..., l] * g_dd)
    return ddo.to(_BF16), du.to(_BF16), dvv.to(_BF16)


# ----------------------------------------------------------------- checks


def _one_dtype(named: dict) -> torch.dtype:
    """The float tensors' one dtype, float32 or bfloat16; TypeError else."""
    dtypes = {t.dtype for t in named.values() if t is not None}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _SUFFIX:
        raise TypeError("vis_mix takes float32 or bfloat16 " + ", ".join(named) + " of one "
                        "dtype, got " + ", ".join(f"{n} {t.dtype}" for n, t in named.items()
                                                  if t is not None))
    return next(iter(dtypes))


def _s1_stride(s1: torch.Tensor) -> int:
    """Elements between consecutive [h] rows of s1 [G, A, k, h], which must
    be evenly spaced with unit column stride (in bf16 an even spacing from
    a 4-byte aligned start: the kernels read column pairs)."""
    g, a, k, h = s1.shape
    r = s1.stride(2)
    bad_pairs = s1.dtype == _BF16 and (r % 2 or s1.data_ptr() % 4)
    if (s1.stride(3) != 1 or r < h or s1.stride(1) != k * r or s1.stride(0) != a * k * r
            or bad_pairs):
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
    dtype = _one_dtype(dict(named, grad=grad))
    if dtype == _BF16 and h % 2:
        raise ValueError(f"the bfloat16 vis_mix kernels take an even h, got {h}")
    for name, t in dict(named, grad=grad).items():
        if t is None:
            continue
        if t.device != ref.device:
            raise ValueError(f"{name} lies on {t.device}, {rows[0]} on {ref.device}")
        want = ((g, a, L, h) if name in rows else (g, a, k, h) if name in edges
                else (g, a, k, L))
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)}, got {tuple(t.shape)}")
        if name != "s1" and not t.is_contiguous():
            raise ValueError(f"vis_mix kernel takes a contiguous {name}")
        if dtype == _BF16 and t.data_ptr() % 4:
            raise ValueError(f"the bfloat16 vis_mix kernels take a 4-byte aligned {name}")
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


def _count(fn, dtype) -> None:
    fn.launches += 1
    fn.launches_bf16 += dtype == _BF16


# --------------------------------------------------------------- kernels


def _launch_agg(vec, s1, s2m, d, nbr_idx, nbr_mask):
    g, a, k, L, h = _check(dict(vec=vec, s1=s1, s2m=s2m, d=d), nbr_idx, nbr_mask,
                           ("vec",), ("s1", "s2m"))
    stride = _s1_stride(s1)
    out = torch.empty_like(vec)
    lib = build.library()
    name = f"vis_vec_agg_fwd_{_SUFFIX[vec.dtype]}"
    with torch.cuda.device(vec.device):
        code = getattr(lib, name)(
            vec.data_ptr(), s1.data_ptr(), stride, s2m.data_ptr(), d.data_ptr(),
            nbr_idx.data_ptr(), nbr_mask.data_ptr(), out.data_ptr(), g, a, k, L, h, _stream(vec))
    _done(lib, name, code, a, k, L)
    _count(vis_vec_agg, vec.dtype)
    return out


def vis_vec_agg_bwd(vec, s1, s2m, d, nbr_idx, nbr_mask, gva):
    """Kernel G: (dvec, ds1, ds2m, dd) for the output gradient `gva`
    [G, A, L, h], on CUDA tensors only, in the inputs' dtype
    (`vec_agg_bwd_plain` is the same backward)."""
    _cuda_only("vis_vec_agg_bwd", vec)
    g, a, k, L, h = _check(dict(vec=vec, s1=s1, s2m=s2m, d=d), nbr_idx, nbr_mask,
                           ("vec", "grad"), ("s1", "s2m"), grad=gva)
    stride = _s1_stride(s1)
    opts = dict(dtype=vec.dtype, device=vec.device)
    dvec = torch.empty((g, a, L, h), **opts)
    ds1, ds2m = torch.empty((g, a, k, h), **opts), torch.empty((g, a, k, h), **opts)
    dd = torch.empty((g, a, k, L), **opts)
    lib = build.library()
    name = f"vis_vec_agg_bwd_{_SUFFIX[vec.dtype]}"
    with torch.cuda.device(vec.device):
        code = getattr(lib, name)(
            vec.data_ptr(), s1.data_ptr(), stride, s2m.data_ptr(), d.data_ptr(),
            nbr_idx.data_ptr(), nbr_mask.data_ptr(), gva.data_ptr(), dvec.data_ptr(),
            ds1.data_ptr(), ds2m.data_ptr(), dd.data_ptr(), g, a, k, L, h, _stream(vec))
    _done(lib, name, code, a, k, L)
    _count(vis_vec_agg_bwd, vec.dtype)
    return dvec, ds1, ds2m, dd


def _launch_wdot(d, u, vv, nbr_idx, nbr_mask):
    g, a, k, L, h = _check(dict(u=u, vv=vv, d=d), nbr_idx, nbr_mask, ("u", "vv"), ())
    out = torch.empty((g, a, k, h), dtype=u.dtype, device=u.device)
    lib = build.library()
    name = f"vis_wdot_fwd_{_SUFFIX[u.dtype]}"
    with torch.cuda.device(u.device):
        code = getattr(lib, name)(
            d.data_ptr(), u.data_ptr(), vv.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(),
            out.data_ptr(), g, a, k, L, h, _stream(u))
    _done(lib, name, code, a, k, L)
    _count(vis_wdot, u.dtype)
    return out


def vis_wdot_bwd(d, u, vv, nbr_idx, nbr_mask, gw):
    """Kernel I: (dd, du, dvv) for the output gradient `gw` [G, A, k, h],
    on CUDA tensors only, in the inputs' dtype (`wdot_bwd_plain` is the
    same backward)."""
    _cuda_only("vis_wdot_bwd", u)
    g, a, k, L, h = _check(dict(u=u, vv=vv, d=d), nbr_idx, nbr_mask, ("u", "vv"),
                           ("grad",), grad=gw)
    opts = dict(dtype=u.dtype, device=u.device)
    du, dvv = torch.empty((g, a, L, h), **opts), torch.empty((g, a, L, h), **opts)
    dd = torch.empty((g, a, k, L), **opts)
    lib = build.library()
    name = f"vis_wdot_bwd_{_SUFFIX[u.dtype]}"
    with torch.cuda.device(u.device):
        code = getattr(lib, name)(
            d.data_ptr(), u.data_ptr(), vv.data_ptr(), nbr_idx.data_ptr(), nbr_mask.data_ptr(),
            gw.data_ptr(), du.data_ptr(), dvv.data_ptr(), dd.data_ptr(), g, a, k, L, h,
            _stream(u))
    _done(lib, name, code, a, k, L)
    _count(vis_wdot_bwd, u.dtype)
    return dd, du, dvv


class _VecAgg(torch.autograd.Function):
    """Kernel F forward, kernel G backward (JAX `_vec_agg`'s custom VJP); on
    a bfloat16 CPU tensor their plain versions."""

    @staticmethod
    def forward(ctx, vec, s1, s2m, d, nbr_idx, nbr_mask):
        ctx.save_for_backward(vec, s1, s2m, d, nbr_idx, nbr_mask)
        if vec.device.type == "cpu":
            return vec_agg_plain(vec, s1, s2m, d, nbr_idx, nbr_mask)
        return _launch_agg(vec, s1, s2m, d, nbr_idx, nbr_mask)

    @staticmethod
    def backward(ctx, gva):
        bwd = vec_agg_bwd_plain if gva.device.type == "cpu" else vis_vec_agg_bwd
        dvec, ds1, ds2m, dd = bwd(*ctx.saved_tensors, gva.contiguous())
        return dvec, ds1, ds2m, dd, None, None


class _WDot(torch.autograd.Function):
    """Kernel H forward, kernel I backward (JAX `_wdot`'s custom VJP); on a
    bfloat16 CPU tensor their plain versions."""

    @staticmethod
    def forward(ctx, d, u, vv, nbr_idx, nbr_mask):
        ctx.save_for_backward(d, u, vv, nbr_idx, nbr_mask)
        if u.device.type == "cpu":
            return wdot_plain(d, u, vv, nbr_idx, nbr_mask)
        return _launch_wdot(d, u, vv, nbr_idx, nbr_mask)

    @staticmethod
    def backward(ctx, gw):
        bwd = wdot_bwd_plain if gw.device.type == "cpu" else vis_wdot_bwd
        dd, du, dvv = bwd(*ctx.saved_tensors, gw.contiguous())
        return dd, du, dvv, None, None


def vis_vec_agg(vec, s1, s2m, d, nbr_idx, nbr_mask):
    """Σ_k s1·vec[j] (masked) + Σ_k s2m·d → [G, A, L, h]."""
    dtype = _one_dtype(dict(vec=vec, s1=s1, s2m=s2m, d=d))
    if vec.device.type == "cpu" and dtype == torch.float32:
        return vec_agg_plain(vec, s1, s2m, d, nbr_idx, nbr_mask)
    if vec.device.type != "cpu":
        _cuda_only("vis_vec_agg", vec)
    return _VecAgg.apply(vec, s1, s2m, d, nbr_idx, nbr_mask)


def vis_wdot(d, u, vv, nbr_idx, nbr_mask):
    """u·vv_j − (u·d)(vv_j·d)(2 − |d|²) per edge (vv_j masked) → [G, A, k, h]."""
    dtype = _one_dtype(dict(d=d, u=u, vv=vv))
    if u.device.type == "cpu" and dtype == torch.float32:
        return wdot_plain(d, u, vv, nbr_idx, nbr_mask)
    if u.device.type != "cpu":
        _cuda_only("vis_wdot", u)
    return _WDot.apply(d, u, vv, nbr_idx, nbr_mask)


for _fn in (vis_vec_agg, vis_vec_agg_bwd, vis_wdot, vis_wdot_bwd):
    _fn.launches = _fn.launches_bf16 = 0
