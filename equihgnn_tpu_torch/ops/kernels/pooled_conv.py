"""Kernels J and K: the fused pooled ConvSE3 unit, forward and backward
(float32: `csrc/pooled_conv_fwd.cu`, `csrc/pooled_conv.cu`; bfloat16:
`csrc/pooled_conv_bf16.cu`).

Replaces `equihgnn_tpu/ops/pallas/pooled_conv.py` `pooled_conv`: the
forward `_pc_fwd` (kernel J) and its custom VJP `_pc_bwd` (kernel K):

    M[g, a, c, i, f] = Σ_k h[g, a, k, f] · tc[g, a, k, c·I + i]
    out[g, a, c, o]  = live[g, a] · Σ_{i,f} W[f, o, i] · M[g, a, c, i, f]

Layouts are JAX's: h [G, A, K, F]; tc [G, A, K, C·I] (c outer, i inner); W
[F, O, I], which the kernels read as it lies and give dW in; out [G, A, C,
O]. `live` [G, A] (bool, optional) marks the sites whose output is kept;
the others' output is 0, and so are their share of the gradients (the
backward is K applied to dout · live: dh and dtc are exactly 0 at the dead
sites, which K writes itself, and their dout is never read). Without it
every site is live. J and K compute only the live sites: `live_sites` turns
the mask into the ids of the live sites, live ones first, and their count,
both on the device (a cumsum and a scatter, no host sync); J's blocks past
the count return at once, K's write their sites' dh and dtc as 0. `live`
may be that `LiveSites` already, so that a caller that passes one mask to
several calls (the model's conv, one call a J) builds the list once; a bare
mask is turned into one at each call. The forward saves the list for K.

h, tc, W (and dout) are all float32 or all bfloat16. In float32 the
products run on the tensor cores in 3xTF32 (`csrc/tf32_mma.cuh`), at ~f32
accuracy; the kernels take any K ≥ 0 (K = 0 gives zeros) and any C in
1..64, and K any F ≤ 128 (a thread keeps a row of dh sums in registers); a
K or C whose chunks do not fit a block's shared memory (J and K: K > 22 at
the model's widths; K also at K = 22 with C = 64) is refused by the C
entry, and the wrapper raises. K takes a workspace of W's size (W re-laid
for its copies), allocated by `pooled_conv_bwd`. In bfloat16 they compute
JAX's bfloat16 kernels' function: float32 sums of the exact products, M
and dM rounded to bfloat16, out, dh and dtc rounded once, dW summed in
float32 over every site and rounded once; the products on the tensor cores
(J's by wgmma and K's dM by mma.sync, with W brought by TMA, at the model's
shapes; a general path in the same source for the others, e.g. an I not a
multiple of 8, or K > 16). They take K ≤ 32 (`MAX_K_BF16`; the wrapper
raises beyond) and C in 1..64; their C entry refuses a shape whose tiles do
not fit shared memory (K's dM kernels stage a tile's dout rows: O ≤ 1,088
at K = 16, C = 1).

Routing (`nn/se3_transformer.py` `_ConvSE3Pair`): a float32 pooled unit
takes J and K at every width (where JAX's gate refuses it, JAX runs the
same function as XLA einsums); a bfloat16 unit takes J and K in bfloat16
where JAX's whole gate, `pooled_conv_supported` (a copy, a pure function
of the shapes), fuses it, and JAX's per-J path with kernels L and M
(`ops/kernels/pooled_m.py`) where it does not.

`pooled_conv` is the wrapper. A CPU tensor goes to the plain version
(`pooled_conv_plain`), which autograd traces. A CUDA tensor goes through
`_PooledConv`, an `autograd.Function` whose forward is kernel J and whose
backward is kernel K (`pooled_conv_bwd`); like JAX's custom VJP it saves
only its inputs (and the live-site list). Any other device, type, mix of
types, shape or a non-contiguous h, tc or dout raises (W may have any
strides: the wrapper makes it contiguous, which copies nothing for the
model's W[..., J] slices of one J). `.launches` on `pooled_conv` and
`pooled_conv_bwd` counts calls of the C entries in either type,
`.launches_bf16` the bfloat16 ones.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from equihgnn_tpu_torch.ops.kernels import build

MAX_C = 64  # a row tile of the kernels holds the C rows of at least one site
MAX_K_BF16 = 32  # the bfloat16 kernels stage a site's K neighbours whole
_ISPLIT = 4  # the i-chunk of JAX's fused unit (`pooled_conv.py` `_ISPLIT`)
# M chunk the plain versions materialize at once (sites × C·I·F floats)
_PLAIN_CHUNK_FLOATS = 1 << 28


# JAX's fused unit's VMEM budget and the i-chunk of its projection dots
# (`pooled_conv.py:42-43, 54`): its gate is a pure function of the shapes
_VMEM_BUDGET = 96 * 2**20


def _bwd_vmem(gb, a, k, c, i, f, o, isz):
    """JAX's `_bwd_vmem` (`pooled_conv.py:57-70`): the backward's VMEM bytes
    at `gb` molecule rows a block."""
    r = gb * a * c
    ic, ch = i // _ISPLIT, _ISPLIT * f
    h_b = gb * a * k * f * isz
    tc_b = gb * a * k * c * i * isz
    do_b = r * o * isz
    dbuf = 2 * (2 * h_b + 2 * tc_b + 2 * do_b)
    w4 = ic * ch * o * isz
    dw4 = ic * ch * o * isz
    scratch = 2 * r * ic * ch * isz + ic * ch * o * 4
    return dbuf + w4 + dw4 + scratch + r * o * 4


def _gb_g(a, k, c, i, f, o, isz):
    """JAX's `_gb_g` (`pooled_conv.py:73-78`): the most molecule rows a
    block (at most 256 projection rows) that fit its VMEM budget, else 0."""
    for gb in range(max(1, 256 // (a * c)), 0, -1):
        if _bwd_vmem(gb, a, k, c, i, f, o, isz) < _VMEM_BUDGET:
            return gb
    return 0


def pooled_conv_supported(a: int, k: int, c: int, i: int, f: int, o: int,
                          itemsize: int) -> bool:
    """JAX's whole gate `pooled_conv_supported` (`pooled_conv.py:80-84`) for
    an element of `itemsize` bytes: I % 4, F % 8, O % 128, and the
    backward's VMEM at one molecule row a block. Where it holds, JAX runs
    the fused unit (J and K); where it fails, its einsums (float32) or the
    per-J path with the pooled-M build (kernels L and M, below float32).
    The port routes a bfloat16 pooled unit by it (`nn/se3_transformer.py`)."""
    if i % _ISPLIT or f % 8 or o % 128:
        return False
    return _gb_g(a, k, c, i, f, o, itemsize) > 0


# ------------------------------------------------------------ plain versions


def _site_chunks(h: torch.Tensor, c: int, i: int) -> int:
    """Sites of [G·A] per chunk of the plain versions, so that one chunk's M
    stays under `_PLAIN_CHUNK_FLOATS` floats (1 GiB)."""
    per_site = max(1, c * i * h.shape[-1])
    return max(1, _PLAIN_CHUNK_FLOATS // per_site)


class LiveSites(NamedTuple):
    """A bool live-site mask [G, A] with the list kernel J walks: the flat
    ids of the live sites in order, then those of the others (int32
    [G·A]), and the number of live ones (int32 [1]), on the mask's device."""

    mask: torch.Tensor
    ids: torch.Tensor
    count: torch.Tensor


def live_sites(live: torch.Tensor) -> LiveSites:
    """`LiveSites` of a bool `live` [G, A]. A cumsum and a scatter into a
    permutation: no host sync, the same result every time."""
    flat = live.reshape(-1)
    n = flat.numel()
    pos = torch.cumsum(flat, 0, dtype=torch.int32)  # live sites up to each site
    count = pos[-1:] if n else pos.new_zeros(1)
    idx = torch.arange(n, dtype=torch.int32, device=live.device)
    target = torch.where(flat, pos - 1, count + idx - pos)  # live first, then dead, each in order
    ids = torch.empty_like(idx).scatter_(0, target.long(), idx)
    return LiveSites(live, ids, count)


def _mask(live):
    """The bool mask of `live` (a mask, a `LiveSites` or None)."""
    return live.mask if isinstance(live, LiveSites) else live


def _f32(*ts):
    """The tensors in float32 (a bfloat16 value is exact there)."""
    return [t.float() for t in ts]


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to `dtype` and read back in float32; under autograd the
    gradient is rounded the same way on its way back."""
    return t if dtype == torch.float32 else t.to(dtype).float()


def pooled_conv_plain(h, tc, w, c: int, live=None):
    """The einsums of JAX's docstring (`pooled_conv.py:272-277`), with M
    materialized for a chunk of sites at a time, times `live` (a bool
    [G, A], a `LiveSites` or None). In bfloat16 (h, tc and w all bfloat16)
    it is JAX's bfloat16 kernel: float32 sums of the exact products, M
    rounded to bfloat16 (`pooled_conv.py:97`), the output rounded once.
    Autograd through it is `pooled_conv_bwd_plain`'s function: it rounds
    dM, dh, dtc and dW where that does."""
    _check_dtypes(h, tc, w)
    g, a, k, f = h.shape
    i = w.shape[2]
    dt = h.dtype
    hs = h.reshape(g * a, k, f)
    ts = tc.reshape(g * a, k, c, i)
    step = _site_chunks(h, c, i)
    w32, = _f32(w) if dt != torch.float32 else (w,)
    outs = []
    for s0 in range(0, g * a, step):
        hc, tcc = hs[s0:s0 + step], ts[s0:s0 + step]
        if dt != torch.float32:
            hc, tcc = _f32(hc, tcc)
        m = _rounded(torch.einsum("skf,skci->scif", hc, tcc), dt)
        outs.append(torch.einsum("scif,foi->sco", m, w32))
    out = torch.cat(outs) if outs else hs.new_zeros((0, c, w.shape[1]), dtype=w32.dtype)
    out = out.reshape(g, a, c, w.shape[1]).to(dt)
    live = _mask(live)
    return out if live is None else out * live[..., None, None]


def pooled_conv_bwd_plain(h, tc, w, c: int, dout, live=None):
    """(dh, dtc, dW) for the output gradient `dout` [G, A, C, O] of
    `pooled_conv_plain(h, tc, w, c, live)`: with dout · live, dM = dout·Wᵀ,
    dh = Σ_{c,i} tc·dM, dtc = Σ_f h·dM, dW = Σ_{g,a,c} M·dout, chunked as
    `pooled_conv_plain` (live a bool [G, A], a `LiveSites` or None: every
    site). dh and dtc are 0 at the dead sites, as dM is there. In bfloat16
    it is JAX's bfloat16 `_bwd_kernel`: M and dM rounded to bfloat16, dh
    and dtc float32 sums over the rounded dM rounded once each, dW summed in
    float32 over every site and rounded once (`pooled_conv.py:128-158`)."""
    _check_dtypes(h, tc, w, dout)
    live = _mask(live)
    if live is not None:
        dout = dout * live[..., None, None]
    g, a, k, f = h.shape
    i = w.shape[2]
    dt = h.dtype
    hs = h.reshape(g * a, k, f)
    ts = tc.reshape(g * a, k, c, i)
    ds = dout.reshape(g * a, c, -1)
    step = _site_chunks(h, c, i)
    w32, = _f32(w) if dt != torch.float32 else (w,)
    dhs, dtcs = [], []
    dw = torch.zeros_like(w32)
    for s0 in range(0, g * a, step):
        hc, tcc, dc = hs[s0:s0 + step], ts[s0:s0 + step], ds[s0:s0 + step]
        if dt != torch.float32:
            hc, tcc, dc = _f32(hc, tcc, dc)
        dm = _rounded(torch.einsum("sco,foi->scif", dc, w32), dt)
        dhs.append(torch.einsum("skci,scif->skf", tcc, dm).to(dt))
        dtcs.append(torch.einsum("skf,scif->skci", hc, dm).to(dt))
        dw += torch.einsum("scif,sco->foi", _rounded(torch.einsum("skf,skci->scif", hc, tcc), dt),
                           dc)
    dh = torch.cat(dhs) if dhs else torch.zeros_like(hs)
    dtc = torch.cat(dtcs) if dtcs else torch.zeros_like(ts)
    return dh.reshape(h.shape), dtc.reshape(tc.shape), dw.to(dt)


def bwd_bf16_rounding_bound(h, tc, w, c: int, dout, live=None):
    """Per element of the bfloat16 backward's dh and dtc, the most that
    rounding dM to bfloat16 at another boundary can move it: 2^-7 (an ulp
    of a bfloat16 value, at most) of Σ_{c,i} |tc|·|dM| and of Σ_f |h|·|dM|,
    dM the plain version's. Kernel K rounds dM from its tensor-core sums,
    the plain version from cuBLAS's; the two float32 sums of O products
    differ in their last bits, and a dM at a rounding boundary rounds up in
    one and down in the other. dh and dtc sum 256 or 128 such terms and can
    cancel to well below them, so one dM an ulp apart can move them by
    several of their own ulps."""
    live = _mask(live)
    if live is not None:
        dout = dout * live[..., None, None]
    g, a, k, f = h.shape
    i = w.shape[2]
    hs, ts = h.reshape(g * a, k, f), tc.reshape(g * a, k, c, i)
    ds = dout.reshape(g * a, c, -1)
    w32 = w.float()
    step = _site_chunks(h, c, i)
    dhs, dtcs = [], []
    for s0 in range(0, g * a, step):
        hc, tcc, dc = _f32(hs[s0:s0 + step], ts[s0:s0 + step], ds[s0:s0 + step])
        dm = torch.einsum("sco,foi->scif", dc, w32).to(h.dtype).float().abs()
        dhs.append(torch.einsum("skci,scif->skf", tcc.abs(), dm) * 2.0 ** -7)
        dtcs.append(torch.einsum("skf,scif->skci", hc.abs(), dm) * 2.0 ** -7)
    dh = torch.cat(dhs) if dhs else torch.zeros(hs.shape, device=h.device)
    dtc = torch.cat(dtcs) if dtcs else torch.zeros(ts.shape, device=h.device)
    return dh.reshape(h.shape), dtc.reshape(tc.shape)


# ----------------------------------------------------------------- checks


def _check_dtypes(h, tc, w, dout=None):
    """h, tc, w (and dout) all float32 or all bfloat16."""
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"pooled_conv takes float32 or bfloat16 h, got {h.dtype}")
    for name, t in (("tc", tc), ("w", w), ("dout", dout)):
        if t is not None and t.dtype != h.dtype:
            raise TypeError(f"pooled_conv takes {name} in h's dtype {h.dtype}, got {t.dtype}")


def _check(h, tc, w, c, dout=None, live=None):
    _check_dtypes(h, tc, w, dout)
    if h.ndim != 4 or tc.ndim != 4 or w.ndim != 3:
        raise ValueError(f"pooled_conv takes h [G, A, K, F], tc [G, A, K, C·I], w [F, O, I]; "
                         f"got {tuple(h.shape)}, {tuple(tc.shape)}, {tuple(w.shape)}")
    g, a, k, f = h.shape
    _, o, i = w.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"pooled_conv kernels take C in 1..{MAX_C}, got {c}")
    if h.dtype == torch.bfloat16 and k > MAX_K_BF16:
        raise ValueError(f"the bfloat16 pooled_conv kernels take K ≤ {MAX_K_BF16}, got {k}")
    want = {"h": (g, a, k, f), "tc": (g, a, k, c * i), "w": (f, o, i), "dout": (g, a, c, o)}
    for name, t in (("h", h), ("tc", tc), ("w", w), ("dout", dout)):
        if t is None:
            continue
        if t.device != h.device:
            raise ValueError(f"{name} lies on {t.device}, h on {h.device}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {list(want[name])}, got {tuple(t.shape)}")
        if name != "w" and not t.is_contiguous():  # w is made contiguous
            raise ValueError(f"pooled_conv kernel takes a contiguous {name}")
    if live is not None and (live.dtype != torch.bool or tuple(live.shape) != (g, a)
                             or live.device != h.device):
        raise ValueError(f"live must be a bool [{g}, {a}] on {h.device}, got {live.dtype} "
                         f"{tuple(live.shape)} on {live.device}")
    return g * a, k, i, f, o


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _cuda_only(name, t):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {t.device}")


# --------------------------------------------------------------- kernels


def _suffix(h) -> str:
    return "bf16" if h.dtype == torch.bfloat16 else "f32"


def _launch_fwd(h, tc, w, c, sites: LiveSites | None = None):
    s, k, i, f, o = _check(h, tc, w, c, live=_mask(sites))
    w = w.contiguous()
    shape = h.shape[:2] + (c, o)
    if sites is None:  # J writes every row
        out = torch.empty(shape, dtype=h.dtype, device=h.device)
    else:  # J writes the live sites' rows only
        out = torch.zeros(shape, dtype=h.dtype, device=h.device)
    lib = build.library()
    entry = f"pooled_conv_fwd_{_suffix(h)}"
    with torch.cuda.device(h.device):
        code = getattr(lib, entry)(h.data_ptr(), tc.data_ptr(), w.data_ptr(),
                                   None if sites is None else sites.ids.data_ptr(),
                                   None if sites is None else sites.count.data_ptr(),
                                   out.data_ptr(), s, k, c, i, f, o, _stream(h))
    build.check(lib, f"{entry} at K = {k}, C = {c}", code)
    pooled_conv.launches += 1
    pooled_conv.launches_bf16 += h.dtype == torch.bfloat16
    return out


def pooled_conv_bwd(h, tc, w, c: int, dout, sites=None):
    """Kernel K: (dh, dtc, dW) for the output gradient `dout` [G, A, C, O] of
    J at the live sites (`sites`: a `LiveSites`, a bool [G, A] or None: every
    site), on CUDA tensors only (`pooled_conv_bwd_plain` is the same
    backward). dh and dtc are 0 at the dead sites, written by the kernel;
    their dout is not read."""
    _cuda_only("pooled_conv_bwd", h)
    if isinstance(sites, torch.Tensor):
        _check(h, tc, w, c, live=sites)
        sites = live_sites(sites)
    s, k, i, f, o = _check(h, tc, w, c, dout, live=_mask(sites))
    w = w.contiguous()
    dh, dtc, dw = torch.empty_like(h), torch.empty_like(tc), torch.empty_like(w)
    lib = build.library()
    ids = None if sites is None else sites.ids.data_ptr()
    count = None if sites is None else sites.count.data_ptr()
    entry = f"pooled_conv_bwd_{_suffix(h)}"
    ws = ()
    if h.dtype == torch.float32:  # f32 K takes a workspace: W re-laid by stage
        floats = ctypes.c_int64()
        build.check(lib, "pooled_conv_bwd_workspace_f32",
                    lib.pooled_conv_bwd_workspace_f32(i, f, o, ctypes.byref(floats)))
        ws = (torch.empty(floats.value, dtype=torch.float32, device=h.device),)
    with torch.cuda.device(h.device):
        code = getattr(lib, entry)(h.data_ptr(), tc.data_ptr(), w.data_ptr(), dout.data_ptr(),
                                   ids, count, dh.data_ptr(), dtc.data_ptr(), dw.data_ptr(),
                                   *(t.data_ptr() for t in ws), s, k, c, i, f, o, _stream(h))
    build.check(lib, f"{entry} at K = {k}, C = {c}", code)
    pooled_conv_bwd.launches += 1
    pooled_conv_bwd.launches_bf16 += h.dtype == torch.bfloat16
    return dh, dtc, dw


class _PooledConv(torch.autograd.Function):
    """Kernel J forward, kernel K backward (JAX `_pooled_conv`'s custom VJP)
    at the live sites, both walking the same list."""

    @staticmethod
    def forward(ctx, h, tc, w, c, sites):
        ctx.save_for_backward(h, tc, w, *(sites if sites is not None else (None,) * 3))
        ctx.c = c
        return _launch_fwd(h, tc, w, c, sites)

    @staticmethod
    def backward(ctx, dout):
        h, tc, w, mask, ids, count = ctx.saved_tensors
        sites = None if mask is None else LiveSites(mask, ids, count)
        dh, dtc, dw = pooled_conv_bwd(h, tc, w, ctx.c, dout.contiguous(), sites)
        return dh, dtc, dw, None, None


def pooled_conv(h, tc, w, c: int, live=None):
    """out[g, a, c, o] = live[g, a] · Σ_{i,f} W[f, o, i] · Σ_k h[g, a, k, f] · tc[g, a, k, c·I + i]
    (live a bool [G, A], its `LiveSites`, or None: every site)."""
    if h.device.type == "cpu":
        return pooled_conv_plain(h, tc, w, c, live)
    _cuda_only("pooled_conv", h)
    if isinstance(live, torch.Tensor):
        _check(h, tc, w, c, live=live)  # a bool [G, A], before its list is built
        live = live_sites(live)
    return _PooledConv.apply(h, tc, w, c, live)


pooled_conv.launches = pooled_conv.launches_bf16 = 0
pooled_conv_bwd.launches = pooled_conv_bwd.launches_bf16 = 0
