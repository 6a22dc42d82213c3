"""Kernels J and K: the fused pooled ConvSE3 unit, forward and backward
(`csrc/pooled_conv_fwd.cu`, `csrc/pooled_conv.cu`).

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
mask is turned into one at each call. The forward saves the list for K. The
kernels are float32 only; their products run on the tensor cores in 3xTF32
(`csrc/tf32_mma.cuh`), at ~f32 accuracy. Routing (`nn/se3_transformer.py`
`_ConvSE3Pair`): a float32 pooled unit takes J and K at every width, since
the VMEM half of JAX's gate `pooled_conv_supported` is not ported; a
bfloat16 unit takes the per-J path with kernels L and M
(`ops/kernels/pooled_m.py`) where the gate's divisibility half,
`pooled_conv_shape_ok`, fails, as JAX does, and raises where it holds (J
and K in bfloat16 are ROADMAP item 11). The kernels take any K ≥ 0 (K = 0
gives zeros) and any C in 1..64, and K any F ≤ 128 (a thread keeps a row of
dh sums in registers); a K or C whose chunks do not fit a block's shared
memory (J and K: K > 22 at the model's widths; K also at K = 22 with C =
64) is refused by the C entry, and the wrapper raises. K takes a workspace
of W's size (W re-laid for its copies), allocated by `pooled_conv_bwd`.

`pooled_conv` is the wrapper. A CPU tensor goes to the plain version
(`pooled_conv_plain`), which autograd traces. A CUDA tensor goes through
`_PooledConv`, an `autograd.Function` whose forward is kernel J and whose
backward is kernel K (`pooled_conv_bwd`); like JAX's custom VJP it saves
only its inputs (and the live-site list). Any other device, type, shape or
a non-contiguous h, tc or dout raises (W may have any strides: the wrapper
makes it contiguous, which copies nothing for the model's W[..., J] slices
of one J). `.launches` on `pooled_conv` and `pooled_conv_bwd` counts calls
of the C entries.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from equihgnn_tpu_torch.ops.kernels import build

MAX_C = 64  # a row tile of the kernels holds the C rows of at least one site
_ISPLIT = 4  # the i-chunk of JAX's fused unit (`pooled_conv.py` `_ISPLIT`)
# M chunk the plain versions materialize at once (sites × C·I·F floats)
_PLAIN_CHUNK_FLOATS = 1 << 28


def pooled_conv_shape_ok(i: int, f: int, o: int) -> bool:
    """The divisibility half of JAX's `pooled_conv_supported`
    (`pooled_conv.py:80-84`: I % 4, F % 8, O % 128), by which the port
    routes a bfloat16 pooled unit: where it holds, JAX runs the fused unit
    (J and K, which the port has in float32 only: the unit raises), and
    where it fails, the per-J path with the pooled-M build (kernels L and M,
    `ops/kernels/pooled_m.py`). Its VMEM half is not ported."""
    return i % _ISPLIT == 0 and f % 8 == 0 and o % 128 == 0


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


def pooled_conv_plain(h, tc, w, c: int, live=None):
    """The einsums of JAX's docstring (`pooled_conv.py:272-277`), with M
    materialized for a chunk of sites at a time, times `live` (a bool
    [G, A], a `LiveSites` or None)."""
    g, a, k, f = h.shape
    i = w.shape[2]
    hs = h.reshape(g * a, k, f)
    ts = tc.reshape(g * a, k, c, i)
    step = _site_chunks(h, c, i)
    outs = []
    for s0 in range(0, g * a, step):
        m = torch.einsum("skf,skci->scif", hs[s0:s0 + step], ts[s0:s0 + step])
        outs.append(torch.einsum("scif,foi->sco", m, w))
    out = torch.cat(outs) if outs else hs.new_zeros((0, c, w.shape[1]))
    out = out.reshape(g, a, c, w.shape[1])
    live = _mask(live)
    return out if live is None else out * live[..., None, None]


def pooled_conv_bwd_plain(h, tc, w, c: int, dout, live=None):
    """(dh, dtc, dW) for the output gradient `dout` [G, A, C, O] of
    `pooled_conv_plain(h, tc, w, c, live)`: with dout · live, dM = dout·Wᵀ,
    dh = Σ_{c,i} tc·dM, dtc = Σ_f h·dM, dW = Σ_{g,a,c} M·dout, chunked as
    `pooled_conv_plain` (live a bool [G, A], a `LiveSites` or None: every
    site). dh and dtc are 0 at the dead sites, as dM is there."""
    live = _mask(live)
    if live is not None:
        dout = dout * live[..., None, None]
    g, a, k, f = h.shape
    i = w.shape[2]
    hs = h.reshape(g * a, k, f)
    ts = tc.reshape(g * a, k, c, i)
    ds = dout.reshape(g * a, c, -1)
    step = _site_chunks(h, c, i)
    dhs, dtcs = [], []
    dw = torch.zeros_like(w)
    for s0 in range(0, g * a, step):
        hc, tcc, dc = hs[s0:s0 + step], ts[s0:s0 + step], ds[s0:s0 + step]
        dm = torch.einsum("sco,foi->scif", dc, w)
        dhs.append(torch.einsum("skci,scif->skf", tcc, dm))
        dtcs.append(torch.einsum("skf,scif->skci", hc, dm))
        dw += torch.einsum("scif,sco->foi", torch.einsum("skf,skci->scif", hc, tcc), dc)
    dh = torch.cat(dhs) if dhs else torch.zeros_like(hs)
    dtc = torch.cat(dtcs) if dtcs else torch.zeros_like(ts)
    return dh.reshape(h.shape), dtc.reshape(tc.shape), dw


# ----------------------------------------------------------------- checks


def _check(h, tc, w, c, dout=None, live=None):
    if h.ndim != 4 or tc.ndim != 4 or w.ndim != 3:
        raise ValueError(f"pooled_conv takes h [G, A, K, F], tc [G, A, K, C·I], w [F, O, I]; "
                         f"got {tuple(h.shape)}, {tuple(tc.shape)}, {tuple(w.shape)}")
    g, a, k, f = h.shape
    _, o, i = w.shape
    if not 1 <= c <= MAX_C:
        raise ValueError(f"pooled_conv kernels take C in 1..{MAX_C}, got {c}")
    want = {"h": (g, a, k, f), "tc": (g, a, k, c * i), "w": (f, o, i), "dout": (g, a, c, o)}
    for name, t in (("h", h), ("tc", tc), ("w", w), ("dout", dout)):
        if t is None:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"pooled_conv kernel takes float32 {name}, got {t.dtype}")
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


def _launch_fwd(h, tc, w, c, sites: LiveSites | None = None):
    s, k, i, f, o = _check(h, tc, w, c, live=_mask(sites))
    w = w.contiguous()
    shape = h.shape[:2] + (c, o)
    if sites is None:  # J writes every row
        out = torch.empty(shape, dtype=torch.float32, device=h.device)
    else:  # J writes the live sites' rows only
        out = torch.zeros(shape, dtype=torch.float32, device=h.device)
    lib = build.library()
    with torch.cuda.device(h.device):
        code = lib.pooled_conv_fwd_f32(h.data_ptr(), tc.data_ptr(), w.data_ptr(),
                                       None if sites is None else sites.ids.data_ptr(),
                                       None if sites is None else sites.count.data_ptr(),
                                       out.data_ptr(), s, k, c, i, f, o, _stream(h))
    build.check(lib, f"pooled_conv_fwd_f32 at K = {k}, C = {c}", code)
    pooled_conv.launches += 1
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
    floats = ctypes.c_int64()
    build.check(lib, "pooled_conv_bwd_workspace_f32",
                lib.pooled_conv_bwd_workspace_f32(i, f, o, ctypes.byref(floats)))
    ws = torch.empty(floats.value, dtype=torch.float32, device=h.device)  # W re-laid by stage
    with torch.cuda.device(h.device):
        code = lib.pooled_conv_bwd_f32(h.data_ptr(), tc.data_ptr(), w.data_ptr(),
                                       dout.data_ptr(),
                                       None if sites is None else sites.ids.data_ptr(),
                                       None if sites is None else sites.count.data_ptr(),
                                       dh.data_ptr(), dtc.data_ptr(), dw.data_ptr(),
                                       ws.data_ptr(), s, k, c, i, f, o, _stream(h))
    build.check(lib, f"pooled_conv_bwd_f32 at K = {k}, C = {c}", code)
    pooled_conv_bwd.launches += 1
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


pooled_conv.launches = 0
pooled_conv_bwd.launches = 0
