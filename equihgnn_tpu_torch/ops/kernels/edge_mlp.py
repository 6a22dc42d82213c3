"""Kernels B and C: fused EGNN edge messages, forward and backward
(`csrc/edge_mlp.cu`).

Replaces `equihgnn_tpu/ops/pallas/edge_mlp.py` `fused_edge_messages`: its
forward `_fwd_impl`/`_fwd_kernel` (kernel B) and its custom VJP
`_vjp_bwd`/`_bwd_kernel` (kernel C):

    out[g, a, kk] = silu(z),  z = silu(ui[g, a] + ujn[g, idx[g, a, kk]]
                                       + dist[g, a, kk]·wd + b0) @ w1 + b1

`fused_edge_messages` is the wrapper, with the JAX function's argument
layout: ui/ujn [G, A, F], dist [G, A, k], nbr_idx [G, A, k] slot indices
into the A axis, wd/b0 [F], w1 [F, m], b1 [m] → [G, A, k, m]. An optional
`edge_mask` [G, A, k] (bool, the model's pair_mask) makes it

    where(edge_mask[..., None], silu(z), 0),

whose backward is the unmasked one's on dm·mask (the `live` mask of kernels
J and K, `pooled_conv.py`, does the same): kernel B then skips every slot
whose edges are all dead, and writes 0 at the dead edges. With no mask every
edge is computed, exactly the JAX function. A CPU tensor
goes to `fused_edge_messages_plain`, which autograd traces. A CUDA tensor
goes through `_FusedEdgeMessages`, an `autograd.Function` whose forward is
kernel B and whose backward is kernel C (`fused_edge_messages_bwd`). When
an input needs a gradient, kernel B also writes z [G, A, k, m] (25 MB at
batch 768), which the Function saves beside its inputs, so that kernel C
does not compute the forward again; JAX's `_vjp_fwd` saved only its inputs
and recomputed z, because its kernel had only VMEM to keep it in. Serving
(no gradient) writes nothing more than `out`; with a mask, z is written at
the live edges only, and the backward hands kernel C dm·mask, so that C,
which reads z only where dm is not 0, never reads it at a dead edge.
Kernel C skips, exactly, the edges whose row of dm is all 0 (the model's
padded neighbours: both consumers of `out` mask them), and writes 0 there. `nbr_idx` gets no
gradient. The kernels take float32, m = 16 and rows of A ≤ 1,138 slots at
k = 16 (kernel B's shared memory; C's limit is lower, A ≤ 897), or the
wrapper raises.

bfloat16 (the models' compute dtype): ui, ujn and dist in bf16, the
parameters in f32, as JAX's bf16 call (`_dot(..., mm_bf16=True)`,
`:51-62`): pre and its SiLU in f32, the product silu(pre)·W1 with both
operands rounded to bf16 and summed in f32, out = silu(z) rounded to bf16;
z stays f32 (C's silu'(z) is the one JAX recomputes). The backward gives
dui, dujn and ddist in bf16 and the parameters' gradients in f32; dz is
rounded to bf16 before its two products (dz·W1ᵀ, a1ᵀ·dz), as in JAX, and
dujn is summed in f32 (JAX rounds dpre to bf16 before its one-hot
scatter, a TPU matrix-unit artefact not copied). The bf16 kernels
(`edge_mlp_fwd_bf16`, `edge_mlp_bwd_bf16`) run those products on bf16
`mma.sync` and take an even F and rows of A ≤ 1,887 slots at k = 16 (B;
its ujn stage is bf16) and A ≤ 1,164 (C). `fused_edge_messages_plain` is
the same bf16 function in plain PyTorch (the [G, A, k, F] composition in
f32, a1 and W1 rounded before an f32 matmul whose backward rounds dz), and
autograd through it is C's plain version.
Contract: every index lies in [0, A), as `knn_dense` gives them; the
kernels do not check it (that would need a device-to-host sync per call).
`fused_edge_messages.launches` and `fused_edge_messages_bwd.launches` count
kernel launches in either dtype, their `launches_bf16` the bfloat16 ones.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from equihgnn_tpu_torch.ops.kernels import build

KERNEL_M = 16  # the kernels' message width (csrc/edge_mlp.cu M_OUT)
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block can use
GROUP = 8  # kernel C's live edges a warp walks at once (csrc)
FW_PASS = 32  # kernel B's edge tiles a pass over the columns (csrc)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


class _Bf16Product(torch.autograd.Function):
    """a [..., F] @ w [F, m] with both operands rounded to bfloat16 and the
    products summed in float32 (JAX's `_dot(..., mm_bf16=True)`); the
    backward rounds the output gradient dz to bfloat16 too before its two
    products, as JAX's backward kernel does (`:117,119`)."""

    @staticmethod
    def forward(ctx, a, w):
        ar, wr = _round_bf16(a), _round_bf16(w)
        ctx.save_for_backward(ar, wr)
        return torch.matmul(ar, wr)

    @staticmethod
    def backward(ctx, dz):
        ar, wr = ctx.saved_tensors
        dzr = _round_bf16(dz)
        da = torch.matmul(dzr, wr.t())
        dw = torch.matmul(ar.reshape(-1, ar.shape[-1]).t(), dzr.reshape(-1, dzr.shape[-1]))
        return da, dw


def fused_edge_messages_plain(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, edge_mask=None):
    """The same function in plain PyTorch: materializes [G, A, k, F]; 0 at
    the edges `edge_mask` drops. bfloat16 inputs take the bf16 function
    (see the module docstring) and give a bfloat16 output."""
    g = torch.arange(ujn.shape[0], device=ujn.device)[:, None, None]
    if ui.dtype == torch.bfloat16:  # f32 before the gather: dujn is summed in f32
        # JAX's order, (ui + b0) + ujn[idx] + dist·wd, which the kernels keep
        pre = ((ui.float()[:, :, None, :] + b0) + ujn.float()[g, nbr_idx]
               + dist.float()[..., None] * wd)
        out = F.silu(_Bf16Product.apply(F.silu(pre), w1) + b1).to(torch.bfloat16)
    else:
        pre = ui[:, :, None, :] + ujn[g, nbr_idx] + dist[..., None] * wd + b0
        out = F.silu(torch.matmul(F.silu(pre), w1) + b1)
    if edge_mask is None:
        return out
    return torch.where(edge_mask[..., None], out, torch.zeros((), dtype=out.dtype, device=out.device))


def fused_edge_messages_bwd_plain(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm, edge_mask=None):
    """(dui, dujn, ddist, dwd, db0, dw1, db1): autograd through
    `fused_edge_messages_plain` for the output gradient `dm`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (ui, ujn, dist, wd, b0, w1, b1)]
        out = fused_edge_messages_plain(*leaves[:3], nbr_idx, *leaves[3:], edge_mask)
        return torch.autograd.grad(out, leaves, dm)


def bwd_bf16_rounding_bound(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm, z):
    """Per element of the bf16 backward's (dui, dujn, ddist), the most that
    rounding dz to bf16 at another boundary can move it: 2^-7 of the sum
    over the element's terms of |dz|·|W1|ᵀ·|silu'(pre)| (times |wd| for
    ddist), dz = dm·silu'(z) from the `z` given. Kernel C rounds dz from
    kernel B's z, autograd through `fused_edge_messages_plain` from its own,
    and the two z's are f32 sums in other orders: a dz at a rounding
    boundary can round up in one and down in the other."""
    g = torch.arange(ujn.shape[0], device=ujn.device)[:, None, None]
    pre = ((ui.float()[:, :, None, :] + b0) + ujn.float()[g, nbr_idx]
           + dist.float()[..., None] * wd)
    s, sp = torch.sigmoid(z), torch.sigmoid(pre)
    dz = (dm.float() * s * (1 + z * (1 - s))).abs()
    terms = torch.matmul(dz, w1.abs().t()) * (sp * (1 + pre * (1 - sp))).abs() * 2.0 ** -7
    del pre, sp
    rows = (g * ujn.shape[1] + nbr_idx).reshape(-1)
    dujn = torch.zeros(ujn.shape[0] * ujn.shape[1], ujn.shape[2], device=ujn.device)
    dujn.index_add_(0, rows, terms.reshape(-1, terms.shape[-1]))
    return terms.sum(2), dujn.view(ujn.shape), torch.matmul(terms, wd.abs())


def _check(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm=None, z=None, edge_mask=None):
    named = dict(ui=ui, ujn=ujn, dist=dist, wd=wd, b0=b0, w1=w1, b1=b1)
    if dm is not None:
        named["dm"] = dm
    if z is not None:
        named["z"] = z
    act = ui.dtype  # of ui, ujn, dist and dm; the parameters and z are float32
    if act not in (torch.float32, torch.bfloat16):
        raise TypeError(f"edge_mlp kernel takes float32 or bfloat16 ui, got {act}")
    for name, t in named.items():
        want = act if name in ("ui", "ujn", "dist", "dm") else torch.float32
        if t.dtype != want:
            raise TypeError(f"edge_mlp kernel takes {want} {name} with {act} ui, got {t.dtype}")
    if nbr_idx.dtype != torch.int64:
        raise TypeError(f"edge_mlp kernel takes int64 nbr_idx, got {nbr_idx.dtype}")
    if edge_mask is not None and edge_mask.dtype != torch.bool:
        raise TypeError(f"edge_mlp kernel takes a bool edge_mask, got {edge_mask.dtype}")
    tensors = dict(named, nbr_idx=nbr_idx)
    if edge_mask is not None:
        tensors["edge_mask"] = edge_mask
    for name, t in tensors.items():
        if t.device != ui.device:
            raise ValueError(f"{name} lies on {t.device}, ui on {ui.device}")
        if not t.is_contiguous():
            raise ValueError(f"edge_mlp kernel takes a contiguous {name}")
    if ui.ndim != 3 or ujn.shape != ui.shape:
        raise ValueError(f"ui and ujn must both be [G, A, F], got {tuple(ui.shape)}, {tuple(ujn.shape)}")
    g, a, f = ui.shape
    k = nbr_idx.shape[-1]
    if nbr_idx.shape != (g, a, k) or dist.shape != (g, a, k):
        raise ValueError(
            f"nbr_idx and dist must be [G, A, k] = [{g}, {a}, k], got "
            f"{tuple(nbr_idx.shape)}, {tuple(dist.shape)}"
        )
    if edge_mask is not None and edge_mask.shape != (g, a, k):
        raise ValueError(f"edge_mask must be [{g}, {a}, {k}], got {tuple(edge_mask.shape)}")
    if wd.shape != (f,) or b0.shape != (f,) or w1.shape != (f, KERNEL_M) or b1.shape != (KERNEL_M,):
        raise ValueError(
            f"edge_mlp kernel takes wd, b0 [{f}], w1 [{f}, {KERNEL_M}], b1 "
            f"[{KERNEL_M}]; got {tuple(wd.shape)}, {tuple(b0.shape)}, "
            f"{tuple(w1.shape)}, {tuple(b1.shape)}"
        )
    bf16 = act == torch.bfloat16
    if bf16 and (f < 2 or f % 2):
        raise ValueError(f"the bfloat16 edge_mlp kernels take an even F, got {f}")
    if (_fwd_smem_bf16 if bf16 else _fwd_smem)(a, k, 16) > SMEM_LIMIT:
        raise ValueError(f"A = {a}, k = {k} need more shared memory than a block has (kernel B)")
    for name, t in (("dm", dm), ("z", z)):
        if t is not None and t.shape != (g, a, k, KERNEL_M):
            raise ValueError(f"{name} must be [{g}, {a}, {k}, {KERNEL_M}], got {tuple(t.shape)}")
    if dm is not None and (_bwd_smem_bf16 if bf16 else _bwd_smem)(a, k, 32) > SMEM_LIMIT:
        raise ValueError(f"A = {a}, k = {k} need more shared memory than a block has")


def _fwd_smem(a: int, k: int, cw: int) -> int:
    """Kernel B's shared memory in bytes at `cw` columns a stage (csrc
    `fwd_smem`): the running sums of a pass's tiles, two stages of the row's
    ujn [A][cw + 4], the pass's ui, wd, b0 and W1's fragments, and the row's
    live-tile list. The launch takes the widest of 64, 32 and 16 columns
    that fits (`fwd_cols`)."""
    tiles = a * -(-k // 16)
    stage = a * (cw + 4) + FW_PASS * cw + 2 * cw + 32 * cw
    return (FW_PASS * 256 + 2 * stage) * 4 + (2 * tiles + 1) * 4


def _fwd_smem_bf16(a: int, k: int, cw: int) -> int:
    """Kernel B in bf16's shared memory in bytes (csrc `fwd_smem_bf16`):
    the running sums, two stages of ujn [A][cw + 8] and the pass's ui in
    bf16, wd and b0 in f32 and W1's bf16 fragments (32 bytes a column), and
    the live-tile list."""
    tiles = a * -(-k // 16)
    stage = 2 * a * (cw + 8) + 2 * FW_PASS * cw + 8 * cw + 32 * cw
    return FW_PASS * 256 * 4 + 2 * stage + (2 * tiles + 1) * 4


def fwd_workspace_floats(f: int, dtype: torch.dtype = torch.float32) -> int:
    """Floats of kernel B's workspace: W1's split fragments, 32 floats a
    column of F rounded up to 16 (csrc `edge_mlp_fwd_f32`); in bf16 its
    bf16 fragments, 8 floats' worth a column (`edge_mlp_fwd_bf16`)."""
    return -(-f // 16) * (128 if dtype == torch.bfloat16 else 512)


def _bwd_smem(a: int, k: int, cols: int) -> int:
    """Kernel C's shared memory in bytes at `cols` columns a block (csrc
    `bwd_smem`): the dujn and ujn chunks [A][cols], two slot buffers, each
    warp's live list. The launch takes the widest of 128, 64 and 32 columns
    that fits (`bwd_cols`)."""
    warps = cols // 32
    slot = ((k + 1) * (KERNEL_M + 2 + warps) + k + 3) // 4 * 4
    return (2 * a * cols + 2 * slot + warps * (-(-k // GROUP) * GROUP)) * 4


def _bwd_smem_bf16(a: int, k: int, cols: int) -> int:
    """Kernel C in bf16's shared memory in bytes (csrc `bwd_smem_bf16`):
    dujn [A][cols] in f32 and ujn in bf16, two slot buffers (kernel C's and
    dz in bf16 as [KT][16] and [16][KT + 8], KT = k rounded up to 16), each
    warp's live list, t [KT][32] in f32 and a1 [32][KT + 8] in bf16."""
    def up16(n):
        return -(-n // 16) * 16

    warps, kt = cols // 32, -(-k // 16) * 16
    slot_f32 = ((k + 1) * (KERNEL_M + 2 + warps) + k + 3) // 4 * 4 * 4
    slot = slot_f32 + kt * 16 * 2 + up16(16 * (kt + 8) * 2)
    lists = up16(warps * (-(-k // GROUP) * GROUP) * 4)
    return up16(a * cols * 6) + 2 * slot + lists + warps * (kt * 32 * 4 + 32 * (kt + 8) * 2)


_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, edge_mask=None, want_z: bool = False):
    """(out, z): kernel B's output, and z where `want_z` (else None; with
    `edge_mask`, z is written at the live edges only)."""
    g, a, f = ui.shape
    k = nbr_idx.shape[-1]
    out = torch.empty((g, a, k, KERNEL_M), dtype=ui.dtype, device=ui.device)
    z = torch.empty(out.shape, dtype=torch.float32, device=ui.device) if want_z else None
    lib = build.library()
    ws = torch.empty(fwd_workspace_floats(f, ui.dtype), dtype=torch.float32, device=ui.device)
    name = f"edge_mlp_fwd_{_SUFFIX[ui.dtype]}"
    with torch.cuda.device(ui.device):
        code = getattr(lib, name)(
            ui.data_ptr(), ujn.data_ptr(), dist.data_ptr(), nbr_idx.data_ptr(),
            None if edge_mask is None else edge_mask.data_ptr(),
            wd.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            out.data_ptr(), z.data_ptr() if want_z else None, ws.data_ptr(), g, a, k, f,
            KERNEL_M, _stream(ui),
        )
    build.check(lib, name, code)
    fused_edge_messages.launches += 1
    fused_edge_messages.launches_bf16 += ui.dtype == torch.bfloat16
    return out, z


def fused_edge_messages_bwd(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm, z):
    """Kernel C: (dui, dujn, ddist, dwd, db0, dw1, db1) for the output
    gradient `dm` [G, A, k, m], on CUDA tensors only: on the CPU autograd
    differentiates `fused_edge_messages_plain` itself, and
    `fused_edge_messages_bwd_plain` is the same backward for other callers.
    `z` [G, A, k, m] is the forward's pre-activation of the last SiLU, as
    kernel B writes it (`_launch_fwd(..., want_z=True)`), in float32 in
    either dtype; the input gradients come in ui's dtype, the parameters'
    in float32."""
    if ui.device.type != "cuda":
        raise ValueError(f"fused_edge_messages_bwd: unsupported device {ui.device}")
    _check(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm, z)
    g, a, f = ui.shape
    k = nbr_idx.shape[-1]
    lib = build.library()
    sfx = _SUFFIX[ui.dtype]
    floats = ctypes.c_int64()
    code = getattr(lib, f"edge_mlp_bwd_workspace_{sfx}")(g, a, k, f, KERNEL_M,
                                                          ctypes.byref(floats))
    build.check(lib, f"edge_mlp_bwd_workspace_{sfx}", code)
    opts = dict(dtype=torch.float32, device=ui.device)
    act = dict(dtype=ui.dtype, device=ui.device)  # the input gradients' dtype
    dui, dujn = torch.empty((g, a, f), **act), torch.empty((g, a, f), **act)
    ddist = torch.empty((g, a, k), **act)
    dparams = torch.empty(f * (KERNEL_M + 2) + KERNEL_M, **opts)
    ws = torch.empty(floats.value, **opts)
    with torch.cuda.device(ui.device):
        code = getattr(lib, f"edge_mlp_bwd_{sfx}")(
            ui.data_ptr(), ujn.data_ptr(), dist.data_ptr(), nbr_idx.data_ptr(),
            wd.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), dm.data_ptr(),
            z.data_ptr(), dui.data_ptr(), dujn.data_ptr(),
            ddist.data_ptr(), dparams.data_ptr(), ws.data_ptr(), g, a, k, f, KERNEL_M,
            _stream(ui),
        )
    build.check(lib, f"edge_mlp_bwd_{sfx}", code)
    fused_edge_messages_bwd.launches += 1
    fused_edge_messages_bwd.launches_bf16 += ui.dtype == torch.bfloat16
    dw1, dwd, db0, db1 = torch.split(dparams, [f * KERNEL_M, f, f, KERNEL_M])
    return dui, dujn, ddist, dwd, db0, dw1.view(f, KERNEL_M), db1


def _recorded(*tensors) -> bool:
    """Whether autograd records a call on these tensors (grad mode on and
    one of them requires a gradient); `ctx.needs_input_grad` alone does not
    tell, since it is set under no_grad too."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FusedEdgeMessages(torch.autograd.Function):
    """Kernel B forward, kernel C backward (JAX `_fused`'s custom VJP); z
    saved where `want_z` (autograd records the call); with `edge_mask`, C
    gets dm·mask."""

    @staticmethod
    def forward(ctx, ui, ujn, dist, nbr_idx, wd, b0, w1, b1, edge_mask, want_z):
        out, z = _launch_fwd(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, edge_mask=edge_mask,
                             want_z=want_z)
        ctx.save_for_backward(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, z, edge_mask)
        return out

    @staticmethod
    def backward(ctx, dm):
        *inputs, z, edge_mask = ctx.saved_tensors
        dm = dm.contiguous()
        if edge_mask is not None:
            dm = torch.where(edge_mask[..., None], dm, torch.zeros((), dtype=dm.dtype,
                                                                   device=dm.device))
        dui, dujn, ddist, dwd, db0, dw1, db1 = fused_edge_messages_bwd(*inputs, dm, z)
        return dui, dujn, ddist, None, dwd, db0, dw1, db1, None, None


def fused_edge_messages(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, *, edge_mask=None):
    """silu(silu(ui ⊕ gather(ujn) + dist·wd + b0) @ w1 + b1) → [G, A, k, m],
    0 at the edges `edge_mask` drops."""
    if ui.device.type == "cpu":
        return fused_edge_messages_plain(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, edge_mask)
    if ui.device.type != "cuda":
        raise ValueError(f"fused_edge_messages: unsupported device {ui.device}")
    _check(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, edge_mask=edge_mask)
    # z only where autograd records the call: serving writes `out` alone
    return _FusedEdgeMessages.apply(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, edge_mask,
                                    _recorded(ui, ujn, dist, wd, b0, w1, b1))


fused_edge_messages.launches = fused_edge_messages.launches_bf16 = 0
fused_edge_messages_bwd.launches = fused_edge_messages_bwd.launches_bf16 = 0
