"""Kernels B and C: fused EGNN edge messages, forward and backward
(`csrc/edge_mlp.cu`).

Replaces `equihgnn_tpu/ops/pallas/edge_mlp.py` `fused_edge_messages`: its
forward `_fwd_impl`/`_fwd_kernel` (kernel B) and its custom VJP
`_vjp_bwd`/`_bwd_kernel` (kernel C):

    out[g, a, kk] = silu(silu(ui[g, a] + ujn[g, idx[g, a, kk]]
                              + dist[g, a, kk]·wd + b0) @ w1 + b1)

`fused_edge_messages` is the wrapper, with the JAX function's argument
layout: ui/ujn [G, A, F], dist [G, A, k], nbr_idx [G, A, k] slot indices
into the A axis, wd/b0 [F], w1 [F, m], b1 [m] → [G, A, k, m]. A CPU tensor
goes to `fused_edge_messages_plain`, which autograd traces. A CUDA tensor
goes through `_FusedEdgeMessages`, an `autograd.Function` whose forward is
kernel B and whose backward is kernel C (`fused_edge_messages_bwd`). Like
JAX's `_vjp_fwd` it saves only its inputs, never a [G, A, k, F] tensor, and
kernel C recomputes the pre-activation; `nbr_idx` gets no gradient. The
kernels take float32 and m = 16, or the wrapper raises. Contract: every
index lies in [0, A), as `knn_dense` gives them; the kernels do not check
it (that would need a device-to-host sync per call).
`fused_edge_messages.launches` and `fused_edge_messages_bwd.launches` count
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from equihgnn_tpu_torch.ops.kernels import build

KERNEL_M = 16  # the kernels' message width (csrc/edge_mlp.cu M_OUT)
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block can use
BW_COLS, BW_WARPS = 128, 4  # kernel C's f columns and warps per block (csrc)


def fused_edge_messages_plain(ui, ujn, dist, nbr_idx, wd, b0, w1, b1):
    """The same function in plain PyTorch: materializes [G, A, k, F]."""
    g = torch.arange(ujn.shape[0], device=ujn.device)[:, None, None]
    uj = ujn[g, nbr_idx]  # [G, A, k, F]
    pre = ui[:, :, None, :] + uj + dist[..., None] * wd + b0
    return F.silu(torch.matmul(F.silu(pre), w1) + b1)


def fused_edge_messages_bwd_plain(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm):
    """(dui, dujn, ddist, dwd, db0, dw1, db1): autograd through
    `fused_edge_messages_plain` for the output gradient `dm`."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (ui, ujn, dist, wd, b0, w1, b1)]
        out = fused_edge_messages_plain(*leaves[:3], nbr_idx, *leaves[3:])
        return torch.autograd.grad(out, leaves, dm)


def _check(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm=None):
    named = dict(ui=ui, ujn=ujn, dist=dist, wd=wd, b0=b0, w1=w1, b1=b1)
    if dm is not None:
        named["dm"] = dm
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"edge_mlp kernel takes float32 {name}, got {t.dtype}")
    if nbr_idx.dtype != torch.int64:
        raise TypeError(f"edge_mlp kernel takes int64 nbr_idx, got {nbr_idx.dtype}")
    for name, t in dict(named, nbr_idx=nbr_idx).items():
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
    if wd.shape != (f,) or b0.shape != (f,) or w1.shape != (f, KERNEL_M) or b1.shape != (KERNEL_M,):
        raise ValueError(
            f"edge_mlp kernel takes wd, b0 [{f}], w1 [{f}, {KERNEL_M}], b1 "
            f"[{KERNEL_M}]; got {tuple(wd.shape)}, {tuple(b0.shape)}, "
            f"{tuple(w1.shape)}, {tuple(b1.shape)}"
        )
    if (KERNEL_M + 2) * f * 4 > SMEM_LIMIT:
        raise ValueError(f"F = {f} needs more shared memory than a block has")
    if dm is not None:
        if dm.shape != (g, a, k, KERNEL_M):
            raise ValueError(f"dm must be [{g}, {a}, {k}, {KERNEL_M}], got {tuple(dm.shape)}")
        if (a * BW_COLS + k * (KERNEL_M + 2 + BW_WARPS)) * 4 > SMEM_LIMIT:
            raise ValueError(f"A = {a}, k = {k} need more shared memory than a block has")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch_fwd(ui, ujn, dist, nbr_idx, wd, b0, w1, b1):
    g, a, f = ui.shape
    k = nbr_idx.shape[-1]
    out = torch.empty((g, a, k, KERNEL_M), dtype=torch.float32, device=ui.device)
    lib = build.library()
    with torch.cuda.device(ui.device):
        code = lib.edge_mlp_fwd_f32(
            ui.data_ptr(), ujn.data_ptr(), dist.data_ptr(), nbr_idx.data_ptr(),
            wd.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            out.data_ptr(), g, a, k, f, KERNEL_M, _stream(ui),
        )
    build.check(lib, "edge_mlp_fwd_f32", code)
    fused_edge_messages.launches += 1
    return out


def fused_edge_messages_bwd(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm):
    """Kernel C: (dui, dujn, ddist, dwd, db0, dw1, db1) for the output
    gradient `dm` [G, A, k, m], on CUDA tensors only: on the CPU autograd
    differentiates `fused_edge_messages_plain` itself, and
    `fused_edge_messages_bwd_plain` is the same backward for other callers."""
    if ui.device.type != "cuda":
        raise ValueError(f"fused_edge_messages_bwd: unsupported device {ui.device}")
    _check(ui, ujn, dist, nbr_idx, wd, b0, w1, b1, dm)
    g, a, f = ui.shape
    k = nbr_idx.shape[-1]
    lib = build.library()
    floats = ctypes.c_int64()
    code = lib.edge_mlp_bwd_workspace_f32(g, a, k, f, KERNEL_M, ctypes.byref(floats))
    build.check(lib, "edge_mlp_bwd_workspace_f32", code)
    opts = dict(dtype=torch.float32, device=ui.device)
    dui, dujn = torch.empty((g, a, f), **opts), torch.empty((g, a, f), **opts)
    ddist = torch.empty((g, a, k), **opts)
    dparams = torch.empty(f * (KERNEL_M + 2) + KERNEL_M, **opts)
    ws = torch.empty(floats.value, **opts)
    with torch.cuda.device(ui.device):
        code = lib.edge_mlp_bwd_f32(
            ui.data_ptr(), ujn.data_ptr(), dist.data_ptr(), nbr_idx.data_ptr(),
            wd.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(), dm.data_ptr(),
            dui.data_ptr(), dujn.data_ptr(), ddist.data_ptr(), dparams.data_ptr(),
            ws.data_ptr(), g, a, k, f, KERNEL_M, _stream(ui),
        )
    build.check(lib, "edge_mlp_bwd_f32", code)
    fused_edge_messages_bwd.launches += 1
    dw1, dwd, db0, db1 = torch.split(dparams, [f * KERNEL_M, f, f, KERNEL_M])
    return dui, dujn, ddist, dwd, db0, dw1.view(f, KERNEL_M), db1


class _FusedEdgeMessages(torch.autograd.Function):
    """Kernel B forward, kernel C backward (JAX `_fused`'s custom VJP)."""

    @staticmethod
    def forward(ctx, ui, ujn, dist, nbr_idx, wd, b0, w1, b1):
        ctx.save_for_backward(ui, ujn, dist, nbr_idx, wd, b0, w1, b1)
        return _launch_fwd(ui, ujn, dist, nbr_idx, wd, b0, w1, b1)

    @staticmethod
    def backward(ctx, dm):
        dui, dujn, ddist, dwd, db0, dw1, db1 = fused_edge_messages_bwd(
            *ctx.saved_tensors, dm.contiguous())
        return dui, dujn, ddist, None, dwd, db0, dw1, db1


def fused_edge_messages(ui, ujn, dist, nbr_idx, wd, b0, w1, b1):
    """silu(silu(ui ⊕ gather(ujn) + dist·wd + b0) @ w1 + b1) → [G, A, k, m]."""
    if ui.device.type == "cpu":
        return fused_edge_messages_plain(ui, ujn, dist, nbr_idx, wd, b0, w1, b1)
    if ui.device.type != "cuda":
        raise ValueError(f"fused_edge_messages: unsupported device {ui.device}")
    _check(ui, ujn, dist, nbr_idx, wd, b0, w1, b1)
    return _FusedEdgeMessages.apply(ui, ujn, dist, nbr_idx, wd, b0, w1, b1)


fused_edge_messages.launches = 0
fused_edge_messages_bwd.launches = 0
