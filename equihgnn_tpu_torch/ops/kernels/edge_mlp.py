"""Kernel B: fused EGNN edge messages, forward (`csrc/edge_mlp.cu`).

Replaces `equihgnn_tpu/ops/pallas/edge_mlp.py` `fused_edge_messages`
(`_fwd_impl`/`_fwd_kernel`), forward only:

    out[g, a, kk] = silu(silu(ui[g, a] + ujn[g, idx[g, a, kk]]
                              + dist[g, a, kk]·wd + b0) @ w1 + b1)

`fused_edge_messages` is the wrapper, with the JAX function's argument
layout: ui/ujn [G, A, F], dist [G, A, k], nbr_idx [G, A, k] slot indices
into the A axis, wd/b0 [F], w1 [F, m], b1 [m] → [G, A, k, m]. A CPU tensor
goes to `fused_edge_messages_plain`; a CUDA tensor goes to the kernel,
which takes float32 and m = 16, or the wrapper raises. Contract: every
index lies in [0, A), as `knn_dense` gives them; the kernel does not check
it (that would need a device-to-host sync per call).
`fused_edge_messages.launches` counts kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from equihgnn_tpu_torch.ops.kernels import build

KERNEL_M = 16  # the kernel's message width (csrc/edge_mlp.cu M_OUT)
SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block can use


def fused_edge_messages_plain(ui, ujn, dist, nbr_idx, wd, b0, w1, b1):
    """The same function in plain PyTorch: materializes [G, A, k, F]."""
    g = torch.arange(ujn.shape[0], device=ujn.device)[:, None, None]
    uj = ujn[g, nbr_idx]  # [G, A, k, F]
    pre = ui[:, :, None, :] + uj + dist[..., None] * wd + b0
    return F.silu(torch.matmul(F.silu(pre), w1) + b1)


def _check(ui, ujn, dist, nbr_idx, wd, b0, w1, b1):
    named = dict(ui=ui, ujn=ujn, dist=dist, wd=wd, b0=b0, w1=w1, b1=b1)
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


def fused_edge_messages(ui, ujn, dist, nbr_idx, wd, b0, w1, b1):
    """silu(silu(ui ⊕ gather(ujn) + dist·wd + b0) @ w1 + b1) → [G, A, k, m]."""
    if ui.device.type == "cpu":
        return fused_edge_messages_plain(ui, ujn, dist, nbr_idx, wd, b0, w1, b1)
    if ui.device.type != "cuda":
        raise ValueError(f"fused_edge_messages: unsupported device {ui.device}")
    _check(ui, ujn, dist, nbr_idx, wd, b0, w1, b1)
    g, a, f = ui.shape
    k = nbr_idx.shape[-1]
    out = torch.empty((g, a, k, KERNEL_M), dtype=torch.float32, device=ui.device)
    lib = build.library()
    with torch.cuda.device(ui.device):
        stream = torch.cuda.current_stream(ui.device).cuda_stream
        code = lib.edge_mlp_fwd_f32(
            ui.data_ptr(), ujn.data_ptr(), dist.data_ptr(), nbr_idx.data_ptr(),
            wd.data_ptr(), b0.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            out.data_ptr(), g, a, k, f, KERNEL_M, stream,
        )
    build.check(lib, "edge_mlp_fwd_f32", code)
    fused_edge_messages.launches += 1
    return out


fused_edge_messages.launches = 0
