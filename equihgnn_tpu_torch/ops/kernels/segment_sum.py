"""Kernel A: segment sum over sorted segment ids (`csrc/segment_sum.cu`).

Replaces `equihgnn_tpu/ops/pallas/segment_sum.py` `sorted_segment_sum`.
`sorted_segment_sum` is the wrapper: a CPU tensor goes to
`sorted_segment_sum_plain`, which autograd traces; a CUDA tensor goes
through `_SortedSegmentSum`, an `autograd.Function` whose forward is the
kernel (raising if it cannot launch) and whose backward is the gather
`grad_out[segment_ids]` in plain indexing, as the JAX custom VJP's `_bwd`
is plain XLA. `sorted_segment_sum.launches` counts kernel launches.

Contract: `segment_ids` is non-decreasing. The kernel relies on it and
does not check it; `pad_hypergraph_batch` checks it on the host, once per
batch. The JAX package's runtime window check and its fallback have no
counterpart here. Ids outside [0, num_segments) fall in no output row, as
in `jax.ops.segment_sum`.

The kernel's host path is kept short, since a call's device work is a few
tens of microseconds: the C entry is looked up once, the output and the
kernel's workspace (two partial rows per tile of `TILE_ROWS` rows) are one
allocation, and the call runs on the current device's current stream, read
as a raw handle (`torch.cuda.current_stream()` builds a Stream object at
each call; a tensor on another device raises instead of switching
devices).
"""

from __future__ import annotations

import functools

import torch

from equihgnn_tpu_torch.ops.kernels import build

TILE_ROWS = 32  # rows of a tile of the kernel (`TR` in csrc/segment_sum.cu)


def sorted_segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """out[s] = Σ_{i: ids[i] = s} data[i] with `index_add_` (any id order);
    rows whose id lies outside [0, num_segments) go to a spare row that is
    cut off."""
    out = data.new_zeros((num_segments + 1,) + tuple(data.shape[1:]))
    inside = (segment_ids >= 0) & (segment_ids < num_segments)
    return out.index_add_(0, torch.where(inside, segment_ids, num_segments), data)[:num_segments]


def _check(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    if data.dtype != torch.float32:
        raise TypeError(f"sorted_segment_sum kernel takes float32 data, got {data.dtype}")
    if segment_ids.dtype != torch.int64:
        raise TypeError(f"sorted_segment_sum kernel takes int64 ids, got {segment_ids.dtype}")
    if data.ndim != 2 or segment_ids.ndim != 1 or segment_ids.shape[0] != data.shape[0]:
        raise ValueError(
            f"sorted_segment_sum kernel takes data [M, D] and ids [M], got "
            f"{tuple(data.shape)} and {tuple(segment_ids.shape)}"
        )
    if segment_ids.device != data.device:
        raise ValueError("data and segment_ids lie on different devices")
    if data.device.index != torch.cuda.current_device():
        raise ValueError(f"sorted_segment_sum kernel runs on the current device "
                         f"(cuda:{torch.cuda.current_device()}), data lies on {data.device}")
    if not (data.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("sorted_segment_sum kernel takes contiguous tensors")
    if num_segments < 0:
        raise ValueError(f"unsupported num_segments={num_segments}")


@functools.cache
def _entry():
    lib = build.library()
    return lib, lib.sorted_segment_sum_f32


def _launch(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    m, d = data.shape
    ws = 2 * -(-m // TILE_ROWS) * d
    buf = torch.empty(num_segments * d + ws, dtype=torch.float32, device=data.device)
    out = buf[:num_segments * d].view(num_segments, d)
    lib, fn = _entry()
    code = fn(data.data_ptr(), segment_ids.data_ptr(), buf.data_ptr(),
              buf.data_ptr() + 4 * num_segments * d, ws, m, d, num_segments,
              torch._C._cuda_getCurrentRawStream(data.device.index))
    if code:
        build.check(lib, "sorted_segment_sum_f32", code)
    sorted_segment_sum.launches += 1
    return out


class _SortedSegmentSum(torch.autograd.Function):
    """Kernel A forward; backward the gather of JAX's `_bwd`."""

    @staticmethod
    def forward(ctx, data, segment_ids, num_segments):
        ctx.save_for_backward(segment_ids)
        return _launch(data, segment_ids, num_segments)

    @staticmethod
    def backward(ctx, grad_out):
        (segment_ids,) = ctx.saved_tensors
        return grad_out[segment_ids], None, None


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum for non-decreasing `segment_ids` → [num_segments, D]."""
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, segment_ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {data.device}")
    _check(data, segment_ids, num_segments)
    return _SortedSegmentSum.apply(data, segment_ids, num_segments)


sorted_segment_sum.launches = 0
