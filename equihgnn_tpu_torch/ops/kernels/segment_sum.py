"""Kernel A: segment sum over sorted segment ids (`csrc/segment_sum.cu`).

Replaces `equihgnn_tpu/ops/pallas/segment_sum.py` `sorted_segment_sum`.
`sorted_segment_sum` is the wrapper: a CPU tensor goes to
`sorted_segment_sum_plain`, which autograd traces; a CUDA tensor goes
through `_SortedSegmentSum`, an `autograd.Function` whose forward is the
kernel (raising if it cannot launch) and whose backward is the gather
`grad_out[segment_ids]` in plain indexing, as the JAX custom VJP's `_bwd`
is plain XLA. `sorted_segment_sum.launches` counts kernel launches, in
either dtype: float32, or bfloat16 data summed in float32 and rounded
once to bfloat16 (JAX's `_pallas_forward`, `:92-109`);
`sorted_segment_sum.launches_bf16` counts the bfloat16 ones alone.

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
    cut off. bfloat16 data is summed into a float32 buffer and the sums
    rounded once, as JAX's kernel does (`_pallas_forward`, `:108-109`)."""
    acc = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
    out = torch.zeros((num_segments + 1,) + tuple(data.shape[1:]), dtype=acc,
                      device=data.device)
    inside = (segment_ids >= 0) & (segment_ids < num_segments)
    out.index_add_(0, torch.where(inside, segment_ids, num_segments), data.to(acc))
    return out[:num_segments].to(data.dtype)


def _check(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int):
    if data.dtype not in _ENTRY:
        raise TypeError(f"sorted_segment_sum kernel takes float32 or bfloat16 data, got {data.dtype}")
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


_ENTRY = {torch.float32: "sorted_segment_sum_f32", torch.bfloat16: "sorted_segment_sum_bf16"}


@functools.cache
def _entry(dtype: torch.dtype):
    lib = build.library()
    return lib, getattr(lib, _ENTRY[dtype])


def _launch(data: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """The kernel's output [num_segments, D] in the data's dtype; its float32
    workspace follows it in the same allocation, 16-byte aligned."""
    m, d = data.shape
    ws = 2 * -(-m // TILE_ROWS) * d
    out_bytes = data.element_size() * num_segments * d
    ws_at = -(-out_bytes // 16) * 16
    buf = torch.empty(ws_at + 4 * ws, dtype=torch.uint8, device=data.device)
    out = buf[:out_bytes].view(data.dtype).view(num_segments, d)
    lib, fn = _entry(data.dtype)
    code = fn(data.data_ptr(), segment_ids.data_ptr(), buf.data_ptr(), buf.data_ptr() + ws_at,
              ws, m, d, num_segments, torch._C._cuda_getCurrentRawStream(data.device.index))
    if code:
        build.check(lib, _ENTRY[data.dtype], code)
    sorted_segment_sum.launches += 1
    if data.dtype == torch.bfloat16:
        sorted_segment_sum.launches_bf16 += 1
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
    """Segment sum for non-decreasing `segment_ids` → [num_segments, D] in
    the data's dtype (float32 or bfloat16; a bfloat16 sum is taken in
    float32 and rounded once)."""
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, segment_ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {data.device}")
    _check(data, segment_ids, num_segments)
    return _SortedSegmentSum.apply(data, segment_ids, num_segments)


sorted_segment_sum.launches = 0
sorted_segment_sum.launches_bf16 = 0
