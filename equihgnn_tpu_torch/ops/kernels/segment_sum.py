"""Kernel A: segment sum over sorted segment ids (`csrc/segment_sum.cu`).

Replaces `equihgnn_tpu/ops/pallas/segment_sum.py` `sorted_segment_sum`,
forward only. `sorted_segment_sum` is the wrapper: a CPU tensor goes to
`sorted_segment_sum_plain`, a CUDA tensor to the kernel, which raises if
it cannot launch. `sorted_segment_sum.launches` counts kernel launches.

Contract: `segment_ids` is non-decreasing. The kernel relies on it and
does not check it; `pad_hypergraph_batch` checks it on the host, once per
batch. The JAX package's runtime window check and its fallback have no
counterpart here.
"""

from __future__ import annotations

import torch

from equihgnn_tpu_torch.ops.kernels import build


def sorted_segment_sum_plain(data: torch.Tensor, segment_ids: torch.Tensor,
                             num_segments: int) -> torch.Tensor:
    """out[s] = Σ_{i: ids[i] = s} data[i] with `index_add_` (any id order)."""
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


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
    if not (data.is_contiguous() and segment_ids.is_contiguous()):
        raise ValueError("sorted_segment_sum kernel takes contiguous tensors")
    if num_segments < 0 or data.shape[1] > 65535 * 32:
        raise ValueError(f"unsupported num_segments={num_segments} or D={data.shape[1]}")


def sorted_segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                       num_segments: int) -> torch.Tensor:
    """Segment sum for non-decreasing `segment_ids` → [num_segments, D]."""
    if data.device.type == "cpu":
        return sorted_segment_sum_plain(data, segment_ids, num_segments)
    if data.device.type != "cuda":
        raise ValueError(f"sorted_segment_sum: unsupported device {data.device}")
    _check(data, segment_ids, num_segments)
    m, d = data.shape
    out = torch.empty((num_segments, d), dtype=torch.float32, device=data.device)
    lib = build.library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        code = lib.sorted_segment_sum_f32(
            data.data_ptr(), segment_ids.data_ptr(), out.data_ptr(),
            m, d, num_segments, stream,
        )
    build.check(lib, "sorted_segment_sum_f32", code)
    sorted_segment_sum.launches += 1
    return out


sorted_segment_sum.launches = 0
