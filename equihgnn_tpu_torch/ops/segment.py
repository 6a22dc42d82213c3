"""Masked segment reductions over static-shape padded index arrays.

Port of `segment_sum`, `segment_mean` and `masked_segment_reduce`
(`equihgnn_tpu/ops/segment.py:24-107`). Padded entries carry a False mask
and contribute zero; the mask is applied before summing. `reduce="mean"`
divides by the member count and gives 0 for an empty segment.

`sorted_ids=True` (the hyperedge direction of the incidence arrays, sorted
by the batch builder) sends the sum to the sorted-segment-sum kernel
(`ops/kernels/segment_sum.py`). Unsorted ids (the vertex direction, the
graph pooling) stay on `index_add_`, as the JAX package leaves them to
`jax.ops.segment_sum` outside any Pallas kernel.
"""

from __future__ import annotations

import torch

from equihgnn_tpu_torch.ops.kernels.segment_sum import sorted_segment_sum


def _apply_mask(data: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return data
    return data * mask.to(data.dtype).reshape(mask.shape + (1,) * (data.ndim - 1))


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Masked segment sum. `data` [M, ...], `segment_ids` [M] → [num_segments, ...]."""
    data = _apply_mask(data, mask)
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    return out.index_add_(0, segment_ids, data)


def segment_count(segment_ids, num_segments: int, mask=None, dtype=torch.float32):
    ones = torch.ones(segment_ids.shape, dtype=dtype, device=segment_ids.device)
    return segment_sum(ones, segment_ids, num_segments, mask=mask)


def _divide_by_count(total, segment_ids, num_segments, mask):
    count = segment_count(segment_ids, num_segments, mask=mask, dtype=total.dtype)
    count = count.reshape(count.shape + (1,) * (total.ndim - 1))
    return total / torch.clamp(count, min=1.0)


def segment_mean(data, segment_ids, num_segments: int, mask=None):
    """Masked segment mean; empty segments map to 0."""
    total = segment_sum(data, segment_ids, num_segments, mask=mask)
    return _divide_by_count(total, segment_ids, num_segments, mask)


def masked_segment_reduce(
    data, segment_ids, num_segments: int, reduce: str, mask=None,
    sorted_ids: bool = False,
):
    """Dispatch on the reference's `aggr` strings {"sum", "add", "mean"}."""
    if reduce not in ("sum", "add", "mean"):
        raise ValueError(f"Unknown or unported reduce: {reduce!r}")
    if sorted_ids:
        total = sorted_segment_sum(_apply_mask(data, mask), segment_ids, num_segments)
    else:
        total = segment_sum(data, segment_ids, num_segments, mask=mask)
    if reduce == "mean":
        return _divide_by_count(total, segment_ids, num_segments, mask)
    return total
