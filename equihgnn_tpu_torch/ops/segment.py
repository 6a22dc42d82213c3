"""Masked segment reductions over static-shape padded index arrays.

Port of `segment_sum`, `segment_mean`, `segment_max`, `segment_softmax` and
`masked_segment_reduce` (`equihgnn_tpu/ops/segment.py:24-107`). Padded
entries carry a False mask and contribute zero; the mask is applied before
summing. `reduce="mean"` divides by the member count and gives 0 for an
empty segment. `segment_max` treats a masked entry as `finfo.min` and gives
0 for a segment with no kept entry; its backward splits the gradient
evenly among tied maxima, as `lax.scatter_max`'s does (`scatter_reduce`
"amax" with `include_self=False` on an output filled with `finfo.min`).

`sorted_ids=True` (the hyperedge direction of the incidence arrays, sorted
by the batch builder) sends the sum to the sorted-segment-sum kernel
(`ops/kernels/segment_sum.py`). Unsorted ids (the vertex direction, the
graph pooling) stay on `index_add_`, as the JAX package leaves them to
`jax.ops.segment_sum` outside any Pallas kernel.

Sums of bfloat16 data are taken in float32 and rounded once to bfloat16,
on both routes (kernel A's function, `equihgnn_tpu/ops/pallas/
segment_sum.py:108-109`); `index_add_` into a bfloat16 buffer would round
at every add on the card (its atomics), where XLA's CPU scatter rounds at
every add too and the TPU's Pallas kernel does not. A mean's member count
is taken in the data's dtype, as in JAX (`equihgnn_tpu/ops/segment.py:41,
99`).
"""

from __future__ import annotations

import torch

from equihgnn_tpu_torch.ops.kernels.segment_sum import sorted_segment_sum


def _apply_mask(data: torch.Tensor, mask: torch.Tensor | None) -> torch.Tensor:
    if mask is None:
        return data
    return data * mask.to(data.dtype).reshape(mask.shape + (1,) * (data.ndim - 1))


def _broadcast(v: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape + (1,) * (data.ndim - v.ndim))


def segment_sum(data, segment_ids, num_segments: int, mask=None):
    """Masked segment sum. `data` [M, ...], `segment_ids` [M] → [num_segments, ...];
    a bfloat16 sum is taken in float32 and rounded once."""
    data = _apply_mask(data, mask)
    acc = torch.float32 if data.dtype == torch.bfloat16 else data.dtype
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]), dtype=acc, device=data.device)
    return out.index_add_(0, segment_ids, data.to(acc)).to(data.dtype)


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


def _raw_segment_max(data, segment_ids, num_segments: int, mask=None):
    """(per-segment max with masked entries at `finfo.min`, `finfo.min`);
    an empty segment keeps `finfo.min`."""
    neg = torch.finfo(data.dtype).min
    if mask is not None:
        data = torch.where(_broadcast(mask, data), data, neg)
    out = data.new_full((num_segments,) + tuple(data.shape[1:]), neg)
    idx = _broadcast(segment_ids, data).expand_as(data)
    return out.scatter_reduce(0, idx, data, "amax", include_self=False), neg


def segment_max(data, segment_ids, num_segments: int, mask=None):
    """Masked segment max; a segment with no kept entry maps to 0."""
    out, neg = _raw_segment_max(data, segment_ids, num_segments, mask)
    return torch.where(out <= neg / 2, 0.0, out)


def segment_softmax(logits, segment_ids, num_segments: int, mask=None):
    """Numerically stable softmax within each segment; masked entries get 0,
    and the denominator is clamped at 1e-16."""
    seg_max, neg = _raw_segment_max(logits, segment_ids, num_segments, mask)
    seg_max = torch.where(seg_max <= neg / 2, 0.0, seg_max)
    if mask is not None:
        logits = torch.where(_broadcast(mask, logits), logits, neg)
    ex = torch.exp(logits - seg_max.index_select(0, segment_ids))
    ex = _apply_mask(ex, mask)
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(denom.index_select(0, segment_ids), min=1e-16)


def masked_segment_reduce(
    data, segment_ids, num_segments: int, reduce: str, mask=None,
    sorted_ids: bool = False,
):
    """Dispatch on the reference's `aggr` strings {"sum", "add", "mean", "max"}."""
    if reduce == "max":
        return segment_max(data, segment_ids, num_segments, mask=mask)
    if reduce not in ("sum", "add", "mean"):
        raise ValueError(f"Unknown reduce: {reduce!r}")
    if sorted_ids:
        total = sorted_segment_sum(_apply_mask(data, mask), segment_ids, num_segments)
    else:
        total = segment_sum(data, segment_ids, num_segments, mask=mask)
    if reduce == "mean":
        return _divide_by_count(total, segment_ids, num_segments, mask)
    return total
