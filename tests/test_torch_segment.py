"""Port's segment reductions vs the JAX package, and the sorted-ids contract.

Inputs are drawn with numpy and fed to both sides. On the CPU the port's
`sorted_segment_sum` wrapper takes its plain version; the JAX side runs
its Pallas kernel in interpret mode (`sorted_segment_sum`) or its XLA
segment sum (`masked_segment_reduce` off the TPU). Tolerance: f32 sums of
a few terms in another order, atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equihgnn_tpu.ops.pallas.segment_sum import sorted_segment_sum as jax_sorted_segment_sum
from equihgnn_tpu.ops.segment import masked_segment_reduce as jax_masked_segment_reduce
from equihgnn_tpu_torch.data.batching import BatchSpec, pad_hypergraph_batch
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.ops.kernels.segment_sum import (
    sorted_segment_sum,
    sorted_segment_sum_plain,
)
from equihgnn_tpu_torch.ops.segment import masked_segment_reduce

torch.set_num_threads(1)

ATOL = 1e-6


def _inputs(seed, m=300, s=120, d=7, sort=True):
    """Data, ids with empty segments (every third id unused), a mask with
    False rows."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(0, s, 3), size=m)
    if sort:
        ids = np.sort(ids)
    data = rng.standard_normal((m, d)).astype(np.float32)
    mask = rng.random(m) < 0.8
    return data, ids.astype(np.int64), mask, s


@pytest.mark.parametrize("reduce", ["sum", "mean"])
def test_sorted_reduce_matches_jax(reduce):
    data, ids, mask, s = _inputs(0)
    got = masked_segment_reduce(
        torch.from_numpy(data), torch.from_numpy(ids), s, reduce,
        mask=torch.from_numpy(mask), sorted_ids=True,
    ).numpy()
    want = np.asarray(jax_masked_segment_reduce(
        jnp.asarray(data), jnp.asarray(ids, jnp.int32), s, reduce,
        mask=jnp.asarray(mask), sorted_ids=True,
    ))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    empty = np.setdiff1d(np.arange(s), ids[mask])
    assert len(empty) > 0 and np.all(got[empty] == 0.0)


def test_sorted_sum_matches_jax_pallas_kernel():
    """Port sum vs the Pallas kernel itself (interpret mode on the CPU)."""
    data, ids, mask, s = _inputs(1)
    masked = data * mask[:, None]
    got = masked_segment_reduce(
        torch.from_numpy(data), torch.from_numpy(ids), s, "sum",
        mask=torch.from_numpy(mask), sorted_ids=True,
    ).numpy()
    want = np.asarray(jax_sorted_segment_sum(
        jnp.asarray(masked), jnp.asarray(ids, jnp.int32), s
    ))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("reduce", ["sum", "add", "mean"])
def test_unsorted_reduce_matches_jax(reduce):
    data, ids, mask, s = _inputs(2, sort=False)
    got = masked_segment_reduce(
        torch.from_numpy(data), torch.from_numpy(ids), s, reduce,
        mask=torch.from_numpy(mask),
    ).numpy()
    want = np.asarray(jax_masked_segment_reduce(
        jnp.asarray(data), jnp.asarray(ids, jnp.int32), s, reduce,
        mask=jnp.asarray(mask),
    ))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_cpu_wrapper_takes_plain_version_without_launching():
    data, ids, _, s = _inputs(3)
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(torch.from_numpy(data), torch.from_numpy(ids), s)
    want = sorted_segment_sum_plain(torch.from_numpy(data), torch.from_numpy(ids), s)
    assert torch.equal(got, want)
    assert sorted_segment_sum.launches == before


def test_wrapper_rejects_other_devices():
    data = torch.zeros(4, 2, device="meta")
    ids = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        sorted_segment_sum(data, ids, 3)


def test_unknown_reduce_raises():
    data, ids, mask, s = _inputs(4)
    with pytest.raises(ValueError):
        masked_segment_reduce(torch.from_numpy(data), torch.from_numpy(ids), s, "max")


def test_pad_hypergraph_batch_rejects_unsorted_hedge_idx():
    samples = make_synthetic_dataset(3, seed=5, num_targets=1)
    spec = BatchSpec(num_graphs=4, num_atoms=128, num_hedges=128, nnz=256,
                     max_atoms_per_graph=32)
    pad_hypergraph_batch(samples, spec, with_pos=True)  # sorted: accepted
    s = samples[1]
    order = np.argsort(-s.hedge_idx, kind="stable")  # descending
    s.hedge_idx, s.vertex_idx = s.hedge_idx[order], s.vertex_idx[order]
    with pytest.raises(ValueError, match="non-decreasing"):
        pad_hypergraph_batch(samples, spec, with_pos=True)
