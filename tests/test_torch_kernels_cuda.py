"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where no CUDA device is available. On a
machine with an H100 (which has no JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

The shapes here are the edge cases that the serving shapes do not reach:
ragged F, k not a multiple of 4, a single slot, empty and trailing
segments, D not a multiple of 128, no rows at all.
"""

import pytest
import torch

from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
    fused_edge_messages,
    fused_edge_messages_plain,
)
from equihgnn_tpu_torch.ops.kernels.segment_sum import (
    sorted_segment_sum,
    sorted_segment_sum_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize(
    "m,s,d",
    [(300, 120, 7), (1000, 40, 130), (5, 1, 1), (0, 9, 16)],
)
def test_sorted_segment_sum_kernel(dev, m, s, d):
    gen = torch.Generator().manual_seed(m + s + d)
    # every other segment empty, including the first and the trailing ones
    ids = torch.sort(2 * torch.randint(0, max(s // 2, 1), (m,), generator=gen) + (s > 1)).values
    ids = ids.clamp(max=s - 1)
    data = torch.randn(m, d, generator=gen)
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(data.to(dev), ids.to(dev), s).cpu()
    assert sorted_segment_sum.launches == before + 1
    want = sorted_segment_sum_plain(data.double(), ids, s)
    scale = max(1.0, float(want.abs().max()))
    assert float((got.double() - want).abs().max()) <= 1e-5 * scale
    counts = torch.bincount(ids, minlength=s)
    assert torch.all(got[counts == 0] == 0)


@pytest.mark.parametrize(
    "g,a,k,f",
    [(3, 8, 5, 34), (5, 29, 16, 1026), (2, 1, 1, 3)],
)
def test_edge_mlp_kernel(dev, g, a, k, f):
    gen = torch.Generator().manual_seed(g * a + k + f)
    args = (
        torch.randn(g, a, f, generator=gen),
        torch.randn(g, a, f, generator=gen),
        torch.rand(g, a, k, generator=gen) * 4.0,
        torch.randint(0, a, (g, a, k), generator=gen),
        0.1 * torch.randn(f, generator=gen),
        0.1 * torch.randn(f, generator=gen),
        0.1 * torch.randn(f, 16, generator=gen),
        0.1 * torch.randn(16, generator=gen),
    )
    cuda_args = [t.to(dev) for t in args]
    before = fused_edge_messages.launches
    got = fused_edge_messages(*cuda_args)
    assert fused_edge_messages.launches == before + 1
    want = fused_edge_messages_plain(*cuda_args)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_edge_mlp_kernel_rejects_other_widths(dev):
    g, a, k, f = 2, 4, 3, 10
    args = [torch.randn(g, a, f), torch.randn(g, a, f), torch.rand(g, a, k),
            torch.randint(0, a, (g, a, k)), torch.randn(f), torch.randn(f),
            torch.randn(f, 8), torch.randn(8)]
    with pytest.raises(ValueError):
        fused_edge_messages(*[t.to(dev) for t in args])


def test_model_on_card_matches_cpu(dev):
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
    from equihgnn_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(mlp_hidden=16, output_hidden=8)
    samples = make_synthetic_dataset(8, seed=3, num_targets=1)
    batch = next(iter_batches(samples, spec_for_samples(samples, 8), with_pos=True))
    model = create_model("egnn_equihnns", num_target=1, cfg=cfg).eval()
    with torch.inference_mode():
        want = model(batch)
        sorted_segment_sum.launches = fused_edge_messages.launches = 0
        got = model.to(dev)(batch.to(dev)).cpu()
    assert fused_edge_messages.launches == 1
    assert sorted_segment_sum.launches == cfg.all_num_layers
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
