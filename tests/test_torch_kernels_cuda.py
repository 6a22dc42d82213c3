"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where no CUDA device is available. On a
machine with an H100 (which has no JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

The shapes here are the edge cases that the batch-768 shapes do not
reach: ragged F, k not a multiple of 4, a single slot, empty and trailing
segments, D not a multiple of 128, no rows at all. The autograd tests show
that a CUDA call of each wrapper is differentiable (its output has a
`grad_fn`) and gives the gradients of the plain version on the card.
Gradient tolerance: max |Δ| ≤ 1e-4·max |plain| + 1e-6 per tensor (f32 sums
in other orders; dW1 and the bias sums add up to G·A·k terms).
"""

import pytest
import torch

from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
    fused_edge_messages,
    fused_edge_messages_bwd,
    fused_edge_messages_bwd_plain,
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


def _assert_grad_close(got, want, name):
    err = float((got - want).abs().max()) if want.numel() else 0.0
    limit = 1e-4 * (float(want.abs().max()) if want.numel() else 0.0) + 1e-6
    assert err <= limit, f"{name}: max |d| {err:.3e} > {limit:.3e}"


def _edge_args(g, a, k, f, seed):
    gen = torch.Generator().manual_seed(seed)
    return (
        torch.randn(g, a, f, generator=gen),
        torch.randn(g, a, f, generator=gen),
        torch.rand(g, a, k, generator=gen) * 4.0,
        torch.randint(0, a, (g, a, k), generator=gen),
        0.1 * torch.randn(f, generator=gen),
        0.1 * torch.randn(f, generator=gen),
        0.1 * torch.randn(f, 16, generator=gen),
        0.1 * torch.randn(16, generator=gen),
    ), torch.randn(g, a, k, 16, generator=gen)


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
    args, _ = _edge_args(g, a, k, f, seed=g * a + k + f)
    cuda_args = [t.to(dev) for t in args]
    before = fused_edge_messages.launches
    got = fused_edge_messages(*cuda_args)
    assert fused_edge_messages.launches == before + 1
    want = fused_edge_messages_plain(*cuda_args)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_sorted_segment_sum_autograd(dev):
    """Kernel A inside its autograd.Function: the CUDA output carries a
    grad_fn, and the gather backward equals the plain version's gradient."""
    gen = torch.Generator().manual_seed(5)
    m, s, d = 500, 90, 40
    ids = torch.sort(torch.randint(0, s, (m,), generator=gen)).values.to(dev)
    data = torch.randn(m, d, generator=gen).to(dev)
    dout = torch.randn(s, d, generator=gen).to(dev)
    x = data.clone().requires_grad_()
    out = sorted_segment_sum(x, ids, s)
    assert out.grad_fn is not None
    out.backward(dout)
    x_ref = data.clone().requires_grad_()
    sorted_segment_sum_plain(x_ref, ids, s).backward(dout)
    _assert_grad_close(x.grad, x_ref.grad, "data")


def test_edge_mlp_autograd(dev):
    """Kernel B inside its autograd.Function: the CUDA output carries a
    grad_fn, and kernel C's gradients equal the plain version's."""
    args, dm = _edge_args(3, 8, 5, 34, seed=9)
    args, dm = [t.to(dev) for t in args], dm.to(dev)
    diff = [0, 1, 2, 4, 5, 6, 7]  # every input but nbr_idx
    leaves = [t.clone().requires_grad_() if i in diff else t for i, t in enumerate(args)]
    before = fused_edge_messages_bwd.launches
    out = fused_edge_messages(*leaves)
    assert out.grad_fn is not None
    out.backward(dm)
    assert fused_edge_messages_bwd.launches == before + 1
    ref = [t.clone().requires_grad_() if i in diff else t for i, t in enumerate(args)]
    fused_edge_messages_plain(*ref).backward(dm)
    for i in diff:
        _assert_grad_close(leaves[i].grad, ref[i].grad, f"input {i}")


@pytest.mark.parametrize(
    "g,a,k,f",
    [(3, 8, 5, 34), (5, 29, 16, 1026), (4, 32, 16, 130), (2, 1, 1, 3)],
)
def test_edge_mlp_bwd_kernel(dev, g, a, k, f):
    """Kernel C at a ragged F (34, 130: a partial 128-column chunk), k not a
    multiple of the forward's 4-neighbour tile, one slot, and the EGNN
    width F = 1026 at k = 16."""
    args, dm = _edge_args(g, a, k, f, seed=g * a + k + f)
    cuda_args, dm = [t.to(dev) for t in args], dm.to(dev)
    before = fused_edge_messages_bwd.launches
    got = fused_edge_messages_bwd(*cuda_args, dm)
    assert fused_edge_messages_bwd.launches == before + 1
    want = fused_edge_messages_bwd_plain(*cuda_args, dm)
    names = ("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1")
    for name, x, y in zip(names, got, want):
        assert x.shape == y.shape, name
        _assert_grad_close(x, y, name)


def test_edge_mlp_bwd_rejects_unsupported_shapes(dev):
    args, dm = _edge_args(2, 4, 3, 10, seed=1)
    cuda_args = [t.to(dev) for t in args]
    with pytest.raises(ValueError):  # dm of another shape
        fused_edge_messages_bwd(*cuda_args, dm[..., :8].contiguous().to(dev))
    big, big_dm = _edge_args(1, 512, 2, 4, seed=2)  # A·128 floats > shared memory
    with pytest.raises(ValueError):
        fused_edge_messages_bwd(*[t.to(dev) for t in big], big_dm.to(dev))


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


def test_model_grads_on_card_match_cpu(dev):
    """A train step's gradients: every parameter reached on the CPU (plain
    versions) is reached on the card (kernels A, B, C), with equal values."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.train.trainer import masked_mse

    cfg = ModelConfig(mlp_hidden=16, output_hidden=8)
    samples = make_synthetic_dataset(8, seed=3, num_targets=1)
    batch = next(iter_batches(samples, spec_for_samples(samples, 8), with_pos=True, target=0))

    def grads(device):
        model = create_model("egnn_equihnns", num_target=1, cfg=cfg,
                             generator=torch.Generator().manual_seed(1)).to(device)
        b = batch.to(device)
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        (sq / cnt.clamp(min=1.0)).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    want = grads("cpu")
    sorted_segment_sum.launches = fused_edge_messages.launches = 0
    fused_edge_messages_bwd.launches = 0
    got = grads(dev)
    assert (sorted_segment_sum.launches, fused_edge_messages.launches,
            fused_edge_messages_bwd.launches) == (cfg.all_num_layers, 1, 1)
    nonzero = {n for n, g in want.items() if bool(g.abs().max() > 0)}
    assert {"egnn_layer.edge_mlp_1.weight", "atom_encoder.atom.embedding",
            "trunk.conv.W1.lin_0.weight"} <= nonzero
    for name in nonzero:
        assert name in got and bool(got[name].abs().max() > 0), name
        _assert_grad_close(got[name].cpu(), want[name], name)
