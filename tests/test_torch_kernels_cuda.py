"""The port's CUDA kernels vs their plain PyTorch versions, on the card.

Marked `cuda`: every test skips where no CUDA device is available. On a
machine with an H100 (which has no JAX, hence `--noconftest`):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

The shapes here are the edge cases that the batch-768 shapes do not
reach: ragged F, k not a multiple of 4, a single slot, empty and trailing
segments, D not a multiple of 128, no rows at all, and k = 40 (kernel C:
two words of live-edge bits); kernel B with edge masks (random, all dead,
all live, whole slots dead: 0 at the dead edges, the live edges' bits as
without the mask, kernel C's gradients the same with z NaN at the dead
edges) and at rows on each side of its stage-width switches up to its
limit (A = 1,138 at k = 16; 1,139 raises); kernel C with kernel B's saved z and without
it (computed again: the same bits), and kernels C and E with the output
gradient at every edge or position, 0 on a mask as the models pass it, 0
on a whole slot or one position, and 0 everywhere (a zero-gradient edge or
position is skipped: 0 in its ddist or dx), each the same bits twice; for
kernel A at D = 256
also no segments, empty segments at the start, in the middle and at the
end, one segment of 5,000 rows (across ~160 row tiles), ids ≥ S (in no
row) and every id equal, each the same bits twice; for kernels D and E an
odd P, C = 3 and 4, every H/2 the kernels take, and dropout on and off
(the same seed gives the same mask in the kernels and the plain version),
kernel D also on the "offset" inputs at every (C, H/2) and over ~12
grid-stride rounds a warp;
for kernels F-I masked edges (H also every edge masked, where it writes
+0, and none), an all-empty padding row, A < k (the
neighbour axis padded with masked edges, as `knn_dense` pads it), L = 3
and 8, h not a multiple of 32 and a strided s1, G and I also over
clusters of 1, 2 and 8 blocks a row and two turns of one (h = 288), with
all-masked rows and source slots no edge leads to, and at the largest slot
axis all four take (A = 142 at L = 8, k = 17; 143 raises); for kernels J and K
C = 1, 3, 5, k = 0, 4, 16, a site count G·A that fills no row tile
exactly, and ragged I, F and O, and J with live-site masks (random, all
dead, all live, C = 3 across tile edges, k = 0): 0 at the dead sites, the
same bits twice, and K's gradients on dout · live through autograd; K with
the same live-site lists (against the plain backward on dout · live, 0 at
the dead sites, the same bits twice) and refusing a K (23) or C (64 at K =
22) its shared memory cannot take, or an F over 128; for
kernels L and M the batch-768 shapes (G = 769, A = 32, K = 16, F = 128,
X = 64 and 192) in bfloat16 and float32, K = 0, 5 and 20, ragged F and X,
12,000 sites, many more than L's persistent grid has blocks, and sites
whose operands are all ±0 (L skips their products; M reads no dM there and
writes +0 while dM is random, also in a live site's ±0 neighbour rows); for
kernels J and K in bfloat16 the f32 cases' shapes and more (C = 2, 17; K
= 32; O = 384; G·A = 1,280), with live masks (random, all dead, all
live) and without, the same bits twice, +0 at the dead sites, and their
refusals (mixed types, K > 32, C > 64, a non-contiguous h, tc or dout). The autograd tests show
that a CUDA call of each wrapper is differentiable (its output has a
`grad_fn`) and gives the gradients of the plain version on the card.
Gradient tolerance: max |Δ| ≤ 1e-4·max |plain| + 1e-6 per tensor (f32 sums
in other orders; dW1 and the bias sums add up to G·A·k terms); kernels F
and H forward: 1e-5·max |plain| + 1e-6 per tensor; kernel J forward
1e-4·max |plain| + 1e-6 (sums of I·F = 32,768 products at the model's
widths). Kernels L and M in bfloat16: at least 99 % of the elements equal
to the plain version's and every one within one bfloat16 ulp (both round
an f32 sum once); in float32 within rtol = atol = 1e-5. Kernels J and K
in bfloat16: the same, K's dh and dtc within one ulp past the bound of
dM's rounding (`bwd_bf16_rounding_bound`: the kernel and the plain
version round dM from f32 sums in other orders). The bf16 model on
the card against the bf16 model on the CPU: predictions within the CPU's
own bfloat16-vs-float32 distance at the same weights, and the encoder's
gradients under a smooth loss (relative L2 over all parameters) within
half of it; cuBLAS's reduced-precision bf16 reductions are off for it.
Kernels A, B and C in bfloat16 against their plain bf16 versions: A and
B's out within one bf16 ulp (of max(|value|, max/256)) and at least 99 %
the same bits (A at the trunk's batch-768 shape, its edge cases and the
scalar path), B with every kind of edge mask and on both sides of each
stage-width switch up to its limit (A = 1,887 at k = 16; 1,888 raises); C
at least 99 % the same bits and within two ulps past the bound of dz's
rounding (`bwd_bf16_rounding_bound`), its f32 parameter gradients as
above, on both sides of each column-chunk switch up to its limit (A =
1,164; 1,165 raises); an odd F and a bf16 parameter raise. `egnn_equihnns`
and `mhnns` in bf16 at hidden 32 on the card against the CPU, as the
SE(3)-Transformer's. Kernels F-I in bfloat16 against their plain bf16
versions: within one bf16 ulp and at least 99 % the same bits, the same
bits twice, at `MIX_CASES`' kinds of input (h = 42 and 34 take the 4-byte
copies, h = 576 two turns of a cluster of 8), on both sides of G's and
I's staging switches (A = 77 / 109), of I's kept gw rows (every live row
kept to A = 30, some to A = 54, none above), with every edge of a row live
(I's kept rows full, and past them from A = 31) and at the rows' limit (A
= 170 at L = 8, k = 17; 171 raises); a mixed dtype or an odd h raises;
`visnet_equihnns` in bf16 at hidden 32 on the card against the CPU, F-I
on the bf16 counters and the trunk's A in f32. Kernels D and E in
bfloat16 against their plain bf16 versions (the f32 function of x.float()
and dout.float(), out and dx rounded once): out and dx within one bf16 ulp
and at least 99 % the same bits, E's f32 parameter gradients as above, at
`FS_CASES` (dropout 0 and 0.1: the same mask), every (C, H/2) on the
"offset" inputs, the mask probe, and E's zero-row skip; bf16 parameters,
float16 x or a dout of another dtype raise; `faformer_equihnns` in bf16 at
hidden 64 on the card against the CPU, D and E on the bf16 counters.
"""

import importlib.util
from pathlib import Path

import pytest
import torch

from equihgnn_tpu_torch.ops.kernels.edge_mlp import (
    _launch_fwd,
    bwd_bf16_rounding_bound,
    fused_edge_messages,
    fused_edge_messages_bwd,
    fused_edge_messages_bwd_plain,
    fused_edge_messages_plain,
)
from equihgnn_tpu_torch.ops.kernels.frame_swiglu import (
    frame_swiglu_bwd_plain,
    frame_swiglu_plain,
    fused_frame_swiglu,
    fused_frame_swiglu_bwd,
)
from equihgnn_tpu_torch.ops.kernels.pooled_conv import (
    bwd_bf16_rounding_bound as pc_rounding_bound,
)
from equihgnn_tpu_torch.ops.kernels.pooled_conv import (
    live_sites,
    pooled_conv,
    pooled_conv_bwd,
    pooled_conv_bwd_plain,
    pooled_conv_plain,
)
from equihgnn_tpu_torch.ops.kernels.pooled_m import (
    pooled_m,
    pooled_m_bwd,
    pooled_m_bwd_plain,
    pooled_m_plain,
)
from equihgnn_tpu_torch.ops.kernels.segment_sum import (
    sorted_segment_sum,
    sorted_segment_sum_plain,
)
from equihgnn_tpu_torch.ops.kernels.vis_mix import (
    vec_agg_bwd_plain,
    vec_agg_plain,
    vis_vec_agg,
    vis_vec_agg_bwd,
    vis_wdot,
    vis_wdot_bwd,
    wdot_bwd_plain,
    wdot_plain,
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


def _segment_case(name, gen):
    """(ids, S) of kernel A's edge cases at D = 256."""
    rand = lambda hi, n: torch.sort(torch.randint(0, hi, (n,), generator=gen)).values
    if name == "no_rows":
        return torch.zeros(0, dtype=torch.int64), 50
    if name == "no_segments":
        return rand(5, 300), 0
    if name == "empty_start_middle_end":  # ids 7 … 392 in steps of 3: all others empty
        return 7 + 3 * rand(129, 2000), 400
    if name == "one_segment_of_5000":
        return torch.cat([rand(20, 700), torch.full((5000,), 20), 21 + rand(600, 900)]), 700
    if name == "ids_at_or_above_s":
        return rand(120, 3000), 80
    if name == "every_id_equal":
        return torch.full((4000,), 3), 9
    raise ValueError(name)


@pytest.mark.parametrize("name", ["no_rows", "no_segments", "empty_start_middle_end",
                                  "one_segment_of_5000", "ids_at_or_above_s", "every_id_equal"])
def test_sorted_segment_sum_edge_cases(dev, name):
    """Kernel A against its plain version on the card at D = 256 (1e-5 of
    max(1, max |plain|)): every output row written once, 0 for an empty
    segment, nothing for ids outside [0, S); the same bits twice."""
    gen = torch.Generator().manual_seed(7)
    ids, s = _segment_case(name, gen)
    data = torch.randn(ids.shape[0], 256, generator=gen).to(dev)
    ids = ids.to(dev)
    got = sorted_segment_sum(data, ids, s)
    want = sorted_segment_sum_plain(data, ids, s)
    assert got.shape == want.shape == (s, 256)
    if s:
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-5 * scale
        counts = torch.bincount(ids[ids < s], minlength=s)
        assert torch.all(got[counts == 0] == 0)
    assert torch.equal(sorted_segment_sum(data, ids, s), got)


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


def _zero_grad_case(dm, kind, seed):
    """The output gradient of kernel C or E as `kind` leaves it: "rand" (or
    any other kind) as drawn; "mask" 0 on about half of its rows (edges or positions), as the
    models pass it; "slot" (kernel C: [G, A, k, m]) 0 on a whole slot's k
    rows and on every other row of another slot, or (kernel E: [P, H/2])
    one row 0; "zero" 0 everywhere."""
    gen = torch.Generator().manual_seed(seed)
    dm = dm.clone()
    if kind == "mask":
        dm *= (torch.rand(dm.shape[:-1], generator=gen) < 0.5).unsqueeze(-1)
    elif kind == "slot" and dm.ndim == 4:
        dm[0, 0] = 0.0
        dm[-1, -1, ::2] = 0.0
    elif kind == "slot":
        dm[dm.shape[0] // 2] = 0.0
    elif kind == "zero":
        dm.zero_()
    return dm


@pytest.mark.parametrize("kind", ["rand", "mask"])
def test_edge_mlp_autograd(dev, kind):
    """Kernel B inside its autograd.Function: the CUDA output carries a
    grad_fn, B saves z, and kernel C's gradients equal the plain version's
    and, bit for bit, kernel C's with z computed again by kernel B; with the gradient 0
    on half of the edges, as the model masks them, too."""
    args, dm = _edge_args(3, 8, 5, 34, seed=9)
    args, dm = [t.to(dev) for t in args], _zero_grad_case(dm, kind, 3).to(dev)
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
    recomputed = fused_edge_messages_bwd(*args, dm, _launch_fwd(*args, want_z=True)[1])
    for i, g in zip(diff, recomputed):
        assert torch.equal(leaves[i].grad, g), f"input {i}: z saved and computed again differ"


@pytest.mark.parametrize("kind", ["rand", "mask", "slot", "zero"])
@pytest.mark.parametrize(
    "g,a,k,f",
    [(3, 8, 5, 34), (5, 29, 16, 1026), (4, 32, 16, 130), (2, 1, 1, 3), (2, 6, 40, 20),
     (1, 223, 16, 130), (1, 224, 16, 130), (1, 448, 16, 130), (1, 449, 16, 130),
     (1, 897, 16, 130)],
)
def test_edge_mlp_bwd_kernel(dev, g, a, k, f, kind):
    """Kernel C at a ragged F (34, 130: a partial 128-column chunk), k not a
    multiple of the forward's 4-neighbour tile, one slot, the EGNN width
    F = 1026 at k = 16, k = 40 (two words of live-edge bits), and both sides
    of each switch of its column chunk at k = 16 (128 columns a block up to
    A = 223 slots, 64 up to 448, 32 up to 897); with the gradient at every
    edge, 0 on a mask, on a whole slot, or everywhere. A zero-gradient edge
    is skipped: 0 in its ddist. The same bits twice, and with z from a
    second launch of kernel B."""
    args, dm = _edge_args(g, a, k, f, seed=g * a + k + f)
    cuda_args = [t.to(dev) for t in args]
    dm = _zero_grad_case(dm, kind, seed=g + k).to(dev)
    _, z = _launch_fwd(*cuda_args, want_z=True)
    before = fused_edge_messages_bwd.launches
    got = fused_edge_messages_bwd(*cuda_args, dm, z)
    assert fused_edge_messages_bwd.launches == before + 1
    want = fused_edge_messages_bwd_plain(*cuda_args, dm)
    names = ("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1")
    for name, x, y in zip(names, got, want):
        assert x.shape == y.shape, name
        _assert_grad_close(x, y, name)
    assert torch.all(got[2][(dm == 0).all(-1)] == 0)
    if kind == "zero":
        assert all(torch.all(x == 0) for x in got)
    for name, x, y, w in zip(names, got, fused_edge_messages_bwd(*cuda_args, dm, z),
                             fused_edge_messages_bwd(*cuda_args, dm,
                                                     _launch_fwd(*cuda_args, want_z=True)[1])):
        assert torch.equal(x, y), f"{name}: other bits on a second call"
        assert torch.equal(x, w), f"{name}: z saved and computed again differ"


def test_edge_mlp_bwd_rejects_unsupported_shapes(dev):
    args, dm = _edge_args(2, 4, 3, 10, seed=1)
    cuda_args = [t.to(dev) for t in args]
    with pytest.raises(ValueError):  # dm of another shape
        fused_edge_messages_bwd(*cuda_args, dm[..., :8].contiguous().to(dev), dm.to(dev))
    big, big_dm = _edge_args(1, 1024, 2, 4, seed=2)  # A·32 floats twice > shared memory
    with pytest.raises(ValueError, match="A = 1024, k = 2"):
        fused_edge_messages_bwd(*[t.to(dev) for t in big], big_dm.to(dev), big_dm.to(dev))
    big, big_dm = _edge_args(1, 898, 16, 4, seed=3)  # one slot past the 32-column limit
    with pytest.raises(ValueError, match="A = 898, k = 16"):
        fused_edge_messages_bwd(*[t.to(dev) for t in big], big_dm.to(dev), big_dm.to(dev))


def _b_mask(kind, g, a, k, seed):
    """Kernel B's edge mask: "random" (about half live), "dead" (none),
    "live" (all), "slots" (random, every third slot and slot (0, 1) wholly
    dead, as the model's padding slots are)."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "dead":
        return torch.zeros(g, a, k, dtype=torch.bool)
    if kind == "live":
        return torch.ones(g, a, k, dtype=torch.bool)
    mask = torch.rand(g, a, k, generator=gen) < 0.5
    if kind == "slots":
        mask[:, ::3] = False
        mask[0, min(1, a - 1)] = False
    return mask


@pytest.mark.parametrize("kind", ["random", "dead", "live", "slots"])
@pytest.mark.parametrize("g,a,k,f", [(3, 8, 5, 34), (5, 29, 16, 1026), (2, 6, 40, 20),
                                     (4, 32, 16, 130)])
def test_edge_mlp_kernel_with_edge_mask(dev, g, a, k, f, kind):
    """Kernel B with an edge mask: within atol 1e-5 + rtol 1e-4 of the plain
    version (which zeroes the dead edges), exactly 0 at every dead edge, the
    same bits as without the mask at the live edges, the same bits twice
    and with z written; z at the live edges the unmasked call's z. Kernel C
    never reads z at a dead edge: with z NaN there, its gradients on dm·mask
    are the same bits, and they match the plain masked backward."""
    args, dm = _edge_args(g, a, k, f, seed=g * a + k + f + 7)
    cuda_args = [t.to(dev) for t in args]
    mask = _b_mask(kind, g, a, k, seed=g + k).to(dev)
    got = fused_edge_messages(*cuda_args, edge_mask=mask)
    want = fused_edge_messages_plain(*cuda_args, mask)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    assert torch.all(got[~mask] == 0)
    unmasked, z_all = _launch_fwd(*cuda_args, want_z=True)
    assert torch.equal(got[mask], unmasked[mask])
    assert torch.equal(got, fused_edge_messages(*cuda_args, edge_mask=mask))
    got_z, z = _launch_fwd(*cuda_args, edge_mask=mask, want_z=True)
    assert torch.equal(got, got_z)
    assert torch.equal(z[mask], z_all[mask])
    dm = dm.to(dev) * mask[..., None]
    z_nan = z.clone()
    z_nan[~mask] = float("nan")
    grads = fused_edge_messages_bwd(*cuda_args, dm, z)
    for name, x, y, w in zip(("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1"), grads,
                             fused_edge_messages_bwd(*cuda_args, dm, z_nan),
                             fused_edge_messages_bwd_plain(*cuda_args, dm, mask)):
        assert torch.equal(x, y), f"{name}: kernel C read z at a dead edge"
        _assert_grad_close(x, w, name)


@pytest.mark.parametrize("a", [223, 224, 300, 301, 448, 449, 617, 618, 897, 1138])
def test_edge_mlp_kernel_row_sizes(dev, a):
    """Kernel B on both sides of each switch of its stage width (64 columns
    up to A = 300 slots at k = 16, 32 up to 617, 16 up to 1,138) and at
    kernel C's switches and limit (223, 448, 897), with the model's kind of
    mask (whole dead slots): within atol 1e-5 + rtol 1e-4 of the plain
    version, and the same bits at the live edges as without the mask."""
    args, _ = _edge_args(1, a, 16, 130, seed=a)
    cuda_args = [t.to(dev) for t in args]
    mask = _b_mask("slots", 1, a, 16, seed=a).to(dev)
    got = fused_edge_messages(*cuda_args, edge_mask=mask)
    torch.testing.assert_close(got, fused_edge_messages_plain(*cuda_args, mask), atol=1e-5,
                               rtol=1e-4)
    assert torch.equal(got[mask], fused_edge_messages(*cuda_args)[mask])


def test_edge_mlp_kernel_rejects_rows_past_its_limit(dev):
    args, _ = _edge_args(1, 1139, 16, 4, seed=4)  # one slot past the 16-column stage
    with pytest.raises(ValueError, match="A = 1139, k = 16"):
        fused_edge_messages(*[t.to(dev) for t in args])


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


def _fs_args(p, c, h, seed):
    gen = torch.Generator().manual_seed(seed)
    return (
        torch.randn(p, c, generator=gen),
        0.3 * torch.randn(c, h, generator=gen),
        0.1 * torch.randn(h, generator=gen),
        1.0 + 0.2 * torch.randn(h // 2, generator=gen),
        0.1 * torch.randn(h // 2, generator=gen),
    ), torch.randn(p, h // 2, generator=gen)


FS_CASES = [(1001, 4, 256, 0.0), (1001, 3, 256, 0.1), (37, 3, 64, 0.0), (333, 4, 128, 0.1),
            (5, 4, 512, 0.0), (1, 3, 256, 0.1)]


@pytest.mark.parametrize("p,c,h,rate", FS_CASES)
def test_frame_swiglu_kernel(dev, p, c, h, rate):
    """Kernel D vs the plain version; with dropout, the same seed must give
    the same mask (a mask that differs in one value moves that row's
    LayerNorm by far more than the tolerance)."""
    args, _ = _fs_args(p, c, h, seed=p + c + h)
    cuda_args = [t.to(dev) for t in args]
    before = fused_frame_swiglu.launches
    got = fused_frame_swiglu(*cuda_args, drop_rate=rate, seed=11)
    assert fused_frame_swiglu.launches == before + 1
    want = frame_swiglu_plain(*cuda_args, drop_rate=rate, seed=11)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)
    if rate > 0.0 and p > 100:
        other = frame_swiglu_plain(*cuda_args, drop_rate=rate, seed=12)
        assert float((other - got).abs().max()) > 1e-2


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("hh", [32, 64, 128, 256])
def test_frame_swiglu_kernel_offset_statistics(dev, c, hh):
    """Kernel D's frame statistics (all 8 frames' sums, then their centred
    sums of squares, each in one butterfly) at every instance (C, H/2), on
    the "offset" inputs of kernel E's test (b1 + 10: each frame's mean is
    large against its spread, where a one-pass variance would cancel), with
    dropout off and on."""
    args, _ = _fs_args(777, c, 2 * hh, seed=c * hh)
    args = (*args[:2], args[2] + 10.0, *args[3:])
    cuda_args = [t.to(dev) for t in args]
    for rate in (0.0, 0.1):
        got = fused_frame_swiglu(*cuda_args, drop_rate=rate, seed=3)
        want = frame_swiglu_plain(*cuda_args, drop_rate=rate, seed=3)
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_frame_swiglu_kernel_over_grid_stride_rounds(dev):
    """Kernel D at a P that is no multiple of the warps and takes every warp
    of its resident grid through ~12 positions (each warp loads the next
    position's x ahead): within atol 1e-5 + rtol 1e-4, the same bits twice."""
    args, _ = _fs_args(24_611, 3, 256, seed=5)
    cuda_args = [t.to(dev) for t in args]
    got = fused_frame_swiglu(*cuda_args)
    torch.testing.assert_close(got, frame_swiglu_plain(*cuda_args), atol=1e-5, rtol=1e-4)
    assert torch.equal(got, fused_frame_swiglu(*cuda_args))


@pytest.mark.parametrize("kind", ["rand", "mask", "slot", "zero", "offset"])
@pytest.mark.parametrize("p,c,h,rate", FS_CASES)
def test_frame_swiglu_bwd_kernel(dev, p, c, h, rate, kind):
    """Kernel E with the gradient at every position, 0 on a mask (as the
    model passes it), 0 on one position, or 0 everywhere: a zero-gradient
    position is skipped, 0 in its dx; the same bits twice. "offset": b1 + 10,
    so that each frame's LayerNorm mean is large against its spread, where
    statistics from unshifted sums (E[y²] − μ²) would cancel."""
    args, dout = _fs_args(p, c, h, seed=p * c + h)
    if kind == "offset":
        args = (*args[:2], args[2] + 10.0, *args[3:])
    cuda_args = [t.to(dev) for t in args]
    dout = _zero_grad_case(dout, kind, seed=p + c).to(dev)
    before = fused_frame_swiglu_bwd.launches
    got = fused_frame_swiglu_bwd(*cuda_args, dout, rate, 11)
    assert fused_frame_swiglu_bwd.launches == before + 1
    want = frame_swiglu_bwd_plain(*cuda_args, dout, rate, 11)
    for name, x, y in zip(("dx", "dw1", "db1", "dls", "dlb"), got, want):
        assert x.shape == y.shape, name
        _assert_grad_close(x, y, name)
    assert torch.all(got[0][(dout == 0).all(-1)] == 0)
    if kind == "zero":
        assert all(torch.all(x == 0) for x in got)
    for x, y in zip(got, fused_frame_swiglu_bwd(*cuda_args, dout, rate, 11)):
        assert torch.equal(x, y)


def test_frame_swiglu_dropout_mask_is_the_plain_versions(dev):
    """Inputs that make every mask bit visible: SwiGLU values in [1.5, 4.5],
    distinct per frame, so a kept value dropped, or a swap between frames,
    moves the output by > 1e-2 (0.30 and 0.037 when one bit is changed in
    the plain version on the CPU); agreement within 1e-5 is bit-for-bit."""
    gen = torch.Generator().manual_seed(0)
    p, hh = 3001, 128
    x = 0.5 + torch.rand(p, 4, generator=gen)
    w1 = torch.cat([0.2 * torch.rand(4, hh, generator=gen) + 0.1,
                    0.02 * torch.randn(4, hh, generator=gen)], 1)
    b1 = torch.cat([torch.linspace(2.5, 3.5, hh), torch.ones(hh)])
    args = [t.to(dev) for t in (x, w1, b1, torch.ones(hh), torch.zeros(hh))]
    got = fused_frame_swiglu(*args, drop_rate=0.1, seed=13)
    torch.testing.assert_close(got, frame_swiglu_plain(*args, drop_rate=0.1, seed=13),
                               atol=1e-5, rtol=0)
    assert float((frame_swiglu_plain(*args, drop_rate=0.1, seed=14) - got).abs().max()) > 1e-2


@pytest.mark.parametrize("kind", ["rand", "mask"])
def test_frame_swiglu_bwd_is_deterministic(dev, kind):
    args, dout = _fs_args(5000, 4, 256, seed=3)
    cuda_args, dout = [t.to(dev) for t in args], _zero_grad_case(dout, kind, 4).to(dev)
    a = fused_frame_swiglu_bwd(*cuda_args, dout, 0.1, 5)
    b = fused_frame_swiglu_bwd(*cuda_args, dout, 0.1, 5)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["rand", "mask"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_frame_swiglu_autograd(dev, rate, kind):
    """Kernel D inside its autograd.Function: the CUDA output carries a
    grad_fn, and kernel E's gradients equal the plain version's, also with
    the gradient 0 on half of the positions."""
    args, dout = _fs_args(700, 4, 256, seed=9)
    args, dout = [t.to(dev) for t in args], _zero_grad_case(dout, kind, 5).to(dev)
    leaves = [t.clone().requires_grad_() for t in args]
    before = fused_frame_swiglu_bwd.launches
    out = fused_frame_swiglu(*leaves, drop_rate=rate, seed=4)
    assert out.grad_fn is not None
    out.backward(dout)
    assert fused_frame_swiglu_bwd.launches == before + 1
    ref = [t.clone().requires_grad_() for t in args]
    frame_swiglu_plain(*ref, drop_rate=rate, seed=4).backward(dout)
    for i, (x, y) in enumerate(zip(leaves, ref)):
        _assert_grad_close(x.grad, y.grad, f"input {i}")


def test_frame_swiglu_rejects_unsupported_shapes(dev):
    for p, c, h in ((10, 5, 256), (10, 4, 96), (10, 2, 64)):
        args, _ = _fs_args(p, c, h, seed=1)
        with pytest.raises(ValueError):
            fused_frame_swiglu(*[t.to(dev) for t in args])
    args, dout = _fs_args(10, 4, 64, seed=1)
    cuda_args = [t.to(dev) for t in args]
    with pytest.raises(TypeError):
        fused_frame_swiglu(cuda_args[0].double(), *cuda_args[1:])
    with pytest.raises(ValueError):  # w1 given as [H, C]
        fused_frame_swiglu(cuda_args[0], cuda_args[1].t(), *cuda_args[2:])
    with pytest.raises(ValueError):
        fused_frame_swiglu_bwd(*cuda_args, dout[:, :8].contiguous().to(dev))


def _faformer_setup():
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
    from equihgnn_tpu_torch.models.config import ModelConfig

    cfg = ModelConfig(mlp_hidden=64, output_hidden=8)
    samples = make_synthetic_dataset(8, seed=3, num_targets=1)
    return cfg, next(iter_batches(samples, spec_for_samples(samples, 8), with_pos=True, target=0))


def _reset_counts():
    for fn in (sorted_segment_sum, fused_edge_messages, fused_edge_messages_bwd,
               fused_frame_swiglu, fused_frame_swiglu_bwd, vis_vec_agg, vis_vec_agg_bwd,
               vis_wdot, vis_wdot_bwd, pooled_conv, pooled_conv_bwd, pooled_m, pooled_m_bwd):
        fn.launches = 0


def test_faformer_on_card_matches_cpu(dev):
    from equihgnn_tpu_torch import create_model

    cfg, batch = _faformer_setup()
    model = create_model("faformer_equihnns", num_target=1, cfg=cfg).eval()
    with torch.inference_mode():
        want = model(batch)
        _reset_counts()
        got = model.to(dev)(batch.to(dev)).cpu()
    assert fused_frame_swiglu.launches == 5  # 3 EdgeModules + 2 FAFFNs
    assert sorted_segment_sum.launches == cfg.all_num_layers
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)


def test_faformer_grads_on_card_match_cpu(dev):
    """A train step's gradients in eval() mode (no dropout): every parameter
    reached on the CPU (plain versions) is reached on the card (kernels A,
    D, E), with equal values."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.train.trainer import masked_mse

    cfg, batch = _faformer_setup()

    def grads(device):
        model = create_model("faformer_equihnns", num_target=1, cfg=cfg,
                             generator=torch.Generator().manual_seed(1)).to(device).eval()
        b = batch.to(device)
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        (sq / cnt.clamp(min=1.0)).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    want = grads("cpu")
    _reset_counts()
    got = grads(dev)
    assert (fused_frame_swiglu.launches, fused_frame_swiglu_bwd.launches) == (5, 4)
    nonzero = {n for n, g in want.items() if bool(g.abs().max() > 0)}
    assert {"fa_former.edge_module.coord_mlp.fc1.weight", "fa_former.layers_0.ffn.W_frame.fc1.weight",
            "atom_encoder.atom.embedding", "trunk.conv.W1.lin_0.weight"} <= nonzero
    for name in nonzero:
        assert name in got and bool(got[name].abs().max() > 0), name
        _assert_grad_close(got[name].cpu(), want[name], name)


def _mix_args(g, a, k, L, h, seed, knn_pad=0):
    """vec, s1 (a strided view of a [.., 2h] tensor), s2m, d, idx, mask, u,
    vv; the last row empty; with `knn_pad`, the last `knn_pad` neighbour
    columns are masked index-0 padding, as knn_dense pads A < k."""
    gen = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(*shape, generator=gen)  # noqa: E731
    vec, u, vv = r(g, a, L, h), r(g, a, L, h), r(g, a, L, h)
    s1 = r(g, a, k, 2 * h)[..., :h]
    d = r(g, a, k, L)
    idx = torch.randint(0, a, (g, a, k), generator=gen)
    mask = torch.rand(g, a, k, generator=gen) > 0.25
    if knn_pad:
        idx[..., k - knn_pad:] = 0
        mask[..., k - knn_pad:] = False
    if g > 1:
        mask[-1] = False
    s2m = r(g, a, k, h) * mask[..., None]
    return vec, s1, s2m, d, idx, mask, u, vv


MIX_CASES = [(6, 32, 17, 8, 256, 0), (4, 10, 17, 8, 40, 7), (3, 5, 7, 3, 16, 0),
             (1, 3, 4, 8, 33, 0), (2, 1, 1, 3, 8, 0)]


@pytest.mark.parametrize("g,a,k,L,h,pad", MIX_CASES)
def test_vis_mix_kernels(dev, g, a, k, L, h, pad):
    """Kernels F and H against their plain versions, G and I against
    autograd through them."""
    vec, s1, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _mix_args(g, a, k, L, h, g + a + k,
                                                                        knn_pad=pad))
    before = (vis_vec_agg.launches, vis_wdot.launches)
    with torch.no_grad():
        va, wd = vis_vec_agg(vec, s1, s2m, d, idx, mask), vis_wdot(d, u, vv, idx, mask)
    assert (vis_vec_agg.launches, vis_wdot.launches) == (before[0] + 1, before[1] + 1)
    # per tensor: w_dot = uv − ud·vd·(2 − |d|²) cancels where it is small, so
    # its error scales with its largest terms, not with each value
    for name, x, y in (("F", va, vec_agg_plain(vec, s1, s2m, d, idx, mask)),
                       ("H", wd, wdot_plain(d, u, vv, idx, mask))):
        err, limit = float((x - y).abs().max()), 1e-5 * float(y.abs().max()) + 1e-6
        assert err <= limit, f"kernel {name}: max |d| {err:.3e} > {limit:.3e}"
    assert bool((wd[~mask] == 0).all())
    gen = torch.Generator().manual_seed(1)
    gva, gw = torch.randn(g, a, L, h, generator=gen).to(dev), torch.randn(g, a, k, h, generator=gen).to(dev)
    got = vis_vec_agg_bwd(vec, s1, s2m, d, idx, mask, gva)
    for name, x, y in zip(("dvec", "ds1", "ds2m", "dd"), got,
                          vec_agg_bwd_plain(vec, s1, s2m, d, idx, mask, gva)):
        assert x.shape == y.shape, name
        _assert_grad_close(x, y, f"G {name}")
    got = vis_wdot_bwd(d, u, vv, idx, mask, gw)
    for name, x, y in zip(("dd", "du", "dvv"), got, wdot_bwd_plain(d, u, vv, idx, mask, gw)):
        assert x.shape == y.shape, name
        _assert_grad_close(x, y, f"I {name}")


def test_vis_mix_bwd_is_deterministic(dev):
    vec, s1, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _mix_args(40, 32, 17, 8, 128, 3))
    idx[:, :, :8] = 0  # many edges onto one source slot
    gva, gw = torch.randn_like(vec), torch.randn(40, 32, 17, 128, device=dev)
    for a_, b_ in zip(vis_vec_agg_bwd(vec, s1, s2m, d, idx, mask, gva),
                      vis_vec_agg_bwd(vec, s1, s2m, d, idx, mask, gva)):
        assert torch.equal(a_, b_)
    for a_, b_ in zip(vis_wdot_bwd(d, u, vv, idx, mask, gw), vis_wdot_bwd(d, u, vv, idx, mask, gw)):
        assert torch.equal(a_, b_)


def test_vis_mix_autograd(dev):
    """Kernels F/H inside their autograd.Functions: CUDA outputs carry a
    grad_fn, G/I run once each, and d's two gradients add up as the plain
    version's; s1 is a view of the s_proj output, as in ViS_MP."""
    vec, _, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _mix_args(5, 12, 17, 8, 64, 8))
    s12 = torch.randn(5, 12, 17, 128, device=dev)
    r1, r2 = torch.randn(5, 12, 8, 64, device=dev), torch.randn(5, 12, 17, 64, device=dev)

    def run(fa, fw):
        leaves = [t.clone().requires_grad_() for t in (vec, s12, s2m, d, u, vv)]
        va = fa(leaves[0], leaves[1][..., :64], leaves[2], leaves[3], idx, mask)
        wd = fw(leaves[3], leaves[4], leaves[5], idx, mask)
        (torch.sum(va * r1) + torch.sum(wd * r2)).backward()
        return va, [t.grad for t in leaves]

    before = (vis_vec_agg_bwd.launches, vis_wdot_bwd.launches)
    va, got = run(vis_vec_agg, vis_wdot)
    assert va.grad_fn is not None
    assert (vis_vec_agg_bwd.launches, vis_wdot_bwd.launches) == (before[0] + 1, before[1] + 1)
    _, want = run(vec_agg_plain, wdot_plain)
    for name, x, y in zip(("vec", "s12", "s2m", "d", "u", "vv"), got, want):
        _assert_grad_close(x, y, name)


def test_vis_mix_rejects_unsupported_inputs(dev):
    vec, s1, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _mix_args(2, 6, 5, 8, 32, 1))
    with pytest.raises(ValueError):  # an index tensor left on the CPU
        vis_vec_agg(vec, s1, s2m, d, idx.cpu(), mask)
    with pytest.raises(ValueError):
        vis_wdot(d, u, vv.cpu(), idx, mask)
    with pytest.raises(TypeError):
        vis_vec_agg(vec.double(), s1, s2m, d, idx, mask)
    with pytest.raises(ValueError):  # L = 5
        vis_wdot(d[..., :5].contiguous(), u[:, :, :5].contiguous(), vv[:, :, :5].contiguous(),
                 idx, mask)
    with pytest.raises(ValueError):  # s2m not contiguous
        vis_vec_agg(vec, s1, s2m.transpose(1, 2).contiguous().transpose(1, 2), d, idx, mask)
    with pytest.raises(ValueError):  # s1 with rows not evenly strided
        vis_vec_agg(vec, s1.transpose(0, 1).contiguous().transpose(0, 1), s2m, d, idx, mask)
    with pytest.raises(ValueError):  # d of another k
        vis_vec_agg(vec, s1, s2m, d[:, :, :4].contiguous(), idx, mask)
    with pytest.raises(ValueError):  # an output gradient of another shape
        vis_wdot_bwd(d, u, vv, idx, mask, torch.zeros(2, 6, 5, 16, device=dev))
    big = _mix_args(1, 200, 17, 8, 32, 2)  # A·L·32 floats > shared memory
    with pytest.raises(RuntimeError, match="A = 200, k = 17, L = 8"):
        vis_vec_agg(*(t.to(dev) for t in big[:6]))
    # the refusal leaves no error behind for the next launch
    assert vis_vec_agg(vec, s1, s2m, d, idx, mask).shape == vec.shape


@pytest.mark.parametrize("kind", ["all", "none"])
def test_vis_wdot_kernel_all_or_no_edges_masked(dev, kind):
    """Kernel H with every edge masked (it writes +0 in every bit and reads
    no d and no vv: u and d are non-zero) and with none masked, against the
    plain version, the same bits twice."""
    _, _, _, d, idx, mask, u, vv = (t.to(dev) for t in _mix_args(6, 32, 17, 8, 256, 11))
    mask[:] = kind == "none"
    with torch.no_grad():
        got, want = vis_wdot(d, u, vv, idx, mask), wdot_plain(d, u, vv, idx, mask)
    err, limit = float((got - want).abs().max()), 1e-5 * float(want.abs().max()) + 1e-6
    assert err <= limit, f"kernel H: max |d| {err:.3e} > {limit:.3e}"
    if kind == "all":
        assert not got.view(torch.int32).any()
    else:
        assert bool((got != 0).any())
    assert torch.equal(vis_wdot(d, u, vv, idx, mask), got)


def _check_bwd(vec, s1, s2m, d, idx, mask, u, vv, seed):
    """Kernels G and I against their plain versions on these inputs."""
    gen = torch.Generator().manual_seed(seed)
    g, a, L, h = vec.shape
    gva = torch.randn(g, a, L, h, generator=gen).to(vec.device)
    gw = torch.randn(g, a, idx.shape[-1], h, generator=gen).to(vec.device)
    for name, x, y in zip(("dvec", "ds1", "ds2m", "dd"), vis_vec_agg_bwd(vec, s1, s2m, d, idx, mask, gva),
                          vec_agg_bwd_plain(vec, s1, s2m, d, idx, mask, gva)):
        _assert_grad_close(x, y, f"G {name}")
    for name, x, y in zip(("dd", "du", "dvv"), vis_wdot_bwd(d, u, vv, idx, mask, gw),
                          wdot_bwd_plain(d, u, vv, idx, mask, gw)):
        _assert_grad_close(x, y, f"I {name}")


@pytest.mark.parametrize("h", [32, 64, 256, 288])
def test_vis_mix_bwd_clusters_and_empty_sources(dev, h):
    """G and I over clusters of 1, 2 and 8 blocks a row (h = 32, 64, 256;
    at 288 the 9 chunks of a row take two turns of a cluster of 8), with a
    row whose edges are all masked, one whose edges all lead to slot 0 and
    source slots that no edge leads to."""
    vec, s1, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _mix_args(4, 12, 17, 8, h, h))
    idx[idx == 3] = 5  # slot 3 is no edge's source
    idx[1] = 0  # row 1: every edge leads to slot 0, the other slots to none
    mask[2] = False  # row 2: all masked (as the padding row 3)
    s2m = s2m * mask[..., None]
    _check_bwd(vec, s1, s2m, d, idx, mask, u, vv, h)


def test_vis_mix_kernels_at_the_largest_slot_axis(dev):
    """At L = 8, k = 17 a block of F or H holds a row of A ≤ 142 slots
    (shared memory), and G and I take the same rows (there they gather from
    device memory what a row of A ≤ 70 / 97 stages): at A = 142 all four
    kernels match their plain versions; one slot more, each of the four
    raises."""
    vec, s1, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _mix_args(2, 142, 17, 8, 40, 5))
    for name, x, y in (("F", vis_vec_agg(vec, s1, s2m, d, idx, mask),
                        vec_agg_plain(vec, s1, s2m, d, idx, mask)),
                       ("H", vis_wdot(d, u, vv, idx, mask), wdot_plain(d, u, vv, idx, mask))):
        err, limit = float((x - y).abs().max()), 1e-5 * float(y.abs().max()) + 1e-6
        assert err <= limit, f"kernel {name}: max |d| {err:.3e} > {limit:.3e}"
    _check_bwd(vec, s1, s2m, d, idx, mask, u, vv, 2)
    vec, s1, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _mix_args(1, 143, 17, 8, 32, 6))
    gw = torch.ones(1, 143, 17, 32, device=dev)
    for call in (lambda: vis_vec_agg(vec, s1, s2m, d, idx, mask),
                 lambda: vis_wdot(d, u, vv, idx, mask),
                 lambda: vis_vec_agg_bwd(vec, s1, s2m, d, idx, mask, torch.ones_like(vec)),
                 lambda: vis_wdot_bwd(d, u, vv, idx, mask, gw)):
        with pytest.raises(RuntimeError, match="A = 143, k = 17, L = 8"):
            call()


def test_visnet_on_card_matches_cpu(dev):
    """`visnet_equihnns` at hidden 32: the eval forward and a train step's
    gradients on the card (kernels A, F-I) against the CPU (plain versions);
    every parameter the CPU reaches is reached on the card."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.train.trainer import masked_mse

    _, batch = _faformer_setup()
    cfg = ModelConfig(mlp_hidden=32, output_hidden=8)

    def make(device):
        return create_model("visnet_equihnns", num_target=1, cfg=cfg,
                            generator=torch.Generator().manual_seed(1)).to(device)

    with torch.inference_mode():
        want = make("cpu").eval()(batch)
        _reset_counts()
        got = make(dev).eval()(batch.to(dev)).cpu()
    assert (vis_vec_agg.launches, vis_wdot.launches) == (6, 5)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)

    def grads(device):
        model = make(device)
        b = batch.to(device)
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        (sq / cnt.clamp(min=1.0)).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    want = grads("cpu")
    _reset_counts()
    got = grads(dev)
    assert (vis_vec_agg.launches, vis_wdot.launches, vis_vec_agg_bwd.launches,
            vis_wdot_bwd.launches) == (6, 5, 6, 5)
    nonzero = {n for n, g in want.items() if bool(g.abs().max() > 0)}
    assert {"visnet_layer.vis_mp_layers_1.w_src_proj.weight",
            "visnet_layer.embedding.atom.embedding", "trunk.conv.W1.lin_0.weight"} <= nonzero
    for name in nonzero:
        assert name in got and bool(got[name].abs().max() > 0), name
        _assert_grad_close(got[name].cpu(), want[name], name)


def _pc_args(g, a, k, c, i, f, o, seed):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(g, a, k, f, generator=gen), torch.randn(g, a, k, c * i, generator=gen),
            0.1 * torch.randn(f, o, i, generator=gen)), torch.randn(g, a, c, o, generator=gen)


PC_CASES = [(3, 23, 16, 1, 256, 128, 256), (3, 23, 16, 3, 256, 128, 256), (2, 29, 4, 5, 40, 24, 200),
            (5, 7, 0, 3, 16, 16, 64), (4, 32, 16, 1, 19, 13, 260), (1, 1, 4, 3, 8, 8, 8)]


@pytest.mark.parametrize("g,a,k,c,i,f,o", PC_CASES)
def test_pooled_conv_kernels(dev, g, a, k, c, i, f, o):
    """Kernel J against the plain version, kernel K against the plain
    backward; k = 0 gives zeros and a zero dW."""
    args, dout = _pc_args(g, a, k, c, i, f, o, seed=g + a + k + c)
    h, tc, w = (t.to(dev) for t in args)
    dout = dout.to(dev)
    before = (pooled_conv.launches, pooled_conv_bwd.launches)
    with torch.no_grad():
        got = pooled_conv(h, tc, w, c)
    want = pooled_conv_plain(h, tc, w, c)
    err, limit = float((got - want).abs().max()), 1e-4 * float(want.abs().max()) + 1e-6
    assert err <= limit, f"kernel J: max |d| {err:.3e} > {limit:.3e}"
    grads = pooled_conv_bwd(h, tc, w, c, dout)
    assert (pooled_conv.launches, pooled_conv_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, x, y in zip(("dh", "dtc", "dW"), grads, pooled_conv_bwd_plain(h, tc, w, c, dout)):
        assert x.shape == y.shape, name
        _assert_grad_close(x, y, f"K {name}")
    if k == 0:
        assert float(got.abs().max()) == float(grads[2].abs().max()) == 0.0


PC_LIVE_CASES = [  # (g, a, k, c, i, f, o, mask)
    (3, 23, 16, 1, 256, 128, 256, "random"), (4, 32, 16, 3, 256, 128, 256, "random"),
    (3, 23, 16, 1, 64, 32, 256, "all_dead"), (3, 23, 16, 3, 64, 32, 128, "all_live"),
    (7, 19, 5, 3, 40, 24, 200, "random"), (5, 7, 0, 3, 16, 16, 64, "random"),
]


def _live_mask(g, a, kind, seed):
    gen = torch.Generator().manual_seed(seed)
    if kind == "all_but_3":  # every site live but the last three: a known live count
        return torch.arange(g * a).reshape(g, a) < g * a - 3
    return {"random": torch.rand(g, a, generator=gen) < 0.5,
            "all_dead": torch.zeros(g, a, dtype=torch.bool),
            "all_live": torch.ones(g, a, dtype=torch.bool)}[kind]


@pytest.mark.parametrize("g,a,k,c,i,f,o,mask", PC_LIVE_CASES)
def test_pooled_conv_live_kernel(dev, g, a, k, c, i, f, o, mask):
    """Kernel J with live sites against the plain version (tc as given: J
    computes the live sites only, and 0 elsewhere), the same bits twice,
    one launch."""
    args, _ = _pc_args(g, a, k, c, i, f, o, seed=g + a + c)
    h, tc, w = (t.to(dev) for t in args)
    live = _live_mask(g, a, mask, seed=g + k).to(dev)
    before = pooled_conv.launches
    with torch.no_grad():
        got = pooled_conv(h, tc, w, c, live)
        again = pooled_conv(h, tc, w, c, live)
    assert pooled_conv.launches == before + 2
    want = pooled_conv_plain(h, tc, w, c, live)
    err, limit = float((got - want).abs().max()), 1e-4 * float(want.abs().max()) + 1e-6
    assert err <= limit, f"kernel J with live: max |d| {err:.3e} > {limit:.3e}"
    assert not got[~live].any()
    assert torch.equal(got, again)
    # the live-site list built once and passed in, as the model's conv does
    with torch.no_grad():
        assert torch.equal(pooled_conv(h, tc, w, c, live_sites(live)), got)


def test_pooled_conv_live_autograd(dev):
    """Autograd through J with live sites gives kernel K's gradients on
    dout · live, which are 0 at the dead sites for dh and dtc."""
    args, dout = _pc_args(6, 17, 16, 3, 64, 128, 96, seed=9)
    h, tc, w = (t.to(dev) for t in args)
    dout = dout.to(dev)
    live = _live_mask(6, 17, "random", seed=2).to(dev)
    leaves = [t.clone().requires_grad_() for t in (h, tc, w)]
    before = pooled_conv_bwd.launches
    pooled_conv(*leaves, 3, live).backward(dout)
    assert pooled_conv_bwd.launches == before + 1
    want = pooled_conv_bwd(h, tc, w, 3, dout, live)  # K with the same live-site list
    for name, leaf, y in zip(("dh", "dtc", "dW"), leaves, want):
        assert torch.equal(leaf.grad, y), name
    assert not leaves[0].grad[~live].any() and not leaves[1].grad[~live].any()
    for name, leaf, y in zip(("dh", "dtc", "dW"), leaves, pooled_conv_bwd_plain(
            h, tc, w, 3, dout * live[..., None, None])):
        _assert_grad_close(leaf.grad, y, name)


@pytest.mark.parametrize("g,a,k,c,i,f,o,mask", PC_LIVE_CASES)
def test_pooled_conv_bwd_live_kernel(dev, g, a, k, c, i, f, o, mask):
    """Kernel K with live sites (a `LiveSites`, as J's forward saves it)
    against the plain backward on dout · live; dh and dtc exactly 0 at the
    dead sites, whose tc and dout are not 0 here; the same bits twice."""
    args, dout = _pc_args(g, a, k, c, i, f, o, seed=g + a + c + 1)
    h, tc, w = (t.to(dev) for t in args)
    dout = dout.to(dev)
    live = _live_mask(g, a, mask, seed=g + k + 1).to(dev)
    sites = live_sites(live)
    before = pooled_conv_bwd.launches
    got = pooled_conv_bwd(h, tc, w, c, dout, sites)
    again = pooled_conv_bwd(h, tc, w, c, dout, sites)
    assert pooled_conv_bwd.launches == before + 2
    for name, x, y, z in zip(("dh", "dtc", "dW"), got,
                             pooled_conv_bwd_plain(h, tc, w, c, dout, live), again):
        assert x.shape == y.shape, name
        _assert_grad_close(x, y, f"K with live {name}")
        assert torch.equal(x, z), name
    assert not got[0][~live].any() and not got[1][~live].any()
    # a bare mask is turned into the same list
    assert all(torch.equal(x, y) for x, y in zip(pooled_conv_bwd(h, tc, w, c, dout, live), got))


def test_pooled_conv_bwd_rejects_unsupported_inputs(dev):
    """Kernel K refuses a K or C whose tiles its shared memory cannot take
    (dW stages two chunks of 32 rows' h and tc: K <= 22; the dM tile of one
    site of 64 rows at K = 22 is too large) and an F over 128, and a call
    afterwards runs."""
    (h23, tc23, w23), d23 = _pc_args(1, 2, 23, 1, 8, 128, 256, seed=4)
    with pytest.raises(RuntimeError, match="pooled_conv_bwd_f32 at K = 23"):
        pooled_conv_bwd(h23.to(dev), tc23.to(dev), w23.to(dev), 1, d23.to(dev))
    (h22, tc22, w22), d22 = _pc_args(1, 2, 22, 64, 8, 128, 256, seed=5)
    with pytest.raises(RuntimeError, match="pooled_conv_bwd_f32 at K = 22, C = 64"):
        pooled_conv_bwd(h22.to(dev), tc22.to(dev), w22.to(dev), 64, d22.to(dev))
    with pytest.raises(ValueError):  # a live mask of another shape
        pooled_conv_bwd(h22.to(dev), tc22.to(dev), w22.to(dev), 64, d22.to(dev),
                        torch.ones(2, 1, dtype=torch.bool, device=dev))
    # a thread keeps one (site, k) row of dh sums in registers: F <= 128
    (hf, tcf, wf), df = _pc_args(1, 2, 4, 1, 8, 136, 16, seed=7)
    with pytest.raises(RuntimeError, match="pooled_conv_bwd_f32 at K = 4, C = 1"):
        pooled_conv_bwd(hf.to(dev), tcf.to(dev), wf.to(dev), 1, df.to(dev))
    (h, tc, w), dout = _pc_args(2, 5, 22, 1, 8, 128, 256, seed=6)
    grads = pooled_conv_bwd(h.to(dev), tc.to(dev), w.to(dev), 1, dout.to(dev))
    for name, x, y in zip(("dh", "dtc", "dW"), grads, pooled_conv_bwd_plain(
            h.to(dev), tc.to(dev), w.to(dev), 1, dout.to(dev))):
        _assert_grad_close(x, y, name)


def test_pooled_conv_bwd_is_deterministic(dev):
    args, dout = _pc_args(40, 32, 16, 3, 256, 128, 256, seed=3)
    h, tc, w = (t.to(dev) for t in args)
    a_ = pooled_conv_bwd(h, tc, w, 3, dout.to(dev))
    b_ = pooled_conv_bwd(h, tc, w, 3, dout.to(dev))
    for x, y in zip(a_, b_):
        assert torch.equal(x, y)


def test_pooled_conv_autograd(dev):
    """Kernel J inside its autograd.Function: the CUDA output carries a
    grad_fn, K runs once, and W may be a strided slice (as the conv passes
    W[..., J])."""
    args, dout = _pc_args(6, 17, 16, 3, 64, 128, 96, seed=8)
    h, tc, w2 = args[0].to(dev), args[1].to(dev), torch.randn(128, 96, 64, 2).to(dev)
    dout = dout.to(dev)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (h, tc, w2)]
        out = fn(leaves[0], leaves[1], leaves[2][..., 1], 3)
        out.backward(dout)
        return out, [t.grad for t in leaves]

    before = pooled_conv_bwd.launches
    out, got = run(pooled_conv)
    assert out.grad_fn is not None and pooled_conv_bwd.launches == before + 1
    _, want = run(pooled_conv_plain)
    for name, x, y in zip(("h", "tc", "W"), got, want):
        _assert_grad_close(x, y, name)
    assert float(got[2][..., 0].abs().max()) == 0.0


def test_pooled_conv_rejects_unsupported_inputs(dev):
    args, dout = _pc_args(2, 5, 4, 3, 8, 8, 8, seed=1)
    h, tc, w = (t.to(dev) for t in args)
    with pytest.raises(TypeError):
        pooled_conv(h.double(), tc, w, 3)
    with pytest.raises(ValueError):  # tc of another C·I
        pooled_conv(h, tc[..., :20].contiguous(), w, 3)
    with pytest.raises(ValueError):  # tc not contiguous
        pooled_conv(h, tc.transpose(0, 1).contiguous().transpose(0, 1), w, 3)
    with pytest.raises(ValueError):  # C beyond a row tile
        pooled_conv(h, torch.zeros(2, 5, 4, 65 * 8, device=dev), w, 65)
    with pytest.raises(ValueError):  # an index tensor left on the CPU
        pooled_conv(h, tc.cpu(), w, 3)
    with pytest.raises(ValueError):
        pooled_conv_bwd(h, tc, w, 3, dout[..., :4].contiguous().to(dev))
    with pytest.raises(ValueError):  # a live mask of another shape
        pooled_conv(h, tc, w, 3, torch.ones(2, 4, dtype=torch.bool, device=dev))
    # J stages a chunk's K neighbours in shared memory: at C = 1 it takes K <= 22
    (h23, tc23, w23), _ = _pc_args(1, 2, 23, 1, 8, 8, 8, seed=2)
    with pytest.raises(RuntimeError, match="pooled_conv_fwd_f32 at K = 23"):
        pooled_conv(h23.to(dev), tc23.to(dev), w23.to(dev), 1)
    # the refusal leaves no error behind for the next launch
    assert pooled_conv(h, tc, w, 3).shape == (2, 5, 3, 8)


def test_se3_transformer_on_card_matches_cpu(dev):
    """`se3_transformer_equihnns` at hidden 32: the eval forward and a train
    step's gradients on the card (kernels A, J, K) against the CPU (plain
    versions); every parameter the CPU reaches is reached on the card."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.train.trainer import masked_mse

    _, batch = _faformer_setup()
    cfg = ModelConfig(mlp_hidden=32, output_hidden=8)

    def make(device):
        return create_model("se3_transformer_equihnns", num_target=1, cfg=cfg,
                            generator=torch.Generator().manual_seed(1)).to(device)

    with torch.inference_mode():
        want = make("cpu").eval()(batch)
        _reset_counts()
        got = make(dev).eval()(batch.to(dev)).cpu()
    assert (pooled_conv.launches, sorted_segment_sum.launches) == (4, cfg.all_num_layers)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-4)

    def grads(device):
        model = make(device)
        b = batch.to(device)
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        (sq / cnt.clamp(min=1.0)).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    want = grads("cpu")
    _reset_counts()
    got = grads(dev)
    assert (pooled_conv.launches, pooled_conv_bwd.launches) == (4, 4)
    nonzero = {n for n, g in want.items() if bool(g.abs().max() > 0)}
    assert {"se3_transformer_layer.conv_in.pair_0_1.radial_out_W",
            "se3_transformer_layer.conv_out.pair_1_0.radial_out_W",
            "atom_encoder.atom.embedding", "trunk.conv.W1.lin_0.weight"} <= nonzero
    for name in nonzero:
        assert name in got and bool(got[name].abs().max() > 0), name
        _assert_grad_close(got[name].cpu(), want[name], name)


def _pm_args(g, a, k, f, x, dtype, seed):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(dtype)
            for shape in ((g, a, k, f), (g, a, k, x), (g, a, x, f))]


def _assert_pm_close(got, want, name):
    assert got.dtype == want.dtype and got.shape == want.shape, name
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5, msg=name)
        return
    if not want.numel():
        return

    def ordered(t):  # bf16 bit patterns as ordered integers
        bits = t.view(torch.int16).to(torch.int32)
        return torch.where(bits < 0, -32768 - bits, bits)

    equal = float((got == want).float().mean())
    ulps = int((ordered(got) - ordered(want)).abs().max())
    assert equal >= 0.99 and ulps <= 1, f"{name}: {equal:.5f} equal, {ulps} ulps at most"


PM_CASES = [(769, 32, 16, 128, 64), (769, 32, 16, 128, 192), (3, 11, 5, 13, 9), (2, 3, 0, 16, 8),
            (1, 1, 16, 24, 200), (3000, 4, 16, 32, 16), (5, 9, 20, 40, 24)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("g,a,k,f,x", PM_CASES)
def test_pooled_m_kernels(dev, g, a, k, f, x, dtype):
    """Kernel L against the plain version and kernel M against the plain
    backward, the same bits on a second run, one launch each."""
    h, tc, dm = (t.to(dev) for t in _pm_args(g, a, k, f, x, dtype, seed=g + k + x))
    before = (pooled_m.launches, pooled_m_bwd.launches)
    with torch.no_grad():
        got = pooled_m(h, tc)
    _assert_pm_close(got, pooled_m_plain(h, tc), "L")
    grads = pooled_m_bwd(h, tc, dm)
    assert (pooled_m.launches, pooled_m_bwd.launches) == (before[0] + 1, before[1] + 1)
    for name, x_, y_ in zip(("dh", "dtc"), grads, pooled_m_bwd_plain(h, tc, dm)):
        _assert_pm_close(x_, y_, f"M {name}")
    with torch.no_grad():
        assert torch.equal(pooled_m(h, tc), got)
    for x_, y_ in zip(pooled_m_bwd(h, tc, dm), grads):
        assert torch.equal(x_, y_)
    if k == 0:
        assert float(got.float().abs().max()) == 0.0


def test_pooled_m_kernel_zero_sites(dev):
    """Sites whose h and tc are all ±0 (the SE(3)-Transformer's sites with no
    neighbour within the radius) skip kernel L's products: their M is +0
    in every bit, the plain version's value, and the other sites agree with
    the plain version as everywhere. Kernel M reads no dM there and writes
    +0 in every bit while dM is random and non-zero (signed zeros count as
    zeros; X = 64 takes one dM stage a site, 192 three); a live site whose
    last neighbour rows are ±0 gets +0 in those rows of dh and dtc; the
    same bits on a second run."""
    for x in (64, 192):
        h, tc, dm = (t.to(dev) for t in _pm_args(40, 32, 16, 128, x, torch.bfloat16, seed=4 + x))
        dead = (torch.rand(40, 32, generator=torch.Generator().manual_seed(5)) < 0.5).to(dev)
        dead[0, :2] = True
        dead[1, 0] = False
        h[dead], tc[dead] = 0.0, 0.0
        h[0, 0], tc[0, 1] = -0.0, -0.0  # signed zeros count as zeros
        h[1, 0, 9:], tc[1, 0, 9:] = -0.0, 0.0  # a live site with dead neighbour rows
        dm = torch.where(dm >= 0, dm + 0.5, dm - 0.5)  # non-zero everywhere
        assert bool((dm[dead] != 0).all())
        with torch.no_grad():
            got = pooled_m(h, tc)
        _assert_pm_close(got, pooled_m_plain(h, tc), "L")
        assert not got[dead].view(torch.int16).any()
        assert got[~dead].float().abs().max() > 0
        grads = pooled_m_bwd(h, tc, dm)
        for name, g_, want in zip(("dh", "dtc"), grads, pooled_m_bwd_plain(h, tc, dm)):
            _assert_pm_close(g_, want, f"M {name} X={x}")
            assert not g_[dead].view(torch.int16).any(), f"M {name} X={x}: not +0 at a dead site"
            assert not g_[1, 0, 9:].view(torch.int16).any(), f"M {name} X={x}: a dead row"
            assert g_[~dead].float().abs().max() > 0
        for a_, b_ in zip(pooled_m_bwd(h, tc, dm), grads):
            assert torch.equal(a_, b_)


def test_pooled_m_autograd(dev):
    """Kernel L inside its autograd.Function: the CUDA output carries a
    grad_fn, and kernel M runs once for the plain version's gradients."""
    h, tc, dm = (t.to(dev) for t in _pm_args(7, 9, 16, 128, 64, torch.bfloat16, seed=5))
    leaves = [t.clone().requires_grad_() for t in (h, tc)]
    before = pooled_m_bwd.launches
    out = pooled_m(*leaves)
    assert out.grad_fn is not None
    out.backward(dm)
    assert pooled_m_bwd.launches == before + 1
    for name, got, want in zip(("dh", "dtc"), (t.grad for t in leaves),
                               pooled_m_bwd_plain(h, tc, dm)):
        _assert_pm_close(got, want, name)


def test_pooled_m_rejects_unsupported_inputs(dev):
    h, tc, dm = (t.to(dev) for t in _pm_args(2, 5, 4, 8, 6, torch.bfloat16, seed=1))
    with pytest.raises(TypeError):
        pooled_m(h.half(), tc.half())
    with pytest.raises(TypeError):  # types mixed
        pooled_m(h, tc.float())
    with pytest.raises(ValueError):  # tc not contiguous
        pooled_m(h, tc.transpose(0, 1).contiguous().transpose(0, 1))
    with pytest.raises(ValueError):  # tc left on the CPU
        pooled_m(h, tc.cpu())
    with pytest.raises(ValueError):  # dM of another X
        pooled_m_bwd(h, tc, dm[:, :, :4].contiguous())
    with pytest.raises(RuntimeError):  # a site beyond a block's shared memory
        pooled_m(torch.zeros(1, 1, 64, 1024, dtype=torch.bfloat16, device=dev),
                 torch.zeros(1, 1, 64, 1024, dtype=torch.bfloat16, device=dev))


def _rel_l2(got: dict, want: dict) -> float:
    num = sum(float(((got[n].double().cpu() - want[n].double()) ** 2).sum()) for n in want)
    return (num / sum(float((w.double() ** 2).sum()) for w in want.values())) ** 0.5


def test_se3_transformer_bf16_on_card_matches_cpu(dev):
    """`se3_transformer_equihnns` in bfloat16 at hidden 32: kernels L (4 a
    forward, 8 a train step) and M (4 a step), never J or K, and every
    parameter the CPU reaches reached; the eval forward and the encoder's
    gradients under a smooth loss against the CPU's bf16 model (a step's
    gradients also cross the trunk's ReLU kinks, which bf16 moves)."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.train.trainer import masked_mse

    _, batch = _faformer_setup()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False

    def make(device, dtype="bfloat16"):
        cfg = ModelConfig(mlp_hidden=32, output_hidden=8, compute_dtype=dtype)
        return create_model("se3_transformer_equihnns", num_target=1, cfg=cfg,
                            generator=torch.Generator().manual_seed(1)).to(device)

    with torch.inference_mode():
        want, want32 = make("cpu").eval()(batch), make("cpu", None).eval()(batch)
        _reset_counts()
        got = make(dev).eval()(batch.to(dev)).cpu()
    assert (pooled_m.launches, pooled_conv.launches) == (4, 0)
    assert float((got - want).abs().max()) <= float((want - want32).abs().max())

    def grads(device, loss, dtype="bfloat16"):
        model = make(device, dtype)
        loss(model, batch.to(device)).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    def step(model, b):
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        return sq / cnt.clamp(min=1.0)

    proj = torch.randn(batch.num_atoms, 32, generator=torch.Generator().manual_seed(4))

    def encoder(model, b):
        return torch.sum(model.encode(b)[b.atom_mask] * proj.to(b.pos.device)[b.atom_mask])

    want = grads("cpu", step)
    _reset_counts()
    got = grads(dev, step)
    assert (pooled_m.launches, pooled_m_bwd.launches, pooled_conv.launches) == (8, 4, 0)
    nonzero = {n for n, g in want.items() if bool(g.abs().max() > 0)}
    assert {"se3_transformer_layer.conv_in.pair_0_1.radial_out_W",
            "atom_encoder.atom.embedding", "trunk.conv.W1.lin_0.weight"} <= nonzero
    for name in nonzero:
        assert name in got and bool(got[name].abs().max() > 0), name
    want, want32 = grads("cpu", encoder), grads("cpu", encoder, None)
    assert _rel_l2(grads(dev, encoder), want) <= 0.5 * _rel_l2(want, want32)


# ------------------------------------------------ kernels A, B and C in bfloat16


def bf16_ulp_distance(got, want):
    """Per element, |got − want| in bfloat16 ulps of max(|want|,
    max|want| / 256): an ulp of the value, floored at the ulp of 1/256 of
    the tensor's largest (an f32 sum that cancels to near 0 is resolved in
    the other f32 sum's order only to ~1e-6 of its terms, whichever
    framework rounds it)."""
    want, got = want.float(), got.float()
    top = float(want.abs().max()) if want.numel() else 0.0
    if top == 0.0:
        return (got - want).abs()
    mag = want.abs().clamp(min=top / 256)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return (got - want).abs() / ulp


def _assert_bf16_close(got, want, name, ulps=1, equal=0.99, slack=0.0):
    """bfloat16 outputs of a kernel and its plain version, both f32 sums
    rounded once: at least `equal` of the elements the same bits, every one
    within `ulps` bfloat16 ulps (`bf16_ulp_distance`) past `slack` (a
    bound per element of what an operand's rounding at another boundary
    can move it, or 0)."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, name
    if not want.numel():
        return
    same = float((got == want).float().mean())
    excess = ((got.float() - want.float()).abs() - slack).clamp(min=0)
    far = float(bf16_ulp_distance(want.float() + excess, want.float()).max())
    assert same >= equal and far <= ulps, f"{name}: {same:.5f} equal, {far:.2f} ulps at most"


def _bf16_edge_args(g, a, k, f, seed):
    args, dm = _edge_args(g, a, k, f, seed)
    return [t.to(torch.bfloat16) if i < 3 else t for i, t in enumerate(args)], \
        dm.to(torch.bfloat16)


@pytest.mark.parametrize("m,s,d", [(300, 120, 7), (1000, 40, 130), (5, 1, 1), (0, 9, 16),
                                   (29456, 13968, 256)])
def test_sorted_segment_sum_bf16_kernel(dev, m, s, d):
    """Kernel A in bfloat16 (f32 sums rounded once) against its plain
    version (`index_add_` into f32, then a cast): within one bf16 ulp, at
    least 99 % the same bits, 0 at the empty segments, the same bits twice;
    D = 7 and 130 take the kernel's scalar path, 256 its 8-byte one."""
    gen = torch.Generator().manual_seed(m + s + d)
    ids = torch.sort(2 * torch.randint(0, max(s // 2, 1), (m,), generator=gen) + (s > 1)).values
    ids = ids.clamp(max=s - 1).to(dev)
    data = torch.randn(m, d, generator=gen).to(torch.bfloat16).to(dev)
    before = sorted_segment_sum.launches
    got = sorted_segment_sum(data, ids, s)
    assert sorted_segment_sum.launches == before + 1 and got.dtype == torch.bfloat16
    _assert_bf16_close(got, sorted_segment_sum_plain(data, ids, s), "out")
    counts = torch.bincount(ids, minlength=s)
    assert torch.all(got[counts == 0] == 0)
    assert torch.equal(sorted_segment_sum(data, ids, s), got)


@pytest.mark.parametrize("name", ["no_rows", "no_segments", "empty_start_middle_end",
                                  "one_segment_of_5000", "ids_at_or_above_s", "every_id_equal"])
def test_sorted_segment_sum_bf16_edge_cases(dev, name):
    gen = torch.Generator().manual_seed(8)
    ids, s = _segment_case(name, gen)
    data = torch.randn(ids.shape[0], 256, generator=gen).to(torch.bfloat16).to(dev)
    ids = ids.to(dev)
    got = sorted_segment_sum(data, ids, s)
    _assert_bf16_close(got, sorted_segment_sum_plain(data, ids, s), name)
    assert torch.equal(sorted_segment_sum(data, ids, s), got)


def test_sorted_segment_sum_bf16_autograd(dev):
    gen = torch.Generator().manual_seed(6)
    ids = torch.sort(torch.randint(0, 90, (500,), generator=gen)).values.to(dev)
    data = torch.randn(500, 40, generator=gen).to(torch.bfloat16).to(dev).requires_grad_()
    dout = torch.randn(90, 40, generator=gen).to(torch.bfloat16).to(dev)
    sorted_segment_sum(data, ids, 90).backward(dout)
    assert data.grad.dtype == torch.bfloat16 and torch.equal(data.grad, dout[ids])


BF16_EDGE_CASES = [(3, 8, 5, 34), (5, 29, 16, 1026), (4, 32, 16, 130), (2, 6, 40, 20),
                   (2, 1, 1, 4)]


@pytest.mark.parametrize("kind", ["random", "dead", "live", "slots"])
@pytest.mark.parametrize("g,a,k,f", BF16_EDGE_CASES)
def test_edge_mlp_bf16_kernel(dev, g, a, k, f, kind):
    """Kernel B in bfloat16 against its plain version (a1 and W1 rounded to
    bf16, f32 sums): out within one bf16 ulp (`bf16_ulp_distance`), at least
    99 % the same bits; with and without the edge mask (0 at the dead edges,
    the live edges' bits as without it), z (f32) the same bits with the mask
    at the live edges and the same bits twice."""
    args, _ = _bf16_edge_args(g, a, k, f, seed=g * a + k + f)
    cuda_args = [t.to(dev) for t in args]
    mask = _b_mask(kind, g, a, k, seed=g + k).to(dev)
    before = fused_edge_messages.launches
    got = fused_edge_messages(*cuda_args, edge_mask=mask)
    assert fused_edge_messages.launches == before + 1 and got.dtype == torch.bfloat16
    _assert_bf16_close(got, fused_edge_messages_plain(*cuda_args, mask), "out")
    assert torch.all(got[~mask] == 0)
    unmasked, z_all = _launch_fwd(*cuda_args, want_z=True)
    _assert_bf16_close(unmasked, fused_edge_messages_plain(*cuda_args), "out, no mask")
    assert torch.equal(got[mask], unmasked[mask])
    got_z, z = _launch_fwd(*cuda_args, edge_mask=mask, want_z=True)
    assert torch.equal(got, got_z) and z.dtype == torch.float32
    assert torch.equal(z[mask], z_all[mask])
    assert torch.equal(got, fused_edge_messages(*cuda_args, edge_mask=mask))


def _assert_bf16_grads(got, want, args, dm, z):
    """Kernel C in bfloat16 against autograd through the plain bf16 forward:
    dui, dujn and ddist at least 99 % the same bits, each within two bf16
    ulps (`bf16_ulp_distance`) plus `bwd_bf16_rounding_bound` (C rounds dz
    from kernel B's z, the plain version from its own: a dz at a rounding
    boundary goes either way); the f32 parameter gradients within
    1e-4·max|plain| + 1e-6."""
    bounds = dict(zip(("dui", "dujn", "ddist"), bwd_bf16_rounding_bound(*args, dm, z)))
    for name, x, y in zip(("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1"), got, want):
        if name in bounds:
            assert x.dtype == y.dtype == torch.bfloat16 and x.shape == y.shape, name
            same = float((x == y).float().mean())
            excess = (x.float() - y.float()).abs() - bounds[name]
            far = float(bf16_ulp_distance(y.float() + excess.clamp(min=0), y.float()).max())
            assert same >= 0.99 and far <= 2, f"{name}: {same:.5f} equal, {far:.2f} ulps past"
        else:
            assert x.dtype == y.dtype == torch.float32, name
            _assert_grad_close(x, y, name)


@pytest.mark.parametrize("kind", ["rand", "mask", "slot", "zero"])
@pytest.mark.parametrize("g,a,k,f", BF16_EDGE_CASES + [(1, 276, 16, 130), (1, 277, 16, 130),
                                                        (1, 572, 16, 130), (1, 573, 16, 130)])
def test_edge_mlp_bwd_bf16_kernel(dev, g, a, k, f, kind):
    """Kernel C in bfloat16 with kernel B's z, on both sides of each switch
    of its column chunk at k = 16 (128 columns a block up to A = 276, 64 up
    to 572, 32 up to 1,164): within `_assert_bf16_grads` of the plain
    backward, 0 in ddist at a zero-gradient edge, the same bits twice."""
    args, dm = _bf16_edge_args(g, a, k, f, seed=g * a + k + f)
    cuda_args = [t.to(dev) for t in args]
    dm = _zero_grad_case(dm, kind, seed=g + k).to(dev)
    _, z = _launch_fwd(*cuda_args, want_z=True)
    before = fused_edge_messages_bwd.launches
    got = fused_edge_messages_bwd(*cuda_args, dm, z)
    assert fused_edge_messages_bwd.launches == before + 1
    _assert_bf16_grads(got, fused_edge_messages_bwd_plain(*cuda_args, dm), cuda_args, dm, z)
    assert torch.all(got[2][(dm == 0).all(-1)] == 0)
    if kind == "zero":
        assert all(torch.all(x == 0) for x in got)
    for x, y in zip(got, fused_edge_messages_bwd(*cuda_args, dm, z)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("kind", ["rand", "mask"])
def test_edge_mlp_bf16_autograd(dev, kind):
    """Kernels B and C in bfloat16 through the autograd.Function, with the
    model's kind of mask: the gradients of the plain version, and with z NaN
    at the dead edges the same bits (C never reads z there)."""
    args, dm = _bf16_edge_args(5, 29, 16, 1026, seed=11)
    args, dm = [t.to(dev) for t in args], dm.to(dev)
    mask = _b_mask("slots" if kind == "mask" else "live", 5, 29, 16, seed=2).to(dev)
    diff = [0, 1, 2, 4, 5, 6, 7]
    leaves = [t.clone().requires_grad_() if i in diff else t for i, t in enumerate(args)]
    out = fused_edge_messages(*leaves, edge_mask=mask)
    assert out.grad_fn is not None and out.dtype == torch.bfloat16
    out.backward(dm)
    want = fused_edge_messages_bwd_plain(*args, dm, mask)
    _, z = _launch_fwd(*args, edge_mask=mask, want_z=True)
    dmm = dm * mask[..., None]
    _assert_bf16_grads([leaves[i].grad for i in diff], want, args, dmm,
                       torch.where(mask[..., None], z, 0.0))
    z[~mask] = float("nan")
    for i, g in zip(diff, fused_edge_messages_bwd(*args, dmm, z)):
        assert torch.equal(leaves[i].grad, g), f"input {i}"


@pytest.mark.parametrize("a", [629, 630, 1148, 1149, 1164, 1887])
def test_edge_mlp_bf16_row_sizes(dev, a):
    """Kernel B in bfloat16 on both sides of each switch of its stage width
    (64 columns up to A = 629 slots at k = 16, 32 up to 1,148, 16 up to
    1,887, its limit), and kernel C at its limit (A = 1,164), with the
    model's kind of mask, against the plain versions."""
    args, dm = _bf16_edge_args(1, a, 16, 130, seed=a)
    cuda_args = [t.to(dev) for t in args]
    mask = _b_mask("slots", 1, a, 16, seed=a).to(dev)
    got = fused_edge_messages(*cuda_args, edge_mask=mask)
    _assert_bf16_close(got, fused_edge_messages_plain(*cuda_args, mask), "out")
    if a <= 1164:
        dm = dm.to(dev) * mask[..., None]
        _, z = _launch_fwd(*cuda_args, edge_mask=mask, want_z=True)
        z = torch.where(mask[..., None], z, 0.0)  # unwritten at the dead edges
        _assert_bf16_grads(fused_edge_messages_bwd(*cuda_args, dm, z),
                           fused_edge_messages_bwd_plain(*cuda_args, dm), cuda_args, dm, z)


def test_edge_mlp_bf16_rejects_what_it_does_not_take(dev):
    """One slot past B's limit (A = 1,888) or C's (A = 1,165), an odd F,
    and float32 parameters' partners in another dtype raise."""
    args, dm = _bf16_edge_args(1, 1888, 16, 4, seed=4)
    with pytest.raises(ValueError, match="A = 1888, k = 16"):
        fused_edge_messages(*[t.to(dev) for t in args])
    args, dm = _bf16_edge_args(1, 1165, 16, 4, seed=5)
    cuda_args = [t.to(dev) for t in args]
    with pytest.raises(ValueError, match="A = 1165, k = 16"):
        fused_edge_messages_bwd(*cuda_args, dm.to(dev), dm.float().to(dev))
    args, _ = _bf16_edge_args(2, 4, 3, 9, seed=6)
    with pytest.raises(ValueError, match="even F"):
        fused_edge_messages(*[t.to(dev) for t in args])
    args, _ = _bf16_edge_args(2, 4, 3, 10, seed=7)
    args[4] = args[4].to(torch.bfloat16)
    with pytest.raises(TypeError, match="wd"):
        fused_edge_messages(*[t.to(dev) for t in args])


@pytest.mark.parametrize("method", ["egnn_equihnns", "mhnns"])
def test_bf16_hypergraph_model_on_card_matches_cpu(dev, method):
    """`egnn_equihnns` and `mhnns` in bfloat16 at hidden 32: kernels A (3 a
    forward, in bf16), B (1) and C (1 a step) for the EGNN, A alone for
    mhnns; the eval forward against the CPU's bf16 model within the CPU's
    own bfloat16-vs-float32 distance, every parameter the CPU's step reaches
    reached, and the encoder's gradients under a smooth loss within half of
    that distance (relative L2 over all parameters)."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.train.trainer import masked_mse

    _, batch = _faformer_setup()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    egnn = method == "egnn_equihnns"

    def make(device, dtype="bfloat16"):
        cfg = ModelConfig(mlp_hidden=32, output_hidden=8, compute_dtype=dtype)
        return create_model(method, num_target=1, cfg=cfg,
                            generator=torch.Generator().manual_seed(1)).to(device)

    with torch.inference_mode():
        want, want32 = make("cpu").eval()(batch), make("cpu", None).eval()(batch)
        _reset_counts()
        got = make(dev).eval()(batch.to(dev)).cpu()
    assert got.dtype == torch.float32
    assert (sorted_segment_sum.launches, fused_edge_messages.launches) == (3, int(egnn))
    assert float((got - want).abs().max()) <= float((want - want32).abs().max())

    def grads(device, loss, dtype="bfloat16"):
        model = make(device, dtype)
        loss(model, batch.to(device)).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    def step(model, b):
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        return sq / cnt.clamp(min=1.0)

    proj = torch.randn(batch.num_atoms, 32, generator=torch.Generator().manual_seed(4))

    def encoder(model, b):
        return torch.sum(model.encode(b)[b.atom_mask].float() * proj.to(b.pos.device)[b.atom_mask])

    want = grads("cpu", step)
    _reset_counts()
    got = grads(dev, step)
    assert (sorted_segment_sum.launches, fused_edge_messages.launches,
            fused_edge_messages_bwd.launches) == (3, int(egnn), int(egnn))
    nonzero = {n for n, g in want.items() if bool(g.abs().max() > 0)}
    assert {"atom_encoder.atom.embedding", "trunk.conv.W2.lin_0.weight"} <= nonzero
    for name in nonzero:
        assert name in got and bool(got[name].abs().max() > 0), name
    if egnn:
        want, want32 = grads("cpu", encoder), grads("cpu", encoder, None)
        assert _rel_l2(grads(dev, encoder), want) <= 0.5 * _rel_l2(want, want32)


# ------------------------------------------------ kernels F-I in bfloat16


def _bf16_mix_args(g, a, k, L, h, seed, knn_pad=0):
    """`_mix_args` in bfloat16 (s1 still a strided view of a [.., 2h] tensor)."""
    vec, s1, s2m, d, idx, mask, u, vv = _mix_args(g, a, k, L, h, seed, knn_pad)
    bf = torch.bfloat16
    s12 = torch.cat([s1, torch.randn_like(s1)], dim=-1).to(bf)
    return vec.to(bf), s12[..., :h], s2m.to(bf), d.to(bf), idx, mask, u.to(bf), vv.to(bf)


def _check_bf16_mix(args, seed, equal=0.99):
    """F and H against their plain bf16 versions, G and I against theirs
    for random output gradients: within one bf16 ulp, at least `equal` the
    same bits, the same bits twice."""
    vec, s1, s2m, d, idx, mask, u, vv = args
    g, a, L, h = vec.shape
    gen = torch.Generator().manual_seed(seed)
    gva = torch.randn(g, a, L, h, generator=gen).to(torch.bfloat16).to(vec.device)
    gw = torch.randn(g, a, idx.shape[-1], h, generator=gen).to(torch.bfloat16).to(vec.device)
    cases = {
        "F": (lambda: (vis_vec_agg(vec, s1, s2m, d, idx, mask),),
              lambda: (vec_agg_plain(vec, s1, s2m, d, idx, mask),), ("vec_agg",)),
        "H": (lambda: (vis_wdot(d, u, vv, idx, mask),), lambda: (wdot_plain(d, u, vv, idx, mask),),
              ("w_dot",)),
        "G": (lambda: vis_vec_agg_bwd(vec, s1, s2m, d, idx, mask, gva),
              lambda: vec_agg_bwd_plain(vec, s1, s2m, d, idx, mask, gva),
              ("dvec", "ds1", "ds2m", "dd")),
        "I": (lambda: vis_wdot_bwd(d, u, vv, idx, mask, gw),
              lambda: wdot_bwd_plain(d, u, vv, idx, mask, gw), ("dd", "du", "dvv")),
    }
    with torch.no_grad():
        for letter, (call, plain, names) in cases.items():
            got, want = call(), plain()
            for name, x, y in zip(names, got, want):
                _assert_bf16_close(x, y, f"{letter} {name}", equal=equal)
            assert all(torch.equal(x, y) for x, y in zip(got, call())), letter


BF16_MIX_CASES = [(6, 32, 17, 8, 256, 0), (4, 10, 17, 8, 42, 7), (3, 5, 7, 3, 16, 0),
                  (1, 3, 4, 8, 34, 0), (2, 1, 1, 3, 8, 0), (4, 12, 17, 8, 576, 0)]


@pytest.mark.parametrize("g,a,k,L,h,pad", BF16_MIX_CASES)
def test_vis_mix_bf16_kernels(dev, g, a, k, L, h, pad):
    """Kernels F-I in bfloat16 against their plain bf16 versions (f32 sums in
    the kernels' order, rounded once; G's and I's per-edge terms of dvec and
    dvv rounded first): masked edges, an all-empty padding row, A < k, L = 3
    and 8, h not a multiple of 8 (the 4-byte copies) or of 64, a strided s1,
    G and I over clusters of 1, 4 and 8 blocks a row and two turns of one
    (h = 576); each launch on the bf16 counters as well."""
    args = [t.to(dev) for t in _bf16_mix_args(g, a, k, L, h, g + a + k + 1, knn_pad=pad)]
    for fn in (vis_vec_agg, vis_vec_agg_bwd, vis_wdot, vis_wdot_bwd):
        fn.launches = fn.launches_bf16 = 0
    _check_bf16_mix(args, h)
    for fn in (vis_vec_agg, vis_vec_agg_bwd, vis_wdot, vis_wdot_bwd):
        assert fn.launches == fn.launches_bf16 == 2, fn.__name__
    vec, s1, s2m, d, idx, mask, u, vv = args
    assert bool((vis_wdot(d, u, vv, idx, mask)[~mask] == 0).all())


def test_vis_mix_bf16_rows_at_each_switch_and_the_limit(dev):
    """At L = 8, k = 17 a bf16 block of F or H holds a row of A ≤ 170 slots
    (1,364 bytes a slot of shared memory; f32: 142); G stages vec and gva up
    to A = 77, I vv and u up to A = 109 (above that they gather from device
    memory); I keeps as many of a row's live gw rows as two blocks an SM
    leave room for: all A·K of them up to A = 30, fewer up to A = 54, none
    above: on both sides of each switch and at the limit all four match
    their plain versions; one slot past it, each raises."""
    for a in (30, 31, 54, 55, 77, 78, 109, 110, 170):
        _check_bf16_mix([t.to(dev) for t in _bf16_mix_args(2, a, 17, 8, 72, a)], a)
    vec, s1, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _bf16_mix_args(1, 171, 17, 8, 32, 6))
    gw = torch.ones(1, 171, 17, 32, dtype=torch.bfloat16, device=dev)
    for call in (lambda: vis_vec_agg(vec, s1, s2m, d, idx, mask),
                 lambda: vis_wdot(d, u, vv, idx, mask),
                 lambda: vis_vec_agg_bwd(vec, s1, s2m, d, idx, mask, torch.ones_like(vec)),
                 lambda: vis_wdot_bwd(d, u, vv, idx, mask, gw)):
        with pytest.raises(RuntimeError, match="A = 171, k = 17, L = 8"):
            call()
    # the refusal leaves no error behind for the next launch
    small = [t.to(dev) for t in _bf16_mix_args(2, 6, 5, 8, 32, 1)]
    assert vis_vec_agg(*small[:6]).dtype == torch.bfloat16


@pytest.mark.parametrize("a", [30, 31, 32, 54])
def test_vis_mix_bf16_rows_with_every_edge_live(dev, a):
    """A row whose A·K edges are all live: I's kept gw rows full at A = 30,
    and from A = 31 (the model's A = 32: 499 kept of 544) more live rows
    than it keeps, the rest read from device memory in both passes; each
    kernel against its plain version, the same bits twice."""
    args = [t.to(dev) for t in _bf16_mix_args(2, a, 17, 8, 72, a + 1)]
    args[5][0] = True  # row 0: every edge live
    _check_bf16_mix(args, a + 1)


def test_vis_mix_bf16_is_deterministic_with_many_edges_on_one_source(dev):
    args = [t.to(dev) for t in _bf16_mix_args(40, 32, 17, 8, 128, 3)]
    args[4][:, :, :8] = 0  # many edges onto one source slot
    _check_bf16_mix(args, 3)


def test_vis_mix_bf16_autograd(dev):
    """Kernels F-I in bfloat16 through the autograd.Functions (s1 a view of
    the s_proj output, as in ViS_MP) against the same Functions on the CPU
    (the plain bf16 forwards and backwards): each input's gradient within
    one bf16 ulp, d's two gradients added in bf16 on both."""
    vec, s1, s2m, d, idx, mask, u, vv = _bf16_mix_args(5, 12, 17, 8, 64, 8)
    s12 = s1._base if s1._base is not None else s1
    gen = torch.Generator().manual_seed(2)
    r1 = torch.randn(5, 12, 8, 64, generator=gen).to(torch.bfloat16)
    r2 = torch.randn(5, 12, 17, 64, generator=gen).to(torch.bfloat16)

    def run(device):
        leaves = [t.to(device).clone().requires_grad_() for t in (vec, s12, s2m, d, u, vv)]
        i, m = idx.to(device), mask.to(device)
        va = vis_vec_agg(leaves[0], leaves[1][..., :64], leaves[2], leaves[3], i, m)
        wd = vis_wdot(leaves[3], leaves[4], leaves[5], i, m)
        (torch.sum(va.float() * r1.to(device).float()) +
         torch.sum(wd.float() * r2.to(device).float())).backward()
        return va, [t.grad.cpu() for t in leaves]

    va, got = run(dev)
    assert va.grad_fn is not None and va.dtype == torch.bfloat16
    _, want = run("cpu")
    for name, x, y in zip(("vec", "s12", "s2m", "d", "u", "vv"), got, want):
        _assert_bf16_close(x, y, name)


def test_vis_mix_bf16_rejects_what_it_does_not_take(dev):
    vec, s1, s2m, d, idx, mask, u, vv = (t.to(dev) for t in _bf16_mix_args(2, 6, 5, 8, 32, 1))
    with pytest.raises(TypeError):  # one float32 input among bfloat16 ones
        vis_vec_agg(vec, s1, s2m.float(), d, idx, mask)
    with pytest.raises(TypeError):
        vis_wdot_bwd(d, u, vv, idx, mask, torch.zeros(2, 6, 5, 32, device=dev))
    odd = [t.to(dev) for t in _bf16_mix_args(2, 6, 5, 8, 33, 1)]
    with pytest.raises(ValueError, match="even h"):
        vis_vec_agg(*odd[:6])
    with pytest.raises(ValueError, match="even h"):
        vis_wdot(odd[3], odd[6], odd[7], odd[4], odd[5])


def test_visnet_bf16_on_card_matches_cpu(dev):
    """`visnet_equihnns` in bfloat16 at hidden 32: kernels F (6 a forward)
    and H (5), with G (6) and I (5) in a train step, all on the bf16
    counters, and the trunk's A in f32 (JAX's ViSNet returns f32 scalars to
    TrunkS); the eval forward against the CPU's bf16 model within the CPU's
    own bfloat16-vs-float32 distance, every parameter the CPU's step reaches
    reached, and the encoder's gradients under a smooth loss within half of
    that distance (relative L2 over all parameters)."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.train.trainer import masked_mse

    _, batch = _faformer_setup()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    mix = (vis_vec_agg, vis_wdot, vis_vec_agg_bwd, vis_wdot_bwd)

    def make(device, dtype="bfloat16"):
        cfg = ModelConfig(mlp_hidden=32, output_hidden=8, compute_dtype=dtype)
        return create_model("visnet_equihnns", num_target=1, cfg=cfg,
                            generator=torch.Generator().manual_seed(1)).to(device)

    def counts():
        return [(fn.launches, fn.launches_bf16) for fn in mix] + \
            [(sorted_segment_sum.launches, sorted_segment_sum.launches_bf16)]

    def reset():
        _reset_counts()
        for fn in (*mix, sorted_segment_sum):
            fn.launches_bf16 = 0

    with torch.inference_mode():
        want, want32 = make("cpu").eval()(batch), make("cpu", None).eval()(batch)
        reset()
        got = make(dev).eval()(batch.to(dev)).cpu()
    assert got.dtype == torch.float32
    assert counts() == [(6, 6), (5, 5), (0, 0), (0, 0), (3, 0)]
    assert float((got - want).abs().max()) <= float((want - want32).abs().max())

    def grads(device, loss, dtype="bfloat16"):
        model = make(device, dtype)
        loss(model, batch.to(device)).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    def step(model, b):
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        return sq / cnt.clamp(min=1.0)

    proj = torch.randn(batch.num_atoms, 32, generator=torch.Generator().manual_seed(4))

    def encoder(model, b):
        return torch.sum(model.encode(b)[b.atom_mask].float() * proj.to(b.pos.device)[b.atom_mask])

    want = grads("cpu", step)
    reset()
    got = grads(dev, step)
    assert counts() == [(6, 6), (5, 5), (6, 6), (5, 5), (3, 0)]
    nonzero = {n for n, g in want.items() if bool(g.abs().max() > 0)}
    assert {"visnet_layer.vis_mp_layers_1.w_src_proj.weight",
            "visnet_layer.embedding.atom.embedding", "trunk.conv.W1.lin_0.weight"} <= nonzero
    for name in nonzero:
        assert name in got and bool(got[name].abs().max() > 0), name
    want, want32 = grads("cpu", encoder), grads("cpu", encoder, None)
    assert _rel_l2(grads(dev, encoder), want) <= 0.5 * _rel_l2(want, want32)


# ------------------------------------------------ kernels D and E in bfloat16


def _fs_bf16_args(p, c, h, seed, offset=0.0):
    """`_fs_args` with x and dout in bfloat16 and the parameters float32, as
    the bf16 FAFormer passes them; `offset` added to b1."""
    (x, w1, b1, ls, lb), dout = _fs_args(p, c, h, seed)
    return (x.to(torch.bfloat16), w1, b1 + offset, ls, lb), dout.to(torch.bfloat16)


@pytest.mark.parametrize("p,c,h,rate", FS_CASES)
def test_frame_swiglu_bf16_kernel(dev, p, c, h, rate):
    """bf16 D against its plain bf16 version (the f32 function of x.float(),
    rounded once): within one bf16 ulp, at least 99 % the same bits, the
    same bits twice; with dropout the same seed's mask (a mask bit that
    differs moves its row's LayerNorm by many ulps), on the bf16 counter."""
    args, _ = _fs_bf16_args(p, c, h, seed=p + c + h)
    cuda_args = [t.to(dev) for t in args]
    before = (fused_frame_swiglu.launches, fused_frame_swiglu.launches_bf16)
    got = fused_frame_swiglu(*cuda_args, drop_rate=rate, seed=11)
    assert (fused_frame_swiglu.launches, fused_frame_swiglu.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    _assert_bf16_close(got, frame_swiglu_plain(*cuda_args, drop_rate=rate, seed=11), "out")
    assert torch.equal(got, fused_frame_swiglu(*cuda_args, drop_rate=rate, seed=11))


@pytest.mark.parametrize("c", [3, 4])
@pytest.mark.parametrize("hh", [32, 64, 128, 256])
def test_frame_swiglu_bf16_kernel_offset_statistics(dev, c, hh):
    """bf16 D at every instance (C, H/2) on the "offset" inputs (b1 + 10),
    dropout off and on: its packed stores of every width, within one ulp."""
    args, _ = _fs_bf16_args(777, c, 2 * hh, seed=c * hh, offset=10.0)
    cuda_args = [t.to(dev) for t in args]
    for rate in (0.0, 0.1):
        _assert_bf16_close(fused_frame_swiglu(*cuda_args, drop_rate=rate, seed=3),
                           frame_swiglu_plain(*cuda_args, drop_rate=rate, seed=3),
                           f"C={c}, H/2={hh}, drop {rate}")


def test_frame_swiglu_bf16_dropout_mask_is_the_plain_versions(dev):
    """The mask probe of `test_frame_swiglu_dropout_mask_is_the_plain_versions`
    in bf16: one mask bit that differs moves a row by > 1e-2, one bf16 ulp
    of its outputs is at most 2^-6; within one ulp is the same mask."""
    gen = torch.Generator().manual_seed(0)
    p, hh = 3001, 128
    x = (0.5 + torch.rand(p, 4, generator=gen)).to(torch.bfloat16)
    w1 = torch.cat([0.2 * torch.rand(4, hh, generator=gen) + 0.1,
                    0.02 * torch.randn(4, hh, generator=gen)], 1)
    b1 = torch.cat([torch.linspace(2.5, 3.5, hh), torch.ones(hh)])
    args = [t.to(dev) for t in (x, w1, b1, torch.ones(hh), torch.zeros(hh))]
    got = fused_frame_swiglu(*args, drop_rate=0.1, seed=13)
    _assert_bf16_close(got, frame_swiglu_plain(*args, drop_rate=0.1, seed=13), "out")
    other = frame_swiglu_plain(*args, drop_rate=0.1, seed=14)
    assert float((other.float() - got.float()).abs().max()) > 1e-2


@pytest.mark.parametrize("kind", ["rand", "mask", "slot", "zero", "offset"])
@pytest.mark.parametrize("p,c,h,rate", FS_CASES)
def test_frame_swiglu_bwd_bf16_kernel(dev, p, c, h, rate, kind):
    """bf16 E against its plain bf16 version: dx within one bf16 ulp and at
    least 99 % the same bits (both round one f32 value), the f32 parameter
    gradients as E's; a zero-gradient position skipped (0 in its dx); the
    same bits twice; on the bf16 counter."""
    args, dout = _fs_bf16_args(p, c, h, seed=p * c + h, offset=10.0 if kind == "offset" else 0.0)
    cuda_args = [t.to(dev) for t in args]
    dout = _zero_grad_case(dout, "rand" if kind == "offset" else kind, seed=p + c).to(dev)
    before = (fused_frame_swiglu_bwd.launches, fused_frame_swiglu_bwd.launches_bf16)
    got = fused_frame_swiglu_bwd(*cuda_args, dout, rate, 11)
    assert (fused_frame_swiglu_bwd.launches, fused_frame_swiglu_bwd.launches_bf16) == (
        before[0] + 1, before[1] + 1)
    want = frame_swiglu_bwd_plain(*cuda_args, dout, rate, 11)
    _assert_bf16_close(got[0], want[0], "dx")
    for name, x, y in zip(("dw1", "db1", "dls", "dlb"), got[1:], want[1:]):
        assert x.dtype == torch.float32 and x.shape == y.shape, name
        _assert_grad_close(x, y, name)
    assert torch.all(got[0][(dout == 0).all(-1)] == 0)
    if kind == "zero":
        assert all(torch.all(x == 0) for x in got)
    for x, y in zip(got, fused_frame_swiglu_bwd(*cuda_args, dout, rate, 11)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_frame_swiglu_bf16_autograd(dev, rate):
    """bf16 D inside its autograd.Function: x's gradient (bf16 E's dx) and
    the parameters' (f32) equal autograd through the plain bf16 version's,
    dx within one ulp."""
    args, dout = _fs_bf16_args(700, 4, 256, seed=9)
    args, dout = [t.to(dev) for t in args], _zero_grad_case(dout, "mask", 5).to(dev)
    leaves = [t.clone().requires_grad_() for t in args]
    out = fused_frame_swiglu(*leaves, drop_rate=rate, seed=4)
    assert out.grad_fn is not None and out.dtype == torch.bfloat16
    out.backward(dout)
    ref = [t.clone().requires_grad_() for t in args]
    frame_swiglu_plain(*ref, drop_rate=rate, seed=4).backward(dout)
    _assert_bf16_close(leaves[0].grad, ref[0].grad, "dx")
    for i, (x, y) in enumerate(zip(leaves[1:], ref[1:])):
        _assert_grad_close(x.grad, y.grad, f"parameter {i}")


def test_frame_swiglu_bf16_rejects_what_it_does_not_take(dev):
    """bf16 parameters, float16 x, a dout of another dtype than x, and the
    shapes the f32 kernels refuse raise; nothing falls back."""
    (x, w1, b1, ls, lb), dout = _fs_bf16_args(10, 4, 64, seed=1)
    x, w1, b1, ls, lb, dout = (t.to(dev) for t in (x, w1, b1, ls, lb, dout))
    with pytest.raises(TypeError):
        fused_frame_swiglu(x, w1.to(torch.bfloat16), b1, ls, lb)
    with pytest.raises(TypeError):
        fused_frame_swiglu(x, w1, b1, ls.to(torch.bfloat16), lb)
    with pytest.raises(TypeError):
        fused_frame_swiglu(x.half(), w1, b1, ls, lb)
    with pytest.raises(TypeError):
        fused_frame_swiglu_bwd(x, w1, b1, ls, lb, dout.float())
    with pytest.raises(TypeError):
        fused_frame_swiglu_bwd(x.float(), w1, b1, ls, lb, dout)
    for p, c, h in ((10, 5, 256), (10, 4, 96), (10, 2, 64)):
        (xs, *ps), _ = _fs_bf16_args(p, c, h, seed=1)
        with pytest.raises(ValueError):
            fused_frame_swiglu(*[t.to(dev) for t in (xs, *ps)])
    with pytest.raises(ValueError):
        fused_frame_swiglu_bwd(x, w1, b1, ls, lb, dout[:, :8].contiguous())


def test_faformer_bf16_on_card_matches_cpu(dev):
    """`faformer_equihnns` in bfloat16 at hidden 64: kernels D (5 a forward)
    and E (4 a step) on their bf16 counters, the trunk's A (3) in bf16; the
    eval forward against the CPU's bf16 model within the CPU's own
    bfloat16-vs-float32 distance, every parameter the CPU's step reaches
    reached, and the encoder's gradients under a smooth loss within half of
    that distance (relative L2 over all parameters)."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.train.trainer import masked_mse

    _, batch = _faformer_setup()
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    fns = (fused_frame_swiglu, fused_frame_swiglu_bwd, sorted_segment_sum)

    def make(device, dtype="bfloat16"):
        cfg = ModelConfig(mlp_hidden=64, output_hidden=8, compute_dtype=dtype)
        return create_model("faformer_equihnns", num_target=1, cfg=cfg,
                            generator=torch.Generator().manual_seed(1)).to(device)

    def counts():
        return [(fn.launches, fn.launches_bf16) for fn in fns]

    def reset():
        _reset_counts()
        for fn in fns:
            fn.launches_bf16 = 0

    with torch.inference_mode():
        want, want32 = make("cpu").eval()(batch), make("cpu", None).eval()(batch)
        reset()
        got = make(dev).eval()(batch.to(dev)).cpu()
    assert got.dtype == torch.float32
    assert counts() == [(5, 5), (0, 0), (3, 3)]
    assert float((got - want).abs().max()) <= float((want - want32).abs().max())

    def grads(device, loss, dtype="bfloat16"):
        model = make(device, dtype).eval()
        loss(model, batch.to(device)).backward()
        return {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    def step(model, b):
        sq, cnt = masked_mse(model(b), b.y, b.graph_mask)
        return sq / cnt.clamp(min=1.0)

    proj = torch.randn(batch.num_atoms, 64, generator=torch.Generator().manual_seed(4))

    def encoder(model, b):
        return torch.sum(model.encode(b)[b.atom_mask].float() * proj.to(b.pos.device)[b.atom_mask])

    want = grads("cpu", step)
    reset()
    got = grads(dev, step)
    assert counts() == [(5, 5), (4, 4), (3, 3)]
    nonzero = {n for n, g in want.items() if bool(g.abs().max() > 0)}
    assert {"fa_former.edge_module.coord_mlp.fc1.weight",
            "fa_former.layers_0.ffn.W_frame.fc1.weight", "atom_encoder.atom.embedding",
            "trunk.conv.W1.lin_0.weight"} <= nonzero
    for name in nonzero:
        assert name in got and bool(got[name].abs().max() > 0), name
    want, want32 = grads("cpu", encoder), grads("cpu", encoder, None)
    assert _rel_l2(grads(dev, encoder), want) <= 0.5 * _rel_l2(want, want32)


# ------------------------------------------------ kernels J and K in bfloat16

PC16_CASES = [  # (g, a, k, c, i, f, o, live mask or None)
    (3, 23, 16, 1, 256, 128, 256, None), (3, 23, 16, 3, 256, 128, 256, None),
    (4, 32, 16, 1, 256, 128, 256, "random"), (4, 32, 16, 3, 256, 128, 256, "random"),
    (2, 29, 4, 5, 40, 24, 200, None), (5, 7, 0, 3, 16, 16, 64, "random"),
    (4, 32, 16, 1, 19, 13, 260, None), (1, 1, 4, 3, 8, 8, 8, None),
    (3, 23, 16, 3, 64, 32, 128, "all_dead"), (3, 9, 32, 2, 128, 128, 384, "all_live"),
    (2, 3, 7, 17, 24, 16, 128, "random"), (40, 32, 16, 3, 128, 128, 128, "random"),
    # 132 live sites: J's and the dM kernels' last tile (64 sites) holds 4, dW's
    # last chunk (64 rows) 4 rows
    (3, 45, 16, 1, 256, 128, 256, "all_but_3"),
    # C = 3: a tile holds 21 sites (63 rows); dW's 64-row chunks split sites' rows
    (4, 32, 16, 3, 64, 32, 128, None),
    (6, 32, 16, 1, 128, 128, 128, "random"),  # O = 128: the hidden-128 fused path
    (2, 32, 32, 3, 256, 128, 256, "random"),  # K = 32: the shallower rings
    (769, 32, 16, 1, 256, 128, 256, "random"),  # the batch-768 grid
]


def _pc16_args(g, a, k, c, i, f, o, seed, dev):
    args, dout = _pc_args(g, a, k, c, i, f, o, seed)
    return [t.to(dev).bfloat16() for t in args], dout.to(dev).bfloat16()


@pytest.mark.parametrize("g,a,k,c,i,f,o,mask", PC16_CASES)
def test_pooled_conv_bf16_kernels(dev, g, a, k, c, i, f, o, mask):
    """Kernels J and K in bfloat16 against their plain bfloat16 versions
    (float32 sums of exact products, rounded where JAX's bfloat16 kernels
    round): at least 99 % of the elements the same bits, each within one
    bfloat16 ulp (K's dh and dtc past `bwd_bf16_rounding_bound`: the two
    round dM from sums in other orders); with live sites (random, all dead, all live) 0 at the
    dead sites; the same bits twice; one launch on each counter."""
    (h, tc, w), dout = _pc16_args(g, a, k, c, i, f, o, seed=g + a + k + c, dev=dev)
    live = None if mask is None else _live_mask(g, a, mask, seed=g + k).to(dev)
    before = [pooled_conv.launches, pooled_conv.launches_bf16, pooled_conv_bwd.launches,
              pooled_conv_bwd.launches_bf16]
    with torch.no_grad():
        got, again = pooled_conv(h, tc, w, c, live), pooled_conv(h, tc, w, c, live)
    assert got.dtype == torch.bfloat16 and torch.equal(got, again)
    _assert_bf16_close(got, pooled_conv_plain(h, tc, w, c, live), "J bf16")
    grads = pooled_conv_bwd(h, tc, w, c, dout, live)
    assert [pooled_conv.launches, pooled_conv.launches_bf16, pooled_conv_bwd.launches,
            pooled_conv_bwd.launches_bf16] == [n + m for n, m in zip(before, (2, 2, 1, 1))]
    bounds = pc_rounding_bound(h, tc, w, c, dout, live) + (0.0,)
    for name, x, y, z, slack in zip(("dh", "dtc", "dW"), grads,
                                    pooled_conv_bwd_plain(h, tc, w, c, dout, live),
                                    pooled_conv_bwd(h, tc, w, c, dout, live), bounds):
        _assert_bf16_close(x, y, f"K bf16 {name}", slack=slack)
        assert torch.equal(x, z), name
    if live is not None:
        assert not got[~live].any()
        assert not grads[0][~live].view(torch.int16).any()  # +0 in every bit
        assert not grads[1][~live].view(torch.int16).any()
    if k == 0:
        assert not got.any() and not grads[2].any()


def test_pooled_conv_bf16_autograd(dev):
    """Autograd through J in bfloat16 with live sites gives kernel K's
    bfloat16 gradients; W may be a strided slice, as the conv passes it."""
    (h, tc, _), dout = _pc16_args(6, 17, 16, 3, 64, 128, 128, seed=9, dev=dev)
    w2 = torch.randn(128, 128, 64, 2, device=dev).bfloat16()
    live = _live_mask(6, 17, "random", seed=2).to(dev)
    leaves = [t.clone().requires_grad_() for t in (h, tc, w2)]
    before = pooled_conv_bwd.launches_bf16
    out = pooled_conv(leaves[0], leaves[1], leaves[2][..., 1], 3, live)
    assert out.dtype == torch.bfloat16 and out.grad_fn is not None
    out.backward(dout)
    assert pooled_conv_bwd.launches_bf16 == before + 1
    want = pooled_conv_bwd(h, tc, w2[..., 1], 3, dout, live)
    for name, x, y in zip(("dh", "dtc", "dW"), (leaves[0].grad, leaves[1].grad,
                                                leaves[2].grad[..., 1]), want):
        assert torch.equal(x, y), name
    assert not leaves[2].grad[..., 0].any()


def test_pooled_conv_f32_keeps_the_parent_bits(dev):
    """The f32 kernels J and K give the output bits of the parent commit's
    (`chip_smoke.PC_F32_BEFORE`, on `chip_smoke.pooled_conv_digests`'
    inputs): their sources are the parent's, the bf16 kernels live apart."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    got = smoke.pooled_conv_digests()
    assert got["inputs"] == smoke.PC_F32_BEFORE["inputs"], "other inputs: nothing to compare"
    assert got == smoke.PC_F32_BEFORE


def test_pooled_conv_bf16_rejects_unsupported_inputs(dev):
    """Mixed types, a K past 32 or a C past 64, a non-contiguous h, tc or
    dout, and an O past what K's shared memory holds raise, and a call
    afterwards runs."""
    (h, tc, w), dout = _pc16_args(2, 5, 4, 3, 8, 8, 8, seed=1, dev=dev)
    with pytest.raises(TypeError):
        pooled_conv(h, tc.float(), w, 3)
    with pytest.raises(TypeError):
        pooled_conv(h, tc, w.float(), 3)
    with pytest.raises(TypeError):
        pooled_conv_bwd(h, tc, w, 3, dout.float())
    (h33, tc33, w33), d33 = _pc16_args(1, 2, 33, 1, 8, 8, 8, seed=2, dev=dev)
    with pytest.raises(ValueError, match="K ≤ 32"):
        pooled_conv(h33, tc33, w33, 1)
    with pytest.raises(ValueError, match="K ≤ 32"):
        pooled_conv_bwd(h33, tc33, w33, 1, d33)
    with pytest.raises(ValueError):  # C beyond a row tile
        pooled_conv(h, torch.zeros(2, 5, 4, 65 * 8, device=dev).bfloat16(), w, 65)
    for name, args in (("h", (h.transpose(0, 1).contiguous().transpose(0, 1), tc, w, 3)),
                       ("tc", (h, tc.transpose(0, 1).contiguous().transpose(0, 1), w, 3))):
        with pytest.raises(ValueError, match=f"contiguous {name}"):
            pooled_conv(*args)
    with pytest.raises(ValueError, match="contiguous dout"):
        pooled_conv_bwd(h, tc, w, 3, dout.transpose(0, 1).contiguous().transpose(0, 1))
    assert pooled_conv(h, tc, w, 3).shape == (2, 5, 3, 8)
    # K's dM kernels stage a tile's dout rows whole: O ≤ 1,088 at K = 16, C = 1
    (h16, tc16, w16), d16 = _pc16_args(1, 2, 16, 1, 8, 8, 1089, seed=3, dev=dev)
    with pytest.raises(RuntimeError, match="pooled_conv_bwd_bf16"):
        pooled_conv_bwd(h16, tc16, w16, 1, d16)
    (h16, tc16, w16), d16 = _pc16_args(1, 2, 16, 1, 8, 8, 1088, seed=3, dev=dev)
    assert pooled_conv_bwd(h16, tc16, w16, 1, d16)[2].shape == (8, 1088, 8)
