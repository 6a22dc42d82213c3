"""Port's kNN and EGNN layer vs the JAX package and the reference golden.

The JAX EGNN runs its dense path with the fused edge MLP in Pallas
interpret mode; the port's runs the plain version of its kernel. Weights
come from the JAX init, redrawn at O(0.1) so that the edge MLP and the
coordinate update move the outputs, and reach the port through
`params_from_jax`. Tolerance atol 1e-5, rtol 1e-4 (f32, other summation
orders); the golden keeps its own test's atol 2e-5.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.data.synthetic import make_synthetic_dataset
from equihgnn_tpu.nn.egnn import EGNN as JaxEGNN
from equihgnn_tpu.ops.knn import knn_dense as jax_knn_dense
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.nn.egnn import EGNN
from equihgnn_tpu_torch.ops.knn import knn_dense

torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "egnn_layer.npz")


def _redraw(flat, seed):
    """Replace every JAX parameter by an O(0.1) draw (LayerNorm scales
    around 1) of the same shape."""
    rng = np.random.default_rng(seed)
    out = {}
    for k, v in flat.items():
        x = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
        out[k] = x + 1.0 if k.endswith("node_norm/scale") else x
    return out


@pytest.mark.parametrize("a,k,radius", [(12, 16, None), (12, 5, None), (12, 16, 2.0)])
def test_knn_dense_matches_jax(a, k, radius):
    rng = np.random.default_rng(a + k)
    r = 6
    pos = (rng.standard_normal((r, a, 3)) * 1.5).astype(np.float32)
    n_valid = rng.integers(1, a + 1, size=r)
    mask = np.arange(a)[None, :] < n_valid[:, None]
    gid = np.where(mask, np.arange(r)[:, None] + (np.arange(a)[None, :] >= 9), -1)
    pos = pos * mask[..., None]
    idx, nmask, _ = knn_dense(torch.from_numpy(pos), torch.from_numpy(mask), k,
                              valid_radius=radius, squared_radius=True,
                              slot_gid=torch.from_numpy(gid))
    jidx, jmask, _ = jax_knn_dense(jnp.asarray(pos), jnp.asarray(mask), k, valid_radius=radius,
                                   squared_radius=True, slot_gid=jnp.asarray(gid))
    jidx, jmask = np.asarray(jidx), np.asarray(jmask)
    assert idx.shape == jidx.shape == (r, a, k)
    np.testing.assert_array_equal(nmask.numpy(), jmask)
    valid = jmask
    np.testing.assert_array_equal(idx.numpy()[valid], jidx[valid])
    # invalid slots tie at BIG; a stable sort resolves them as lax.top_k does
    np.testing.assert_array_equal(idx.numpy(), jidx)


def _batches(n=6, seed=11):
    from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples

    samples = make_synthetic_dataset(n, seed=seed, num_targets=1)
    jb = jax_pad(samples, jax_spec(samples, batch_size=8), target=0, with_pos=True)
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), with_pos=True)
    return jb, tb


@pytest.mark.parametrize("radius_mask", [False, True])
def test_egnn_dense_matches_jax(radius_mask):
    """Dense path as the model runs it (radius mask dead) and with the
    radius mask on (valid_radius 5.0 against the squared distance)."""
    dim = 16
    jb, tb = _batches()
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((tb.num_atoms, dim)).astype(np.float32)
    jm = JaxEGNN(dim=dim, norm_coors=True, norm_feats=True, valid_radius=5.0,
                 num_nearest_neighbors=16, apply_radius_mask=radius_mask)
    jargs = dict(
        mask=jnp.asarray(jb.atom_mask), graph_id=jnp.asarray(jb.atom_graph_id),
        slot_index=jnp.asarray(jb.slot_index), slot_mask=jnp.asarray(jb.slot_mask),
        atom_slot=jnp.asarray(jb.atom_slot), slot_gid=jnp.asarray(jb.slot_gid),
        atom_row=jnp.asarray(jb.atom_row),
    )
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(jb.pos), **jargs)
    flat = _redraw(traverse_util.flatten_dict(variables["params"], sep="/"), seed=1)
    jf, jc = jm.apply({"params": traverse_util.unflatten_dict(flat, sep="/")},
                      jnp.asarray(feats), jnp.asarray(jb.pos), **jargs)

    tm = EGNN(dim=dim, apply_radius_mask=radius_mask, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(flat, tm))
    with torch.inference_mode():
        tf, tc = tm(torch.from_numpy(feats), tb.pos, tb.slot_index, tb.slot_mask,
                    tb.atom_slot, tb.atom_row, tb.slot_gid)
    real = np.asarray(jb.atom_mask)
    np.testing.assert_allclose(tf.numpy()[real], np.asarray(jf)[real], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(tc.numpy()[real], np.asarray(jc)[real], atol=1e-5, rtol=1e-4)
    # the message terms moved the features: the test is not just the residual
    assert np.abs(tf.numpy() - feats)[real].max() > 1e-2


def test_egnn_layer_golden():
    """The reference golden, through the JAX test's own converter."""
    from test_reference_goldens import _state, egnn_tree

    d = dict(np.load(GOLDEN))
    dim, k = 32, int(d["meta::k"])
    n = d["in::feats"].shape[0]
    flat = traverse_util.flatten_dict(egnn_tree(_state(d), dim), sep="/")
    tm = EGNN(dim=dim, num_nearest_neighbors=k, valid_radius=5.0,
              generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(flat, tm))
    ar = torch.arange(n)
    with torch.inference_mode():
        feats, coors = tm(
            torch.from_numpy(d["in::feats"]), torch.from_numpy(d["in::coors"]),
            slot_index=ar[None], slot_mask=torch.ones(1, n, dtype=torch.bool),
            atom_slot=ar, atom_row=torch.zeros(n, dtype=torch.int64),
        )
    np.testing.assert_allclose(feats.numpy(), d["out::feats"], atol=2e-5, rtol=1e-4)
    np.testing.assert_allclose(coors.numpy(), d["out::coors"], atol=2e-5, rtol=1e-4)


# ------------------------------ kernel C: edges whose output gradient is 0


def _edge_mlp_case(seed=0, g=3, a=8, k=6, f=34):
    """Edge-MLP inputs at O(0.1) weights, an output gradient dm, and a mask
    of kept edges (about half, slot (0, 0) wholly dropped)."""
    rng = np.random.default_rng(seed)
    args = [rng.standard_normal((g, a, f)).astype(np.float32),
            rng.standard_normal((g, a, f)).astype(np.float32),
            (rng.random((g, a, k)) * 4.0).astype(np.float32),
            rng.integers(0, a, (g, a, k)).astype(np.int64),
            (rng.standard_normal(f) * 0.1).astype(np.float32),
            (rng.standard_normal(f) * 0.1).astype(np.float32),
            (rng.standard_normal((f, 16)) * 0.1).astype(np.float32),
            (rng.standard_normal(16) * 0.1).astype(np.float32)]
    dm = rng.standard_normal((g, a, k, 16)).astype(np.float32)
    keep = rng.random((g, a, k)) < 0.5
    keep[0, 0] = False
    return args, dm * keep[..., None], keep


def test_edge_mlp_bwd_on_zeroed_edges_is_the_live_edges_backward():
    """Kernel C skips every edge whose row of dm is 0. The function it must
    keep: on the CPU, the plain backward for dm zeroed on a mask equals the
    edge MLP's backward over the kept edges alone (each gradient within
    1e-5·max + 1e-7: the same terms summed in another order), with exactly
    0 in ddist at every dropped edge, in dui at the slot whose edges are all
    dropped and in dujn at every slot that no kept edge reads; and both
    agree with `jax.vjp` of JAX's fused edge MLP (its Pallas backward in
    interpret mode) on the same zeroed dm within atol = rtol = 1e-4, as
    `tests/test_torch_edge_mlp.py` holds the unmasked one."""
    import torch.nn.functional as F

    from equihgnn_tpu.ops.pallas.edge_mlp import fused_edge_messages as jax_fused_edge_messages
    from equihgnn_tpu_torch.ops.kernels.edge_mlp import fused_edge_messages_bwd_plain

    args, dm, keep = _edge_mlp_case()
    targs = [torch.from_numpy(x) for x in args]
    got = fused_edge_messages_bwd_plain(*targs, torch.from_numpy(dm))

    # the kept edges alone: (g, a, kk) triples, their messages, their dm rows
    ui, ujn, dist, idx, wd, b0, w1, b1 = [t.clone().requires_grad_() if t.is_floating_point()
                                          else t for t in targs]
    e = torch.from_numpy(np.argwhere(keep))
    g, a, kk = e.unbind(1)
    pre = ui[g, a] + ujn[g, idx[g, a, kk]] + dist[g, a, kk, None] * wd + b0
    out = F.silu(F.silu(pre) @ w1 + b1)
    want = torch.autograd.grad(out, (ui, ujn, dist, wd, b0, w1, b1),
                               torch.from_numpy(dm[keep]))
    names = ("dui", "dujn", "ddist", "dwd", "db0", "dw1", "db1")
    for name, x, y in zip(names, got, want):
        assert x.shape == y.shape, name
        err, scale = float((x - y).abs().max()), float(y.abs().max())
        assert err <= 1e-5 * scale + 1e-7, f"{name}: {err:.3e} of {scale:.3e}"
    assert torch.all(got[2][torch.from_numpy(~keep)] == 0)
    assert torch.all(got[0][0, 0] == 0)  # slot (0, 0): every edge dropped
    read = np.zeros(idx.shape[:2], bool)
    for gi, ai, ki in np.argwhere(keep):
        read[gi, args[3][gi, ai, ki]] = True
    assert (~read).any() and torch.all(got[1][torch.from_numpy(~read)] == 0)

    jargs = [jnp.asarray(x) for x in args]
    jidx = jargs[3].astype(jnp.int32)
    _, vjp = jax.vjp(lambda ui, ujn, dist, wd, b0, w1, b1: jax_fused_edge_messages(
        ui, ujn, dist, jidx, wd, b0, w1, b1), *jargs[:3], *jargs[4:])
    for name, x, y in zip(names, got, vjp(jnp.asarray(dm))):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-4, rtol=1e-4, err_msg=name)


def test_dm_is_zero_on_every_masked_edge_of_a_train_step(monkeypatch):
    """The premise of kernel C's skip: in one `egnn_equihnns` train step on
    the CPU, the gradient that reaches the edge MLP (dm, a row an edge) is
    exactly 0 on every edge that `pair_mask` drops (both consumers of the
    messages mask them) and on none of the kept edges."""
    from equihgnn_tpu_torch import create_model
    from equihgnn_tpu_torch.data.batching import iter_batches, spec_for_samples
    from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset as torch_synthetic
    from equihgnn_tpu_torch.models.config import ModelConfig
    from equihgnn_tpu_torch.nn import egnn as egnn_mod
    from equihgnn_tpu_torch.train.trainer import masked_mse

    seen = {}
    kernel, knn = egnn_mod.fused_edge_messages, egnn_mod.knn_dense

    def knn_seen(*a, **kw):
        seen["knn"] = knn(*a, **kw)
        return seen["knn"]

    def kernel_seen(*a, **kw):
        out = kernel(*a, **kw)
        out.register_hook(lambda g: seen.__setitem__("dm", g.detach().clone()))
        return out

    monkeypatch.setattr(egnn_mod, "knn_dense", knn_seen)
    monkeypatch.setattr(egnn_mod, "fused_edge_messages", kernel_seen)
    samples = torch_synthetic(10, seed=5, num_targets=1)
    batch = next(iter_batches(samples, spec_for_samples(samples, 10), with_pos=True, target=0))
    model = create_model("egnn_equihnns", num_target=1, cfg=ModelConfig(mlp_hidden=16, output_hidden=8),
                         generator=torch.Generator().manual_seed(2)).train()
    sq, cnt = masked_mse(model(batch), batch.y, batch.graph_mask)
    (sq / cnt.clamp(min=1.0)).backward()
    pair_mask, dm = seen["knn"][1], seen["dm"]
    assert dm.shape == pair_mask.shape + (16,)
    assert (~pair_mask).any() and pair_mask.any()
    assert torch.all(dm[~pair_mask] == 0)
    assert not (dm[pair_mask] == 0).all(-1).any()


@pytest.mark.parametrize("radius_mask", [False, True])
def test_egnn_layer_is_the_same_bits_with_the_edge_mask(radius_mask, monkeypatch):
    """The layer hands `pair_mask` to the fused edge MLP, which then gives 0
    at the masked edges (on the card it skips the slots with no kept edge).
    Both consumers of the messages mask them, and the coordinate MLP between
    works row by row, so nothing the model computes may move: the layer's
    outputs, and its gradients with respect to every parameter and both
    inputs, are the same bits (`torch.equal`) with `edge_mask=pair_mask` as
    with `edge_mask=None`. Weights at O(0.1), so that the edge MLP moves
    both outputs."""
    from equihgnn_tpu_torch.nn import egnn as egnn_mod

    dim = 16
    _, tb = _batches()
    gen = torch.Generator().manual_seed(3)
    layer = EGNN(dim=dim, apply_radius_mask=radius_mask, generator=gen)
    with torch.no_grad():
        for name, p in layer.named_parameters():
            p.copy_(0.1 * torch.randn(p.shape, generator=gen) + (1.0 if "node_norm.weight" in name else 0.0))
    feats0 = torch.randn(tb.num_atoms, dim, generator=gen)
    rf = torch.randn(tb.num_atoms, dim, generator=gen)
    rc = torch.randn(tb.num_atoms, 3, generator=gen)
    kernel = egnn_mod.fused_edge_messages
    masks = []

    def run(drop_mask: bool):
        def edge_messages(*args, edge_mask=None):
            masks.append(edge_mask)
            return kernel(*args, edge_mask=None if drop_mask else edge_mask)

        monkeypatch.setattr(egnn_mod, "fused_edge_messages", edge_messages)
        layer.zero_grad()
        feats = feats0.clone().requires_grad_()
        coors = tb.pos.clone().requires_grad_()
        f, c = layer(feats, coors, tb.slot_index, tb.slot_mask, tb.atom_slot, tb.atom_row,
                     tb.slot_gid)
        ((f * rf).sum() + (c * rc).sum()).backward()
        grads = {n: p.grad.clone() for n, p in layer.named_parameters()}
        return f.detach(), c.detach(), feats.grad, coors.grad, grads

    with_mask, without = run(False), run(True)
    assert masks[0] is not None and (~masks[0]).any() and masks[0].any()
    for name, x, y in zip(("feats", "coors", "dfeats", "dcoors"), with_mask[:4], without[:4]):
        assert torch.equal(x, y), name
    assert with_mask[4].keys() == without[4].keys()
    for name in with_mask[4]:
        assert torch.equal(with_mask[4][name], without[4][name]), name
    # the messages moved the outputs and reached every parameter
    assert float((with_mask[0] - feats0).abs().max()) > 1e-2
    assert all(float(g.abs().max()) > 0 for g in with_mask[4].values())
