"""EGNN's flat path (`cross_molecule_knn=True`, or a batch without the slot
view) vs the JAX package and the reference golden, on the CPU.

`knn_graph` against JAX's (with and without molecule ids, padded rows,
ties, `exclude_self`, the radius, the row chunks); the flat EGNN layer's
outputs and gradients against JAX's flat path (which, as the port's, runs
no Pallas kernel); `model_egnn_equihnns.npz`, captured on this path, at
the JAX test's atol 2e-5, rtol 1e-4; and `egnn_equihnns` against JAX at
matched weights (`test_torch_mhnn.check_against_jax`: forwards atol 1e-5,
rtol 1e-4, gradients per tensor 1e-4·max |JAX| + 1e-6). Weights of the
layer tests are redrawn at O(0.1), so that the edge MLP and the
coordinate update move the outputs.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.nn.egnn import EGNN as JaxEGNN
from equihgnn_tpu.ops.knn import knn_graph as jax_knn_graph
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import BatchSpec, pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.nn import egnn as egnn_mod
from equihgnn_tpu_torch.nn.egnn import EGNN
from equihgnn_tpu_torch.ops import knn
from equihgnn_tpu_torch.ops.knn import knn_graph
from test_torch_egnn import _redraw
from test_torch_mhnn import CFG, _flat, check_against_jax

torch.set_num_threads(1)


def _points(seed, n=40, n_graphs=4):
    """Positions with padded rows (mask False, at the origin), molecule
    ids, and ties: a few points duplicated, so that distances tie."""
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((n, 3)) * 1.5).astype(np.float32)
    pos[5] = pos[3]
    pos[17] = pos[3]
    mask = np.ones(n, bool)
    mask[-6:] = False
    pos[~mask] = 0.0
    gid = np.sort(rng.integers(0, n_graphs, size=n)).astype(np.int64)
    gid[~mask] = n_graphs
    return pos, mask, gid


@pytest.mark.parametrize("use_gid,exclude_self,radius,chunk", [
    (False, False, None, None), (True, False, None, None), (False, True, 4.0, 7),
    (True, True, 2.0, 1)], ids=["cloud", "molecules", "cloud-noself-radius-chunk7",
                                "molecules-noself-radius-chunk1"])
def test_knn_graph_matches_jax(monkeypatch, use_gid, exclude_self, radius, chunk):
    """Chunks of `chunk` rows (None: one chunk) give the same lists."""
    pos, mask, gid = _points(5)
    k = 8
    if chunk:
        monkeypatch.setattr(knn, "PAIRS_PER_CHUNK", chunk * len(pos))
    kw = dict(valid_radius=radius, squared_radius=True, exclude_self=exclude_self)
    idx, nmask, sq = knn_graph(torch.from_numpy(pos), k, mask=torch.from_numpy(mask),
                               graph_id=torch.from_numpy(gid) if use_gid else None, **kw)
    jidx, jmask, jsq = jax_knn_graph(jnp.asarray(pos), k, mask=jnp.asarray(mask),
                                     graph_id=jnp.asarray(gid) if use_gid else None, **kw)
    assert idx.dtype == torch.int64 and idx.shape == (40, k)
    # every index, the invalid ones (ranked BIG, ties) included: lower index first
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(nmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(sq.numpy(), np.asarray(jsq), atol=1e-6, rtol=1e-6)
    assert (~nmask[-6:]).all() and nmask[:-6].any()
    if not use_gid:  # the duplicated points are each other's neighbours at distance 0
        assert ({5, 17} | (set() if exclude_self else {3})) <= set(idx[3].tolist())


def _layer_case(cross: bool):
    """A batch of 6 synthetic molecules without the slot view, features
    and output cotangents from numpy, the JAX layer and redrawn weights."""
    samples = make_synthetic_dataset(6, seed=13, num_targets=1)
    jb = jax_pad(samples, jax_spec(samples, batch_size=8), target=0, with_pos=True)
    rng = np.random.default_rng(2)
    n, dim = jb.atom_mask.shape[0], 16
    feats = rng.standard_normal((n, dim)).astype(np.float32)
    cot_f = rng.standard_normal((n, dim)).astype(np.float32)
    cot_c = rng.standard_normal((n, 3)).astype(np.float32)
    jm = JaxEGNN(dim=dim, norm_coors=True, norm_feats=True, valid_radius=5.0,
                 num_nearest_neighbors=16, cross_molecule=cross)
    jargs = dict(mask=jnp.asarray(jb.atom_mask), graph_id=jnp.asarray(jb.atom_graph_id))
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(feats), jnp.asarray(jb.pos), **jargs)
    flat = _redraw(traverse_util.flatten_dict(variables["params"], sep="/"), seed=1)
    return jb, feats, cot_f, cot_c, jm, jargs, flat


@pytest.mark.parametrize("cross", [True, False], ids=["cross-molecule", "per-molecule"])
def test_egnn_flat_layer_matches_jax(cross):
    """Outputs and gradients (the input features and every parameter) of
    the flat layer against JAX's flat path, under a fixed cotangent. The
    gradient with respect to the input coordinates is not held: at the self
    edge rel = 0 meets CoorsNorm's 1 / max(|rel|, 1e-8), so terms of
    ~1e7 cancel between an atom and itself, each framework in its own order
    (an O(1) difference); the models feed data coordinates, which take no
    gradient."""
    jb, feats, cot_f, cot_c, jm, jargs, flat = _layer_case(cross)
    real = np.asarray(jb.atom_mask)

    def loss(params, x, c):
        f, co = jm.apply({"params": params}, x, c, **jargs)
        return jnp.sum(f * cot_f * real[:, None]) + jnp.sum(co * cot_c * real[:, None]), (f, co)

    (_, (jf, jc)), (jg, jgx, jgc) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True))(
        traverse_util.unflatten_dict(flat, sep="/"), jnp.asarray(feats), jnp.asarray(jb.pos))

    tm = EGNN(dim=16, cross_molecule=cross, generator=torch.Generator().manual_seed(0))
    tm.load_state_dict(params_from_jax(flat, tm))
    x = torch.from_numpy(feats).requires_grad_()
    c = torch.from_numpy(np.asarray(jb.pos)).requires_grad_()
    # no slot view: the flat path, with or without molecule ids
    f, co = tm(x, c, mask=torch.from_numpy(real),
               graph_id=torch.from_numpy(np.asarray(jb.atom_graph_id, np.int64)))
    m = torch.from_numpy(real)[:, None].float()
    ((f * torch.from_numpy(cot_f) * m).sum() + (co * torch.from_numpy(cot_c) * m).sum()).backward()
    np.testing.assert_allclose(f.detach().numpy()[real], np.asarray(jf)[real], atol=1e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(co.detach().numpy()[real], np.asarray(jc)[real], atol=1e-5,
                               rtol=1e-4)
    assert np.abs(f.detach().numpy() - feats)[real].max() > 1e-2
    want = params_from_jax(_flat(jg), tm)
    assert c.grad is not None and np.isfinite(c.grad.numpy()).all()
    pairs = [("feats", x.grad, jgx)]
    pairs += [(n, p.grad, want[n]) for n, p in tm.named_parameters()]
    for name, got, w in pairs:
        w = torch.as_tensor(np.array(w))
        assert got is not None and float(w.abs().max()) > 0, name
        err, limit = float((got - w).abs().max()), 1e-4 * float(w.abs().max()) + 1e-6
        assert err <= limit, f"{name}: max |d| {err:.3e} > {limit:.3e}"


def test_flat_path_takes_no_kernel(monkeypatch):
    """Kernel B (the fused edge MLP) runs on the dense view only, as JAX's
    does: the flat path, asked for by `cross_molecule` on a batch with the
    slot view, never reaches it, and the dense path always does."""
    calls = []
    kernel = egnn_mod.fused_edge_messages
    monkeypatch.setattr(egnn_mod, "fused_edge_messages",
                        lambda *a, **kw: calls.append(1) or kernel(*a, **kw))
    samples = make_synthetic_dataset(4, seed=3, num_targets=1)
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=4), with_pos=True)
    feats = torch.randn(tb.num_atoms, 8, generator=torch.Generator().manual_seed(1))
    args = (feats, tb.pos, tb.slot_index, tb.slot_mask, tb.atom_slot, tb.atom_row, tb.slot_gid)
    kw = dict(mask=tb.atom_mask, graph_id=tb.atom_graph_id)
    with torch.no_grad():
        for cross, want in ((True, 0), (False, 1)):
            calls.clear()
            EGNN(dim=8, cross_molecule=cross, generator=torch.Generator())(*args, **kw)
            assert len(calls) == want, cross


def test_egnn_model_golden():
    """`model_egnn_equihnns.npz`, captured with the reference's
    batch-as-one-point-cloud kNN (`cross_molecule_knn=True`), through the
    JAX test's converters."""
    from test_reference_goldens import _model_cfg, _state, egnn_tree, load, model_tree

    d = load("model_egnn_equihnns")
    st = _state(d)
    jcfg = dataclasses.replace(_model_cfg(), cross_molecule_knn=True)
    variables = model_tree("mhnns", st, jcfg)
    params = _flat(variables["params"])
    params.update({f"egnn_layer/{k}": v for k, v in _flat(
        egnn_tree(st, jcfg.mlp_hidden, prefix="egnn_layer.")).items()})
    model = create_model("egnn_equihnns", num_target=1,
                         cfg=ModelConfig(**dataclasses.asdict(jcfg)))
    model.load_state_dict(params_from_jax(params, model))
    samples = make_synthetic_dataset(6, seed=17)
    spec = BatchSpec(num_graphs=8, num_atoms=256, num_hedges=128, nnz=512)
    batch = pad_hypergraph_batch(samples, spec, target=0, with_pos=True)
    with torch.no_grad():
        out = model.eval()(batch).numpy()
    np.testing.assert_allclose(out[:6], d["out::y"], atol=2e-5, rtol=1e-4)
    # the batch-wide kNN crosses molecules here (the reference's EGNN init,
    # N(0, 1e-3²), moves the features little, so the golden alone would
    # barely tell the two neighbourhoods apart)
    idx, nmask, _ = knn_graph(batch.pos, 16, mask=batch.atom_mask)
    gid = batch.atom_graph_id
    assert bool((nmask & (gid[idx] != gid[:, None])).any())


@pytest.mark.parametrize("cross,slot_view", [(True, True), (False, False)],
                         ids=["cross-molecule", "no-slot-view"])
def test_egnn_equihnns_flat_matches_jax(cross, slot_view):
    """`egnn_equihnns` with `cross_molecule_knn=True` (on a batch with the
    slot view: the flat path all the same), and on a batch without the slot
    view (per-molecule neighbourhoods, flat): forwards, loss, gradients and
    every parameter the JAX model reaches."""
    samples = make_synthetic_dataset(6, seed=23, num_targets=1)
    model, want, reached = check_against_jax(
        "egnn_equihnns", {**CFG, "cross_molecule_knn": cross}, samples, with_pos=True,
        slot_view=slot_view)
    assert float(want["egnn_layer.edge_mlp_0.weight_i"].abs().max()) > 0
    assert reached > 0.8 * len(list(model.parameters()))
