"""Port's `egnn_equihnns` vs the JAX model at converted weights, and the
port's batch builder vs the JAX one.

Hidden 16, output hidden 8 over 3 layers, a batch of 6 synthetic
molecules. The JAX model runs its EGNN through the Pallas edge MLP
(interpret mode). With the slot-incidence tables set to None its trunk
takes the flat segment path, as the port's does; with them it takes the
dense one-hot path, which must agree within the same tolerance.
Tolerance atol 1e-5, rtol 1e-4 (f32, other summation orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import iter_batches as jax_iter_batches
from equihgnn_tpu.data.batching import pad_hypergraph_batch as jax_pad
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.data.synthetic import make_synthetic_dataset
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import iter_batches, pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.models.config import ModelConfig

torch.set_num_threads(1)

CFG = dict(mlp_hidden=16, output_hidden=8, all_num_layers=3, output_num_layers=3,
           aggregate="mean", normalization="ln")
SLOT_TABLES = ("hedge_row", "hedge_slot", "hedge_slot_index", "hedge_slot_mask",
               "inc_slot_atom", "inc_slot_hedge", "inc_slot_mask")
BATCH_FIELDS = ("atom_feat", "atom_mask", "atom_graph_id", "vertex_idx", "hedge_idx",
                "inc_mask", "hedge_mask", "graph_mask", "y", "pos", "slot_index",
                "slot_mask", "slot_gid", "atom_slot", "atom_row")


def _samples(n=6, seed=23):
    return make_synthetic_dataset(n, seed=seed, num_targets=1)


def _jax_setup(seed=0):
    """JAX model, a batch with slot tables, and its params with the EGNN
    layer redrawn at O(0.1) (its init of N(0, 1e-3²) barely moves x)."""
    samples = _samples()
    jb = jax_pad(samples, jax_spec(samples, batch_size=8), target=0, with_pos=True)
    assert all(getattr(jb, f) is not None for f in SLOT_TABLES)
    jb = jax.tree.map(jnp.asarray, jb)
    model = jax_create_model("egnn_equihnns", num_target=1, cfg=JaxModelConfig(**CFG))
    params = model.init(jax.random.PRNGKey(seed), jb, deterministic=True)["params"]
    flat = {k: np.asarray(v) for k, v in traverse_util.flatten_dict(params, sep="/").items()}
    rng = np.random.default_rng(seed)
    for k, v in flat.items():
        if k.startswith("egnn_layer/") and "norm" not in k:
            flat[k] = (rng.standard_normal(v.shape) * 0.1).astype(np.float32)
    return samples, jb, model, flat


def _port(flat):
    model = create_model("egnn_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    model.load_state_dict(params_from_jax(flat, model))
    return model.eval()


@pytest.mark.parametrize("slot_tables", [False, True])
def test_model_matches_jax(slot_tables):
    samples, jb, jmodel, flat = _jax_setup()
    if not slot_tables:  # flat trunk path, as the port's
        jb = dataclasses.replace(jb, **{f: None for f in SLOT_TABLES})
    want = np.asarray(jmodel.apply(
        {"params": traverse_util.unflatten_dict(flat, sep="/")}, jb, deterministic=True
    ))
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), with_pos=True)
    with torch.inference_mode():
        got = _port(flat)(tb).numpy()
    assert got.shape == want.shape == (9,)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4)


def test_pad_hypergraph_batch_matches_jax():
    samples = _samples(7, seed=3)
    jspec, tspec = jax_spec(samples, batch_size=8), spec_for_samples(samples, batch_size=8)
    for f in dataclasses.fields(tspec):
        assert getattr(tspec, f.name) == getattr(jspec, f.name), f.name
    jb = jax_pad(samples, jspec, target=0, with_pos=True)
    tb = pad_hypergraph_batch(samples, tspec, target=0, with_pos=True)
    for name in BATCH_FIELDS:
        got, want = getattr(tb, name).numpy(), np.asarray(getattr(jb, name))
        np.testing.assert_array_equal(got, want, err_msg=name)
        if got.dtype.kind in "iu":
            assert got.dtype == np.int64, name


def test_iter_batches_splits_like_jax():
    samples = _samples(20, seed=4)
    spec = spec_for_samples(samples[:5], batch_size=4)
    got = [b.graph_mask.numpy() for b in iter_batches(samples, spec, with_pos=True)]
    want = [np.asarray(b.graph_mask) for b in jax_iter_batches(
        samples, jax_spec(samples[:5], batch_size=4), with_pos=True)]
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fault", ["missing", "extra", "shape"])
def test_params_from_jax_rejects_bad_trees(fault):
    _, _, _, flat = _jax_setup()
    model = create_model("egnn_equihnns", num_target=1, cfg=ModelConfig(**CFG))
    params_from_jax(flat, model)  # the full tree converts
    flat = dict(flat)
    if fault == "missing":
        del flat["trunk/conv/W2/lin_1/bias"]
    elif fault == "extra":
        flat["trunk/conv/W4/lin_0/kernel"] = np.zeros((16, 16), np.float32)
    else:
        flat["egnn_layer/edge_mlp_1/kernel"] = np.zeros((66, 8), np.float32)
    with pytest.raises(KeyError if fault != "shape" else ValueError):
        params_from_jax(flat, model)


@pytest.mark.parametrize(
    "method,override", [("egnn_equihnns", dict(compute_dtype="bfloat16")),
                        ("gin", dict(compute_dtype="bfloat16")),
                        ("egnn_equihnns", dict(remat=True)),
                        ("mhnn", dict(compute_dtype="bfloat16")),
                        ("gat", dict(remat=True)),
                        ("equiformer_equihnns", {}),
                        ("faformer_equihnns", dict(compute_dtype="bfloat16")),
                        ("visnet_equihnns", dict(compute_dtype="bfloat16"))],
)
def test_unported_configs_raise(method, override):
    """The configurations that once raised build. The MHNN family and the
    EGNN models build in bfloat16 (held to JAX in
    `tests/test_torch_bf16_hypergraph.py`), the ViSNet models too
    (`tests/test_torch_visnet_bf16.py`), the FAFormer models too
    (`tests/test_torch_faformer_bf16.py`; the Equiformer in bfloat16 still
    raises, ROADMAP item 11: `tests/test_torch_equiformer.py`), and the 2-D
    baselines take the flag and ignore it, as in JAX. `remat` and `equiformer_equihnns` are
    ported and build (remat's steps: `tests/test_torch_remat.py`; the
    Equiformer: `tests/test_torch_equiformer.py`). `cross_molecule_knn=True`
    is ported (`tests/test_torch_egnn_flat.py`)."""
    cfg = ModelConfig(**{**CFG, **override})
    model = create_model(method, num_target=1, cfg=cfg, **(
        {"gnn_type": method} if method in ("gat", "gin") else {}))
    assert model.cfg.remat == bool(override.get("remat"))
    assert model.cfg.compute_dtype == override.get("compute_dtype")
    assert sum(p.numel() for p in model.parameters()) > 0
    assert all(p.dtype == torch.float32 for p in model.parameters())
    if method == "gin" and "compute_dtype" in override:  # taken and ignored
        from equihgnn_tpu_torch.data.batching import pad_graph_batch
        from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset as graphs

        plain = create_model(method, num_target=1, cfg=ModelConfig(**CFG), gnn_type=method)
        samples = graphs(6, seed=71, hyper=False)
        batch = pad_graph_batch(samples, spec_for_samples(samples, batch_size=8), target=0)
        with torch.no_grad():
            got, want = model.eval()(batch), plain.eval()(batch)
        assert got.dtype == torch.float32 and torch.equal(got, want)


def test_bn_prelu_model_matches_jax():
    """`egnn_equihnns` with masked BatchNorm in its MLPs and PReLU: eval and
    training forwards, gradients and running statistics against JAX."""
    from test_torch_mhnn import CFG as SMALL
    from test_torch_mhnn import check_against_jax

    model, want, reached = check_against_jax(
        "egnn_equihnns", dict(SMALL, normalization="bn", activation="prelu"), _samples(),
        with_pos=True)
    assert "trunk.act.alpha" in want and float(want["trunk.act.alpha"].abs()) > 0
    assert "trunk.conv.W2.norm_0.running_var" in want
    assert reached > 0.8 * len(list(model.parameters()))
