"""The port's 2-D baselines (`gin`, `gcn`, `gat`, `gatv2`) and their segment
reductions vs the JAX package and the reference goldens, on the CPU.

Small widths: 3 layers, emb 64 (the goldens' widths; the models against
JAX at emb 32), batches of synthetic molecules, or molecules parsed from
SMILES where ties matter. Tolerances: the goldens keep the JAX test's
(atol 2e-5, rtol 1e-4); forwards against JAX atol 1e-5, rtol 1e-4 (f32 sums
in other orders); gradients per tensor max |Δ| ≤ 1e-4·max |JAX| + 1e-6;
running statistics atol 1e-5, rtol 1e-4; after an Adam step parameters
within 1e-2·lr (an update is O(lr) whatever the gradient's size). A bias
that feeds a training-mode BatchNorm has a 0 gradient in exact
arithmetic: it is held to ~0 in both frameworks (`vanishing`). GAT and
GATv2 are held against both of JAX's paths, its dense per-molecule view
and its flat segment path. The JAX side is jitted.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from equihgnn_tpu import create_model as jax_create_model
from equihgnn_tpu.data.batching import pad_graph_batch as jax_pad_graph
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.models.config import ModelConfig as JaxModelConfig
from equihgnn_tpu.ops.segment import segment_max as jax_segment_max
from equihgnn_tpu.ops.segment import segment_softmax as jax_segment_softmax
from equihgnn_tpu.train.trainer import TrainConfig as JaxTrainConfig
from equihgnn_tpu.train.trainer import Trainer as JaxTrainer
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import BatchSpec, pad_graph_batch, spec_for_samples
from equihgnn_tpu_torch.data.featurize import mol_from_smiles, mol_to_graph
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.models import baseline_2d
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.ops.segment import masked_segment_reduce, segment_max, segment_softmax
from equihgnn_tpu_torch.train.trainer import TrainConfig, Trainer, masked_mse
from test_torch_mhnn import _flat, _jax_run, _unflat, jax_reference, random_variables

torch.set_num_threads(1)

DENSE_FIELDS = ("slot_index", "slot_mask", "atom_slot", "eslot_src", "eslot_dst",
                "eslot_edge", "eslot_mask")
GOLDEN_CASES = [("gin", "last", "mean"), ("gin", "sum", "sum"), ("gcn", "last", "mean"),
                ("gat", "last", "mean"), ("gatv2", "last", "mean")]
# symmetric molecules: equal node features, so max pooling meets tied maxima
SYMMETRIC = ("c1ccccc1", "C1CCCCC1", "c1ccc2ccccc2c1", "CC(C)(C)C", "C=C", "OC(=O)C(=O)O")


def _cfg(**kw):
    return dict(dict(gnn_num_layer=3, gnn_emb_dim=32, dropout=0.0), **kw)


def _samples(n=6, seed=37):
    return make_synthetic_dataset(n, seed=seed, hyper=False, num_targets=1, with_pos=False)


def _smiles_samples():
    y = np.zeros(1, np.float32)
    return [mol_to_graph(mol_from_smiles(s), y=y) for s in SYMMETRIC]


def _one_column(samples):
    """The QM9 graph variants' layout: the bond type alone."""
    return [dataclasses.replace(s, edge_feat=s.edge_feat[:, :1].copy()) for s in samples]


def jax_graph_batch(samples, dense: bool):
    jb = jax_pad_graph(samples, jax_spec(samples, batch_size=8), target=0)
    assert (jb.slot_index is not None) and (jb.eslot_src is not None)
    if not dense:
        jb = jb.replace(**{f: None for f in DENSE_FIELDS})
    return jax.tree.map(jnp.asarray, jb)


def vanishing(model) -> set[str]:
    """Biases that feed a training-mode BatchNorm: their gradient is 0 in
    exact arithmetic (the norm removes any shift shared by every atom)."""
    names = set()
    for i in range(model.num_layer):
        if model.gnn_type == "gin":
            names |= {f"convs_{i}.mlp_lin0.bias", f"convs_{i}.mlp_lin1.bias"}
        elif model.gnn_type in ("gat", "gatv2"):
            names.add(f"convs_{i}.bias")
    if model.cfg.gnn_graph_pooling == "attention":
        names.add("pool_gate_lin0.bias")
    return names


def check_2d(method, cfg, samples, dense=False, bond_width=3, seed=0):
    """`method` in both frameworks at matched weights: eval forward,
    training forward, loss, gradients (every parameter reached in JAX is
    reached here) and running statistics. Returns (model, JAX's grads as a
    state dict, the number of parameters reached)."""
    jb = jax_graph_batch(samples, dense)
    tb = pad_graph_batch(samples, spec_for_samples(samples, batch_size=8), target=0)
    jmodel = jax_create_model(method, num_target=1, cfg=JaxModelConfig(**cfg), gnn_type=method)
    params, stats = random_variables(jmodel, jb, seed)
    ev, tr, lv, jgrads, new = jax_reference(jmodel, jb, params, stats, _jax_run(jmodel))
    model = create_model(method, num_target=1, cfg=ModelConfig(**cfg), gnn_type=method,
                         bond_width=bond_width)
    model.load_state_dict(params_from_jax(params, model, batch_stats=stats))
    with torch.no_grad():
        got = model.eval()(tb).numpy()
    assert got.shape == ev.shape == (9,)
    np.testing.assert_allclose(got, ev, atol=1e-5, rtol=1e-4)
    preds = model.train()(tb)
    np.testing.assert_allclose(preds.detach().numpy(), tr, atol=1e-5, rtol=1e-4)
    sq, cnt = masked_mse(preds, tb.y, tb.graph_mask)
    loss = sq / torch.clamp(cnt, min=1.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), lv, rtol=1e-5)
    want = params_from_jax(jgrads, model, batch_stats=new)
    top = max(float(w.abs().max()) for w in want.values())
    reached = 0
    for name, p in model.named_parameters():
        w = want[name]
        if name in vanishing(model):  # rounding in both: held to ~0, not to each other
            for g in (p.grad, w):
                assert float(g.abs().max()) <= 1e-5 * top, name
            reached += 1
            continue
        assert float(w.abs().max()) > 0, f"{name} unreached in JAX"
        assert p.grad is not None and float(p.grad.abs().max()) > 0, name
        reached += 1
        err, limit = float((p.grad - w).abs().max()), 1e-4 * float(w.abs().max()) + 1e-6
        assert err <= limit, f"{name}: max |d| {err:.3e} > {limit:.3e}"
    for name, buf in model.named_buffers():  # the training forward's statistics
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[name].numpy(), atol=1e-5, rtol=1e-4,
                                       err_msg=name)
    return model, want, reached


# ----------------------------------------------------------------- goldens


@pytest.mark.parametrize("gnn_type,jk,pooling", GOLDEN_CASES)
def test_gnn2d_golden(gnn_type, jk, pooling):
    """The reference GNN_2D's goldens through the JAX test's converter, in
    eval mode (`out::y`) and training mode (`out::y_train`)."""
    from test_reference_goldens import _model_cfg, _state, gnn2d_tree, load

    d = load(f"model_{gnn_type}_{jk}_{pooling}")
    jcfg = dataclasses.replace(_model_cfg(), gnn_num_layer=3, gnn_emb_dim=64, gnn_jk=jk,
                               gnn_graph_pooling=pooling)
    variables = gnn2d_tree(_state(d), gnn_type)
    model = create_model(gnn_type, num_target=1, cfg=ModelConfig(**dataclasses.asdict(jcfg)),
                         gnn_type=gnn_type)
    model.load_state_dict(params_from_jax(_flat(variables["params"]), model,
                                          batch_stats=_flat(variables["batch_stats"])))
    samples = make_synthetic_dataset(6, seed=71, hyper=False)
    spec = BatchSpec(num_graphs=8, num_atoms=256, num_hedges=512, nnz=512)
    batch = pad_graph_batch(samples, spec, target=0)
    with torch.no_grad():
        np.testing.assert_allclose(model.eval()(batch).numpy()[:6], d["out::y"],
                                   atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(model.train()(batch).numpy()[:6], d["out::y_train"],
                                   atol=2e-5, rtol=1e-4)


# ------------------------------------------------ the models against JAX


@pytest.mark.parametrize("method,dense", [("gin", False), ("gcn", False), ("gat", False),
                                          ("gat", True), ("gatv2", False), ("gatv2", True)],
                         ids=["gin", "gcn", "gat-flat", "gat-dense", "gatv2-flat",
                              "gatv2-dense"])
def test_models_match_jax(method, dense):
    """JK "last", mean pooling; GAT and GATv2 against JAX's dense view and
    its flat path (the port computes the flat one)."""
    model, _, reached = check_2d(method, _cfg(), _samples(), dense=dense)
    assert reached == len(list(model.parameters()))


@pytest.mark.parametrize("method,variant,smiles", [
    ("gin", dict(gnn_graph_pooling="sum"), False),
    ("gcn", dict(gnn_graph_pooling="max"), True),
    ("gat", dict(gnn_graph_pooling="attention"), False),
    ("gatv2", dict(gnn_graph_pooling="set2set"), False),
    ("gin", dict(gnn_jk="sum", gnn_residual=True, gnn_graph_pooling="max"), True),
], ids=["gin-sum", "gcn-max-ties", "gat-attention", "gatv2-set2set", "gin-jksum-residual-max"])
def test_poolings_jk_residual_match_jax(method, variant, smiles):
    """Every pooling, JK "sum" and `gnn_residual`. Max pooling runs on
    symmetric molecules, whose equal node features tie at the maximum: both
    frameworks split the gradient evenly among the tied atoms."""
    samples = _smiles_samples() if smiles else _samples()
    pooled = []
    if smiles:  # record what max pooling sees, to show the ties are there
        def record(x, graph_id, num_graphs, mask=None, reduce="sum"):
            pooled.append((x.detach(), graph_id, mask))
            return masked_segment_reduce(x, graph_id, num_graphs, reduce, mask=mask)

        old, baseline_2d.global_pool = baseline_2d.global_pool, record
    try:
        model, want, reached = check_2d(method, _cfg(**variant), samples)
    finally:
        if smiles:
            baseline_2d.global_pool = old
    assert reached == len(list(model.parameters()))
    if variant.get("gnn_graph_pooling") == "set2set":
        assert "pool_set2set.lstm.weight_ih" in want and "pool_set2set.lstm.bias_hh" in want
    if smiles:
        x, gid, mask = pooled[-1]
        x, gid = x[mask], gid[mask]
        ties = 0
        for g in torch.unique(gid):
            rows = x[gid == g]
            ties += int(((rows == rows.max(0).values).sum(0) > 1).sum())
        assert ties > 0


def test_one_column_bond_layout_matches_jax():
    """The QM9 graph variants' 1-column bond features: a BondEncoder table of
    the bond types' 5 rows, as JAX's."""
    model, want, _ = check_2d("gcn", _cfg(), _one_column(_samples()), bond_width=1)
    assert tuple(want["bond_encoder.bond.embedding"].shape) == (5, 32)
    with pytest.raises(ValueError, match="bond feature column"):
        model(pad_graph_batch(_samples(), spec_for_samples(_samples(), 8)))


def test_model_inits_follow_jax():
    """The port's own init follows JAX's laws: eps and the GAT bias zero,
    `root_emb` N(0, 1), glorot attention vectors, the LSTM's input kernels
    truncated at 2σ and its hidden blocks orthogonal."""
    gen = dict(generator=torch.Generator().manual_seed(0))
    gin = create_model("gin", num_target=1, cfg=ModelConfig(**_cfg()), **gen)
    assert float(gin.convs_0.eps.detach()) == 0.0 and gin.gnn_type == "gin"
    gcn = create_model("gcn", num_target=1, cfg=ModelConfig(**_cfg(gnn_emb_dim=512)), **gen)
    assert 0.9 < float(gcn.convs_0.root_emb.std()) < 1.1
    gat = create_model("gat", num_target=1, cfg=ModelConfig(**_cfg(
        gnn_graph_pooling="set2set")), **gen)
    att, bound = gat.convs_0.att_src, (6.0 / (4 + 32)) ** 0.5
    assert float(gat.convs_0.bias.abs().max()) == 0.0 and float(att.abs().max()) <= bound
    lstm = gat.pool_set2set.lstm
    std = (1.0 / 64) ** 0.5 / 0.87962566103423978
    assert float(lstm.weight_ih.abs().max()) <= 2 * std + 1e-7
    blk = lstm.weight_hh[:32]
    torch.testing.assert_close(blk @ blk.T, torch.eye(32), atol=1e-5, rtol=0)
    assert float(lstm.bias_hh.abs().max()) == 0.0
    assert create_model("gatv2", num_target=1, cfg=ModelConfig(**_cfg())).gnn_type == "gatv2"


def test_lstm_conversion_rejects_bad_trees():
    """An unused or missing key of the LSTM cell raises."""
    jb = jax_graph_batch(_samples(), False)
    cfg = _cfg(gnn_graph_pooling="set2set")
    jmodel = jax_create_model("gin", num_target=1, cfg=JaxModelConfig(**cfg), gnn_type="gin")
    params, stats = random_variables(jmodel, jb)
    model = create_model("gin", num_target=1, cfg=ModelConfig(**cfg))
    params_from_jax(params, model, batch_stats=stats)
    for fault in ("missing", "extra"):
        bad = dict(params)
        if fault == "missing":
            del bad["pool_set2set/lstm/hf/bias"]
        else:
            bad["pool_set2set/lstm/if/bias"] = np.zeros(32, np.float32)
        with pytest.raises(KeyError, match="LSTM cell"):
            params_from_jax(bad, model, batch_stats=stats)


# ------------------------------------------------------- a train step


def test_gin_adam_step_matches_jax():
    """One Adam step of `gin` against the JAX trainer's step: parameters and
    running statistics. Where JAX's gradient is below 1e-3 of its tensor's
    max (or vanishes in exact arithmetic), the sign of Adam's first step is
    rounding's: such an element is held to have moved by at most lr in both
    frameworks; every other element to 1e-2·lr."""
    cfg = _cfg()
    samples = _samples(seed=41)
    jb = jax_graph_batch(samples, False)
    tb = pad_graph_batch(samples, spec_for_samples(samples, batch_size=8), target=0)
    jmodel = jax_create_model("gin", num_target=1, cfg=JaxModelConfig(**cfg), gnn_type="gin")
    params, stats = random_variables(jmodel, jb, seed=1)
    lr, wd = 1e-3, 0.0
    jt = JaxTrainer(jmodel, JaxTrainConfig(lr=lr, weight_decay=wd, seed=0), jb, std=1.0)
    jp = _unflat(params)
    jp, _, jstats, jloss, _ = jt._step_fn(jp, jt.tx.init(jp), _unflat(stats), jb,
                                          np.float32(lr), jax.random.PRNGKey(1))
    model = create_model("gin", num_target=1, cfg=ModelConfig(**cfg))
    model.load_state_dict(params_from_jax(params, model, batch_stats=stats))
    start = {k: v.clone() for k, v in model.state_dict().items()}
    grads = params_from_jax(jax_reference(jmodel, jb, params, stats)[3], model,
                            batch_stats=stats)
    tloss = Trainer(model, TrainConfig(lr=lr, weight_decay=wd, seed=0), std=1.0,
                    device="cpu").train_step(tb)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    want = params_from_jax(_flat(jp), model, batch_stats=_flat(jstats))
    got = model.state_dict()
    n_stats = 0
    for name, w in want.items():
        if name.endswith(("running_mean", "running_var")):
            n_stats += 1
            assert not torch.equal(w, start[name]), name
            np.testing.assert_allclose(got[name].numpy(), w.numpy(),
                                       atol=1e-6 * float(w.abs().max()), rtol=0, err_msg=name)
            continue
        g = grads[name].abs()
        by_sign = g <= 1e-3 * float(g.max()) if name not in vanishing(model) else g >= 0
        for moved in (got[name] - start[name], w - start[name]):
            assert bool((moved.abs() <= lr * (1 + 1e-3))[by_sign].all()), name
        np.testing.assert_allclose(got[name][~by_sign].numpy(), w[~by_sign].numpy(),
                                   atol=1e-2 * lr, rtol=0, err_msg=name)
    assert n_stats == 2 * (3 + 3)  # batch_norms_i and each GINConv's mlp_bn


# ------------------------------------------------- segment max / softmax


def _segment_inputs(seed, m=200, s=40, d=5):
    """Ids with empty segments (every fourth id unused), a mask with False
    rows (one segment wholly masked), and tied maxima: in a few segments
    two kept rows share a value above every other row."""
    rng = np.random.default_rng(seed)
    ids = rng.choice(np.arange(0, s, 4), size=m).astype(np.int64)
    ids[:5] = s - 3  # a segment whose every entry is masked
    data = rng.standard_normal((m, d)).astype(np.float32)
    mask = rng.random(m) < 0.8
    mask[:5] = False
    for seg in (0, 8, 12):
        rows = np.flatnonzero((ids == seg) & mask)
        if len(rows) >= 2:
            data[rows[1]] = data[rows[0]] = data[rows].max(0) + 1.0
    return data, ids, mask, s


@pytest.mark.parametrize("fn", ["max", "softmax"])
@pytest.mark.parametrize("masked", [True, False])
def test_segment_max_softmax_match_jax(fn, masked):
    """Values and gradients (a random cotangent) against JAX, with empty
    segments (0 out), masks and tied maxima (the gradient split evenly)."""
    data, ids, mask, s = _segment_inputs(3)
    dy_shape = (s, data.shape[1]) if fn == "max" else data.shape
    dy = np.random.default_rng(4).standard_normal(dy_shape).astype(np.float32)
    jfn = {"max": jax_segment_max, "softmax": jax_segment_softmax}[fn]
    tfn = {"max": segment_max, "softmax": segment_softmax}[fn]
    jmask = jnp.asarray(mask) if masked else None
    want, vjp = jax.vjp(lambda x: jfn(x, jnp.asarray(ids), s, mask=jmask), jnp.asarray(data))
    want_dx, = vjp(jnp.asarray(dy))
    x = torch.from_numpy(data).requires_grad_()
    got = tfn(x, torch.from_numpy(ids), s, mask=torch.from_numpy(mask) if masked else None)
    (got * torch.from_numpy(dy)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_dx), atol=1e-6, rtol=1e-5)
    if fn == "max":
        empty = np.setdiff1d(np.arange(s), ids[mask] if masked else ids)
        assert len(empty) > 0 and np.all(got.detach().numpy()[empty] == 0.0)
        # the tied rows share their segment's gradient evenly
        rows = np.flatnonzero((ids == 0) & mask)
        if len(rows) >= 2 and masked:
            col = x.grad.numpy()[rows[:2]]
            np.testing.assert_allclose(col[0], col[1], rtol=0, atol=0)
            np.testing.assert_allclose(col[0], dy[0] / 2, rtol=1e-6)
    assert masked_segment_reduce(x, torch.from_numpy(ids), s, "max").shape == (s, 5)
