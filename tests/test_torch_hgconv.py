"""Port's `MHNNConv` and `MHNNSConv` vs the JAX package's flat path and the
reference goldens, on the CPU.

Hidden 16 on the incidence of a padded batch of 5 synthetic molecules
(padded atoms, hyperedges and incidence entries included), weights drawn
at O(0.3) from numpy and converted with `params_from_jax`. JAX runs its
flat segment path (no slot tables; on the CPU kernel A's reference, as the
port's plain version). Cases: sum and mean, the identity slice
(`mlp*_layers <= 0`), and "bn" with the masks of the rows each MLP runs
over, in eval mode (random running statistics) and training mode (batch
statistics, and the running statistics after the forward). Tolerance atol
1e-5, rtol 1e-4 (f32 sums in other orders); the goldens keep the JAX
test's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from equihgnn_tpu.nn.hgconv import MHNNConv as JaxMHNNConv
from equihgnn_tpu.nn.hgconv import MHNNSConv as JaxMHNNSConv
from equihgnn_tpu_torch.convert import params_from_jax
from equihgnn_tpu_torch.data.batching import pad_hypergraph_batch, spec_for_samples
from equihgnn_tpu_torch.data.synthetic import make_synthetic_dataset
from equihgnn_tpu_torch.nn.hgconv import MHNNConv, MHNNSConv
from test_torch_mhnn import _flat, _variables

torch.set_num_threads(1)

D = 16
GEN = dict(generator=torch.Generator().manual_seed(0))


def _random_vars(jmodule, *args, seed=0, **kw):
    """(params, batch_stats), flat: O(0.3) draws, norm scales around 1,
    running means around 0 and variances in [0.5, 1.5]."""
    shapes = jax.eval_shape(lambda: jmodule.init(jax.random.PRNGKey(0), *args, **kw))
    rng = np.random.default_rng(seed)
    params, stats = {}, {}
    for k, v in traverse_util.flatten_dict(shapes["params"], sep="/").items():
        x = (rng.standard_normal(v.shape) * 0.3).astype(np.float32)
        params[k] = x + 1.0 if k.endswith("scale") else x
    for k, v in traverse_util.flatten_dict(shapes.get("batch_stats", {}), sep="/").items():
        stats[k] = (rng.uniform(0.5, 1.5, v.shape) if k.endswith("var")
                    else rng.standard_normal(v.shape) * 0.2).astype(np.float32)
    return params, stats


def _incidence():
    """A padded batch's incidence (port tensors) and the same arrays in JAX."""
    samples = make_synthetic_dataset(5, seed=8, num_targets=1, with_pos=False)
    tb = pad_hypergraph_batch(samples, spec_for_samples(samples, batch_size=8), target=0)
    assert not bool(tb.inc_mask.all()) and not bool(tb.hedge_mask.all())
    names = ("vertex_idx", "hedge_idx", "inc_mask", "atom_mask", "hedge_mask")
    tt = {n: getattr(tb, n) for n in names}
    jj = {n: jnp.asarray(t.numpy().astype(np.int32) if t.dtype == torch.int64 else t.numpy())
          for n, t in tt.items()}
    return tb, tt, jj


def _features(tb, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((tb.num_atoms, D)).astype(np.float32)
    e = rng.standard_normal((tb.num_hedges, D)).astype(np.float32)
    return x, e


CONV_CASES = {
    "sum": dict(aggr="sum", layers=(2, 2, 2, 2), norm="ln"),
    "mean": dict(aggr="mean", layers=(2, 2, 2, 2), norm="ln"),
    "idslice": dict(aggr="mean", layers=(0, 2, 0, 1), norm="None"),
    "bn": dict(aggr="mean", layers=(2, 2, 2, 2), norm="bn"),
    "bn_sum": dict(aggr="sum", layers=(1, 3, 2, 2), norm="bn"),
}


def _conv_pair(case):
    c = CONV_CASES[case]
    l1, l2, l3, l4 = c["layers"]
    kw = dict(mlp1_layers=l1, mlp2_layers=l2, mlp3_layers=l3, mlp4_layers=l4,
              aggr=c["aggr"], dropout=0.0, normalization=c["norm"])
    return JaxMHNNConv(hid_dim=D, **kw), MHNNConv(D, **kw, **GEN)


# (case, training mode): the "ln" and "None" convs are the same in both modes
@pytest.mark.parametrize("case,train", [("sum", False), ("mean", False), ("idslice", False),
                                        ("bn", False), ("bn", True), ("bn_sum", True)])
def test_mhnnconv_matches_jax(case, train):
    tb, tt, jj = _incidence()
    x, e = _features(tb)
    jm, tm = _conv_pair(case)
    jargs = (jnp.asarray(x), jnp.asarray(e), jj["vertex_idx"], jj["hedge_idx"], jj["inc_mask"])
    jkw = dict(atom_mask=jj["atom_mask"], hedge_mask=jj["hedge_mask"])
    params, stats = _random_vars(jm, *jargs, **jkw)
    if train:
        (jx, je), mut = jax.jit(lambda v: jm.apply(
            v, *jargs, **jkw, deterministic=False, mutable=["batch_stats"]))(
                _variables(params, stats))
    else:
        jx, je = jax.jit(lambda v: jm.apply(v, *jargs, **jkw))(_variables(params, stats))
    tm.load_state_dict(params_from_jax(params, tm, batch_stats=stats))
    tm.train(train)
    with torch.no_grad():
        tx, te = tm(torch.from_numpy(x), torch.from_numpy(e), tt["vertex_idx"],
                    tt["hedge_idx"], tt["inc_mask"], atom_mask=tt["atom_mask"],
                    hedge_mask=tt["hedge_mask"])
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), atol=1e-5, rtol=1e-4)
    if train:  # the running statistics after the forward
        want = params_from_jax(params, tm, batch_stats=_flat(mut["batch_stats"]))
        got = tm.state_dict()
        moved = 0
        for k in (k for k in got if k.endswith(("running_mean", "running_var"))):
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-6, rtol=1e-5,
                                       err_msg=k)
            moved += int(not np.allclose(want[k].numpy(), stats[_jax_stats_path(k)]))
        assert moved == 2 * sum(CONV_CASES[case]["layers"][i] - 1 for i in range(4))


def _jax_stats_path(key):
    """`W1.norm_0.running_mean` → `W1/norm_0/MaskedBatchNorm_0/mean`."""
    *mods, leaf = key.split(".")
    return "/".join(mods + ["MaskedBatchNorm_0", leaf.replace("running_", "")])


def test_mhnnconv_padded_hyperedges_get_no_message():
    """A padded hyperedge has no kept incidence entry: its V→E message is 0
    (JAX's dense path zeros it with hedge_mask), so with the identity W2
    slice its output row is 0, and no real row depends on padded rows."""
    tb, tt, _ = _incidence()
    x, e = _features(tb)
    tm = MHNNConv(D, mlp1_layers=2, mlp2_layers=0, mlp3_layers=2, mlp4_layers=2, **GEN).eval()
    args = (tt["vertex_idx"], tt["hedge_idx"], tt["inc_mask"])
    with torch.no_grad():
        tx, te = tm(torch.from_numpy(x), torch.from_numpy(e), *args)
        x2, e2 = x.copy(), e.copy()
        x2[~tt["atom_mask"].numpy()] = 7.0
        e2[~tt["hedge_mask"].numpy()] = -7.0
        tx2, te2 = tm(torch.from_numpy(x2), torch.from_numpy(e2), *args)
    pad_e = ~tt["hedge_mask"]
    assert bool(pad_e.any()) and bool((te[pad_e] == 0).all())
    real = tt["atom_mask"]
    torch.testing.assert_close(tx2[real], tx[real], rtol=0, atol=0)
    torch.testing.assert_close(te2[~pad_e], te[~pad_e], rtol=0, atol=0)


@pytest.mark.parametrize("norm", ["ln", "bn"])
def test_mhnnsconv_matches_jax(norm):
    tb, tt, jj = _incidence()
    x, _ = _features(tb)
    x0 = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    kw = dict(mlp1_layers=2, mlp2_layers=2, mlp3_layers=2, aggr="mean", dropout=0.0,
              normalization=norm)
    jm, tm = JaxMHNNSConv(hid_dim=D, **kw), MHNNSConv(D, **kw, **GEN)
    jargs = (jnp.asarray(x), jj["vertex_idx"], jj["hedge_idx"], jj["inc_mask"],
             jnp.asarray(x0), tb.num_hedges)
    params, stats = _random_vars(jm, *jargs, atom_mask=jj["atom_mask"])
    tm.load_state_dict(params_from_jax(params, tm, batch_stats=stats))
    for train in (False, True):
        fn = lambda v: jm.apply(v, *jargs, atom_mask=jj["atom_mask"],  # noqa: E731
                                deterministic=not train, mutable=["batch_stats"])
        want, _ = fn(_variables(params, stats))
        with torch.no_grad():
            got = tm.train(train)(torch.from_numpy(x), tt["vertex_idx"], tt["hedge_idx"],
                                  tt["inc_mask"], torch.from_numpy(x0), tb.num_hedges,
                                  atom_mask=tt["atom_mask"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-4)


# ------------------------------------------------------------------ goldens


def _golden_conv(name, counts, norm):
    from test_reference_goldens import _state, conv_tree, load

    d = load(name)
    params, stats = conv_tree(_state(d), counts, norm)
    assert not stats
    v = torch.from_numpy(d["in::vertex"].astype(np.int64))
    h = torch.from_numpy(d["in::edges"].astype(np.int64))
    return d, _flat(params), v, h, torch.ones(v.shape, dtype=torch.bool)


@pytest.mark.parametrize("name,counts,aggr,norm", [
    ("mhnnconv_mean", {"W1": 2, "W2": 2, "W3": 2, "W4": 2}, "mean", "ln"),
    ("mhnnconv_sum", {"W1": 2, "W2": 2, "W3": 2, "W4": 2}, "sum", "ln"),
    ("mhnnconv_idslice", {"W2": 2, "W4": 1}, "mean", "None"),
])
def test_mhnnconv_golden(name, counts, aggr, norm):
    d, flat, v, h, mask = _golden_conv(name, counts, norm)
    layers = {k: counts.get(k, 0) for k in ("W1", "W2", "W3", "W4")}
    tm = MHNNConv(48, mlp1_layers=layers["W1"], mlp2_layers=layers["W2"],
                  mlp3_layers=layers["W3"], mlp4_layers=layers["W4"], aggr=aggr,
                  normalization=norm, **GEN)
    tm.load_state_dict(params_from_jax(flat, tm))
    with torch.no_grad():
        xo, eo = tm.eval()(torch.from_numpy(d["in::X"]), torch.from_numpy(d["in::E"]), v, h,
                           mask)
    np.testing.assert_allclose(xo.numpy(), d["out::X"], atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(eo.numpy(), d["out::E"], atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("aggr", ["mean", "sum"])
def test_mhnnsconv_golden(aggr):
    d, flat, v, h, mask = _golden_conv(f"mhnnsconv_{aggr}", {"W1": 2, "W2": 2, "W3": 2}, "ln")
    tm = MHNNSConv(48, mlp1_layers=2, mlp2_layers=2, mlp3_layers=2, aggr=aggr,
                   normalization="ln", **GEN)
    tm.load_state_dict(params_from_jax(flat, tm))
    with torch.no_grad():
        xo = tm.eval()(torch.from_numpy(d["in::X"]), v, h, mask,
                       torch.from_numpy(d["in::X0"]), int(d["in::edges"].max()) + 1)
    np.testing.assert_allclose(xo.numpy(), d["out::X"], atol=1e-5, rtol=1e-4)
