"""The port's plain-graph data path and SMILES serving vs the JAX package,
on the CPU: `synthetic_g` / `synthetic_g_3d`, `pad_graph_batch` and
`iter_batches(hyper=False)`, the SMILES parser and the `mol_to_graph` /
`smiles_to_hypergraph` featurizers, `predict.run --smiles` (for `gin` and
`mhnn`) and `--sdf` for the 2-D baselines, and `main.run --data
synthetic_g` for `gin`. Integer fields must be equal; predictions within
atol 1e-6 of the library path on the same molecules.
"""

import csv
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from equihgnn_tpu.data import featurize as jax_featurize
from equihgnn_tpu.data.batching import iter_batches as jax_iter_batches
from equihgnn_tpu.data.batching import pad_graph_batch as jax_pad_graph
from equihgnn_tpu.data.batching import spec_for_samples as jax_spec
from equihgnn_tpu.data.datasets.synthetic_ds import SyntheticGraph as JaxSyntheticGraph
from equihgnn_tpu.data.datasets.synthetic_ds import SyntheticGraph3D as JaxSyntheticGraph3D
from equihgnn_tpu.data.smiles import parse_smiles as jax_parse_smiles
from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.data import featurize
from equihgnn_tpu_torch.data.batching import iter_batches, pad_graph_batch, spec_for_samples
from equihgnn_tpu_torch.data.datasets import SyntheticGraph, SyntheticGraph3D
from equihgnn_tpu_torch.data.smiles import parse_smiles
from equihgnn_tpu_torch.data.structures import GraphBatch
from equihgnn_tpu_torch.models.config import ModelConfig
from test_smiles import CASES

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SDF = os.path.join(ROOT, "datasets", "real_sample", "sample.sdf")
GRAPH_FIELDS = ("atom_feat", "atom_mask", "atom_graph_id", "edge_src", "edge_dst", "edge_mask",
                "edge_feat", "y", "graph_mask", "pos", "z")
# test_smiles.py's other cases: charges, salts, brackets, ring closures, garbage
EXTRA_SMILES = ("c1cc[nH]c1", "c1ccsc1", "[NH4+]", "O", "c1ccccc1[N+](=O)[O-]",
                "CC(=O)[O-].[Na+]", "C%10CCCCC%10", "C=1CCCCC=1", "C=1CCCCC#1", "C1CCC",
                "c1cc[se]1", "ClCCBr", "[13CH4]", "[C@@H](N)(C)O", "", "X", "C(", "[Zz]")


@pytest.mark.parametrize("cls,jcls,has_pos", [(SyntheticGraph, JaxSyntheticGraph, False),
                                              (SyntheticGraph3D, JaxSyntheticGraph3D, True)])
def test_synthetic_g_matches_jax(tmp_path, cls, jcls, has_pos):
    ours = cls(root=str(tmp_path), size=20, seed=5).samples
    theirs = jcls(root=str(tmp_path / "jax"), size=20, seed=5).samples
    assert cls.hyper is False and cls.has_pos is has_pos and len(ours) == len(theirs) == 20
    for a, b in zip(ours, theirs):
        for f in ("atom_feat", "edge_src", "edge_dst", "edge_feat", "y", "pos", "z"):
            x, w = getattr(a, f), getattr(b, f)
            assert (x is None) == (w is None) == (f in ("pos", "z") and not has_pos), f
            if x is not None:
                np.testing.assert_array_equal(x, w, err_msg=f)
        # both directions of a bond, interleaved (i, j), (j, i)
        np.testing.assert_array_equal(a.edge_src[0::2], a.edge_dst[1::2])
        np.testing.assert_array_equal(a.edge_feat[0::2], a.edge_feat[1::2])


@pytest.mark.parametrize("with_pos,width", [(False, 3), (True, 3), (False, 1)])
def test_pad_graph_batch_matches_jax(with_pos, width):
    """The flat fields equal JAX's (int64 here); padded edges point at the
    last atom with edge_mask False, padded atoms belong to the padding
    graph; the edge features keep the samples' width (1: the QM9 graph
    variants); `iter_batches(hyper=False)` packs as JAX's."""
    samples = SyntheticGraph3D(root="", size=23, seed=9).samples
    if width == 1:
        samples = [dataclasses.replace(s, edge_feat=s.edge_feat[:, :1].copy()) for s in samples]
    spec, jspec = spec_for_samples(samples[:7], 8), jax_spec(samples[:7], 8)
    assert (spec.num_graphs, spec.num_atoms, spec.num_hedges) == (
        jspec.num_graphs, jspec.num_atoms, jspec.num_hedges)
    tb = pad_graph_batch(samples[:7], spec, target=0, with_pos=with_pos)
    jb = jax_pad_graph(samples[:7], jspec, target=0, with_pos=with_pos)
    assert isinstance(tb, GraphBatch) and tb.edge_feat.shape[1] == width
    for name in GRAPH_FIELDS:
        got, want = getattr(tb, name), getattr(jb, name)
        assert (got is None) == (want is None) == (name in ("pos", "z") and not with_pos), name
        if got is None:
            continue
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=name)
        if got.dtype not in (torch.bool, torch.float32):
            assert got.dtype == torch.int64, name
    pad = ~tb.edge_mask
    assert bool(pad.any()) and bool((tb.edge_src[pad] == tb.num_atoms - 1).all())
    assert bool((tb.edge_dst[pad] == tb.num_atoms - 1).all())
    assert bool((tb.atom_graph_id[~tb.atom_mask] == tb.num_graphs - 1).all())
    got = [b.graph_mask.numpy() for b in iter_batches(samples, spec, hyper=False, target=0)]
    want = [np.asarray(b.graph_mask) for b in jax_iter_batches(samples, jspec, hyper=False,
                                                                target=0)]
    assert len(got) == len(want) > 1
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    moved = tb.pin_memory().to("cpu") if torch.cuda.is_available() else tb.to("cpu")
    assert moved.num_atoms == tb.num_atoms and moved.num_graphs == 9


def _atoms_bonds(mol):
    atoms = [(a.GetAtomicNum(), a.GetFormalCharge(), a.GetTotalNumHs(), a.GetIsAromatic(),
              a.IsInRing(), str(a.GetHybridization())) for a in mol.GetAtoms()]
    bonds = [(b.GetBeginAtomIdx(), b.GetEndAtomIdx(), str(b.GetBondType()),
              b.GetIsConjugated()) for b in mol.GetBonds()]
    return atoms, bonds


@pytest.mark.parametrize("smi", [c[0] for c in CASES.values()] + list(EXTRA_SMILES))
def test_smiles_parser_and_features_match_jax(smi):
    """The same atoms and bonds as JAX's parser on `tests/test_smiles.py`'s
    cases (None where JAX's rejects), and the same `mol_to_graph` and
    `smiles_to_hypergraph` features."""
    mol, jmol = parse_smiles(smi), jax_parse_smiles(smi)
    assert (mol is None) == (jmol is None), smi
    if mol is None:
        assert featurize.smiles_to_hypergraph(smi) is None
        return
    assert _atoms_bonds(mol) == _atoms_bonds(jmol)
    y = np.float32([0.5])
    g, jg = featurize.mol_to_graph(mol, y=y), jax_featurize.mol_to_graph(jmol, y=y)
    for f in ("atom_feat", "edge_src", "edge_dst", "edge_feat", "y"):
        np.testing.assert_array_equal(getattr(g, f), getattr(jg, f), err_msg=f)
    h = featurize.smiles_to_hypergraph(smi, y=y)
    jh = jax_featurize.smiles_to_hypergraph(smi, y=y)
    assert h.smi == jh.smi == smi
    for f in ("atom_feat", "vertex_idx", "hedge_idx", "hedge_feat", "y"):
        np.testing.assert_array_equal(getattr(h, f), getattr(jh, f), err_msg=f)


def _predictions(path):
    with open(path) as f:
        return [(r["title"], float(r["prediction"])) for r in csv.DictReader(f)]


@pytest.mark.parametrize("method", ["gin", "mhnn"])
def test_predict_serves_smiles(tmp_path, method):
    """`predict.run --smiles` for a 2-D baseline and for the MHNN family:
    one row a non-blank line, titled by its SMILES; a SMILES that does not
    parse gives `nan`, as in JAX; the others equal the library path on the
    same molecules. `gin` also serves the SDF; a geometric method refuses
    `--smiles`."""
    from equihgnn_tpu_torch.predict import (
        build_parser,
        featurize_smiles_file,
        predict_samples,
        run,
        save_checkpoint,
    )

    cfg = ModelConfig(mlp_hidden=16, output_hidden=8, gnn_num_layer=2, gnn_emb_dim=16)
    extra = {"gnn_type": method} if method == "gin" else {}
    model = create_model(method, num_target=1, cfg=cfg,
                         generator=torch.Generator().manual_seed(1), **extra)
    ckpt = save_checkpoint(str(tmp_path / "m.pt"), model, method, cfg, std=2.0)
    smi = tmp_path / "in.smi"
    smi.write_text("CCO\nc1ccccc1\n\nC1CCC\nCC(=O)O\n")
    out = str(tmp_path / "p.csv")
    run(build_parser().parse_args(["--ckpt", ckpt, "--smiles", str(smi), "--out", out,
                                   "--device", "cpu"]))
    rows = _predictions(out)
    assert [t for t, _ in rows] == ["CCO", "c1ccccc1", "C1CCC", "CC(=O)O"]
    assert np.isnan(rows[2][1]) and np.isfinite([v for _, v in rows if _ != "C1CCC"]).all()
    samples = [s for _, s in featurize_smiles_file(str(smi), hyper=method != "gin") if s]
    want = predict_samples(model.eval(), samples, 8, torch.device("cpu")) * 2.0
    np.testing.assert_allclose([v for t, v in rows if t != "C1CCC"], want, atol=1e-6, rtol=0)
    if method == "gin":
        run(build_parser().parse_args(["--ckpt", ckpt, "--sdf", SDF, "--out", out,
                                       "--device", "cpu"]))
        sdf_rows = dict(_predictions(out))
        assert len(sdf_rows) == 20 and np.isfinite(list(sdf_rows.values())).all()
        # benzene from the SDF is benzene from its SMILES
        np.testing.assert_allclose(sdf_rows["benzene"], rows[1][1], atol=1e-6, rtol=0)
    egnn = create_model("egnn_equihnns", num_target=1, cfg=cfg)
    ckpt3d = save_checkpoint(str(tmp_path / "e.pt"), egnn, "egnn_equihnns", cfg)
    with pytest.raises(ValueError, match="needs 3-D coordinates"):
        run(build_parser().parse_args(["--ckpt", ckpt3d, "--smiles", str(smi), "--out", out,
                                       "--device", "cpu"]))


def test_main_trains_gin_on_synthetic_g(tmp_path, monkeypatch):
    """`main.run --data synthetic_g --method gin` for one epoch on the CPU:
    the checkpoint carries the BatchNorms' running statistics and its meta
    the `gnn_*` fields; it serves through `predict.run`."""
    from equihgnn_tpu_torch.main import build_parser, run
    from equihgnn_tpu_torch.predict import build_parser as predict_parser
    from equihgnn_tpu_torch.predict import run as predict_run

    monkeypatch.chdir(tmp_path)
    args = build_parser().parse_args([
        "--data", "synthetic_g", "--method", "gin", "--device", "cpu", "--epochs", "1",
        "--batch_size", "16", "--synthetic_size", "64", "--lr", "1e-3"])
    res = run(args)
    assert len(res["history"]) == 1 and np.isfinite(res["test_mae_mean"])
    assert res["history"][0]["train_steps"] >= 3
    ckpt = os.path.join(res["log_dir"], "ckpt_best.pt")
    state = torch.load(ckpt, weights_only=True)
    assert float(state["batch_norms_0.running_var"].sub(1).abs().max()) > 0
    assert float(state["convs_4.mlp_bn.running_mean"].abs().max()) > 0
    assert state["atom_encoder.atom.embedding"].shape == (173, 300)
    with open(ckpt + ".meta.json") as f:
        meta = json.load(f)
    assert meta["method"] == "gin"
    assert {k: meta["model_config"][k] for k in ("gnn_num_layer", "gnn_emb_dim", "gnn_jk",
                                                  "gnn_residual", "gnn_graph_pooling")} == dict(
        gnn_num_layer=5, gnn_emb_dim=300, gnn_jk="last", gnn_residual=False,
        gnn_graph_pooling="mean")
    out = str(tmp_path / "preds.csv")
    predict_run(predict_parser().parse_args(["--ckpt", ckpt, "--sdf", SDF, "--out", out,
                                             "--device", "cpu"]))
    vals = [v for _, v in _predictions(out)]
    assert len(vals) == 20 and np.isfinite(vals).all()
