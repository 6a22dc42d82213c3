"""Port's serving CLI: port checkpoint + SDF → predictions CSV, on the CPU.

Also: `--device cuda` raises where no card is available, and the port
imports nothing of JAX (checked in a fresh interpreter).
"""

import csv
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from equihgnn_tpu_torch import create_model
from equihgnn_tpu_torch.models.config import ModelConfig
from equihgnn_tpu_torch.predict import (
    build_parser,
    featurize_sdf,
    predict_samples,
    run,
    save_checkpoint,
)

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SDF = os.path.join(ROOT, "datasets", "real_sample", "sample.sdf")
CFG = ModelConfig(mlp_hidden=16, output_hidden=8)


def _ckpt(tmp_path, std=2.0):
    model = create_model("egnn_equihnns", num_target=1, cfg=CFG,
                         generator=torch.Generator().manual_seed(7))
    return model, save_checkpoint(str(tmp_path / "model.pt"), model,
                                  "egnn_equihnns", CFG, std=std)


def _rows(path):
    with open(path) as f:
        return list(csv.DictReader(f))


def test_predict_cpu_on_real_sdf(tmp_path):
    model, ckpt = _ckpt(tmp_path)
    out = str(tmp_path / "preds.csv")
    run(build_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", SDF, "--out", out, "--device", "cpu",
         "--batch_size", "8"]))
    rows = _rows(out)
    assert len(rows) == 20
    assert [r["title"] for r in rows][:5] == ["methane", "ethane", "ethylene",
                                             "acetylene", "benzene"]
    vals = np.array([float(r["prediction"]) for r in rows])
    assert np.isfinite(vals).all()
    # de-normalized by the stored std, and equal to the library path
    samples = [s for _, s in featurize_sdf(SDF)]
    want = predict_samples(model.eval(), samples, 8, torch.device("cpu")) * 2.0
    np.testing.assert_allclose(vals, want, rtol=1e-6, atol=1e-6)


def test_predict_faformer_cpu_on_real_sdf(tmp_path):
    model = create_model("faformer_equihnns", num_target=1, cfg=CFG,
                         generator=torch.Generator().manual_seed(7))
    ckpt = save_checkpoint(str(tmp_path / "fa.pt"), model, "faformer_equihnns", CFG, std=2.0)
    out = str(tmp_path / "preds.csv")
    run(build_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", SDF, "--out", out, "--device", "cpu", "--batch_size", "8"]))
    rows = _rows(out)
    assert [r["title"] for r in rows][4] == "benzene" and len(rows) == 20
    vals = np.array([float(r["prediction"]) for r in rows])
    samples = [s for _, s in featurize_sdf(SDF)]
    want = predict_samples(model.eval(), samples, 8, torch.device("cpu")) * 2.0
    assert np.isfinite(vals).all()
    np.testing.assert_allclose(vals, want, rtol=1e-6, atol=1e-6)


def test_methane_has_one_atom_and_no_hyperedges():
    title, sample = featurize_sdf(SDF)[0]
    assert title == "methane"
    assert sample.n_atoms == 1 and sample.n_hedges == 0 and sample.nnz == 0


def test_batch_size_does_not_change_predictions(tmp_path):
    _, ckpt = _ckpt(tmp_path)
    outs = []
    for bs in ("3", "256"):
        out = str(tmp_path / f"preds_{bs}.csv")
        run(build_parser().parse_args(
            ["--ckpt", ckpt, "--sdf", SDF, "--out", out, "--device", "cpu",
             "--batch_size", bs]))
        outs.append(np.array([float(r["prediction"]) for r in _rows(out)]))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6)


def test_predict_cuda_raises_without_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, ckpt = _ckpt(tmp_path)
    args = build_parser().parse_args(
        ["--ckpt", ckpt, "--sdf", SDF, "--out", str(tmp_path / "p.csv")])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run(args)
    assert not os.path.exists(tmp_path / "p.csv")


def test_missing_meta_raises(tmp_path):
    _, ckpt = _ckpt(tmp_path)
    os.remove(ckpt + ".meta.json")
    with pytest.raises(FileNotFoundError):
        run(build_parser().parse_args(
            ["--ckpt", ckpt, "--sdf", SDF, "--out", str(tmp_path / "p.csv"),
             "--device", "cpu"]))


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import equihgnn_tpu_torch, equihgnn_tpu_torch.predict, equihgnn_tpu_torch.convert\n"
        "import equihgnn_tpu_torch.models, equihgnn_tpu_torch.main\n"
        "import equihgnn_tpu_torch.train.trainer, equihgnn_tpu_torch.data.datasets\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'equihgnn_tpu'))\n"
        "print(bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"
