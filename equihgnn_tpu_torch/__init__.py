"""equihgnn_tpu_torch: the PyTorch + CUDA port of equihgnn_tpu.

Runs on an NVIDIA H100 (`sm_90a`) and, with the plain PyTorch versions of
its kernels, on the CPU. It mirrors the module paths of the JAX package
`equihgnn_tpu`, which stays the reference it is tested against, and
imports nothing from it. Covered so far, in float32: serving
(`python -m equihgnn_tpu_torch.predict`) and training
(`python -m equihgnn_tpu_torch.main`, `--remat` included) of all 18 of
the JAX package's models: the MHNN family `mhnn`, `mhnns`, `mhnnm`, the
EGNN, FAFormer and ViSNet encoders each with the MHNN, MHNNS and MHNNM
trunks (`egnn_equihnn{,s,m}`, `faformer_equihnn{,s,m}`,
`visnet_equihnn{,s,m}`; EGNN also with the batch-wide kNN,
`cross_molecule_knn=True`), `se3_transformer_equihnns`,
`equiformer_equihnns`, and the 2-D baselines `gin`, `gcn`, `gat`,
`gatv2` on plain graphs;
and, with `compute_dtype="bfloat16"`, `se3_transformer_equihnns` (its
encoder in bf16, as in JAX) at widths whose pooled units JAX does not
fuse, through kernels L and M, and the MHNN family and the three
`egnn_equihnn*` models (from the atom embedding to the prediction, as in
JAX), through the bf16 variants of kernels A, B and C. Every Pallas kernel
of the JAX package has its CUDA counterpart (`csrc/`).
"""

__version__ = "0.1.0"

from equihgnn_tpu_torch.common.registry import registry  # noqa: F401


def create_model(name: str, *args, **kwargs):
    """Resolve a registered model name and instantiate it, e.g.
    `create_model("egnn_equihnns", num_target=1, cfg=cfg, device="cuda")`."""
    import equihgnn_tpu_torch.models  # noqa: F401  (triggers registration)

    cls = registry.get_model_class(name)
    if cls is None:
        raise ValueError(f"Unknown or unported model name: {name!r}")
    return cls(*args, **kwargs)
