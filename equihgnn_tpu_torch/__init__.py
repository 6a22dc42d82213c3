"""equihgnn_tpu_torch: the PyTorch + CUDA port of equihgnn_tpu.

Runs on an NVIDIA H100 (`sm_90a`) and, with the plain PyTorch versions of
its kernels, on the CPU. It mirrors the module paths of the JAX package
`equihgnn_tpu`, which stays the reference it is tested against, and
imports nothing from it. Covered so far, in float32: serving
(`python -m equihgnn_tpu_torch.predict`) and training
(`python -m equihgnn_tpu_torch.main`) of `egnn_equihnns` and
`faformer_equihnns`.
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
