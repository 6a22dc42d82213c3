"""Split + target normalization.

Copy of `equihgnn_tpu/data/splits.py` (`reference
equihgnn/utils/data_split.py:8-79`), with the port's registry:

  * every non-partitioned dataset: an 80/10/10 random split drawn from
    `split_seed`; per-column normalization by the WHOLE dataset's mean and
    (ddof=1) std, the reference's mild normalization leak (`data_split.py:
    68-72`);
  * returns the scalar std of the selected target (used to de-normalize
    eval metrics, `reference main.py:68,102`).

The partitioned OPV branch (shipped train/valid/test partitions) raises
NotImplementedError until the OPV reader is ported.
"""

from __future__ import annotations

import numpy as np

from equihgnn_tpu_torch.common.registry import registry


def _normalize(samples_splits, mean: np.ndarray, std: np.ndarray):
    for split in samples_splits:
        for s in split:
            s.y = ((np.asarray(s.y, dtype=np.float32) - mean) / std).astype(np.float32)


def create_train_val_test_set_and_normalize(
    target: int,
    data_name: str,
    data_dir: str,
    split_seed: int = 0,
    **data_kwargs,
):
    import equihgnn_tpu_torch.data.datasets  # noqa: F401 — registration

    data_cls = registry.get_data_class(data_name)
    if data_cls is None:
        raise ValueError(f"Unknown or unported dataset name: {data_name!r}")
    print(f"Use {data_cls.__name__} dataset")
    if getattr(data_cls, "partitioned", False):
        raise NotImplementedError(
            f"{data_name}: partitioned (OPV) datasets are not ported yet (ROADMAP item 12)"
        )

    ds = data_cls(root=data_dir, **data_kwargs)
    n = len(ds)
    rng = np.random.default_rng(split_seed)
    perm = rng.permutation(n)
    n_train, n_valid = int(0.8 * n), int(0.1 * n)
    train_s = [ds.samples[i] for i in perm[:n_train]]
    valid_s = [ds.samples[i] for i in perm[n_train : n_train + n_valid]]
    test_s = [ds.samples[i] for i in perm[n_train + n_valid :]]
    y = np.stack([np.asarray(s.y, dtype=np.float32) for s in ds.samples])
    # torch .std() is the unbiased (ddof=1) estimator
    mean, std = y.mean(axis=0), y.std(axis=0, ddof=1)

    std = np.where(std == 0, 1.0, std)
    _normalize((train_s, valid_s, test_s), mean, std)
    t = int(target) if y.ndim > 1 and y.shape[1] > 1 else 0
    return train_s, valid_s, test_s, float(std.reshape(-1)[t])
