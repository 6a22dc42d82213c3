"""Dataset base of the port: a list of ragged samples held in memory.

Cut from `equihgnn_tpu/data/datasets/base.py` `MolDataset`: the same
class attributes (`name`, `hyper`, `has_pos`, `num_targets`,
`partitioned`) and the same constructor, but `process()` runs at every
construction and nothing is cached on disk (the only ported dataset is
generated from a seed). The featurize-once `.npz` cache comes with the real
datasets.
"""

from __future__ import annotations


class MolDataset:
    """Dataset of ragged molecule samples, built by `process()`."""

    name: str = "base"
    hyper: bool = True
    has_pos: bool = False
    num_targets: int = 1
    partitioned: bool = False  # OPV-style pre-split train/valid/test

    def __init__(self, root: str, partition: str | None = None, **kwargs):
        self.root = root
        self.partition = partition
        self.kwargs = kwargs
        self.samples = self.process()

    def process(self) -> list:
        raise NotImplementedError

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        return self.samples[i]
