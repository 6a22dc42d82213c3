"""Model hyperparameter config mirroring the reference CLI namespace.

Copy of `equihgnn_tpu/models/config.py`, unchanged, so that a JAX run's
`meta.json` rebuilds the same configuration here. The PyTorch port reads
every field; it rejects the ones it does not support yet when a model is
built (see `models/equihnn_egnn.py`).

The reference passes the whole argparse namespace into every model
(`reference main.py:28-34`); we use an explicit frozen dataclass with the same
field meanings and the same defaults (`reference main.py:177-203`).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    all_num_layers: int = 3  # --All_num_layers
    mlp1_layers: int = 2  # --MLP1_num_layers
    mlp2_layers: int = 2  # --MLP2_num_layers
    mlp3_layers: int = 2  # --MLP3_num_layers
    mlp4_layers: int = 2  # --MLP4_num_layers
    mlp_hidden: int = 64  # --MLP_hidden
    output_num_layers: int = 2  # --output_num_layers
    output_hidden: int = 64  # --output_hidden
    aggregate: str = "mean"  # --aggregate {sum,mean}
    normalization: str = "ln"  # --normalization {bn,ln,None}
    activation: str = "relu"  # --activation {Id,relu,prelu}
    dropout: float = 0.0  # --dropout
    # GNN_2D-specific (`reference equihgnn/models/baseline_2d.py:82-92`)
    gnn_num_layer: int = 5
    gnn_emb_dim: int = 300
    gnn_jk: str = "last"
    gnn_residual: bool = False
    gnn_graph_pooling: str = "mean"
    # TPU-rebuild knobs (documented deviations / extensions)
    axis_name: str | None = None  # cross-replica axis for BatchNorm stats
    cross_molecule_knn: bool = False  # replicate reference batch-as-point-cloud kNN
    remat: bool = False  # jax.checkpoint over conv layers
    compute_dtype: str | None = None  # e.g. "bfloat16": cast activations after
    #   the encoders (params and loss stay float32) — halves HBM traffic on
    #   the TPU's bandwidth-bound steps

    @classmethod
    def from_args(cls, args) -> "ModelConfig":
        """Build from an argparse namespace with reference flag names."""
        get = lambda name, default: getattr(args, name, default)
        return cls(
            all_num_layers=get("All_num_layers", 3),
            mlp1_layers=get("MLP1_num_layers", 2),
            mlp2_layers=get("MLP2_num_layers", 2),
            mlp3_layers=get("MLP3_num_layers", 2),
            mlp4_layers=get("MLP4_num_layers", 2),
            mlp_hidden=get("MLP_hidden", 64),
            output_num_layers=get("output_num_layers", 2),
            output_hidden=get("output_hidden", 64),
            aggregate=get("aggregate", "mean"),
            normalization=get("normalization", "ln"),
            activation=get("activation", "relu"),
            dropout=get("dropout", 0.0),
            compute_dtype=get("compute_dtype", None),
            remat=bool(get("remat", False)),
        )
