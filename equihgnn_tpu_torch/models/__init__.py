"""Model registry of the port — importing this package registers every
ported model name: `mhnn`, `mhnns`, `mhnnm`, `egnn_equihnn{,s,m}`,
`faformer_equihnn{,s,m}`, `visnet_equihnn{,s,m}`, `se3_transformer_equihnns`,
`equiformer_equihnns`, and the 2-D baselines `gin`, `gcn`, `gat`, `gatv2`:
the JAX package's 18."""

from equihgnn_tpu_torch.models import (  # noqa: F401
    baseline_2d,
    equihnn_egnn,
    equihnn_equiformer,
    equihnn_fa_former,
    equihnn_se3_transformer,
    equihnn_visnet,
    mhnn,
)
from equihgnn_tpu_torch.models.config import ModelConfig  # noqa: F401
