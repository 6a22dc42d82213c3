"""Model registry of the port — importing this package registers every
ported model name (today: `egnn_equihnns`, `faformer_equihnns`,
`visnet_equihnns`, `se3_transformer_equihnns`)."""

from equihgnn_tpu_torch.models.config import ModelConfig  # noqa: F401
from equihgnn_tpu_torch.models.equihnn_egnn import EGNNEquiHNNS  # noqa: F401
from equihgnn_tpu_torch.models.equihnn_fa_former import FAFormerEquiHNNS  # noqa: F401
from equihgnn_tpu_torch.models.equihnn_se3_transformer import SE3TransformerEquiHNNS  # noqa: F401
from equihgnn_tpu_torch.models.equihnn_visnet import VisNetEquiHNNS  # noqa: F401
