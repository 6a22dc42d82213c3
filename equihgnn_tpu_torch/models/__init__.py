"""Model registry of the port — importing this package registers every
ported model name (today: `egnn_equihnns`, `faformer_equihnns`)."""

from equihgnn_tpu_torch.models.config import ModelConfig  # noqa: F401
from equihgnn_tpu_torch.models.equihnn_egnn import EGNNEquiHNNS  # noqa: F401
from equihgnn_tpu_torch.models.equihnn_fa_former import FAFormerEquiHNNS  # noqa: F401
