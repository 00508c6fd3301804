"""KeypointNeRF: the keypoint-conditioned generalizable NeRF baseline, its
renderer, losses, training step and full-image renderer."""

from diner_tpu_torch.models.keypointnerf.model import (
    KeypointNeRF,
    KeypointNeRFConfig,
)

__all__ = ["KeypointNeRF", "KeypointNeRFConfig"]
