"""The dense face-keypoint regressor (NOVEL's auxiliary model).

Port of ``diner_tpu/models/novel/regressor.py`` (reference
``src/models/novel/dense_regressor.py``): the port's ResNet encoder
(``backbone``, resnet18 or resnet34, all four stages) with global average
pooling and a dense head regressing ``num_point × dim_output`` keypoints,
trained with an L1 loss and Adam. Parameter names follow the flax tree
(``backbone.*``, ``head``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.models.novel.model import LecunDense
from diner_tpu_torch.nn.resnet import ResNetEncoder


@dataclass(frozen=True)
class DenseRegressorConfig:
    backbone: str = "resnet18"
    num_point: int = 26317  # FaceScape's mesh vertices
    dim_output: int = 2
    lr: float = 1e-4


class DenseRegressor(nn.Module):
    def __init__(self, cfg: DenseRegressorConfig = DenseRegressorConfig(),
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        self.backbone = ResNetEncoder(backbone=cfg.backbone, num_layers=5,
                                      dtype=dtype)
        # flax nn.Dense: lecun normal kernel, zero bias
        self.head = LecunDense(512, cfg.num_point * cfg.dim_output,
                               dtype=dtype)

    def reset_parameters(self, generator: torch.Generator):
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)

    def forward(self, images, train: bool = True, update_stats: bool = False):
        """images (B, H, W, 3) → (B, num_point, dim_output)."""
        latents = self.backbone(images, train=train,
                                update_stats=update_stats)
        h = latents[-1].float().mean(dim=(1, 2))  # global average pool
        out = self.head(h)
        return out.reshape(out.shape[0], self.cfg.num_point,
                           self.cfg.dim_output)


class RegressorTrainStep:
    """One L1 step per call: ``batch {"image", "target_keypoints"} →
    {"total": loss}``, BN in train mode moving its running statistics, one
    Adam over every parameter; ``step`` counts the steps taken."""

    def __init__(self, model: DenseRegressor, lr: float):
        self.model = model
        self.optimizer = torch.optim.Adam(model.parameters(), lr=lr)
        self.step = 0

    def __call__(self, batch):
        dev = next(self.model.parameters()).device
        images = torch.as_tensor(batch["image"]).to(dev)
        target = torch.as_tensor(batch["target_keypoints"]).to(dev)
        self.optimizer.zero_grad(set_to_none=True)
        pred = self.model(images, train=True, update_stats=True)
        loss = torch.mean(torch.abs(target - pred))
        loss.backward()
        self.optimizer.step()
        self.step += 1
        return {"total": loss.detach()}


def create_regressor_state(cfg: DenseRegressorConfig, seed: int = 0,
                           device=None) -> RegressorTrainStep:
    """The regressor with weights from ``torch.Generator(seed)`` and its
    Adam, on ``device`` (``cuda`` unless the caller asks for the CPU)."""
    model = DenseRegressor(cfg)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return RegressorTrainStep(model.to(resolve_device(device)), cfg.lr)
