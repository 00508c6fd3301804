"""Losses of the DINER train step: MSE, antibias and VGG19 perceptual."""

from diner_tpu_torch.losses.basic import antibias_loss, l1_loss, mse_loss
from diner_tpu_torch.losses.vgg import VGG19Features, init_vgg19, vgg_loss

__all__ = ["mse_loss", "l1_loss", "antibias_loss", "VGG19Features",
           "init_vgg19", "vgg_loss"]
