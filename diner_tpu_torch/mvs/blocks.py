"""Conv building blocks of TransMVSNet (channels-first), with the compute
dtype, the train-mode BatchNorm and rematerialisation.

Port of ``diner_tpu/mvs/blocks.py``, written as the reference's own
wrappers (``deps/TransMVSNet/models/module.py`` Conv2d / Conv3d /
Deconv3d: ``conv`` + BatchNorm (eps 1e-5) + ReLU) so a reference checkpoint
loads by name. The JAX package's channel-free ``TapConvIn1`` /
``TapConvOut1`` are a TPU layout device: here the C_in = 1 and C_out = 1
convolutions are plain 3-D convolutions on a (B, 1, D, H, W) view.
``DeconvBnReLU3D`` is a transposed convolution (k=3, s=2, p=1,
output_padding=1), the reference's module; the JAX package computes it as
an interior pad and a VALID convolution with the kernel flipped
(``utils/convert.py`` undoes the flip).

The compute dtype: :class:`Conv2d`, :class:`Conv3d`,
:class:`ConvTranspose3d`, :class:`Linear` and :class:`LayerNorm` keep f32
parameters and compute in their ``dtype`` (flax's ``dtype=``), casting
input and parameters at use; :func:`set_compute_dtype` sets it on every
such module of a model. At f32 each is its torch module's own forward.

:class:`BatchNorm` is flax's ``BatchNorm(momentum=0.9, epsilon=1e-5)``:
in train mode it normalises with two-pass f32 batch statistics and updates
the running ones with the biased batch variance (torch's BatchNorm takes
the unbiased one); in eval mode it is ``F.batch_norm`` with the running
statistics (in f32 for another dtype); the output is cast to the input's
dtype. Statistics are not updated while :func:`remat` recomputes a forward
in the backward, so a step updates them once, as flax's remat does.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

_state = {"recomputing": False}


@contextlib.contextmanager
def _recomputing():
    prev = _state["recomputing"]
    _state["recomputing"] = True
    try:
        yield
    finally:
        _state["recomputing"] = prev


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (``torch.utils.checkpoint``, non-reentrant), BN statistics left
    alone in the recomputation. Without grad mode it is a plain call."""
    if not torch.is_grad_enabled():
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(),
                                          _recomputing()))


class _Cast:
    """Mixin: the compute dtype of a module whose parameters stay f32."""

    dtype = torch.float32

    def _cast(self, x, *params):
        dt = self.dtype
        return (x.to(dt),) + tuple(None if p is None else p.to(dt)
                                   for p in params)


class Conv2d(_Cast, nn.Conv2d):
    def forward(self, x):
        x, w, b = self._cast(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


class Conv3d(_Cast, nn.Conv3d):
    def forward(self, x):
        x, w, b = self._cast(x, self.weight, self.bias)
        return self._conv_forward(x, w, b)


class ConvTranspose3d(_Cast, nn.ConvTranspose3d):
    def forward(self, x):
        x, w, b = self._cast(x, self.weight, self.bias)
        return F.conv_transpose3d(x, w, b, self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class Linear(_Cast, nn.Linear):
    def forward(self, x):
        return F.linear(*self._cast(x, self.weight, self.bias))


class LayerNorm(_Cast, nn.LayerNorm):
    """Statistics and affine in f32, the output in the compute dtype."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(self.dtype)


def set_compute_dtype(module: nn.Module, dtype) -> nn.Module:
    """Set ``dtype`` on every compute-dtype module under ``module``."""
    for m in module.modules():
        if isinstance(m, _Cast):
            m.dtype = dtype
    return module


class BatchNorm(nn.Module):
    """flax's BatchNorm over dim 1 of an (N, C, ...) input, under the
    reference's parameter and buffer names."""

    momentum = 0.9  # flax's: running = m · running + (1 − m) · batch

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.tensor(0, dtype=torch.long))

    def forward(self, x):
        if not self.training:
            if x.dtype == torch.float32:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, False, 0.0,
                                    self.eps)
            return F.batch_norm(x.float(), self.running_mean,
                                self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps).to(x.dtype)
        # batch statistics in two passes, whose sum order does not depend on
        # the CPU thread split, and flax's update with the biased variance
        shape = (1, -1) + (1,) * (x.dim() - 2)
        axes = [0] + list(range(2, x.dim()))
        xf = x.float()
        mean = xf.mean(dim=axes, keepdim=True)
        var = (xf - mean).square().mean(dim=axes, keepdim=True)
        if not _state["recomputing"]:
            m = self.momentum
            with torch.no_grad():
                self.running_mean.mul_(m).add_((1 - m) * mean.flatten())
                self.running_var.mul_(m).add_((1 - m) * var.flatten())
                self.num_batches_tracked.add_(1)
        mul = torch.rsqrt(var + self.eps) * self.weight.view(shape)
        return ((xf - mean) * mul + self.bias.view(shape)).to(x.dtype)


class _ConvBnReLU(nn.Module):
    def __init__(self, conv, features: int, bn: bool, relu: bool):
        super().__init__()
        self.conv = conv
        self.bn = BatchNorm(features) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return torch.relu(x) if self.relu else x


class ConvBnReLU(_ConvBnReLU):
    """2-D conv (+BN, +ReLU). Input (N, C, H, W)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int | None = None,
                 bn: bool = True, relu: bool = True):
        pad = kernel // 2 if padding is None else padding
        super().__init__(Conv2d(in_channels, features, kernel, stride, pad,
                                bias=not bn), features, bn, relu)


class ConvBnReLU3D(_ConvBnReLU):
    """3-D conv (+BN, +ReLU). Input (N, C, D, H, W)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 stride: int = 1, padding: int | None = None,
                 bn: bool = True, relu: bool = True):
        pad = kernel // 2 if padding is None else padding
        super().__init__(Conv3d(in_channels, features, kernel, stride, pad,
                                bias=not bn), features, bn, relu)


class DeconvBnReLU3D(_ConvBnReLU):
    """Stride-2 3-D transposed conv (+BN, +ReLU), output exactly 2× input.
    Input (N, C, D, H, W)."""

    def __init__(self, in_channels: int, features: int, kernel: int = 3,
                 bn: bool = True, relu: bool = True):
        super().__init__(ConvTranspose3d(
            in_channels, features, kernel, stride=2, padding=1,
            output_padding=1, bias=not bn), features, bn, relu)
