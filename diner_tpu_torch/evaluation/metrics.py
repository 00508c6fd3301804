"""Image quality metrics: PSNR, SSIM, L1, L2 and an LPIPS-style perceptual
distance.

Port of ``diner_tpu/evaluation/metrics.py``. Parity targets: reference
``src/evaluation/eval_suite.py:52-77``, which uses
``skimage.metrics.structural_similarity`` (uniform 7×7 window, K1=0.01,
K2=0.03, sample covariance, edge crop), ``peak_signal_noise_ratio``, MSE,
L1 and ``lpips.LPIPS(net='vgg')``. ``psnr``, ``mse``, ``l1`` and ``ssim``
are the JAX package's numpy code. ``LPIPSVGG`` is the LPIPS architecture
(VGG16 features, five relu taps, unit-normalised channel differences
weighted by linear calibration) in torch core; without the official
weights it is the JAX package's fixed-seed proxy (``init_lpips_proxy``,
reported as ``lpips_proxy``), drawn with the same numpy generator, so the
two packages' proxies are the same network. Loading the official LPIPS
weights waits for the files.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diner_tpu_torch.device import resolve_device


def psnr(pred, gt, data_range: float = 1.0) -> float:
    mse = np.mean((np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def mse(pred, gt) -> float:
    return float(np.mean((np.asarray(pred, np.float64) - np.asarray(gt, np.float64)) ** 2))


def l1(pred, gt) -> float:
    return float(np.mean(np.abs(np.asarray(pred, np.float64) - np.asarray(gt, np.float64))))


def _uniform_filter2d(x: np.ndarray, size: int) -> np.ndarray:
    """scipy.ndimage.uniform_filter (reflect boundary) on the leading 2 axes."""
    from scipy.ndimage import uniform_filter
    if x.ndim == 2:
        return uniform_filter(x, size=size, mode="reflect")
    out = np.empty_like(x)
    for c in range(x.shape[-1]):
        out[..., c] = uniform_filter(x[..., c], size=size, mode="reflect")
    return out


def ssim(pred, gt, data_range: float = 1.0, win_size: int = 7,
         K1: float = 0.01, K2: float = 0.03) -> float:
    """skimage-compatible SSIM for (H, W) or (H, W, C) images."""
    x = np.asarray(pred, np.float64)
    y = np.asarray(gt, np.float64)
    assert x.shape == y.shape
    NP = win_size ** 2
    cov_norm = NP / (NP - 1)

    ux = _uniform_filter2d(x, win_size)
    uy = _uniform_filter2d(y, win_size)
    uxx = _uniform_filter2d(x * x, win_size)
    uyy = _uniform_filter2d(y * y, win_size)
    uxy = _uniform_filter2d(x * y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux ** 2 + uy ** 2 + C1) * (vx + vy + C2))

    pad = (win_size - 1) // 2
    S = S[pad:-pad, pad:-pad]
    return float(S.mean())


# ------------------------------------------------------------------ LPIPS

VGG16_CONVS = (  # (torch features index, channels); pools at index gaps
    (0, 64), (2, 64), (5, 128), (7, 128), (10, 256), (12, 256), (14, 256),
    (17, 512), (19, 512), (21, 512), (24, 512), (26, 512), (28, 512))
POOL_BEFORE = {5, 10, 17, 24}
# relu outputs feeding LPIPS: relu1_2, relu2_2, relu3_3, relu4_3, relu5_3
TAP_AFTER = {2: 0, 7: 1, 14: 2, 21: 3, 28: 4}
LPIPS_CHANNELS = (64, 128, 256, 512, 512)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


class _Conv3x3(nn.Module):
    """One 3×3 conv's parameters: weight (O, I, 3, 3), bias (O,)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))


class LPIPSVGG(nn.Module):
    """LPIPS over VGG16 features: ``conv_{idx}`` as the flax tree names them
    (``utils/convert.py:lpips_to_state_dict`` bridges it 1:1) and ``lin_{i}``
    (C,) calibration weights per tap. Frozen."""

    def __init__(self):
        super().__init__()
        cin = 3
        for idx, ch in VGG16_CONVS:
            self.add_module(f"conv_{idx}", _Conv3x3(cin, ch))
            cin = ch
        for i, ch in enumerate(LPIPS_CHANNELS):
            self.register_parameter(f"lin_{i}",
                                    nn.Parameter(torch.zeros(ch)))
        self.register_buffer("shift", torch.tensor(_LPIPS_SHIFT))
        self.register_buffer("scale", torch.tensor(_LPIPS_SCALE))
        self.requires_grad_(False)

    def features(self, x):
        """(N, 3, H, W), already LPIPS-normalised → the five tap
        activations."""
        taps = [None] * 5
        h = x
        for idx, _ in VGG16_CONVS:
            if idx in POOL_BEFORE:
                h = F.max_pool2d(h, 2, 2)
            conv = getattr(self, f"conv_{idx}")
            h = torch.relu(F.conv2d(h, conv.weight, conv.bias, padding=1))
            if idx in TAP_AFTER:
                taps[TAP_AFTER[idx]] = h
        return taps

    def forward(self, pred, target):
        """LPIPS distance (N,) of (N, H, W, 3) images in [-1, 1]."""
        def prep(x):
            x = (x - self.shift) / self.scale
            return x.permute(0, 3, 1, 2)

        fx = self.features(prep(pred))
        fy = self.features(prep(target))
        total = 0.0
        for i, (a, b) in enumerate(zip(fx, fy)):
            na = a / torch.sqrt(torch.sum(a ** 2, dim=1, keepdim=True) + 1e-10)
            nb = b / torch.sqrt(torch.sum(b ** 2, dim=1, keepdim=True) + 1e-10)
            d2 = (na - nb) ** 2  # (N, C, H, W)
            w = getattr(self, f"lin_{i}")
            total = total + torch.mean(torch.einsum("nchw,c->nhw", d2, w),
                                       dim=(1, 2))
        return total


def init_lpips_proxy(seed: int = 0, device=None) -> LPIPSVGG:
    """The JAX package's fixed-seed proxy (``metrics.py:init_lpips_proxy``):
    He-normal VGG16 kernels from ``np.random.RandomState(seed)`` in the same
    order, zero biases, uniform calibration 1/C; on ``device`` (``cuda``
    unless the caller asks for the CPU)."""
    dev = resolve_device(device)
    rng = np.random.RandomState(seed)
    model = LPIPSVGG()
    c_in = 3
    with torch.no_grad():
        for idx, ch in VGG16_CONVS:
            fan_in = c_in * 9
            kernel = (rng.randn(3, 3, c_in, ch).astype(np.float32)
                      * np.sqrt(2.0 / fan_in))  # flax HWIO, as in JAX
            getattr(model, f"conv_{idx}").weight.copy_(
                torch.from_numpy(np.transpose(kernel, (3, 2, 0, 1)).copy()))
            c_in = ch
        for i, ch in enumerate(LPIPS_CHANNELS):
            getattr(model, f"lin_{i}").fill_(1.0 / ch)
    return model.to(dev)


def lpips_distance(model: LPIPSVGG, pred, target) -> torch.Tensor:
    """LPIPS distance (N,) of (N, H, W, 3) images in [-1, 1] (arrays or
    tensors), computed on the model's device in f32."""
    dev = next(model.parameters()).device
    with torch.no_grad():
        return model(torch.as_tensor(pred, dtype=torch.float32, device=dev),
                     torch.as_tensor(target, dtype=torch.float32,
                                     device=dev))
