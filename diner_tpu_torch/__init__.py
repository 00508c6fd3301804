"""diner_tpu_torch — the PyTorch/CUDA port of ``diner_tpu``.

Mirrors the JAX package's module layout (``geometry``, ``ops``, ``nn``,
``models``, ``renderer``, ``train``, ``utils``, ``data``) in PyTorch idiom:
``nn.Module``s and plain tensor functions, channels-last layouts at public
functions, explicit devices and explicit ``torch.Generator``s. The one TPU
kernel on the eval-render path (fused alpha compositing) is a CUDA C++
kernel under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package imports ``torch`` and never ``jax`` or ``diner_tpu``.
"""

from diner_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
