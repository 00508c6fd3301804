"""diner_tpu_torch — the PyTorch/CUDA port of ``diner_tpu``.

Mirrors the JAX package's module layout (``geometry``, ``ops``, ``nn``,
``models``, ``renderer``, ``losses``, ``train``, ``utils``, ``data``,
``evaluation``) in PyTorch idiom: ``nn.Module``s and plain tensor
functions, channels-last layouts at public functions, explicit devices and
explicit
``torch.Generator``s. The JAX package's TPU kernels are CUDA C++ kernels
under ``csrc/``, built with ``nvcc`` for ``sm_90a`` at first use: fused
alpha compositing, forward and backward, behind one
``torch.autograd.Function`` (``ops/composite_cuda.py``), and the row
gather under every flat gather of the sampler and the field
(``ops/gather_cuda.py``). Training runs from a YAML config with
``python -m diner_tpu_torch.train`` (``train/loop.py:Trainer``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
This package imports ``torch`` and never ``jax`` or ``diner_tpu``.
"""

from diner_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
