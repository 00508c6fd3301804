"""Weight bridge: the JAX package's flax variables → this port's state_dict.

The inverse of the layout rules of ``diner_tpu/utils/torch_convert.py``.
Input is ``{"params": tree, "batch_stats": tree}`` as nested dicts of numpy
arrays (``jax.tree_util.tree_map(np.asarray, variables)``): a PixelNeRF's
variables, or ``{"params": init_vgg19_params(seed)}`` for the VGG19 of the
perceptual loss (``conv_{idx}/kernel|bias``). The port's modules carry the
flax names, so a path maps to a dotted key 1:1:

  conv kernel (kH, kW, I, O) → ``weight`` (O, I, kH, kW)
  dense kernel (I, O)        → ``weight`` (O, I)
  ``bias`` → ``bias``; BN ``scale`` → ``weight``
  batch_stats ``mean`` / ``var`` → ``running_mean`` / ``running_var``

``lpips_to_state_dict`` bridges the LPIPS parameters of
``diner_tpu/evaluation/metrics.py`` (``{"vgg": conv tree, "lins": (C,)
weights per tap}``, e.g. its ``init_lpips_proxy``) to the port's
``evaluation/metrics.py:LPIPSVGG``.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_PARAM_LEAVES = {"kernel": "weight", "scale": "weight", "bias": "bias"}
_STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def _kernel(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:
        return np.transpose(w, (3, 2, 0, 1))
    if w.ndim == 2:
        return w.T
    raise ValueError(f"unsupported kernel rank {w.ndim}")


def _walk(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` flax tree → ``{dotted key: tensor}``."""
    sd: Dict[str, torch.Tensor] = {}
    for collection, leaves in (("params", _PARAM_LEAVES),
                               ("batch_stats", _STAT_LEAVES)):
        for path, value in _walk(variables.get(collection, {})):
            if path[-1] not in leaves:
                raise KeyError(f"unknown {collection} leaf {'/'.join(path)}")
            if path[-1] == "kernel":
                value = _kernel(value)
            key = ".".join(path[:-1] + (leaves[path[-1]],))
            sd[key] = torch.tensor(value, dtype=torch.float32)
    return sd


def lpips_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """JAX LPIPS params (numpy arrays) → a full ``LPIPSVGG`` state_dict."""
    from diner_tpu_torch.evaluation.metrics import LPIPSVGG
    sd = LPIPSVGG().state_dict()  # the input normalisation buffers
    sd.update(flax_to_state_dict({"params": params["vgg"]}))
    for i, w in enumerate(params["lins"]):
        sd[f"lin_{i}"] = torch.tensor(np.asarray(w).reshape(-1),
                                      dtype=torch.float32)
    return sd
