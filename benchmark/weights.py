"""Weights drawn by the benchmark, on the card, from ``--seed``.

One normal draw for every leaf of a state dict at once, cut into leaves
and scaled by a rule on the leaf's name and shape: convolutions at
sqrt(2 / fan-in), dense layers at sqrt(1 / fan-in) (the second layer of a
residual block and the field's output head at half that, the head's
rows centred), biases at 0.05, batch-norm scales at 1 ± 0.1 and shifts at
0.1, running means 0 and variances 1, the gen-latent plane at 1. Every
weight is nonzero, so every leaf takes a gradient in the first step. The
density's bias is ``DENSITY_BIAS`` and its row of the head sums to zero,
so every seed's field renders density near that level from the first
step on, rather than one draw's shift leaving it dead or saturated. The
same names and shapes give the same values on the program's side and the
reference's.
"""

from __future__ import annotations

import math

import torch

DENSITY_BIAS = 1.0
DENSITY_HEAD = "mlp.lin_out.bias"
OUTPUT_HEAD = "mlp.lin_out.weight"


def _is_bn(name: str) -> bool:
    return any("bn" in part for part in name.split(".")[:-1])


def _leaf(name: str, shape, normal):
    last = name.rsplit(".", 1)[-1]
    if last == "running_mean":
        return torch.zeros_like(normal)
    if last == "running_var":
        return torch.ones_like(normal)
    if name == "gen_latent":
        return normal
    if len(shape) == 1:
        if _is_bn(name):
            return (1.0 + 0.1 * normal) if last == "weight" else 0.1 * normal
        out = 0.05 * normal
        if name == DENSITY_HEAD:
            out[3] += DENSITY_BIAS
        return out
    fan_in = math.prod(shape[1:])
    gain = 2.0 if len(shape) == 4 else 1.0
    std = math.sqrt(gain / fan_in) * (0.5 if ".fc_1." in f".{name}"
                                      or name == OUTPUT_HEAD else 1.0)
    out = std * normal
    if name == OUTPUT_HEAD:
        # rows of zero mean: the head reads relu features, whose common
        # positive mean would otherwise shift every output by one draw
        out = out - out.mean(dim=1, keepdim=True)
    return out


@torch.no_grad()
def draw(state_dict: dict, seed: int, device) -> dict:
    """{name: tensor} for every float entry of ``state_dict`` (names and
    shapes only are read), in float32 on ``device``."""
    names = sorted(k for k, v in state_dict.items()
                   if torch.is_floating_point(v))
    sizes = [state_dict[k].numel() for k in names]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for name, normal in zip(names, torch.split(flat, sizes)):
        shape = tuple(state_dict[name].shape)
        out[name] = _leaf(name, shape, normal.reshape(shape)).contiguous()
    return out
