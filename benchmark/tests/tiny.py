"""A cell of the benchmark cut to a size the CPU runs in seconds, and the
CUDA calls the drivers make stood in for on the CPU. For the CPU tests
only: a number from such a run is never a device number."""

from __future__ import annotations

import argparse
import copy
import time

import torch

from benchmark import harness

TINY = dict(image_hw=[48, 64], source_views=2, n_blocks=2, d_hidden=32,
            combine_layer=1, mesh_vertices=300, gen_latent_hw=12,
            gen_latent_ch=128)
TINY_ENCODER = dict(backbone="resnet18", num_layers=2, image_padding=8,
                    padding_pe=2)
TINY_RENDERER = dict(n_samples=8, n_depth_candidates=32, n_gaussian=3)


def tiny_cell(name: str) -> harness.Cell:
    cell = harness.load_cell(name)
    c = copy.deepcopy(cell.config)
    c.update({k: v for k, v in TINY.items()
              if k in c or k in ("image_hw", "source_views")})
    c["encoder"] = dict(c["encoder"], **TINY_ENCODER)
    for mode in ("train", "render"):
        if mode in c:
            c[mode]["renderer"] = dict(c[mode]["renderer"], **TINY_RENDERER)
    if "train" in c:
        c["train"].update(scenes_per_step=min(c["train"]["scenes_per_step"],
                                              2), vgg_spatch=16)
    if "render" in c:
        c["render"]["renderer"]["ray_chunk"] = 768
    cell.config = c
    cell.traffic = dict(cell.traffic, pool=4)
    cell.settings = dict(cell.settings, reference_block_rays=96)
    return cell


def args(seed=3, seconds=0.0, trace=0):
    return argparse.Namespace(seed=seed, seconds=seconds, trace=trace)


class _Event:
    def __init__(self, **_):
        self.t = 0.0

    def record(self):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def cpu_stubs(monkeypatch):
    """Stand-ins for the CUDA calls of the drivers and the harness."""
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda *a: None)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: None)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
