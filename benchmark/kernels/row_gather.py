"""Bound of the flat row gathers (kernel C, ``row_gather``) that a step's
or an image's field and sampler need.

The lookups, at the configuration's shapes (SB scenes, NV views, NR rays,
K samples, N depth candidates): the sampler's packed map (depth, its
deviation, the normal: 5 float32) at every candidate in every view; the
depth at every sample in every view; the latent's four bilinear corners
at every sample in every view (in the compute dtype); for NOVEL the
nearest vertex's offset (3 float32) at every candidate and twice at every
sample, the gen-latent plane's four corners at every sample (float32) and,
with the PE maps, four corners of the source and of the target map
(3 float32) at every sample in every view.

Bytes: each gathered row written once and its 8-byte index read once.
The table rows a gather reads are left out: how many distinct rows the
indices touch depends on the scene, so the bound is a lower one and the
share of it never counts a byte that need not move.
"""

from __future__ import annotations

KERNELS = ("row_gather",)
INDEX_BYTES = 8
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def lookups(c: dict, kind: str) -> list:
    """[(rows, row bytes)] of one training step or one image."""
    nv = c["source_views"]
    if kind == "train":
        m = c["train"]
        SB, NR = m["scenes_per_step"], m["vgg_spatch"] ** 2
    else:
        m = c["render"]
        SB, NR = 1, c["image_hw"][0] * c["image_hw"][1]
    K = m["renderer"]["n_samples"]
    N = m["renderer"]["n_depth_candidates"]
    latent = [0, 64, 128, 256, 512, 1024][c["encoder"]["num_layers"]]
    latent_bytes = latent * DTYPE_BYTES[c["compute_dtype"]]
    samples = SB * NR * K
    out = [(SB * nv * NR * N, 20), (samples * nv, 4)]
    out += [(samples * nv, latent_bytes)] * 4
    if c["family"] == "novel":
        out += [(SB * NR * N, 12)] + [(samples, 12)] * 2
        out += [(samples, c["gen_latent_ch"] * 4)] * 4
        if c.get("use_pe_maps"):
            out += [(samples * nv, 12)] * 8
    return out


def bound_s(c: dict, kind: str, peaks: dict) -> float:
    n_bytes = sum(rows * (row + INDEX_BYTES)
                  for rows, row in lookups(c, kind))
    return n_bytes / peaks["hbm_bytes_per_s"]
