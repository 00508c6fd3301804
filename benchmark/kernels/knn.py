"""Bound of NOVEL's top-1 nearest-vertex search (``knn1``) in a step.

Three searches a step over the target mesh's V vertices: the sampler's
N candidates of each ray, then the K samples twice. Bytes: each point
(12) read and its index (4) written once, the vertices (12) read once per
search. Operations: one point-vertex test a point (8 float32 FLOPs), the
least any exact search makes. The bound is the larger of the two.
"""

from __future__ import annotations

KERNELS = ("knn1",)
FLOPS_PER_TEST = 8


def search_s(SB: int, N: int, V: int, peaks: dict) -> float:
    n_bytes = SB * (N * 16 + V * 12)
    ops = SB * N * FLOPS_PER_TEST
    return max(n_bytes / peaks["hbm_bytes_per_s"],
               ops / peaks["flops_per_s"]["float32"])


def bound_s(c: dict, kind: str, peaks: dict) -> float:
    m = c["train"]
    SB, NR = m["scenes_per_step"], m["vgg_spatch"] ** 2
    r, V = m["renderer"], c["mesh_vertices"]
    return (search_s(SB, NR * r["n_depth_candidates"], V, peaks)
            + 2 * search_s(SB, NR * r["n_samples"], V, peaks))
