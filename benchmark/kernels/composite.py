"""Bound of compositing: kernels A (``composite_fwd``) and B
(``composite_bwd``) at a step's or an image's shapes.

Bytes, each input read once and each output written once, in float32: A
reads rgb and sigma of every sample (its field output), its depth and
each ray's far bound, and writes the ray's rgb, depth and the samples'
weights; B reads rgb, sigma and depth of every sample, the far bound and
the rays' rgb cotangent, and writes the samples' rgb and sigma gradients.
Operations: 17 FLOPs a sample forward, 38 backward (float32, outside the
tensor cores). The bound is the larger of bytes over the memory rate and
operations over the float32 rate.
"""

from __future__ import annotations

KERNELS = ("composite_fwd", "composite_bwd")
FWD_FLOPS_PER_SAMPLE = 17
BWD_FLOPS_PER_SAMPLE = 38


def forward_s(R: int, K: int, peaks: dict) -> float:
    n_bytes = 4 * (R * K * 5 + R + R * 3 + R + R * K)
    ops = FWD_FLOPS_PER_SAMPLE * R * K
    return max(n_bytes / peaks["hbm_bytes_per_s"],
               ops / peaks["flops_per_s"]["float32"])


def backward_s(R: int, K: int, peaks: dict) -> float:
    n_bytes = 4 * (R * K * 5 + R * 4 + R * K * 4)
    ops = BWD_FLOPS_PER_SAMPLE * R * K
    return max(n_bytes / peaks["hbm_bytes_per_s"],
               ops / peaks["flops_per_s"]["float32"])


def bound_s(c: dict, kind: str, peaks: dict) -> float:
    """Least seconds of compositing in one training step or one image."""
    if kind == "train":
        m = c["train"]
        R = m["scenes_per_step"] * m["vgg_spatch"] ** 2
        K = m["renderer"]["n_samples"]
        return forward_s(R, K, peaks) + backward_s(R, K, peaks)
    H, W = c["image_hw"]
    return forward_s(H * W, c["render"]["renderer"]["n_samples"], peaks)
