"""Tolerances of the MVS port's CPU parity tests (``tests/test_torch_mvs*.py``
and ``tests/test_torch_fusion.py``), one place for all of them, and the
helpers those tests share (the tie rule, seeded weights).

- ``BLOCK_RTOL``: a module's output (blocks, DCN, FMT, warping, resizes)
  within 1e-5 of the largest magnitude of the JAX package's output.
- ``PROB_ATOL``: per-stage probability volumes and photometric
  confidences of the whole TransMVSNet forward within 1e-4, absolute.
- ``TIE_MARGIN`` (the tie rule): winner-take-all depth must be equal at
  every pixel whose top two probabilities differ by more than 1e-4; where
  they do not, either bin may win in f32 summed in another order, and a
  later stage's hypotheses follow that choice, so the probability volumes
  of later stages are compared where both sides' hypotheses agree.
- ``PNG_LSB``: the uint16 depth / confidence PNGs within 1 unit.
- ``POINT_ATOL``: fused points equal in count, coordinates within 1e-5.
"""

import numpy as np
import torch

BLOCK_RTOL = 1e-5
PROB_ATOL = 1e-4
TIE_MARGIN = 1e-4
PNG_LSB = 1
POINT_ATOL = 1e-5


def assert_close_to_max(got, ref, what=""):
    """|got − ref| ≤ BLOCK_RTOL · max |ref| everywhere."""
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = float(np.abs(ref).max())
    err = float(np.abs(got - ref).max())
    assert err <= BLOCK_RTOL * scale, f"{what}: {err} > {BLOCK_RTOL} × {scale}"


def decisive(prob_volume):
    """Pixels whose top two probabilities (axis 1) differ by more than
    ``TIE_MARGIN``."""
    top = np.sort(np.asarray(prob_volume), axis=1)
    return top[:, -1] - top[:, -2] > TIE_MARGIN


def assert_forward_matches(got, ref, stages, min_share=0.9):
    """Per-stage TransMVSNet outputs ({stage: {prob_volume,
    photometric_confidence, depth, depth_values}}, numpy, batch first) of
    the port against the JAX package's, under the tie rule: where both
    sides' hypotheses agree (within ``BLOCK_RTOL`` of their largest), the
    probabilities and confidences are within ``PROB_ATOL`` and, at decisive
    pixels, the same bin wins and the depths agree as the hypotheses do.
    At least ``min_share`` of the pixels must be compared at every stage,
    so a broken stage cannot hide behind the rule."""
    for stage in stages:
        g, r = got[stage], ref[stage]
        assert g["prob_volume"].shape == r["prob_volume"].shape, stage
        tol = BLOCK_RTOL * float(np.abs(r["depth_values"]).max())
        same = np.all(np.abs(g["depth_values"] - r["depth_values"]) <= tol,
                      axis=1)
        assert same.mean() >= min_share, (stage, same.mean())
        err = np.abs(g["prob_volume"] - r["prob_volume"]).max(axis=1)
        assert err[same].max() <= PROB_ATOL, (stage, err[same].max())
        err = np.abs(g["photometric_confidence"]
                     - r["photometric_confidence"])
        assert err[same].max() <= PROB_ATOL, (stage, err[same].max())
        keep = same & decisive(r["prob_volume"])
        assert keep.mean() >= min_share, (stage, keep.mean())
        np.testing.assert_array_equal(
            np.argmax(g["prob_volume"], axis=1)[keep],
            np.argmax(r["prob_volume"], axis=1)[keep])
        assert np.abs(g["depth"] - r["depth"])[keep].max() <= tol, stage


def seeded_state(model, seed=0, offset_scale=0.2):
    """The model's state dict with its BN statistics and affines and its
    DCN offset/mask convolutions drawn from ``seed`` (numpy)."""
    rng = np.random.RandomState(seed)
    state = model.state_dict()
    bns = {k[:-len("running_mean")] for k in state
           if k.endswith("running_mean")}
    sd = {}
    for k, v in state.items():
        prefix, leaf = k[:k.rfind(".") + 1], k[k.rfind(".") + 1:]
        shape = tuple(v.shape)
        if leaf == "num_batches_tracked":
            sd[k] = v
            continue
        if prefix in bns and leaf in ("running_mean", "bias"):
            v = 0.1 * rng.randn(*shape)
        elif prefix in bns and leaf == "running_var":
            v = 0.5 + rng.rand(*shape)
        elif prefix in bns and leaf == "weight":
            v = 1 + 0.1 * rng.randn(*shape)
        elif "conv_offset_mask" in k:
            v = offset_scale * rng.randn(*shape)
        else:
            v = v.numpy()
        sd[k] = torch.tensor(np.asarray(v, np.float32))
    return sd
