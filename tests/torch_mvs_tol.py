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

Training (``tests/test_torch_mvs_train.py``, f32 unless named):

- ``LOSS_RTOL``: losses and metrics within 1e-5 relative (f32 sums taken
  in another order through convolutions, BN and softmax).
- ``GRAD_RTOL``: each parameter's gradient and Adam's first moment within
  1e-3 of their norm (the second moment, of squares, 2e-3): f32 sums in
  another order through train-mode BN, the 3-D U-Nets and the FMT's 8
  attention layers, whose toy heads are 2 wide; the largest seen were
  1.0e-4 and 3.5e-4 on FMT projections in two runs (the CPU's thread
  split changes the order from run to run).
- ``PWN_GRAD_RTOL``: PixelwiseNet's gradients within 2e-2 of their norm:
  its max over the depth planes routes each pixel's gradient to one plane,
  and where two planes' sigmoids nearly tie f32 rounding picks which (one
  element of a BN bias off by 1.3 %, 4.3e-3 of the norm, seen at step 3).
- ``UPDATE_RTOL``: each parameter's update by the train step within 1e-2
  of Adam's update from its moments (the update is a difference of f32
  parameters), and of the JAX update's norm over the components whose JAX
  moment is above 1e-2 of its largest: Adam divides each gradient by its
  own root mean square, so a component whose gradient is near 0 moves by
  ±lr on either side of a sign that f32 rounding decides.
- ``STATS_ATOL``: BN running statistics within 1e-4 (flax takes the batch
  variance as E[x²] − E[x]², the port in two passes).
- ``DCN_RTOL``: the DCN sampler's gradients within 1e-5 of their largest
  magnitude (f32 sums of the same terms in another order);
  ``DCN_BF16_RTOL``: a bf16 image gradient within one bf16 step (2^-8) of
  its largest, the f32 sum rounded once on both sides;
  ``DCN_BF16_AUTODIFF_RTOL``: 2^-5 against JAX's autodiff in bf16, which
  sums the weight gradient's channel products in bf16.
- bf16 forwards (``tests/test_torch_mvs_bf16.py``): bf16 keeps 8 bits,
  and the frameworks round convolutions, softmax and sums at other
  places, through some 40 layers. ``BF16_VS_JAX``: the port's bf16 stage-1
  probabilities no further from the f32 forward than 2× the JAX bf16
  forward's distance (+ 2^-8); ``BF16_PROB_ATOL``: within 6e-2 of the JAX
  bf16 forward (0.041 seen); ``BF16_LOSS_RTOL``: the loss within 2e-2.
"""

import numpy as np
import torch

BLOCK_RTOL = 1e-5
PROB_ATOL = 1e-4
TIE_MARGIN = 1e-4
PNG_LSB = 1
POINT_ATOL = 1e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-3
PWN_GRAD_RTOL = 2e-2
UPDATE_RTOL = 1e-2
STATS_ATOL = 1e-4
DCN_RTOL = 1e-5
DCN_BF16_RTOL = 2.0 ** -8
DCN_BF16_AUTODIFF_RTOL = 2.0 ** -5
BF16_VS_JAX = 2.0
BF16_PROB_ATOL = 6e-2
BF16_LOSS_RTOL = 2e-2


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
