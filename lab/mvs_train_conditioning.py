#!/usr/bin/env python3
"""How well conditioned ``chip_smoke.py``'s small TransMVSNet training
step is, in train mode and with the running statistics.

The step is ``mvs_train_small_reference``'s (``chip_smoke.mvs_small_step``:
ndepths 8/8/8 on ``chip_smoke.mvs_small_batch``, 3 views, seed 5) from two
draws of the default model: the seeded one (``seeded_transmvsnet(4)``,
probability gain ``MVS_PROB_GAIN``, DCN offsets of a few pixels) and the
conditioned one (``MVS_CONDITIONED_DRAW``: gain 1, offsets of a fraction of
a pixel). Errors are ``chip_smoke.mvs_step_errors``': each gradient over
its norm, PixelwiseNet's apart, the biases a train-mode BN follows over
their weight's. Two measurements:

- ``perturb`` (any machine, on the CPU): the images times (1 + eps·noise),
  eps 1e-7 (about f32 rounding) and 1e-6, two noise draws, in train mode
  for both draws at 64×96 (and 128×160 for the seeded one) and with the
  running statistics at 64×96; with the smallest gap between the two most
  probable hypotheses of stages 1 and 2 (a gap under the card's
  probability error could flip a winning bin);
- ``card`` (a GPU): the card's train-mode step against the CPU's at 64×96
  for both draws, with cuDNN as set up, with ``cudnn.deterministic`` and
  without cuDNN.

Prints one JSON line per case. Not part of the package and not run by the
tests.

Run from the repository root:  python3 lab/mvs_train_conditioning.py
(``--card-only``: the card's half alone)
"""

import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as c  # noqa: E402

DRAWS = {"seeded": {}, "conditioned": c.MVS_CONDITIONED_DRAW}


def top2_gap(prob):
    """The smallest difference between a pixel's two most probable
    hypotheses."""
    top = prob.topk(2, dim=1).values
    return float((top[:, 0] - top[:, 1]).min())


def brief(errs):
    keys = ("loss_rel_err", "grad_max_err_over_norm", "worst_param",
            "pixel_wise_net_grad_max_err_over_norm", "bn_stats_max_abs_err",
            "prob_max_abs_diff", "wta_bins_differ")
    return {k: errs[k] for k in keys}


def perturb():
    cases = [("seeded", True, (64, 96)), ("seeded", True, (128, 160)),
             ("conditioned", True, (64, 96)), ("seeded", False, (64, 96))]
    for draw, train, (H, W) in cases:
        model = c.mvs_small_model(**DRAWS[draw])
        batch = c.mvs_small_batch(H, W, 3, seed=5)
        ref = c.mvs_small_step(model, batch, "cpu", train)
        gaps = {st: top2_gap(ref["prob"][st]) for st in ("stage1", "stage2")}
        for eps in (1e-7, 1e-6):
            for noise_seed in (0, 1):
                got = c.mvs_small_step(model, batch, "cpu", train, eps=eps,
                                       noise_seed=noise_seed)
                print(json.dumps(dict(
                    case="perturb", draw=draw, train=train, hw=[H, W],
                    eps=eps, noise_seed=noise_seed, top2_gap=gaps,
                    **brief(c.mvs_step_errors(ref, got, train)))),
                    flush=True)


def card():
    batch = c.mvs_small_batch(*c.MVS_SMALL_HW, 3, seed=5)
    models = {d: c.mvs_small_model(**kw) for d, kw in DRAWS.items()}
    refs = {d: c.mvs_small_step(m, batch, "cpu", True)
            for d, m in models.items()}
    for label, flag, value in (("cudnn", None, None),
                               ("cudnn_deterministic", "deterministic", True),
                               ("no_cudnn", "enabled", False)):
        if flag:
            setattr(torch.backends.cudnn, flag, value)
        for draw, model in models.items():
            got = c.mvs_small_step(model, batch, "cuda", True)
            print(json.dumps(dict(
                case="card", label=label, draw=draw,
                **brief(c.mvs_step_errors(refs[draw], got, True)))),
                flush=True)


def main(argv):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--card-only" not in argv:
        perturb()
    if torch.cuda.is_available():
        card()


if __name__ == "__main__":
    main(sys.argv[1:])
