"""Folder-protocol evaluation suite.

Port of ``diner_tpu/evaluation/suite.py:29-124`` (reference
``src/evaluation/eval_suite.py``): walks ``*-gt.png`` / ``*-pred.png``
pairs, scores SSIM / PSNR / L2 / L1 and the LPIPS proxy, and writes
``average_scores.json``, ``detailed_report.json`` and a contact sheet of
examples, with the JAX package's file names and suffixes, so the two
packages' reports are directly comparable. PNGs are read and written with
PIL. ``compare_evaluations`` and its plots are not yet ported.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List

import numpy as np

from diner_tpu_torch.evaluation.metrics import (
    LPIPSVGG,
    init_lpips_proxy,
    l1,
    lpips_distance,
    mse,
    psnr,
    ssim,
)

AVERAGE_SCORE_FILENAME = "average_scores.json"
REPORT_DETAIL_FILENAME = "detailed_report.json"
EXAMPLE_PLOT_FILENAME = "examples.png"
N_EXAMPLE_PLOTS = 5
PRED_SUFFIX = "-pred.png"
GT_SUFFIX = "-gt.png"
REF_SUFFIX = "-ref.png"
DEPTH_SUFFIX = "-depth.png"
LPIPS_PROXY_NOTE = (
    "uniform-calibration proxy (official LPIPS VGG16+lin weights not "
    "present); values are NOT comparable to reference LPIPS ranges "
    "[0, 0.5] — see docs/PRETRAINED.md for the drop-in runbook"
)


def _imread(path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path))


def _imwrite(path, img: np.ndarray):
    from PIL import Image
    Image.fromarray(img).save(str(path))


def evaluate_folder(source_dir, outdir, lpips_params="auto",
                    pred_suffix: str = PRED_SUFFIX,
                    gt_suffix: str = GT_SUFFIX,
                    device=None) -> Dict[str, float]:
    """Score every (gt, pred) pair in `source_dir`; write reports to `outdir`.

    lpips_params: "auto" or "proxy" (the fixed-seed proxy, reported as
      ``lpips_proxy``; values are NOT comparable to reference LPIPS ranges:
      the official weights are not loaded yet, so "auto" is the proxy),
      None (skip), or an ``LPIPSVGG`` (reported as ``lpips``).
    device: where LPIPS runs (``cuda`` unless the caller asks for the CPU).
    """
    source_dir = Path(source_dir)
    outdir = Path(outdir)
    os.makedirs(outdir, exist_ok=True)

    gt_paths = [p for p in sorted(source_dir.iterdir())
                if p.name.endswith(gt_suffix)]
    pred_paths = [p.parent / p.name.replace(gt_suffix, pred_suffix)
                  for p in gt_paths]

    lpips_key = None
    lp = None
    if lpips_params in ("auto", "proxy"):
        lp = init_lpips_proxy(device=device)
        lpips_key = "lpips_proxy"
    elif isinstance(lpips_params, LPIPSVGG):
        lp = lpips_params
        lpips_key = "lpips"
    elif lpips_params is not None:
        raise ValueError(f"lpips_params: {lpips_params!r}")

    scores: Dict[str, List[float]] = defaultdict(list)
    for gt_path, pred_path in zip(gt_paths, pred_paths):
        gt = _imread(gt_path).astype(np.float32)[..., :3] / 255.0
        pred = _imread(pred_path).astype(np.float32)[..., :3] / 255.0
        scores["ssim"].append(ssim(pred, gt, data_range=1.0))
        scores["psnr"].append(psnr(pred, gt, data_range=1.0))
        scores["l2"].append(mse(pred, gt))
        scores["l1"].append(l1(pred, gt))
        if lp is not None:
            d = lpips_distance(lp, pred[None] * 2 - 1, gt[None] * 2 - 1)
            scores[lpips_key].append(float(d[0]))

    avg = {k: float(np.mean(v)) for k, v in scores.items()}
    report = dict(avg)
    if lpips_key == "lpips_proxy":
        report["lpips_proxy_note"] = LPIPS_PROXY_NOTE
    with open(outdir / AVERAGE_SCORE_FILENAME, "w") as f:
        json.dump(report, f, indent="\t")

    detail = []
    for i, p in enumerate(pred_paths):
        row = {"path": str(p)}
        for k, v in scores.items():
            row[k] = float(v[i])
        detail.append(row)
    with open(outdir / REPORT_DETAIL_FILENAME, "w") as f:
        json.dump(detail, f, indent="\t")

    _write_examples(outdir, pred_paths, pred_suffix)
    return avg


def _write_examples(outdir: Path, pred_paths, pred_suffix: str):
    if not pred_paths:
        return
    idcs = np.linspace(0, len(pred_paths) - 1,
                       min(N_EXAMPLE_PLOTS, len(pred_paths))).astype(int)
    rows = []
    for i in idcs:
        p = pred_paths[i]
        pred = _imread(p)[..., :3]
        H, W = pred.shape[:2]

        def load_or_zero(suffix):
            q = p.parent / p.name.replace(pred_suffix, suffix)
            return _imread(q)[..., :3] if q.exists() else np.zeros_like(pred)

        ref = load_or_zero(REF_SUFFIX)
        gt = load_or_zero(GT_SUFFIX)
        depth = load_or_zero(DEPTH_SUFFIX)
        nref = max(ref.shape[1] // W, 1)
        parts = list(np.hsplit(ref[:, : nref * W], nref)) + [gt, pred, depth]
        rows.append(np.concatenate(parts, axis=1))
    _imwrite(outdir / EXAMPLE_PLOT_FILENAME, np.concatenate(rows, axis=0))
