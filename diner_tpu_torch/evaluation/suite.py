"""Folder-protocol evaluation suite.

Port of ``diner_tpu/evaluation/suite.py`` (reference
``src/evaluation/eval_suite.py``): walks ``*-gt.png`` / ``*-pred.png``
pairs, scores SSIM / PSNR / L2 / L1 and LPIPS, and writes
``average_scores.json``, ``detailed_report.json`` and a contact sheet of
examples, with the JAX package's file names and suffixes, so the two
packages' reports are directly comparable; ``compare_evaluations``
summarizes several models' reports in ``comparison.json`` and, where
matplotlib imports, draws the violin and biggest-difference plots. PNGs
are read and written with PIL.
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
from diner_tpu_torch.utils.pretrained import (LPIPS_PROXY_NOTE,
                                              lpips_params_or_proxy)

METRIC_OPT_DICT = dict(l1="-", l2="-", lpips="-", psnr="+", ssim="+")
AVERAGE_SCORE_FILENAME = "average_scores.json"
REPORT_DETAIL_FILENAME = "detailed_report.json"
EXAMPLE_PLOT_FILENAME = "examples.png"
BARPLOT_FILENAME = "average_scores.png"
N_EXAMPLE_PLOTS = 5
PRED_SUFFIX = "-pred.png"
GT_SUFFIX = "-gt.png"
REF_SUFFIX = "-ref.png"
DEPTH_SUFFIX = "-depth.png"


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

    lpips_params: "auto" (the converted official weights where
      ``utils/pretrained.py`` finds them, else the proxy), "proxy" (the
      fixed-seed proxy, reported as ``lpips_proxy``; values are NOT
      comparable to reference LPIPS ranges), None (skip), or an
      ``LPIPSVGG`` (``utils/pretrained.py:load_lpips``, reported as
      ``lpips``).
    device: where LPIPS runs (``cuda`` unless the caller asks for the CPU).
    """
    source_dir = Path(source_dir)
    outdir = Path(outdir)
    os.makedirs(outdir, exist_ok=True)

    gt_paths = [p for p in sorted(source_dir.iterdir())
                if p.name.endswith(gt_suffix)]
    pred_paths = [p.parent / p.name.replace(gt_suffix, pred_suffix)
                  for p in gt_paths]

    if lpips_params == "auto":
        lpips_params = lpips_params_or_proxy(device)
    lpips_key = None
    lp = None
    if lpips_params == "proxy":
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


_VIOLIN_DEFAULT = "#1f77b4"
_VIOLIN_BEST = "green"
_VIOLIN_WORST = "red"


def _normalize_eval_dirs(eval_dirs):
    """Accept reference-style (name, dir) tuples or plain dirs."""
    out = []
    for e in eval_dirs:
        if isinstance(e, (tuple, list)):
            out.append((str(e[0]), Path(e[1])))
        else:
            out.append((Path(e).name, Path(e)))
    return out


def compare_evaluations(eval_dirs, outdir) -> Dict[str, Dict[str, float]]:
    """Compare several models' evaluations (reference
    ``eval_suite.compare_evaluations``; ``diner_tpu/evaluation/suite.py:165``).

    Writes ``comparison.json``: each model's averages under ``models`` and,
    per metric of ``METRIC_OPT_DICT``, the best model under ``best`` (the
    proxy's ``lpips_proxy`` is no such metric, so it gets no entry). Where
    matplotlib imports, also ``average_scores.png`` (per-metric violins over
    the per-sample scores, best green, worst red, mean ± std) and
    ``biggest_difference_{metric}_{j}.png`` (the samples where the models
    disagree most: predictions, L1 error maps, a green→red comparison map).

    ``eval_dirs``: (model_name, eval_dir) tuples or plain dirs (model name
    = directory name).
    """
    eval_dirs = _normalize_eval_dirs(eval_dirs)
    outdir = Path(outdir)
    os.makedirs(outdir, exist_ok=True)

    summary = {}
    details = {}
    for name, d in eval_dirs:
        with open(d / AVERAGE_SCORE_FILENAME) as f:
            summary[name] = json.load(f)
        detail_fp = d / REPORT_DETAIL_FILENAME
        if detail_fp.exists():
            with open(detail_fp) as f:
                details[name] = json.load(f)
    best = {}
    for metric, direction in METRIC_OPT_DICT.items():
        vals = {m: s[metric] for m, s in summary.items() if metric in s}
        if not vals:
            continue
        pick = max(vals, key=vals.get) if direction == "+" else \
            min(vals, key=vals.get)
        best[metric] = pick
    out = {"models": summary, "best": best}
    with open(outdir / "comparison.json", "w") as f:
        json.dump(out, f, indent="\t")

    if details:
        try:
            _plot_violins(details, outdir)
            _plot_biggest_differences(eval_dirs, details, outdir)
        except ImportError:  # matplotlib absent: the JSON table only
            pass
    return out


def _metric_scores(details):
    """{metric: {model: np.ndarray (n_samples,)}} over shared metrics."""
    model_names = list(details)
    metrics = sorted(k for k in details[model_names[0]][0]
                     if k in METRIC_OPT_DICT)
    return model_names, metrics, {
        m: {name: np.array([row[m] for row in details[name]])
            for name in model_names}
        for m in metrics}


def _plot_violins(details, outdir: Path):
    """Violin comparison plot (reference eval_suite.py:141-199)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    model_names, metrics, scores = _metric_scores(details)
    nmodels = len(model_names)
    fig = plt.figure(figsize=(max(3 * nmodels, 6), 3 * len(metrics)))
    x = np.arange(nmodels)
    for i, metric in enumerate(metrics):
        opt = METRIC_OPT_DICT[metric]
        per_model = [scores[metric][name] for name in model_names]
        means = np.array([np.mean(s) for s in per_model])
        stds = np.array([np.std(s) for s in per_model])
        ns = np.array([len(s) for s in per_model])
        best_i = int(np.argmax(means) if opt == "+" else np.argmin(means))
        worst_i = int(np.argmin(means) if opt == "+" else np.argmax(means))
        colors = [_VIOLIN_DEFAULT] * nmodels
        colors[best_i] = _VIOLIN_BEST
        colors[worst_i] = _VIOLIN_WORST

        ax = plt.subplot(len(metrics), 1, i + 1)
        parts = ax.violinplot(per_model, positions=x, showextrema=False,
                              widths=0.9)
        for j, pc in enumerate(parts["bodies"]):
            pc.set_facecolor(colors[j])
        ax.scatter(x, means, c="black")
        ax.vlines(x, means - stds, means + stds, color="black")
        ax.set_xticks(x)
        ax.set_xticklabels(model_names if i == len(metrics) - 1
                           else [""] * nmodels)
        ax.tick_params(labelrotation=45)
        ax.set_ylabel(metric.upper() + f" ({opt})")
        ax.set_xlim((-0.5, nmodels - 0.5))
        for j in range(nmodels):
            ax.text(j, means[j],
                    f"  {means[j]:.3f}+-{stds[j] / np.sqrt(ns[j]):.3f}",
                    horizontalalignment="left", verticalalignment="center")
    plt.tight_layout()
    plt.savefig(outdir / BARPLOT_FILENAME)
    plt.close(fig)


def _find_image(eval_dir: Path, detail_row: dict, suffix: str,
                pred_name: str):
    """Locate a sample image: the detail row's recorded path first, then
    the reference's ``<eval_dir>/visualizations/`` layout."""
    name = pred_name.replace(PRED_SUFFIX, suffix)
    p = Path(detail_row["path"])
    for cand in (p.parent / name, eval_dir / "visualizations" / name):
        if cand.exists():
            return cand
    return None


def _plot_biggest_differences(eval_dirs, details, outdir: Path,
                              n_samples: int = 3):
    """Biggest-difference error-map plots (reference eval_suite.py:281-385):
    per metric, the samples with the highest cross-model score std; rows =
    [predictions + gt, L1 error maps (shared scale, colorbar), green→red
    per-pixel comparison maps + ref]."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import LinearSegmentedColormap

    model_names, metrics, scores = _metric_scores(details)
    dirs = dict(eval_dirs)
    first = details[model_names[0]]
    sample_names = [Path(r["path"]).name for r in first]
    # all reports must cover the same samples
    for name in model_names[1:]:
        if [Path(r["path"]).name for r in details[name]] != sample_names:
            return

    gr_cmap = LinearSegmentedColormap(
        "diner_compare",
        segmentdata={
            "red": [[0.0, 0.0, 0.0], [0.5, 1.0, 1.0], [1.0, 1.0, 1.0]],
            "green": [[0.0, 1.0, 1.0], [0.5, 1.0, 1.0], [1.0, 0.0, 0.0]],
            "blue": [[0.0, 0.0, 0.0], [0.5, 0.0, 0.0], [1.0, 0.0, 0.0]],
        }, N=256)

    n_samples = min(n_samples, len(sample_names))
    for m in metrics:
        stacked = np.stack([scores[m][n] for n in model_names], axis=-1)
        stds = np.std(stacked, axis=-1)
        top = np.argsort(stds)[::-1][:n_samples]
        for j, idx in enumerate(top):
            pred_name = sample_names[idx]
            ncols = len(model_names) + 1
            fig, axes = plt.subplots(nrows=3, ncols=ncols,
                                     figsize=(ncols * 4, 12), squeeze=False)
            gt_fp = _find_image(dirs[model_names[0]], first[idx],
                                GT_SUFFIX, pred_name)
            ref_fp = _find_image(dirs[model_names[0]], first[idx],
                                 REF_SUFFIX, pred_name)
            if gt_fp is None:
                plt.close(fig)
                return
            gt = _imread(gt_fp).astype(np.float32)[..., :3] / 255.0
            axes[0, -1].imshow(gt)
            axes[0, -1].set_title("GT", fontsize=9)
            if ref_fp is not None:
                axes[2, -1].imshow(_imread(ref_fp)[..., :3])

            err_maps = []
            for i, name in enumerate(model_names):
                row = details[name][idx]
                pred_fp = _find_image(dirs[name], row, PRED_SUFFIX,
                                      pred_name)
                pred = _imread(pred_fp).astype(np.float32)[..., :3] / 255.0
                err_maps.append(np.abs(pred - gt).mean(axis=-1))
                score = scores[m][name][idx]
                all_scores = stacked[idx]
                is_best = (np.all(score >= all_scores)
                           if METRIC_OPT_DICT[m] == "+"
                           else np.all(score <= all_scores))
                axes[0, i].imshow(pred)
                axes[0, i].set_title(
                    f"{name}\n{m}[{METRIC_OPT_DICT[m]}]: {score:.5e}",
                    fontsize=9, color="green" if is_best else "black")
                axes[2, i].imshow(pred)

            err = np.stack(err_maps)  # (nmodels, H, W)
            lo, hi = err.min(axis=0, keepdims=True), \
                err.max(axis=0, keepdims=True)
            norm = (err - lo) / np.maximum(hi - lo, 1e-12)
            for i in range(len(model_names)):
                axes[2, i].imshow(norm[i], alpha=1.0, cmap=gr_cmap)
                heat = axes[1, i].imshow(err[i], vmin=err.min(),
                                         vmax=err.max())
            axes[1, 0].set_xlabel("L1 error map")
            axes[2, 0].set_xlabel("l1 comparison map")
            plt.sca(axes[1, -1])
            plt.colorbar(heat)
            for a in axes.flatten():
                a.axis("off")
            fig.suptitle(f"{m} sample {j + 1}/{n_samples} {pred_name}")
            plt.savefig(outdir / f"biggest_difference_{m}_{j + 1}.png")
            plt.close(fig)
