"""Re-score an existing prediction folder, the port's counterpart of
``scripts/evaluate_prediction_folder.py`` (reference
``python_scripts/evaluate_prediction_folder.py``).

Usage (from the repository root):

    python -m diner_tpu_torch.evaluate <folder> [outdir] [--device cuda|cpu]

The reports go to ``outdir`` (default: the folder itself); the scores are
printed. LPIPS runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.evaluate")
    ap.add_argument("folder")
    ap.add_argument("outdir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from diner_tpu_torch.evaluation.suite import evaluate_folder
    scores = evaluate_folder(args.folder, args.outdir or args.folder,
                             device=args.device)
    print(scores)
    return scores


if __name__ == "__main__":
    main()
