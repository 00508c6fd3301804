"""Training entry point of the port, the counterpart of ``scripts/train.py``.

Usage (from the repository root):

    python -m diner_tpu_torch.train <config.yaml> [DINER] [--max-steps N]
        [--num-workers N] [--device cuda|cpu]

It runs on ``cuda`` unless ``--device cpu`` is given. KeypointNeRF and
NOVEL are not yet ported and exit with an error that says so.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.train")
    ap.add_argument("config")
    ap.add_argument("model", nargs="?", default="DINER",
                    choices=["DINER", "KeypointNeRF", "NOVEL", "NOVEL_PE"])
    ap.add_argument("--max-steps", type=int, default=None)
    ap.add_argument("--num-workers", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.model != "DINER":
        ap.exit(2, f"{ap.prog}: {args.model} is not yet ported to "
                "diner_tpu_torch (only DINER)\n")

    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.loop import Trainer

    run_cfg = load_train_config(args.config, model_name=args.model)
    trainer = Trainer(run_cfg, num_workers=args.num_workers,
                      device=args.device)
    trainer.fit(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
