"""Render a validation subset from a checkpoint and score it, the port's
counterpart of ``scripts/create_prediction_folder.py`` (reference
``python_scripts/create_prediction_folder.py:16-62``).

Usage (from the repository root):

    python -m diner_tpu_torch.predict --config cfg.yaml --ckpt CKPT \\
        --out /tmp/preds [--nsamples 32] [--n 100] [--znear Z] [--zfar Z] \\
        [--model DINER] [--prefix nerf.] [--device cuda|cpu]

``--ckpt`` is a checkpoint of the port (a ``step_*`` directory, its
``state.pt``, or a ``checkpoints`` directory, whose latest is taken) or a
reference PyTorch Lightning ``.ckpt`` (a DINER's ``nerf.encoder.*`` and
``nerf.mlp_fine.*`` tensors, mapped by ``utils/convert.py:
reference_to_state_dict``; ``--prefix`` names the PixelNeRF's key prefix,
``""`` for a bare PixelNeRF state dict, as in
``scripts/convert_checkpoint.py``; a Lightning checkpoint is unpickled, so
load only checkpoints you trust). ``--nsamples`` overrides the renderer's
sample count and rescales ``n_gaussian`` in proportion. ``--n`` renders
that many validation samples (``select_eval_indices``; -1 = all). The
folder gets the suite's four files per sample and its reports; the scores
are printed. It runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses
from pathlib import Path

import torch


def override_config(dcfg, nsamples=None, znear=None, zfar=None):
    """The ``DinerConfig`` with the CLI's overrides: ``nsamples`` samples
    with ``n_gaussian`` scaled by ``nsamples / n_samples`` and truncated
    (``create_prediction_folder.py:50-56``), then znear and zfar."""
    if nsamples is not None:
        rend = dcfg.renderer
        scale = nsamples / rend.n_samples
        rend = dataclasses.replace(rend, n_samples=nsamples,
                                   n_gaussian=int(rend.n_gaussian * scale))
        dcfg = dataclasses.replace(dcfg, renderer=rend)
    if znear is not None:
        dcfg = dataclasses.replace(dcfg, znear=znear)
    if zfar is not None:
        dcfg = dataclasses.replace(dcfg, zfar=zfar)
    return dcfg


def checkpoint_state_dict(ckpt, model, prefix="nerf."):
    """The model state dict held by ``ckpt``: the port's checkpoint (a
    ``step_*`` directory, its ``state.pt`` or a ``checkpoints`` directory)
    or a reference checkpoint file, its PixelNeRF under ``prefix``."""
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    from diner_tpu_torch.utils.convert import reference_to_state_dict
    path = Path(ckpt)
    if path.name == ckpt_lib.STATE_FILE:
        path = path.parent
    if path.is_dir():
        path = Path(ckpt_lib.latest_checkpoint(path) or path)
        return ckpt_lib.load_state(path)["model"]
    blob = torch.load(path, map_location="cpu", weights_only=False)
    return reference_to_state_dict(blob, model.state_dict(), prefix)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.predict")
    ap.add_argument("--config", required=True)
    ap.add_argument("--ckpt", required=True,
                    help="a port checkpoint (step_* directory) or a "
                         "reference Lightning .ckpt")
    ap.add_argument("--out", required=True)
    ap.add_argument("--nsamples", type=int, default=None,
                    help="override renderer n_samples (n_gaussian rescaled)")
    ap.add_argument("--n", type=int, default=-1,
                    help="number of val samples to render (-1 = all)")
    ap.add_argument("--znear", type=float, default=None)
    ap.add_argument("--zfar", type=float, default=None)
    ap.add_argument("--model", default="DINER")
    ap.add_argument("--prefix", default="nerf.",
                    help="key prefix of the PixelNeRF module in a reference "
                         "checkpoint ('' for a bare PixelNeRF state dict)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    if args.model != "DINER":
        ap.exit(2, f"{ap.prog}: {args.model} is not yet ported to "
                "diner_tpu_torch (only DINER)\n")

    from diner_tpu_torch.data.loader import DataLoader
    from diner_tpu_torch.evaluation.suite import evaluate_folder
    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.diner import create_model, make_eval_step
    from diner_tpu_torch.train.loop import Trainer, arrays_of

    run_cfg = load_train_config(args.config, model_name=args.model)
    run_cfg.diner = override_config(run_cfg.diner, args.nsamples,
                                    args.znear, args.zfar)
    trainer = Trainer(run_cfg, device=args.device)
    example = next(iter(DataLoader(trainer.val_set, batch_size=1,
                                   num_workers=0)))
    model = create_model(run_cfg.diner, arrays_of(example), seed=0,
                         device=trainer.device)
    model.load_state_dict(checkpoint_state_dict(args.ckpt, model,
                                                args.prefix))
    eval_step = make_eval_step(model, run_cfg.diner)

    outdir = Path(args.out)
    gen = torch.Generator(device=trainer.device).manual_seed(0)
    trainer.create_prediction_folder(eval_step, outdir, gen,
                                     n_samples=args.n)
    scores = evaluate_folder(outdir, outdir, device=trainer.device)
    print(scores)
    return scores


if __name__ == "__main__":
    main()
