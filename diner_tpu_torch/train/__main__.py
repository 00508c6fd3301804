"""Training entry point of the port, the counterpart of ``scripts/train.py``.

Usage (from the repository root):

    python -m diner_tpu_torch.train <config.yaml>
        [DINER|KeypointNeRF|NOVEL|NOVEL_PE]
        [--max-steps N] [--num-workers N] [--device cuda|cpu] [--debug-nans]
        [--mesh [--data-parallel K]]

It runs on ``cuda`` unless ``--device cpu`` is given. DINER trains with
the trainer loop (``train/loop.py``); with ``--mesh`` over a ('data',
'rays') mesh of every rank (``parallel/``, ``scripts/train.py:33-35,
51-55``), one process a GPU under torchrun::

    torchrun --nproc_per_node 4 -m diner_tpu_torch.train <config.yaml> \
        DINER --mesh [--data-parallel K]

and without a launcher as a world of one through the same collective
path. KeypointNeRF trains with
``models/keypointnerf/train.py:fit_keypointnerf``; NOVEL and NOVEL_PE with
``models/novel/train.py:fit_novel``, as ``scripts/train.py`` does.
``--debug-nans`` trains under ``torch.autograd.set_detect_anomaly``: the
backward raises at the first op that returns NaN and names the forward op
that made it (the JAX CLI's ``jax_debug_nans``).
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
    ap.add_argument("--mesh", action="store_true",
                    help="DINER over a ('data', 'rays') mesh of every rank "
                         "(torchrun's, or a world of one)")
    ap.add_argument("--data-parallel", type=int, default=None,
                    help="the mesh's data axis (default: the JAX package's "
                         "rule)")
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection: error at the first "
                         "NaN-producing op of a backward")
    args = ap.parse_args(argv)

    import torch

    from diner_tpu_torch.device import resolve_device
    from diner_tpu_torch.train.config import load_train_config

    device = resolve_device(args.device)
    run_cfg = load_train_config(args.config, model_name=args.model)
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        if args.model == "DINER" and args.mesh:
            train_on_mesh(run_cfg, args)
        elif args.model == "DINER":
            from diner_tpu_torch.train.loop import Trainer
            Trainer(run_cfg, num_workers=args.num_workers,
                    device=device).fit(max_steps=args.max_steps)
        elif args.model == "KeypointNeRF":
            from diner_tpu_torch.models.keypointnerf.train import (
                fit_keypointnerf)
            fit_keypointnerf(run_cfg, max_steps=args.max_steps,
                             device=device, num_workers=args.num_workers)
        else:
            from diner_tpu_torch.models.novel.train import fit_novel
            fit_novel(run_cfg, max_steps=args.max_steps,
                      use_pe=args.model == "NOVEL_PE", device=device,
                      num_workers=args.num_workers)


def train_on_mesh(run_cfg, args):
    """The trainer over the mesh of every rank; leaves the process group
    it joined (one the caller joined stays)."""
    import torch.distributed as dist

    from diner_tpu_torch.parallel import initialize, make_mesh, shutdown
    from diner_tpu_torch.train.loop import Trainer
    joined = not dist.is_initialized()
    device = initialize(device=args.device)
    try:
        mesh = make_mesh(data_parallel=args.data_parallel)
        if mesh.rank == 0:
            print(f"training over mesh {mesh.shape} ({dist.get_backend()})",
                  flush=True)
        Trainer(run_cfg, mesh=mesh, num_workers=args.num_workers,
                device=device).fit(max_steps=args.max_steps)
    finally:
        if joined:
            shutdown()


if __name__ == "__main__":
    main()
