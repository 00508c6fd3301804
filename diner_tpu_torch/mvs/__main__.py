"""TransMVSNet training and depth inference, the port's counterpart of
``scripts/mvs_train.py`` (reference ``deps/TransMVSNet/train.py``).

Usage (from the repository root):

    python -m diner_tpu_torch.mvs --mode train --trainpath data/DTU \\
        --trainlist lists/train.txt [--ndepths 48,32,8] [--epochs 16] \\
        [--max-steps N] [--logdir outputs/mvs] [--ckpt CKPT] \\
        [--dtype float32|bfloat16] [--remat [--remat-mode full|selective]] \\
        [--debug-nans] [--device cuda|cpu]
    python -m diner_tpu_torch.mvs --mode profile …
    python -m diner_tpu_torch.mvs --mode write_prediction --ckpt CKPT \\
        --trainpath data/DTU --trainlist lists/all.txt [--outpath DIR] \\
        [--maskoutput]
    python -m diner_tpu_torch.mvs --mode val --ckpt CKPT … [--max-steps N]

``train`` resumes from the latest checkpoint under ``--logdir/checkpoints``
(or from ``--ckpt``) at the batch where that run stopped, takes shuffled
batches (seed 0 plus the epoch) for ``--epochs`` epochs or until
``--max-steps`` updates in all, prints each step's loss and seconds (after
a sync), and checkpoints at each epoch's end and when it stops.
``profile`` takes one step to warm up, then traces 5 steps into
``--logdir/trace/trace.json``. ``write_prediction`` writes the
``depth_map_XXXX_TransMVSNet(.png|_conf|_vis)`` PNGs that
``data/dtu.py:DTUDataset(depth_fname="TransMVSNet")`` reads, under
``--outpath`` (default: the data root); ``val`` prints the depth metrics
(abs error, share of pixels over 2 / 4 / 8 mm) over the set.

``--ckpt`` is a port checkpoint directory (``step_*``: a full resume of
model, Adam, schedule and step count in ``train``) or a reference
TransMVSNet checkpoint (``{"model": …}`` or a bare state dict: the weights
only); without it every mode reads the run's latest checkpoint, and
without one the weights are a seeded draw. ``--dataset`` is
``dtu_yao``, ``bld`` (BlendedMVS), ``facescape`` (``--split_dir``) or
``multiface`` (``--split_config``, the DINER split JSON with 4 reference
centres; ``--split_dir`` caches its metas). ``--debug-nans``
trains under ``torch.autograd.set_detect_anomaly``. It runs on ``cuda``
unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.mvs")
    ap.add_argument("--mode", default="train",
                    choices=["train", "val", "write_prediction", "profile"])
    ap.add_argument("--dataset", default="dtu_yao",
                    choices=["dtu_yao", "facescape", "multiface", "bld"])
    ap.add_argument("--trainpath", required=True)
    ap.add_argument("--trainlist", default=None,
                    help="scan list (dtu_yao / bld)")
    ap.add_argument("--split_dir", default=None,
                    help="facescape: DINER split directory; multiface: "
                         "the metas' cache directory")
    ap.add_argument("--split_config", default=None,
                    help="multiface: split json")
    ap.add_argument("--vallist", default=None)
    ap.add_argument("--ndepths", default="48,32,8")
    ap.add_argument("--depth_inter_r", default="4,2,1")
    ap.add_argument("--numdepth", type=int, default=192)
    ap.add_argument("--interval_scale", type=float, default=1.06)
    ap.add_argument("--nviews", type=int, default=4)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--epochs", type=int, default=16)
    ap.add_argument("--batch_size", type=int, default=1)
    ap.add_argument("--logdir", default="outputs/mvs")
    ap.add_argument("--ckpt", default=None,
                    help="port step_* directory or reference checkpoint")
    ap.add_argument("--outpath", default=None)
    ap.add_argument("--maskoutput", action="store_true")
    ap.add_argument("--max-steps", type=int, default=-1)
    ap.add_argument("--debug-nans", action="store_true",
                    help="autograd anomaly detection: error at the first "
                         "NaN-producing op of a backward")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"],
                    help="activation/matmul compute dtype (params stay f32)")
    ap.add_argument("--remat", action="store_true",
                    help="recompute FeatureNet / plane-sweep / 3-D U-Net "
                         "activations in the backward")
    ap.add_argument("--remat-mode", default="full",
                    choices=["full", "selective"],
                    help="with --remat: 'selective' keeps FeatureNet's "
                         "activations and recomputes only the plane sweep "
                         "and the U-Nets")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def model_config(args):
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    return TransMVSNetConfig(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        depth_intervals_ratio=tuple(float(x)
                                    for x in args.depth_inter_r.split(",")),
        remat=args.remat, remat_feature=args.remat_mode == "full")


def train_config(args):
    from diner_tpu_torch.mvs.train import MVSTrainConfig
    return MVSTrainConfig(model=model_config(args), lr=args.lr,
                          compute_dtype=args.dtype)


def build_dataset(args, ap):
    """The dataset of ``--dataset`` in the mode the JAX script gives it."""
    mode = "train" if args.mode == "train" else "val"
    if args.dataset in ("dtu_yao", "bld") and not args.trainlist:
        ap.error(f"--trainlist is required for {args.dataset}")
    if args.dataset == "multiface" and not args.split_config:
        ap.error("--split_config is required for multiface")
    if args.dataset == "dtu_yao":
        from diner_tpu_torch.mvs.datasets import MVSDTUDataset
        return MVSDTUDataset(args.trainpath, args.trainlist, mode,
                             nviews=args.nviews, ndepths=args.numdepth,
                             interval_scale=args.interval_scale)
    if args.dataset == "facescape":
        from diner_tpu_torch.mvs.facescape_dataset import MVSFacescapeDataset
        return MVSFacescapeDataset(
            args.trainpath, args.mode, nviews=args.nviews,
            ndepths=args.numdepth,
            **({"split_dir": args.split_dir} if args.split_dir else {}))
    if args.dataset == "multiface":
        from diner_tpu_torch.mvs.multiface_dataset import MVSMultifaceDataset
        return MVSMultifaceDataset(
            args.trainpath, args.mode, nviews=args.nviews,
            ndepths=args.numdepth, split_config=args.split_config,
            meta_dir=args.split_dir)
    from diner_tpu_torch.mvs.eval_datasets import MVSBlendedDataset
    return MVSBlendedDataset(args.trainpath, args.trainlist, mode,
                             nviews=args.nviews, ndepths=args.numdepth)


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)

    from diner_tpu_torch.device import resolve_device
    device = resolve_device(args.device)
    dataset = build_dataset(args, ap)
    cfg = train_config(args)
    if args.mode in ("write_prediction", "val"):
        return infer(args, cfg, dataset, device)
    return train(args, cfg, dataset, device)


def infer(args, cfg, dataset, device):
    from diner_tpu_torch.mvs import predict
    from diner_tpu_torch.mvs.loss import abs_depth_error, threshold_metric
    from diner_tpu_torch.mvs.train import DTYPES
    from diner_tpu_torch.train.checkpoint import latest_checkpoint
    ckpt = args.ckpt or latest_checkpoint(Path(args.logdir) / "checkpoints")
    model = predict.create_model(cfg.model, ckpt, device,
                                 dtype=DTYPES[args.dtype])
    if args.mode == "write_prediction":
        out = predict.write_prediction(model, dataset,
                                       args.outpath or args.trainpath,
                                       mask_output=args.maskoutput,
                                       device=device)
        print(f"wrote {len(out)} depth maps")
        return out

    from diner_tpu_torch.utils.meters import DictAverageMeter
    meter = DictAverageMeter()
    n = len(dataset) if args.max_steps < 0 else min(len(dataset),
                                                    args.max_steps)
    for i in range(n):
        s = dataset[i]
        d = predict.run_model(model, s, device)["depth"]
        gt = torch.as_tensor(s["depth"]["stage3"], device=device)[None]
        mask = torch.as_tensor(s["mask"]["stage3"], device=device)[None]
        meter.update({
            "abs_depth_error": abs_depth_error(d, gt, mask),
            "thres2mm_error": threshold_metric(d, gt, mask, 2.0),
            "thres4mm_error": threshold_metric(d, gt, mask, 4.0),
            "thres8mm_error": threshold_metric(d, gt, mask, 8.0)})
    scores = meter.mean()
    for k, v in scores.items():
        print(f"{k}: {v:.4f}")
    return scores


def restore(state, args, ckpt_dir):
    """Resume ``state`` from ``--ckpt`` (a port checkpoint in full, a
    reference one's weights) or from the run's latest checkpoint."""
    from diner_tpu_torch.mvs.predict import load_checkpoint
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    path = args.ckpt or ckpt_lib.latest_checkpoint(ckpt_dir)
    if path is None:
        return
    if (Path(path) / ckpt_lib.STATE_FILE).is_file():
        ckpt_lib.restore_checkpoint(path, state)
    else:
        load_checkpoint(state.model, path)
    print(f"resumed from {path} at step {state.step}", flush=True)


def epoch_loader(dataset, batch_size, epoch, skip=0):
    """Epoch ``epoch``'s batches in the JAX script's shuffled order (seed 0
    plus the epoch), from batch ``skip`` on: a resumed run takes the
    batches the interrupted one had not."""
    from diner_tpu_torch.data.loader import DataLoader
    order = DataLoader(dataset, batch_size, shuffle=True, seed=0)
    order.epoch = epoch
    rest = order._epoch_indices()[skip * batch_size:]
    return DataLoader(dataset, batch_size, num_workers=2,
                      sample_indices=rest.tolist())


def train(args, cfg, dataset, device):
    """``--mode train`` and ``--mode profile``; returns the per-step
    records of ``train`` (step, loss, depth_loss, entropy, skipped, s)."""
    from diner_tpu_torch.data.loader import DataLoader
    from diner_tpu_torch.mvs.train import (batch_to_device, create_mvs_state,
                                           make_mvs_train_step)
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    from diner_tpu_torch.utils.profiling import sync, trace

    example = next(iter(DataLoader(dataset, args.batch_size,
                                   num_workers=0)))
    state = create_mvs_state(cfg, seed=0, example_batch=example,
                             device=device)
    ckpt_dir = Path(args.logdir) / "checkpoints"
    restore(state, args, ckpt_dir)
    step_fn = make_mvs_train_step(state, cfg)

    if args.mode == "profile":
        batch = batch_to_device(example, device)
        step_fn(batch)  # warm-up
        trace_dir = str(Path(args.logdir) / "trace")
        with trace(trace_dir):
            for _ in range(5):
                step_fn(batch)
        print(f"wrote profiler trace to {trace_dir}")
        return trace_dir

    records = []
    n_batches = -(-len(dataset) // args.batch_size)
    start_epoch, skip = divmod(state.step, n_batches)
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        for epoch in range(start_epoch, args.epochs):
            if 0 <= args.max_steps <= state.step:
                break
            for batch in epoch_loader(dataset, args.batch_size, epoch,
                                      skip if epoch == start_epoch else 0):
                if 0 <= args.max_steps <= state.step:
                    break
                t0 = time.perf_counter()
                loss, depth_loss, entropy, skipped = step_fn(
                    batch_to_device(batch, device))
                sync()
                rec = dict(step=state.step, loss=float(loss),
                           depth_loss=float(depth_loss),
                           entropy=float(entropy), skipped=float(skipped),
                           s=time.perf_counter() - t0)
                records.append(rec)
                print(f"epoch {epoch} step {rec['step']} loss "
                      f"{rec['loss']:.4f} depth_loss {rec['depth_loss']:.4f} "
                      f"skipped {rec['skipped']:.0f} ({rec['s']:.3f} s/it)",
                      flush=True)
            ckpt_lib.save_checkpoint(ckpt_dir, state)
    print("done")
    return records
