"""TransMVSNet depth inference over a DTU tree, the port's counterpart of
``scripts/mvs_train.py`` (reference ``deps/TransMVSNet/train.py``).

Usage (from the repository root):

    python -m diner_tpu_torch.mvs --mode write_prediction --ckpt CKPT \\
        --trainpath data/DTU --trainlist lists/all.txt [--outpath DIR] \\
        [--ndepths 48,32,8] [--depth_inter_r 4,2,1] [--numdepth 192] \\
        [--interval_scale 1.06] [--maskoutput] [--device cuda|cpu]
    python -m diner_tpu_torch.mvs --mode val --ckpt CKPT --trainpath … \\
        --trainlist … [--max-steps N]

``write_prediction`` writes the ``depth_map_XXXX_TransMVSNet(.png|_conf|
_vis)`` PNGs that ``data/dtu.py:DTUDataset(depth_fname="TransMVSNet")``
reads, under ``--outpath`` (default: the DTU root). ``val`` prints the
depth metrics (abs error, share of pixels over 2 / 4 / 8 mm) over the set.
``--ckpt`` is a reference TransMVSNet checkpoint (``{"model": …}`` or a
bare state dict); without it the weights are a seeded draw. The dataset is ``dtu_yao``; the other
datasets, ``--mode train`` / ``profile`` and ``--dtype bfloat16`` are not
yet ported and exit with status 2. The flags of the training modes are
accepted as the JAX script takes them. It runs on ``cuda`` unless
``--device cpu`` is given.
"""

from __future__ import annotations

import argparse

import torch


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.mvs")
    ap.add_argument("--mode", default="train",
                    choices=["train", "val", "write_prediction", "profile"])
    ap.add_argument("--dataset", default="dtu_yao",
                    choices=["dtu_yao", "facescape", "multiface", "bld"])
    ap.add_argument("--trainpath", required=True)
    ap.add_argument("--trainlist", default=None, help="scan list (dtu_yao)")
    ap.add_argument("--split_dir", default=None)
    ap.add_argument("--split_config", default=None)
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
                    help="reference TransMVSNet checkpoint")
    ap.add_argument("--outpath", default=None)
    ap.add_argument("--maskoutput", action="store_true")
    ap.add_argument("--max-steps", type=int, default=-1)
    ap.add_argument("--debug-nans", action="store_true")
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--remat-mode", default="full",
                    choices=["full", "selective"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def model_config(args):
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    return TransMVSNetConfig(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        depth_intervals_ratio=tuple(float(x)
                                    for x in args.depth_inter_r.split(",")),
        remat=args.remat, remat_feature=args.remat_mode == "full")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    for what, unported in (
            (f"--mode {args.mode}", args.mode in ("train", "profile")),
            (f"--dataset {args.dataset}", args.dataset != "dtu_yao"),
            ("--dtype bfloat16", args.dtype != "float32")):
        if unported:
            ap.exit(2, f"{ap.prog}: {what} is not yet ported to "
                    "diner_tpu_torch (write_prediction and val on dtu_yao, "
                    "float32)\n")
    if not args.trainlist:
        ap.error("--trainlist is required for dtu_yao")

    from diner_tpu_torch.device import resolve_device
    from diner_tpu_torch.mvs import predict
    from diner_tpu_torch.mvs.datasets import MVSDTUDataset

    device = resolve_device(args.device)
    dataset = MVSDTUDataset(args.trainpath, args.trainlist, "val",
                            nviews=args.nviews, ndepths=args.numdepth,
                            interval_scale=args.interval_scale)
    model = predict.create_model(model_config(args), args.ckpt, device)

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
            "abs_depth_error": predict.abs_depth_error(d, gt, mask),
            "thres2mm_error": predict.threshold_metric(d, gt, mask, 2.0),
            "thres4mm_error": predict.threshold_metric(d, gt, mask, 4.0),
            "thres8mm_error": predict.threshold_metric(d, gt, mask, 8.0)})
    scores = meter.mean()
    for k, v in scores.items():
        print(f"{k}: {v:.4f}")
    return scores


if __name__ == "__main__":
    main()
