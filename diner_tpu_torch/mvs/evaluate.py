"""MVS test-time inference, filtering and fusion into point clouds, the
port's counterpart of ``scripts/mvs_test.py`` (reference
``deps/TransMVSNet/test.py``).

Usage (from the repository root):

    python -m diner_tpu_torch.mvs.evaluate --testpath ROOT \\
        --testlist scan1,scan4 [--ckpt CKPT] [--outdir outputs/mvs_test] \\
        [--filter_method normal|gipuma|dynamic|none] [--num_view 5] \\
        [--max_h 864] [--max_w 1152] [--fix_res] [--conf 0.9] \\
        [--thres_view 3] [--max-samples N] [--device cuda|cpu]

Per scan (``ROOT/<scan>/{images,cams,pair.txt}``) it writes the
reference's folder protocol: ``<scan>/depth_est/<vid>.pfm`` (and a
viridis ``.png``), ``<scan>/confidence/<vid>.pfm`` (the stage-3
confidence × the bilinearly upsampled stage-1 and stage-2 ones,
test.py:176-179), ``<scan>/cams/<vid>_cam.txt`` and
``<scan>/images/<vid>.jpg``; then it filters and fuses them into
``mvsnet_<scan>.ply``: ``normal`` (reprojection consistency),
``gipuma`` (the C++/OpenMP fusibile equivalent, ``fusion/fusion.py``),
``dynamic`` (dynamic_fusion.py) or ``none``. ``--ckpt`` is a reference
TransMVSNet checkpoint; without it the weights are a seeded draw. It runs on ``cuda`` unless ``--device cpu``
is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.mvs.evaluate")
    ap.add_argument("--testpath", required=True)
    ap.add_argument("--testlist", required=True,
                    help="comma-separated scans or a list file")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--outdir", default="outputs/mvs_test")
    ap.add_argument("--ndepths", default="48,32,8")
    ap.add_argument("--depth_inter_r", default="4,2,1")
    ap.add_argument("--numdepth", type=int, default=192)
    ap.add_argument("--interval_scale", type=float, default=1.06)
    ap.add_argument("--num_view", type=int, default=5)
    ap.add_argument("--max_h", type=int, default=864)
    ap.add_argument("--max_w", type=int, default=1152)
    ap.add_argument("--fix_res", action="store_true")
    ap.add_argument("--filter_method", default="normal",
                    choices=["normal", "gipuma", "dynamic", "none"])
    ap.add_argument("--conf", type=float, default=0.9,
                    help="photometric confidence threshold")
    ap.add_argument("--thres_view", type=int, default=3)
    ap.add_argument("--max-samples", type=int, default=-1)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)

    from diner_tpu_torch.data.io import resize_bilinear, write_pfm
    from diner_tpu_torch.device import resolve_device
    from diner_tpu_torch.mvs import predict
    from diner_tpu_torch.mvs.eval_datasets import MVSGeneralEvalDataset
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    from diner_tpu_torch.utils.visual import colorize
    from PIL import Image

    device = resolve_device(args.device)
    lp = Path(args.testlist)
    scans = ([s for s in lp.read_text().split() if s] if lp.is_file()
             else args.testlist.split(","))
    dataset = MVSGeneralEvalDataset(
        args.testpath, scans, "test", nviews=args.num_view,
        ndepths=args.numdepth, interval_scale=args.interval_scale,
        max_h=args.max_h, max_w=args.max_w, fix_res=args.fix_res)
    cfg = TransMVSNetConfig(
        ndepths=tuple(int(x) for x in args.ndepths.split(",")),
        depth_intervals_ratio=tuple(
            float(x) for x in args.depth_inter_r.split(",")))
    model = predict.create_model(cfg, args.ckpt, device)

    out_root = Path(args.outdir)
    n = len(dataset) if args.max_samples < 0 else min(len(dataset),
                                                      args.max_samples)
    for i in range(n):
        s = dataset[i]
        out = predict.run_model(model, s, device)
        depth = out["depth"][0].cpu().numpy().astype(np.float32)
        H, W = depth.shape
        conf = out["photometric_confidence"][0].cpu().numpy()
        for stage in ("stage1", "stage2"):
            c = out[stage]["photometric_confidence"][0].cpu().numpy()
            conf = conf * resize_bilinear(c.astype(np.float32), H, W)

        fn = s["filename"]
        for sub in ("depth_est", "confidence", "cams", "images"):
            (out_root / fn.format(sub, "")).parent.mkdir(parents=True,
                                                         exist_ok=True)
        write_pfm(out_root / fn.format("depth_est", ".pfm"), depth)
        write_pfm(out_root / fn.format("confidence", ".pfm"), conf)
        vis = (colorize(depth) * 255).astype(np.uint8)
        Image.fromarray(vis).save(out_root / fn.format("depth_est", ".png"))
        Image.fromarray((np.clip(s["imgs"][0], 0, 1) * 255).astype(
            np.uint8)).save(out_root / fn.format("images", ".jpg"))
        dv = s["depth_values"]
        write_cam(out_root / fn.format("cams", "_cam.txt"),
                  s["proj_matrices"]["stage3"][0], float(dv[0]),
                  float(dv[1] - dv[0]))
        print(f"[{i + 1}/{n}] {fn.format('depth_est', '.pfm')}", flush=True)

    if args.filter_method == "none":
        return {}
    return {scan: fuse_scan(args, scan, out_root) for scan in scans}


def write_cam(path, cam, depth_min, depth_interval):
    """Reference write_cam format (test.py:111-128)."""
    lines = ["extrinsic"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in cam[0]]
    lines += ["", "intrinsic"]
    lines += [" ".join(f"{v:.6f}" for v in row) for row in cam[1, :3, :3]]
    lines += ["", f"{depth_min} {depth_interval}"]
    Path(path).write_text("\n".join(lines) + "\n")


def read_cam(path):
    lines = [ln.rstrip() for ln in Path(path).read_text().splitlines()]
    E = np.fromstring(" ".join(lines[1:5]), dtype=np.float32,
                      sep=" ").reshape(4, 4)
    K = np.fromstring(" ".join(lines[7:10]), dtype=np.float32,
                      sep=" ").reshape(3, 3)
    return K, E


def fuse_scan(args, scan, out_root):
    """Filter and fuse one scan's depth maps into ``mvsnet_<scan>.ply``
    by ``args.filter_method``; returns the PLY's path and point count."""
    from diner_tpu_torch.data.io import read_pfm, read_rgb
    from diner_tpu_torch.fusion.consistency import (
        filter_and_fuse, filter_and_fuse_dynamic)
    from diner_tpu_torch.fusion.fusion import fuse_dense_folder, write_ply
    from diner_tpu_torch.mvs.eval_datasets import read_pair_file

    pairs = read_pair_file(Path(args.testpath) / scan / "pair.txt")
    scan_out = out_root / scan
    view_ids = sorted({r for r, _ in pairs}
                      | {s for _, srcs in pairs for s in srcs})
    ply_path = out_root / f"mvsnet_{scan}.ply"
    if args.filter_method == "gipuma":
        pts = fuse_dense_folder(scan_out, [f"{v:08d}" for v in view_ids],
                                ply_path, prob_threshold=args.conf,
                                num_consistent=args.thres_view)
        print(f"fused {scan}: {len(pts)} points -> {ply_path}", flush=True)
        return {"ply": str(ply_path), "points": int(len(pts))}

    id_map = {v: i for i, v in enumerate(view_ids)}
    depths, confs, Ks, Es, images = [], [], [], [], []
    for vid in view_ids:
        depths.append(np.asarray(
            read_pfm(scan_out / "depth_est" / f"{vid:08d}.pfm")[0],
            np.float32))
        confs.append(np.asarray(
            read_pfm(scan_out / "confidence" / f"{vid:08d}.pfm")[0],
            np.float32))
        K, E = read_cam(scan_out / "cams" / f"{vid:08d}_cam.txt")
        Ks.append(K)
        Es.append(E)
        images.append(read_rgb(scan_out / "images" / f"{vid:08d}.jpg"))

    idx_pairs = [(id_map[r], [id_map[s] for s in srcs if s in id_map])
                 for r, srcs in pairs]
    if args.filter_method == "dynamic":
        pts, colors, _ = filter_and_fuse_dynamic(
            depths, confs, Ks, Es, idx_pairs, images=images,
            photo_threshold=0.3, thres_view=args.thres_view)
    else:
        pts, colors, _ = filter_and_fuse(
            depths, confs, Ks, Es, idx_pairs, images=images,
            conf_thresh=args.conf, thres_view=args.thres_view)
    pts = np.concatenate(
        [pts, np.zeros_like(pts),
         colors if colors is not None else np.zeros_like(pts)], axis=1)
    write_ply(ply_path, pts, with_normals=False,
              with_colors=colors is not None)
    print(f"fused {scan}: {len(pts)} points -> {ply_path}", flush=True)
    return {"ply": str(ply_path), "points": int(len(pts))}


if __name__ == "__main__":
    main()
