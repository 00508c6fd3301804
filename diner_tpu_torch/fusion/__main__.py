"""Fuse an existing dense folder into a PLY (gipuma protocol), the port's
counterpart of ``scripts/fuse.py`` (reference
``deps/TransMVSNet/gipuma.py:192-213``): ``fusion/fusion.py:
fuse_dense_folder`` probability-filters each view's depth map, then keeps
the points that enough other views agree with.

The dense folder (what ``python -m diner_tpu_torch.mvs.evaluate`` writes
per scan):

    cams/<stem>_cam.txt        MVSNet camera files
    depth_est/<stem>.pfm       estimated depth
    confidence/<stem>.pfm      photometric confidence
    images/<stem>.jpg|png      (optional, for point colours)

Usage:

    python -m diner_tpu_torch.fusion --scan_dir <dense_folder> \\
        --out fused.ply [--prob_threshold 0.9] [--disp_threshold 0.25] \\
        [--normal_threshold 0.52] [--num_consistent 3]

It runs on the host (the C++/OpenMP library), on no GPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.fusion")
    ap.add_argument("--scan_dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--prob_threshold", type=float, default=0.9)
    ap.add_argument("--disp_threshold", type=float, default=0.25)
    ap.add_argument("--normal_threshold", type=float, default=0.52)
    ap.add_argument("--num_consistent", type=int, default=3)
    args = ap.parse_args(argv)

    from diner_tpu_torch.fusion.fusion import fuse_dense_folder

    scan = Path(args.scan_dir)
    stems = sorted(p.stem for p in (scan / "depth_est").glob("*.pfm"))
    if not stems:
        raise SystemExit(f"no depth_est/*.pfm under {scan}")
    pts = fuse_dense_folder(scan, stems, args.out, args.prob_threshold,
                            args.disp_threshold, args.normal_threshold,
                            args.num_consistent)
    print(f"fused {len(pts)} points -> {args.out}")
    return {"ply": str(args.out), "points": int(len(pts))}


if __name__ == "__main__":
    main()
