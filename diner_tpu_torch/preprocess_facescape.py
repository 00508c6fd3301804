"""Facescape preprocessing CLI: square-crop, resize, undistort, GT depth,
color calibration; the port's counterpart of
``scripts/preprocess_facescape.py`` (reference
``deps/facescape_preprocessing/process_dataset.py``).

Usage (from the repository root):

    python -m diner_tpu_torch.preprocess_facescape --dir_in RAW/1 \\
        --dir_out OUT/001 --rt_scale assets/facescape/Rt_scale_dict.json \\
        [--landmarks assets/facescape/landmark_indices.npz] \\
        [--crop_out 256] [--no-calibrate] [--device cuda|cpu]

Per pose directory of ``--dir_in`` it writes ``<pose>/view_XXXXX/rgba.png``,
``depth.png`` (uint16, 0.1 mm), ``rgba_colorcalib.png`` and the scan's
``cameras.json`` / ``3dlmks.npy`` under ``--dir_out``. The depth maps are
kernel R's and the calibration's colour samples go through kernel C: it
runs on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m diner_tpu_torch.preprocess_facescape")
    ap.add_argument("--dir_in", type=Path, required=True,
                    help="input subject directory, e.g. FACESCAPE_RAW/1")
    ap.add_argument("--dir_out", type=Path, required=True,
                    help="output subject directory, e.g. PROCESSED/001")
    ap.add_argument("--rt_scale", type=Path, required=True,
                    help="Rt_scale_dict.json (facescape alignment asset)")
    ap.add_argument("--landmarks", type=Path, default=None,
                    help="landmark_indices.npz (optional; skips 3dlmks "
                         "export when absent)")
    ap.add_argument("--crop_out", type=int, default=256)
    ap.add_argument("--padding_v", type=float, default=0.01)
    ap.add_argument("--padding_h", type=float, default=0.05)
    ap.add_argument("--no-calibrate", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    import numpy as np

    from diner_tpu_torch.device import resolve_device
    from diner_tpu_torch.preprocessing.facescape_pipeline import process_pose

    device = resolve_device(args.device)
    with open(args.rt_scale) as f:
        align_Rts = json.load(f)
    lm_indices = None
    if args.landmarks and args.landmarks.exists():
        lm_indices = np.load(args.landmarks)["v10"]

    pose_dirs = sorted(d for d in args.dir_in.iterdir()
                       if d.is_dir() and d.name[0].isdigit())
    args.dir_out.mkdir(parents=True, exist_ok=True)
    done = {}
    for pose_dir in pose_dirs:
        try:
            ok = process_pose(pose_dir, args.dir_out, align_Rts, lm_indices,
                              crop_out=args.crop_out,
                              padding_v=args.padding_v,
                              padding_h=args.padding_h,
                              calibrate=not args.no_calibrate,
                              device=device)
            print(f"{pose_dir.name}: {'ok' if ok else 'skipped'}",
                  flush=True)
            done[pose_dir.name] = ok
        except Exception as e:  # per-pose robustness (reference: print+skip)
            print(f"ERROR {pose_dir.name}: {e}", flush=True)
            done[pose_dir.name] = False
    return done


if __name__ == "__main__":
    main()
