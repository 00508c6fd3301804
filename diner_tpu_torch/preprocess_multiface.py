"""Multiface preprocessing: render GT depth + masks from tracked meshes; the
port's counterpart of ``scripts/preprocess_multiface.py`` (reference
``deps/multiface/process_dataset.py``).

Usage (from the repository root):

    python -m diner_tpu_torch.preprocess_multiface --root data/MULTIFACE \\
        [-s SUBJECT ...] [-H 2048] [-W 1334] [--device cuda|cpu]

For every subject / sequence / frame / camera of the KRT file it
rasterizes the tracked mesh (``tracked_mesh/<seq>/<frame>.obj``, mm) into
a z-buffer with kernel R and writes ``<subj>/depths/<seq>/<cam>/<frame>.png``
(uint16 at 0.1 mm: ``SCALE_FACTOR`` 1e-1 on mm depths,
process_dataset.py:37-47) and ``<subj>/masks/<seq>/<cam>/<frame>.png``
(255 where the depth is not 0), which ``data/multiface.py`` reads. It runs
on ``cuda`` unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

UINT16_MAX = 65535
SCALE_FACTOR = 1e-1  # 6.5535 m range at 0.1 mm resolution (mm inputs)


def float32_2_uint16(x: np.ndarray) -> np.ndarray:
    float_max = UINT16_MAX * SCALE_FACTOR
    return (x.clip(max=float_max) / SCALE_FACTOR).round().astype(np.uint16)


def uint16_2_float32(x: np.ndarray) -> np.ndarray:
    return x.astype(np.float32) * SCALE_FACTOR


def process_frame(mesh_path, krt, out_subj, seq_name, H, W, device):
    """Every camera's depth and mask PNG of one tracked mesh → the depth
    PNGs' paths."""
    import torch
    from PIL import Image

    from diner_tpu_torch.preprocessing.rasterize import (
        load_obj_vertices_faces, rasterize_depth)

    verts, faces = load_obj_vertices_faces(mesh_path)
    verts = torch.as_tensor(verts, device=device)
    faces = torch.as_tensor(faces, device=device)
    written = []
    for cam_name in sorted(krt.keys()):
        K = krt[cam_name]["intrin"].astype(np.float32)
        E34 = krt[cam_name]["extrin"].astype(np.float32)
        depth = rasterize_depth(verts, faces, K, E34, H, W).cpu().numpy()
        alpha = (depth != 0).astype(np.float32)

        out_d = out_subj / "depths" / seq_name / cam_name / \
            f"{mesh_path.stem}.png"
        out_a = out_subj / "masks" / seq_name / cam_name / \
            f"{mesh_path.stem}.png"
        out_d.parent.mkdir(parents=True, exist_ok=True)
        out_a.parent.mkdir(parents=True, exist_ok=True)
        Image.fromarray(float32_2_uint16(depth)).save(out_d)
        Image.fromarray((alpha * 255).astype(np.uint8)).save(out_a)
        written.append(out_d)
    return written


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m diner_tpu_torch.preprocess_multiface")
    ap.add_argument("--root", type=Path, default=Path("data/MULTIFACE"))
    ap.add_argument("--subjects", "-s", nargs="*", default=[])
    ap.add_argument("-H", type=int, default=2048)
    ap.add_argument("-W", type=int, default=1334)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from diner_tpu_torch.data.multiface import load_krt
    from diner_tpu_torch.device import resolve_device

    device = resolve_device(args.device)
    subjects = args.subjects or sorted(
        p.name for p in args.root.iterdir() if p.is_dir())
    written = []
    for subj in subjects:
        subj_path = args.root / subj
        krt = load_krt(subj_path / "KRT")
        mesh_root = subj_path / "tracked_mesh"
        if not mesh_root.exists():
            print(f"skipping {subj}: no tracked_mesh/")
            continue
        for seq_path in sorted(mesh_root.iterdir()):
            meshes = [p for p in sorted(seq_path.iterdir())
                      if p.suffix == ".obj"]
            for i, mesh_path in enumerate(meshes):
                written += process_frame(mesh_path, krt, subj_path,
                                         seq_path.name, args.H, args.W,
                                         device)
                print(f"{subj}/{seq_path.name}: {i + 1}/{len(meshes)}",
                      flush=True)
    return written


if __name__ == "__main__":
    main()
