"""The FaceScape NOVEL dataset: cross-expression pairs (host-side numpy).

Port-side copy of ``diner_tpu/data/facescape_novel.py`` (reference
``src/data/facescape_novel.py``): source views of a reference expression
and a target view of another expression of the same subject; both meshes
(``face_vertices.npy``) and ``offset_target_to_source = ref − target``;
per-view positional-encoding maps (NOVEL_PE); the canonical "gen" subject
(002/03, camera 18) with its vertices, camera and PE map and
``offset_target_to_gen = gen − target``; mesh-rendered depth of the
reference expression. The fork's side trees are read under ``side_root``
(flat names) or beside the data.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Optional

import numpy as np

from diner_tpu_torch.data.facescape import (
    conf2std,
    read_depth_triptych,
    read_rgba,
    to_homogeneous,
)

RGBA_FNAME = "rgba_colorcalib_v2.png"
POS_ENCODING_FNAME = "pos_encoding.png"
DEPTH_MESH_FNAME = "depth_mesh.png"


def read_pos_encoding(path) -> np.ndarray:
    """PE map PNG → float32 (H, W, 3) — NOT normalized, matching the
    reference (facescape_novel.py:143-146)."""
    from PIL import Image
    return np.asarray(Image.open(path)).astype(np.float32)[..., :3]


def read_mesh_depth(path) -> tuple:
    """Mesh-rendered depth PNG → (depth (H,W,1), conf (H,W,1)) with the
    constant 0.8 confidence where valid."""
    from PIL import Image
    d = np.asarray(Image.open(path)).astype(np.float32) * 1e-4
    conf = np.where(d == 0.0, 0.0, 0.8).astype(np.float32)
    return d[..., None], conf[..., None]


def load_vertices(path) -> np.ndarray:
    return np.loadtxt(path, dtype=np.float32)


class FacescapeNovelDataset:
    znear = 1.0
    zfar = 2.5

    def __init__(self, root, stage: str, model: str = "NOVEL",
                 split_dir: str = "assets/data_splits/facescape",
                 side_root: Optional[str] = None,
                 gen_scan: str = "002/03", gen_view: str = "18",
                 n_repeat: Optional[int] = None):
        self.data_dir = Path(root)
        assert os.path.exists(root), root
        self.stage = stage
        self.model = model
        self.side_root = Path(side_root) if side_root else None
        self.rnd = (np.random.default_rng() if stage == "train"
                    else np.random.default_rng(128))
        meta_fpath = Path(split_dir) / f"{stage}_metas_novel.txt"
        with open(meta_fpath) as f:
            metas = json.load(f)
        if n_repeat is None:
            n_repeat = 5 if stage == "train" else 20
        self.metas = [m for m in metas for _ in range(n_repeat)]

        self.gen_scan = gen_scan
        self.gen_view = gen_view
        (self.gen_vertices, self.gen_pos_encoding, self.gen_extrinsics,
         self.gen_intrinsics) = self._load_general()

    def _load_general(self):
        gen_path = self.data_dir / self.gen_scan
        verts = load_vertices(gen_path / "face_vertices.npy")
        with open(gen_path / "cameras.json") as f:
            cams = json.load(f)
        intr = np.asarray(cams[self.gen_view]["intrinsics"], np.float32)
        extr = to_homogeneous(
            np.asarray(cams[self.gen_view]["extrinsics"], np.float32))
        pe = read_pos_encoding(self._side_path(
            "target_pos_encodings",
            Path(self.gen_scan) / f"view_{int(self.gen_view):05d}" /
            POS_ENCODING_FNAME))
        return verts, pe, extr, intr

    def _side_path(self, kind: str, rel: Path) -> Path:
        """Side-tree lookup: flat '<parts joined by _>' under side_root
        (the fork's layout) or in-tree next to the data."""
        if self.side_root is not None:
            return self.side_root / kind / "_".join(str(rel).split("/"))
        return self.data_dir / rel

    @staticmethod
    def int_to_viewdir(i: int) -> str:
        return f"view_{i:05d}"

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> Dict:
        meta = self.metas[idx]
        ref_path = Path(meta["ref_scan_path"])
        target_path = Path(meta["target_scan_path"])
        target_id = str(self.rnd.choice(np.array(meta["targets"])))
        left_id = str(self.rnd.choice(np.array(meta["l_refs"])))
        right_id = str(self.rnd.choice(np.array(meta["r_refs"])))
        source_ids = [left_id, right_id]

        ref_scan = self.data_dir / ref_path
        target_scan = self.data_dir / target_path
        subject = ref_scan.parent.name
        ref_frame = ref_scan.name
        target_frame = target_scan.name

        ref_vertices = load_vertices(ref_scan / "face_vertices.npy")
        target_vertices = load_vertices(target_scan / "face_vertices.npy")

        target_rgb, target_alpha = read_rgba(
            target_scan / self.int_to_viewdir(int(target_id)) / RGBA_FNAME)
        target_pe = read_pos_encoding(self._side_path(
            "target_pos_encodings",
            target_path / self.int_to_viewdir(int(target_id)) /
            POS_ENCODING_FNAME))

        rgbs, alphas, depths, stds, pes = [], [], [], [], []
        for sid in source_ids:
            vdir = self.int_to_viewdir(int(sid))
            rgb, a = read_rgba(ref_scan / vdir / RGBA_FNAME)
            d, c = read_mesh_depth(self._side_path(
                "depths_mesh", ref_path / vdir / DEPTH_MESH_FNAME))
            pe = read_pos_encoding(self._side_path(
                "ref_pos_encodings", ref_path / vdir / POS_ENCODING_FNAME))
            rgbs.append(rgb)
            alphas.append(a)
            depths.append(d)
            stds.append(c)
            pes.append(pe)

        with open(ref_scan / "cameras.json") as f:
            ref_cams = json.load(f)
        with open(target_scan / "cameras.json") as f:
            target_cams = json.load(f)

        return dict(
            target_rgb=target_rgb,
            target_alpha=target_alpha,
            target_extrinsics=to_homogeneous(np.asarray(
                target_cams[target_id]["extrinsics"], np.float32)),
            target_intrinsics=np.asarray(
                target_cams[target_id]["intrinsics"], np.float32),
            target_vertices=target_vertices,
            target_pos_encoding=target_pe,
            target_view_id=int(target_id),
            scan_idx=0,
            sample_name=f"{subject}-{ref_frame}-{target_frame}-{target_id}-"
                        f"{'-'.join(source_ids)}",
            src_rgbs=np.stack(rgbs),
            src_depths=np.stack(depths),
            src_depth_stds=conf2std(np.stack(stds)),
            src_alphas=np.stack(alphas),
            src_extrinsics=to_homogeneous(np.asarray(
                [ref_cams[i]["extrinsics"] for i in source_ids], np.float32)),
            src_intrinsics=np.asarray(
                [ref_cams[i]["intrinsics"] for i in source_ids], np.float32),
            src_vertices=ref_vertices,
            src_pos_encodings=np.stack(pes),
            src_view_ids=np.asarray([int(i) for i in source_ids]),
            offset_target_to_source=ref_vertices - target_vertices,
            gen_extrinsics=self.gen_extrinsics,
            gen_intrinsics=self.gen_intrinsics,
            gen_pos_encoding=self.gen_pos_encoding,
            offset_target_to_gen=self.gen_vertices - target_vertices,
        )
