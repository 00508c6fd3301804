"""The FaceScape MVS dataset (TransMVSNet depth for heads), host-side numpy.

Port-side copy of ``diner_tpu/mvs/facescape_dataset.py:24-160`` (reference
``deps/TransMVSNet/datasets/facescape.py``): DINER's binocular metas turned
into MVS samples (each eye the reference, the other the source; one sample
per id pair in ``write_prediction`` / ``val`` / ``test`` mode), RGBA images
on a white background, ground-truth depth from ``depth.png`` (uint16 ×
1e-4) or the left half of ``depth_TransMVSNet.png``, hypotheses
``linspace(znear 1.0, zfar 2.5)``, intrinsics ÷4 / ÷2 / 1 by stage.
``--dataset facescape`` of ``python -m diner_tpu_torch.mvs``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List

import numpy as np

from diner_tpu_torch.data.io import resize_nearest

RGBA_FNAME = "rgba_colorcalib_v2.png"


def build_facescape_mvs_metas(meta_dir, mode: str, nviews: int = 2
                              ) -> List[dict]:
    """DINER binocular metas → MVS metas (facescape.py:39-97)."""
    meta_dir = Path(meta_dir)
    if mode in ("train", "write_prediction"):
        stages = ["train"]
    elif mode in ("val", "test"):
        stages = ["val"]
    elif mode == "all":
        stages = ["train", "val"]
    else:
        raise ValueError(mode)

    diner_metas = []
    for stage in stages:
        with open(meta_dir / f"{stage}_metas_binocular.txt") as f:
            diner_metas += json.load(f)

    metas = []
    old = ("", "")
    suffix = "_val" if mode == "test" else ""
    idx = 0
    for m in diner_metas:
        pair = [m["l_refs" + suffix], m["r_refs" + suffix]]
        key = (m["scan_path"], str(pair))
        if key == old:
            continue
        old = key
        for i in range(nviews):
            targets = pair[(i + 1) % 2]
            refs = pair[i]
            if mode in ("write_prediction", "val", "test"):
                for j in range(len(targets)):
                    metas.append(dict(idx=idx, scan_path=m["scan_path"],
                                      target_ids=[targets[j]],
                                      ref_ids=[[refs[j]]]))
                    idx += 1
            else:
                metas.append(dict(idx=idx, scan_path=m["scan_path"],
                                  target_ids=targets, ref_ids=[refs]))
                idx += 1
    return metas


class MVSFacescapeDataset:
    znear = 1.0
    zfar = 2.5

    def __init__(self, datapath, mode: str, nviews: int = 2,
                 ndepths: int = 384,
                 split_dir: str = "assets/data_splits/facescape",
                 seed: int = 0):
        assert nviews == 2
        self.datapath = Path(datapath)
        self.mode = mode
        self.nviews = nviews
        self.ndepths = ndepths
        self.rnd = np.random.default_rng(seed)
        self.metas = build_facescape_mvs_metas(split_dir, mode, nviews)

    def __len__(self):
        return len(self.metas)

    @staticmethod
    def read_img(path):
        from PIL import Image
        img = np.asarray(Image.open(path).convert("RGBA")).astype(
            np.float32) / 255.0
        mask = img[..., 3:] > 0.5
        rgb = img[..., :3].copy()
        rgb[~mask[..., 0]] = 1.0  # white background
        return rgb, mask.astype(np.float32)

    def read_depth(self, view_path: Path):
        from PIL import Image
        p = view_path / "depth.png"
        if p.exists():
            d = np.asarray(Image.open(p)).astype(np.float32) * 1e-4
            return d
        trans = Image.open(view_path / "depth_TransMVSNet.png")
        gt = trans.crop((0, 0, trans.width // 2, trans.height))
        return np.asarray(gt).astype(np.float32) * 1e-4

    def _pyramid(self, x):
        h, w = x.shape
        return {"stage1": resize_nearest(x, h // 4, w // 4),
                "stage2": resize_nearest(x, h // 2, w // 2),
                "stage3": x}

    def __getitem__(self, idx: int) -> Dict:
        meta = self.metas[idx]
        target_id = str(self.rnd.choice(np.array(meta["target_ids"])))
        ref_ids = [str(self.rnd.choice(np.array(r)))
                   for r in meta["ref_ids"]]
        scan = self.datapath / meta["scan_path"]
        with open(scan / "cameras.json") as f:
            cams = json.load(f)

        view_ids = [target_id] + ref_ids
        imgs, proj = [], []
        depth_ms = mask_ms = None
        dpath = None
        for i, vid in enumerate(view_ids):
            vdir = scan / f"view_{int(vid):05d}"
            rgb, mask = self.read_img(vdir / RGBA_FNAME)
            E = np.asarray(cams[vid]["extrinsics"] + [[0, 0, 0, 1.0]],
                           np.float32)
            K = np.asarray(cams[vid]["intrinsics"], np.float32)
            pm = np.zeros((2, 4, 4), np.float32)
            pm[0] = E
            pm[1, :3, :3] = K
            proj.append(pm)
            imgs.append(rgb)
            if i == 0:
                depth_ms = self._pyramid(self.read_depth(vdir))
                mask_ms = self._pyramid(mask[..., 0])
                dpath = str((vdir / "depth.png"
                             ).relative_to(self.datapath))

        proj = np.stack(proj)
        proj_ms = {"stage3": proj}
        for stage, div in (("stage1", 4), ("stage2", 2)):
            p = proj.copy()
            p[:, 1, :2] /= div
            proj_ms[stage] = p

        depth_values = np.linspace(self.znear, self.zfar, self.ndepths,
                                   dtype=np.float32)
        return {
            "imgs": np.stack(imgs),
            "proj_matrices": proj_ms,
            "depth": depth_ms,
            "mask": mask_ms,
            "depth_values": depth_values,
            "depth_interval": np.float32(depth_values[1] - depth_values[0]),
            "dpath": dpath,
        }
