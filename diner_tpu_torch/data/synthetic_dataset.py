"""Map-style dataset over analytic sphere scenes (for tests and training
runs without any data on disk). Each index varies the target camera angle.

Port of ``diner_tpu/data/synthetic_dataset.py:SphereDataset`` on the port's
``data/synthetic.py``, with the camera sweep of validation (a circle of
look-at cameras around the sphere). ``model`` selects the batch schema:

  - DINER (default): images, depths and cameras;
  - KeypointNeRF: + ``src_alphas`` (the sources' foreground),
    ``target_mask``, ``target_kpt3d`` (``n_kpt`` points on the sphere's
    surface) and ``bounds`` (the sphere's box, 0.2 wider);
  - NOVEL: + the gen camera, ``target_vertices`` (``n_vertices`` points on
    the sphere's surface) and zero expression offsets (a same-expression
    pair);
  - NOVEL_PE: NOVEL + smooth 3-channel positional-encoding maps.
"""

from __future__ import annotations

import numpy as np

from diner_tpu_torch.data.synthetic import _look_at, make_sphere_scene

znear = 0.8
zfar = 2.4

_RADIUS = 0.5  # synthetic.py _render_sphere default
MODELS = ("DINER", "KeypointNeRF", "NOVEL", "NOVEL_PE")


class SphereDataset:
    znear = 0.8
    zfar = 2.4

    def __init__(self, stage: str = "train", n: int = 64, H: int = 32,
                 W: int = 32, nv: int = 2, model: str = "DINER",
                 n_kpt: int = 8, n_vertices: int = 128, **_):
        if model not in MODELS:
            raise NotImplementedError(
                f"SphereDataset: no {model} schema (the schemas are "
                f"{', '.join(MODELS)})")
        self.stage = stage
        self.n = n
        self.H, self.W, self.nv = H, W, nv
        self.model = model
        self.n_kpt = n_kpt
        self.n_vertices = n_vertices
        self._angles = np.linspace(0.1, 2 * np.pi - 0.1, n) + \
            (0.05 if stage == "val" else 0.0)

    def __len__(self):
        return self.n

    def __getitem__(self, idx: int):
        batch = make_sphere_scene(H=self.H, W=self.W, nv=self.nv,
                                  target_angle=float(self._angles[idx]))
        sample = {k: np.asarray(v)[0] for k, v in batch.items()}
        sample["sample_name"] = f"sphere-{self.stage}-{idx:04d}"
        sample.pop("znear")
        sample.pop("zfar")
        seed = idx + (100_000 if self.stage == "val" else 0)
        if self.model == "KeypointNeRF":
            sample["src_alphas"] = (
                sample["src_depths"] > 0).astype(np.float32)
            sample["target_mask"] = sample["target_alpha"][..., 0]
            sample["target_kpt3d"] = self._surface_points(self.n_kpt, seed)
            r = _RADIUS + 0.2
            sample["bounds"] = np.stack(
                [np.full(3, -r), np.full(3, r)]).astype(np.float32)
        elif self.model in ("NOVEL", "NOVEL_PE"):
            sample["gen_extrinsics"] = _look_at(
                np.array([0.0, 0.35, -1.6])).astype(np.float32)
            sample["gen_intrinsics"] = sample["target_intrinsics"]
            verts = self._surface_points(self.n_vertices, seed)
            sample["target_vertices"] = verts
            sample["offset_target_to_source"] = np.zeros_like(verts)
            sample["offset_target_to_gen"] = np.zeros_like(verts)
            if self.model == "NOVEL_PE":
                sample["src_pos_encodings"] = np.stack(
                    [self._pe_map(self.H, self.W, 0.5 * v)
                     for v in range(self.nv)])
                sample["target_pos_encoding"] = self._pe_map(
                    self.H, self.W, float(self._angles[idx]))
        return sample

    @staticmethod
    def _surface_points(n: int, seed: int) -> np.ndarray:
        rng = np.random.RandomState(seed)
        d = rng.randn(n, 3)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return (_RADIUS * d).astype(np.float32)

    @staticmethod
    def _pe_map(H: int, W: int, phase: float) -> np.ndarray:
        """A smooth deterministic 3-channel PE stamp (the reference loads
        NOVEL_PE's maps from disk; any fixed smooth signal drives the same
        lookup)."""
        y, x = np.meshgrid(np.linspace(-1, 1, H), np.linspace(-1, 1, W),
                           indexing="ij")
        return np.stack([np.sin(3 * x + phase), np.cos(3 * y - phase),
                         np.sin(2 * (x + y))], -1).astype(np.float32)

    def get_cam_sweep_extrinsics(self, nframes: int, scan_idx=None, **_):
        """(nframes, 4, 4) world-to-camera extrinsics on a circle of radius
        1.6 at height 0.25, looking at the sphere."""
        angles = np.linspace(0, 2 * np.pi, nframes, endpoint=False)
        extr = [_look_at(np.array([1.6 * np.sin(a), 0.25,
                                   -1.6 * np.cos(a)])) for a in angles]
        return np.stack(extr)
