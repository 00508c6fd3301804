"""Map-style dataset over analytic sphere scenes (for tests and training
runs without any data on disk). Each index varies the target camera angle.

Port of ``diner_tpu/data/synthetic_dataset.py:SphereDataset`` on the port's
``data/synthetic.py``, with the DINER batch schema (images, depths and
cameras). The KeypointNeRF and NOVEL schemas wait for those models.
"""

from __future__ import annotations

import numpy as np

from diner_tpu_torch.data.synthetic import make_sphere_scene

znear = 0.8
zfar = 2.4


class SphereDataset:
    znear = 0.8
    zfar = 2.4

    def __init__(self, stage: str = "train", n: int = 64, H: int = 32,
                 W: int = 32, nv: int = 2, model: str = "DINER", **_):
        if model != "DINER":
            raise NotImplementedError(
                f"SphereDataset: the {model} schema is not yet ported "
                "(only DINER)")
        self.stage = stage
        self.n = n
        self.H, self.W, self.nv = H, W, nv
        self.model = model
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
        return sample
