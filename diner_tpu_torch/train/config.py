"""YAML config system with an explicit registry.

Port of ``diner_tpu/train/config.py``: it reads the same ``configs/*.yaml``
(schema logger / data / nerf / renderer / optimizer / trainer /
checkpointing) into the port's ``DinerConfig`` with the same defaults and
the same znear / zfar rules. The dataset registry is keyed by both the
port's names and the reference's module paths
(``src/util/import_helper.py:16-24``). It registers what the port has,
``dtu``, ``facescape``, ``facescape_novel``, ``facescape_regressor`` and
``synthetic_sphere``; MultiFace raises a ``KeyError`` that names it as not
yet ported. ``build_renderer_config`` also reads ``composite_impl``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import yaml

from diner_tpu_torch.models.pixelnerf import PixelNeRFConfig
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train.diner import DinerConfig

# ------------------------------------------------------------- registries

DATASET_REGISTRY: Dict[str, Callable] = {}


def register_dataset(*names):
    def deco(fn):
        for n in names:
            DATASET_REGISTRY[n] = fn
        return fn
    return deco


@register_dataset("dtu", "src.data.dtu.DTUDataSet")
def _build_dtu(stage: str, model: str = "DINER", **kwargs):
    # DTU has one schema for every model
    from diner_tpu_torch.data.dtu import DTUDataset
    return DTUDataset(stage=stage, **kwargs)


@register_dataset("facescape", "src.data.facescape.FacescapeDataSet")
def _build_facescape(stage: str, model: str = "DINER", **kwargs):
    from diner_tpu_torch.data.facescape import FacescapeDataset
    return FacescapeDataset(stage=stage, model=model, **kwargs)


@register_dataset("facescape_novel",
                  "src.data.facescape_novel.FacescapeDataSet")
def _build_facescape_novel(stage: str, model: str = "NOVEL", **kwargs):
    from diner_tpu_torch.data.facescape_novel import FacescapeNovelDataset
    return FacescapeNovelDataset(stage=stage, model=model, **kwargs)


@register_dataset("facescape_regressor",
                  "src.data.facescape_regressor.FacescapeDataSet")
def _build_facescape_regressor(stage: str, model: str = "DINER", **kwargs):
    # one schema for every model
    from diner_tpu_torch.data.facescape_regressor import (
        FacescapeRegressorDataset)
    return FacescapeRegressorDataset(stage=stage, **kwargs)


@register_dataset("multiface", "src.data.multiface.MultiFaceDataset")
def _build_multiface(stage: str, model: str = "DINER", **kwargs):
    from diner_tpu_torch.data.multiface import MultifaceDataset
    return MultifaceDataset(stage=stage, model=model, **kwargs)


@register_dataset("synthetic_sphere")
def _build_synth(stage: str, model: str = "DINER", **kwargs):
    from diner_tpu_torch.data.synthetic_dataset import SphereDataset
    return SphereDataset(stage=stage, model=model, **kwargs)


def build_dataset(conf: dict, stage: str, model: str = "DINER"):
    module = conf["module"]
    if module not in DATASET_REGISTRY:
        raise KeyError(f"unknown dataset {module!r}; known: "
                       f"{sorted(DATASET_REGISTRY)}")
    return DATASET_REGISTRY[module](stage=stage, model=model,
                                    **conf.get("kwargs", {}))


# --------------------------------------------------------- model configs

_ENCODER_ALIASES = {"src.models.image_encoder.SpatialEncoder", "spatial",
                    "diner_tpu.spatial_encoder"}
_NERF_ALIASES = {"src.models.pixelnerf.PixelNeRF", "pixelnerf",
                 "diner_tpu.pixelnerf"}
_MLP_ALIASES = {"src.models.resnetfc.ResnetFC", "resnetfc"}
_RENDERER_ALIASES = {"src.models.nerf_renderer.NeRFRendererDGS", "dgs",
                     "diner_tpu.renderer_dgs"}


def build_pixelnerf_config(nerf_conf: dict) -> PixelNeRFConfig:
    module = nerf_conf.get("module", "pixelnerf")
    if module not in _NERF_ALIASES:
        raise KeyError(f"unknown nerf module {module!r}")
    kw = nerf_conf.get("kwargs", {})

    enc = kw.get("encoder_conf", {})
    if enc.get("module", "spatial") not in _ENCODER_ALIASES:
        raise KeyError(f"unknown encoder {enc.get('module')!r}")
    ekw = dict(enc.get("kwargs", {}))
    ekw.pop("index_interp", None)  # fixed: bilinear (the only mode used)
    ekw.pop("index_padding", None)
    ekw.pop("upsample_interp", None)
    ekw.pop("pretrained", None)
    encoder = SpatialEncoderConfig(
        backbone=ekw.pop("backbone", "resnet34"),
        num_layers=ekw.pop("num_layers", 4),
        use_first_pool=ekw.pop("use_first_pool", True),
        image_padding=ekw.pop("image_padding", 0),
        padding_pe=ekw.pop("padding_pe", -1),
    )
    assert not ekw, f"unused encoder kwargs: {ekw}"

    pos = kw.get("poscode_conf", {}).get("kwargs", {})
    mlp = kw.get("mlp_fine_conf", {})
    if mlp.get("module", "resnetfc") not in _MLP_ALIASES:
        raise KeyError(f"unknown mlp module {mlp.get('module')!r}")
    mkw = mlp.get("kwargs", {})
    if mkw.get("combine_type", "average") != "average":
        raise NotImplementedError("only average view fusion (as reference)")

    return PixelNeRFConfig(
        num_freqs=pos.get("num_freqs", 6),
        freq_factor=pos.get("freq_factor", 6.28),
        include_input=pos.get("include_input", True),
        encoder=encoder,
        n_blocks=mkw.get("n_blocks", 5),
        d_hidden=mkw.get("d_hidden", 512),
        combine_layer=mkw.get("combine_layer", 3),
        mlp_beta=mkw.get("beta", 0.0),
        compute_dtype=kw.get("compute_dtype", "float32"),
    )


def build_renderer_config(rend_conf: dict) -> RendererConfig:
    module = rend_conf.get("module", "dgs")
    if module not in _RENDERER_ALIASES:
        raise KeyError(f"unknown renderer module {module!r}")
    kw = dict(rend_conf.get("kwargs", {}))
    kw.pop("eval_batch_size", None)  # superseded by ray_chunk
    return RendererConfig(
        n_samples=kw.pop("n_samples", 40),
        n_depth_candidates=kw.pop("n_depth_candidates", 1000),
        n_gaussian=kw.pop("n_gaussian", 15),
        white_bkgd=kw.pop("white_bkgd", True),
        depth_diff_max=kw.pop("depth_diff_max", 0.05),
        ray_chunk=kw.pop("ray_chunk", 4096),
        n_coarse_candidates=kw.pop("n_coarse_candidates", 0),
        n_refine_bins=kw.pop("n_refine_bins", 16),
        composite_impl=kw.pop("composite_impl", "xla"),
    )


@dataclass
class TrainRunConfig:
    diner: DinerConfig
    raw: dict
    save_dir: str = "outputs/run"
    version: str = "default"
    model_name: str = "DINER"
    val_check_interval: int = 30000
    limit_val_batches: int = 10
    max_steps: int = -1
    max_epochs: int = -1
    log_every_n_steps: int = 1000
    ckpt_every_n_steps: int = 10000
    ckpt_path: Optional[str] = None
    n_samples_score_eval: int = 100
    cam_sweep_settings: dict = field(default_factory=dict)

    @property
    def run_dir(self) -> Path:
        return Path(self.save_dir) / self.version

    def build_dataset(self, stage: str):
        return build_dataset(self.raw["data"][stage]["dataset"], stage,
                             self.model_name)

    def dataloader_kwargs(self, stage: str) -> dict:
        kw = dict(self.raw["data"][stage].get("dataloader", {})
                  .get("kwargs", {}))
        kw.pop("num_workers", None)
        return kw


def load_train_config(path, model_name: str = "DINER") -> TrainRunConfig:
    with open(path) as f:
        raw = yaml.safe_load(f)

    opt = raw.get("optimizer", raw.get("optimizer_diner", {})).get("kwargs", {})
    znear = raw.get("znear", opt.get("znear"))
    zfar = raw.get("zfar", opt.get("zfar"))
    # znear/zfar default from the dataset class when not in the YAML
    if znear is None or zfar is None:
        ds_module = raw["data"]["train"]["dataset"]["module"]
        if "dtu" in ds_module.lower():
            from diner_tpu_torch.data.dtu import DTU_SCALE_FACTOR
            znear, zfar = 400 * DTU_SCALE_FACTOR, 1500 * DTU_SCALE_FACTOR
        elif "facescape" in ds_module.lower():
            znear, zfar = 1.0, 2.5
        elif "multiface" in ds_module.lower():
            znear, zfar = 0.5, 1.5
        else:
            znear, zfar = 0.8, 2.4

    diner = DinerConfig(
        nerf=build_pixelnerf_config(raw["nerf"]),
        renderer=build_renderer_config(raw["renderer"]),
        znear=float(znear),
        zfar=float(zfar),
        ray_batch_size=opt.get("ray_batch_size", 128),
        lr=float(opt.get("lr", 1e-4)),
        w_vgg=float(opt.get("w_vgg", 0.0)),
        vgg_spatch=int(opt.get("vgg_spatch", 64)),
        w_antibias=float(opt.get("w_antibias", 0.0)),
        antibias_downsampling=int(opt.get("antibias_downsampling", 3)),
    )

    logger = raw.get("logger", {}).get("kwargs", {})
    trainer = raw.get("trainer", {}).get("kwargs", {})
    ckpt = raw.get("checkpointing", {}).get("kwargs", {})
    return TrainRunConfig(
        diner=diner,
        raw=raw,
        save_dir=logger.get("save_dir", "outputs/run"),
        version=logger.get("version", "default"),
        model_name=model_name,
        val_check_interval=trainer.get("val_check_interval", 30000),
        limit_val_batches=trainer.get("limit_val_batches", 10),
        max_steps=trainer.get("max_steps", -1),
        max_epochs=trainer.get("max_epochs", -1),
        log_every_n_steps=trainer.get("log_every_n_steps", 1000),
        ckpt_every_n_steps=ckpt.get("every_n_train_steps", 10000),
        ckpt_path=raw.get("trainer", {}).get("ckpt_path"),
        n_samples_score_eval=opt.get("n_samples_score_eval", 100),
        cam_sweep_settings=opt.get("cam_sweep_settings", {}),
    )
