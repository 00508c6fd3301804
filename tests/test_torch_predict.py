"""The port's inference entry points against the JAX package's: the
reference-checkpoint bridge, ``python -m diner_tpu_torch.predict`` (from a
Lightning ``.ckpt`` and from a port checkpoint), its ``--nsamples``
override, ``python -m diner_tpu_torch.evaluate`` and the train CLI's
``--debug-nans``.

The bridge copies tensors, so it must equal the JAX package's
``convert_pixelnerf`` followed by ``flax_to_state_dict`` exactly. The
evaluate CLI's scores must equal JAX's ``evaluate_folder`` (PSNR, SSIM, L1,
L2 the same numpy code) and its LPIPS proxy within 1e-5 (convolutions
summed in another order). The predict CLI runs at 24×24 on
``configs/train_synthetic.yaml`` on the CPU.
"""

import dataclasses
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from diner_tpu.train.config import load_train_config as j_load_train_config
from diner_tpu.utils.torch_convert import convert_pixelnerf
from diner_tpu_torch.evaluate import main as evaluate_main
from diner_tpu_torch.evaluation import suite
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.predict import (checkpoint_state_dict, main as
                                     predict_main, override_config)
from diner_tpu_torch.train import checkpoint as ckpt_lib
from diner_tpu_torch.train.config import load_train_config
from diner_tpu_torch.train.diner import create_model, make_train_step
from diner_tpu_torch.utils.convert import (flax_to_state_dict,
                                           reference_to_state_dict)
from tests.torch_refs import TorchResnetFC, TorchSpatialEncoder

ROOT = Path(__file__).resolve().parents[1]
SUFFIXES = ("-pred.png", "-gt.png", "-ref.png", "-depth.png")


def lightning_blob(d_hidden, blocks=(2, 2, 2, 2), seed=0):
    """A reference DINER's Lightning ``state_dict`` (``nerf.encoder.*``,
    ``nerf.mlp_fine.*``, the positional encodings' buffers and the
    BatchNorms' ``num_batches_tracked``) from the torch re-statements, with
    random BN statistics, non-zero ``fc_1`` weights, and a torchvision
    ``fc`` head and ``layer4`` stage that the truncated encoder drops."""
    torch.manual_seed(seed)
    enc = TorchSpatialEncoder(image_padding=8, padding_pe=4, num_layers=4,
                              blocks=blocks)
    cfg = PixelNeRFConfig(encoder=SpatialEncoderConfig(
        backbone="resnet18", image_padding=8, padding_pe=4),
        d_hidden=d_hidden)
    mlp = TorchResnetFC(cfg.d_in, 4, 5, cfg.d_latent, d_hidden,
                        combine_layer=3)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.uniform_(-0.1, 0.1)
        for blk in mlp.blocks:
            blk.fc_1.weight.normal_(0, 0.01)
    sd = {f"nerf.encoder.{k}": v for k, v in enc.state_dict().items()}
    sd.update({f"nerf.mlp_fine.{k}": v for k, v in mlp.state_dict().items()})
    sd["nerf.code._freqs"] = torch.ones(1, 12, 1)
    sd["nerf.encoder.model.fc.weight"] = torch.zeros(1000, 512)
    sd["nerf.encoder.model.layer4.0.conv1.weight"] = torch.zeros(512, 256, 3,
                                                                 3)
    sd["vgg_loss.net.0.weight"] = torch.zeros(64, 3, 3, 3)
    return {"state_dict": sd, "epoch": 3, "global_step": 1000}, cfg


def test_reference_bridge_matches_jax_convert_pixelnerf():
    blob, cfg = lightning_blob(d_hidden=32)
    template = PixelNeRF(cfg).state_dict()
    got = reference_to_state_dict(blob, template)
    stripped = {k[len("nerf."):]: v.numpy()
                for k, v in blob["state_dict"].items()
                if k.startswith("nerf.")}
    want = flax_to_state_dict(convert_pixelnerf(
        stripped, n_blocks=5, combine_layer=3, num_layers=4,
        backbone_blocks=(2, 2, 2, 2)))
    assert sorted(got) == sorted(want) == sorted(template)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], v), k
    # a bare PixelNeRF state dict (no prefix) maps the same
    bare = reference_to_state_dict(
        {k[len("nerf."):]: v for k, v in blob["state_dict"].items()},
        template, prefix="")
    assert all(torch.equal(bare[k], v) for k, v in got.items())


def test_reference_bridge_names_what_does_not_fit():
    blob, cfg = lightning_blob(d_hidden=32)
    template = PixelNeRF(cfg).state_dict()
    sd = dict(blob["state_dict"])
    extra = dict(sd, **{"nerf.mlp_fine.lin_q.weight": torch.zeros(1)})
    with pytest.raises(KeyError, match="nerf.mlp_fine.lin_q.weight"):
        reference_to_state_dict(extra, template)
    wide = PixelNeRF(dataclasses.replace(cfg, d_hidden=48)).state_dict()
    with pytest.raises(ValueError, match="nerf.mlp_fine.lin_in.weight"):
        reference_to_state_dict(sd, wide)
    short = {k: v for k, v in sd.items() if "blocks.4.fc_1" not in k}
    with pytest.raises(KeyError, match="mlp.block_4.fc_1"):
        reference_to_state_dict(short, template)
    with pytest.raises(KeyError, match="prefix"):
        reference_to_state_dict(sd, template, prefix="model.")


def _cfg(tmp_path):
    """configs/train_synthetic.yaml at 24×24, 2 validation scenes."""
    raw = yaml.safe_load((ROOT / "configs/train_synthetic.yaml").read_text())
    raw["logger"]["kwargs"]["save_dir"] = str(tmp_path / "runs")
    raw["data"]["train"]["dataset"]["kwargs"].update(n=2, H=24, W=24)
    raw["data"]["val"]["dataset"]["kwargs"].update(n=3, H=24, W=24)
    raw["renderer"]["kwargs"].update(n_samples=8, n_depth_candidates=32,
                                     n_gaussian=2, ray_chunk=192)
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p


def _predict(cfgp, ckpt, out, *extra):
    return predict_main(["--config", str(cfgp), "--ckpt", str(ckpt),
                         "--out", str(out), "--n", "2", "--device", "cpu",
                         *extra])


def _check_folder(out, scores):
    names = sorted(p.name for p in out.iterdir() if p.suffix == ".png"
                   and p.name != suite.EXAMPLE_PLOT_FILENAME)
    stems = sorted({n.rsplit("-", 1)[0] for n in names})
    assert len(stems) == 2
    assert names == sorted(s + x for s in stems for x in SUFFIXES)
    assert set(scores) == {"ssim", "psnr", "l1", "l2", "lpips_proxy"}
    assert all(math.isfinite(v) for v in scores.values())
    assert json.loads((out / suite.AVERAGE_SCORE_FILENAME).read_text()
                      )["psnr"] == scores["psnr"]


def test_predict_cli_from_lightning_and_port_checkpoints(tmp_path,
                                                         monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path / "none"))
    cfgp = _cfg(tmp_path)
    dcfg = load_train_config(cfgp).diner

    blob, _ = lightning_blob(d_hidden=dcfg.nerf.d_hidden)
    lightning = tmp_path / "DINER.ckpt"
    torch.save(blob, lightning)
    model = PixelNeRF(dcfg.nerf)
    loaded = checkpoint_state_dict(lightning, model)
    sd = blob["state_dict"]
    assert torch.equal(loaded["encoder.resnet.layer2_0.downsample_conv"
                              ".weight"],
                       sd["nerf.encoder.model.layer2.0.downsample.0.weight"])
    assert torch.equal(loaded["mlp.lin_z_2.weight"],
                       sd["nerf.mlp_fine.lin_z.2.weight"])
    out = tmp_path / "from_lightning"
    lightning_scores = _predict(cfgp, lightning, out)
    _check_folder(out, lightning_scores)
    # a bare PixelNeRF state dict, read with --prefix ""
    bare = tmp_path / "pixelnerf.pt"
    torch.save({k[len("nerf."):]: v for k, v in sd.items()
                if k.startswith("nerf.")}, bare)
    got = checkpoint_state_dict(bare, model, prefix="")
    assert all(torch.equal(got[k], v) for k, v in loaded.items())
    out = tmp_path / "from_bare"
    assert _predict(cfgp, bare, out, "--prefix", "") == lightning_scores

    # a port checkpoint: a train step's state saved by train/checkpoint.py
    from diner_tpu_torch.data.synthetic_dataset import SphereDataset
    sample = SphereDataset("val", n=1, H=24, W=24)[0]
    batch = {k: v[None] for k, v in sample.items()
             if isinstance(v, np.ndarray)}
    trained = create_model(dcfg, batch, seed=5, device="cpu")
    path = ckpt_lib.save_checkpoint(tmp_path / "ckpts",
                                    make_train_step(trained, dcfg), step=7)
    for ckpt in (path, Path(path) / "state.pt", tmp_path / "ckpts"):
        got = checkpoint_state_dict(ckpt, model)
        assert all(torch.equal(got[k], v)
                   for k, v in trained.state_dict().items())
    out = tmp_path / "from_port"
    port_scores = _predict(cfgp, path, out)
    _check_folder(out, port_scores)
    assert port_scores != lightning_scores


def test_predict_nsamples_matches_the_jax_script():
    path = ROOT / "configs" / "evaluate_diner_on_dtu.yaml"
    jcfg = j_load_train_config(path).diner
    # scripts/create_prediction_folder.py:50-60
    rend = jcfg.renderer
    scale = 32 / rend.n_samples
    rend = dataclasses.replace(rend, n_samples=32,
                               n_gaussian=int(rend.n_gaussian * scale))
    jcfg = dataclasses.replace(jcfg, renderer=rend, znear=0.5, zfar=3.0)
    got = override_config(load_train_config(path).diner, nsamples=32,
                          znear=0.5, zfar=3.0)
    assert dataclasses.asdict(got) == dataclasses.asdict(jcfg)
    assert (got.renderer.n_samples, got.renderer.n_gaussian) == (32, 12)
    same = load_train_config(path).diner
    assert override_config(same) == same


def test_evaluate_cli_matches_jax(tmp_path, monkeypatch, capsys):
    from PIL import Image

    from diner_tpu.evaluation.suite import evaluate_folder as j_evaluate
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path / "none"))
    rng = np.random.RandomState(9)
    vis = tmp_path / "vis"
    vis.mkdir()
    for i in range(3):
        gt = (rng.rand(20, 28, 3) * 255).astype(np.uint8)
        pred = np.clip(gt + rng.randn(20, 28, 3) * 12, 0, 255).astype(
            np.uint8)
        Image.fromarray(gt).save(vis / f"s{i}-gt.png")
        Image.fromarray(pred).save(vis / f"s{i}-pred.png")
    got = evaluate_main([str(vis), str(tmp_path / "ours"), "--device", "cpu"])
    assert str(got) in capsys.readouterr().out
    want = j_evaluate(vis, tmp_path / "jax")
    assert set(got) == set(want)
    for k in ("ssim", "psnr", "l1", "l2"):
        assert got[k] == want[k], k
    assert abs(got["lpips_proxy"] - want["lpips_proxy"]) <= 1e-5
    # without an outdir the reports go into the folder
    evaluate_main([str(vis), "--device", "cpu"])
    assert (vis / suite.AVERAGE_SCORE_FILENAME).exists()


@pytest.mark.parametrize("flag", [True, False])
def test_debug_nans_turns_on_anomaly_detection(tmp_path, monkeypatch, flag):
    from diner_tpu_torch.train import loop
    from diner_tpu_torch.train.__main__ import main as train_main
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    seen = []
    monkeypatch.setattr(loop.Trainer, "fit", lambda self, max_steps=None:
                        seen.append(torch.is_anomaly_enabled()))
    train_main([str(_cfg(tmp_path)), "--device", "cpu", "--max-steps", "1"]
               + (["--debug-nans"] if flag else []))
    assert seen == [flag]
    assert not torch.is_anomaly_enabled()
