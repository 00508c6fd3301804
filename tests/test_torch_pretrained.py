"""The port's pretrained-weights path against the JAX package's.

The official weights are not on this machine, so every test fabricates
torch-format state dicts with the torchvision / lpips key schemas, as
``tests/test_pretrained.py`` does. Both converters (the JAX package's
``scripts/import_pretrained.py`` and ``python -m
diner_tpu_torch.import_pretrained``) must write equal ``.npz`` trees; with
``DINER_TPU_PRETRAINED`` pointing at them, the port's three consumers must
agree with the JAX package's: the ResNet34 graft exactly, the VGG19 loss
within 1e-5 relative and LPIPS within 1e-5 (convolutions summed in another
order). With the directory empty every result is bit for bit what the
seeded substitutes give.
"""

import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.evaluation.metrics import LPIPS_CHANNELS, _VGG16_CONVS
from diner_tpu.losses.vgg import _VGG19_CONVS
from diner_tpu.losses.vgg import vgg_loss as j_vgg_loss
from diner_tpu.models.pixelnerf import PixelNeRF as JPixelNeRF
from diner_tpu.models.pixelnerf import PixelNeRFConfig as JPixelNeRFConfig
from diner_tpu.nn.spatial_encoder import SpatialEncoderConfig as JEncCfg
from diner_tpu.utils import pretrained as JP
from diner_tpu_torch.data.synthetic import make_sphere_scene
from diner_tpu_torch.evaluation import suite
from diner_tpu_torch.import_pretrained import main as import_main
from diner_tpu_torch.losses import init_vgg19, vgg_loss
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train.diner import DinerConfig, create_model
from diner_tpu_torch.utils import pretrained as P
from diner_tpu_torch.utils.convert import flax_to_state_dict

ENC = dict(backbone="resnet34", num_layers=4, image_padding=8, padding_pe=4)
SRC = ("src_rgbs", "src_depths", "src_depth_stds", "src_extrinsics",
       "src_intrinsics")
PTH = ("resnet34-b627a593.pth", "vgg19-dcbb9e9d.pth", "vgg16-397923af.pth",
       "lpips_vgg_v0.1.pth")


def _conv_sd(convs, seed):
    """torchvision ``features.*`` state dict of a VGG conv stack."""
    rng = np.random.RandomState(seed)
    sd, c_in = {}, 3
    for idx, ch in convs:
        sd[f"features.{idx}.weight"] = torch.from_numpy(
            rng.randn(ch, c_in, 3, 3).astype(np.float32) * 0.05)
        sd[f"features.{idx}.bias"] = torch.from_numpy(
            rng.randn(ch).astype(np.float32) * 0.01)
        c_in = ch
    return sd


def write_pth(wdir):
    """The four release files, seeded, in their schemas."""
    from tests.ref_shims import _ResNet
    torch.manual_seed(0)
    resnet = _ResNet((3, 4, 6, 3))
    with torch.no_grad():  # running statistics that are not the defaults
        for m in resnet.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    torch.save(resnet.state_dict(), wdir / PTH[0])
    torch.save(_conv_sd(_VGG19_CONVS, 0), wdir / PTH[1])
    torch.save(_conv_sd(_VGG16_CONVS, 1), wdir / PTH[2])
    rng = np.random.RandomState(2)
    torch.save({f"lins.{i}.model.1.weight": torch.from_numpy(
        np.abs(rng.randn(1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(LPIPS_CHANNELS)}, wdir / PTH[3])


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(port's weights dir, JAX script's weights dir), each with the four
    .pth files and the trees its converter wrote from them."""
    ours = tmp_path_factory.mktemp("port_weights")
    write_pth(ours)
    theirs = tmp_path_factory.mktemp("jax_weights")
    for name in PTH:
        shutil.copy(ours / name, theirs / name)
    got = import_main(["--weights-dir", str(ours)])
    from scripts.import_pretrained import main as j_import_main
    want = j_import_main(["--weights-dir", str(theirs)])
    assert got == want == [P.RESNET34_NPZ, P.VGG19_NPZ, P.LPIPS_NPZ]
    return ours, theirs


@pytest.fixture
def weights_dir(converted, monkeypatch):
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(converted[0]))
    return converted[0]


@pytest.fixture
def empty_dir(tmp_path, monkeypatch):
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path))
    return tmp_path


def test_converters_write_the_jax_scripts_trees(converted):
    ours, theirs = converted
    for name in (P.RESNET34_NPZ, P.VGG19_NPZ, P.LPIPS_NPZ):
        a, b = np.load(ours / name), np.load(theirs / name)
        assert sorted(a.files) == sorted(b.files), name
        for k in a.files:
            assert a[k].dtype == b[k].dtype, (name, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_npz_trees_read_across_packages(tmp_path):
    tree = {"a": {"b": np.arange(6.0).reshape(2, 3)},
            "lins": (np.ones(3, np.float32), np.zeros(2, np.float32))}
    P.save_tree_npz(tmp_path / "port.npz", tree)
    JP.save_tree_npz(tmp_path / "jax.npz", tree)
    for path in ("port.npz", "jax.npz"):
        for load in (P.load_tree_npz, JP.load_tree_npz):
            back = load(tmp_path / path)
            np.testing.assert_array_equal(back["a"]["b"], tree["a"]["b"])
            assert isinstance(back["lins"], tuple) and len(back["lins"]) == 2


def test_pretrained_dir_is_the_jax_packages(monkeypatch, tmp_path):
    monkeypatch.delenv("DINER_TPU_PRETRAINED", raising=False)
    assert P.pretrained_dir() == JP.pretrained_dir()
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path))
    assert P.pretrained_dir() == JP.pretrained_dir() == tmp_path


def _small_batch():
    return make_sphere_scene(H=32, W=40, nv=2)


def _jax_variables(batch):
    jm = JPixelNeRF(cfg=JPixelNeRFConfig(encoder=JEncCfg(**ENC), d_hidden=32))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(3),
                                 *(jnp.asarray(batch[k]) for k in SRC),
                                 jnp.zeros((1, 8, 3)), jnp.zeros((1, 8, 3)))
    return jax.tree_util.tree_map(np.asarray, variables)


def test_graft_matches_jax(weights_dir):
    variables = _jax_variables(_small_batch())
    model = PixelNeRF(PixelNeRFConfig(encoder=SpatialEncoderConfig(**ENC),
                                      d_hidden=32))
    model.load_state_dict(flax_to_state_dict(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    P.graft_resnet34(model, P.load_resnet34_variables())
    want = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, JP.graft_resnet34(variables,
                                      JP.load_resnet34_variables())))
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    # the ImageNet RGB slice in conv1's first 3 input channels, the PE
    # stamp's channels as drawn, the running statistics replaced
    sd = torch.load(weights_dir / PTH[0], weights_only=True)
    conv1 = got["encoder.resnet.conv1.weight"]
    assert conv1.shape[1] > 3
    assert torch.equal(conv1[:, :3], sd["conv1.weight"])
    assert torch.equal(conv1[:, 3:], before["encoder.resnet.conv1.weight"][:, 3:])
    assert torch.equal(got["encoder.resnet.bn1.running_var"],
                       sd["bn1.running_var"])
    assert torch.equal(got["encoder.resnet.layer3_5.bn2.running_mean"],
                       sd["layer3.5.bn2.running_mean"])
    assert torch.equal(got["mlp.lin_in.weight"], before["mlp.lin_in.weight"])


def _diner_cfg(backbone="resnet34"):
    return DinerConfig(
        nerf=PixelNeRFConfig(encoder=SpatialEncoderConfig(
            **dict(ENC, backbone=backbone)), d_hidden=32),
        renderer=RendererConfig(n_samples=8, n_depth_candidates=64,
                                n_gaussian=3))


def test_create_model_grafts_only_resnet34(weights_dir, monkeypatch):
    batch = _small_batch()
    grafted = create_model(_diner_cfg(), batch, device="cpu").state_dict()
    sd = torch.load(weights_dir / PTH[0], weights_only=True)
    assert torch.equal(grafted["encoder.resnet.conv1.weight"][:, :3],
                       sd["conv1.weight"])
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(weights_dir / "none"))
    fresh = create_model(_diner_cfg(), batch, device="cpu").state_dict()
    # the graft comes after the reroll: everything outside the ResNet and
    # conv1's PE channels are the seeded draw's
    for k, v in fresh.items():
        if k == "encoder.resnet.conv1.weight":
            assert torch.equal(grafted[k][:, 3:], v[:, 3:])
            assert not torch.equal(grafted[k][:, :3], v[:, :3])
        elif not k.startswith("encoder.resnet."):
            assert torch.equal(grafted[k], v), k
    # a ResNet18 encoder is not grafted
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(weights_dir))
    r18 = create_model(_diner_cfg("resnet18"), batch, device="cpu")
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(weights_dir / "none"))
    r18_fresh = create_model(_diner_cfg("resnet18"), batch, device="cpu")
    for k, v in r18.state_dict().items():
        assert torch.equal(v, r18_fresh.state_dict()[k]), k


def test_create_model_without_weights_is_the_seeded_draw(empty_dir):
    """The model is the first draw from torch.Generator(0), as before the
    weights path existed (this init is alive, so no reroll)."""
    cfg = _diner_cfg()
    model = create_model(cfg, _small_batch(), seed=0, device="cpu")
    ref = PixelNeRF(cfg.nerf)
    ref.reset_parameters(torch.Generator().manual_seed(0))
    for k, v in ref.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k


def _vgg_pair():
    rng = np.random.RandomState(4)
    return (rng.rand(2, 32, 32, 3).astype(np.float32),
            rng.rand(2, 32, 32, 3).astype(np.float32))


def test_vgg19_loss_with_loaded_net_matches_jax(weights_dir):
    vgg = P.load_vgg19(device="cpu")
    params = JP.load_vgg19_loss_params()
    sd = torch.load(weights_dir / PTH[1], weights_only=True)
    assert torch.equal(vgg.conv_19.weight, sd["features.19.weight"])
    a, b = _vgg_pair()
    got = float(vgg_loss(vgg, torch.from_numpy(a), torch.from_numpy(b)))
    want = float(j_vgg_loss(params, jnp.asarray(a), jnp.asarray(b)))
    assert abs(got - want) <= 1e-5 * abs(want)


def _trainer_vgg(tmp_path, monkeypatch):
    """The VGG19 the trainer's ``_init_state`` picks for a w_vgg > 0
    config (train_synthetic at 24×24 with the VGG loss on)."""
    import yaml

    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.loop import Trainer, arrays_of
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    raw = yaml.safe_load(open("configs/train_synthetic.yaml"))
    raw["logger"]["kwargs"]["save_dir"] = str(tmp_path / "out")
    for stage, n in (("train", 2), ("val", 1)):
        raw["data"][stage]["dataset"]["kwargs"].update(n=n, H=24, W=24)
    raw["optimizer"]["kwargs"].update(w_vgg=0.1, vgg_spatch=8)
    tmp_path.mkdir()
    p = tmp_path / "cfg.yaml"
    p.write_text(yaml.safe_dump(raw))
    trainer = Trainer(load_train_config(p), num_workers=0, device="cpu")
    example = next(iter(trainer.train_loader))
    return trainer._init_state(arrays_of(example)).vgg


def test_trainer_loads_vgg19_or_falls_back(weights_dir, tmp_path,
                                           monkeypatch):
    loaded = _trainer_vgg(tmp_path / "a", monkeypatch)
    want = P.load_vgg19(device="cpu").state_dict()
    for k, v in loaded.state_dict().items():
        assert torch.equal(v, want[k]), k
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path / "none"))
    seeded = _trainer_vgg(tmp_path / "b", monkeypatch)
    for k, v in init_vgg19(0, device="cpu").state_dict().items():
        assert torch.equal(seeded.state_dict()[k], v), k


def _folder(vis):
    from PIL import Image
    rng = np.random.RandomState(5)
    vis.mkdir(parents=True)
    for i in range(2):
        gt = (rng.rand(20, 24, 3) * 255).astype(np.uint8)
        Image.fromarray(gt).save(vis / f"s{i}{suite.GT_SUFFIX}")
        Image.fromarray(255 - gt).save(vis / f"s{i}{suite.PRED_SUFFIX}")
    return vis


def test_evaluate_folder_auto_reports_lpips_as_jax(weights_dir, tmp_path):
    from diner_tpu.evaluation.suite import evaluate_folder as j_evaluate
    vis = _folder(tmp_path / "vis")
    got = suite.evaluate_folder(vis, tmp_path / "ours", device="cpu")
    want = j_evaluate(vis, tmp_path / "jax")
    assert "lpips" in got and "lpips_proxy" not in got
    assert set(got) == set(want)
    assert abs(got["lpips"] - want["lpips"]) <= 1e-5
    for k in ("ssim", "psnr", "l1", "l2"):
        assert got[k] == want[k], k
    # the module utils/pretrained.py loads is taken as well
    lp = P.load_lpips(device="cpu")
    assert isinstance(P.lpips_params_or_proxy(device="cpu"), type(lp))
    loaded = suite.evaluate_folder(vis, tmp_path / "loaded", device="cpu",
                                   lpips_params=lp)
    assert loaded == got


def test_evaluate_folder_auto_without_weights_is_the_proxy(empty_dir,
                                                           tmp_path):
    vis = _folder(tmp_path / "vis")
    auto = suite.evaluate_folder(vis, tmp_path / "auto", device="cpu")
    proxy = suite.evaluate_folder(vis, tmp_path / "proxy", device="cpu",
                                  lpips_params="proxy")
    assert "lpips_proxy" in auto and auto == proxy
    assert P.load_vgg19(device="cpu") is None
    assert P.load_lpips(device="cpu") is None
    assert P.lpips_params_or_proxy() == "proxy"
