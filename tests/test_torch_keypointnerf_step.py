"""Port parity for KeypointNeRF's training and full-image rendering
(``diner_tpu_torch/models/keypointnerf/train.py``), the sphere's
KeypointNeRF schema and ``python -m diner_tpu_torch.train <yaml>
KeypointNeRF``, against the JAX package on the CPU at the small
configuration of ``tests/test_torch_keypointnerf.py``.

One train step from the same numpy weights, the same VGG19 and the draws
JAX takes from the same key (the patch centre from ``k_patch``; the
stratified t, both passes' density noise, the fine uniforms and the view
dropout from ``k_render``). Tolerances, all f32: each loss term 1e-5
relative; every gradient within 1e-3 of its norm (a backward through the
encoders' norms, the MLPs, the colour head and the VGG19 sums in another
order), but for the parameters whose gradient is zero up to rounding
(``chip_smoke.KPN_ZERO_GRAD``: biases before an instance norm, an offset
the view softmax ignores, and ani_al, which 2 views make inert), held
below 1e-4 of the step's largest gradient norm in both packages; Adam's
first update (−lr·g / (|g| + ε)) within 1e-2 of lr on the components
whose JAX gradient is at least 1e-3 of the largest (their sign
is what the update reads). The full-image render: colour 1e-4 absolute,
depth 1e-4 relative on 99 % of the pixels and 5e-3 on all (where a ray
accumulates almost no alpha its depth is a ratio of two tiny sums, and
JAX's own renders of it differ that much); grouping 16 tiles a call
against 1 is exact.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from chip_smoke import KPN_ZERO_GRAD, KPN_ZERO_GRAD_TOL
from diner_tpu.data.synthetic_dataset import SphereDataset as JSphereDataset
from diner_tpu.losses.vgg import VGG19Features as JVGG19Features
from diner_tpu.models.keypointnerf.train import (
    KeypointNeRFTrainConfig as JTrainConfig,
    build_keypointnerf_run_config as j_build_run_config,
    compute_losses as j_compute_losses,
    get_360_cameras as j_get_360_cameras,
    render_full_image as j_render_full_image,
)
from diner_tpu.train.config import load_train_config as j_load_train_config
from diner_tpu_torch.data.facescape import FacescapeDataset
from diner_tpu_torch.data.synthetic_dataset import SphereDataset
from diner_tpu_torch.losses import VGG19Features
from diner_tpu_torch.models.keypointnerf.model import KeypointNeRFConfig
from diner_tpu_torch.models.keypointnerf.train import (
    BATCH_KEYS,
    KeypointNeRFTrainConfig,
    build_keypointnerf_run_config,
    create_keypointnerf_state,
    get_360_cameras,
    render_full_image,
)
from diner_tpu_torch.train import checkpoint as ckpt_lib
from diner_tpu_torch.train.__main__ import main as train_main
from diner_tpu_torch.train.config import load_train_config
from diner_tpu_torch.utils.convert import (flax_to_state_dict,
                                           keypointnerf_flax_to_state_dict)
from test_torch_facescape import tree  # noqa: F401
from test_torch_keypointnerf import (SMALL, draw_like,  # noqa: F401
                                     few_threads, jax_batch,
                                     jax_patch_center, jax_render_noise,
                                     model_pair, sphere_batch)

ROOT = Path(__file__).resolve().parents[1]
LAMBDAS = dict(lambda_l1_c=1.0, lambda_l1=10.0, lambda_vgg=0.5)


@pytest.fixture(scope="module")
def batch():
    return sphere_batch(seed=1)


@pytest.fixture(scope="module")
def pair(batch):
    return model_pair(batch, seed=3)


@pytest.fixture(scope="module")
def vgg_params():
    """VGG19 weights drawn with numpy onto the flax tree's shapes."""
    shapes = jax.eval_shape(lambda: JVGG19Features().init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 3))))
    return draw_like(shapes["params"], 7)


def _grad_close(g, jg, name, tol=1e-3):
    assert np.isfinite(g).all(), name
    np.testing.assert_allclose(g, jg, atol=tol * np.linalg.norm(jg) + 1e-9,
                               rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def j_step(batch, pair, vgg_params):
    """JAX's loss, gradients and first Adam update for a key (one
    compile for every key)."""
    jm, params, _ = pair
    jcfg = JTrainConfig(model=jm.cfg, **LAMBDAS)
    jb = jax_batch(batch)
    tx = optax.adam(jcfg.lr)

    @jax.jit
    def step(p, key):
        (total, losses), grads = jax.value_and_grad(
            lambda q: j_compute_losses(jm, jcfg, q, vgg_params, jb, key),
            has_aux=True)(p)
        return total, losses, grads, tx.update(grads, tx.init(p), p)[0]

    return lambda key: step(params, key)


# key 20's view dropout keeps both views (its keep draw is 0.83); key 21's
# drops one (0.088), and with one view left the colour head's softmax
# weight is exactly 1: no gradient reaches the texture encoder
@pytest.mark.parametrize("seed,both_views", [(20, True), (21, False)])
def test_train_step_matches_jax(batch, pair, vgg_params, j_step, seed,
                                both_views):
    jm, params, tm = pair
    key = jax.random.PRNGKey(seed)
    j_total, j_losses, j_grads, upd = j_step(key)
    k_patch, k_render = jax.random.split(key)
    center = jax_patch_center(k_patch, batch["target_mask"])
    noise = jax_render_noise(k_render, jm.cfg, 1, 64, 2)
    assert bool(noise.keep[0, 0, 0, 0] > 0.5) == both_views

    cfg = KeypointNeRFTrainConfig(model=KeypointNeRFConfig(**SMALL),
                                  **LAMBDAS)
    vgg = VGG19Features()
    vgg.load_state_dict(flax_to_state_dict({"params": vgg_params}))
    state = create_keypointnerf_state(cfg, device="cpu", vgg=vgg)
    state.model.load_state_dict(tm.state_dict())
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    losses = state(batch, noise=noise, center=center)
    assert state.step == 1
    assert sorted(losses) == sorted(j_losses) == ["e_all", "e_pix_c",
                                                  "e_pix_l1", "e_vgg"]
    for k, v in j_losses.items():
        np.testing.assert_allclose(float(losses[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(float(losses["e_all"]), float(j_total),
                               rtol=1e-5)

    ref = keypointnerf_flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    refu = keypointnerf_flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, upd)})
    named = dict(state.model.named_parameters())
    assert sorted(named) == sorted(ref)
    scale = max(np.linalg.norm(g.numpy()) for g in ref.values())
    nonzero = []
    for k, p in named.items():
        jg = ref[k].numpy()
        if KPN_ZERO_GRAD.search(k):
            # zero but for rounding in both packages (chip_smoke.py)
            assert max(np.abs(jg).max(), float(p.grad.abs().max())) \
                <= KPN_ZERO_GRAD_TOL * scale, k
            continue
        _grad_close(p.grad.numpy(), jg, k)
        if np.abs(jg).max() > 0:
            nonzero.append(k)
        sel = np.abs(jg) >= 1e-3 * np.abs(jg).max()
        du = (p.detach() - before[k]).numpy()
        np.testing.assert_allclose(du[sel], refu[k].numpy()[sel],
                                   atol=1e-2 * cfg.lr, rtol=0, err_msg=k)
    # the geometry encoder's gradient comes through its row gathers; the
    # texture encoder's only through the colour head's view softmax
    assert "geo_encoder.conv1.weight" in nonzero
    assert ("tex_encoder.conv_in.weight" in nonzero) == both_views
    if both_views:
        assert len(nonzero) == len(named) - sum(
            bool(KPN_ZERO_GRAD.search(k)) for k in named)


@pytest.fixture(scope="module")
def eval_pair():
    b = sphere_batch(seed=2, idx=2)
    jm, params, tm = model_pair(b, seed=4)
    return b, jm, params, tm


def test_render_full_image_matches_jax(eval_pair):
    b, jm, params, tm = eval_pair
    color_j, depth_j = j_render_full_image(jm, jm.cfg, params, jax_batch(b),
                                           jax.random.PRNGKey(0), level=3)
    color, depth = render_full_image(tm, tm.cfg, b, level=3)
    assert color.shape == (64, 64, 3) and depth.shape == (64, 64)
    assert np.isfinite(color).all() and np.isfinite(depth).all()
    assert color.std() > 0.01
    np.testing.assert_allclose(color, color_j, atol=1e-4, rtol=0)
    # depth = Σ z·w / (acc + 1e-8) divides by almost nothing where a ray
    # accumulates 1e-4–3e-3 of alpha: there JAX's jitted 16-tile render and
    # its one-call render of the same rays differ by up to 2e-3 relative
    np.testing.assert_allclose(depth, depth_j, rtol=5e-3)
    assert np.mean(np.abs(depth - depth_j) > 1e-4 * np.abs(depth_j)) < 0.01


def test_render_full_image_tile_grouping_is_exact(eval_pair):
    """Grouping strided tiles into one call (and the encoders run once
    per image) changes no value: an eval render draws nothing."""
    b, _, _, tm = eval_pair
    c16, d16 = render_full_image(tm, tm.cfg, b, level=3, tiles_per_call=16)
    c1, d1 = render_full_image(tm, tm.cfg, b, level=3, tiles_per_call=1)
    np.testing.assert_array_equal(c16, c1)
    np.testing.assert_array_equal(d16, d1)
    # a group that does not divide the 16 tiles falls back to 2
    c3, _ = render_full_image(tm, tm.cfg, b, level=3, tiles_per_call=3)
    np.testing.assert_array_equal(c3, c1)


def test_get_360_cameras_match_jax():
    headpose = np.eye(4, dtype=np.float32)
    headpose[:3, :3] = np.array([[0.96, -0.28, 0], [0.28, 0.96, 0],
                                 [0, 0, 1]], np.float32)
    headpose[:3, 3] = [0.1, -0.2, 0.3]
    args = (headpose, 1200.0, 1.1, 0.5, 256, 256)
    ours, ref = get_360_cameras(*args, n_frames=7), j_get_360_cameras(
        *args, n_frames=7)
    assert len(ours) == len(ref) == 7
    for a, r in zip(ours, ref):
        assert sorted(a) == sorted(r)
        for k, v in r.items():
            np.testing.assert_array_equal(a[k], v, err_msg=k)


# ----------------------------------------------------------- the data

@pytest.mark.parametrize("stage", ["train", "val"])
def test_sphere_keypointnerf_schema_matches_jax(stage):
    kw = dict(stage=stage, n=3, H=20, W=24, nv=2, model="KeypointNeRF",
              n_kpt=11)
    ours, ref = SphereDataset(**kw), JSphereDataset(**kw)
    for i in (0, 2):
        a, r = ours[i], ref[i]
        assert sorted(a) == sorted(r)
        for k, v in r.items():
            if isinstance(v, np.ndarray):
                assert a[k].dtype == v.dtype, k
                np.testing.assert_array_equal(a[k], v, err_msg=k)
            else:
                assert a[k] == v, k
    s = ours[1]
    assert set(BATCH_KEYS) <= set(s)
    assert s["target_kpt3d"].shape == (11, 3)
    assert s["src_alphas"].shape == (2, 20, 24, 1)
    np.testing.assert_allclose(s["bounds"], [[-0.7] * 3, [0.7] * 3])


def test_facescape_keypointnerf_batch_trains(tree):  # noqa: F811
    """The FaceScape KeypointNeRF sample holds every key a step reads, and
    a port step on it gives finite losses and gradients."""
    root, split_dir, _ = tree
    s = FacescapeDataset(root, "val", split_dir=split_dir,
                         model="KeypointNeRF")[0]
    assert set(BATCH_KEYS) <= set(s)
    b = {k: np.asarray(s[k])[None] for k in BATCH_KEYS}
    cfg = KeypointNeRFTrainConfig(
        model=KeypointNeRFConfig(**{**SMALL, "znear": 1.0, "zfar": 2.5}),
        lambda_vgg=0.0)
    state = create_keypointnerf_state(cfg, device="cpu")
    losses = state(b, generator=torch.Generator().manual_seed(0))
    assert all(np.isfinite(float(v)) for v in losses.values())
    assert all(bool(torch.isfinite(p.grad).all())
               for p in state.model.parameters())


# ------------------------------------------------------------ the CLI

def _kpn_yaml(tmp_path):
    """configs/train_keypointnerf_facescape.yaml on the 64×64 sphere, the
    model cut to the small configuration."""
    raw = yaml.safe_load((ROOT / "configs/train_keypointnerf_facescape.yaml"
                          ).read_text())
    raw["logger"]["kwargs"]["save_dir"] = str(tmp_path / "out")
    sphere = {"module": "synthetic_sphere",
              "kwargs": {"n": 2, "H": 64, "W": 64, "nv": 2, "n_kpt": 8}}
    for stage in ("train", "val"):
        raw["data"][stage]["dataset"] = sphere
    raw["keypoint_nerf"]["kwargs"] = {
        k: list(v) if isinstance(v, tuple) else v for k, v in SMALL.items()
        if k not in ("znear", "zfar")}
    p = tmp_path / "kpn.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p


def test_keypointnerf_cli_trains_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    p = _kpn_yaml(tmp_path)
    run_cfg = load_train_config(p, model_name="KeypointNeRF")
    cfg = build_keypointnerf_run_config(run_cfg)
    jcfg = j_build_run_config(j_load_train_config(p,
                                                  model_name="KeypointNeRF"))
    assert cfg.lr == jcfg.lr == 1e-4
    assert (cfg.lambda_l1_c, cfg.lambda_l1, cfg.lambda_vgg) == (
        jcfg.lambda_l1_c, jcfg.lambda_l1, jcfg.lambda_vgg) == (1.0, 10.0, 0.5)
    assert (cfg.model.znear, cfg.model.zfar) == (jcfg.model.znear,
                                                 jcfg.model.zfar) == (1.0, 2.5)
    assert cfg.model.sp_dim == jcfg.model.sp_dim == 40

    train_main([str(p), "KeypointNeRF", "--device", "cpu", "--max-steps",
                "2", "--num-workers", "0"])
    ckpt = tmp_path / "out" / "KeypointNeRF" / "checkpoints" / "step_00000002"
    saved = ckpt_lib.load_state(ckpt)
    assert saved["step"] == 2
    assert saved["model"]["mlp_geo.layers1.layer_0.v"].shape == (40 + 16, 32)
    assert all(torch.isfinite(v).all() for v in saved["model"].values())
    # the train state restores from it bit for bit
    fresh = create_keypointnerf_state(cfg, seed=1, device="cpu",
                                      vgg=VGG19Features())
    ckpt_lib.restore_checkpoint(ckpt, fresh)
    assert fresh.step == 2
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, saved["model"][k]), k
    assert fresh.optimizer.state_dict()["state"][0]["step"] == 2
