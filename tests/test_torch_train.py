"""Port parity for the training slice: the BN running-statistics update,
the losses and VGG19, pixel selection, Adam, and one whole train step.

The small DINER of ``test_torch_render.py`` (resnet18 with 2 pyramid
levels, a 32-wide ResnetFC, flax weights perturbed with seeded numpy noise
and bridged to the port) takes one step on the 32×40 two-view sphere
scene, once with the MSE loss on 128 random rays and once with the
production losses (MSE + 0.1·VGG19 + 1.0·antibias) on a 16×16 foreground
patch. The pixel indices and the renderer's noise are what JAX draws from
the same key (``k_pix, k_render = split(key)``, then
``diner_tpu/renderer/renderer.py:77-84``). Tolerances, all at f32:
losses 1e-5 relative; each parameter's gradient within 1e-4 of its norm
(convolutions, matmuls and scatter-adds summed in another order, through
a backward of the train-mode BN; 2.3e-6 seen); running statistics 1e-4
(flax takes the batch variance as E[x²] − E[x]², the port in two
passes); Adam 1e-6.
bf16 VGG losses are compared at 2e-2 relative (bf16 convolutions round at
other places in the two frameworks).
"""

import copy
import dataclasses
import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import optax
import torch

from diner_tpu.losses import antibias_loss as j_antibias_loss
from diner_tpu.losses import init_vgg19_params
from diner_tpu.losses import mse_loss as j_mse_loss
from diner_tpu.losses import vgg_loss as j_vgg_loss
from diner_tpu.renderer import RendererConfig as JRendererConfig
from diner_tpu.train.diner import DinerConfig as JDinerConfig
from diner_tpu.train.diner import compute_losses as j_compute_losses
from diner_tpu.train.diner import select_pixels as j_select_pixels
from diner_tpu_torch.data.synthetic import make_sphere_scene
from diner_tpu_torch.losses import (VGG19Features, antibias_loss, init_vgg19,
                                    mse_loss, vgg_loss)
from diner_tpu_torch.ops import composite_cuda
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train.diner import (DinerConfig, make_eval_step,
                                         make_train_step, select_pixels)
from diner_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_render import RENDER, SRC, jax_noise, small_pair


@pytest.fixture(scope="module")
def pair():
    batch, jm, variables, tm = small_pair(seed=2)
    return types.SimpleNamespace(batch=batch, jm=jm, variables=variables,
                                 tm=tm)


@pytest.fixture(scope="module")
def vgg_params():
    return jax.tree_util.tree_map(np.asarray, init_vgg19_params(0))


def _bridged_vgg(vgg_params):
    vgg = VGG19Features()
    vgg.load_state_dict(flax_to_state_dict({"params": vgg_params}))
    return vgg


def _images(seed, n=2, s=16):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32),
            rng.uniform(0, 1, (n, s, s, 3)).astype(np.float32))


def _rel_close(a, b, rtol):
    np.testing.assert_allclose(float(a), float(b), rtol=rtol, atol=0)


# --------------------------------------------------------------- BatchNorm

def test_bn_running_stats_update_matches_flax(pair):
    tm = copy.deepcopy(pair.tm)
    _, mutated = jax.jit(lambda v, *src: pair.jm.apply(
        v, *src, train=True, method="encode", mutable=["batch_stats"]))(
            pair.variables, *(jnp.asarray(pair.batch[k]) for k in SRC))
    ref = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, mutated))
    saved = {k: v.clone() for k, v in tm.state_dict().items()}
    src = [torch.from_numpy(pair.batch[k]) for k in SRC]
    with torch.no_grad():
        tm.encode(*src, train=True)  # batch statistics, no update
        assert all(torch.equal(v, saved[k])
                   for k, v in tm.state_dict().items())
        tm.encode(*src, train=True, update_stats=True)
    new = tm.state_dict()
    assert len(ref) == 10 and all(k.endswith(("running_mean", "running_var"))
                                 for k in ref)
    for k, v in ref.items():
        assert not torch.equal(new[k], saved[k]), k
        np.testing.assert_allclose(new[k].numpy(), v.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)


# ------------------------------------------------------------------ losses

def test_mse_and_antibias_losses_match_jax():
    x, y = _images(0, s=24)
    _rel_close(mse_loss(torch.from_numpy(x), torch.from_numpy(y)),
               j_mse_loss(jnp.asarray(x), jnp.asarray(y)), 1e-6)
    for n in (1, 3):  # 24 is not a multiple of 2^3: the pool drops the edge
        _rel_close(antibias_loss(torch.from_numpy(x), torch.from_numpy(y), n),
                   j_antibias_loss(jnp.asarray(x), jnp.asarray(y), n), 1e-6)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_vgg_loss_matches_jax(vgg_params, dtype, rtol):
    x, y = _images(1)
    jdt = jnp.dtype(dtype)
    j_val, j_grad = jax.jit(jax.value_and_grad(
        lambda p: j_vgg_loss(vgg_params, p, jnp.asarray(y), dtype=jdt)))(
            jnp.asarray(x))
    vgg = _bridged_vgg(vgg_params)
    xt = torch.from_numpy(x).requires_grad_()
    val = vgg_loss(vgg, xt, torch.from_numpy(y), dtype=getattr(torch, dtype))
    val.backward()
    assert val.dtype == torch.float32 and float(val.detach()) > 0
    _rel_close(val.detach(), j_val, rtol)
    g, jg = xt.grad.numpy(), np.asarray(j_grad)
    assert np.abs(jg).max() > 0
    assert np.linalg.norm(g - jg) <= rtol * 10 * np.linalg.norm(jg)
    # frozen: no gradient reaches the VGG weights
    assert all(not p.requires_grad and p.grad is None
               for p in vgg.parameters())
    assert float(vgg_loss(vgg, torch.from_numpy(y),
                          torch.from_numpy(y))) == 0.0


def test_vgg_init_is_seeded_lecun_and_bridges(vgg_params):
    a, b, c = (init_vgg19(s, device="cpu") for s in (0, 0, 1))
    sa = a.state_dict()
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in sa.items())
    assert not torch.equal(sa["conv_0.weight"],
                           c.state_dict()["conv_0.weight"])
    ref = flax_to_state_dict({"params": vgg_params})
    assert sorted(sa) == sorted(ref) and len(sa) == 18
    assert all(sa[k].shape == ref[k].shape for k in sa)
    w = sa["conv_19.weight"]  # lecun-normal: std sqrt(1 / fan_in)
    assert abs(float(w.std()) * np.sqrt(w[0].numel()) - 1) < 0.05
    assert float(sa["conv_19.bias"].abs().max()) == 0


# ------------------------------------------------------------ pixel choice

def test_select_pixels_patch_mode_respects_mask():
    batch = make_sphere_scene(H=32, W=32, nv=2)
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    cfg = DinerConfig(w_vgg=0.1, vgg_spatch=8)
    idcs = select_pixels(cfg, b, torch.Generator().manual_seed(0)).numpy()
    assert idcs.shape == (1, 64)
    H = W = 32
    assert (idcs >= 0).all() and (idcs < H * W).all()
    xs, ys = idcs[0] % W, idcs[0] // W  # a contiguous 8×8 block
    assert xs.max() - xs.min() == 7 and ys.max() - ys.min() == 7
    assert len(set(idcs[0].tolist())) == 64
    alpha = batch["target_alpha"][0, :, :, 0]
    cx, cy = xs.min() + 4, ys.min() + 4  # the drawn centre
    assert alpha[cy, cx] > 0
    # uniform mode: ray_batch_size indices anywhere in the image
    u = select_pixels(DinerConfig(ray_batch_size=50), b,
                      torch.Generator().manual_seed(1))
    assert u.shape == (1, 50) and 0 <= int(u.min()) and int(u.max()) < H * W


# -------------------------------------------------------------------- Adam

def test_adam_matches_optax_over_two_steps():
    rng = np.random.default_rng(3)
    shapes = {"a": (5, 7), "b": (11,), "c": (2, 3, 4)}
    params = {k: rng.normal(0, 0.5, s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.normal(0, 1, s) * 10.0 ** rng.integers(-6, 1, s)
                  ).astype(np.float32) for k, s in shapes.items()}
             for _ in range(2)]
    tx = optax.adam(1e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = torch.optim.Adam(tp.values(), lr=1e-4)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step()
    for k in shapes:
        moved = np.abs(np.asarray(jp[k]) - params[k]).max()
        assert moved > 1e-4  # two steps of lr 1e-4 each
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   atol=1e-6, rtol=0)


# ---------------------------------------------------------- the train step

STEP_CASES = {
    "mse": dict(ray_batch_size=128),
    "production": dict(w_vgg=0.1, vgg_spatch=16, w_antibias=1.0,
                       antibias_downsampling=3),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_step_matches_jax(pair, vgg_params, case):
    extra = STEP_CASES[case]
    jcfg = JDinerConfig(nerf=pair.jm.cfg, renderer=JRendererConfig(**RENDER),
                        **extra)
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    vp = vgg_params if jcfg.w_vgg > 0 else None
    key = jax.random.PRNGKey(17)

    def loss_fn(params):
        return j_compute_losses(pair.jm, jcfg, params,
                                pair.variables["batch_stats"], vp, jbatch,
                                key)

    (j_total, aux), j_grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(pair.variables["params"])
    k_pix, k_render = jax.random.split(key)
    pix = np.array(j_select_pixels(jcfg, jbatch, k_pix))
    noise = tuple(np.array(a) for a in jax_noise(
        k_render, 1, jcfg.rays_per_step, jcfg.renderer))

    cfg = DinerConfig(nerf=pair.tm.cfg, renderer=RendererConfig(**RENDER),
                      **extra)
    tm = copy.deepcopy(pair.tm)
    saved = {k: v.clone() for k, v in tm.state_dict().items()}
    vgg = _bridged_vgg(vgg_params) if cfg.w_vgg > 0 else None
    step = make_train_step(tm, cfg, vgg)
    before = (composite_cuda.launches, composite_cuda.bwd_launches)
    metrics = step(pair.batch, noise=noise, pix_idcs=pix)
    assert (composite_cuda.launches, composite_cuda.bwd_launches) == before
    assert step.step == 1

    j_metrics = aux["metrics"]
    assert sorted(metrics) == sorted(j_metrics)
    for k, v in j_metrics.items():
        _rel_close(metrics[k], v, 1e-5)
    _rel_close(metrics["total"], j_total, 1e-5)

    # each parameter's gradient, against JAX's value_and_grad
    ref = flax_to_state_dict({"params": jax.tree_util.tree_map(
        np.asarray, j_grads)})
    named = dict(tm.named_parameters())
    assert sorted(named) == sorted(ref)
    for k, p in named.items():
        g, jg = p.grad.numpy(), ref[k].numpy()
        assert np.isfinite(g).all(), k
        np.testing.assert_allclose(
            g, jg, atol=1e-4 * np.linalg.norm(jg) + 1e-9, rtol=0, err_msg=k)
    assert float(named["encoder.resnet.conv1.weight"].grad.abs().max()) > 0
    # Adam moved the parameters; the BN statistics moved as flax's did
    assert not torch.equal(named["mlp.lin_in.weight"].detach(),
                           saved["mlp.lin_in.weight"])
    stats = flax_to_state_dict({"batch_stats": jax.tree_util.tree_map(
        np.asarray, aux["batch_stats"])})
    new = tm.state_dict()
    for k, v in stats.items():
        np.testing.assert_allclose(new[k].numpy(), v.numpy(), atol=1e-4,
                                   rtol=1e-4, err_msg=k)

    # an eval step after it leaves the statistics where the step put them
    moved = {k: v.clone() for k, v in tm.state_dict().items()}
    make_eval_step(tm, dataclasses.replace(
        cfg, renderer=dataclasses.replace(cfg.renderer, ray_chunk=640)))(
            pair.batch, generator=torch.Generator().manual_seed(0))
    assert all(torch.equal(v, moved[k]) for k, v in tm.state_dict().items())


def test_train_step_draws_from_generator_and_needs_vgg(pair):
    cfg = DinerConfig(nerf=pair.tm.cfg, renderer=RendererConfig(**RENDER),
                      ray_batch_size=64)
    out = []
    for _ in range(2):
        tm = copy.deepcopy(pair.tm)
        step = make_train_step(tm, cfg)
        m = step(pair.batch, generator=torch.Generator().manual_seed(5))
        out.append((float(m["total"]), tm.mlp.lin_in.weight.detach()))
    assert np.isfinite(out[0][0]) and out[0][0] == out[1][0]
    assert torch.equal(out[0][1], out[1][1])
    with pytest.raises(ValueError, match="VGG"):
        make_train_step(tm, dataclasses.replace(cfg, w_vgg=0.1))
