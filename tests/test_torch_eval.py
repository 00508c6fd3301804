"""Port parity for the full-image eval step and the seeded model
constructor.

The eval step renders the whole 32×40 target in chunks of 512 rays (three
chunks, the last one edge-padded) from bridged weights and the noise JAX
draws from the same key (``diner_tpu/renderer/renderer.py:142`` and
``:77-84``). Tolerance 1e-4: every output is downstream of convolutions
and matmuls summed in another order.
"""

import types

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from diner_tpu.renderer import RendererConfig as JRendererConfig
from diner_tpu.train.diner import DinerConfig as JDinerConfig
from diner_tpu.train.diner import make_eval_step as j_make_eval_step
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train.diner import (DinerConfig, create_model,
                                         make_eval_step)
from diner_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_render import H, W, RENDER, jax_chunk_noise, small_pair


@pytest.fixture(scope="module")
def pair():
    batch, jm, variables, tm = small_pair(seed=1)
    return types.SimpleNamespace(batch=batch, jm=jm, variables=variables,
                                 tm=tm)


@pytest.mark.parametrize("use_running_stats", [False, True])
def test_eval_step_matches_jax(pair, use_running_stats):
    rcfg = dict(RENDER, ray_chunk=512)
    jcfg = JDinerConfig(nerf=pair.jm.cfg, renderer=JRendererConfig(**rcfg))
    state = types.SimpleNamespace(
        params=pair.variables["params"],
        batch_stats=pair.variables["batch_stats"])
    j_step = j_make_eval_step(pair.jm, jcfg, use_running_stats)
    key = jax.random.PRNGKey(5)
    jbatch = {k: jnp.asarray(v) for k, v in pair.batch.items()}
    j_rgb, j_depth = jax.jit(lambda b, k: j_step(state, b, k))(jbatch, key)

    cfg = DinerConfig(nerf=pair.tm.cfg, renderer=RendererConfig(**rcfg))
    noise = jax_chunk_noise(key, 1, H * W, 512, jcfg.renderer)
    before = {k: v.clone() for k, v in pair.tm.state_dict().items()}
    rgb, depth = make_eval_step(pair.tm, cfg, use_running_stats)(
        pair.batch, noise=noise)
    assert rgb.shape == (1, H, W, 3) and depth.shape == (1, H, W)
    assert (depth > 0).float().mean() > 0.05  # rays that hit density
    np.testing.assert_allclose(rgb.numpy(), np.asarray(j_rgb), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(depth.numpy(), np.asarray(j_depth),
                               atol=1e-4, rtol=0)
    for k, v in pair.tm.state_dict().items():  # running stats untouched
        assert torch.equal(v, before[k]), k


def test_create_model_is_seeded_and_bridgeable(pair):
    cfg = DinerConfig(nerf=pair.tm.cfg, renderer=RendererConfig(**RENDER))
    a = create_model(cfg, pair.batch, seed=3, device="cpu")
    b = create_model(cfg, pair.batch, seed=3, device="cpu")
    c = create_model(cfg, pair.batch, seed=4, device="cpu")
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["mlp.lin_in.weight"], sc["mlp.lin_in.weight"])
    # the port's parameter tree is the flax tree, name for name and shape
    # for shape
    ref = flax_to_state_dict(pair.variables)
    assert sorted(sa) == sorted(ref)
    assert all(sa[k].shape == ref[k].shape for k in sa)
    # JAX initializers: zero residual output layers, He-normal fan-in
    assert float(sa["mlp.block_0.fc_1.weight"].abs().max()) == 0
    w = sa["mlp.block_0.fc_0.weight"]
    assert abs(float(w.std()) / np.sqrt(2.0 / w.shape[1]) - 1) < 0.1
    step = make_eval_step(a, cfg)
    rgb, depth = step(pair.batch, generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(rgb).all() and (depth > 0).any()


def test_create_model_rerolls_dead_inits(pair, monkeypatch):
    """A draw whose density head is dead everywhere is redrawn."""
    from diner_tpu_torch.models import pixelnerf
    cfg = DinerConfig(nerf=pair.tm.cfg, renderer=RendererConfig(**RENDER))
    draws = []
    real = pixelnerf.PixelNeRF.reset_parameters

    def reset(self, generator):
        real(self, generator)
        draws.append(1)
        if len(draws) == 1:  # kill the first draw's density head
            with torch.no_grad():
                self.mlp.lin_out.bias[3] = -1e4

    monkeypatch.setattr(pixelnerf.PixelNeRF, "reset_parameters", reset)
    model = create_model(cfg, pair.batch, seed=0, device="cpu")
    assert len(draws) == 2
    assert float(model.mlp.lin_out.bias[3].detach()) > -1e3
