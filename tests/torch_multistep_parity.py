"""Several production train steps through the JAX package and the port.

Not a test (pytest does not collect it): it takes about 90 s on an
8-core CPU at the full model width. Both packages start from the same weights
(JAX's ``create_state`` bridged to the port) and take the same pixels and
renderer noise each step (drawn by JAX from the step's key). Per step it
prints each package's total loss, how many parameter tensors got a
gradient that is not all zero, and the largest difference between the
two packages' parameters after the step.

  JAX_PLATFORMS=cpu python tests/torch_multistep_parity.py --steps 8
"""

import argparse
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE.parent), str(HERE)]  # the repository, the tests

# flake8: noqa: E402 (imports after the path set-up)
from diner_tpu.data.synthetic import make_sphere_scene
from diner_tpu.losses import init_vgg19_params
from diner_tpu.models.pixelnerf import PixelNeRFConfig as JPixelNeRFConfig
from diner_tpu.nn.spatial_encoder import SpatialEncoderConfig as JEncCfg
from diner_tpu.renderer import RendererConfig as JRendererConfig
from diner_tpu.train import diner as jdiner
from diner_tpu_torch.losses import VGG19Features
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train.diner import DinerConfig, make_train_step
from diner_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_render import jax_noise


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--height", type=int, default=48)
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    args = ap.parse_args()

    # the production recipe of bench.py:73-93 at the full model width, on
    # a small image with a 16×16 patch and 128 depth candidates
    enc = dict(backbone="resnet34", num_layers=4, image_padding=16,
               padding_pe=4)
    rend = dict(n_samples=40, n_depth_candidates=128, n_gaussian=15,
                white_bkgd=False)
    extra = dict(lr=1e-4, w_vgg=0.1, vgg_spatch=16, w_antibias=1.0)
    jcfg = jdiner.DinerConfig(
        nerf=JPixelNeRFConfig(encoder=JEncCfg(**enc), d_hidden=512,
                              compute_dtype=args.dtype),
        renderer=JRendererConfig(**rend), **extra)
    batch = make_sphere_scene(H=args.height, W=args.width, nv=4)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vgg_params = init_vgg19_params(0)
    jmodel, state = jdiner.create_state(jcfg, jax.random.PRNGKey(0), batch,
                                        vgg_params=vgg_params)

    tm = PixelNeRF(PixelNeRFConfig(encoder=SpatialEncoderConfig(**enc),
                                   d_hidden=512, compute_dtype=args.dtype))
    tm.load_state_dict(flax_to_state_dict(_numpy(
        {"params": state.params, "batch_stats": state.batch_stats})))
    vgg = VGG19Features()
    vgg.load_state_dict(flax_to_state_dict({"params": _numpy(vgg_params)}))
    step = make_train_step(tm, DinerConfig(
        nerf=tm.cfg, renderer=RendererConfig(**rend), **extra), vgg)

    j_step = jax.jit(jdiner.make_train_step(jmodel, jcfg))
    j_grad = jax.jit(jax.grad(lambda p, s, k: jdiner.compute_losses(
        jmodel, jcfg, p, s.batch_stats, s.vgg_params, jbatch, k)[0]))
    key = jax.random.PRNGKey(1)
    for i in range(args.steps):
        key, sub = jax.random.split(key)
        j_nonzero = sum(bool(jnp.any(g != 0)) for g in
                        jax.tree_util.tree_leaves(j_grad(state.params,
                                                         state, sub)))
        state, j_metrics = j_step(state, jbatch, sub)
        k_pix, k_render = jax.random.split(sub)
        pix = np.array(jdiner.select_pixels(jcfg, jbatch, k_pix))
        noise = tuple(np.array(a) for a in jax_noise(
            k_render, 1, jcfg.rays_per_step, jcfg.renderer))
        metrics = step(batch, noise=noise, pix_idcs=pix)
        nonzero = sum(bool((p.grad != 0).any()) for p in tm.parameters())
        ref = flax_to_state_dict({"params": _numpy(state.params)})
        diff = max(float((p.detach() - ref[n]).abs().max())
                   for n, p in tm.named_parameters())
        print(f"step {i + 1}: jax total {float(j_metrics['total']):.6f} "
              f"nonzero {j_nonzero} | port total "
              f"{float(metrics['total']):.6f} nonzero {nonzero} | "
              f"max param diff {diff:.2e}", flush=True)


if __name__ == "__main__":
    main()
