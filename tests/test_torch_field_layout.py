"""The field's matrix products take operands whose rows start on 16-byte
multiples (``nn/resnetfc.py``): the latent and the zero-padded point
features enter ``ResnetFC`` apart. At the widths of DINER (bf16) and of
NOVEL_PE (f32, PE maps on), a forward and backward of ``field`` leaves
``resnetfc.misaligned`` at 0; the same ``ResnetFC`` read through slices of
the 567-wide concatenation it replaced counts every product that reads
them. On the card (``cuda``): a bf16 DINER field forward and backward runs
no byte-wise (``align1``) kernel, and gives the concatenated layout's
output within bf16 rounding.

No JAX here: the ``cuda`` test runs on the card with ``--noconftest``.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from diner_tpu_torch.data.synthetic_dataset import SphereDataset
from diner_tpu_torch.models.novel.model import (NovelPixelNeRF,
                                                NovelPixelNeRFConfig)
from diner_tpu_torch.models.novel.train import gen_context_of
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.nn import resnetfc
from diner_tpu_torch.train.diner import SRC_KEYS, batch_to_device

H, W = 24, 32
# the benchmark configurations' widths: a ResNet34 latent of 512 channels,
# ResnetFC 5 × 512, 55 point features
WIDTHS = dict(d_hidden=512, n_blocks=5, combine_layer=3)
CASES = {"diner": ("DINER", "bfloat16"), "novel_pe": ("NOVEL_PE", "float32")}


def _setup(case, device, n_points=96):
    """(field(xyz) → (SB, B, 4), xyz (1, n_points, 3)): the case's model
    at the configurations' widths on an encoded two-view sphere."""
    schema, dtype = CASES[case]
    s = SphereDataset("train", n=2, H=H, W=W, nv=2, model=schema,
                      n_vertices=64)[1]
    b = batch_to_device({k: np.asarray(v)[None] for k, v in s.items()
                         if isinstance(v, np.ndarray)}, device)
    if case == "novel_pe":
        model = NovelPixelNeRF(NovelPixelNeRFConfig(
            **WIDTHS, compute_dtype=dtype, gen_latent_hw=12,
            gen_latent_ch=512, use_pe_maps=True))
    else:
        model = PixelNeRF(PixelNeRFConfig(**WIDTHS, compute_dtype=dtype))
    model.reset_parameters(torch.Generator().manual_seed(0))
    model.to(device)
    with torch.no_grad():
        ctx = model.encode(*(b[k] for k in SRC_KEYS), train=False)
    # the train step's field backward reaches the latent
    ctx = dataclasses.replace(ctx, latent=ctx.latent.requires_grad_())
    gen = torch.Generator(device=device).manual_seed(1)
    xyz = torch.rand(1, n_points, 3, generator=gen, device=device) - 0.5
    dirs = torch.nn.functional.normalize(
        torch.randn(1, n_points, 3, generator=gen, device=device), dim=-1)
    if case == "novel_pe":
        gctx = gen_context_of(model, b, W, H)
        return model, lambda p: model.field(ctx, gctx, p, p, dirs), xyz
    return model, lambda p: model.field(ctx, p, dirs), xyz


def _concatenated(model, monkeypatch):
    """Run ``model.mlp`` as before: one [latent, features] concatenation,
    the products reading both through slices of it."""
    forward = model.mlp.forward

    def sliced(z, x):
        zx = torch.cat([z, x[..., :model.cfg.d_in]], dim=-1)
        d = model.cfg.d_latent
        return forward(zx[..., :d], zx[..., d:])

    monkeypatch.setattr(model.mlp, "forward", sliced)


@pytest.mark.parametrize("case", sorted(CASES))
def test_field_operands_aligned(case, monkeypatch):
    model, field, xyz = _setup(case, "cpu")
    xyz.requires_grad_()
    before = resnetfc.misaligned
    field(xyz).square().sum().backward()
    assert resnetfc.misaligned == before
    assert xyz.grad.abs().sum() > 0
    _concatenated(model, monkeypatch)
    with torch.no_grad():
        field(xyz)
    # lin_in and the lin_z products before the view mean read the slices
    assert resnetfc.misaligned == before + 1 + model.cfg.combine_layer


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the chip machine")
    return torch.device("cuda")


def _kernel_names(fn):
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    return out, {e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA}


@pytest.mark.cuda
def test_field_no_align1_kernels_on_the_card(cuda, monkeypatch):
    model, field, xyz = _setup("diner", cuda, n_points=4096)
    xyz.requires_grad_()

    def fwd_bwd():
        xyz.grad = None
        out = field(xyz)
        out.square().sum().backward()
        return out.detach()

    fwd_bwd()  # cuBLAS's and the kernels' first calls
    before = resnetfc.misaligned
    out, names = _kernel_names(fwd_bwd)
    assert resnetfc.misaligned == before
    assert not [n for n in names if "align1" in n], sorted(names)
    _concatenated(model, monkeypatch)
    with torch.no_grad():
        old = field(xyz)
    torch.testing.assert_close(out, old, rtol=2e-2,
                               atol=2e-2 * float(old.abs().max()))
