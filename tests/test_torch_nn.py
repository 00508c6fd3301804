"""Port parity: positional encoding, resize, ResNet, spatial encoder,
ResnetFC and the flax→torch weight bridge.

Flax modules are initialized, their parameters and BN statistics are
perturbed with seeded numpy noise (so zero-initialized layers and unit BN
scales are exercised), and the same tree goes to the port through
``utils/convert.py``. Tolerances: 1e-5 for elementwise ops; 1e-4 after a
conv or matmul stack (f32 sums in another order, and BN statistics from
another variance formula).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from diner_tpu.nn import positional_encoding as jpe
from diner_tpu.nn import resnet as jresnet
from diner_tpu.nn import resnetfc as jfc
from diner_tpu.nn import spatial_encoder as jse
from diner_tpu.utils import resize as jresize
from diner_tpu_torch.nn import positional_encoding as tpe
from diner_tpu_torch.nn import resnet as tresnet
from diner_tpu_torch.nn import resnetfc as tfc
from diner_tpu_torch.nn import spatial_encoder as tse
from diner_tpu_torch.utils import resize as tresize
from diner_tpu_torch.utils.convert import flax_to_state_dict


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(a, b, atol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=0)


def _perturb(variables, seed):
    """Numpy copy of a flax tree with every leaf randomized around its
    init (BN variances kept positive)."""
    rng = np.random.default_rng(seed)

    def leaf(path, x):
        x = np.asarray(x, np.float32)
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x + rng.normal(0, 0.05, x.shape).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))
    return jax.tree_util.tree_map(np.asarray, _unfreeze(tree))


def _unfreeze(tree):
    if hasattr(tree, "items"):
        return {k: _unfreeze(v) for k, v in tree.items()}
    return tree


@pytest.mark.parametrize("d_in,include", [(3, True), (1, True), (2, False)])
def test_positional_encoding(d_in, include):
    x = np.random.default_rng(0).normal(0, 1, (4, 7, d_in)).astype(
        np.float32)
    _close(tpe.positional_encode(_t(x), 6, 6.28, include),
           jpe.positional_encode(jnp.asarray(x), 6, 6.28, include), 1e-5)
    assert tpe.PositionalEncoding(6, d_in, 6.28, include).d_out == \
        jpe.PositionalEncoding(6, d_in, 6.28, include).d_out


def test_resize_align_corners():
    x = np.random.default_rng(1).normal(0, 1, (2, 5, 7, 3)).astype(
        np.float32)
    out = tresize.resize_bilinear_align_corners(_t(x), 11, 13)
    _close(out, jresize.resize_bilinear_align_corners(jnp.asarray(x), 11, 13),
           1e-5)
    ref = F.interpolate(_t(x).permute(0, 3, 1, 2), size=(11, 13),
                        mode="bilinear", align_corners=True)
    _close(out, ref.permute(0, 2, 3, 1), 1e-5)


def test_pad_ring_pe():
    _close(tse.pad_ring_pe(12, 10, 3, 4),
           jse.pad_ring_pe(12, 10, 3, 4), 1e-5)
    assert float(tse.pad_ring_pe(12, 10, 3, 4)[3:-3, 3:-3].abs().max()) == 0


@pytest.mark.parametrize("train", [True, False])
def test_resnet_encoder(train):
    x = np.random.default_rng(2).normal(0, 1, (2, 24, 32, 5)).astype(
        np.float32)
    jm = jresnet.ResNetEncoder(backbone="resnet18", num_layers=4)
    variables = _perturb(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), 3)
    if train:
        ref, _ = jm.apply(variables, jnp.asarray(x), train=True,
                          mutable=["batch_stats"])
    else:
        # running statistics near this input's own, as after training, so
        # activations stay O(1) and an absolute tolerance means something
        update = jax.jit(lambda v: jm.apply(v, jnp.asarray(x), train=True,
                                            mutable=["batch_stats"])[1])
        for _ in range(40):
            variables = {"params": variables["params"],
                         **jax.tree_util.tree_map(np.asarray,
                                                  update(variables))}
        ref = jm.apply(variables, jnp.asarray(x), train=False)
    tm = tresnet.ResNetEncoder(5, "resnet18", num_layers=4)
    tm.load_state_dict(flax_to_state_dict(variables))
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        out = tm(_t(x), train=train)
    assert len(out) == len(ref) == 4
    for a, b in zip(out, ref):
        assert a.shape == b.shape
        _close(a, b, 1e-4)
    # batch statistics are used, not accumulated
    for k, v in tm.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_spatial_encoder():
    cfg = dict(backbone="resnet18", num_layers=2, image_padding=8,
               padding_pe=4)
    x = np.random.default_rng(4).normal(0, 1, (2, 32, 40, 3)).astype(
        np.float32)
    jm = jse.SpatialEncoder(cfg=jse.SpatialEncoderConfig(**cfg))
    variables = _perturb(jm.init(jax.random.PRNGKey(1), jnp.asarray(x)), 5)
    ref, _ = jm.apply(variables, jnp.asarray(x), train=True,
                      mutable=["batch_stats"])
    tm = tse.SpatialEncoder(tse.SpatialEncoderConfig(**cfg))
    tm.load_state_dict(flax_to_state_dict(variables))
    with torch.no_grad():
        out = tm(_t(x), train=True)
    assert out.shape == ref.shape == (2, 24, 28, 128)
    _close(out, ref, 1e-4)


def test_spatial_encoder_bf16_keeps_bf16():
    """BN normalizes in f32 but hands the compute dtype on: no f32
    promotion of the pyramid under bf16."""
    cfg = tse.SpatialEncoderConfig(backbone="resnet18", num_layers=3,
                                   image_padding=8, padding_pe=4)
    tm = tse.SpatialEncoder(cfg, dtype=torch.bfloat16)
    for m in tm.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(torch.Generator().manual_seed(0))
    x = torch.rand(2, 16, 24, 3)
    with torch.no_grad():
        latents = tm.resnet(torch.rand(2, 32, 40, 3 + cfg.pe.d_out))
        out = tm(x)
    assert all(t.dtype == torch.bfloat16 for t in latents)
    assert out.dtype == torch.bfloat16 and out.shape[-1] == 256
    assert all(p.dtype == torch.float32 for p in tm.parameters())


@pytest.mark.parametrize("d_latent,d_hidden,dtype,atol", [
    (16, 32, "float32", 1e-4),
    (512, 512, "float32", 1e-4),   # DINER's widths
    (512, 64, "bfloat16", 0.2),    # 2e-2 of outputs up to ≈ 9
])
def test_resnetfc(d_latent, d_hidden, dtype, atol):
    """The port's ResnetFC of the latent and the zero-padded features,
    apart, against the JAX one of their concatenation."""
    d_in, NV, B = 55, 2, 30
    zx = np.random.default_rng(6).normal(
        0, 1, (1, NV, B, d_latent + d_in)).astype(np.float32)
    jm = jfc.ResnetFC(d_in=d_in, d_out=4, n_blocks=5, d_latent=d_latent,
                      d_hidden=d_hidden, combine_layer=3, combine_axis=1,
                      dtype=getattr(jnp, dtype))
    variables = _perturb(jm.init(jax.random.PRNGKey(2), jnp.asarray(zx)), 7)
    ref = np.asarray(jm.apply(variables, jnp.asarray(zx)), np.float32)
    dt = getattr(torch, dtype)
    tm = tfc.ResnetFC(d_in=d_in, d_out=4, n_blocks=5, d_latent=d_latent,
                      d_hidden=d_hidden, combine_layer=3, combine_axis=1,
                      dtype=dt)
    tm.load_state_dict(flax_to_state_dict(variables))
    z = _t(zx[..., :d_latent]).to(dt)
    x = tfc.cat_aligned([_t(zx[..., d_latent:]).to(dt)])
    assert x.shape[-1] == 56
    before = tfc.misaligned
    with torch.no_grad():
        out = tm(z, x).float()
    assert tfc.misaligned == before
    assert out.shape == ref.shape == (1, B, 4)
    _close(out, ref, atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_zero_padded_input(dtype):
    """lin_in's product of zero-padded features and its zero-padded weight
    gives the unpadded product's values and the (512, 55) weight's
    gradient."""
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(3)
    dense = tfc.Dense(55, 512, dtype=dt)
    dense.reset_parameters(gen)
    with torch.no_grad():
        dense.bias.normal_(0.0, 1.0, generator=gen)
    x = torch.randn(3, 40, 55, generator=gen).to(dt)
    g = torch.randn(3, 40, 512, generator=gen).to(dt)
    outs, grads = [], []
    for inp in (x, tfc.cat_aligned([x])):
        dense.weight.grad = None
        out = dense(inp)
        out.backward(g)
        outs.append(out.float())
        grads.append(dense.weight.grad.clone())
    assert grads[1].shape == (512, 55)
    tol = {} if dtype == "float32" else dict(rtol=1.6e-2, atol=1e-2)
    torch.testing.assert_close(outs[1], outs[0], **tol)
    torch.testing.assert_close(grads[1], grads[0], rtol=1e-5, atol=1e-4)


def test_misaligned_counter():
    """A Dense fed a slice of the 567-wide concatenation counts one call."""
    dense = tfc.Dense(512, 8, dtype=torch.bfloat16)
    dense.reset_parameters(torch.Generator().manual_seed(0))
    zx = torch.randn(2, 10, 567).to(torch.bfloat16)
    before = tfc.misaligned
    dense(zx[..., :512].contiguous())
    assert tfc.misaligned == before
    dense(zx[..., :512])
    assert tfc.misaligned == before + 1


def test_bridge_layouts():
    k_conv = np.arange(2 * 3 * 4 * 5, dtype=np.float32).reshape(2, 3, 4, 5)
    k_dense = np.arange(6, dtype=np.float32).reshape(2, 3)
    sd = flax_to_state_dict({
        "params": {"a": {"conv": {"kernel": k_conv},
                         "bn": {"scale": np.ones(5), "bias": np.zeros(5)},
                         "fc": {"kernel": k_dense, "bias": np.ones(3)}}},
        "batch_stats": {"a": {"bn": {"mean": np.zeros(5),
                                     "var": np.ones(5)}}}})
    assert sorted(sd) == ["a.bn.bias", "a.bn.running_mean",
                          "a.bn.running_var", "a.bn.weight", "a.conv.weight",
                          "a.fc.bias", "a.fc.weight"]
    assert sd["a.conv.weight"].shape == (5, 4, 2, 3)
    assert sd["a.conv.weight"][4, 3, 1, 2] == k_conv[1, 2, 3, 4]
    assert sd["a.fc.weight"].shape == (3, 2)
    assert sd["a.fc.weight"][2, 1] == k_dense[1, 2]
    with pytest.raises(KeyError):
        flax_to_state_dict({"params": {"x": {"embedding": np.ones(2)}}})
