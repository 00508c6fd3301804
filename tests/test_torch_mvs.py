"""TransMVSNet's modules in the PyTorch port against the JAX package, on
the CPU: the resizes, the conv blocks (the transposed 3-D conv with
non-symmetric weights and BN statistics), DCNv2 with nonzero offsets and
masks and taps off the image, the FMT with the sine and the SuperGlue
positional encodings, and the plane-sweep warp with some hypotheses behind
the camera.

Weights: a seeded port ``TransMVSNet`` (BN statistics, BN affines and the
offset/mask convolutions drawn too), carried to the JAX package by its own
``convert_transmvsnet``; each JAX submodule runs on its slice of the
variables. Tolerance (``tests/torch_mvs_tol.py``): every output within
``BLOCK_RTOL`` = 1e-5 of the largest magnitude of the JAX output.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.mvs import blocks as jblocks
from diner_tpu.mvs import dcn as jdcn
from diner_tpu.mvs import fmt as jfmt
from diner_tpu.mvs.homography import homo_warping as j_homo_warping
from diner_tpu.mvs.model import CostRegNet as JCostRegNet
from diner_tpu.mvs.model import FeatureNet as JFeatureNet
from diner_tpu.utils import resize as jresize
from diner_tpu.utils.torch_convert import convert_transmvsnet
from diner_tpu_torch.mvs import fmt as pfmt
from diner_tpu_torch.mvs.homography import homo_warping
from diner_tpu_torch.mvs.model import TransMVSNet, TransMVSNetConfig
from diner_tpu_torch.utils import resize as presize
from tests.torch_mvs_tol import assert_close_to_max, seeded_state

CFG = TransMVSNetConfig(ndepths=(8, 8, 8))


@pytest.fixture(scope="module")
def models():
    torch.manual_seed(0)
    model = TransMVSNet(CFG)
    model.load_state_dict(seeded_state(model))
    model.eval()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, convert_transmvsnet(sd)


def sub(variables, *path):
    out = {}
    for coll in ("params", "batch_stats"):
        node = variables[coll]
        for p in path:
            node = node.get(p, {}) if isinstance(node, dict) else {}
        if node:
            out[coll] = node
    return out


# ------------------------------------------------------------- resizes

@pytest.mark.parametrize("align_corners", [False, True])
def test_resizes_match_jax(align_corners):
    x = np.random.RandomState(1).randn(2, 5, 7, 9, 3).astype(np.float32)
    xt = torch.from_numpy(x)
    cases = [
        (jresize.resize_linear_2d(jnp.asarray(x), 14, 5, align_corners),
         presize.resize_linear_2d(xt, 14, 5, align_corners)),
        (jresize.resize_linear_axis(jnp.asarray(x), 11, 1, align_corners),
         presize.resize_linear_axis(xt, 11, 1, align_corners)),
        (jresize.resize_trilinear(jnp.asarray(x), 10, 3, 18, align_corners),
         presize.resize_trilinear(xt, 10, 3, 18, align_corners)),
    ]
    for j, p in cases:
        assert_close_to_max(p.numpy(), np.asarray(j), "resize")
    # the channels-first axes the model uses: the same values, moved
    got = presize.resize_linear_2d(xt.permute(0, 1, 4, 2, 3), 14, 5,
                                   align_corners, axes=(-2, -1))
    assert_close_to_max(got.permute(0, 1, 3, 4, 2).numpy(),
                        np.asarray(cases[0][0]), "resize (C, H, W)")
    np.testing.assert_array_equal(
        presize.resize_nearest_2x(xt).numpy(),
        np.asarray(jresize.resize_nearest_2x(jnp.asarray(x))))


# --------------------------------------------------------------- blocks

def test_deconv_block_matches_jax(models):
    """The transposed conv (conv7: 64 → 32 channels) with the reference's
    weight layout against the JAX interior-pad conv on the flipped kernel,
    BN statistics applied."""
    model, v = models
    block = model.cost_regularization[0].conv7
    w = block.conv.weight.detach().numpy()
    assert not np.allclose(w, w[:, :, ::-1, ::-1, ::-1])  # not symmetric
    x = np.random.RandomState(2).randn(1, 2, 3, 4, 64).astype(np.float32)
    ref = jblocks.DeconvBnReLU3D(32).apply(sub(v, "cost_reg_0", "conv7"),
                                           jnp.asarray(x), train=False)
    with torch.no_grad():
        got = block(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.shape == (1, 32, 4, 6, 8)
    assert_close_to_max(got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(ref),
                        "DeconvBnReLU3D")


def test_conv_blocks_and_cost_regnet_match_jax(models):
    """ConvBnReLU3D on a channel-free volume (the JAX TapConvIn1 path) and
    with channels; the whole 3-D U-Net (TapConvOut1 head)."""
    model, v = models
    rng = np.random.RandomState(3)
    vol = rng.randn(1, 8, 8, 8).astype(np.float32)
    cr = model.cost_regularization[0]
    ref0 = jblocks.ConvBnReLU3D(8).apply(sub(v, "cost_reg_0", "conv0"),
                                         jnp.asarray(vol), train=False)
    x = rng.randn(1, 8, 8, 8, 8).astype(np.float32)
    ref1 = jblocks.ConvBnReLU3D(16, stride=2).apply(
        sub(v, "cost_reg_0", "conv1"), jnp.asarray(x), train=False)
    ref2 = JCostRegNet(8).apply(sub(v, "cost_reg_0"), jnp.asarray(vol),
                                train=False)
    with torch.no_grad():
        got0 = cr.conv0(torch.from_numpy(vol)[:, None])
        got1 = cr.conv1(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        got2 = cr(torch.from_numpy(vol))
    assert_close_to_max(got0.permute(0, 2, 3, 4, 1).numpy(),
                        np.asarray(ref0), "ConvBnReLU3D, C_in = 1")
    assert_close_to_max(got1.permute(0, 2, 3, 4, 1).numpy(),
                        np.asarray(ref1), "ConvBnReLU3D, stride 2")
    assert_close_to_max(got2.numpy(), np.asarray(ref2), "CostRegNet")


def test_dcn_matches_jax(models):
    """A DCN layer of the FeatureNet head with drawn offset/mask weights:
    offsets of several pixels, taps off the image, masks away from 0.5."""
    model, v = models
    layer = model.feature.out1[1]
    x = np.random.RandomState(4).randn(2, 32, 6, 10).astype(np.float32)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        om = layer.conv_offset_mask(xt)
        got = layer(xt)
    off = om[:, :18]
    gy = torch.arange(6.0)[:, None] + off[:, 0::2]
    gx = torch.arange(10.0)[None] + off[:, 1::2]
    off_image = ((gy < 0) | (gy > 5) | (gx < 0) | (gx > 9)).float().mean()
    assert float(off.abs().max()) > 2.0 and 0.05 < float(off_image) < 0.9
    assert float(torch.sigmoid(om[:, 18:]).sub(0.5).abs().max()) > 0.3
    ref = jdcn.DeformConv2d(32).apply(sub(v, "feature", "out1_dcn0"),
                                      jnp.asarray(x.transpose(0, 2, 3, 1)))
    assert_close_to_max(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref),
                        "DeformConv2d")


def test_feature_net_matches_jax(models):
    """The FPN with its 9 DCN layers, batched over views."""
    model, v = models
    imgs = np.random.RandomState(5).rand(3, 32, 32, 3).astype(np.float32)
    ref = JFeatureNet(8).apply(sub(v, "feature"), jnp.asarray(imgs),
                               train=False)
    with torch.no_grad():
        got = model.feature(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    for stage in ("stage1", "stage2", "stage3"):
        assert_close_to_max(got[stage].permute(0, 2, 3, 1).numpy(),
                            np.asarray(ref[stage]), f"FeatureNet {stage}")


# ------------------------------------------------------------------ FMT

def _pyramid(seed, V=3, bc=8, H=4, W=6):
    rng = np.random.RandomState(seed)
    return [{f"stage{i + 1}": rng.randn(1, H << i, W << i,
                                        (4 * bc) >> i).astype(np.float32)
             for i in range(3)} for _ in range(V)]


def _run_pathway(port_pathway, jax_vars, feats, pe_type):
    ref = jfmt.FMTWithPathway(8, pe_type=pe_type).apply(
        jax_vars, [{k: jnp.asarray(a) for k, a in f.items()} for f in feats])
    with torch.no_grad():
        got = port_pathway([{k: torch.from_numpy(a).permute(0, 3, 1, 2)
                             for k, a in f.items()} for f in feats])
    for vi, (g, r) in enumerate(zip(got, ref)):
        for stage in ("stage1", "stage2", "stage3"):
            assert_close_to_max(g[stage].permute(0, 2, 3, 1).numpy(),
                                np.asarray(r[stage]), f"view {vi} {stage}")


def test_fmt_pathway_sine_pe_matches_jax(models):
    model, v = models
    pe = pfmt.sine_position_encoding_2d(32, 5, 7).numpy()
    np.testing.assert_allclose(
        pe, np.asarray(jfmt.sine_position_encoding_2d(32, 5, 7)),
        rtol=0, atol=1e-6)
    _run_pathway(model.FMT_with_pathway, sub(v, "FMT_with_pathway"),
                 _pyramid(6), "sine")


def test_fmt_pathway_superglue_pe_matches_jax(models):
    """The SuperGlue PE under the reference's names (kenc.encoder.j),
    carried to the JAX module's mlp_i / bn_i by hand; BN statistics
    drawn."""
    model, v = models
    torch.manual_seed(1)
    pathway = pfmt.FMTWithPathway(8, pe_type="superglue")
    state = pathway.state_dict()
    rng = np.random.RandomState(7)
    for k, val in model.FMT_with_pathway.state_dict().items():
        state[k] = val
    enc = "FMT.pos_encoding.kenc.encoder"
    for j in (1, 4):
        state[f"{enc}.{j}.running_mean"] = torch.tensor(
            0.1 * rng.randn(*state[f"{enc}.{j}.running_mean"].shape),
            dtype=torch.float32)
        state[f"{enc}.{j}.running_var"] = torch.tensor(
            0.5 + rng.rand(*state[f"{enc}.{j}.running_var"].shape),
            dtype=torch.float32)
    state[f"{enc}.6.bias"] = torch.tensor(
        0.1 * rng.randn(32), dtype=torch.float32)
    pathway.load_state_dict(state)
    pathway.eval()
    s = {k: val.numpy() for k, val in state.items()}
    pe_params = {
        "mlp_0": {"kernel": s[f"{enc}.0.weight"][:, :, 0].T,
                  "bias": s[f"{enc}.0.bias"]},
        "mlp_1": {"kernel": s[f"{enc}.3.weight"][:, :, 0].T,
                  "bias": s[f"{enc}.3.bias"]},
        "mlp_out": {"kernel": s[f"{enc}.6.weight"][:, :, 0].T,
                    "bias": s[f"{enc}.6.bias"]}}
    pe_stats = {}
    for name, j in (("0", 1), ("1", 4)):
        pe_params[f"bn_{name}"] = {"scale": s[f"{enc}.{j}.weight"],
                                   "bias": s[f"{enc}.{j}.bias"]}
        pe_stats[f"bn_{name}"] = {"mean": s[f"{enc}.{j}.running_mean"],
                                  "var": s[f"{enc}.{j}.running_var"]}
    jv = sub(v, "FMT_with_pathway")
    jv = {"params": {**jv["params"], "FMT": {**jv["params"]["FMT"],
                                             "pos_encoding": pe_params}},
          "batch_stats": {"FMT": {"pos_encoding": pe_stats}}}
    _run_pathway(pathway, jv, _pyramid(8), "superglue")


# --------------------------------------------------------------- warping

def test_homo_warping_matches_jax():
    """Source features warped to 7 hypotheses, two of them behind the
    source camera (z < 1e-6 → off the grid → zeros)."""
    rng = np.random.RandomState(9)
    B, H, W, C, D = 2, 12, 16, 8, 7
    src = rng.randn(B, H, W, C).astype(np.float32)
    K = np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]], np.float32)

    def proj(tx, tz):
        P = np.eye(4, dtype=np.float32)
        P[:3, :3] = K
        P[0, 3], P[2, 3] = tx, tz
        return np.tile(P, (B, 1, 1))

    src_proj, ref_proj = proj(2.0, -1.5), proj(0.0, 0.0)
    dv = np.tile(np.linspace(0.5, 3.0, D, dtype=np.float32)[None, :, None,
                                                            None],
                 (B, 1, H, W))
    dv = dv + 0.05 * rng.rand(B, D, H, W).astype(np.float32)
    ref = j_homo_warping(jnp.asarray(src), jnp.asarray(src_proj),
                         jnp.asarray(ref_proj), jnp.asarray(dv))
    got = homo_warping(torch.from_numpy(src), torch.from_numpy(src_proj),
                       torch.from_numpy(ref_proj), torch.from_numpy(dv))
    assert (dv[:, :2] - 1.5 < 1e-6).all()  # z < 1e-6 in the source view
    assert float(got[:, :2].abs().max()) == 0.0
    assert float(got[:, 2:].abs().max()) > 0.5
    assert_close_to_max(got.numpy(), np.asarray(ref), "homo_warping")
