"""The PyTorch port's whole TransMVSNet forward and its depth-map writer
against the JAX package on the CPU, and the weight bridges of
``diner_tpu_torch/utils/convert.py``.

Inputs: three 32×32 views of a seeded scene, cameras 0.1 apart in x,
hypotheses from 2 to 6, ndepths (8, 8, 8), base_channels 8. Weights: a
seeded port model (``tests/torch_mvs_tol.py:seeded_state``) carried to the
JAX package by its ``convert_transmvsnet``, or seeded JAX variables
carried to the port by ``transmvsnet_flax_to_state_dict``. The JAX forward
is compiled once for the module. Tolerances and the tie rule
(``tests/torch_mvs_tol.py``): per-stage probability volumes and
confidences within ``PROB_ATOL`` = 1e-4 where both sides' hypotheses agree;
winner-take-all depth the same bin at every pixel whose top two
probabilities differ by more than ``TIE_MARGIN`` = 1e-4; the uint16 PNGs
within ``PNG_LSB`` = 1 unit there (the confidence PNG everywhere).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diner_tpu.mvs.model import TransMVSNet as JTransMVSNet
from diner_tpu.mvs.model import TransMVSNetConfig as JConfig
from diner_tpu.mvs.train import write_prediction as j_write_prediction
from diner_tpu.utils.torch_convert import convert_transmvsnet
from diner_tpu_torch.data.io import read_depth_png
from diner_tpu_torch.mvs import predict
from diner_tpu_torch.mvs.model import TransMVSNet, TransMVSNetConfig
from diner_tpu_torch.utils.convert import (
    transmvsnet_flax_to_state_dict,
    transmvsnet_reference_state_dict,
)
from tests.torch_mvs_tol import (
    PNG_LSB,
    assert_forward_matches,
    decisive,
    seeded_state,
)

NDEPTHS = (8, 8, 8)
H = W = 32
V = 3
STAGES = ("stage1", "stage2", "stage3")


def toy_sample(seed=1):
    """One sample in the datasets' layout: images (V, H, W, 3), per-stage
    [extrinsics; intrinsics] (V, 2, 4, 4), 48 global hypotheses 2..6."""
    rng = np.random.RandomState(seed)
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    projs = {}
    for stage, scale in zip(STAGES, (4, 2, 1)):
        pm = np.zeros((V, 2, 4, 4), np.float32)
        for v in range(V):
            E = np.eye(4, dtype=np.float32)
            E[0, 3] = 0.1 * v
            pm[v, 0] = E
            pm[v, 1, :3, :3] = K / scale
            pm[v, 1, 2, 2] = 1
        projs[stage] = pm
    return {"imgs": rng.rand(V, H, W, 3).astype(np.float32),
            "proj_matrices": projs,
            "depth_values": np.linspace(2, 6, 48, dtype=np.float32),
            "mask": {"stage3": np.ones((H, W), np.float32)},
            "dpath": "Depths/scan1/depth_map_0000.pfm"}


class ToyDataset:
    def __init__(self, sample):
        self.sample = sample

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return self.sample


PROB_GAIN = 10.0


def sharpened(state):
    """``state`` with the cost regularisers' last convolutions × PROB_GAIN:
    random weights otherwise leave the softmax over 8 bins so flat that few
    pixels are decisive under the tie rule."""
    return {k: v * PROB_GAIN if k.endswith(".prob.weight") else v
            for k, v in state.items()}


@pytest.fixture(scope="module")
def jax_model():
    """The JAX TransMVSNet, its jitted inference and the shapes of its
    variables (no compile for those)."""
    model = JTransMVSNet(cfg=JConfig(ndepths=NDEPTHS))
    s = toy_sample()
    args = (jnp.asarray(s["imgs"])[None],
            {k: jnp.asarray(p)[None] for k, p in s["proj_matrices"].items()},
            jnp.asarray(s["depth_values"])[None])
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), *args, train=False))
    infer = jax.jit(lambda v, i, p, d: model.apply(v, i, p, d, train=False))
    return model, infer, shapes


@pytest.fixture(scope="module")
def port_model():
    torch.manual_seed(0)
    model = TransMVSNet(TransMVSNetConfig(ndepths=NDEPTHS))
    model.load_state_dict(sharpened(seeded_state(model, seed=3)))
    return model.eval()


def jax_outputs(infer, variables, sample):
    out = infer(variables, jnp.asarray(sample["imgs"])[None],
                {k: jnp.asarray(p)[None]
                 for k, p in sample["proj_matrices"].items()},
                jnp.asarray(sample["depth_values"])[None])
    return {st: {k: np.asarray(out[st][k]) for k in
                 ("prob_volume", "photometric_confidence", "depth",
                  "depth_values")} for st in STAGES}


def port_outputs(model, sample):
    out = predict.run_model(model, sample, "cpu")
    return {st: {k: v.numpy() for k, v in out[st].items()} for st in STAGES}


def leaves(tree, prefix=()):
    if isinstance(tree, dict) or hasattr(tree, "items"):
        for k, v in tree.items():
            yield from leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def test_forward_matches_jax(jax_model, port_model):
    """Port weights → ``convert_transmvsnet`` → the JAX forward equals the
    port's at every stage (the tie rule for depth)."""
    _, infer, _ = jax_model
    sample = toy_sample()
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    ref = jax_outputs(infer, convert_transmvsnet(sd), sample)
    got = port_outputs(port_model, sample)
    assert_forward_matches(got, ref, STAGES)


def test_state_dict_round_trip(jax_model, port_model):
    """The port's state dict covers the JAX model's variables exactly
    (paths and shapes), and ``transmvsnet_flax_to_state_dict`` inverts the
    JAX package's ``convert_transmvsnet`` bit for bit."""
    _, _, shapes = jax_model
    sd = port_model.state_dict()
    jv = convert_transmvsnet({k: v.numpy() for k, v in sd.items()})
    want = {p: tuple(x.shape) for p, x in leaves(shapes)}
    have = {p: tuple(np.shape(x)) for p, x in leaves(jv)}
    assert have == want
    back = transmvsnet_flax_to_state_dict(jv)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(back[k], v), k


def test_jax_variables_carried_to_port_match_forward(jax_model):
    """Seeded JAX variables (fan-in scaled kernels, drawn BN statistics and
    offset/mask convolutions) → ``transmvsnet_flax_to_state_dict`` →
    the port's forward equals the JAX one."""
    _, infer, shapes = jax_model
    rng = np.random.RandomState(5)

    def draw(path, x):
        name = "/".join(getattr(k, "key", str(k)) for k in path)
        shape = tuple(x.shape)
        if name.endswith("/var"):
            v = 0.5 + rng.rand(*shape)
        elif name.endswith("/mean") or name.endswith("/bias"):
            v = 0.1 * rng.randn(*shape)
        elif name.endswith("/scale"):
            v = 1 + 0.1 * rng.randn(*shape)
        elif "conv_offset_mask" in name:
            v = 0.05 * rng.randn(*shape)
        else:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return np.asarray(v, np.float32)

    jv = jax.tree_util.tree_map_with_path(draw, shapes)
    jv = jax.tree_util.tree_map(np.asarray, jv)
    model = TransMVSNet(TransMVSNetConfig(ndepths=NDEPTHS))
    model.load_state_dict(sharpened(transmvsnet_flax_to_state_dict(jv)))
    jv = convert_transmvsnet({k: v.numpy()
                              for k, v in model.state_dict().items()})
    sample = toy_sample(seed=2)
    assert_forward_matches(port_outputs(model.eval(), sample),
                           jax_outputs(infer, jv, sample), STAGES)


def test_reference_checkpoint_bridge(port_model, tmp_path):
    """A reference trainer checkpoint (``{"model": …}``, DDP ``module.``
    keys, ``num_batches_tracked``) loads bit for bit; a bare dict too; an
    unknown key, a wrong shape or a missing key raises naming it."""
    sd = port_model.state_dict()
    blob = {"model": {"module." + k: v.clone() for k, v in sd.items()},
            "epoch": 15, "optimizer": {}}
    path = tmp_path / "model_000015.ckpt"
    torch.save(blob, path)
    fresh = TransMVSNet(TransMVSNetConfig(ndepths=NDEPTHS))
    predict.load_checkpoint(fresh, path)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bare = transmvsnet_reference_state_dict(
        {k: v for k, v in sd.items() if "num_batches" not in k}, sd)
    assert all(torch.equal(bare[k], sd[k]) for k in sd)

    bad = dict(blob["model"])
    bad["module.feature.extra.weight"] = torch.zeros(3)
    with pytest.raises(KeyError, match="feature.extra.weight"):
        transmvsnet_reference_state_dict(bad, sd)
    bad = dict(blob["model"])
    bad["module.feature.inner1.bias"] = torch.zeros(5)
    with pytest.raises(ValueError, match="feature.inner1.bias"):
        transmvsnet_reference_state_dict(bad, sd)
    bad = dict(blob["model"])
    del bad["module.DepthNet.pixel_wise_net.conv2.bias"]
    with pytest.raises(KeyError, match="pixel_wise_net.conv2.bias"):
        transmvsnet_reference_state_dict(bad, sd)


@pytest.mark.parametrize("triptych", [False, True])
def test_write_prediction_matches_jax(jax_model, port_model, tmp_path,
                                      triptych):
    """The depth and confidence PNGs of the port's ``write_prediction``
    equal the JAX package's within ``PNG_LSB`` (depth at decisive pixels),
    and the facescape triptych branch writes the same image. Depth ÷ 1 so
    one unit is 1e-4 of depth."""
    _, infer, _ = jax_model
    sample = toy_sample()
    sd = {k: v.numpy() for k, v in port_model.state_dict().items()}
    jv = convert_transmvsnet(sd)
    ds = ToyDataset(sample)

    def jax_eval(imgs, projs, dvals):
        return infer(jv, imgs, projs, dvals)

    stem = "Depths/scan1/depth_map_0000_TransMVSNet"
    outs = {}
    for side in ("jax", "port"):
        root = tmp_path / side
        for rep in range(2 if triptych else 1):
            kw = dict(depth_scale=1.0, facescape_triptych=rep == 1)
            if side == "jax":
                written = j_write_prediction(None, jv, ds, root,
                                             batch_eval_fn=jax_eval, **kw)
            else:
                written = predict.write_prediction(port_model, ds, root,
                                                   device="cpu", **kw)
            assert len(written) == 1
        outs[side] = root
    keep = decisive(port_outputs(port_model, sample)["stage3"]
                    ["prob_volume"])[0]
    if triptych:
        names = ["Depths/scan1/depth_map_0000_gt_pred_conf.png"]
        assert not (outs["port"] / (stem + ".png")).exists()
        keep = np.concatenate([keep, np.ones_like(keep)], axis=1)
    else:
        names = [stem + ".png", stem + "_conf.png"]
        assert (outs["port"] / (stem + "_vis.png")).exists()
    for i, name in enumerate(names):
        a = read_depth_png(outs["port"] / name) / 1e-4
        b = read_depth_png(outs["jax"] / name) / 1e-4
        assert a.shape == b.shape == keep.shape
        mask = keep if i == 0 else np.ones_like(keep)
        assert keep.mean() > 0.9
        assert np.abs(a - b)[mask].max() <= PNG_LSB, name
