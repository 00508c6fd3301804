"""TransMVSNet training in the PyTorch port against the JAX package on the
CPU: the losses and metrics, the learning-rate schedule, train-mode
BatchNorm, the DCN sampler's hand-written backward, the train step over 3
updates and a NaN-guarded one, rematerialisation and bf16.

Inputs come from numpy seeds and go to both packages. The train step runs
at ``tests/test_mvs_train.py``'s toy size (base_channels 4, cr_base_chs 4,
ndepths 8/8/8, 3 views of 32×32) from seeded JAX variables, bridged to the
port by ``utils/convert.py:transmvsnet_flax_to_state_dict``;
after each update the JAX state is bridged again and compared in the port's
layout. Tolerances (reasons in ``tests/torch_mvs_tol.py``):
``LOSS_RTOL`` for losses, ``UPDATE_RTOL`` for each parameter's update and
``STATS_ATOL`` for BN statistics; the DCN backward's outputs within
``DCN_RTOL`` of their largest magnitude (``DCN_BF16_RTOL`` for a bf16
image gradient, ``DCN_BF16_AUTODIFF_RTOL`` against autodiff in bf16).
bf16 forwards are ``tests/test_torch_mvs_bf16.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diner_tpu.mvs import loss as jloss
from diner_tpu.mvs import train as jtrain
from diner_tpu.mvs.dcn import _bilinear_sample_pix, bilinear_sample_pix_ref
from diner_tpu.mvs.model import TransMVSNet as JTransMVSNet
from diner_tpu.mvs.model import TransMVSNetConfig as JConfig
from diner_tpu_torch.mvs import blocks, dcn, loss, train
from diner_tpu_torch.mvs.model import TransMVSNetConfig
from diner_tpu_torch.ops import dcn_cuda
from diner_tpu_torch.utils.convert import transmvsnet_flax_to_state_dict
from tests.torch_mvs_tol import (
    GRAD_RTOL,
    PWN_GRAD_RTOL,
    DCN_BF16_AUTODIFF_RTOL,
    DCN_BF16_RTOL,
    DCN_RTOL,
    LOSS_RTOL,
    STATS_ATOL,
    UPDATE_RTOL,
)

H = W = 32
V = 3
STAGES = ("stage1", "stage2", "stage3")
TOY = dict(ndepths=(8, 8, 8), cr_base_chs=(4, 4, 4), base_channels=4)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """Two intra-op threads while this module runs: the suite runs several
    workers at once on the host's cores, and more torch threads than cores
    make every op wait on the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.tensor(np.asarray(a))


# ----------------------------------------------------------------- losses

def _loss_inputs(seed, layout, zero_mask=False):
    rng = np.random.RandomState(seed)
    B, D, h, w = 2, 8, 6, 5
    logits = rng.randn(B, D, h, w).astype(np.float32) * 2
    prob = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
    dv = np.linspace(2, 6, D, dtype=np.float32)
    dv = np.broadcast_to(dv[None], (B, D)).copy()
    if layout == "bdhw":
        dv = (dv[:, :, None, None] + 0.1 * rng.randn(B, D, h, w)).astype(
            np.float32)
    gt = rng.uniform(2, 6, (B, h, w)).astype(np.float32)
    mask = rng.rand(B, h, w) > 0.3
    if zero_mask:
        mask[:] = False
    return logits, prob.astype(np.float32), dv, gt, mask


@pytest.mark.parametrize("layout", ["bd", "bdhw"])
@pytest.mark.parametrize("zero_mask", [False, True])
def test_losses_match_jax(layout, zero_mask):
    """Every function of ``mvs/loss.py`` against ``diner_tpu.mvs.loss``:
    both depth-value layouts, an all-zero mask included."""
    logits, prob, dv, gt, mask = _loss_inputs(0, layout, zero_mask)

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a, np.float64),
                                   np.asarray(b, np.float64),
                                   rtol=LOSS_RTOL, atol=1e-7)

    got = loss.entropy_loss(t(prob), t(gt), t(mask), t(dv))
    ref = jloss.entropy_loss(prob, gt, mask, dv)
    close(got[0], ref[0])
    close(got[1], ref[1])
    close(loss.info_entropy_loss(t(prob), t(logits), t(mask)),
          jloss.info_entropy_loss(prob, logits, mask))
    close(loss.smooth_l1(t(gt), t(gt[::-1].copy())),
          jloss.smooth_l1(gt, gt[::-1]))
    pred = gt + np.random.RandomState(1).randn(*gt.shape).astype(
        np.float32) * 3
    close(loss.abs_depth_error(t(pred), t(gt), t(mask)),
          jloss.abs_depth_error(pred, gt, mask))
    close(loss.abs_depth_error(t(pred), t(gt), t(mask), thresh=2.0),
          jloss.abs_depth_error(pred, gt, mask, thresh=2.0))
    close(loss.threshold_metric(t(pred), t(gt), t(mask), 2.0),
          jloss.threshold_metric(pred, gt, mask, 2.0))

    outputs, depth_ms, mask_ms = {}, {}, {}
    for i, st in enumerate(("stage3", "stage1", "stage2")):  # unsorted
        lg, pv, d, g, m = _loss_inputs(10 + i, layout, zero_mask)
        outputs[st] = {"prob_volume": pv, "depth_values": d,
                       "depth": g + 0.5}
        depth_ms[st], mask_ms[st] = g, m.astype(np.float32)
    port_out = {k: {kk: t(vv) for kk, vv in v.items()}
                for k, v in outputs.items()}
    pd = {k: t(v) for k, v in depth_ms.items()}
    pm = {k: t(v) for k, v in mask_ms.items()}
    for dlossw in (None, (0.5, 1.0, 2.0)):
        got = loss.trans_mvsnet_loss(port_out, pd, pm, dlossw)
        ref = jloss.trans_mvsnet_loss(outputs, depth_ms, mask_ms, dlossw)
        for a, b in zip(got, ref):
            close(a, b)
    got = loss.focal_loss_bld(port_out, pd, pm, 2.5, (0.5, 1.0, 2.0))
    ref = jloss.focal_loss_bld(outputs, depth_ms, mask_ms, 2.5,
                               (0.5, 1.0, 2.0))
    for a, b in zip(got, ref):
        close(a, b)


def test_warmup_schedule_matches_jax():
    """The learning rate at step 0, mid-warmup, the warmup's end and each
    milestone (and either side of it) is the JAX schedule's."""
    cfg = train.MVSTrainConfig(warmup_steps=500, milestones=(700, 900))
    jcfg = jtrain.MVSTrainConfig(warmup_steps=500, milestones=(700, 900))
    ours = train.warmup_multistep_schedule(cfg)
    ref = jtrain.warmup_multistep_schedule(jcfg)
    for step in (0, 1, 250, 499, 500, 501, 699, 700, 701, 899, 900, 2000):
        np.testing.assert_allclose(ours(step), float(ref(step)), rtol=1e-6)
    # LambdaLR stepped after each update gives update k the schedule at k
    state = train.create_mvs_state(
        train.MVSTrainConfig(model=TransMVSNetConfig(**TOY), warmup_steps=4,
                             milestones=(6,)), device="cpu")
    lrs = []
    for _ in range(8):
        lrs.append(state.optimizer.param_groups[0]["lr"])
        state.optimizer.step()
        state.scheduler.step()
    sched = jtrain.warmup_multistep_schedule(jtrain.MVSTrainConfig(
        warmup_steps=4, milestones=(6,)))
    np.testing.assert_allclose(lrs, [float(sched(k)) for k in range(8)],
                               rtol=1e-6)


# -------------------------------------------------------------- BatchNorm

@pytest.mark.parametrize("dim", [2, 3])
def test_batchnorm_matches_flax(dim):
    """Train mode: output and the running update of flax's BatchNorm
    (momentum 0.9, biased variance); eval mode: bit for bit torch's
    ``BatchNorm2d/3d`` in eval, the reference's module."""
    import flax.linen as fnn
    rng = np.random.RandomState(dim)
    shape = (2, 5) + (3, 4, 6)[:dim]
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    scale = (1 + 0.1 * rng.randn(5)).astype(np.float32)
    bias = (0.1 * rng.randn(5)).astype(np.float32)
    mean0 = (0.1 * rng.randn(5)).astype(np.float32)
    var0 = (0.5 + rng.rand(5)).astype(np.float32)
    bn = blocks.BatchNorm(5)
    with torch.no_grad():
        for name, v in (("weight", scale), ("bias", bias),
                        ("running_mean", mean0), ("running_var", var0)):
            getattr(bn, name).copy_(t(v))
    y = bn.train()(t(x))
    fbn = fnn.BatchNorm(use_running_average=False, momentum=0.9,
                        epsilon=1e-5, axis=1)
    jy, mut = fbn.apply({"params": {"scale": scale, "bias": bias},
                         "batch_stats": {"mean": mean0, "var": var0}},
                        x, mutable=["batch_stats"])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(mut["batch_stats"]["mean"]),
                               atol=STATS_ATOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(mut["batch_stats"]["var"]),
                               atol=STATS_ATOL)
    ref = (torch.nn.BatchNorm2d if dim == 2 else torch.nn.BatchNorm3d)(5)
    ref.load_state_dict(bn.state_dict())
    assert torch.equal(bn.eval()(t(x)), ref.eval()(t(x)))


# ------------------------------------------------------- the DCN sampler

def _dcn_inputs(W_, seed=0):
    rng = np.random.RandomState(seed)
    N, H_, C, P = 2, 7, 5, 33
    img = rng.randn(N, H_, W_, C).astype(np.float32)
    x = rng.uniform(-2.0, W_ + 1.0, (N, P)).astype(np.float32)
    y = rng.uniform(-2.0, H_ + 1.0, (N, P)).astype(np.float32)
    x[:, 0], y[:, 0] = 3.0, 2.0  # an exact integer position
    scale = rng.uniform(0.0, 1.0, (N, P)).astype(np.float32)
    g = rng.randn(N, P, C).astype(np.float32)
    return img, x, y, scale, g


def _jax_vjp(fn, img, x, y, scale, g):
    args = (img, x, y) + ((scale,) if scale is not None else ())

    def f(*a):
        return fn(*a) if scale is not None else fn(*a, None)
    out, vjp = jax.vjp(f, *args)
    return out, vjp(g)


@pytest.mark.parametrize("W_", [8, 9])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_scale", [True, False])
def test_dcn_function_matches_jax(W_, dtype, with_scale):
    """The port's sampler (``DCN_CUSTOM_VJP``: the autograd Function whose
    CPU backward is ``bilinear_sample_pix_bwd_plain``) against JAX's
    custom VJP ``_bilinear_sample_pix`` (called directly; no JAX flag
    changes) and autodiff of ``bilinear_sample_pix_ref``: the value and
    the gradients of img, x, y and scale."""
    img, x, y, scale, g = _dcn_inputs(W_)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = getattr(torch, dtype)
    s = scale if with_scale else None
    j_in = (jnp.asarray(img).astype(jdt), jnp.asarray(x), jnp.asarray(y),
            None if s is None else jnp.asarray(s))
    jg = jnp.asarray(g).astype(jdt)
    out_c, grads_c = _jax_vjp(_bilinear_sample_pix, *j_in, jg)
    out_r, grads_r = _jax_vjp(bilinear_sample_pix_ref, *j_in, jg)

    p_in = [t(img).to(tdt), t(x), t(y)] + ([t(s)] if s is not None else [])
    for a in p_in:
        a.requires_grad_()
    assert dcn.DCN_CUSTOM_VJP
    out = dcn.bilinear_sample_pix(*p_in[:3],
                                  p_in[3] if s is not None else None)
    grads = torch.autograd.grad(out, p_in, t(g).to(tdt))

    def f64(a):
        if isinstance(a, torch.Tensor):
            return a.detach().float().numpy().astype(np.float64)
        return np.asarray(jnp.asarray(a).astype(jnp.float32), np.float64)

    def err(a, b):
        a, b = f64(a), f64(b)
        return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)

    assert err(out.detach(), out_c) == 0.0  # the same corner sums
    for i, name in enumerate(("img", "x", "y", "scale")[:len(p_in)]):
        tol = DCN_BF16_RTOL if (name == "img" and dtype == "bfloat16") \
            else DCN_RTOL
        assert err(grads[i], grads_c[i]) <= tol, (name, "custom VJP")
        tol_r = DCN_RTOL if dtype == "float32" else DCN_BF16_AUTODIFF_RTOL
        assert err(grads[i], grads_r[i]) <= tol_r, (name, "autodiff")


def test_dcn_backward_plain_is_autograd_of_the_gathers():
    """``DCN_CUSTOM_VJP = False`` (autograd of the corner gathers) and
    the Function give the same f32 gradients, and the wrapper raises for a
    CUDA-less launch instead of falling back."""
    img, x, y, scale, g = _dcn_inputs(8, seed=3)
    ins = [t(a).requires_grad_() for a in (img, x, y, scale)]
    res = []
    for flag in (True, False):
        dcn.DCN_CUSTOM_VJP = flag
        try:
            out = dcn.bilinear_sample_pix(*ins)
            res.append(torch.autograd.grad(out, ins, t(g)))
        finally:
            dcn.DCN_CUSTOM_VJP = True
    for a, b in zip(*res):
        assert (a - b).abs().max() <= DCN_RTOL * b.abs().max()
    with pytest.raises(ValueError, match="CUDA"):
        dcn_cuda.bilinear_sample_pix_bwd_kernel(
            t(img), t(x), t(y), t(scale), t(g))


def test_dcn_backward_f32_canvas_resolves_the_weight_rounding():
    """``f32_d_img`` returns the image gradient's f32 canvas, whose cast is
    the image-dtype gradient. For a bf16 image the canvas is the sum of
    g times the forward's weights rounded to bf16: within ``DCN_RTOL`` of
    that sum taken here corner by corner, and further than 1e-4 of its
    largest from the sum with unrounded weights, so a comparison of
    canvases at 1e-5 (``chip_smoke.py``'s ``kernel_dcn_bwd``) sees the
    rounding where one of bf16 outputs would not."""
    img, x, y, scale, g = _dcn_inputs(9, seed=4)
    ti, tx, ty, ts = t(img).bfloat16(), t(x), t(y), t(scale)
    tg = t(g).bfloat16()
    canvas = dcn_cuda.bilinear_sample_pix_bwd_plain(ti, tx, ty, ts, tg,
                                                    f32_d_img=True)
    cast = dcn_cuda.bilinear_sample_pix_bwd_plain(ti, tx, ty, ts, tg)
    assert canvas[0].dtype == torch.float32 and cast[0].dtype == ti.dtype
    assert torch.equal(canvas[0].to(ti.dtype), cast[0])
    for a, b in zip(canvas[1:], cast[1:]):
        assert torch.equal(a, b)

    N, Hi, Wi, C = ti.shape
    corners, _ = dcn_cuda.corner_meta(ti.shape, tx, ty, ts)

    def by_hand(rounded):
        acc = torch.zeros((N * Hi * Wi, C))
        for idx, w, _, _ in corners:
            wq = w.bfloat16().float() if rounded else w
            acc.index_add_(0, idx.reshape(-1),
                           (tg.float() * wq[..., None]).reshape(-1, C))
        return acc.reshape(N, Hi, Wi, C)

    top = canvas[0].abs().max()
    assert (canvas[0] - by_hand(True)).abs().max() <= DCN_RTOL * top
    assert (canvas[0] - by_hand(False)).abs().max() > 1e-4 * top


# ------------------------------------------------------------ train step

def toy_batch(seed=1, nan=False):
    """One batch of 1 in the datasets' layout (numpy): 3 views of a seeded
    scene, cameras 0.1 apart, 48 hypotheses 2..6, depth 4 with a ring of
    masked-out pixels; ``nan`` puts a NaN in the first image."""
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
        projs[stage] = pm[None]
    imgs = rng.rand(1, V, H, W, 3).astype(np.float32)
    if nan:
        imgs[0, 0, 3, 3, 0] = np.nan
    depth, mask = {}, {}
    for stage, s in zip(STAGES, (4, 2, 1)):
        h, w = H // s, W // s
        depth[stage] = (4.0 + 0.5 * rng.rand(1, h, w)).astype(np.float32)
        m = np.ones((1, h, w), np.float32)
        m[:, 0] = 0
        mask[stage] = m
    return {"imgs": imgs, "proj_matrices": projs, "depth": depth,
            "mask": mask,
            "depth_values": np.linspace(2, 6, 48, dtype=np.float32)[None]}


def _jax_batch(b):
    return jax.tree_util.tree_map(jnp.asarray, b)


def jax_variables(model, batch, seed=5):
    """Seeded variables of the JAX ``model`` for ``batch``'s shapes, drawn
    with numpy (no JAX init runs): fan-in scaled kernels, BN affines and
    statistics near 1 / 0, small DCN offset/mask convolutions."""
    b = _jax_batch(batch)
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), b["imgs"], b["proj_matrices"],
        b["depth_values"], train=False))
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = "/".join(getattr(k, "key", str(k)) for k in path)
        shape = tuple(x.shape)
        if name.endswith("/var"):
            v = 0.5 + rng.rand(*shape)
        elif name.endswith(("/mean", "/bias")):
            v = 0.1 * rng.randn(*shape)
        elif name.endswith("/scale"):
            v = 1 + 0.1 * rng.randn(*shape)
        elif "conv_offset_mask" in name:
            v = 0.05 * rng.randn(*shape)
        else:
            v = rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))
        return jnp.asarray(np.asarray(v, np.float32))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _port_state_dict(jstate):
    return transmvsnet_flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, {"params": jstate["params"],
                     "batch_stats": jstate["batch_stats"]}))


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX package's state before and after each of 4 jitted train
    steps (3 batches, then a NaN batch) at the toy size, in the port's
    layout: parameters and BN statistics, and Adam's first and second
    moments and count. flax's BatchNorm is run with two-pass statistics
    here, the port's (its default E[x²] − E[x]² loses most digits where a
    U-Net level normalises a handful of values: stage 2's deepest levels
    see 4 per channel at 32×32, and the gradients upstream of them then
    differ by a few per cent between the two formulas)."""
    import flax.linen.normalization as fnorm
    two_pass = fnorm._compute_stats

    def stats(*args, **kwargs):
        kwargs["use_fast_variance"] = False
        return two_pass(*args, **kwargs)

    cfg = jtrain.MVSTrainConfig(model=JConfig(**TOY), warmup_steps=2,
                                milestones=(1000,))
    batches = [toy_batch(1), toy_batch(2), toy_batch(3),
               toy_batch(4, nan=True)]
    model = JTransMVSNet(cfg=cfg.model)
    variables = jax_variables(model, batches[0])
    # create_mvs_state's state, from drawn variables (its init runs the
    # model op by op, a minute of the CPU for values any draw gives)
    tx = optax.adam(jtrain.warmup_multistep_schedule(cfg))
    state = {"params": variables["params"],
             "batch_stats": variables["batch_stats"],
             "opt_state": tx.init(variables["params"]),
             "step": jnp.zeros((), jnp.int32)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fnorm, "_compute_stats", stats)
        step_fn = jax.jit(jtrain.make_mvs_train_step(model, cfg, tx))
        states, metrics, adam = [_port_state_dict(state)], [], []
        for b in batches:
            state, m = step_fn(state, _jax_batch(b))
            states.append(_port_state_dict(state))
            metrics.append({k: float(v) for k, v in m.items()})
            moments = state["opt_state"][0]
            adam.append({
                "count": int(moments.count),
                **{k: _port_state_dict({"params": getattr(moments, k),
                                        "batch_stats": state["batch_stats"]})
                   for k in ("mu", "nu")}})
    return batches, states, metrics, adam


# PixelwiseNet's parameters: its max over the depth planes sends the
# gradient to one plane, which f32 rounding picks where two planes nearly tie
PWN = "DepthNet.pixel_wise_net."

# biases right before a train-mode BN (the DCN heads' first two DCNs):
# their gradient is 0 in exact arithmetic, rounding noise in either package,
# and Adam scales that noise up to an update of up to lr; held to be noise
ZERO_GRAD = tuple(f"feature.out{n}.{i}.bias" for n in (1, 2, 3)
                  for i in (1, 4))


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def test_train_step_matches_jax(jax_steps):
    """3 updates from seeded JAX variables, each from the
    JAX state before it (parameters, BN statistics, Adam's moments; so a
    component whose sign f32 rounding picked differently in one step does
    not move the next step's inputs): per step the
    loss, depth loss and entropy; each parameter's gradient (the JAX one
    recovered from Adam's first moments) and Adam's two moments within
    ``GRAD_RTOL`` of their norms (PixelwiseNet's ``PWN_GRAD_RTOL``), the
    count; after each update every
    parameter's update within ``UPDATE_RTOL`` of Adam's update from those
    moments at the schedule's learning rate, and of the JAX update where
    the JAX moment is above 1e-2 of its largest (Adam divides by the root
    mean square, so elsewhere f32 rounding may pick the sign of ±lr), and
    the BN statistics within ``STATS_ATOL``. Then a batch with a NaN:
    ``skipped`` 1 as in JAX, zero gradients, and the moments, count and
    parameters still stepped as optax steps them."""
    batches, states, metrics, adam = jax_steps
    cfg = train.MVSTrainConfig(model=TransMVSNetConfig(**TOY),
                               warmup_steps=2, milestones=(1000,))
    state = train.create_mvs_state(cfg, seed=0, device="cpu")
    state.model.load_state_dict(states[0])
    step = train.make_mvs_train_step(state, cfg)
    params = dict(state.model.named_parameters())
    b1 = 0.9
    sched = jtrain.warmup_multistep_schedule(jtrain.MVSTrainConfig(
        warmup_steps=2, milestones=(1000,)))
    lrs = [float(sched(k)) for k in range(len(batches))]
    for k, b in enumerate(batches):
        if k:  # each step from JAX's state before it: no drift carried over
            state.model.load_state_dict(states[k])
            with torch.no_grad():
                for name, p in params.items():
                    st = state.optimizer.state[p]
                    st["exp_avg"].copy_(adam[k - 1]["mu"][name])
                    st["exp_avg_sq"].copy_(adam[k - 1]["nu"][name])
        before = {n: v.clone() for n, v in state.model.state_dict().items()}
        got = [float(v) for v in step(train.batch_to_device(b, "cpu"))]
        ref = metrics[k]
        assert got[3] == ref["skipped"] == (1.0 if k == 3 else 0.0)
        if k < 3:
            np.testing.assert_allclose(
                got[:3], [ref["loss"], ref["depth_loss"], ref["entropy"]],
                rtol=LOSS_RTOL, atol=0, err_msg=f"step {k + 1}")
        opt = state.optimizer.state
        assert {int(opt[p]["step"]) for p in params.values()} == \
            {adam[k]["count"]} == {k + 1}
        after = state.model.state_dict()
        for name, p in params.items():
            tol = PWN_GRAD_RTOL if name.startswith(PWN) else GRAD_RTOL
            mu0 = adam[k - 1]["mu"][name] if k else torch.zeros_like(p)
            jgrad = (adam[k]["mu"][name] - b1 * mu0) / (1 - b1)
            if k == 3:
                assert not p.grad.any(), name
            elif name not in ZERO_GRAD:
                assert _rel(p.grad, jgrad) <= tol, (k + 1, name)
            else:
                assert p.grad.abs().max() <= 1e-6 * max(
                    g.grad.abs().max() for g in params.values())
                continue
            # the second moment holds squares: twice the relative error
            for ours, theirs, t in (("exp_avg", "mu", tol),
                                    ("exp_avg_sq", "nu", 2 * tol)):
                assert _rel(opt[p][ours], adam[k][theirs][name]) <= t, \
                    (k + 1, name, ours)
            # the update is Adam's from these moments at the schedule's lr
            t_ = k + 1
            upd = after[name] - before[name]
            adam_upd = -lrs[k] * (opt[p]["exp_avg"] / (1 - b1 ** t_)) / (
                (opt[p]["exp_avg_sq"] / (1 - 0.999 ** t_)).sqrt() + 1e-8)
            assert _rel(upd, adam_upd) <= UPDATE_RTOL, (k + 1, name)
            # and JAX's where the gradient's sign is not left to rounding
            jmu = adam[k]["mu"][name]
            well = jmu.abs() > 1e-2 * jmu.abs().max()
            jupd = states[k + 1][name] - states[k][name]
            assert _rel(upd[well], jupd[well]) <= UPDATE_RTOL, (k + 1, name)
        for name, v in states[k + 1].items():
            if k < 3 and name.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(after[name].numpy(), v.numpy(),
                                           atol=STATS_ATOL, err_msg=name)
    assert state.step == 4


# ------------------------------------------------------------------ remat

def _grads_and_stats(remat, remat_feature, batch):
    cfg = TransMVSNetConfig(**TOY, remat=remat, remat_feature=remat_feature)
    st = train.create_mvs_state(train.MVSTrainConfig(model=cfg), seed=3,
                                device="cpu")
    model = st.model.train()
    b = train.batch_to_device(batch, "cpu")
    out = model(b["imgs"], b["proj_matrices"], b["depth_values"])
    total = loss.trans_mvsnet_loss(out, b["depth"], b["mask"],
                                   (0.5, 1.0, 2.0))[0]
    total.backward()
    grads = {n: p.grad.clone() for n, p in model.named_parameters()}
    stats = {n: v.clone() for n, v in model.state_dict().items()
             if "running" in n or "num_batches" in n}
    return float(total), grads, stats


@pytest.mark.parametrize("remat_feature", [True, False],
                         ids=["full", "selective"])
def test_remat_changes_no_gradient_or_statistic(remat_feature):
    """``remat`` (full: FeatureNet too; selective: the sweeps and U-Nets)
    gives the loss, gradients and BN statistics of the plain graph, each BN
    updated once per call (the recomputation in the backward leaves them
    alone)."""
    batch = toy_batch(5)
    l0, g0, s0 = _grads_and_stats(False, True, batch)
    l1, g1, s1 = _grads_and_stats(True, remat_feature, batch)
    assert l0 == l1
    for n in g0:
        assert torch.equal(g0[n], g1[n]), n
    for n in s0:
        assert torch.equal(s0[n], s1[n]), n
    # one update per call of each BN: PixelwiseNet's run once per source
    # view, as flax's do; every other BN once
    for n, v in s1.items():
        if n.endswith("num_batches_tracked"):
            assert int(v) == (V - 1 if "pixel_wise_net" in n else 1), n
