"""Resuming in the port from the JAX package's orbax train states:
``export_jax_checkpoint.py`` (JAX side) then
``diner_tpu_torch/train/import_jax.py`` (torch side).

- DINER: a 24×24 JAX state after 2 steps (the VGG and antibias losses on,
  so it holds ``vgg_params``) is saved with
  ``diner_tpu/train/checkpoint.py:save_checkpoint``, exported and imported
  through the CLI. The imported parameters, statistics, Adam moments and
  counts equal the bridged orbax state exactly. Then one port step from
  the imported checkpoint is held to one JAX step from the orbax state on
  the same batch and draws: losses 1e-5 relative; the parameters within
  1e-5 (an Adam step moves an element by at most ≈ lr = 5e-4, and by
  lr · |Δg| / ε where |g| is near ε); both moments within 1e-4 of their
  norms (the step's gradients agree to 1e-4 of their norms,
  ``tests/test_torch_train.py``). The port's ``Trainer`` resumes from the
  imported directory at the JAX step count and takes the next step.
- MVS: a TransMVSNet state (a seeded port model's weights in the flax
  layout, one optax update of seeded gradients) at
  schedule counts 9,999 and 10,000, on both sides of the first milestone:
  the imported learning rate is optax's schedule there, and one more
  update of the same gradients moves the parameters as optax's does
  (1e-6).
- NOVEL, NOVEL_PE and KeypointNeRF: the state after one Adam update of
  seeded gradients (optax's moments written out; their forward and step
  are held to JAX in their own test files) imports to the bridged
  parameters and moments exactly.
- An unknown leaf raises ``KeyError``.
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

import export_jax_checkpoint
from diner_tpu.data.loader import DataLoader as JDataLoader
from diner_tpu.models.keypointnerf.train import (
    build_keypointnerf_run_config as j_kpn_run_config)
from diner_tpu.models.keypointnerf.train import (
    create_keypointnerf_state as j_create_kpn_state)
from diner_tpu.models.novel.train import (
    build_novel_run_config as j_novel_run_config)
from diner_tpu.models.novel.train import create_novel_state as j_novel_state
from diner_tpu.mvs import train as jmvs
from diner_tpu.train import checkpoint as j_ckpt
from diner_tpu.train.config import load_train_config as j_load_train_config
from diner_tpu.models.pixelnerf import PixelNeRF as JPixelNeRF
from diner_tpu.train.diner import DinerState
from diner_tpu.train.diner import make_train_step as j_make_train_step
from diner_tpu.train.diner import select_pixels as j_select_pixels
from diner_tpu.utils.torch_convert import convert_transmvsnet
from diner_tpu_torch.losses import VGG19Features
from diner_tpu_torch.train import checkpoint as ckpt_lib
from diner_tpu_torch.train import import_jax
from diner_tpu_torch.train.config import load_train_config
from diner_tpu_torch.train.loop import Trainer
from diner_tpu_torch.utils import convert
from test_torch_parallel import vgg_flax_params
from test_torch_render import SRC

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def no_pretrained(tmp_path, monkeypatch):
    """Seeded substitutes for every pretrained network; JSONL logs only."""
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path / "none"))
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _save_and_export(state, ckpt_dir, step):
    """orbax → ``.npz`` through the export script; returns its path."""
    path = j_ckpt.save_checkpoint(ckpt_dir, state, step=step)
    npz = Path(ckpt_dir) / f"state_{step}.npz"
    export_jax_checkpoint.main([path, str(npz)])
    return npz


def _seeded_like(shapes, seed):
    """numpy weights on a tree of shapes: fan-in scaled kernels, positive
    variances, scales near 1, small biases and means."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        name = getattr(path[-1], "key", "")
        shape = tuple(x.shape)
        if name == "var":
            v = rng.uniform(0.5, 2.0, shape)
        elif name in ("scale", "g"):
            v = 1 + 0.1 * rng.standard_normal(shape)
        elif name in ("bias", "mean", "ani_al"):
            v = 0.1 * rng.standard_normal(shape)
        else:
            v = rng.standard_normal(shape) / np.sqrt(
                max(np.prod(shape[:-1]), 1))
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: rng.standard_normal(p.shape).astype(np.float32), params)


def _adam_after_one_update(params, seed):
    """``optax.adam(lr)``'s state after one update of seeded gradients g:
    count 1, mu = (1 − β1)·g, nu = (1 − β2)·g² (optax's defaults), then
    the learning rate's empty state."""
    g = _grads(params, seed)
    mu = jax.tree_util.tree_map(lambda x: np.float32(0.1) * x, g)
    nu = jax.tree_util.tree_map(lambda x: np.float32(0.001) * x * x, g)
    return (optax.ScaleByAdamState(count=np.int32(1), mu=mu, nu=nu),
            optax.EmptyState())


def _moments(opt_state):
    adam = opt_state[0] if isinstance(opt_state, (list, tuple)) else \
        opt_state
    return adam.mu, adam.nu, int(adam.count)


def _assert_imported(saved, bridge, params, stats, opt_state, step):
    """A saved port state equals the bridged orbax state exactly."""
    sd = bridge({"params": params, "batch_stats": stats})
    assert sorted(saved["model"]) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(saved["model"][k], v), k
    mu, nu, count = _moments(opt_state)
    mu = bridge({"params": mu, "batch_stats": stats})
    nu = bridge({"params": nu, "batch_stats": stats})
    names = [k for k in saved["model"] if k in mu and not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    state = saved["optimizer"]["state"]
    assert len(state) == len(names)
    # the optimizer's state is keyed by the parameters' order
    for i, name in enumerate(names):
        assert float(state[i]["step"]) == count
        assert torch.equal(state[i]["exp_avg"], mu[name]), name
        assert torch.equal(state[i]["exp_avg_sq"], nu[name]), name
    assert saved["step"] == step


# ------------------------------------------------------------------ DINER

def _diner_yaml(tmp_path):
    """configs/train_synthetic.yaml at 24×24 with the production losses on
    an 8×8 patch and a narrow model."""
    raw = yaml.safe_load((ROOT / "configs/train_synthetic.yaml").read_text())
    raw["logger"]["kwargs"]["save_dir"] = str(tmp_path / "out")
    for stage in ("train", "val"):
        raw["data"][stage]["dataset"]["kwargs"].update(n=4, H=24, W=24)
    raw["nerf"]["kwargs"]["encoder_conf"]["kwargs"]["num_layers"] = 2
    raw["nerf"]["kwargs"]["mlp_fine_conf"]["kwargs"]["d_hidden"] = 32
    raw["renderer"]["kwargs"].update(n_samples=8, n_depth_candidates=32,
                                     n_gaussian=2, ray_chunk=192)
    raw["optimizer"]["kwargs"].update(w_vgg=0.1, vgg_spatch=8,
                                      w_antibias=1.0)
    raw["trainer"]["kwargs"]["val_check_interval"] = -1
    p = tmp_path / "diner.yaml"
    p.write_text(yaml.safe_dump(raw))
    return p


def _draws(jcfg, batch, key):
    """The step's pixel indices and noise, as JAX draws them from ``key``
    (``k_pix, k_render = split(key)``)."""
    @jax.jit
    def draw(b, key):
        k_pix, k_render = jax.random.split(key)
        pix = j_select_pixels(jcfg, b, k_pix)
        k_coarse, k_gauss, k_fill = jax.random.split(k_render, 3)
        shape = pix.shape
        rc = jcfg.renderer
        return (pix, jax.random.uniform(k_coarse,
                                        shape + (rc.n_depth_candidates,)),
                jax.random.normal(k_gauss, shape + (rc.n_gaussian,)),
                jax.random.uniform(k_fill, shape + (rc.n_samples,)))

    pix, *noise = (np.array(a) for a in draw(batch, key))
    return pix, tuple(noise)


def _diner_state(jcfg, jbatch, vgg_params):
    """A JAX DinerState at step 0: seeded numpy weights on
    ``jax.eval_shape``'s tree of the model (flax's own init compiles for
    ~10 s), optax's Adam state."""
    model = JPixelNeRF(cfg=jcfg.nerf)
    SB = jbatch["src_rgbs"].shape[0]
    shapes = jax.eval_shape(lambda k: model.init(
        k, *(jbatch[k_] for k_ in SRC), jnp.zeros((SB, 8, 3)),
        jnp.zeros((SB, 8, 3))), jax.random.PRNGKey(0))
    params = _seeded_like(shapes["params"], 0)
    return model, DinerState(
        params=params, batch_stats=_seeded_like(shapes["batch_stats"], 1),
        opt_state=jax.jit(optax.adam(jcfg.lr).init)(params),
        vgg_params=vgg_params, step=jnp.zeros((), jnp.int32))


def test_diner_state_imports_and_steps_as_jax(tmp_path):
    yml = _diner_yaml(tmp_path)
    run = j_load_train_config(yml)
    jcfg = run.diner
    batch = {k: v for k, v in next(iter(JDataLoader(
        run.build_dataset("train"), batch_size=2, num_workers=0))).items()
        if isinstance(v, np.ndarray)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    vgg_params = vgg_flax_params()
    model, state = _diner_state(jcfg, jbatch, vgg_params)
    step_fn = jax.jit(j_make_train_step(model, jcfg))
    for i in range(2):
        state, _ = step_fn(state, jbatch, jax.random.PRNGKey(10 + i))
    npz = _save_and_export(state, tmp_path / "jax", 2)
    restored = j_ckpt.restore_checkpoint(tmp_path / "jax" / "step_00000002",
                                         state)

    run_dir = load_train_config(yml).run_dir
    import_jax.main([str(npz), str(yml), "DINER",
                     str(run_dir / "checkpoints"), "--device", "cpu"])
    path = run_dir / "checkpoints" / "step_00000002"
    saved = ckpt_lib.load_state(path)
    _assert_imported(saved, convert.flax_to_state_dict, _np(state.params),
                     _np(state.batch_stats), _np(state.opt_state), 2)

    # one step each from the orbax state and from the imported checkpoint
    key = jax.random.PRNGKey(12)
    j_state, j_metrics = step_fn(restored, jbatch, key)
    pix, noise = _draws(jcfg, jbatch, key)
    t_state, _ = import_jax.build_state("DINER", yml, device="cpu")
    t_state.vgg = VGG19Features()
    t_state.vgg.load_state_dict(convert.flax_to_state_dict(
        {"params": vgg_params}))
    ckpt_lib.restore_checkpoint(path, t_state)
    metrics = t_state(batch, noise=noise, pix_idcs=pix)
    assert t_state.step == 3
    for k, v in j_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5,
                                   err_msg=k)
    ref = convert.flax_to_state_dict({"params": _np(j_state.params),
                                      "batch_stats": _np(
                                          j_state.batch_stats)})
    got = t_state.model.state_dict()
    for k, v in ref.items():
        atol = 1e-4 if k.endswith(("running_mean", "running_var")) else 1e-5
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=atol,
                                   rtol=0, err_msg=k)
    mu, nu, count = _moments(_np(j_state.opt_state))
    assert count == 3
    for name, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        ref = convert.flax_to_state_dict({"params": tree})
        for n, p in t_state.model.named_parameters():
            m = t_state.optimizer.state[p]
            assert float(m["step"]) == 3
            assert float((m[name] - ref[n]).abs().max()) <= \
                1e-4 * float(ref[n].norm()) + 1e-30, (name, n)

    # the trainer resumes from the imported checkpoint at step 2
    trainer = Trainer(load_train_config(yml), num_workers=0, device="cpu")
    assert trainer._init_state(batch).step == 2
    resumed = trainer.fit(max_steps=3)
    assert resumed.step == 3
    assert ckpt_lib.load_state(run_dir / "checkpoints" /
                               "step_00000003")["step"] == 3


# -------------------------------------------------------------------- MVS

@pytest.fixture(scope="module")
def mvs_state():
    """A JAX TransMVSNet state at the default MVSTrainConfig after one
    optax update: its variables are a seeded port model's, in the flax
    layout (``diner_tpu/utils/torch_convert.py:convert_transmvsnet``)."""
    from diner_tpu_torch.mvs.train import MVSTrainConfig, create_mvs_state
    cfg = jmvs.MVSTrainConfig()
    model = create_mvs_state(MVSTrainConfig(), seed=1, device="cpu").model
    variables = convert_transmvsnet(
        {k: v.numpy() for k, v in model.state_dict().items()})
    params, stats = variables["params"], variables["batch_stats"]
    tx = optax.adam(jmvs.warmup_multistep_schedule(cfg))
    update = jax.jit(tx.update)  # one compile for both counts
    grads = _grads(params, 3)
    _, opt_state = update(grads, jax.jit(tx.init)(params), params)
    return cfg, update, params, stats, _np(opt_state), grads


@pytest.mark.parametrize("count", [9999, 10000])
def test_mvs_schedule_count_imports(tmp_path, mvs_state, count):
    cfg, update, params, stats, opt_state, grads = mvs_state
    adam, sched = opt_state
    opt_state = (adam._replace(count=np.int32(count)),
                 sched._replace(count=np.int32(count)))
    state = {"params": params, "batch_stats": stats,
             "opt_state": opt_state, "step": np.int32(count)}
    npz = _save_and_export(state, tmp_path / "jax", count)
    yml = tmp_path / "mvs.yaml"
    yml.write_text("")  # MVSTrainConfig's defaults
    path = import_jax.import_jax(npz, yml, "MVS", tmp_path / "port",
                                 device="cpu")
    saved = ckpt_lib.load_state(path)

    def bridge(v):
        return convert.transmvsnet_flax_to_state_dict(v)

    _assert_imported(saved, bridge, params, stats, opt_state, count)
    lr = float(jmvs.warmup_multistep_schedule(cfg)(count))
    assert lr == pytest.approx(1e-3 if count < 10000 else 5e-4, rel=1e-7)
    assert saved["scheduler"]["last_epoch"] == count
    assert [g["lr"] for g in saved["optimizer"]["param_groups"]] == \
        pytest.approx([lr], rel=1e-7)
    # the next update: the same gradients through optax, and through torch
    # Adam restored from the checkpoint
    updates, _ = update(grads, opt_state, params)
    ref = bridge({"params": _np(optax.apply_updates(params, updates)),
                  "batch_stats": stats})
    g = bridge({"params": grads, "batch_stats": stats})
    names = [k for k in saved["model"] if k in g and not k.endswith(
        ("running_mean", "running_var", "num_batches_tracked"))]
    weights = [saved["model"][n].clone().requires_grad_() for n in names]
    adam = torch.optim.Adam(weights)
    adam.load_state_dict(saved["optimizer"])
    for n, w in zip(names, weights):
        w.grad = g[n].clone()
    adam.step()
    for n, w in zip(names, weights):
        np.testing.assert_allclose(w.detach().numpy(), ref[n].numpy(),
                                   atol=1e-6, rtol=0, err_msg=n)


# ------------------------------------------- NOVEL, NOVEL_PE, KeypointNeRF

def _novel_yaml(tmp_path):
    from test_torch_novel import _novel_cfg
    return _novel_cfg(tmp_path)


def _kpn_yaml(tmp_path):
    from test_torch_keypointnerf_step import _kpn_yaml as kpn_yaml
    return kpn_yaml(tmp_path)


def _first_batch(run):
    sample = JDataLoader(run.build_dataset("train"), batch_size=1,
                         num_workers=0)
    return {k: jnp.asarray(v) for k, v in next(iter(sample)).items()
            if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("kind", ["NOVEL", "NOVEL_PE", "KeypointNeRF"])
def test_novel_and_keypointnerf_states_import(tmp_path, kind):
    if kind == "KeypointNeRF":
        yml = _kpn_yaml(tmp_path)
        run = j_load_train_config(yml, model_name=kind)
        jcfg = j_kpn_run_config(run)
        shapes = jax.eval_shape(
            lambda k: j_create_kpn_state(jcfg, k, _first_batch(run))[1],
            jax.random.PRNGKey(0))
        p_shapes, s_shapes = shapes["params"], {}
        bridge = convert.keypointnerf_flax_to_state_dict
    else:
        yml = _novel_yaml(tmp_path)
        run = j_load_train_config(yml, model_name=kind)
        jcfg = j_novel_run_config(run, use_pe=kind == "NOVEL_PE")
        shapes = jax.eval_shape(
            lambda k: j_novel_state(jcfg, k, _first_batch(run))[1],
            jax.random.PRNGKey(0))
        p_shapes, s_shapes = shapes.params, shapes.batch_stats
        bridge = convert.novel_flax_to_state_dict
    params = _seeded_like(p_shapes, 5)
    stats = _seeded_like(s_shapes, 6)
    opt_state = _adam_after_one_update(params, 7)
    state = {"params": params, "opt_state": opt_state, "step": np.int32(1)}
    if stats:
        state["batch_stats"] = stats
    npz = _save_and_export(state, tmp_path / "jax", 1)
    path = import_jax.import_jax(npz, yml, kind, tmp_path / "port",
                                 device="cpu")
    _assert_imported(ckpt_lib.load_state(path), bridge, params, stats,
                     opt_state, 1)


# ------------------------------------------------------------ unknown leaf

def test_unknown_leaf_raises(tmp_path):
    yml = _diner_yaml(tmp_path)
    state, bridge = import_jax.build_state("DINER", yml, device="cpu")
    params = {"mlp": {"lin_out": {"kernel": np.zeros((33, 4), np.float32)}}}
    tree = {"params": params, "opt_state": {"0": {
        "count": np.int32(1), "mu": params, "nu": params}},
        "step": np.int32(1)}
    with pytest.raises(KeyError, match="no leaf for"):
        import_jax.load_jax_state(state, bridge, tree)
    full = {"params": _flax_params(state), "batch_stats": {},
            "opt_state": {"0": {"count": np.int32(1)}}, "step": np.int32(1)}
    full["params"]["mlp"]["lin_out"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unknown params leaf"):
        import_jax.load_jax_state(state, bridge, full)
    with pytest.raises(KeyError, match="unknown train-state entry"):
        import_jax.load_jax_state(state, bridge, {**tree, "ema": params})
    with pytest.raises(KeyError, match="opt_state"):
        import_jax.adam_state({"0": {"count": np.int32(1), "trace": {}}})


def _flax_params(state):
    """A flax-layout params tree with the port model's shapes (kernels
    back to (…, I, O))."""
    tree: dict = {}
    for name, p in state.model.named_parameters():
        *mods, leaf = name.split(".")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        v = p.detach().numpy()
        if leaf == "weight" and v.ndim == 4:
            node["kernel"] = v.transpose(2, 3, 1, 0)
        elif leaf == "weight" and v.ndim == 2:
            node["kernel"] = v.T
        else:
            node["scale" if leaf == "weight" else leaf] = v
    return tree
