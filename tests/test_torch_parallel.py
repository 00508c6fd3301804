"""The port's ('data', 'rays') mesh (``diner_tpu_torch/parallel/``) on the
CPU with gloo.

Two processes (``tests/torch_parallel_worker.py``) take DINER train
steps over a mesh of (2, 1) and of (1, 2) on a fixture with every term the
mesh must get right: train-mode BN (two scenes with different textures),
the VGG and antibias losses on a 16×16 patch (``w_vgg=0.1``,
``w_antibias=1.0``), SB = 2. The fixture's weights are a perturbed flax
init bridged to the port, and its pixel indices and noise are what JAX
draws from its key, so one batch and one set of draws feed three steps:

- the port's one-process ``TrainStep``, which each rank's mesh step must
  equal: ``total`` within rtol 2e-4 (as ``tests/test_parallel.py:54``);
  every gradient within 1e-4 of its norm, Adam's two moments likewise (the
  ranks sum in another order: partial sums of the BN statistics, the
  gradient all-reduce); each parameter after Adam within 1e-6 + lr · |Δg|
  / ε of the reference, Δg the two steps' gradient difference at that
  element (Adam's first step moves an element by lr · g / (|g| + ε), whose
  slope in g is at most 1 / ε: where |g| is near ε = 1e-8 a gradient
  that agrees to 1e-10 may move it 1e-6 apart, and a flipped sign 2 · lr
  apart), and within ``PARAM_LR_FRAC`` · lr (the 2 · lr of a flipped
  sign is what a fault shows); the running statistics within 1e-5; the two
  ranks' parameters equal. A second step from each side's weights and
  Adam state, on the same draws, where Adam's moments are not zero, is
  held to the one-process second step alike (all but the first-step
  bound);
- the JAX one-device step (``diner_tpu/train/diner.py``), which the (1, 2)
  step must equal as the one-process port step does in
  ``tests/test_torch_train.py``: losses 1e-5 relative, gradients 1e-4 of
  their norm, running statistics 1e-4 (flax's one-pass variance), the
  parameters after optax's Adam as above, within ``JAX_PARAM_LR_FRAC`` ·
  lr;
- the negative controls: the same fixture with per-rank BN statistics at
  (2, 1), or with the patch not gathered at (1, 2), misses these
  tolerances.

Each mesh also renders the whole image through the mesh eval step, of
both scenes and of one (which does not split over the data axis), with
the same whole-image noise as the one-process eval step (1e-5: the BN
statistics of its encode are summed in another order, and the field runs
on half chunks).
The CLI's ``--mesh`` runs a world of one on the CPU.
"""

import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from diner_tpu.models.pixelnerf import PixelNeRF as JPixelNeRF
from diner_tpu.models.pixelnerf import PixelNeRFConfig as JPixelNeRFConfig
from diner_tpu.nn.spatial_encoder import SpatialEncoderConfig as JEncCfg
from diner_tpu.parallel import make_mesh as j_make_mesh
from diner_tpu.renderer import RendererConfig as JRendererConfig
from diner_tpu.train.diner import DinerConfig as JDinerConfig
from diner_tpu.train.diner import compute_losses as j_compute_losses
from diner_tpu.train.diner import select_pixels as j_select_pixels
from diner_tpu_torch.data.synthetic import make_sphere_scene
from diner_tpu_torch.losses import VGG19Features, init_vgg19
from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.parallel import (Mesh, initialize, is_multiprocess,
                                      make_mesh, mesh_shape, ray_slice,
                                      shard_batch, shutdown)
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train.diner import (DinerConfig, make_eval_step,
                                         make_train_step)
from diner_tpu_torch.utils.convert import flax_to_state_dict
from test_torch_render import ENC, RENDER, SRC, _perturbed, jax_noise

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "torch_parallel_worker.py"
H = W = 32
LOSS = dict(w_vgg=0.1, vgg_spatch=16, w_antibias=1.0,
            antibias_downsampling=3)
RAY_CHUNK = 256  # the eval renders 4 chunks, each split over the rays
TOTAL_RTOL = 2e-4
GRAD_TOL = 1e-4     # of each gradient's norm
PARAM_ATOL = 1e-6
PARAM_LR_FRAC = 0.05  # mesh against one process: |Δp| ≤ this · lr
JAX_PARAM_LR_FRAC = 0.5  # against JAX's step (flax's one-pass variance)
STATS_ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ shapes

@pytest.mark.parametrize("n", range(1, 9))
def test_mesh_shape_matches_jax(n):
    """The default rule and an explicit data_parallel, as JAX's make_mesh
    lays out its (data, rays) mesh (``tests/test_parallel.py:63-68``)."""
    ref = j_make_mesh(n)
    assert mesh_shape(n) == (ref.shape["data"], ref.shape["rays"])
    assert mesh_shape(n, data_parallel=1) == (1, n)
    if n == 8:
        assert mesh_shape(8) == (2, 4)
        assert mesh_shape(8, data_parallel=8) == (8, 1)
    with pytest.raises(ValueError, match="do not split"):
        mesh_shape(n, data_parallel=n + 1)


def vgg_flax_params(seed=0):
    """The port's seeded VGG19 (``init_vgg19``) as the JAX package's params
    tree (``conv_{idx}/kernel`` HWIO, ``bias``): JAX's own init of VGG19
    runs op by op, ~10 s on the CPU."""
    sd = init_vgg19(seed, device="cpu").state_dict()
    return {k.split(".")[0]: {
        "kernel": sd[k].permute(2, 3, 1, 0).numpy(),
        "bias": sd[k.replace("weight", "bias")].numpy()}
        for k in sd if k.endswith("weight")}


def _mesh(data, rays, rank):
    return Mesh(data, rays, rank, None, None, None)


def test_shard_batch_and_ray_slice():
    batch = {"a": np.arange(12).reshape(4, 3), "b": np.arange(3),
             "c": np.float32(2.0), "names": ["x", "y", "z", "w"]}
    # rank 3 of (2, 2): scene slice 1, ray slice 1
    m = _mesh(2, 2, 3)
    assert (m.data_index, m.ray_index) == (1, 1)
    out = shard_batch(batch, m)
    np.testing.assert_array_equal(out["a"], batch["a"][2:])
    np.testing.assert_array_equal(out["b"], batch["b"])  # 3 % 2: whole
    assert out["c"] == 2.0 and out["names"] == batch["names"]
    x = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    assert torch.equal(ray_slice(x, m), x[2:, 3:])
    assert torch.equal(ray_slice(x[:3], m), x[:3, 3:])  # scenes replicated
    with pytest.raises(ValueError, match="do not split"):
        ray_slice(x[:, :5], m)


def test_world_of_one(monkeypatch):
    """No launcher variables: a world of one on an in-process store;
    idempotent; the mesh (1, 1); a mesh needs a process group first."""
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    shutdown()
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()
    try:
        assert initialize(device="cpu") == torch.device("cpu")
        assert initialize(device="cpu") == torch.device("cpu")
        assert torch.distributed.get_backend() == "gloo"
        assert not is_multiprocess()
        mesh = make_mesh()
        assert mesh.shape == {"data": 1, "rays": 1} and mesh.rank == 0
        with pytest.raises(ValueError, match="world of 1"):
            make_mesh(2)
    finally:
        shutdown()
    with pytest.raises(ValueError, match="MASTER_ADDR"):
        initialize(device="cpu", rank=0, world_size=2)
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------- the mesh steps

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """Flax weights bridged to the port, the bridged VGG, the global batch
    (two scenes with different textures) and JAX's draws from its key."""
    batch = make_sphere_scene(H=H, W=W, nv=2, sb=2)
    rng = np.random.default_rng(4)
    batch["src_rgbs"] = np.clip(batch["src_rgbs"] + rng.normal(
        0, 0.1, batch["src_rgbs"].shape), 0, 1).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jm = JPixelNeRF(cfg=JPixelNeRFConfig(encoder=JEncCfg(**ENC),
                                         d_hidden=32))
    variables = jax.jit(jm.init)(jax.random.PRNGKey(4),
                                 *(jbatch[k] for k in SRC),
                                 jnp.zeros((2, 8, 3)), jnp.zeros((2, 8, 3)))
    variables = _perturbed(variables, 104)
    vgg_params = vgg_flax_params()
    jcfg = JDinerConfig(nerf=jm.cfg, renderer=JRendererConfig(**RENDER),
                        **LOSS)
    cfg = DinerConfig(nerf=PixelNeRFConfig(
        encoder=SpatialEncoderConfig(**ENC), d_hidden=32),
        renderer=RendererConfig(**RENDER, ray_chunk=RAY_CHUNK), **LOSS)
    key = jax.random.PRNGKey(23)
    k_pix, k_render = jax.random.split(key)
    pix = np.array(j_select_pixels(jcfg, jbatch, k_pix))
    noise = tuple(np.array(a) for a in jax_noise(
        k_render, 2, jcfg.rays_per_step, jcfg.renderer))
    eval_noise = tuple(np.array(a) for a in jax_noise(
        jax.random.PRNGKey(5), 2, H * W, jcfg.renderer))
    state = flax_to_state_dict(variables)
    vgg = flax_to_state_dict({"params": vgg_params})
    fix = dict(cfg=cfg, state=state, vgg=vgg, batch=batch, pix=pix,
               noise=noise, eval_noise=eval_noise)
    work = tmp_path_factory.mktemp("mesh")
    torch.save(fix, work / "fixture.pt")
    return types.SimpleNamespace(work=work, jm=jm, jcfg=jcfg, key=key,
                                 jbatch=jbatch, variables=variables,
                                 vgg_params=vgg_params, **fix)


@pytest.fixture(scope="module")
def mesh_runs(fixture):
    """Both ranks of every case of the worker's ``CASES``."""
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(WORKER), str(r), "2", str(port),
         str(fixture.work)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, cwd=ROOT) for r in range(2)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=300)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out}"
    from torch_parallel_worker import CASES
    runs = {case: [torch.load(fixture.work / f"{case}_rank{r}.pt",
                              weights_only=False) for r in range(2)]
            for case in CASES}
    runs["checks"] = [torch.load(fixture.work / f"checks_rank{r}.pt")
                      for r in range(2)]
    return runs


def _snapshot(step, metrics):
    model = step.model
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "adam": {n: (step.optimizer.state[p]["exp_avg"].clone(),
                         step.optimizer.state[p]["exp_avg_sq"].clone())
                     for n, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def one_process(fixture):
    """The port's one-process step, eval render and second step (Adam's
    state carried over) on the fixture."""
    model = PixelNeRF(fixture.cfg.nerf)
    model.load_state_dict(fixture.state)
    vgg = VGG19Features()
    vgg.load_state_dict(fixture.vgg)
    step = make_train_step(model, fixture.cfg, vgg)
    out = _snapshot(step, step(fixture.batch, noise=fixture.noise,
                               pix_idcs=fixture.pix))
    eval_step = make_eval_step(model, fixture.cfg)
    out["eval"] = eval_step(fixture.batch, noise=fixture.eval_noise)
    out["eval_one"] = eval_step(
        {k: v[:1] for k, v in fixture.batch.items()},
        noise=tuple(t[:1] for t in fixture.eval_noise))
    out["second"] = _snapshot(step, step(
        fixture.batch, noise=fixture.noise, pix_idcs=fixture.pix))
    return out


@pytest.fixture(scope="module")
def jax_step(fixture):
    """JAX's one-device step from the same variables and key: metrics,
    gradients, the parameters after optax's Adam, the BN statistics."""
    jm, jcfg = fixture.jm, fixture.jcfg

    def loss_fn(params):
        return j_compute_losses(jm, jcfg, params,
                                fixture.variables["batch_stats"],
                                fixture.vgg_params, fixture.jbatch,
                                fixture.key)

    (total, aux), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        fixture.variables["params"])
    tx = optax.adam(jcfg.lr)
    params = fixture.variables["params"]
    updates, _ = tx.update(grads, tx.init(params), params)
    new = optax.apply_updates(params, updates)
    as_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"metrics": {k: float(v) for k, v in aux["metrics"].items()},
            "total": float(total),
            "grads": flax_to_state_dict({"params": as_np(grads)}),
            "state": flax_to_state_dict({"params": as_np(new),
                                         "batch_stats": as_np(
                                             aux["batch_stats"])})}


def _assert_adam_close(run, ref, lr):
    """Every parameter after the first Adam step within PARAM_ATOL +
    lr · |Δg| / ε of the reference's (ε = 1e-8, the slope bound)."""
    for n, g_ref in ref["grads"].items():
        bound = PARAM_ATOL + lr * (run["grads"][n] - g_ref).abs() / 1e-8
        diff = (run["state"][n] - ref["state"][n]).abs()
        assert bool((diff <= bound).all()), (n, float((diff - bound).max()))


def _grad_errs(got, ref):
    """Worst |Δ| over the reference's norm, per parameter."""
    return {n: float((got[n] - g).abs().max()) / max(float(g.norm()), 1e-30)
            for n, g in ref.items()}


def _misses(run, ref):
    """The fixture's checks this run misses."""
    m = run["metrics"]
    miss = []
    if abs(m["total"] - ref["metrics"]["total"]) > \
            TOTAL_RTOL * abs(ref["metrics"]["total"]):
        miss.append("total")
    if max(_grad_errs(run["grads"], ref["grads"]).values()) > GRAD_TOL:
        miss.append("grads")
    if any(float((run["state"][k] - ref["state"][k]).abs().max())
           > STATS_ATOL for k in _stats(ref["state"])):
        miss.append("stats")
    return miss


def _assert_step_close(run, ref, lr):
    """A mesh rank's step against the one-process step: metrics, every
    gradient and both of Adam's moments, every parameter after Adam
    (within PARAM_LR_FRAC · lr) and the running statistics."""
    assert run["metrics"].keys() == ref["metrics"].keys()
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(run["metrics"][k], v, rtol=TOTAL_RTOL,
                                   err_msg=k)
    errs = _grad_errs(run["grads"], ref["grads"])
    assert max(errs.values()) <= GRAD_TOL, max(errs.items(),
                                               key=lambda kv: kv[1])
    for n, (m, v) in ref["adam"].items():
        gm, gv = run["adam"][n]
        assert float((gm - m).abs().max()) <= GRAD_TOL * float(
            m.norm()) + 1e-30, n
        assert float((gv - v).abs().max()) <= GRAD_TOL * float(
            v.norm()) + 1e-30, n
    worst = max(((float((run["state"][n] - ref["state"][n]).abs().max())
                  / lr, n) for n in ref["grads"]))
    assert worst[0] <= PARAM_LR_FRAC, worst
    for k in _stats(ref["state"]):
        np.testing.assert_allclose(run["state"][k].numpy(),
                                   ref["state"][k].numpy(),
                                   atol=STATS_ATOL, rtol=0, err_msg=k)


@pytest.mark.parametrize("case", ["mesh_2x1", "mesh_1x2"])
def test_mesh_step_equals_one_process_step(mesh_runs, one_process, fixture,
                                           case):
    ranks = mesh_runs[case]
    assert ranks[0]["mesh"] == ({"mesh_2x1": (2, 1),
                                 "mesh_1x2": (1, 2)}[case])
    ref = one_process
    assert sorted(ref["metrics"]) == ["antibias", "rgb_fine", "total",
                                      "vgg_fine"]
    for run in ranks:
        _assert_step_close(run, ref, fixture.cfg.lr)
        _assert_adam_close(run, ref, fixture.cfg.lr)
        for got, want in zip(run["eval"] + run["eval_one"],
                             ref["eval"] + ref["eval_one"]):
            assert got.shape == want.shape
            np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                       rtol=0)
    # Adam ran on identical gradients on both ranks
    for k, v in ranks[0]["state"].items():
        assert torch.equal(v, ranks[1]["state"][k]), k
    assert not torch.equal(ranks[0]["state"]["mlp.lin_in.weight"],
                           fixture.state["mlp.lin_in.weight"])


@pytest.mark.parametrize("case", ["mesh_2x1", "mesh_1x2"])
def test_mesh_second_step_equals_one_process_step(mesh_runs, one_process,
                                                  fixture, case):
    """A second step from the first one's weights and Adam state, where
    Adam's moments are not zero, against the one-process second step."""
    ref = one_process["second"]
    assert any(float(g.abs().max()) > 0 for g in ref["grads"].values())
    for run in mesh_runs[case]:
        _assert_step_close(run["second"], ref, fixture.cfg.lr)
    for k, v in mesh_runs[case][0]["second"]["state"].items():
        assert torch.equal(v, mesh_runs[case][1]["second"]["state"][k]), k


def _stats(state):
    return [k for k in state if k.endswith(("running_mean", "running_var"))]


def test_mesh_1x2_step_equals_jax_step(mesh_runs, jax_step, fixture):
    ref = jax_step
    for run in mesh_runs["mesh_1x2"]:
        for k, v in ref["metrics"].items():
            np.testing.assert_allclose(run["metrics"][k], v, rtol=1e-5,
                                       err_msg=k)
        errs = _grad_errs(run["grads"], ref["grads"])
        assert max(errs.values()) <= 1e-4, max(errs.items(),
                                               key=lambda kv: kv[1])
        _assert_adam_close(run, ref, fixture.cfg.lr)
        worst = max(((float((run["state"][n] - ref["state"][n]).abs().max())
                      / fixture.cfg.lr, n) for n in ref["grads"]))
        assert worst[0] <= JAX_PARAM_LR_FRAC, worst
        for k in _stats(ref["state"]):
            np.testing.assert_allclose(run["state"][k].numpy(),
                                       ref["state"][k].numpy(), atol=1e-4,
                                       rtol=0, err_msg=k)


@pytest.mark.parametrize("case,mesh", [("per_rank_bn", (2, 1)),
                                       ("patch_not_gathered", (1, 2))])
def test_negative_controls_miss(mesh_runs, one_process, case, mesh):
    for run in mesh_runs[case]:
        assert run["mesh"] == mesh
        assert _misses(run, one_process), case
    for run in mesh_runs[case.replace("per_rank_bn", "mesh_2x1").replace(
            "patch_not_gathered", "mesh_1x2")]:
        assert _misses(run, one_process) == []


def test_metric_reduction_and_barrier(mesh_runs):
    for r, c in enumerate(mesh_runs["checks"]):
        assert c["world"] == 2 and c["rank"] == r and c["multiprocess"]
        assert c["reduce"] == 0.5  # the mean of ranks {0, 1}
        assert c["barrier"] == "ok"


# --------------------------------------------------------------- the CLI

def test_cli_mesh_dry_run(tmp_path, monkeypatch, capsys):
    """``python -m diner_tpu_torch.train <yaml> DINER --mesh --max-steps 2
    --device cpu`` (``tests/test_parallel.py:90``): a world of one through
    the mesh step, its checkpoint at step 2, the mesh printed; it leaves
    no process group behind."""
    from diner_tpu_torch.train.__main__ import main as train_main
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    raw = yaml.safe_load((ROOT / "configs" / "train_synthetic.yaml")
                         .read_text())
    raw["logger"]["kwargs"]["save_dir"] = str(tmp_path / "runs")
    raw["trainer"]["kwargs"]["val_check_interval"] = -1
    raw["data"]["train"]["dataset"]["kwargs"].update(n=4, H=24, W=24)
    raw["renderer"]["kwargs"].update(n_samples=8, n_depth_candidates=32,
                                     n_gaussian=2)
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(raw))
    train_main([str(path), "DINER", "--mesh", "--max-steps", "2",
                "--device", "cpu", "--num-workers", "0"])
    assert not torch.distributed.is_initialized()
    assert "training over mesh {'data': 1, 'rays': 1} (gloo)" in \
        capsys.readouterr().out
    ckpts = list((tmp_path / "runs").rglob("step_00000002/state.pt"))
    assert len(ckpts) == 1
