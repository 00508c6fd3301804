"""One rank of the two-process mesh runs of ``tests/test_torch_parallel.py``.

Run as ``python tests/torch_parallel_worker.py <rank> <world> <port>
<workdir>``. It joins a gloo group on ``127.0.0.1:<port>`` through
``diner_tpu_torch.parallel.initialize``, checks the metric reduction and
the barrier (``utils/meters.py``), then, for each case of ``CASES``, takes
a mesh train step, a mesh eval render and a second train step (Adam's
state carried over; the defect cases take the first step only) from
``workdir/fixture.pt`` (the model's state, the VGG, the config, the
global batch and draws), and saves what it got to
``workdir/<case>_rank<rank>.pt``. Imports torch and the port only.
"""

import sys
from pathlib import Path

import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from diner_tpu_torch.losses import VGG19Features  # noqa: E402
from diner_tpu_torch.models.pixelnerf import PixelNeRF  # noqa: E402
from diner_tpu_torch.parallel import (initialize,  # noqa: E402
                                      is_multiprocess, make_mesh,
                                      make_parallel_eval_step,
                                      make_parallel_train_step, shutdown)
from diner_tpu_torch.parallel import sharding  # noqa: E402
from diner_tpu_torch.utils import meters  # noqa: E402

# case → (data_parallel, defect): the two meshes, then the two defects the
# negative controls plant (per-rank BN statistics; a patch not gathered)
CASES = {"mesh_2x1": (2, None), "mesh_1x2": (1, None),
         "per_rank_bn": (2, "bn"), "patch_not_gathered": (1, "patch")}


def snapshot(step, metrics):
    """What a train step left: its metrics, every gradient, the model's
    state and Adam's two moments."""
    model = step.model
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "state": {k: v.clone() for k, v in model.state_dict().items()},
            "adam": {n: (step.optimizer.state[p]["exp_avg"].clone(),
                         step.optimizer.state[p]["exp_avg_sq"].clone())
                     for n, p in model.named_parameters()}}


def run_case(fix, data_parallel, defect):
    mesh = make_mesh(data_parallel=data_parallel)
    cfg = fix["cfg"]
    model = PixelNeRF(cfg.nerf)
    model.load_state_dict(fix["state"])
    vgg = VGG19Features()
    vgg.load_state_dict(fix["vgg"])
    step = make_parallel_train_step(model, cfg, mesh, vgg)
    batch_mean, gather_rays = sharding.batch_mean, sharding.gather_rays
    if defect == "bn":
        sharding.batch_mean = lambda mesh: None
    elif defect == "patch":
        sharding.gather_rays = lambda x, mesh: x
    try:
        metrics = step(fix["batch"], noise=fix["noise"],
                       pix_idcs=fix["pix"])
    finally:
        sharding.batch_mean, sharding.gather_rays = batch_mean, gather_rays
    out = {"mesh": (mesh.data, mesh.rays), **snapshot(step, metrics)}
    if defect is None:
        eval_step = make_parallel_eval_step(model, cfg, mesh)
        out["eval"] = eval_step(fix["batch"], noise=fix["eval_noise"])
        # one scene: it does not split over the data axis, so every rank
        # renders it (only the rays split)
        out["eval_one"] = eval_step(
            {k: v[:1] for k, v in fix["batch"].items()},
            noise=tuple(t[:1] for t in fix["eval_noise"]))
        out["second"] = snapshot(step, step(
            fix["batch"], noise=fix["noise"], pix_idcs=fix["pix"]))
    return out


def main():
    rank, world, port, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                                  int(sys.argv[3]), Path(sys.argv[4]))
    torch.set_num_threads(2)
    initialize(device="cpu", rank=rank, world_size=world,
               master_addr="127.0.0.1", master_port=port)
    assert initialize(device="cpu").type == "cpu"  # idempotent
    checks = {"world": dist.get_world_size(), "rank": dist.get_rank(),
              "multiprocess": is_multiprocess(),
              "reduce": meters.reduce_scalar_dict({"loss": float(rank)})
              ["loss"]}
    meters.synchronize()
    checks["barrier"] = "ok"
    fix = torch.load(workdir / "fixture.pt", weights_only=False)
    for case, (data_parallel, defect) in CASES.items():
        torch.save(run_case(fix, data_parallel, defect),
                   workdir / f"{case}_rank{rank}.pt")
    torch.save(checks, workdir / f"checks_rank{rank}.pt")
    shutdown()


if __name__ == "__main__":
    main()
