#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``diner_tpu_torch``) on one NVIDIA GPU.

Builds every CUDA kernel of the eval-render path from the sources in this
checkout, holds each kernel against its plain PyTorch version on the card,
then drives the main path through the port's entry points: a seeded DINER
at the DTU eval protocol (4 source views at 512×640, ResNet34 encoder with
a 64 px PE ring, 512-wide ResnetFC, 64 samples from 1000 candidates with
24 Gaussian resamples, 4096-ray chunks, bf16 compute) renders a full
512×640 target of the synthetic sphere scene. It checks the launch counts,
the outputs, a 1024-ray f32 crop rendered through the kernel and through
the plain composite, and a small render on the card against the same
render on the CPU. A profiler pass and per-layer CUDA-event timings of one
warm render say where the time goes.

Each phase prints one JSON line; any failed check exits nonzero. The last
three lines are the kernel table, the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": {...}}``. A copy
of every phase line goes to ``outputs/chip_smoke/chip_smoke.json``.

Run from the repository root:  python3 chip_smoke.py
"""

import dataclasses
import json
import statistics
import subprocess
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "outputs" / "chip_smoke"  # git-ignored
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
COMPOSITE_FLOPS_PER_SAMPLE = 17  # delta, alpha (exp as 1), w, 4 sums, T
LOG = []


def emit(phase, **fields):
    line = {"phase": phase, **fields}
    LOG.append(line)
    print(json.dumps(line), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_time_ms(fn, runs=30, warmup=5):
    """Median device time of ``fn`` over ``runs`` warm calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_err(a, b):
    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(a, b) if x is not None)


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    emit("device", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return smi


def phase_build():
    from diner_tpu_torch.ops import cuda_build
    t0 = time.perf_counter()
    report = cuda_build.build()
    seconds = time.perf_counter() - t0
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    emit("build", seconds=seconds, kernels={
        n: {"seconds": r["seconds"],
            "ptxas": [ln.strip() for ln in r["log"].splitlines()
                      if "registers" in ln or "spill" in ln]}
        for n, r in report.items()})


def field_case(R, K, seed):
    """Inputs as the renderer hands them to the composite: rgb and sigma
    are views of the field's (1, R, K, 4) output."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    out = torch.rand((1, R, K, 4), generator=g, device="cuda")
    out[..., 3] = torch.randn((1, R, K), generator=g, device="cuda") * 2
    z = torch.sort(torch.rand((1, R, K), generator=g, device="cuda") * 1.5
                   + 0.5).values
    rays = torch.zeros((1, R, 8), device="cuda")
    rays[..., 7] = 2.5
    return out[..., :3], out[..., 3], z, rays


def phase_kernel():
    from diner_tpu_torch.ops import composite as plain
    from diner_tpu_torch.ops import composite_cuda
    rows = []
    for R, K in ((4096, 64), (4097, 40)):
        for white in (False, True):
            args = field_case(R, K, R + K + white)
            got = composite_cuda.composite_kernel(*args, white_bkgd=white)
            torch.cuda.synchronize()
            ref = plain.composite(*args, white_bkgd=white)
            err = max_err(got, ref)
            row = dict(R=R, K=K, white_bkgd=white, max_abs_err=err)
            if (R, K) == (4096, 64):
                row["ms"] = cuda_time_ms(
                    lambda: composite_cuda.composite_kernel(*args, white))
                row["plain_ms"] = cuda_time_ms(
                    lambda: plain.composite(*args, white))
                n_in = R * K * 5 + R          # rgb, sigma, z; far
                n_out = R * 3 + R + R * K     # rgb, depth, weights
                t_bytes = 4 * (n_in + n_out) / HBM_BYTES_PER_S
                t_ops = COMPOSITE_FLOPS_PER_SAMPLE * R * K / F32_FLOPS_PER_S
                row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
                row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
            emit("kernel", name="composite_fwd", **row)
            check(err <= 1e-5, f"composite kernel vs plain {row}")
            rows.append(row)
    return rows


def dtu_eval_config():
    from diner_tpu_torch.models.pixelnerf import PixelNeRFConfig
    from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
    from diner_tpu_torch.renderer import RendererConfig
    from diner_tpu_torch.train.diner import DinerConfig
    return DinerConfig(
        nerf=PixelNeRFConfig(
            encoder=SpatialEncoderConfig(backbone="resnet34", num_layers=4,
                                         image_padding=64, padding_pe=4),
            n_blocks=5, d_hidden=512, combine_layer=3,
            compute_dtype="bfloat16"),
        renderer=RendererConfig(n_samples=64, n_depth_candidates=1000,
                                n_gaussian=24, white_bkgd=False,
                                ray_chunk=4096),
        znear=0.8, zfar=2.4)


def phase_path():
    from diner_tpu_torch.data.synthetic import make_sphere_scene
    from diner_tpu_torch.ops import composite_cuda
    from diner_tpu_torch.train.diner import create_model, make_eval_step
    H, W = 512, 640
    cfg = dtu_eval_config()
    batch = make_sphere_scene(H=H, W=W, nv=4)
    n_chunks = -(-H * W // cfg.renderer.ray_chunk)

    t0 = time.perf_counter()
    model = create_model(cfg, batch, seed=0)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    step = make_eval_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)

    composite_cuda.launches = 0
    t1 = time.perf_counter()
    rgb, depth = step(batch, generator=gen)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    launches_first = composite_cuda.launches
    check(launches_first == n_chunks,
          f"first render launched the kernel {launches_first} times, "
          f"expected {n_chunks}")

    torch.cuda.reset_peak_memory_stats()
    composite_cuda.launches = 0
    t2 = time.perf_counter()
    rgb, depth = step(batch, generator=gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t2
    launches = composite_cuda.launches
    peak = torch.cuda.max_memory_allocated()
    check(launches == n_chunks,
          f"warm render launched the kernel {launches} times, "
          f"expected {n_chunks}")
    check(rgb.shape == (1, H, W, 3) and depth.shape == (1, H, W),
          f"output shapes {tuple(rgb.shape)} {tuple(depth.shape)}")
    check(bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(depth).all()),
          "non-finite rgb or depth")
    hit = float((depth > 0).float().mean())
    check(hit > 0, "no ray has depth > 0")
    emit("path", config="DTU eval protocol, bf16, sphere scene 512x640 nv=4",
         chunks=n_chunks, launches=launches, launches_first_render=launches_first,
         model_init_s=t_model, first_image_s=t_first,
         time_to_first_image_s=t_model + t_first, warm_s_per_image=t_warm,
         peak_mem_bytes=peak, share_depth_gt0=hit,
         rgb_mean=float(rgb.mean()), depth_mean=float(depth.mean()))

    profile_render(step, batch, gen)
    stage_times(model, cfg, batch, H, W)
    crop_check(model, cfg, batch, H, W)
    return launches


def profile_render(step, batch, gen):
    """Kernel time by name over one warm render, and the device's idle
    share (1 − summed kernel time / wall time of the render)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, generator=gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    # the attribute is self_cuda_time_total in older PyTorch releases
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(getattr(e, attr) for e in kernels) / 1e3
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.key.startswith("aten::")]
    top = sorted(ops, key=lambda e: getattr(e, attr), reverse=True)[:12]
    emit("profile", wall_ms=wall * 1e3, kernel_ms=busy_ms,
         idle_share=1 - busy_ms / (wall * 1e3), top_ops=[
             {"op": e.key, "device_ms": getattr(e, attr) / 1e3,
              "calls": e.count} for e in top])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke_profile.txt").write_text(
        events.table(sort_by=attr, row_limit=80))


def stage_times(model, cfg, batch, H, W):
    """Device time of each layer for one encode and one 4096-ray chunk
    through the middle of the image (CUDA events, median of warm runs)."""
    from diner_tpu_torch.ops import composite_cuda
    from diner_tpu_torch.ops.sampling import (fill_up_uniform,
                                              sample_depthguided)
    from diner_tpu_torch.renderer import draw_noise
    from diner_tpu_torch.train.diner import (SRC_KEYS, target_rays,
                                             batch_to_device)
    rc = cfg.renderer
    b = batch_to_device(batch, "cuda")
    src = [b[k] for k in SRC_KEYS]
    start = (H * W) // 2 - rc.ray_chunk // 2
    rays = target_rays(cfg, b, H, W)[:, start:start + rc.ray_chunk]
    rays = rays.contiguous()
    u_coarse, gauss, u_fill = draw_noise(
        rc, 1, rc.ray_chunk, device="cuda",
        generator=torch.Generator("cuda").manual_seed(3))
    with torch.no_grad():
        ctx = model.encode(*src)
        views = ctx.view_maps()

        def sampler():
            z = sample_depthguided(rays, views, rc.n_samples,
                                   rc.n_depth_candidates, u_coarse, gauss,
                                   rc.n_gaussian, rc.depth_diff_max)
            return fill_up_uniform(z, rays, u_fill)

        z = sampler()
        pts = (rays[..., None, :3] + z[..., None] * rays[..., None, 3:6]
               ).reshape(1, -1, 3)
        dirs = rays[..., None, 3:6].expand(1, rc.ray_chunk, rc.n_samples,
                                           3).reshape(1, -1, 3)
        out = model.field(ctx, pts, dirs).reshape(1, rc.ray_chunk,
                                                  rc.n_samples, 4)
        ms = {
            "encode_ms": cuda_time_ms(lambda: model.encode(*src), 5, 1),
            "sampler_ms": cuda_time_ms(sampler, 10, 2),
            "field_ms": cuda_time_ms(lambda: model.field(ctx, pts, dirs),
                                     10, 2),
            "composite_ms": cuda_time_ms(lambda: composite_cuda.composite(
                out[..., :3], out[..., 3], z, rays, rc.white_bkgd)),
        }
    emit("stages", chunk_rays=rc.ray_chunk, **ms)


def crop_check(model, cfg, batch, H, W):
    """1024 rays at f32, same noise, through the kernel and through the
    plain composite on the card."""
    from diner_tpu_torch.models.pixelnerf import PixelNeRF
    from diner_tpu_torch.renderer import draw_noise, render_rays_chunked
    from diner_tpu_torch.train.diner import (SRC_KEYS, target_rays,
                                             batch_to_device)
    m32 = PixelNeRF(dataclasses.replace(cfg.nerf, compute_dtype="float32"))
    m32.load_state_dict(model.state_dict())
    m32.cuda()
    b = batch_to_device(batch, "cuda")
    start = (H // 2) * W + W // 2 - 512
    with torch.no_grad():
        ctx = m32.encode(*(b[k] for k in SRC_KEYS))
        rays = target_rays(cfg, b, H, W)[:, start:start + 1024].contiguous()
        noise = draw_noise(cfg.renderer, 1, 1024, device="cuda",
                           generator=torch.Generator("cuda").manual_seed(1))
        outs = {impl: render_rays_chunked(
                    m32.field, ctx, rays,
                    dataclasses.replace(cfg.renderer, composite_impl=impl),
                    noise=noise)
                for impl in ("pallas", "torch")}
    err = max_err(outs["pallas"], outs["torch"])
    emit("crop_f32", rays=1024, max_abs_err=err,
         share_depth_gt0=float((outs["pallas"].depth > 0).float().mean()))
    check(err <= 1e-5, f"f32 crop kernel vs plain composite: {err}")


def phase_small_reference():
    """A small render on the card against the same render on the CPU:
    same weights, same noise, f32."""
    from diner_tpu_torch.data.synthetic import make_sphere_scene
    from diner_tpu_torch.models.pixelnerf import PixelNeRF, PixelNeRFConfig
    from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
    from diner_tpu_torch.renderer import RendererConfig, draw_noise
    from diner_tpu_torch.train.diner import (DinerConfig, create_model,
                                             make_eval_step)
    H, W = 32, 40
    cfg = DinerConfig(
        nerf=PixelNeRFConfig(encoder=SpatialEncoderConfig(
            backbone="resnet18", num_layers=2, image_padding=8), d_hidden=32),
        renderer=RendererConfig(n_samples=8, n_depth_candidates=64,
                                n_gaussian=3, white_bkgd=False,
                                ray_chunk=512))
    batch = make_sphere_scene(H=H, W=W, nv=2)
    cpu_model = create_model(cfg, batch, seed=0, device="cpu")
    gpu_model = PixelNeRF(cfg.nerf)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.cuda()
    noise = draw_noise(cfg.renderer, 1, H * W,
                       generator=torch.Generator().manual_seed(2))
    ref = make_eval_step(cpu_model, cfg)(batch, noise=noise)
    got = make_eval_step(gpu_model, cfg)(batch, noise=noise)
    diff = torch.maximum((got[0].cpu() - ref[0]).abs().amax(-1),
                         (got[1].cpu() - ref[1]).abs())
    share = float((diff <= 1e-4).float().mean())
    emit("small_reference", pixels=H * W, max_abs_err=float(diff.max()),
         tol=1e-4, share_within_tol=share)
    # 1e-4: convolutions and matmuls sum in another order on the card; a
    # rounding step at a sampler threshold may move a few pixels' samples
    check(share >= 0.99, f"card vs CPU render: {share} of pixels within 1e-4")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs an "
                         "NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()
    rows = phase_kernel()
    launches = phase_path()
    phase_small_reference()

    main_row = next(r for r in rows if (r["R"], r["K"]) == (4096, 64))
    kernels = [{
        "name": "composite_fwd", "route": "cuda",
        "source": "diner_tpu_torch/csrc/composite_fwd.cu",
        "replaces": "diner_tpu/ops/pallas/composite_pallas.py:29",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": None,
    }]
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(
        {"phases": LOG, "kernels": kernels, "nvidia_smi": smi}, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
