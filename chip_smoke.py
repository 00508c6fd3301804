#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``diner_tpu_torch``) on one NVIDIA GPU.

Builds every CUDA kernel of the port from the sources in this checkout
(kernel A, the compositing forward; kernel B, its backward; kernel C, the
row gather), holds each against its plain PyTorch version on the card
(kernel B at K = 1-100 around its 32-sample chunks and its register path,
R = 4096 and 4097, white or not, with and without g_depth and g_w, strided
or contiguous rgb), then
drives the port's paths through its entry points, with the launch counts
set to 0 just before each and read just after:

- eval: a seeded DINER at the DTU eval protocol (4 source views at
  512×640, ResNet34 encoder with a 64 px PE ring, 512-wide ResnetFC, 64
  samples from 1000 candidates with 24 Gaussian resamples, 4096-ray
  chunks, bf16 compute) renders a full 512×640 target of the synthetic
  sphere scene. Checks: launch counts, outputs, a 1024-ray f32 crop
  through the kernel and through the plain composite, and a small render
  on the card against the same render on the CPU.
- eval through the pair table: the same render with the latent's x-pair
  table attached (``ctx.with_latent_pairs()``) and the same noise; its rgb
  and depth must equal the eval render's bit for bit.
- eval with the pruned sampler: the same model and image with
  ``n_coarse_candidates=125, n_refine_bins=16``.
- training: the production step of ``bench.py:73-93`` (the same model, 40
  samples from 1000 candidates with 15 Gaussian resamples, a 64×64
  foreground patch of 4096 rays, MSE + 0.1·VGG19 + 1.0·antibias, Adam at
  lr 1e-4) takes 2 warm-up and 5 timed steps, with the one-stage sampler
  and with the pruned one (``pruned=True``, the JAX package's headline
  step). Checks: kernels A and B once per step and kernel C 6 (7 pruned)
  times, finite losses and gradients, parameters and BN running statistics
  moved, a 1024-ray f32 step through the kernels against the same step
  through the plain composite, and small steps on the card against the
  same steps on the CPU.
- the training entry point (``train_loop``): ``configs/train_dtu.yaml``
  through the port's ``load_train_config`` with only ``data`` replaced by
  the sphere at 512×640 (4 views, 2 scenes a step, f32): ``python -m
  diner_tpu_torch.train`` takes steps 1-4 in a subprocess, then
  ``Trainer.fit`` resumes to step 6 in this process, checkpointing and
  validating there. Checks: step counts, every checkpoint restoring bit
  for bit, finite logged rows, a scored prediction folder of 2 images,
  kernels A, B and C once, once and 6 times per step, A 80 and C 480 times
  per validation image, peak memory under 40 GB.

Profiler passes (with each port kernel's summed device time) and
per-layer CUDA-event timings say where the time goes. A kernel's ``ms``,
its plain version's ``plain_ms`` and the library call's ``library_ms`` are
device times: 50 calls captured in one CUDA graph, replayed between CUDA
events, over 50 (``device_time_ms``). ``call_ms`` is one Python call of
the wrapper between two events, host work included. Kernel C is timed
against ``table[idx]`` and ``index_select`` at the path's shapes with
random rows, and at the indices one real chunk hands it, warm and with L2
flushed before each call.

Each phase prints one JSON line; any failed check exits nonzero. The last
three lines are the kernel table, the card's name and power limit as
``nvidia-smi`` reports them, and ``{"ok": true, "device": {...}}``. A copy
of every phase line goes to ``outputs/chip_smoke/chip_smoke.json``.

Run from the repository root:  python3 chip_smoke.py
"""

import dataclasses
import itertools
import json
import statistics
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "outputs" / "chip_smoke"  # git-ignored
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12     # H100 SXM, f32 outside the tensor cores
COMPOSITE_FLOPS_PER_SAMPLE = 17  # delta, alpha (exp as 1), w, 4 sums, T
# kernel B: delta, alpha, T and w (8), dL/dw (8 with g_depth and g_w), the
# product and suffix scans (10), then the suffix, dL/dalpha, d_sigma and
# d_rgb (12)
COMPOSITE_BWD_FLOPS_PER_SAMPLE = 38
PRUNED = dict(n_coarse_candidates=125, n_refine_bins=16)  # bench.py:84-85
LOG = []


def emit(phase, **fields):
    line = {"phase": phase, **fields}
    LOG.append(line)
    print(json.dumps(line), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def cuda_time_ms(fn, runs=30, warmup=5):
    """Median time of one warm Python call of ``fn`` between two CUDA
    events (``call_ms``): on an idle device it includes the host work the
    call does before its kernels start (checks, allocation, the launch)."""
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


def device_time_ms(fn, n=50, replays=5):
    """Device time of one call of ``fn`` (``ms``): ``n`` back-to-back calls
    captured in one CUDA graph on PyTorch's current stream, the graph
    replayed ``replays`` times between CUDA events, the median replay over
    ``n``. Only the kernels replay, not the host work of the call. Outputs
    freed inside the capture are reused by the next call, so the graph
    holds about one call's memory."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the default stream
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del graph
    torch.cuda.empty_cache()
    return statistics.median(times)


FLUSH_BYTES = 128 << 20  # > the H100's 50 MB L2


def cold_device_time_ms(fn, n=20):
    """Device time of ``fn`` with L2 flushed before each call: a graph of
    (write a 128 MB buffer, call) pairs, less a graph of the writes alone."""
    flush = torch.empty(FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    both = device_time_ms(lambda: (flush.zero_(), fn()), n)
    alone = device_time_ms(flush.zero_, n)
    return both - alone


def times_ms(fn, call_runs=30):
    """``ms`` (device, CUDA graph) and ``call_ms`` (one Python call)."""
    return dict(ms=device_time_ms(fn), call_ms=cuda_time_ms(fn, call_runs))


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


def field_case(R, K, seed, contiguous_rgb=False, device="cuda"):
    """Inputs as the renderer hands them to the composite: rgb and sigma
    are views of the field's (1, R, K, 4) output (or rgb a contiguous
    (1, R, K, 3) copy)."""
    g = torch.Generator(device=device).manual_seed(seed)
    out = torch.rand((1, R, K, 4), generator=g, device=device)
    out[..., 3] = torch.randn((1, R, K), generator=g, device=device) * 2
    z = torch.sort(torch.rand((1, R, K), generator=g, device=device) * 1.5
                   + 0.5).values
    rays = torch.zeros((1, R, 8), device=device)
    rays[..., 7] = 2.5
    rgb = out[..., :3].contiguous() if contiguous_rgb else out[..., :3]
    return rgb, out[..., 3], z, rays


# (R, K) of kernel A's checks: the eval (K = 64) and train (K = 40) shapes,
# then R not a multiple of the rays per block and K around one and two
# 32-sample chunks; timed at the first two
COMPOSITE_CASES = ((4096, 64), (4096, 40), (4097, 1), (4097, 31), (4097, 32),
                   (4097, 33), (4097, 40), (4097, 64), (4097, 100))


def phase_kernel():
    from diner_tpu_torch.ops import composite as plain
    from diner_tpu_torch.ops import composite_cuda
    rows = []
    for R, K in COMPOSITE_CASES:
        for white in (False, True):
            for contiguous_rgb in (False, True):
                args = field_case(R, K, R + K + white, contiguous_rgb)
                got = composite_cuda.composite_kernel(*args,
                                                      white_bkgd=white)
                torch.cuda.synchronize()
                ref = plain.composite(*args, white_bkgd=white)
                err = max_err(got, ref)
                row = dict(R=R, K=K, white_bkgd=white,
                           contiguous_rgb=contiguous_rgb, max_abs_err=err)
                if R == 4096 and not white and not contiguous_rgb:
                    row.update(times_ms(
                        lambda: composite_cuda.composite_kernel(*args, white)))
                    row["plain_ms"] = device_time_ms(
                        lambda: plain.composite(*args, white))
                    n_in = R * K * 5 + R          # rgb, sigma, z; far
                    n_out = R * 3 + R + R * K     # rgb, depth, weights
                    t_bytes = 4 * (n_in + n_out) / HBM_BYTES_PER_S
                    t_ops = (COMPOSITE_FLOPS_PER_SAMPLE * R * K
                             / F32_FLOPS_PER_S)
                    row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
                    row["bound_by"] = ("bytes" if t_bytes >= t_ops
                                       else "operations")
                emit("kernel", name="composite_fwd", **row)
                check(err <= 1e-5, f"composite kernel vs plain {row}")
                rows.append(row)
    return rows


# (R, K) of kernel B's checks: K around one and two 32-sample chunks (the
# register path holds K <= 64; 65 and 100 take the shared-memory path),
# the training step's 40 and the eval shape's 64, each at R = 4096 and at
# R no multiple of the rays per block, and the train loop's two scenes a
# step (8192 x 40, where half a warp per ray was kept); timed at (4096, 40)
COMPOSITE_BWD_CASES = tuple((R, K) for R in (4096, 4097)
                            for K in (1, 31, 32, 33, 40, 63, 64, 65, 100)) \
    + ((8192, 40),)


def saturate(sigma, z, far, g):
    """Drives samples of ``sigma`` (in place) to alpha ~ 1. On even rays one
    sample, at a random k0, gets sigma * delta in [16.6, 17.7]: alpha rounds
    to 1 in f32 while exp(-sigma * delta) is still 2e-8 to 6e-8, so the
    1e-10 floor of (1 - alpha + 1e-10) divides S_k there and T drops by
    1e-10 after it. On rays 1 mod 4 a quarter of the samples get sigma *
    delta up to about 40 * K * delta (alpha = 1, no gradient)."""
    R, K = sigma.shape[-2:]
    dev = sigma.device
    delta = torch.cat([z[..., 1:], far[..., None]], -1) - z
    k0 = torch.randint(0, K, (1, R, 1), generator=g, device=dev)
    window = ((16.6 + 1.1 * torch.rand((1, R, 1), generator=g, device=dev))
              / delta.gather(-1, k0)).expand(1, R, K)
    ray = torch.arange(R, device=dev)[:, None]
    at_k0 = (torch.arange(K, device=dev) == k0) & (ray % 2 == 0)
    deep = (torch.rand((1, R, K), generator=g, device=dev) < 0.25) \
        & (ray % 4 == 1)
    sigma[at_k0] = window[at_k0]
    sigma[deep] = (torch.rand((1, R, K), generator=g, device=dev)
                   * 40 * K)[deep]


def composite_bwd_case(R, K, white, with_g_w, contiguous_rgb, device,
                       saturated=False):
    """Kernel B's arguments for one case: the field's views (or a
    contiguous rgb) and seeded cotangents; g_depth and g_w are None (as the
    train step hands them) unless ``with_g_w``; ``saturated``: samples at
    alpha ~ 1 (``saturate``)."""
    rgb, sigma, z, rays = field_case(R, K, 7 * R + K + white,
                                     contiguous_rgb, device)
    g = torch.Generator(device=device).manual_seed(K + with_g_w)
    if saturated:
        saturate(sigma, z, rays[..., 7], g)
    g_rgb = torch.randn((1, R, 3), generator=g, device=device)
    g_depth, g_w = ((torch.randn((1, R), generator=g, device=device),
                     torch.randn((1, R, K), generator=g, device=device))
                    if with_g_w else (None, None))
    return rgb, sigma, z, rays, g_rgb, g_depth, g_w, white


def phase_kernel_bwd():
    """Kernel B against ``composite_bwd`` on the card, at every case of
    ``COMPOSITE_BWD_CASES``, white background or not, with only g_rgb (the
    train step's case: its depth and weights outputs are unused) or with
    g_depth and g_w too, for the field's strided rgb and a contiguous one,
    with samples at alpha ~ 1 or without."""
    from diner_tpu_torch.ops import composite as plain
    from diner_tpu_torch.ops import composite_cuda
    rows = []
    for (R, K), white, with_g_w, contiguous_rgb, saturated in \
            itertools.product(COMPOSITE_BWD_CASES, (False, True),
                              (False, True), (False, True), (False, True)):
        args = composite_bwd_case(R, K, white, with_g_w, contiguous_rgb,
                                  "cuda", saturated)
        rgb, sigma, z, rays, g_rgb, g_depth, g_w, _ = args
        got = composite_cuda.composite_bwd_kernel(*args)
        torch.cuda.synchronize()
        ref = plain.composite_bwd(rgb, sigma, z, rays[..., 7], *args[4:])
        err_rgb = max_err(got[:1], ref[:1])
        err_sigma = max_err(got[1:], ref[1:])
        scale = float(ref[1].abs().max())
        row = dict(R=R, K=K, white_bkgd=white, g_depth_and_g_w=with_g_w,
                   contiguous_rgb=contiguous_rgb, saturated=saturated,
                   max_abs_err=max(err_rgb, err_sigma), err_d_rgb=err_rgb,
                   err_d_sigma=err_sigma, d_sigma_scale=scale,
                   err_d_sigma_over_scale=err_sigma / max(scale, 1e-30))
        if (R, K, white, contiguous_rgb, saturated) == (4096, 40, False,
                                                        False, False):
            row.update(times_ms(
                lambda: composite_cuda.composite_bwd_kernel(*args)))
            row["plain_ms"] = device_time_ms(lambda: plain.composite_bwd(
                rgb, sigma, z, rays[..., 7], *args[4:]))
            n_in = R * K * 5 + R * 4      # rgb, sigma, z; far, g_rgb
            if with_g_w:
                n_in += R * K + R         # g_w, g_depth
            n_out = R * K * 4             # d_rgb, d_sigma
            t_bytes = 4 * (n_in + n_out) / HBM_BYTES_PER_S
            t_ops = COMPOSITE_BWD_FLOPS_PER_SAMPLE * R * K / F32_FLOPS_PER_S
            row["bound_ms"] = 1e3 * max(t_bytes, t_ops)
            row["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        emit("kernel_bwd", name="composite_bwd", **row)
        # d_rgb 1e-5 absolute; d_sigma 1e-5 of its largest value: the
        # kernel's T and suffix sums run in tree order within each chunk,
        # the plain version's sequentially, and neither subtracts
        check(err_rgb <= 1e-5 and err_sigma <= 1e-5 * scale,
              f"composite_bwd kernel vs plain {row}")
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
    from diner_tpu_torch.ops import composite_cuda, gather_cuda
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

    composite_cuda.launches = gather_cuda.launches = 0
    t1 = time.perf_counter()
    rgb, depth = step(batch, generator=gen)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    launches_first = (composite_cuda.launches, gather_cuda.launches)
    check(launches_first == (n_chunks, 6 * n_chunks),
          f"first render launched kernels A and C {launches_first} times, "
          f"expected ({n_chunks}, {6 * n_chunks})")

    torch.cuda.reset_peak_memory_stats()
    composite_cuda.launches = composite_cuda.bwd_launches = 0
    gather_cuda.launches = 0
    gen.manual_seed(1)  # path_pairs renders with the same noise
    t2 = time.perf_counter()
    rgb, depth = step(batch, generator=gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t2
    launches = (composite_cuda.launches, composite_cuda.bwd_launches,
                gather_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    check(launches == (n_chunks, 0, 6 * n_chunks),
          f"warm render launched kernels A, B and C {launches} times, "
          f"expected ({n_chunks}, 0, {6 * n_chunks})")
    check_image(rgb, depth, H, W)
    hit = float((depth > 0).float().mean())
    emit("path", config="DTU eval protocol, bf16, sphere scene 512x640 nv=4",
         chunks=n_chunks, launches=launches[0], launches_bwd=launches[1],
         launches_row_gather=launches[2],
         launches_first_render=launches_first[0],
         launches_row_gather_first_render=launches_first[1],
         model_init_s=t_model, first_image_s=t_first,
         time_to_first_image_s=t_model + t_first, warm_s_per_image=t_warm,
         peak_mem_bytes=peak, share_depth_gt0=hit,
         rgb_mean=float(rgb.mean()), depth_mean=float(depth.mean()))

    profile_once("profile", lambda: step(batch, generator=gen))
    stage_times(model, cfg, batch, H, W)
    gather_path(model, cfg, batch, H, W)
    crop_check(model, cfg, batch, H, W)
    return launches, dict(model=model, cfg=cfg, batch=batch, rgb=rgb,
                          depth=depth, model_init_s=t_model)


def check_image(rgb, depth, H, W):
    check(rgb.shape == (1, H, W, 3) and depth.shape == (1, H, W),
          f"output shapes {tuple(rgb.shape)} {tuple(depth.shape)}")
    check(bool(torch.isfinite(rgb).all()) and bool(torch.isfinite(depth).all()),
          "non-finite rgb or depth")
    check(float((depth > 0).float().mean()) > 0, "no ray has depth > 0")


def phase_path_pairs(ev):
    """The eval render with the latent's pair table attached after the
    encode, as ``scripts/eval_render_bench.py``'s pair-table arm opts in,
    with the noise of the eval render's warm run: rgb and depth must equal
    it bit for bit."""
    from diner_tpu_torch.ops import composite_cuda, gather_cuda
    from diner_tpu_torch.renderer import render_rays_chunked
    from diner_tpu_torch.train.diner import (SRC_KEYS, batch_to_device,
                                             target_rays)
    model, cfg, batch = ev["model"], ev["cfg"], ev["batch"]
    H, W = batch["target_rgb"].shape[1:3]
    n_chunks = -(-H * W // cfg.renderer.ray_chunk)

    @torch.no_grad()
    def render(gen):
        b = batch_to_device(batch, "cuda")
        ctx = model.encode(*(b[k] for k in SRC_KEYS)).with_latent_pairs()
        out = render_rays_chunked(model.field, ctx, target_rays(cfg, b, H, W),
                                  cfg.renderer, generator=gen)
        return out.rgb.reshape(1, H, W, 3), out.depth.reshape(1, H, W)

    gen = torch.Generator(device="cuda").manual_seed(1)
    t1 = time.perf_counter()
    render(gen)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    composite_cuda.launches = composite_cuda.bwd_launches = 0
    gather_cuda.launches = 0
    gen.manual_seed(1)
    t2 = time.perf_counter()
    rgb, depth = render(gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t2
    launches = (composite_cuda.launches, composite_cuda.bwd_launches,
                gather_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    check(launches == (n_chunks, 0, 4 * n_chunks),
          f"pair-table render launched kernels A, B and C {launches} times, "
          f"expected ({n_chunks}, 0, {4 * n_chunks})")
    check_image(rgb, depth, H, W)
    same = torch.equal(rgb, ev["rgb"]) and torch.equal(depth, ev["depth"])
    emit("path_pairs", config="DTU eval protocol through ctx."
         "with_latent_pairs(), same noise as path", chunks=n_chunks,
         launches=launches[0], launches_bwd=launches[1],
         launches_row_gather=launches[2], first_image_s=t_first,
         warm_s_per_image=t_warm, peak_mem_bytes=peak,
         bit_identical_to_path=same,
         max_abs_diff_rgb=float((rgb - ev["rgb"]).abs().max()),
         max_abs_diff_depth=float((depth - ev["depth"]).abs().max()))
    check(same, "pair-table render differs from the 4-corner render")
    return launches


def phase_path_pruned(ev):
    """The eval render with the pruned two-stage sampler
    (``eval_render_bench.py``'s arm ``(4096, pairs=False, pruned=True)``)
    on the eval path's model; the warm render takes the eval render's
    noise, so their difference is the sampler's."""
    from diner_tpu_torch.ops import composite_cuda, gather_cuda
    from diner_tpu_torch.train.diner import make_eval_step
    model, batch = ev["model"], ev["batch"]
    cfg = dataclasses.replace(ev["cfg"], renderer=dataclasses.replace(
        ev["cfg"].renderer, **PRUNED))
    H, W = batch["target_rgb"].shape[1:3]
    n_chunks = -(-H * W // cfg.renderer.ray_chunk)
    step = make_eval_step(model, cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t1 = time.perf_counter()
    step(batch, generator=gen)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    torch.cuda.reset_peak_memory_stats()
    composite_cuda.launches = composite_cuda.bwd_launches = 0
    gather_cuda.launches = 0
    gen.manual_seed(1)
    t2 = time.perf_counter()
    rgb, depth = step(batch, generator=gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t2
    launches = (composite_cuda.launches, composite_cuda.bwd_launches,
                gather_cuda.launches)
    peak = torch.cuda.max_memory_allocated()
    check(launches == (n_chunks, 0, 7 * n_chunks),
          f"pruned render launched kernels A, B and C {launches} times, "
          f"expected ({n_chunks}, 0, {7 * n_chunks})")
    check_image(rgb, depth, H, W)
    mse = float(((rgb.float() - ev["rgb"].float()) ** 2).mean())
    emit("path_pruned", config="DTU eval protocol, pruned sampler "
         "(125 coarse bins, 16 refined), bf16, sphere scene 512x640 nv=4",
         chunks=n_chunks, launches=launches[0], launches_bwd=launches[1],
         launches_row_gather=launches[2], first_image_s=t_first,
         time_to_first_image_s=ev["model_init_s"] + t_first,
         warm_s_per_image=t_warm, peak_mem_bytes=peak,
         share_depth_gt0=float((depth > 0).float().mean()),
         psnr_vs_one_stage_db=(10 * np.log10(1.0 / mse) if mse > 0
                               else float("inf")),
         share_pixels_equal_to_one_stage=float(
             (rgb == ev["rgb"]).all(-1).float().mean()))
    return launches


def profile_once(phase, fn):
    """Kernel time by name over one warm call of ``fn``, and the device's
    idle share (1 − summed kernel time / wall time of the call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
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
    # the port's own kernels by the name their CUDA functions carry
    port = {name: {"device_ms": sum(getattr(e, attr) for e in kernels
                                    if name in e.key) / 1e3,
                   "launches": sum(e.count for e in kernels if name in e.key)}
            for name in ("composite_fwd", "composite_bwd", "row_gather")}
    emit(phase, wall_ms=wall * 1e3, kernel_ms=busy_ms,
         idle_share=1 - busy_ms / (wall * 1e3),
         device_kernels=sum(e.count for e in kernels), port_kernels=port,
         top_ops=[{"op": e.key, "device_ms": getattr(e, attr) / 1e3,
                   "calls": e.count} for e in top])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"chip_smoke_{phase}.txt").write_text(
        events.table(sort_by=attr, row_limit=80))


def stage_times(model, cfg, batch, H, W):
    """Device time of each layer for one encode and one 4096-ray chunk
    through the middle of the image (CUDA events, median of warm runs)."""
    from diner_tpu_torch.ops import composite_cuda
    from diner_tpu_torch.ops.sampling import (fill_up_uniform,
                                              sample_depthguided,
                                              sample_depthguided_pruned)
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

        def sampler_pruned():
            z = sample_depthguided_pruned(
                rays, views, rc.n_samples, rc.n_depth_candidates,
                PRUNED["n_coarse_candidates"], PRUNED["n_refine_bins"],
                u_coarse, gauss, rc.n_gaussian, rc.depth_diff_max)
            return fill_up_uniform(z, rays, u_fill)

        z = sampler()
        pts = (rays[..., None, :3] + z[..., None] * rays[..., None, 3:6]
               ).reshape(1, -1, 3)
        dirs = rays[..., None, 3:6].expand(1, rc.ray_chunk, rc.n_samples,
                                           3).reshape(1, -1, 3)
        out = model.field(ctx, pts, dirs).reshape(1, rc.ray_chunk,
                                                  rc.n_samples, 4)
        ctx_pairs = ctx.with_latent_pairs()
        ms = {
            "encode_ms": cuda_time_ms(lambda: model.encode(*src), 5, 1),
            "sampler_ms": cuda_time_ms(sampler, 10, 2),
            "sampler_pruned_ms": cuda_time_ms(sampler_pruned, 10, 2),
            "field_ms": cuda_time_ms(lambda: model.field(ctx, pts, dirs),
                                     10, 2),
            "pair_table_build_ms": cuda_time_ms(
                lambda: ctx.with_latent_pairs(), 5, 1),
            "field_pairs_ms": cuda_time_ms(
                lambda: model.field(ctx_pairs, pts, dirs), 10, 2),
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


def dtu_train_config(pruned=False):
    """The production training recipe of ``bench.py:73-93``
    (``production=True``; reference ``configs/train_dtu.yaml``);
    ``pruned=True`` is the JAX package's headline step."""
    from diner_tpu_torch.renderer import RendererConfig
    eval_cfg = dtu_eval_config()
    return dataclasses.replace(
        eval_cfg,
        renderer=RendererConfig(n_samples=40, n_depth_candidates=1000,
                                n_gaussian=15, white_bkgd=False,
                                **(PRUNED if pruned else {})),
        lr=1e-4, w_vgg=0.1, vgg_spatch=64, w_antibias=1.0,
        antibias_downsampling=3)


def grads_of(model):
    return {n: p.grad for n, p in model.named_parameters()}


def grad_errs(got, ref):
    """Largest |Δ| of each parameter's gradient over the reference's norm
    → (worst ratio, its name, parameters whose reference gradient is not
    all zero); fails if every reference gradient is zero."""
    worst, nonzero = (0.0, ""), 0
    for n, g in ref.items():
        norm = float(g.float().norm())
        nonzero += norm > 0
        diff = float((got[n].float().cpu() - g.float().cpu()).abs().max())
        worst = max(worst, (diff / max(norm, 1e-30), n))
    check(nonzero > 0, "every reference gradient is zero")
    return worst + (nonzero,)


def phase_train_path(pruned=False):
    """Full-width production train steps through the port's entry points,
    with the one-stage or the pruned sampler."""
    from diner_tpu_torch.data.synthetic import make_sphere_scene
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.ops import composite_cuda, gather_cuda
    from diner_tpu_torch.train.diner import (batch_to_device, create_model,
                                             make_train_step)
    cfg = dtu_train_config(pruned)
    n_gathers = 7 if pruned else 6
    b = batch_to_device(make_sphere_scene(H=512, W=640, nv=4), "cuda")
    t0 = time.perf_counter()
    model = create_model(cfg, b, seed=0)
    vgg = init_vgg19(0, device="cuda")
    step = make_train_step(model, cfg, vgg)
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the init weights, whose density create_model checked is alive
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats0 = {n: t.clone() for n, t in model.named_buffers()}

    t1 = time.perf_counter()
    metrics = step(b, generator=gen)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    grads = grads_of(model)
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "non-finite gradient in the first train step")
    n_nonzero = sum(bool((g != 0).any()) for g in grads.values())
    check(n_nonzero > 0, "every gradient of the first train step is zero")
    moved = sum(not torch.equal(p.detach(), params0[n])
                for n, p in model.named_parameters())
    check(moved > 0, "no parameter changed in the first train step")
    stats_moved = sum(not torch.equal(t, stats0[n])
                      for n, t in model.named_buffers())
    check(stats_moved == len(stats0) > 0,
          f"{stats_moved} of {len(stats0)} BN statistics moved")
    step(b, generator=gen)  # second warm-up step

    def counts():
        return (composite_cuda.launches, composite_cuda.bwd_launches,
                gather_cuda.launches)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    composite_cuda.launches = composite_cuda.bwd_launches = 0
    gather_cuda.launches = 0
    times, losses, per_step, nonzero_per_step = [], [], [], []
    for _ in range(5):
        before = counts()
        t2 = time.perf_counter()
        metrics = step(b, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t2)
        per_step.append(tuple(a - c for a, c in zip(counts(), before)))
        losses.append({k: float(v) for k, v in metrics.items()})
        nonzero_per_step.append(sum(bool((g != 0).any())
                                    for g in grads_of(model).values()))
    launches = counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(c == (1, 1, n_gathers) for c in per_step),
          f"kernel A, B and C launches per step: {per_step}, expected "
          f"(1, 1, {n_gathers})")
    check(all(np.isfinite(v) for m in losses for v in m.values()),
          f"non-finite loss: {losses}")
    check(sorted(losses[0]) == ["antibias", "rgb_fine", "total", "vgg_fine"],
          f"metrics {sorted(losses[0])}")
    s_step = statistics.median(times)
    emit("train_path_pruned" if pruned else "train_path",
         config="DTU production train step, bf16, sphere scene 512x640 "
         "nv=4, 64x64 patch" + (", pruned sampler (125 coarse bins, 16 "
                                "refined)" if pruned else ""),
         rays_per_step=cfg.rays_per_step,
         steps_timed=len(times), launches_composite_fwd=launches[0],
         launches_composite_bwd=launches[1],
         launches_row_gather=launches[2], s_per_step=s_step,
         s_per_step_all=times, rays_per_s=cfg.rays_per_step / s_step,
         model_init_s=t_model, first_step_s=t_first,
         time_to_first_step_s=t_model + t_first, peak_mem_bytes=peak,
         params=len(grads), params_grad_nonzero=n_nonzero,
         params_grad_nonzero_timed_steps=nonzero_per_step,
         params_moved=moved, bn_stats_moved=stats_moved,
         steps_taken=step.step, losses=losses)

    profile_once("train_pruned_profile" if pruned else "train_profile",
                 lambda: step(b, generator=gen))
    if not pruned:
        train_stage_times(model, cfg, b, vgg, step)
    return launches, state0, vgg, b


def train_stage_times(model, cfg, b, vgg, step):
    """Device time of each layer of one production step (CUDA events,
    median of warm runs); each backward takes a seeded random cotangent."""
    from diner_tpu_torch.losses import antibias_loss, vgg_loss
    from diner_tpu_torch.ops import composite_cuda
    from diner_tpu_torch.ops.sampling import (fill_up_uniform,
                                              sample_depthguided,
                                              sample_depthguided_pruned)
    from diner_tpu_torch.renderer import draw_noise
    from diner_tpu_torch.train.diner import (SRC_KEYS, select_pixels,
                                             target_rays)
    rc = cfg.renderer
    g = torch.Generator(device="cuda").manual_seed(5)
    src = [b[k] for k in SRC_KEYS]
    H, W = b["target_rgb"].shape[1:3]
    pix = select_pixels(cfg, b, g)
    rays = torch.gather(target_rays(cfg, b, H, W), 1,
                        pix[..., None].expand(-1, -1, 8))
    NR, K = rays.shape[1], rc.n_samples
    u_coarse, gauss, u_fill = draw_noise(rc, 1, NR, generator=g,
                                         device="cuda")
    with torch.no_grad():
        ctx = model.encode(*src)
    g_lat = torch.randn(ctx.latent.shape, generator=g, device="cuda"
                        ).to(ctx.latent.dtype)

    def encode_fb():
        model.encode(*src).latent.backward(g_lat)

    def sampler():
        with torch.no_grad():
            z = sample_depthguided(rays, ctx.view_maps(), K,
                                   rc.n_depth_candidates, u_coarse, gauss,
                                   rc.n_gaussian, rc.depth_diff_max)
            return fill_up_uniform(z, rays, u_fill)

    def sampler_pruned():
        with torch.no_grad():
            z = sample_depthguided_pruned(
                rays, ctx.view_maps(), K, rc.n_depth_candidates,
                PRUNED["n_coarse_candidates"], PRUNED["n_refine_bins"],
                u_coarse, gauss, rc.n_gaussian, rc.depth_diff_max)
            return fill_up_uniform(z, rays, u_fill)

    z = sampler()
    pts = (rays[..., None, :3] + z[..., None] * rays[..., None, 3:6]
           ).reshape(1, -1, 3)
    dirs = rays[..., None, 3:6].expand(1, NR, K, 3).reshape(1, -1, 3)
    ctx_g = dataclasses.replace(ctx,
                                latent=ctx.latent.detach().requires_grad_())
    g_field = torch.randn((1, NR * K, 4), generator=g, device="cuda")

    def field_fb():
        model.field(ctx_g, pts, dirs).backward(g_field)

    out = torch.rand((1, NR, K, 4), generator=g, device="cuda"
                     ).requires_grad_()
    g_rgb = torch.randn((1, NR, 3), generator=g, device="cuda")

    def composite_fb():
        o = composite_cuda.composite(out[..., :3], out[..., 3], z, rays,
                                     rc.white_bkgd)
        o.rgb.backward(g_rgb)

    s = cfg.vgg_spatch
    pred = torch.rand((1, s, s, 3), generator=g, device="cuda"
                      ).requires_grad_()
    gt = torch.rand((1, s, s, 3), generator=g, device="cuda")

    def losses_fb():
        loss = (cfg.w_vgg * vgg_loss(vgg, pred, gt, dtype=model.dtype)
                + cfg.w_antibias * antibias_loss(pred, gt,
                                                 cfg.antibias_downsampling))
        loss.backward()

    ms = {
        "encode_fwd_bwd_ms": cuda_time_ms(encode_fb, 5, 1),
        "sampler_ms": cuda_time_ms(sampler, 10, 2),
        "sampler_pruned_ms": cuda_time_ms(sampler_pruned, 10, 2),
        "field_fwd_bwd_ms": cuda_time_ms(field_fb, 5, 1),
        "composite_a_b_ms": cuda_time_ms(composite_fb),
        "vgg_antibias_fwd_bwd_ms": cuda_time_ms(losses_fb, 10, 2),
        # last: it moves the weights (the grads are the last step's)
        "adam_step_ms": cuda_time_ms(step.optimizer.step, 10, 2),
    }
    emit("train_stages", rays=NR, samples=K, **ms,
         sum_ms=sum(v for k, v in ms.items() if k != "sampler_pruned_ms"))


def phase_train_grad_f32(state, vgg, b):
    """One 1024-ray production step at f32 through kernels A and B and
    through the plain composite (autograd of its tensor ops): same weights,
    noise and pixels; the loss and every parameter's gradient compared."""
    from diner_tpu_torch.models.pixelnerf import PixelNeRF
    from diner_tpu_torch.ops import composite_cuda
    from diner_tpu_torch.renderer import draw_noise
    from diner_tpu_torch.train.diner import compute_losses, select_pixels
    base = dtu_train_config()
    cfg = dataclasses.replace(
        base, vgg_spatch=32,
        nerf=dataclasses.replace(base.nerf, compute_dtype="float32"))
    m32 = PixelNeRF(cfg.nerf)
    m32.load_state_dict(state)
    m32.cuda()
    g = torch.Generator(device="cuda").manual_seed(6)
    pix = select_pixels(cfg, b, g)
    noise = draw_noise(cfg.renderer, 1, cfg.rays_per_step, generator=g,
                       device="cuda")
    res = {}
    for impl in ("pallas", "torch"):
        c = dataclasses.replace(cfg, renderer=dataclasses.replace(
            cfg.renderer, composite_impl=impl))
        m32.zero_grad(set_to_none=True)
        composite_cuda.launches = composite_cuda.bwd_launches = 0
        total, _ = compute_losses(m32, c, b, vgg, noise=noise, pix_idcs=pix)
        total.backward()
        torch.cuda.synchronize()
        res[impl] = (total.item(),
                     {n: t.clone() for n, t in grads_of(m32).items()},
                     (composite_cuda.launches, composite_cuda.bwd_launches))
    check(res["pallas"][2] == (1, 1) and res["torch"][2] == (0, 0),
          f"launches kernel path {res['pallas'][2]}, plain {res['torch'][2]}")
    loss_err = abs(res["pallas"][0] - res["torch"][0]) / abs(res["torch"][0])
    worst, name, nonzero = grad_errs(res["pallas"][1], res["torch"][1])
    emit("train_grad_f32", rays=cfg.rays_per_step,
         loss_kernels=res["pallas"][0], loss_plain=res["torch"][0],
         loss_rel_err=loss_err, worst_grad_err_over_norm=worst,
         worst_param=name, params=len(res["torch"][1]),
         params_grad_nonzero=nonzero, tol=1e-3)
    # 1e-3 of the norm: the kernels sum in another order, and the latent's
    # scatter-add and cuDNN's backward use atomics in a changing order
    check(loss_err <= 1e-5 and worst <= 1e-3,
          f"f32 step, kernels vs plain composite: loss {loss_err}, "
          f"grad {worst} at {name}")


def phase_train_small_reference(pruned=False):
    """A small production step on the card against the same step on the
    CPU: same weights, VGG, pixels and noise, f32; with the one-stage or
    the pruned sampler (64 candidates: 16 coarse bins of 4, 4 refined)."""
    import copy

    from diner_tpu_torch.data.synthetic import make_sphere_scene
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.models.pixelnerf import PixelNeRFConfig
    from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
    from diner_tpu_torch.ops import composite_cuda, gather_cuda
    from diner_tpu_torch.renderer import RendererConfig, draw_noise
    from diner_tpu_torch.train.diner import (DinerConfig, batch_to_device,
                                             compute_losses, create_model,
                                             select_pixels)
    cfg = DinerConfig(
        nerf=PixelNeRFConfig(encoder=SpatialEncoderConfig(
            backbone="resnet18", num_layers=2, image_padding=8), d_hidden=32),
        renderer=RendererConfig(n_samples=8, n_depth_candidates=64,
                                n_gaussian=3, white_bkgd=False,
                                n_coarse_candidates=16 if pruned else 0,
                                n_refine_bins=4),
        w_vgg=0.1, vgg_spatch=16, w_antibias=1.0)
    batch = make_sphere_scene(H=32, W=40, nv=2)
    cpu_model = create_model(cfg, batch, seed=0, device="cpu")
    cpu_vgg = init_vgg19(0, device="cpu")
    g = torch.Generator().manual_seed(2)
    b_cpu = batch_to_device(batch, "cpu")
    pix = select_pixels(cfg, b_cpu, g)
    noise = draw_noise(cfg.renderer, 1, cfg.rays_per_step, generator=g)
    res = {}
    for where, dev in (("cpu", "cpu"), ("card", "cuda")):
        m = copy.deepcopy(cpu_model).to(dev)
        composite_cuda.launches = composite_cuda.bwd_launches = 0
        gather_cuda.launches = 0
        total, _ = compute_losses(
            m, cfg, batch_to_device(batch, dev),
            copy.deepcopy(cpu_vgg).to(dev), pix_idcs=pix.to(dev),
            noise=tuple(t.to(dev) for t in noise))
        total.backward()
        res[where] = (total.item(), grads_of(m),
                      (composite_cuda.launches, composite_cuda.bwd_launches,
                       gather_cuda.launches))
    expected = (1, 1, 7 if pruned else 6)
    check(res["card"][2] == expected and res["cpu"][2] == (0, 0, 0),
          f"card step launches {res['card'][2]}, expected {expected}; "
          f"CPU step {res['cpu'][2]}")
    loss_err = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    worst, name, nonzero = grad_errs(res["card"][1], res["cpu"][1])
    emit("train_small_reference", sampler="pruned" if pruned else
         "one-stage", rays=cfg.rays_per_step,
         loss_card=res["card"][0], loss_cpu=res["cpu"][0],
         loss_rel_err=loss_err, worst_grad_err_over_norm=worst,
         worst_param=name, params=len(res["cpu"][1]),
         params_grad_nonzero=nonzero, tol=1e-3)
    # 1e-3 of the norm: convolutions, matmuls and scatter-adds sum in
    # another order on the card, through the train-mode BN backward
    check(loss_err <= 1e-4 and worst <= 1e-3,
          f"card vs CPU step: loss {loss_err}, grad {worst} at {name}")


TRAIN_LOOP_DIR = OUT_DIR / "train_loop"
TRAIN_LOOP_HW = (512, 640)  # the DTU image size of configs/train_dtu.yaml
TRAIN_LOOP_BATCH = 2  # scenes per step; 4 peaks above 40 GB in f32


def train_loop_config():
    """``configs/train_dtu.yaml`` read by the port's ``load_train_config``
    with only ``data`` replaced (the analytic sphere at the DTU image size:
    512×640, 4 source views; 8 train and 2 val scenes) and the trainer
    settings of this phase: 6 steps, a checkpoint every 3, one validation
    at step 6 over 2 images, a log row every step. Written as JSON (valid
    YAML) → its path."""
    from diner_tpu_torch.train.config import load_train_config
    raw = load_train_config(ROOT / "configs" / "train_dtu.yaml").raw

    def split(n, shuffle):
        return {"dataset": {"module": "synthetic_sphere",
                            "kwargs": {"n": n, "H": TRAIN_LOOP_HW[0],
                                       "W": TRAIN_LOOP_HW[1], "nv": 4}},
                "dataloader": {"kwargs": {"shuffle": shuffle,
                                          "batch_size": TRAIN_LOOP_BATCH}}}

    raw["data"] = {"train": split(8, True), "val": split(2, False)}
    raw["logger"]["kwargs"]["save_dir"] = str(TRAIN_LOOP_DIR / "runs")
    raw["trainer"]["kwargs"].update(max_steps=6, val_check_interval=6,
                                    log_every_n_steps=1)
    raw["checkpointing"]["kwargs"]["every_n_train_steps"] = 3
    raw["optimizer"]["kwargs"]["n_samples_score_eval"] = 2
    path = TRAIN_LOOP_DIR / "train_dtu_sphere.yaml"
    path.write_text(json.dumps(raw, indent=1))
    return path


def state_equal(saved, train_step):
    """Is the checkpoint's state ``train_step``'s, bit for bit?"""
    model = train_step.model.state_dict()
    opt = train_step.optimizer.state_dict()
    return (saved["step"] == train_step.step
            and sorted(saved["model"]) == sorted(model)
            and all(torch.equal(v, model[k].cpu())
                    for k, v in saved["model"].items())
            and saved["optimizer"]["param_groups"] == opt["param_groups"]
            and sorted(saved["optimizer"]["state"]) == sorted(opt["state"])
            and all(torch.equal(v, opt["state"][i][k].cpu())
                    for i, st in saved["optimizer"]["state"].items()
                    for k, v in st.items()))


def phase_train_loop():
    """The training entry point on the card: ``python -m
    diner_tpu_torch.train`` (a subprocess) takes steps 1-4 of
    ``train_loop_config()`` at full width (ResNet34, ResnetFC 5×512, 40
    samples from 1000 candidates, MSE + 0.1·VGG + 1.0·antibias, f32) with
    checkpoints at 3 and 4; then ``Trainer.fit(max_steps=6)`` in this
    process resumes from step 4, checkpoints and validates at step 6 (a
    prediction folder of 2 images, scored). Checks: the step counts; the
    checkpoints (6 is the fit's final state bit for bit; a fresh TrainStep
    restored from the CLI's 4 holds it bit for bit, and its step 5 on the
    fit's batch and generator state gives the fit's step-5 losses and
    update); finite logged rows; the scored folder; kernel launches per
    train step (A 1, B 1, C 6) and per validation image (A 80, C 480)."""
    import shutil
    import sys

    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.ops import composite_cuda, gather_cuda
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    from diner_tpu_torch.train import loop
    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.diner import (TrainStep, create_model,
                                             make_train_step)

    shutil.rmtree(TRAIN_LOOP_DIR, ignore_errors=True)
    TRAIN_LOOP_DIR.mkdir(parents=True)
    cfg_path = train_loop_config()
    run_cfg = load_train_config(cfg_path)
    ckpt_dir = run_cfg.run_dir / "checkpoints"
    H, W = TRAIN_LOOP_HW
    n_chunks = -(-H * W // run_cfg.diner.renderer.ray_chunk)

    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "diner_tpu_torch.train", str(cfg_path),
         "DINER", "--max-steps", "4", "--device", "cuda"], cwd=ROOT,
        capture_output=True,
        text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    (TRAIN_LOOP_DIR / "cli.log").write_text(cli.stdout + cli.stderr)
    check(cli.returncode == 0, f"train CLI exited {cli.returncode}: "
          f"{cli.stderr[-2000:]}")
    check(ckpt_lib.latest_checkpoint(ckpt_dir) == str(ckpt_dir /
                                                      "step_00000004"),
          f"CLI checkpoints {sorted(p.name for p in ckpt_dir.iterdir())}")

    def counts():
        return (composite_cuda.launches, composite_cuda.bwd_launches,
                gather_cuda.launches)

    # per call of the train step and of the eval step: (steps taken
    # before, launches of A, B and C, seconds to the end of its kernels)
    calls = {"train": [], "eval": []}

    def record(kind, taken, fn, *args, **kwargs):
        before, t = counts(), time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        calls[kind].append((taken, tuple(x - y for x, y in
                                         zip(counts(), before)),
                            time.perf_counter() - t))
        return out

    train_call, make_eval = TrainStep.__call__, loop.make_eval_step
    # the resumed fit's first step (4 -> 5): its batch, its generator's
    # state, its losses and the parameters after it
    step5 = {}

    def params_of(train_step):
        return torch.cat([p.detach().flatten()
                          for p in train_step.model.parameters()])

    def spied_train_call(self, batch, generator=None, **kwargs):
        first = self.step == 4 and not step5
        if first:
            step5.update(batch=batch, gen_state=generator.get_state())
        out = record("train", self.step, train_call, self, batch,
                     generator=generator, **kwargs)
        if first:
            step5.update(losses={k: float(v) for k, v in out.items()},
                         params=params_of(self))
        return out

    def spied_make_eval(*args, **kwargs):
        step = make_eval(*args, **kwargs)
        return lambda *a, **k: record("eval", None, step, *a, **k)

    TrainStep.__call__ = spied_train_call
    loop.make_eval_step = spied_make_eval
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    composite_cuda.launches = composite_cuda.bwd_launches = 0
    gather_cuda.launches = 0
    try:
        trainer = loop.Trainer(run_cfg, device="cuda")
        t1 = time.perf_counter()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            ts = trainer.fit(max_steps=6)
            torch.cuda.synchronize()
        t_fit = time.perf_counter() - t1
    finally:
        TrainStep.__call__, loop.make_eval_step = train_call, make_eval
    launches = counts()
    peak = torch.cuda.max_memory_allocated()

    check(ts.step == 6, f"resumed fit ended at step {ts.step}, expected 6")
    check([c[0] for c in calls["train"]] == [4, 5],
          f"resumed train steps began at {[c[0] for c in calls['train']]}")
    check(all(c[1] == (1, 1, 6) for c in calls["train"]),
          f"kernel A, B, C launches per train step "
          f"{[c[1] for c in calls['train']]}, expected (1, 1, 6)")
    check(len(calls["eval"]) == 2 and all(
        c[1] == (n_chunks, 0, 6 * n_chunks) for c in calls["eval"]),
        f"launches per validation image {[c[1] for c in calls['eval']]}, "
        f"expected ({n_chunks}, 0, {6 * n_chunks})")

    names = sorted(p.name for p in ckpt_dir.iterdir() if p.is_dir())
    check(names == ["step_00000003", "step_00000004", "step_00000006"],
          f"checkpoints {names}")
    saved = {n: ckpt_lib.load_state(ckpt_dir / n) for n in names}
    check(state_equal(saved["step_00000006"], ts),
          "checkpoint 6 is not the fit's final state bit for bit")
    check(saved["step_00000003"]["step"] == 3 and not all(
        torch.equal(v, saved["step_00000004"]["model"][k])
        for k, v in saved["step_00000003"]["model"].items()),
        "checkpoint 3 is not step 3's or equals step 4's")
    # a fresh TrainStep restored from the CLI's checkpoint 4 continues as
    # the resumed fit did: same losses at step 5 (the forward repeats),
    # same update (up to the order of the backward's atomic adds)
    dcfg = run_cfg.diner
    fresh = make_train_step(
        create_model(dcfg, step5["batch"], seed=0, device="cuda"), dcfg,
        init_vgg19(0, device="cuda") if dcfg.w_vgg > 0 else None)
    ckpt_lib.restore_checkpoint(ckpt_dir / "step_00000004", fresh)
    restored4 = state_equal(saved["step_00000004"], fresh)
    check(restored4, "checkpoint 4 not restored bit for bit")
    params4 = params_of(fresh)
    gen5 = torch.Generator(device="cuda")
    gen5.set_state(step5["gen_state"])
    losses5 = {k: float(v) for k, v in
               fresh(step5["batch"], generator=gen5).items()}
    loss_rel_diff = max(abs(losses5[k] - v) / max(abs(v), 1e-30)
                        for k, v in step5["losses"].items())
    update_rel_diff = float((params_of(fresh) - step5["params"]).norm()
                            / (step5["params"] - params4).norm())
    del fresh, params4, step5["params"]
    torch.cuda.empty_cache()
    check(sorted(losses5) == sorted(step5["losses"])
          and loss_rel_diff <= 1e-6 and update_rel_diff <= 1e-2,
          f"step 5 from checkpoint 4: losses {losses5} vs the fit's "
          f"{step5['losses']} (relative {loss_rel_diff}), update relative "
          f"difference {update_rel_diff}")

    rows = [json.loads(line) for line in (run_cfg.run_dir / "logs" /
                                          "metrics.jsonl").read_text()
            .splitlines()]
    train_rows = [r for r in rows if "total" in r]
    check([r["step"] for r in train_rows] == [1, 2, 3, 4, 5, 6],
          f"logged train steps {[r['step'] for r in train_rows]}")
    check(all(np.isfinite(v) for r in rows for v in r.values()),
          f"non-finite logged value in {rows}")
    eval_dir = run_cfg.run_dir / "eval_000006"
    preds = sorted((eval_dir / "visualizations").glob("*-pred.png"))
    check(len(preds) == 2, f"prediction folder holds {len(preds)} images")
    scores = json.loads((eval_dir / "average_scores.json").read_text())
    keys = ("psnr", "ssim", "l1", "l2", "lpips_proxy")
    check(all(np.isfinite(scores.get(k, float("nan"))) for k in keys),
          f"validation scores {scores}")

    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    from torch.autograd import DeviceType
    busy_ms = sum(getattr(e, attr) for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    (OUT_DIR / "chip_smoke_train_loop_profile.txt").write_text(
        events.table(sort_by=attr, row_limit=60))
    cli_steps = [1 / r["steps_per_sec"] for r in train_rows[:4]]
    emit("train_loop",
         config=f"configs/train_dtu.yaml, data: synthetic_sphere {H}x{W} "
         f"nv=4, batch {TRAIN_LOOP_BATCH}, f32; 6 steps, checkpoints every "
         "3, validation at 6 over 2 images",
         rays_per_step=run_cfg.diner.rays_per_step * TRAIN_LOOP_BATCH,
         cli_s=t_cli, cli_first_step_s=cli_steps[0],
         s_per_step=statistics.median(cli_steps[1:]),
         s_per_step_all=[1 / r["steps_per_sec"] for r in train_rows],
         step_alone_s=[c[2] for c in calls["train"]],
         validation_image_s=[c[2] for c in calls["eval"]],
         fit_resume_s=t_fit, peak_mem_bytes=peak,
         idle_share_fit=1 - busy_ms / (t_fit * 1e3), kernel_ms_fit=busy_ms,
         launches_composite_fwd=launches[0],
         launches_composite_bwd=launches[1],
         launches_row_gather=launches[2],
         launches_per_step=[c[1] for c in calls["train"]],
         launches_per_validation_image=[c[1] for c in calls["eval"]],
         checkpoints=names, restored_4_bit_for_bit=restored4,
         step5_loss_rel_diff=loss_rel_diff,
         step5_update_rel_diff=update_rel_diff,
         losses=[{k: r[k] for k in r if k not in ("step", "steps_per_sec")}
                 for r in train_rows],
         val_scores={k: scores[k] for k in keys})
    check(peak < 40e9, f"train loop peak memory {peak} B, limit 40 GB")
    return launches


def gather_row(table, idx, runs=30, cold=False):
    """Kernel C against ``table[idx]`` (plain) and ``index_select``
    (library) on one input: exactness, device times (``ms``, ``plain_ms``,
    ``library_ms``; with ``cold``, also the kernel's and the library's with
    L2 flushed before each call), the kernel's one-call ``call_ms``, and
    the bound: the distinct table rows the indices touch, read once, the
    indices at their width and the output written once."""
    from diner_tpu_torch.ops import gather_cuda
    got = gather_cuda.row_gather_kernel(table, idx)
    torch.cuda.synchronize()
    ref = gather_cuda.row_gather_plain(table, idx)
    exact = torch.equal(got, ref)
    err = (float((got.float() - ref.float()).abs().max())
           if got.numel() else 0.0)
    del got, ref
    row_bytes = table.shape[1] * table.element_size()
    distinct = int(torch.unique(idx).numel())
    n_bytes = (distinct * row_bytes + idx.numel() * idx.element_size()
               + idx.numel() * row_bytes)

    def kernel():
        return gather_cuda.row_gather_kernel(table, idx)

    def library():
        return torch.index_select(table, 0, idx)

    row = dict(
        R=table.shape[0], C=table.shape[1], dtype=str(table.dtype),
        P=idx.numel(), index_dtype=str(idx.dtype), exact=exact,
        max_abs_err=err, distinct_rows=distinct, **times_ms(kernel, runs),
        plain_ms=device_time_ms(lambda: table[idx]),
        library_ms=device_time_ms(library),
        library_call_ms=cuda_time_ms(library, runs),
        bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S, bound_by="bytes")
    if cold:
        row.update(ms_cold_l2=cold_device_time_ms(kernel),
                   library_ms_cold_l2=cold_device_time_ms(library))
    return row


# (case, R, C, dtype, P) — the path's row gathers: sampler maps (one-stage
# and one pruned stage), latent corners (all four corners of an eval chunk
# in one call, as the index_select yardstick of earlier runs took them;
# one corner in eval and in training), the depth lookup, the pair table's
# row fetch, and the C = 128 f32 proxy of scripts/gather_lab.py
GATHER_CASES = (
    ("sampler_map_c5_f32", 4 * 512 * 640, 5, torch.float32, 4 * 4096 * 1000),
    ("sampler_map_c5_f32_pruned_stage", 4 * 512 * 640, 5, torch.float32,
     4 * 4096 * 128),
    ("latent_c512_bf16", 4 * 320 * 384, 512, torch.bfloat16,
     4 * 4096 * 64 * 4),
    ("latent_corner_c512_bf16", 4 * 320 * 384, 512, torch.bfloat16,
     4 * 4096 * 64),
    ("latent_corner_c512_bf16_train", 4 * 320 * 384, 512, torch.bfloat16,
     4 * 4096 * 40),
    ("depth_c1_f32", 4 * 512 * 640, 1, torch.float32, 4 * 4096 * 64),
    ("pair_row_c1024_bf16", 4 * 320 * 384, 1024, torch.bfloat16,
     4 * 4096 * 64),
    ("lab_proxy_c128_f32", 4 * 512 * 640, 128, torch.float32, 512_000),
)


def gather_edge_tables(device, seed=0):
    """Small tables of every row width the kernel takes (4 B to 2 KB; f32
    and bf16), aligned, at odd offsets and with strided rows; also read by
    tests/test_torch_kernels.py."""
    g = torch.Generator().manual_seed(seed)
    wide = torch.randn((4001, 9), generator=g).to(device)
    big = torch.randn((4001, 1024), generator=g).bfloat16().to(device)
    return {
        "c1_f32": wide[:, 0].contiguous()[:4000, None],
        "c1_f32_offset_4B": wide.reshape(-1)[1:4001, None],
        "c3_f32": wide.reshape(-1)[:4000 * 3].view(4000, 3),
        "c5_f32_offset_36B": wide.reshape(-1)[9:9 + 4000 * 5].view(4000, 5),
        "c5_f32_strided_rows": wide[1:, 2:7],
        "c7_bf16_offset_2B": wide.bfloat16().reshape(-1)[1:1 + 4000 * 7]
        .view(4000, 7),
        "c8_f32": wide[:, :8].contiguous()[:4000],
        "c16_f32": torch.randn((4000, 16), generator=g).to(device),
        "c128_f32": torch.randn((4000, 128), generator=g).to(device),
        "c512_bf16": big[:4000, :512].contiguous(),
        "c512_bf16_offset_4B": big.reshape(-1)[2:2 + 4000 * 512]
        .view(4000, 512),
        "c1024_bf16": big[:4000],
        "c1024_bf16_strided_rows": big[1:, :1000],
    }


def phase_kernel_gather():
    """Kernel C at the path's shapes (uniform random rows, int64 indices
    as the port builds them; the lab proxy int32 as gather_lab.py), then
    edge cases at every row width, aligned, unaligned and strided, with
    int32 and int64 indices: P = 50,001 (no multiple of the rows a thread
    or warp takes), P = 1, R = 1, and out-of-range indices (clamped).
    Every case must be exact."""
    from diner_tpu_torch.ops import gather_cuda
    g = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for name, n_rows, C, dtype, P in GATHER_CASES:
        table = torch.randn((n_rows, C), generator=g, device="cuda").to(dtype)
        idx = torch.randint(0, n_rows, (P,), generator=g, device="cuda",
                            dtype=torch.int32 if C == 128 else torch.int64)
        row = dict(case=name, **gather_row(table, idx))
        emit("kernel_gather", name="row_gather", **row)
        check(row["exact"], f"row gather kernel vs plain {row}")
        rows.append(row)
        del table, idx
        torch.cuda.empty_cache()

    idx = torch.randint(0, 4000, (50_001,), generator=g, device="cuda")
    bad = torch.tensor([-5, 0, 3999, 4000, 10 ** 12, -(10 ** 12), 17],
                       device="cuda")
    for name, table in gather_edge_tables("cuda").items():
        for index_dtype in (torch.int64, torch.int32):
            ix = idx.to(index_dtype)
            out_of_range = (bad if index_dtype == torch.int64 else
                            bad.clamp(-2 ** 31, 2 ** 31 - 1).int())
            for case, t, i in (
                    (name, table, ix), (name + "_P1", table, ix[:1]),
                    (name + "_R1", table[:1], ix.clamp(max=0)),
                    (name + "_clamped", table, out_of_range)):
                got = gather_cuda.row_gather_kernel(t, i)
                torch.cuda.synchronize()
                exact = torch.equal(got, t[i.long().clamp(0, len(t) - 1)])
                row = dict(case=case, R=t.shape[0], C=t.shape[1],
                           dtype=str(t.dtype), P=i.numel(),
                           index_dtype=str(index_dtype), exact=exact,
                           max_abs_err=0.0 if exact else float("inf"))
                emit("kernel_gather", name="row_gather", **row)
                check(exact, f"row gather kernel vs plain {row}")
                rows.append(row)
    return rows


def capture_gathers(fn):
    """Run ``fn`` and return the (table, idx) of every row gather it made
    through the grid-sample and sampler modules, in call order."""
    from diner_tpu_torch.ops import gather_cuda, grid_sample, sampling
    calls = []

    def spy(table, idx):
        calls.append((table, idx))
        return gather_cuda.row_gather(table, idx)

    saved = grid_sample.row_gather, sampling.row_gather
    grid_sample.row_gather = sampling.row_gather = spy
    try:
        fn()
    finally:
        grid_sample.row_gather, sampling.row_gather = saved
    return calls


GATHER_KINDS = {(5, torch.float32): "sampler_map", (1, torch.float32): "depth",
                (512, torch.bfloat16): "latent_corner",
                (1024, torch.bfloat16): "pair_row"}


def gather_path(model, cfg, batch, H, W):
    """Kernel C at the indices one 4096-ray chunk through the image centre
    hands it (spatially coherent, unlike the random rows above), for the
    one-stage, pruned and pair-table renders: warm, as repeated calls
    leave the touched rows in L2, and with L2 flushed before each call, as
    the render, whose field passes run between the gathers, finds it.
    Returns {config: launches}."""
    from diner_tpu_torch.renderer import draw_noise, render_rays
    from diner_tpu_torch.train.diner import (SRC_KEYS, batch_to_device,
                                             target_rays)
    rc = cfg.renderer
    b = batch_to_device(batch, "cuda")
    start = (H * W) // 2 - rc.ray_chunk // 2
    rays = target_rays(cfg, b, H, W)[:, start:start + rc.ray_chunk]
    rays = rays.contiguous()
    noise = draw_noise(rc, 1, rc.ray_chunk, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(4))
    counts = {}
    with torch.no_grad():
        ctx = model.encode(*(b[k] for k in SRC_KEYS))
        for name, c, rcfg in (
                ("one_stage", ctx, rc), ("pairs", ctx.with_latent_pairs(), rc),
                ("pruned", ctx, dataclasses.replace(rc, **PRUNED))):
            calls = capture_gathers(lambda: render_rays(
                model.field, c, rays, rcfg, noise=noise))
            counts[name] = len(calls)
            for i, (table, idx) in enumerate(calls):
                kind = GATHER_KINDS[(table.shape[1], table.dtype)]
                row = dict(config=name, call=i, kind=kind,
                           **gather_row(table, idx, runs=20, cold=True))
                emit("gather_path", **row)
                check(row["exact"], f"row gather kernel vs plain {row}")
            del calls
    check(counts == {"one_stage": 6, "pairs": 4, "pruned": 7},
          f"row gathers per chunk {counts}, expected 6 / 4 / 7")
    return counts


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs an "
                         "NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    phase_build()
    rows = phase_kernel()
    bwd_rows = phase_kernel_bwd()
    gather_rows = phase_kernel_gather()
    eval_l, ev = phase_path()
    pairs_l = phase_path_pairs(ev)
    pruned_l = phase_path_pruned(ev)
    del ev
    torch.cuda.empty_cache()
    phase_small_reference()
    train_l, state, vgg, b = phase_train_path()
    phase_train_grad_f32(state, vgg, b)
    del state, vgg, b
    torch.cuda.empty_cache()
    train_pruned_l = phase_train_path(pruned=True)[0]
    torch.cuda.empty_cache()
    phase_train_small_reference()
    phase_train_small_reference(pruned=True)
    torch.cuda.empty_cache()
    train_loop_l = phase_train_loop()

    paths = {"eval_render": eval_l, "eval_render_pairs": pairs_l,
             "eval_render_pruned": pruned_l, "train_steps": train_l,
             "train_steps_pruned": train_pruned_l, "train_loop": train_loop_l}

    def entry(name, row_list, main, replaces, which, library_ms=None):
        by_path = {p: launches[which] for p, launches in paths.items()}
        return {
            "name": name, "route": "cuda",
            "source": f"diner_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in row_list),
            "ms": main["ms"], "call_ms": main["call_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": library_ms,
        }

    # kernel C's row: one eval latent corner (the path's largest gather
    # by bytes, 320 of an image's 480 launches); every timed case beside it
    corner = next(r for r in gather_rows
                  if r["case"] == "latent_corner_c512_bf16")
    timed = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")
    kernels = [
        dict(entry("composite_fwd", rows,
                   next(r for r in rows if (r["R"], r["K"]) == (4096, 64)
                        and "ms" in r),
                   "diner_tpu/ops/pallas/composite_pallas.py:29", 0),
             cases=[{k: r[k] for k in ("R", "K") + timed if k in r}
                    for r in rows if "ms" in r]),
        # the train step's case: R = 4096, K = 40, only g_rgb
        dict(entry("composite_bwd", bwd_rows,
                   next(r for r in bwd_rows if "ms" in r
                        and not r["g_depth_and_g_w"]),
                   "diner_tpu/ops/pallas/composite_pallas.py:54", 1),
             err_d_sigma_over_scale={
                 kind: max(r["err_d_sigma_over_scale"] for r in bwd_rows
                           if r["saturated"] == sat)
                 for kind, sat in (("unsaturated", False),
                                   ("saturated", True))}),
        dict(entry("row_gather", gather_rows, corner,
                   "diner_tpu/ops/pallas/gather_pallas.py:45", 2,
                   library_ms=corner["library_ms"]),
             main_case=corner["case"],
             cases=[{k: r[k] for k in ("case", "C", "P") + timed}
                    for r in gather_rows if "ms" in r],
             path_cases=[{k: r[k] for k in ("config", "call", "kind", "P",
                                            "distinct_rows", "ms_cold_l2",
                                            "library_ms_cold_l2") + timed}
                         for r in LOG if r["phase"] == "gather_path"]),
    ]
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
