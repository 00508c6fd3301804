#!/usr/bin/env python3
"""Chip smoke run of the PyTorch port (``diner_tpu_torch``) on one NVIDIA GPU.

Builds every CUDA kernel of the port from the sources in this checkout
(kernel A, the compositing forward; kernel B, its backward; kernel C, the
row gather; the DCN sampler's backward; NOVEL's top-1 kNN; kernel R, the
mesh z-buffer of the preprocessing), holds each against its plain PyTorch
version on the card (kernel R bit for bit at its edge cases and on a
50,400-face head mesh at multiface's 2048×1334; the kNN's indices exactly,
at edge cases, past 2³¹ / 3 point offsets and at the NOVEL step's shapes
on 26,317 vertices) (the DCN backward at edge positions, odd and
even W, C = 5 and 32, with and without its scale, f32 and bf16, and at
the stage-3 tap of the 512×640 TransMVSNet training step)
(kernel B at K = 1-100 around its 32-sample chunks and its register path,
R = 4096 and 4097, white or not, with and without g_depth and g_w, strided
or contiguous rgb, random samples, samples at alpha ~ 1 and a large
|prefix| before the later samples), then
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
- inference (``predict``): ``python -m diner_tpu_torch.predict`` on
  ``configs/evaluate_diner_on_dtu.yaml`` with ``data`` replaced by the
  sphere at 512×640 (its full width, f32) renders and scores 3 validation
  images from a reference Lightning ``.ckpt``, at 64 samples and with
  ``--nsamples 32``; ``python -m diner_tpu_torch.evaluate`` re-scores the
  first folder and ``compare_evaluations`` compares both. Checks: the
  loaded weights are the checkpoint's bit for bit, 4 files per sample,
  finite scores, ``comparison.json`` names both, A 80 and C 480 launches
  per image.
- pretrained weights (``pretrained``): seeded ``.pth`` files in the
  torchvision / lpips schemas go through ``python -m
  diner_tpu_torch.import_pretrained``; with ``DINER_TPU_PRETRAINED`` set in
  this phase only, ``create_model`` grafts ResNet34 (conv1's RGB slice the
  file's, its PE channels the seeded draw's), VGG19 loads, and
  ``evaluate_folder`` reports ``lpips``, not ``lpips_proxy``.
- TransMVSNet depth inference (``mvs_*``): ``python -m
  diner_tpu_torch.data.dtu_fixture`` writes one fabricated DTU scan;
  ``python -m diner_tpu_torch.mvs --mode write_prediction`` maps its 4
  quad-grid targets at 512×640 from 4 views with the default model
  (ndepths 48/32/8, 192 hypotheses, f32) read from a seeded checkpoint in
  the reference's schema; kernel C is timed at the indices of one
  plane-sweep chunk per stage and one DCN tap (``gather_mvs``); ``python
  -m diner_tpu_torch.mvs.evaluate`` maps a test-layout scan of 5 views at
  864×1152 and fuses it (``normal``, then ``gipuma``), and the fixture's
  ground-truth depths go through both fusion backends; a small
  TransMVSNet on the card is held against the CPU. Checks: loaded weights
  bit for bit, the files of both CLIs, finite depth inside the cascade's
  reach, kernel C 456 (4 views) and 500 (5 views) times per map, fused
  shares of the ground truth.
- TransMVSNet training (``mvs_train``): ``python -m diner_tpu_torch.mvs
  --mode train`` in subprocesses at the CLI's defaults (512×640, 4 views,
  48/32/8, 192 hypotheses, batch 1) on the fixture's scan: f32 for 6
  steps, bf16 for 2, autograd of the DCN gathers for 3, ``--remat`` full
  and selective for 1, a second process resuming the f32 run for 2; then
  ``write_prediction`` from the trained checkpoint and ``--mode profile``;
  one warm f32 step under the profiler (``mvs_train_profile``), and one
  small step on the card against the CPU (``mvs_train_small_reference``).
  Checks: finite losses, no step skipped, kernel C 456 (912 full remat,
  588 selective) and the DCN backward 81 times per step, each process's
  peak within 0.95 of the card, the resume, the written maps, the trace;
  loss, gradients and BN statistics card vs CPU.
- the one-command pipeline (``pipeline``, after the TransMVSNet phases):
  ``python -m diner_tpu_torch.pipeline`` on the fixture (all 49 cameras)
  at its full recipe's widths, the reference DTU recipe (TransMVSNet
  512×640, 48/32/8 of 192, bf16, remat; DINER ResNet34, ResnetFC 5 × 512,
  40 of 1000 samples, 15 Gaussians, 128 rays, a 64 px VGG patch, at
  downsample 0.5; the prediction folder at 512×640 with 64 samples), only
  its depth cut (3 MVS steps, 25 DINER steps, one validation hook of 2
  views and a 2-frame sweep, 2 images scored): TransMVSNet training →
  write_prediction into the tree → DINER training on those PNGs → the
  prediction folder → its scores, each stage a subprocess whose launch
  counts are read; after it ``python -m diner_tpu_torch.fusion`` fuses
  the fixture's ground truth and ``mvs_test``'s gipuma folder. Checks:
  every stage's exit code and launches (C and the DCN backward per MVS
  step, C per map, A, B and C per DINER step, A and C per image), the
  source depths DINER reads equal to the written PNGs and within one PNG
  unit of the maps made, finite losses and logged rows, 2 pred / gt
  pairs, finite scores in ``PIPELINE_RESULT.json``, the fusion CLI's
  points those of the gipuma PLY and as many as the in-process fusion of
  the ground truth.
- NOVEL / NOVEL_PE (``novel_*``, before the TransMVSNet phases):
  ``configs/train_novel_facescape.yaml``'s model, renderer and optimizer
  (ResNet34 with the 64 px ring, ResnetFC 5 × 512, 40 of 1000 samples, 15
  Gaussians, a 64×64 patch with MSE + 0.1·VGG19 + 1.0·antibias, Adam at
  1e-4, f32) on the sphere at FaceScape's shape (256×256, 2 source views, 26,317 mesh vertices): ``python -m
  diner_tpu_torch.train <yaml> NOVEL`` (then NOVEL_PE) takes 3 steps in a
  subprocess, then 5 warm steps in this process and one under the
  profiler; the trained NOVEL renders one 256×256 image in 4,096-ray
  chunks; one small step of each on the card against the CPU. Checks: the
  CLI's checkpoint, finite losses and gradients (the plane's too), launches
  per step (A 1, B 1, C 13 / 21, DCN 0, kNN 3) and per image (A 16, C
  208, kNN 48), each peak within 0.95 of the card, the loss and every
  gradient card vs CPU.
- KeypointNeRF (``keypointnerf_*``, after the NOVEL phases):
  ``configs/train_keypointnerf_facescape.yaml``'s model at its full width
  (HGFilterV2 of 64 channels, 1 stack, 4 downsamples; the ResBlk texture
  encoder at ngf 64, 3 down, 4 blocks, 2 up, 8 channels; 68 keypoints;
  a 64×64 patch, 64 + 64 samples; L1 1.0 coarse, 10.0 fine, 0.5 VGG19;
  Adam at 1e-4; f32) on the sphere at FaceScape's shape (256×256, 2
  source views): ``python -m diner_tpu_torch.train <yaml> KeypointNeRF``
  takes 3 steps in a subprocess, then 5 warm steps in this process and
  one under the profiler; the trained model renders one 256×256 image
  with ``render_full_image`` (16 calls of 16 strided tiles); one small
  step on the card against the CPU. Checks: the CLI's checkpoint, finite
  losses and gradients, kernel C 40 times per step and 640 per image (4
  corners of 5 bilinear samples in each of 2 passes) and no other kernel,
  each peak within 0.95 of the card, the loss and every gradient card vs
  CPU. ``kernel_gather`` holds kernel C at the fine pass's tables (C = 1,
  3, 8, 64 f32; 1,048,576 rows) beside ``index_select``.
- preprocessing and multiface (after the KeypointNeRF phases): ``python
  -m diner_tpu_torch.preprocess_multiface`` at 2048×1334 renders the depth
  and mask PNGs of a fabricated subject (16 ring cameras in a KRT file, 2
  tracked frames of the head mesh, mm) through kernel R; ``python -m
  diner_tpu_torch.predict`` on ``configs/evaluate_diner_on_multiface.yaml``
  (full width, 4 source views at 256×160) renders and scores 2 images
  from those PNGs and a seeded Lightning ``.ckpt``; ``python -m
  diner_tpu_torch.mvs --dataset multiface --mode train`` takes 2 steps at
  the CLI's defaults on the same subject; ``python -m
  diner_tpu_torch.preprocess_facescape --crop_out 256`` processes a
  fabricated raw FaceScape pose (4 views at 2048×1334, a PLY scan) and
  ``FacescapeDataset`` reads the views back. Checks: R once per map, once
  per raw view and once per calibrated view; the first PNG equal to
  ``float32_2_uint16`` of the plain map; masks equal depth ≠ 0; the source
  depths DINER reads equal the PNGs; C 6 per ray chunk, 5 per calibrated
  view, 456 and the DCN backward 81 per MVS step; finite scores and
  losses.
- the training entry point (``train_loop``): ``configs/train_dtu.yaml``
  through the port's ``load_train_config`` with ``data`` replaced by the
  sphere at 512×640 (4 views, the config's 4 scenes a step, f32) and a
  camera sweep cut to 3 frames: ``python -m diner_tpu_torch.train`` takes
  steps 1-4 in a subprocess, then ``Trainer.fit`` resumes to step 6 in
  this process, checkpointing and validating there. Checks: step counts,
  every checkpoint restoring bit for bit, finite logged rows, a scored
  prediction folder of 2 images, the sweep's animation, kernels A, B and C
  once, once and 6 times per step, A 80 and C 480 times per validation or
  sweep image, the CLI's and the fit's peak allocation each within 0.95
  of the card's memory.

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
of every phase line goes to ``outputs/chip_smoke/chip_smoke.json``; what
the phases write there besides that log and the profile tables is deleted
at the end.

Run from the repository root:  python3 chip_smoke.py
"""

import dataclasses
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from diner_tpu_torch.utils.profiling import (
    cold_device_time_ms,
    cuda_time_ms,
    device_time_ms,
    time_fn,
)

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
T0 = time.perf_counter()


def emit(phase, **fields):
    line = {"phase": phase, **fields,
            "elapsed_s": time.perf_counter() - T0}
    LOG.append(line)
    print(json.dumps(line), flush=True)


def check(cond, what):
    if not cond:
        raise SystemExit(f"chip_smoke: check failed: {what}")


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
    return seconds


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


def train_loop_composite_shape():
    """(R, K) that kernels A and B get once per step of the ``train_loop``
    phase: ``TRAIN_LOOP_BATCH`` scenes of ``configs/train_dtu.yaml``'s
    ``rays_per_step`` rays (the kernels merge the scene and ray axes), its
    ``n_samples`` samples each. Both kernels' checks add this case, so a
    change of the batch or the config moves it with them."""
    from diner_tpu_torch.train.config import load_train_config
    dcfg = load_train_config(ROOT / "configs" / "train_dtu.yaml").diner
    return TRAIN_LOOP_BATCH * dcfg.rays_per_step, dcfg.renderer.n_samples


def phase_kernel():
    """Kernel A against ``composite`` on the card, at every case of
    ``COMPOSITE_CASES`` and the train loop's ``train_loop_composite_shape``,
    white background or not, for the field's strided rgb and a contiguous
    one."""
    from diner_tpu_torch.ops import composite as plain
    from diner_tpu_torch.ops import composite_cuda
    rows = []
    for R, K in COMPOSITE_CASES + (train_loop_composite_shape(),):
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
# R no multiple of the rays per block, and two scenes of the training step
# (8192 x 40, where half a warp per ray was kept); timed at (4096, 40).
# phase_kernel_bwd adds the train loop's train_loop_composite_shape()
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


FRONT_SAMPLES = 16  # the dense run of front_load


def front_load(sigma, z, g):
    """Puts a large |prefix| before the later samples (in place): on every
    ray the first ``FRONT_SAMPLES`` samples move to a run 1e-5 apart just
    before sample 16, with sigma * delta in [0.8, 1.2] each, so they hold
    all but about e^-16 of the ray's weight while their own d_sigma (a
    factor delta = 1e-5) stays small. For every later sample S_k is then
    about 1e-7 of sum_j dL/dw_j * w_j: total - prefix_k cancels there to
    the last digits, and its error, times that sample's delta (about
    0.04), is some 1e-3 of the largest d_sigma in an f32 emulation, where
    a suffix sum stays within some 1e-7. Needs K > ``FRONT_SAMPLES``."""
    R, K = sigma.shape[-2:]
    m = FRONT_SAMPLES
    dev = sigma.device
    z[..., :m] = z[..., m:m + 1] - 1e-5 * (m - torch.arange(m, device=dev))
    sigma[..., :m] = (0.8 + 0.4 * torch.rand((1, R, m), generator=g,
                                             device=dev)) / 1e-5


def composite_bwd_case(R, K, white, with_g_w, contiguous_rgb, device,
                       saturated=False, front_loaded=False):
    """Kernel B's arguments for one case: the field's views (or a
    contiguous rgb) and seeded cotangents; g_depth and g_w are None (as the
    train step hands them) unless ``with_g_w``; ``saturated``: samples at
    alpha ~ 1 (``saturate``); ``front_loaded``: a large |prefix| before
    the later samples (``front_load``)."""
    rgb, sigma, z, rays = field_case(R, K, 7 * R + K + white,
                                     contiguous_rgb, device)
    g = torch.Generator(device=device).manual_seed(K + with_g_w)
    if saturated:
        saturate(sigma, z, rays[..., 7], g)
    if front_loaded:
        front_load(sigma, z, g)
    g_rgb = torch.randn((1, R, 3), generator=g, device=device)
    g_depth, g_w = ((torch.randn((1, R), generator=g, device=device),
                     torch.randn((1, R, K), generator=g, device=device))
                    if with_g_w else (None, None))
    return rgb, sigma, z, rays, g_rgb, g_depth, g_w, white


# the input patterns of kernel B's checks: plain random samples, samples
# at alpha ~ 1 (saturate) and a large |prefix| before the later samples
# (front_load, where K > FRONT_SAMPLES)
BWD_PATTERNS = ("random", "saturated", "front_loaded")


def phase_kernel_bwd():
    """Kernel B against ``composite_bwd`` on the card, at every case of
    ``COMPOSITE_BWD_CASES`` and the train loop's
    ``train_loop_composite_shape``, white background or not, with only g_rgb (the
    train step's case: its depth and weights outputs are unused) or with
    g_depth and g_w too, for the field's strided rgb and a contiguous one,
    with each of ``BWD_PATTERNS``."""
    from diner_tpu_torch.ops import composite as plain
    from diner_tpu_torch.ops import composite_cuda
    rows = []
    for (R, K), white, with_g_w, contiguous_rgb, pattern in \
            itertools.product(COMPOSITE_BWD_CASES
                              + (train_loop_composite_shape(),),
                              (False, True),
                              (False, True), (False, True), BWD_PATTERNS):
        if pattern == "front_loaded" and K <= FRONT_SAMPLES:
            continue
        saturated = pattern == "saturated"
        args = composite_bwd_case(R, K, white, with_g_w, contiguous_rgb,
                                  "cuda", saturated,
                                  pattern == "front_loaded")
        rgb, sigma, z, rays, g_rgb, g_depth, g_w, _ = args
        got = composite_cuda.composite_bwd_kernel(*args)
        torch.cuda.synchronize()
        ref = plain.composite_bwd(rgb, sigma, z, rays[..., 7], *args[4:])
        err_rgb = max_err(got[:1], ref[:1])
        err_sigma = max_err(got[1:], ref[1:])
        scale = float(ref[1].abs().max())
        row = dict(R=R, K=K, white_bkgd=white, g_depth_and_g_w=with_g_w,
                   contiguous_rgb=contiguous_rgb, saturated=saturated,
                   pattern=pattern,
                   max_abs_err=max(err_rgb, err_sigma), err_d_rgb=err_rgb,
                   err_d_sigma=err_sigma, d_sigma_scale=scale,
                   err_d_sigma_over_scale=err_sigma / max(scale, 1e-30))
        if (R, K, white, contiguous_rgb, pattern) == (4096, 40, False,
                                                      False, "random"):
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

    reset_counts()
    t1 = time.perf_counter()
    rgb, depth = step(batch, generator=gen)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    launches_first = read_counts()
    check(launches_first == (n_chunks, 0, 6 * n_chunks, 0, 0, 0),
          f"first render launched kernels A, B, C, the DCN backward and the kNN "
          f"{launches_first} times, expected ({n_chunks}, 0, {6 * n_chunks}"
          f", 0, 0, 0)")

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    gen.manual_seed(1)  # path_pairs renders with the same noise
    t2 = time.perf_counter()
    rgb, depth = step(batch, generator=gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t2
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches == (n_chunks, 0, 6 * n_chunks, 0, 0, 0),
          f"warm render launched kernels A, B and C {launches} times, "
          f"expected ({n_chunks}, 0, {6 * n_chunks})")
    check_image(rgb, depth, H, W)
    hit = float((depth > 0).float().mean())
    emit("path", config="DTU eval protocol, bf16, sphere scene 512x640 nv=4",
         chunks=n_chunks, launches=launches[0], launches_bwd=launches[1],
         launches_row_gather=launches[2],
         launches_first_render=launches_first[0],
         launches_row_gather_first_render=launches_first[2],
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
    reset_counts()
    gen.manual_seed(1)
    t2 = time.perf_counter()
    rgb, depth = render(gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t2
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches == (n_chunks, 0, 4 * n_chunks, 0, 0, 0),
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
    reset_counts()
    gen.manual_seed(1)
    t2 = time.perf_counter()
    rgb, depth = step(batch, generator=gen)
    torch.cuda.synchronize()
    t_warm = time.perf_counter() - t2
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(launches == (n_chunks, 0, 7 * n_chunks, 0, 0, 0),
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
    idle share (1 − summed kernel time / wall time of the call); returns
    the port's kernels' device ms and launches by name."""
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
            for name in ("composite_fwd", "composite_bwd", "row_gather",
                         "dcn_sample_bwd", "knn1")}
    emit(phase, wall_ms=wall * 1e3, kernel_ms=busy_ms,
         idle_share=1 - busy_ms / (wall * 1e3),
         device_kernels=sum(e.count for e in kernels), port_kernels=port,
         nccl_kernels={e.key: e.count for e in kernels
                       if "nccl" in e.key.lower()},
         # the process group's calls on the host, by name
         collectives={e.key: e.count for e in events
                      if e.device_type == DeviceType.CPU
                      and e.key.startswith(("nccl:", "c10d::", "gloo:"))},
         top_ops=[{"op": e.key, "device_ms": getattr(e, attr) / 1e3,
                   "calls": e.count} for e in top])
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / f"chip_smoke_{phase}.txt").write_text(
        events.table(sort_by=attr, row_limit=80))
    return port


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

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    times, losses, per_step, nonzero_per_step = [], [], [], []
    for _ in range(5):
        before = read_counts()
        t2 = time.perf_counter()
        metrics = step(b, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t2)
        per_step.append(tuple(a - c for a, c in
                              zip(read_counts(), before)))
        losses.append({k: float(v) for k, v in metrics.items()})
        nonzero_per_step.append(sum(bool((g != 0).any())
                                    for g in grads_of(model).values()))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(c == (1, 1, n_gathers, 0, 0, 0) for c in per_step),
          f"kernel A, B and C launches per step: {per_step}, expected "
          f"(1, 1, {n_gathers}, 0, 0, 0)")
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


PARALLEL_STEPS = 3  # mesh steps held to the plain step
PARALLEL_TIMED = 5  # steps of each kind timed between CUDA events
PARALLEL_DIR = OUT_DIR / "parallel"
# mesh against plain after each Adam step: every parameter within this
# fraction of lr (two first Adam steps on gradients of opposite sign are
# 2 · lr apart), each of Adam's moments within 1e-3 of its norm. Adam's
# first step moves an element by lr · g / (|g| + ε), so where |g| is
# within rounding of 0 its sign decides a move of ±lr: such elements, at
# most PARALLEL_NOISE_MULT times the largest gradient difference of their
# tensor, are counted and left out (where |g| is above that, a gradient
# difference moves an element at most lr / (4 · PARALLEL_NOISE_MULT)
# apart). Each step starts both sides from the plain side's weights, BN
# statistics and Adam state, so no such difference carries into the next
PARALLEL_PARAM_LR_FRAC = 0.1
PARALLEL_NOISE_MULT = 10


def parallel_cli_config():
    """``configs/train_dtu.yaml`` with ``data`` the sphere at 512×640 (one
    scene a step), 2 steps, no validation, one checkpoint at the end: the
    training CLI's ``--mesh`` run → its path."""
    from diner_tpu_torch.train.config import load_train_config
    raw = load_train_config(ROOT / "configs" / "train_dtu.yaml").raw
    raw["data"] = sphere_data(2, 1, 1)
    raw["logger"]["kwargs"]["save_dir"] = str(PARALLEL_DIR / "runs")
    raw["trainer"]["kwargs"].update(max_steps=2, val_check_interval=0,
                                    log_every_n_steps=1)
    raw["checkpointing"]["kwargs"]["every_n_train_steps"] = 0
    PARALLEL_DIR.mkdir(parents=True, exist_ok=True)
    path = PARALLEL_DIR / "train_dtu_sphere_mesh.yaml"
    path.write_text(json.dumps(raw, indent=1))
    return path


def phase_parallel_train(state0, vgg, b):
    """The mesh train step (``parallel/``) on the card as a world of one
    NCCL rank on a local store: ``make_mesh()`` is (1, 1), and the step
    runs every collective of the mesh path there too (the BN statistics'
    autograd all-reduces, the patch's autograd all-gather, the gradient
    and metric all-reduces, each over a group of one), so it must equal
    the plain ``TrainStep``. On ``phase_train_path``'s production weights,
    VGG and batch (4 views at 512×640, 4,096 rays, the 64×64 patch),
    computed in f32 (in bf16 on an H100 the mesh step of one rank, which
    computes what the plain step does, missed 1e-3 of the norm at the
    first BN's bias gradient: the scatter-adds' and cuDNN's atomics sum in
    a changing order, and bf16 rounds the difference up):
    ``PARALLEL_STEPS`` steps from the init weights on three draws, each
    step on the same draws and from the same weights, BN statistics and
    Adam state on both sides (the plain side's, carried from step to step,
    so Adam's moments are not zero from the second step on), hold the
    loss (1e-5 relative),
    every gradient (1e-3 of its norm), Adam's two moments (1e-3 of their
    norms), the parameters (``PARALLEL_PARAM_LR_FRAC`` · lr, but for the
    elements whose gradient is within rounding of 0, counted) and the BN
    statistics (1e-5). The random-init field renders no density after a
    step of this recipe, on both sides (ROADMAP §3), so the later steps'
    gradients are 0 and Adam moves the weights on its moments alone.
    Kernels A, B and C launch on the mesh step as on the plain one. Then,
    at the production recipe (bf16), the seconds per step of each (CUDA
    events) and the launches per step of each (a profile), with the
    collectives and the NCCL kernels by name, and ``python -m
    diner_tpu_torch.train ... --mesh --max-steps 2`` in process on
    ``parallel_cli_config()``."""
    from diner_tpu_torch.parallel import initialize, shutdown
    cfg = dtu_train_config()
    cfg32 = dataclasses.replace(cfg, nerf=dataclasses.replace(
        cfg.nerf, compute_dtype="float32"))
    t0 = time.perf_counter()
    device = initialize()
    try:
        return parallel_steps(cfg, cfg32, state0, vgg, b, device, t0)
    finally:
        shutdown()


def parallel_steps(cfg, cfg32, state0, vgg, b, device, t0):
    """The body of :func:`phase_parallel_train` in its process group."""
    import copy
    import shutil

    import torch.distributed as dist

    from diner_tpu_torch.models.pixelnerf import PixelNeRF
    from diner_tpu_torch.parallel import (make_mesh,
                                          make_parallel_train_step, shutdown)
    from diner_tpu_torch.renderer import draw_noise
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    from diner_tpu_torch.train.__main__ import main as train_main
    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.diner import make_train_step, select_pixels
    mesh = make_mesh()
    backend = dist.get_backend()
    t_init = time.perf_counter() - t0
    check(device == torch.device("cuda", 0) and backend == "nccl"
          and mesh.shape == {"data": 1, "rays": 1},
          f"world of one: {device}, {backend}, mesh {mesh.shape}")

    def model_from(c):
        m = PixelNeRF(c.nerf)
        m.load_state_dict(state0)
        return m.cuda()

    plain_step = make_train_step(model_from(cfg32), cfg32, vgg)
    mesh_step = make_parallel_train_step(model_from(cfg32), cfg32, mesh, vgg)
    g = torch.Generator(device="cuda").manual_seed(7)
    rows, mesh_counts = [], [0] * 6
    for i in range(PARALLEL_STEPS):
        before = {n: p.detach().clone()
                  for n, p in plain_step.model.named_parameters()}
        pix = select_pixels(cfg32, b, g)
        noise = draw_noise(cfg32.renderer, 1, cfg32.rays_per_step,
                           generator=g, device="cuda")
        res = {}
        for name, step in (("plain", plain_step), ("mesh", mesh_step)):
            reset_counts()
            metrics = step(b, noise=noise, pix_idcs=pix)
            torch.cuda.synchronize()
            counts = read_counts()
            res[name] = (float(metrics["total"]), grads_of(step.model),
                         {n: p.detach() for n, p in
                          step.model.named_parameters()},
                         {n: t for n, t in step.model.named_buffers()},
                         counts, {n: (step.optimizer.state[p]["exp_avg"],
                                      step.optimizer.state[p]["exp_avg_sq"])
                                  for n, p in step.model.named_parameters()})
        mesh_counts = [a + c for a, c in zip(mesh_counts, res["mesh"][4])]
        n_zero = {k: sum(not bool((t != 0).any()) for t in r[1].values())
                  for k, r in res.items()}
        for name in res:
            grads = res[name][1]
            check(np.isfinite(res[name][0]) and all(
                bool(torch.isfinite(t).all()) for t in grads.values())
                and (i > 0 or n_zero[name] < len(grads)),
                f"{name} step {i + 1}: loss {res[name][0]}, "
                f"{sum(not bool(torch.isfinite(t).all()) for t in grads.values())}"
                f" non-finite and {n_zero[name]} all-zero gradients of "
                f"{len(grads)}")
        loss_err = abs(res["mesh"][0] - res["plain"][0]) / abs(
            res["plain"][0])
        if n_zero["plain"] == len(before):  # the field renders no density
            worst, name, nonzero = max(
                (float(t.abs().max()), n) for n, t in res["mesh"][1].items()
            ) + (0,)
        else:
            worst, name, nonzero = grad_errs(res["mesh"][1], res["plain"][1])
        in_noise = {}
        for n, g_plain in res["plain"][1].items():
            floor = float((res["mesh"][1][n] - g_plain).abs().max())
            in_noise[n] = ((g_plain.abs() <= PARALLEL_NOISE_MULT * floor)
                           if floor > 0 else torch.zeros_like(
                               g_plain, dtype=torch.bool))
        p_diff = {n: (res["mesh"][2][n] - res["plain"][2][n]).abs()
                  for n in before}
        param_err = max(float(d.masked_fill(in_noise[n], 0).max())
                        for n, d in p_diff.items()) / cfg32.lr
        param_err_all = max(float(d.max()) for d in p_diff.values()) / cfg32.lr
        n_noise = sum(int(m.sum()) for m in in_noise.values())
        moment_err = max(
            float((got - want).abs().max()) / max(float(want.norm()), 1e-30)
            for n in before for got, want in zip(res["mesh"][5][n],
                                                 res["plain"][5][n]))
        moved = sum(not torch.equal(res["plain"][2][n], before[n])
                    for n in before)
        stats_err = max(float((res["mesh"][3][n] - t).abs().max())
                        for n, t in res["plain"][3].items())
        rows.append(dict(step=i + 1, loss_plain=res["plain"][0],
                         loss_mesh=res["mesh"][0], loss_rel_err=loss_err,
                         worst_grad_err_over_norm=worst, worst_param=name,
                         params_grad_nonzero=nonzero,
                         params_grad_all_zero=n_zero,
                         param_err_over_lr=param_err,
                         param_err_over_lr_all=param_err_all,
                         elements_in_noise=n_noise,
                         elements=sum(t.numel() for t in before.values()),
                         adam_moment_err_over_norm=moment_err,
                         params_moved=moved, bn_stats_max_abs_err=stats_err,
                         launches_plain=res["plain"][4],
                         launches_mesh=res["mesh"][4]))
        check(res["mesh"][4] == res["plain"][4] == (1, 1, 6, 0, 0, 0),
              f"step {i + 1}: launches mesh {res['mesh'][4]}, plain "
              f"{res['plain'][4]}, expected (1, 1, 6, 0, 0, 0)")
        check(loss_err <= 1e-5 and worst <= 1e-3 and moment_err <= 1e-3
              and param_err <= PARALLEL_PARAM_LR_FRAC and stats_err <= 1e-5
              and moved > 0,
              f"mesh vs plain step {i + 1}: loss {loss_err}, grad {worst} "
              f"at {name}, Adam's moments {moment_err}, params "
              f"{param_err} · lr ({n_noise} elements in the noise left out; "
              f"all {param_err_all} · lr), stats {stats_err}, {moved} "
              f"parameters moved")
        # the next step from the same state on both sides
        mesh_step.model.load_state_dict(plain_step.model.state_dict())
        mesh_step.optimizer.load_state_dict(
            copy.deepcopy(plain_step.optimizer.state_dict()))

    # the production recipe (bf16) for the times and the launches
    plain_step = make_train_step(model_from(cfg), cfg, vgg)
    mesh_step = make_parallel_train_step(model_from(cfg), cfg, mesh, vgg)
    ms = {"plain": cuda_time_ms(lambda: plain_step(b, generator=g),
                                PARALLEL_TIMED, 1),
          "mesh": cuda_time_ms(lambda: mesh_step(b, generator=g),
                               PARALLEL_TIMED, 1)}
    profiles = {}
    for name, step in (("plain", plain_step), ("mesh", mesh_step)):
        profile_once(f"parallel_train_{name}_profile",
                     lambda: step(b, generator=g))
        profiles[name] = LOG[-1]
    del plain_step, mesh_step
    shutdown()  # the CLI joins and leaves a world of its own
    torch.cuda.empty_cache()

    # the CLI's --mesh in process: it joins a world of one and leaves it
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    cfg_path = parallel_cli_config()
    run_dir = load_train_config(cfg_path).run_dir
    reset_counts()
    t1 = time.perf_counter()
    train_main([str(cfg_path), "DINER", "--mesh", "--max-steps", "2",
                "--num-workers", "0"])
    torch.cuda.synchronize()
    t_cli = time.perf_counter() - t1
    cli_launches = read_counts()
    saved = ckpt_lib.load_state(run_dir / "checkpoints" / "step_00000002")
    check(saved["step"] == 2 and not dist.is_initialized(),
          f"--mesh CLI: checkpoint step {saved['step']}, process group "
          f"left {dist.is_initialized()}")
    # 2 steps of (1, 1, 6) and create_model's init probe (5 C)
    check(cli_launches == (2, 2, 17, 0, 0, 0),
          f"--mesh CLI launches {cli_launches}, expected (2, 2, 17, ...)")
    shutil.rmtree(PARALLEL_DIR, ignore_errors=True)
    emit("parallel_train", config="DTU production train step, bf16, sphere "
         "scene 512x640 nv=4, 64x64 patch, mesh (1, 1) over NCCL",
         mesh=mesh.shape, backend=backend, world_size=mesh.size,
         init_s=t_init, steps=rows, s_per_step_plain=ms["plain"] / 1e3,
         s_per_step_mesh=ms["mesh"] / 1e3,
         device_kernels_per_step_plain=profiles["plain"]["device_kernels"],
         device_kernels_per_step_mesh=profiles["mesh"]["device_kernels"],
         collectives_per_step_mesh=profiles["mesh"]["collectives"],
         collectives_per_step_plain=profiles["plain"]["collectives"],
         nccl_kernels_mesh=profiles["mesh"]["nccl_kernels"],
         nccl_kernels_plain=profiles["plain"]["nccl_kernels"],
         launches_mesh_steps=tuple(mesh_counts),
         cli_s=t_cli, cli_launches=cli_launches, cli_steps=saved["step"],
         compared_in="float32", timed_in=cfg.nerf.compute_dtype,
         tol=dict(loss=1e-5, grad=1e-3, adam_moments=1e-3,
                  params_over_lr=PARALLEL_PARAM_LR_FRAC,
                  noise_mult=PARALLEL_NOISE_MULT, stats=1e-5))
    return tuple(mesh_counts), cli_launches


def phase_train_small_reference(pruned=False):
    """A small production step on the card against the same step on the
    CPU: same weights, VGG, pixels and noise, f32; with the one-stage or
    the pruned sampler (64 candidates: 16 coarse bins of 4, 4 refined)."""
    import copy

    from diner_tpu_torch.data.synthetic import make_sphere_scene
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.models.pixelnerf import PixelNeRFConfig
    from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
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
        reset_counts()
        total, _ = compute_losses(
            m, cfg, batch_to_device(batch, dev),
            copy.deepcopy(cpu_vgg).to(dev), pix_idcs=pix.to(dev),
            noise=tuple(t.to(dev) for t in noise))
        total.backward()
        res[where] = (total.item(), grads_of(m),
                      read_counts())
    expected = (1, 1, 7 if pruned else 6, 0, 0, 0)
    check(res["card"][2] == expected and res["cpu"][2] == (0, 0, 0, 0, 0, 0),
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
TRAIN_LOOP_BATCH = 4  # scenes per step, configs/train_dtu.yaml's own
# validation's camera sweep, cut from the default 30 frames of 4 sweeps
# (120 f32 renders) to one sweep of 2 frames
TRAIN_LOOP_SWEEP = {"nframes": 2, "n_cam_sweeps": 1}
# validation images scored at step 6 (2 until PR 16)
TRAIN_LOOP_EVAL_N = 1
# the train loop's peak allocation, in the CLI and in the resumed fit, may
# take this share of the card's memory: the rest is the CUDA context's and
# the caching allocator's headroom
MEMORY_SHARE_LIMIT = 0.95
CLI_PEAK_TAG = "cli_peak_mem_bytes="
# ``python -m diner_tpu_torch.train ARGS`` that prints the process's peak
# allocation after the run
TRAIN_CLI_WITH_PEAK = (
    "import sys, torch\n"
    "from diner_tpu_torch.train.__main__ import main\n"
    "main(sys.argv[1:])\n"
    f"print('{CLI_PEAK_TAG}' + str(torch.cuda.max_memory_allocated()))\n")


def train_loop_config():
    """``configs/train_dtu.yaml`` read by the port's ``load_train_config``
    with only ``data`` replaced (the analytic sphere at the DTU image size:
    512×640, 4 source views; 8 train and 2 val scenes, the config's batch
    of 4 scenes) and the trainer settings of this phase: 6 steps, a
    checkpoint every 3, one validation at step 6 over
    ``TRAIN_LOOP_EVAL_N`` images with a camera sweep of
    ``TRAIN_LOOP_SWEEP``, a log row every step. Written as
    JSON (valid YAML) → its path."""
    from diner_tpu_torch.train.config import load_train_config
    raw = load_train_config(ROOT / "configs" / "train_dtu.yaml").raw
    raw["data"] = sphere_data(8, 2, TRAIN_LOOP_BATCH)
    raw["logger"]["kwargs"]["save_dir"] = str(TRAIN_LOOP_DIR / "runs")
    raw["trainer"]["kwargs"].update(max_steps=6, val_check_interval=6,
                                    log_every_n_steps=1)
    raw["checkpointing"]["kwargs"]["every_n_train_steps"] = 3
    raw["optimizer"]["kwargs"]["n_samples_score_eval"] = TRAIN_LOOP_EVAL_N
    raw["optimizer"]["kwargs"]["cam_sweep_settings"] = TRAIN_LOOP_SWEEP
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
    samples from 1000 candidates, MSE + 0.1·VGG + 1.0·antibias, f32, 4
    scenes a step) with checkpoints at 3 and 4; then
    ``Trainer.fit(max_steps=6)`` in this process resumes from step 4,
    checkpoints and validates at step 6 (a prediction folder of
    ``TRAIN_LOOP_EVAL_N`` image, scored, and one camera sweep of 2 frames:
    cut from 4 sweeps of 30, see ``TRAIN_LOOP_SWEEP``); the profiler
    watches the fit's two train steps. Checks: the step counts; the checkpoints (6 is
    the fit's final state bit for bit; a fresh TrainStep restored from the
    CLI's 4 holds it bit for bit, and its step 5 on the fit's batch and
    generator state gives the fit's step-5 losses and update); finite
    logged rows; the scored folder; the sweep's animation (2·3 − 1 frames
    of 200 ms) and source views; kernel launches per train step (A 1, B 1,
    C 6) and per validation or sweep image (A 80, C 480); the peak
    allocation of the CLI and of the resumed fit each within
    ``MEMORY_SHARE_LIMIT`` of the card's memory."""
    import shutil
    import sys

    from diner_tpu_torch.losses import init_vgg19
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

    import gc
    gc.collect()
    torch.cuda.empty_cache()  # the CLI needs all but the context's memory
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-c", TRAIN_CLI_WITH_PEAK, str(cfg_path), "DINER",
         "--max-steps", "4", "--device", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    (TRAIN_LOOP_DIR / "cli.log").write_text(cli.stdout + cli.stderr)
    check(cli.returncode == 0, f"train CLI exited {cli.returncode}: "
          f"{cli.stderr[-2000:]}")
    cli_peak = int(cli.stdout.split(CLI_PEAK_TAG)[-1].split()[0])
    check(ckpt_lib.latest_checkpoint(ckpt_dir) == str(ckpt_dir /
                                                      "step_00000004"),
          f"CLI checkpoints {sorted(p.name for p in ckpt_dir.iterdir())}")

    # per call of the train step and of the eval step: (steps taken
    # before, launches of A, B and C, seconds to the end of its kernels)
    calls = {"train": [], "eval": []}

    def record(kind, taken, fn, *args, **kwargs):
        before, t = read_counts(), time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        calls[kind].append((taken, tuple(x - y for x, y in
                                         zip(read_counts(), before)),
                            time.perf_counter() - t))
        return out

    train_call, make_eval = TrainStep.__call__, loop.make_eval_step
    # the resumed fit's first step (4 -> 5): its batch, its generator's
    # state, its losses and the parameters after it
    step5 = {}

    def params_of(train_step):
        return torch.cat([p.detach().flatten()
                          for p in train_step.model.parameters()])

    # the profiler watches the resumed steps 5 and 6 and the loop between
    # them, not the validation renders (under it they took ≈ 60 s more)
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof_wall = {}

    def spied_train_call(self, batch, generator=None, **kwargs):
        first = self.step == 4 and not step5
        if first:
            step5.update(batch=batch, gen_state=generator.get_state())
            torch.cuda.synchronize()
            prof.start()
            prof_wall["start"] = time.perf_counter()
        out = record("train", self.step, train_call, self, batch,
                     generator=generator, **kwargs)
        if first:
            step5.update(losses={k: float(v) for k, v in out.items()},
                         params=params_of(self))
        if self.step == 6 and "end" not in prof_wall:
            prof.stop()
            prof_wall["end"] = time.perf_counter()
        return out

    def spied_make_eval(*args, **kwargs):
        step = make_eval(*args, **kwargs)
        return lambda *a, **k: record("eval", None, step, *a, **k)

    TrainStep.__call__ = spied_train_call
    loop.make_eval_step = spied_make_eval
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        trainer = loop.Trainer(run_cfg, device="cuda")
        t1 = time.perf_counter()
        ts = trainer.fit(max_steps=6)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t1
    finally:
        TrainStep.__call__, loop.make_eval_step = train_call, make_eval
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    total_mem = torch.cuda.get_device_properties(0).total_memory
    mem_limit = int(MEMORY_SHARE_LIMIT * total_mem)

    check(ts.step == 6, f"resumed fit ended at step {ts.step}, expected 6")
    check([c[0] for c in calls["train"]] == [4, 5],
          f"resumed train steps began at {[c[0] for c in calls['train']]}")
    check(all(c[1] == (1, 1, 6, 0, 0, 0) for c in calls["train"]),
          f"kernel A, B, C, DCN backward and kNN launches per train step "
          f"{[c[1] for c in calls['train']]}, expected (1, 1, 6, 0, 0, 0)")
    n_sweep = TRAIN_LOOP_SWEEP["nframes"] * TRAIN_LOOP_SWEEP["n_cam_sweeps"]
    check(len(calls["eval"]) == TRAIN_LOOP_EVAL_N + n_sweep and all(
        c[1] == (n_chunks, 0, 6 * n_chunks, 0, 0, 0) for c in calls["eval"]),
        f"launches per validation and sweep image "
        f"{[c[1] for c in calls['eval']]}, expected {TRAIN_LOOP_EVAL_N} + "
        f"{n_sweep} times ({n_chunks}, 0, {6 * n_chunks}, 0, 0, 0)")

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
    check(len(preds) == TRAIN_LOOP_EVAL_N,
          f"prediction folder holds {len(preds)} images")
    scores = json.loads((eval_dir / "average_scores.json").read_text())
    keys = ("psnr", "ssim", "l1", "l2", "lpips_proxy")
    check(all(np.isfinite(scores.get(k, float("nan"))) for k in keys),
          f"validation scores {scores}")
    sweep = sweep_files(eval_dir / "cam_sweeps")
    check(sweep["names"] == ["sphere-val-0000-ref_imgs.jpg",
                             "sphere-val-0000.gif"]
          and sweep["duration_ms"] == (2 * TRAIN_LOOP_SWEEP["nframes"] - 1)
          * 200, f"camera sweep files {sweep}")

    events = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(events[0], "self_device_time_total")
            else "self_cuda_time_total")
    from torch.autograd import DeviceType
    busy_ms = sum(getattr(e, attr) for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    t_prof = prof_wall["end"] - prof_wall["start"]
    (OUT_DIR / "chip_smoke_train_loop_profile.txt").write_text(
        events.table(sort_by=attr, row_limit=60))
    cli_steps = [1 / r["steps_per_sec"] for r in train_rows[:4]]
    emit("train_loop",
         config=f"configs/train_dtu.yaml, data: synthetic_sphere {H}x{W} "
         f"nv=4, batch {TRAIN_LOOP_BATCH}, f32; 6 steps, checkpoints every "
         f"3, validation at 6 over {TRAIN_LOOP_EVAL_N} image, camera sweep "
         f"{TRAIN_LOOP_SWEEP}",
         rays_per_step=run_cfg.diner.rays_per_step * TRAIN_LOOP_BATCH,
         cli_s=t_cli, cli_first_step_s=cli_steps[0],
         s_per_step=statistics.median(cli_steps[1:]),
         s_per_step_all=[1 / r["steps_per_sec"] for r in train_rows],
         step_alone_s=[c[2] for c in calls["train"]],
         validation_image_s=[c[2] for c in calls["eval"]
                             [:TRAIN_LOOP_EVAL_N]],
         fit_resume_s=t_fit, peak_mem_bytes=peak,
         cli_peak_mem_bytes=cli_peak, profiled_steps_s=t_prof,
         idle_share_steps=1 - busy_ms / (t_prof * 1e3),
         kernel_ms_steps=busy_ms,
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
         val_scores={k: scores[k] for k in keys},
         sweep_image_s=[c[2] for c in calls["eval"][TRAIN_LOOP_EVAL_N:]],
         cam_sweep=sweep,
         card_memory_bytes=total_mem, memory_limit_bytes=mem_limit,
         peak_over_40gb_target=max(peak, cli_peak) > 40e9)
    check(max(peak, cli_peak) <= mem_limit,
          f"train loop peak memory: CLI {cli_peak} B, resumed fit {peak} B, "
          f"limit {mem_limit} B ({MEMORY_SHARE_LIMIT} of the card's "
          f"{total_mem} B)")
    return launches


def sweep_files(sweep_dir):
    """The files of a camera-sweep directory and its first GIF's frames
    and summed duration (PIL folds a frame equal to the one before into
    its duration, so the duration counts the frames written)."""
    from PIL import Image
    names = sorted(p.name for p in sweep_dir.iterdir())
    gifs = sorted(sweep_dir.glob("*.gif"))
    if not gifs:
        return dict(names=names, gif_frames=0, duration_ms=0)
    durations = []
    with Image.open(gifs[0]) as im:
        for f in range(im.n_frames):
            im.seek(f)
            durations.append(im.info["duration"])
        size = im.size
    return dict(names=names, gif_frames=len(durations),
                duration_ms=sum(durations), gif_size=size)


PREDICT_DIR = OUT_DIR / "predict"
PREDICT_N = 2  # validation images per prediction folder: 1 warm one


def sphere_data(n_train, n_val, batch_size):
    """The ``data`` block of a config on the analytic sphere at the DTU
    image size (``TRAIN_LOOP_HW``, 4 source views)."""
    def split(n, shuffle):
        return {"dataset": {"module": "synthetic_sphere",
                            "kwargs": {"n": n, "H": TRAIN_LOOP_HW[0],
                                       "W": TRAIN_LOOP_HW[1], "nv": 4}},
                "dataloader": {"kwargs": {"shuffle": shuffle,
                                          "batch_size": batch_size}}}
    return {"train": split(n_train, True), "val": split(n_val, False)}


def predict_config():
    """``configs/evaluate_diner_on_dtu.yaml`` with ``data`` swapped for the
    sphere (its full width: ResNet34, ResnetFC 5×512, 64 samples from 1000
    candidates, 24 Gaussians, f32 as the config sets no dtype), written as
    JSON → its path."""
    from diner_tpu_torch.train.config import load_train_config
    raw = load_train_config(ROOT / "configs" /
                            "evaluate_diner_on_dtu.yaml").raw
    raw["data"] = sphere_data(1, PREDICT_N + 1, 1)
    raw["logger"]["kwargs"]["save_dir"] = str(PREDICT_DIR / "runs")
    path = PREDICT_DIR / "evaluate_diner_sphere.yaml"
    path.write_text(json.dumps(raw, indent=1))
    return path


def reference_key(key):
    """The reference Lightning DINER's key of a port ``PixelNeRF`` key
    (``nerf.encoder.model.*`` torchvision names, ``nerf.mlp_fine.*``)."""
    import re
    if key.startswith("encoder.resnet."):
        k = key[len("encoder.resnet."):]
        k = re.sub(r"^(layer\d)_(\d+)\.downsample_conv\.",
                   r"\1.\2.downsample.0.", k)
        k = re.sub(r"^(layer\d)_(\d+)\.downsample_bn\.",
                   r"\1.\2.downsample.1.", k)
        return "nerf.encoder.model." + re.sub(r"^(layer\d)_(\d+)\.",
                                              r"\1.\2.", k)
    k = re.sub(r"^lin_z_(\d+)\.", r"lin_z.\1.", key[len("mlp."):])
    return "nerf.mlp_fine." + re.sub(r"^block_(\d+)\.", r"blocks.\1.", k)


def lightning_checkpoint(cfg, batch, path):
    """A reference-schema Lightning ``.ckpt`` of a seeded full-width model
    (seed 1, BN statistics and the zero-initialized ``fc_1`` drawn too),
    with the entries the bridge drops (``num_batches_tracked``,
    torchvision's ``fc`` head, the positional encodings' buffers) →
    {reference key: tensor} of its weights."""
    from diner_tpu_torch.train.diner import create_model
    model = create_model(cfg, batch, seed=1, device="cuda")
    g = torch.Generator().manual_seed(11)
    sd = {}
    for k, v in model.state_dict().items():
        v = v.cpu()
        if k.endswith("running_mean") or k.endswith("fc_1.weight"):
            v = 0.05 * torch.randn(v.shape, generator=g)
        elif k.endswith("running_var"):
            v = 0.5 + torch.rand(v.shape, generator=g)
        sd[reference_key(k)] = v.clone()
    weights = dict(sd)
    sd["nerf.encoder.model.bn1.num_batches_tracked"] = torch.tensor(1000)
    sd["nerf.encoder.model.fc.weight"] = torch.zeros(1000, 512)
    sd["nerf.code._freqs"] = torch.ones(1, 12, 1)
    torch.save({"state_dict": sd, "epoch": 10, "global_step": 30000}, path)
    return weights


def folder_files(folder):
    """{sample stem: sorted suffixes} of a prediction folder's images."""
    from diner_tpu_torch.evaluation import suite
    suffixes = (suite.PRED_SUFFIX, suite.GT_SUFFIX, suite.REF_SUFFIX,
                suite.DEPTH_SUFFIX)
    stems = {}
    for p in folder.iterdir():
        for x in suffixes:
            if p.name.endswith(x):
                stems.setdefault(p.name[:-len(x)], []).append(x)
    return {k: sorted(v) for k, v in stems.items()}, sorted(suffixes)


def phase_predict(smi, build_s):
    """The inference entry points on the card: ``python -m
    diner_tpu_torch.predict`` (``main(argv)`` in this process, so the
    launch counts and the loaded model can be read) renders and scores
    ``PREDICT_N`` validation images of ``predict_config()`` from a
    reference Lightning ``.ckpt``, at 64 samples and again with
    ``--nsamples 32`` (12 Gaussians); ``python -m diner_tpu_torch.evaluate``
    re-scores the first folder; ``compare_evaluations`` compares the two.
    Checks: the loaded weights are the checkpoint's bit for bit; 4 files
    per sample under the suite's suffixes; finite scores, the evaluate
    CLI's equal to predict's; ``comparison.json`` names both models;
    kernels A 80 and C 480 times per image (B never). Returns the
    launches of each run and the first folder."""
    import shutil

    from diner_tpu_torch import evaluate, predict
    from diner_tpu_torch.evaluation.suite import compare_evaluations
    from diner_tpu_torch.train import diner
    from diner_tpu_torch.train.config import load_train_config

    shutil.rmtree(PREDICT_DIR, ignore_errors=True)
    PREDICT_DIR.mkdir(parents=True)
    cfg_path = predict_config()
    dcfg = load_train_config(cfg_path).diner
    from diner_tpu_torch.data.synthetic_dataset import SphereDataset
    H, W = TRAIN_LOOP_HW
    sample = SphereDataset("val", n=1, H=H, W=W, nv=4)[0]
    batch = {k: v[None] for k, v in sample.items()
             if isinstance(v, np.ndarray)}
    ckpt = PREDICT_DIR / "DINER.ckpt"
    weights = lightning_checkpoint(dcfg, batch, ckpt)
    n_chunks = -(-H * W // dcfg.renderer.ray_chunk)

    make_eval = diner.make_eval_step
    results = {}
    for name, extra in (("nsamples64", []), ("nsamples32",
                                             ["--nsamples", "32"])):
        calls, models = [], []

        def spied_make_eval(model, cfg, *args, **kwargs):
            models.append((model, cfg))
            step = make_eval(model, cfg, *args, **kwargs)

            def timed(*a, **k):
                before = read_counts()
                out = step(*a, **k)
                torch.cuda.synchronize()
                calls.append((tuple(x - y for x, y in
                                    zip(read_counts(), before)),
                              time.perf_counter()))
                return out
            return timed

        out = PREDICT_DIR / name
        diner.make_eval_step = spied_make_eval
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            t0 = time.perf_counter()
            scores = predict.main(["--config", str(cfg_path), "--ckpt",
                                   str(ckpt), "--out", str(out), "--n",
                                   str(PREDICT_N), "--device", "cuda",
                                   *extra])
            t_cli = time.perf_counter() - t0
        finally:
            diner.make_eval_step = make_eval
        launches = read_counts()
        peak = torch.cuda.max_memory_allocated()
        model, cfg = models[0]
        loaded = model.state_dict()
        same = all(torch.equal(loaded[k].cpu(), weights[reference_key(k)])
                   for k in loaded)
        check(same and sorted(map(reference_key, loaded)) == sorted(weights),
              f"{name}: the loaded weights are not the checkpoint's")
        files, suffixes = folder_files(out)
        check(len(files) == PREDICT_N and all(v == suffixes
                                              for v in files.values()),
              f"{name}: prediction folder {files}")
        check(all(np.isfinite(v) for v in scores.values())
              and "lpips_proxy" in scores, f"{name}: scores {scores}")
        check(len(calls) == PREDICT_N and all(
            c[0] == (n_chunks, 0, 6 * n_chunks, 0, 0, 0) for c in calls),
            f"{name}: launches per image {[c[0] for c in calls]}, expected "
            f"({n_chunks}, 0, {6 * n_chunks}, 0, 0, 0)")
        ends = [t0] + [c[1] for c in calls]
        warm = [b - a for a, b in zip(ends[1:], ends[2:])]
        results[name] = dict(
            n_samples=cfg.renderer.n_samples,
            n_gaussian=cfg.renderer.n_gaussian,
            compute_dtype=cfg.nerf.compute_dtype, images=len(calls),
            time_to_first_image_s=ends[1] - t0,
            s_per_image_warm=statistics.median(warm),
            s_per_image_warm_all=warm,
            s_per_image_warm_spread=max(warm) - min(warm), cli_s=t_cli,
            peak_mem_bytes=peak, launches=launches,
            launches_per_image=[c[0] for c in calls],
            loaded_bit_for_bit=same, scores=scores, folder=str(out))
    check(results["nsamples32"]["n_gaussian"] == 12,
          f"--nsamples 32 gave {results['nsamples32']['n_gaussian']} "
          "Gaussians, expected int(24 * 32 / 64) = 12")

    folders = {name: Path(r["folder"]) for name, r in results.items()}
    rescored = evaluate.main([str(folders["nsamples64"]),
                              str(PREDICT_DIR / "rescored"), "--device",
                              "cuda"])
    check(rescored == results["nsamples64"]["scores"],
          f"evaluate CLI {rescored} vs predict "
          f"{results['nsamples64']['scores']}")
    comparison = compare_evaluations(list(folders.items()),
                                     PREDICT_DIR / "comparison")
    written = json.loads((PREDICT_DIR / "comparison" /
                          "comparison.json").read_text())
    check(sorted(written["models"]) == sorted(folders)
          and written == comparison, f"comparison.json {written}")
    emit("predict", config="configs/evaluate_diner_on_dtu.yaml, data: "
         "synthetic_sphere 512x640 nv=4, f32, reference Lightning .ckpt",
         nvidia_smi=smi, kernels_built_s=build_s,
         kernels_prebuilt="built by the build phase of this run; "
         "time_to_first_image_s counts the CLI's start, the model init, "
         "the checkpoint load and the first render",
         runs=results, evaluate_cli_scores=rescored,
         comparison_best=written["best"],
         comparison_files=sorted(p.name for p in
                                 (PREDICT_DIR / "comparison").iterdir()))
    return ({name: r["launches"] for name, r in results.items()},
            folders["nsamples64"])


def torchvision_state_dicts(seed=0):
    """Seeded state dicts in the release files' schemas: torchvision
    ResNet34 (with the ``fc`` head and ``layer4``), VGG19 and VGG16
    ``features`` (with a ``classifier`` entry, as the full models carry),
    and the lpips package's linear calibration."""
    g = torch.Generator().manual_seed(seed)

    def rand(*shape, scale=0.05):
        return scale * torch.randn(shape, generator=g)

    def bn(prefix, c, sd):
        sd[prefix + ".weight"] = 1 + rand(c)
        sd[prefix + ".bias"] = rand(c)
        sd[prefix + ".running_mean"] = rand(c)
        sd[prefix + ".running_var"] = 0.5 + torch.rand(c, generator=g)
        sd[prefix + ".num_batches_tracked"] = torch.tensor(0)

    resnet = {"conv1.weight": rand(64, 3, 7, 7)}
    bn("bn1", 64, resnet)
    cin = 64
    for s, (n, w) in enumerate(zip((3, 4, 6, 3), (64, 128, 256, 512))):
        for b in range(n):
            p = f"layer{s + 1}.{b}"
            resnet[p + ".conv1.weight"] = rand(w, cin, 3, 3)
            bn(p + ".bn1", w, resnet)
            resnet[p + ".conv2.weight"] = rand(w, w, 3, 3)
            bn(p + ".bn2", w, resnet)
            if b == 0 and s > 0:
                resnet[p + ".downsample.0.weight"] = rand(w, cin, 1, 1)
                bn(p + ".downsample.1", w, resnet)
            cin = w
    resnet["fc.weight"], resnet["fc.bias"] = rand(1000, 512), rand(1000)

    def vgg(convs):
        sd, cin = {}, 3
        for idx, ch in convs:
            sd[f"features.{idx}.weight"] = rand(ch, cin, 3, 3)
            sd[f"features.{idx}.bias"] = rand(ch, scale=0.01)
            cin = ch
        sd["classifier.6.bias"] = rand(1000)
        return sd

    from diner_tpu_torch.evaluation.metrics import (LPIPS_CHANNELS,
                                                    VGG16_CONVS)
    vgg19 = vgg(((0, 64), (2, 64), (5, 128), (7, 128), (10, 256),
                 (12, 256), (14, 256), (16, 256), (19, 512), (21, 512),
                 (23, 512), (25, 512), (28, 512), (30, 512), (32, 512),
                 (34, 512)))
    lins = {f"lins.{i}.model.1.weight": rand(1, c, 1, 1).abs()
            for i, c in enumerate(LPIPS_CHANNELS)}
    return {"resnet34-b627a593.pth": resnet, "vgg19-dcbb9e9d.pth": vgg19,
            "vgg16-397923af.pth": vgg(VGG16_CONVS),
            "lpips_vgg_v0.1.pth": lins}


def phase_pretrained(folder):
    """The pretrained-weights path on the card: seeded ``.pth`` files in
    the torchvision / lpips schemas are converted by ``python -m
    diner_tpu_torch.import_pretrained`` (a subprocess), and with
    ``DINER_TPU_PRETRAINED`` pointing at them (in this phase only; restored
    after it) ``create_model`` at ``configs/evaluate_diner_on_dtu.yaml``'s
    width grafts the ImageNet ResNet34, the VGG19 loss net loads, and
    ``evaluate_folder`` scores real LPIPS on the predict phase's
    ``PREDICT_N`` rendered images. Checks: conv1's RGB slice is the file's and its PE
    channels the seeded draw's; every other model weight outside the ResNet
    the seeded draw's; VGG19's convolutions the file's; the scores report
    ``lpips``, not ``lpips_proxy``, and keep the other metrics."""
    import os
    import shutil
    import sys

    from diner_tpu_torch.evaluation.suite import evaluate_folder
    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.diner import create_model
    from diner_tpu_torch.utils.pretrained import load_vgg19

    wdir = OUT_DIR / "pretrained"
    shutil.rmtree(wdir, ignore_errors=True)
    wdir.mkdir(parents=True)
    files = torchvision_state_dicts()
    for name, sd in files.items():
        torch.save(sd, wdir / name)
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-m", "diner_tpu_torch.import_pretrained",
         "--weights-dir", str(wdir)], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    t_import = time.perf_counter() - t0
    check(cli.returncode == 0, f"import_pretrained exited "
          f"{cli.returncode}: {cli.stderr[-2000:]}")
    npz = sorted(p.name for p in wdir.glob("*.npz"))
    check(npz == ["lpips_vgg.npz", "resnet34_imagenet.npz",
                  "vgg19_imagenet.npz"], f"converted {npz}: {cli.stdout}")

    dcfg = load_train_config(ROOT / "configs" /
                             "evaluate_diner_on_dtu.yaml").diner
    from diner_tpu_torch.data.synthetic import make_sphere_scene
    batch = make_sphere_scene(H=TRAIN_LOOP_HW[0], W=TRAIN_LOOP_HW[1], nv=4)
    saved = os.environ.get("DINER_TPU_PRETRAINED")
    os.environ["DINER_TPU_PRETRAINED"] = str(wdir)
    try:
        t1 = time.perf_counter()
        grafted = create_model(dcfg, batch, seed=0).state_dict()
        torch.cuda.synchronize()
        t_model = time.perf_counter() - t1
        vgg = load_vgg19()
        scores = evaluate_folder(folder, wdir / "scores")
    finally:
        if saved is None:
            os.environ.pop("DINER_TPU_PRETRAINED")
        else:
            os.environ["DINER_TPU_PRETRAINED"] = saved
    fresh = create_model(dcfg, batch, seed=0).state_dict()

    conv1 = grafted["encoder.resnet.conv1.weight"].cpu()
    rgb_is_file = torch.equal(conv1[:, :3],
                              files["resnet34-b627a593.pth"]["conv1.weight"])
    pe_is_draw = torch.equal(conv1[:, 3:],
                             fresh["encoder.resnet.conv1.weight"][:, 3:].cpu())
    rest_is_draw = all(torch.equal(v, fresh[k]) for k, v in grafted.items()
                       if not k.startswith("encoder.resnet."))
    stats_from_file = torch.equal(
        grafted["encoder.resnet.layer3_5.bn2.running_var"].cpu(),
        files["resnet34-b627a593.pth"]["layer3.5.bn2.running_var"])
    vgg_is_file = vgg is not None and all(
        torch.equal(getattr(vgg, f"conv_{i}").weight.cpu(),
                    files["vgg19-dcbb9e9d.pth"][f"features.{i}.weight"])
        for i in (0, 19))
    emit("pretrained", converted=npz, import_cli_s=t_import,
         conv1_shape=list(conv1.shape), conv1_rgb_is_file=rgb_is_file,
         conv1_pe_channels_are_the_draw=pe_is_draw,
         other_weights_are_the_draw=rest_is_draw,
         bn_stats_from_file=stats_from_file, vgg19_loaded=vgg_is_file,
         model_init_s=t_model, scores=scores,
         env_restored=os.environ.get("DINER_TPU_PRETRAINED") == saved)
    check(conv1.shape[1] > 3 and rgb_is_file and pe_is_draw
          and rest_is_draw and stats_from_file,
          "ResNet34 graft: RGB slice, PE channels, other weights or BN "
          "statistics wrong")
    check(vgg_is_file, "VGG19 loss net not loaded from the converted file")
    check("lpips" in scores and "lpips_proxy" not in scores
          and all(np.isfinite(v) for v in scores.values()),
          f"scores with the converted LPIPS: {scores}")
    del grafted, fresh, vgg
    torch.cuda.empty_cache()


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
# KeypointNeRF's fine pass at configs/train_keypointnerf_facescape.yaml's
# width: 4,096 rays × 128 samples in 2 views per corner gather, from the
# source masks and images (256×256), the geometry encoder's full-resolution
# (128×128, 8 ch) and coarse (32×32, 64 ch) levels and the texture features
# (64×64, 8 ch), all f32
KPN_FINE_P = 2 * 4096 * 128
KPN_GATHER_CASES = (
    ("kpn_fine_mask_c1_f32", 2 * 256 * 256, 1, torch.float32, KPN_FINE_P),
    ("kpn_fine_rgb_c3_f32", 2 * 256 * 256, 3, torch.float32, KPN_FINE_P),
    ("kpn_fine_geo_hd_c8_f32", 2 * 128 * 128, 8, torch.float32, KPN_FINE_P),
    ("kpn_fine_tex_c8_f32", 2 * 64 * 64, 8, torch.float32, KPN_FINE_P),
    ("kpn_fine_geo_c64_f32", 2 * 32 * 32, 64, torch.float32, KPN_FINE_P),
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
    as the port builds them; the lab proxy int32 as gather_lab.py), with
    the regime and unit ``gather_cuda.plan`` picks for each, then edge
    cases at every row width, aligned, unaligned and strided, with int32
    and int64 indices: P = 50,001 (no multiple of the rows a thread or
    warp takes), P = 1, R = 1, and out-of-range indices (clamped). Every
    case must be exact."""
    from diner_tpu_torch.ops import gather_cuda
    g = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    for name, n_rows, C, dtype, P in GATHER_CASES + KPN_GATHER_CASES:
        table = torch.randn((n_rows, C), generator=g, device="cuda").to(dtype)
        idx = torch.randint(0, n_rows, (P,), generator=g, device="cuda",
                            dtype=torch.int32 if C == 128 else torch.int64)
        row_bytes = C * table.element_size()
        regime, unit = gather_cuda.plan(row_bytes, row_bytes,
                                        table.data_ptr(), 0)
        row = dict(case=name, regime=regime, unit_bytes=unit,
                   **gather_row(table, idx))
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


# the DCN sampler backward's tolerance against its plain version, relative
# to each output's largest magnitude, in either image dtype: d_img is
# compared as the f32 canvas before its cast (``f32_d_img``), which f32
# atomics sum in another order (a few f32 roundings); leaving a bf16
# image's weights unrounded would move it by ~2^-9; d_x, d_y and d_scale
# are f32 sums
DCN_BWD_RTOL = 1e-5
# the taps of the 512×640 training step: 4 views, FeatureNet's DCN inputs
# are 4 × base_channels = 32 wide at every stage (mvs/model.py:_dcn_head)
DCN_TAP = dict(N=4, H=512, W=640, C=32)
DCN_TAPS = {"tap_stage3": (512, 640), "tap_stage2": (256, 320),
            "tap_stage1": (128, 160)}
# DCN layers of TransMVSNet's FeatureNet (3 heads of 3) × taps of a 3×3,
# each a call of the tap design: its tile and spill kernels
DCN_BWD_CALLS_PER_STEP = 3 * 3 * 9
DCN_BWD_LAUNCHES_PER_CALL = 2
DCN_BWD_PER_STEP = DCN_BWD_CALLS_PER_STEP * DCN_BWD_LAUNCHES_PER_CALL


def dcn_case(N, H, W, C, P, dtype, with_scale, seed, edges):
    """(img, x, y, scale, g) on the card. ``edges``: positions uniform in
    [-2, W + 1] × [-2, H + 1] (outside, on the borders) with exact integers
    at every 7th point, as ``tests/test_mvs.py``'s custom-VJP test; else a
    DCN tap's: the pixel grid plus N(0, 1.5) offsets, the mask a sigmoid."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    img = rnd(N, H, W, C).to(dtype)
    if edges:
        x = torch.rand((N, P), generator=g, device="cuda") * (W + 3) - 2
        y = torch.rand((N, P), generator=g, device="cuda") * (H + 3) - 2
        x[:, ::7] = torch.floor(x[:, ::7])
        y[:, ::7] = torch.floor(y[:, ::7])
    else:
        gy, gx = torch.meshgrid(torch.arange(H, device="cuda"),
                                torch.arange(W, device="cuda"), indexing="ij")
        x = (gx.reshape(1, -1) + 1.5 * rnd(N, P)).contiguous()
        y = (gy.reshape(1, -1) + 1.5 * rnd(N, P)).contiguous()
    scale = torch.sigmoid(rnd(N, P)) if with_scale else None
    return img, x, y, scale, rnd(N, P, C).to(dtype)


def dcn_bwd_errors(got, ref):
    """Each output's max |got − ref| over its max |ref| (the checked
    errors; ``max_abs_err`` is the largest |got − ref| of any output)."""
    return [float((a.float() - b.float()).abs().max()
                  / b.float().abs().max().clamp_min(1e-30))
            for a, b in zip(got, ref) if b is not None]


def dcn_bwd_bytes(img, x, y, scale, g):
    """The backward's bytes: g, each distinct image row a valid corner
    touches and x, y (and scale) read once; d_img and d_x, d_y (and
    d_scale) written once."""
    from diner_tpu_torch.ops.dcn_cuda import corner_meta
    N, H, W, C = img.shape
    es = img.element_size()
    corners, _ = corner_meta(img.shape, x, y, scale)
    rows = torch.unique(torch.cat([c[0][c[2]] for c in corners]))
    vectors = (3 if scale is not None else 2) * 2 * x.numel() * 4
    return (g.numel() * es + rows.numel() * C * es + img.numel() * es
            + vectors), int(rows.numel())


def dcn_autograd_times(img, x, y, scale, g):
    """The sampler's forward, and its forward and backward through the
    Function (``DCN_CUSTOM_VJP = True``) and through autograd of the corner
    gathers (``False``), device ms."""
    from diner_tpu_torch.mvs import dcn
    ins = [t.detach().requires_grad_() for t in (img, x, y, scale)]

    def fwd_bwd(flag):
        def run():
            dcn.DCN_CUSTOM_VJP = flag
            out = dcn.bilinear_sample_pix(*ins)
            return torch.autograd.grad(out, ins, g)
        return run

    def fwd():
        with torch.no_grad():
            return dcn.bilinear_sample_pix(img, x, y, scale)
    try:
        t = dict(forward_ms=device_time_ms(fwd),
                 function_fwd_bwd_ms=device_time_ms(fwd_bwd(True)),
                 autograd_fwd_bwd_ms=device_time_ms(fwd_bwd(False)))
    finally:
        dcn.DCN_CUSTOM_VJP = True
    t["autograd_bwd_ms"] = t["autograd_fwd_bwd_ms"] - t["forward_ms"]
    return t


def phase_kernel_dcn_bwd():
    """The DCN sampler's backward kernel against its plain version on the
    card, all four outputs: edge positions (outside, on the borders, exact
    integers) at odd and even W and C = 5 and 32, with and without scale,
    f32 and bf16 (P = 1001: the point design); then the three training
    taps (``DCN_TAPS``, the tap design) in f32 and bf16, timed beside the
    plain version, with the bytes bound and the share of corners that
    spill; the stage-3 tap also beside autograd of the corner gathers
    (``dcn_autograd_times``)."""
    from diner_tpu_torch.ops import dcn_cuda
    rows = []
    cases = [dict(N=2, H=7, W=W, C=C, P=1001, dtype=dt, with_scale=ws,
                  edges=True)
             for W in (8, 9) for C in (5, 32)
             for dt in (torch.float32, torch.bfloat16) for ws in (True, False)]
    cases += [dict(N=DCN_TAP["N"], H=H, W=W, C=DCN_TAP["C"], P=H * W,
                   dtype=dt, with_scale=True, edges=False, tap=tap)
              for tap, (H, W) in DCN_TAPS.items()
              for dt in (torch.float32, torch.bfloat16)]
    for i, case in enumerate(cases):
        img, x, y, scale, g = dcn_case(seed=20 + i, **{
            k: case[k] for k in ("N", "H", "W", "C", "P", "dtype",
                                 "with_scale", "edges")})
        got = dcn_cuda.bilinear_sample_pix_bwd_kernel(img, x, y, scale, g,
                                                      f32_d_img=True)
        torch.cuda.synchronize()
        ref = dcn_cuda.bilinear_sample_pix_bwd_plain(img, x, y, scale, g,
                                                     f32_d_img=True)
        errs = dcn_bwd_errors(got, ref)
        abs_err = max_err(got, ref)
        ok = all(e <= DCN_BWD_RTOL for e in errs)
        row = dict(case=case.get("tap", "edges"),
                   **{k: v for k, v in case.items()
                      if k not in ("dtype", "tap")},
                   dtype=str(case["dtype"]),
                   design="tap" if dcn_cuda.tiled(img.shape, case["P"])
                   else "point",
                   err_d_img_f32=errs[0], err_d_xy_scale=errs[1:],
                   max_abs_err=abs_err, rtol=DCN_BWD_RTOL)
        del got, ref
        if not case["edges"]:
            n_bytes, distinct = dcn_bwd_bytes(img, x, y, scale, g)
            spills = dcn_cuda.spilled_corners(img.shape, x, y)
            valid = [c[2] for c in dcn_cuda.corner_meta(img.shape, x, y,
                                                        None)[0]]
            n_valid = sum(int(v.sum()) for v in valid)
            row["spilled_corners"] = sum(int(s.sum()) for s in spills)
            row["spill_share"] = row["spilled_corners"] / max(n_valid, 1)
            if case["tap"] == "tap_stage3":
                row.update(dcn_autograd_times(img, x, y, scale, g))
            row.update(
                **times_ms(lambda: dcn_cuda.bilinear_sample_pix_bwd_kernel(
                    img, x, y, scale, g)),
                plain_ms=device_time_ms(
                    lambda: dcn_cuda.bilinear_sample_pix_bwd_plain(
                        img, x, y, scale, g)),
                library_ms=None, distinct_rows=distinct, bytes=n_bytes,
                bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S, bound_by="bytes")
        emit("kernel_dcn_bwd", name="dcn_sample_bwd", **row)
        check(ok, f"DCN sampler backward kernel vs plain {row}")
        rows.append(row)
        del img, x, y, scale, g
        torch.cuda.empty_cache()
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


# ------------------------------------------------------------ NOVEL, kNN

KNN_V = 26317           # FaceScape's mesh (models/novel/regressor.py)
# a NOVEL training step's kNN shapes: the sampler's 4,096 rays × 1,000
# candidates and deform_points' 4,096 × 40 samples
KNN_RAYS, KNN_CANDIDATES, KNN_SAMPLES = 4096, 1000, 40
NOVEL_HW = (256, 256)   # FaceScape's images, 2 source views
NOVEL_NV = 2            # (scripts/variant_warm_bench.py:8-9)
NOVEL_CONFIG = ROOT / "configs" / "train_novel_facescape.yaml"
NOVEL_DIR = OUT_DIR / "novel"
NOVEL_CLI_STEPS = 3
NOVEL_WARM_STEPS = 5
# the kNN's bound: 4 multiply-add-class FP32 operations a point-vertex
# pair (3 for the dot product, 1 for d²), 2 FLOPs each
KNN_FLOPS_PER_PAIR = 8
# row gathers of one NOVEL forward (sampler map, the sampler's offsets, the
# samples' two offsets, 4 latent corners, 4 plane corners, the depth) and
# NOVEL_PE's 8 PE-map corners; the backward is index_add_
NOVEL_C_PER_STEP = {False: 13, True: 21}
NOVEL_KNN_PER_STEP = 3  # the sampler's candidates, the samples twice
NOVEL_TAG = "novel_cli_result="


def counted_cli(module, tag, setup=""):
    """A ``python -c`` script that runs ``setup``, then ``module``'s
    ``main`` on the script's arguments with every launch count set to 0
    just before it (``reset_counts``) and read just after it
    (``read_counts``), and prints one line after ``tag``: main's return
    value, the counts and the peak allocation. It imports this file, so it
    runs with the repository's root as its working directory."""
    return (
        "import json, sys, torch\n"
        "from chip_smoke import read_counts, reset_counts\n"
        f"from {module} import main\n" + setup +
        "reset_counts()\n"
        "records = main(sys.argv[1:])\n"
        f"print({tag!r} + json.dumps(dict(records=records, "
        "launches=list(read_counts()), "
        "peak=torch.cuda.max_memory_allocated())))\n")


# ``python -m diner_tpu_torch.train ARGS`` under ``counted_cli``
NOVEL_CLI = counted_cli("diner_tpu_torch.train.__main__", NOVEL_TAG)


def knn_bound(SB, N, V, pairs=None):
    """(ms, what bounds it) for ``pairs`` point-vertex tests over the FP32
    rate, or the bytes (points and vertices read once, indices written
    once) over the memory rate, whichever is larger. By default ``pairs``
    is one a point: any exact search tests at least each point's own
    nearest vertex, so that is the function's bound, whatever the data and
    however a kernel culls. ``pairs = SB·N·V`` gives the brute-force
    figure."""
    pairs = SB * N if pairs is None else pairs
    ops_ms = 1e3 * pairs * KNN_FLOPS_PER_PAIR / F32_FLOPS_PER_S
    bytes_ms = 1e3 * SB * (N * 16 + V * 12) / HBM_BYTES_PER_S
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def knn_tested_pairs(SB, N, V, culled):
    """The point-vertex tests a kernel run makes when it culls ``culled`` of
    its (warp, tile) pairs: every vertex of a scanned tile for each of the
    warp's 32 points, and each point's representatives. A measure of the
    kernel's own work, not of the function's: no bound is made from it."""
    from diner_tpu_torch.ops import knn_cuda
    tiles = -(-V // knn_cuda.TILE)
    scanned = round((1.0 - culled) * SB * -(-N // 32) * tiles)
    return (scanned * 32 * knn_cuda.TILE
            + SB * N * -(-V // knn_cuda.REP_STRIDE))


def knn_compare(points, verts, offsets=None):
    """The kernel against its plain version on one input: index
    disagreements, the largest gap between the two chosen vertices' exact
    squared distances where they disagree, and (with ``offsets``) the
    deformed points' largest error where they agree."""
    from diner_tpu_torch.ops import knn_cuda
    from diner_tpu_torch.ops.knn import deform_points
    got = knn_cuda.knn1_kernel(points, verts)
    torch.cuda.synchronize()
    ref = knn_cuda.knn1_plain(points, verts)
    diff = got != ref
    n_diff = int(diff.sum())
    gap = 0.0
    if n_diff:
        s, i = diff.nonzero(as_tuple=True)
        p = points[s, i].double()
        d_got = ((p - verts[s, got[s, i].long()].double()) ** 2).sum(-1)
        d_ref = ((p - verts[s, ref[s, i].long()].double()) ** 2).sum(-1)
        gap = float((d_got - d_ref).abs().max())
    row = dict(SB=points.shape[0], N=points.shape[1], V=verts.shape[1],
               index_disagreements=n_diff, distance_gap=gap,
               exact=n_diff == 0)
    if offsets is not None:
        moved = deform_points(points, verts, offsets)
        plain = points + torch.gather(
            offsets, 1, ref.long()[..., None].expand(-1, -1, 3))
        agree = ~diff
        row["deformed_max_abs_err"] = (
            float((moved - plain)[agree].abs().max()) if agree.any()
            else 0.0)
    row["max_abs_err"] = row.get("deformed_max_abs_err", 0.0)
    return row, got


def knn_timed(points, verts, big, culled, plain=True):
    """``ms`` / ``call_ms`` of the kernel, ``plain_ms`` of the plain
    version and ``library_ms`` of ``torch.cdist(...).argmin(-1)`` in the
    plain version's chunks (no single PyTorch call computes a top-1
    index). With ``big`` (a second or more a call for the plain version
    and cdist) those two are timed over 1 call between CUDA events, not in
    a graph, and the kernel's graph holds 5 calls. Without
    ``plain`` only the kernel is timed. ``bound_ms`` is ``knn_bound``'s, from
    the inputs alone; beside it stand the tests the kernel made
    (``culled``: the share of (warp, tile) pairs it skipped) and their time
    at the FP32 rate, and the brute-force figure (every pair tested)."""
    from diner_tpu_torch.ops import knn_cuda

    def kernel():
        return knn_cuda.knn1_kernel(points, verts)

    def plain_version():
        return knn_cuda.knn1_plain(points, verts)

    def library():
        return torch.cat([torch.cdist(points[:, s:s + 2048], verts)
                          .argmin(-1) for s in range(0, points.shape[1],
                                                     2048)], dim=1)

    if big and not plain:
        t = dict(ms=device_time_ms(kernel, n=5, replays=3),
                 call_ms=cuda_time_ms(kernel, 5, 1))
    elif big:
        t = dict(ms=device_time_ms(kernel, n=5, replays=3),
                 call_ms=cuda_time_ms(kernel, 5, 1),
                 plain_ms=cuda_time_ms(plain_version, 1, 1),
                 library_ms=cuda_time_ms(library, 1, 1),
                 plain_timing="1 call between CUDA events")
    else:
        t = dict(ms=device_time_ms(kernel, n=20), call_ms=cuda_time_ms(
                     kernel, 10, 2),
                 plain_ms=device_time_ms(plain_version, n=5, replays=3),
                 library_ms=device_time_ms(library, n=5, replays=3),
                 plain_timing="CUDA graph of 5 calls")
    SB, N = points.shape[:2]
    V = verts.shape[1]
    bound, by = knn_bound(SB, N, V)
    pairs = knn_tested_pairs(SB, N, V, culled)
    return dict(t, bound_ms=bound, bound_by=by, tested_pairs=pairs,
                tested_pairs_ms=1e3 * pairs * KNN_FLOPS_PER_PAIR
                / F32_FLOPS_PER_S,
                brute_force_ms=knn_bound(SB, N, V, SB * N * V)[0])


def knn_edge_cases(device, seed=0):
    """name → (points, vertices, expected indices or None): N and V no
    multiples of the block (256) or the tile (2048), V = 1, duplicated
    vertices (the first copy wins), exact ties on a lattice, two scenes
    with different vertex sets, points as a strided view, NaN inputs (the
    first NaN distance wins, as ``argmin``'s), and three tiles with an
    infinite vertex, a huge one (|v|² overflows) and a NaN one, and a huge
    point (its products overflow): the kernel's NaN-aware scan runs on
    some tiles and not on others; and points equidistant (bit for bit)
    from two mirrored vertices in different tiles, where the lower index
    must win though the tiles come out of index order."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape):
        return torch.randn(shape, generator=g, device=device)

    v = rand(1, 2049, 3)
    lattice = torch.stack(torch.meshgrid(
        *(torch.arange(4.0, device=device),) * 3, indexing="ij"),
        dim=-1).reshape(1, -1, 3)
    centres = lattice[:, :27] + 0.5  # 8 lattice vertices tie at each
    two = rand(2, 500, 3)
    two[1] += 3.0
    wide = rand(1, 1001, 6)
    nan_v = v[:, :40].clone()
    nan_v[0, 5, 1] = nan_v[0, 9, 0] = float("nan")
    nan_p = rand(1, 300, 3)
    nan_p[0, 7, 2] = float("nan")  # every distance NaN: index 0
    nan_expected = torch.full((1, 300), 5, dtype=torch.int32, device=device)
    nan_expected[0, 7] = 0
    # tile 0: (inf, 0, 0) at 300, NaN d² for x > 0; tile 1: 1e30 at 3000,
    # d² = +inf; tile 2: a NaN at 4100, the first NaN for x < 0
    inf_v = rand(1, 4200, 3)
    inf_v[0, 300] = torch.tensor([float("inf"), 0.0, 0.0])
    inf_v[0, 3000] = 1e30
    inf_v[0, 4100, 2] = float("nan")
    inf_p = rand(1, 500, 3)
    inf_p[0, 10] = 1e20
    inf_expected = torch.where(inf_p[..., 0] > 0, 300, 4100).int()
    # vertex i and i + 600 mirrored in y, |y| ≥ 0.3 (other Morton halves,
    # so other tiles); points at y = 0 tie exactly between the two
    half = rand(1, 600, 3)
    half[..., 1] = torch.sign(half[..., 1]) * (0.3 + half[..., 1].abs())
    mirrored = torch.cat([half, half * torch.tensor([1.0, -1.0, 1.0],
                                                    device=device)], dim=1)
    on_plane = rand(1, 500, 3)
    on_plane[..., 1] = 0.0
    return {
        "n1001_v2049": (rand(1, 1001, 3), v, None),
        "n257_v1": (rand(1, 257, 3), v[:, :1],
                    torch.zeros((1, 257), dtype=torch.int32, device=device)),
        "duplicates": (rand(1, 3000, 3), torch.cat([v, v], dim=1), None),
        "lattice_ties": (centres, lattice, None),
        "sb2_distinct_sets": (rand(2, 300, 3) + torch.tensor(
            [[[0.0]], [[3.0]]], device=device), two, None),
        "strided_points": (wide[..., :3], v[:, :100], None),
        "n0": (rand(1, 0, 3), v, None),
        "nan_inputs": (nan_p, nan_v, nan_expected),
        "nonfinite_tiles": (inf_p, inf_v, inf_expected),
        "mirror_ties": (on_plane, mirrored, None),
    }


def knn_ray_points(device, n_rays=None, n_cand=None, V=None, seed=9):
    """(points, vertices) as NOVEL's sampler makes them: the ``n_cand``
    stratified candidates of each of ``n_rays`` consecutive target rays
    through the middle of the sphere fixture's 256×256 view, ray-major
    (SB = 1), between the config's znear and zfar; ``V`` points of the
    sphere's surface as the mesh."""
    from diner_tpu_torch.data.synthetic_dataset import SphereDataset
    from diner_tpu_torch.ops.sampling import stratified_z
    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.diner import target_rays
    n_rays = KNN_RAYS if n_rays is None else n_rays
    n_cand = KNN_CANDIDATES if n_cand is None else n_cand
    V = KNN_V if V is None else V
    g = torch.Generator(device=device).manual_seed(seed)
    verts = torch.from_numpy(SphereDataset._surface_points(V, 0))[None].to(
        device)
    b = {k: torch.from_numpy(v[None]).to(device) for k, v in SphereDataset(
        "val", n=1, H=NOVEL_HW[0], W=NOVEL_HW[1], nv=NOVEL_NV)[0].items()
        if isinstance(v, np.ndarray)}
    H, W = NOVEL_HW
    rays = target_rays(load_train_config(NOVEL_CONFIG).diner, b, H, W)
    mid = H * W // 2 - n_rays // 2
    chunk = rays[:, mid:mid + n_rays].contiguous()
    u = torch.rand((1, n_rays, n_cand), generator=g, device=device)
    z = stratified_z(chunk, n_cand, u)
    points = (chunk[..., None, :3] + z[..., None]
              * chunk[..., None, 3:6]).reshape(1, -1, 3)
    return points, verts


def phase_kernel_knn():
    """The top-1 kNN kernel against its plain version: the edge cases of
    ``knn_edge_cases`` (every index equal), a 64-bit-offset case (N·3 past
    2³¹: 716 million points, V = 2, the answer known from the sign of x),
    and the NOVEL step's shapes on FaceScape's 26,317 vertices (the
    sphere's surface points): the sampler's 4,096 rays × 1,000 candidates
    and ``deform_points``' 4,096 × 40 samples, each on ray-ordered points
    as the path makes them (``knn_ray_points``) and uniform in a cube.
    Every index equal, the deformed points equal; each case timed, with
    the share of (warp, tile) pairs the kernel culled."""
    from diner_tpu_torch.ops import knn_cuda
    rows = []
    for name, (pts, verts, expected) in knn_edge_cases("cuda").items():
        row, got = knn_compare(pts, verts)
        if expected is not None:
            row["exact"] = row["exact"] and torch.equal(got, expected)
        if name == "duplicates":  # the first copy of each vertex wins
            row["exact"] = row["exact"] and int(got.max()) < 2049
        emit("kernel_knn", case=name, **row)
        check(row["exact"], f"kNN kernel vs plain, {name}: {row}")
        rows.append(dict(case=name, **row))

    n = 716_000_000  # N·3 > 2^31
    pts = torch.rand((1, n, 3), device="cuda") * 2 - 1
    verts = torch.tensor([[[-1.0, 0, 0], [1.0, 0, 0]]], device="cuda")
    got = knn_cuda.knn1_kernel(pts, verts)
    torch.cuda.synchronize()
    ok = bool((got == (pts[..., 0] > 0).int()).all())
    row = dict(case="offsets_64bit", SB=1, N=n, V=2, exact=ok,
               index_disagreements=int((got != (pts[..., 0] > 0).int())
                                       .sum()), max_abs_err=0.0)
    emit("kernel_knn", **row)
    check(ok, f"kNN kernel past 2^31 / 3 points: {row}")
    rows.append(row)
    del pts, got
    torch.cuda.empty_cache()

    g = torch.Generator(device="cuda").manual_seed(9)
    ray_points, verts = knn_ray_points("cuda")
    deform_rays = knn_ray_points("cuda", n_cand=KNN_SAMPLES, seed=10)[0]
    offsets = torch.randn(verts.shape, generator=g, device="cuda") * 0.02
    # (name, points, big as knn_timed takes it): the path's own ray-ordered
    # points at the sampler's shape (render_chunk: 4,096 rays × 1,000
    # candidates) and deform_points' (4,096 × 40 samples), and the same
    # shapes uniform in a cube around the sphere, the worst case for the
    # tile cull; the plain version and cdist, seconds a call at the
    # sampler's shape, are timed at render_chunk only
    cases = (
        ("render_chunk", ray_points, True),
        ("sampler", torch.rand(ray_points.shape, generator=g,
                               device="cuda") * 1.2 - 0.6, True),
        ("deform_rays", deform_rays, False),
        ("deform", torch.rand(deform_rays.shape, generator=g,
                              device="cuda") * 1.2 - 0.6, False))
    for name, pts, big in cases:
        row, _ = knn_compare(pts, verts, offsets)
        _, culled = knn_cuda.knn1_kernel_culled(pts, verts)
        row.update(knn_timed(pts, verts, big, culled,
                             plain=name != "sampler"), tiles_culled=culled)
        row["case"] = name
        emit("kernel_knn", **row)
        check(row["index_disagreements"] == 0
              and row["deformed_max_abs_err"] == 0.0,
              f"kNN kernel vs plain at {name}: {row}")
        rows.append(row)
        del pts
        torch.cuda.empty_cache()
    return rows


def novel_yaml(model):
    """``configs/train_novel_facescape.yaml`` with only ``data`` swapped
    for the sphere at FaceScape's shape (256×256, 2 source views, 26,317
    mesh vertices) and the run written under ``NOVEL_DIR``; written as
    JSON (valid YAML) → its path."""
    from diner_tpu_torch.train.config import load_train_config
    raw = load_train_config(NOVEL_CONFIG).raw
    sphere = {"module": "synthetic_sphere", "kwargs": {
        "n": 8, "H": NOVEL_HW[0], "W": NOVEL_HW[1], "nv": NOVEL_NV,
        "n_vertices": KNN_V}}
    for stage in ("train", "val"):
        raw["data"][stage]["dataset"] = sphere
    raw["logger"]["kwargs"].update(save_dir=str(NOVEL_DIR / "runs"),
                                   version=model)
    NOVEL_DIR.mkdir(parents=True, exist_ok=True)
    path = NOVEL_DIR / f"{model}.yaml"
    path.write_text(json.dumps(raw, indent=1))
    return path


def novel_step_launches(use_pe):
    return (1, 1, NOVEL_C_PER_STEP[use_pe], 0, NOVEL_KNN_PER_STEP, 0)


def phase_novel_train(smi, use_pe):
    """NOVEL (or NOVEL_PE) training at ``configs/train_novel_facescape
    .yaml``'s width on the sphere at FaceScape's shape: ``python -m
    diner_tpu_torch.train <yaml> NOVEL --max-steps 3`` in a subprocess
    (``NOVEL_CLI``), then in this process ``create_novel_state`` and the
    train step: 2 warm-up and ``NOVEL_WARM_STEPS`` timed steps, one step
    under the profiler. Checks: the CLI's checkpoint and launches, each
    step's launches (A 1, B 1, C ``NOVEL_C_PER_STEP``, DCN 0, kNN 3),
    finite losses and gradients, the plane's gradient, moved parameters,
    both peaks within ``MEMORY_SHARE_LIMIT`` of the card. Returns the train
    step, a batch and {path: launches}."""
    from diner_tpu_torch.data.loader import DataLoader
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.models.novel.train import (build_novel_run_config,
                                                    create_novel_state)
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.loop import arrays_of
    model = "NOVEL_PE" if use_pe else "NOVEL"
    phase = "novel_pe_train" if use_pe else "novel_train"
    path = novel_yaml(model)
    run_cfg = load_train_config(path, model_name=model)
    total_mem = torch.cuda.get_device_properties(0).total_memory
    mem_limit = int(MEMORY_SHARE_LIMIT * total_mem)
    per_step = novel_step_launches(use_pe)

    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-c", NOVEL_CLI, str(path), model, "--max-steps",
         str(NOVEL_CLI_STEPS), "--device", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    (NOVEL_DIR / f"{model}_cli.log").write_text(cli.stdout + cli.stderr)
    check(cli.returncode == 0 and NOVEL_TAG in cli.stdout,
          f"{model} CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    res = json.loads(cli.stdout.split(NOVEL_TAG)[-1].splitlines()[0])
    ckpt = ckpt_lib.latest_checkpoint(run_cfg.run_dir / "checkpoints")
    saved = ckpt_lib.load_state(ckpt)
    check(saved["step"] == NOVEL_CLI_STEPS and all(
        bool(torch.isfinite(v).all()) for v in saved["model"].values()),
        f"{model} CLI checkpoint {ckpt}: step {saved['step']}")
    check(("deformation_layer.weight" in saved["model"]) == use_pe,
          f"{model} CLI checkpoint's parameters")
    cli_expected = [n * NOVEL_CLI_STEPS for n in per_step]
    check(res["launches"] == cli_expected,
          f"{model} CLI launches {res['launches']}, expected "
          f"{cli_expected}")
    check(res["peak"] <= mem_limit, f"{model} CLI peak {res['peak']} B")
    del saved

    cfg = build_novel_run_config(run_cfg, use_pe)
    batch = arrays_of(next(iter(DataLoader(run_cfg.build_dataset("train"),
                                           1, num_workers=0))))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_novel_state(cfg, device="cuda",
                               vgg=init_vgg19(0, device="cuda"))
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    params0 = {n: p.detach().clone()
               for n, p in state.model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    t1 = time.perf_counter()
    state(batch, generator=gen)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          f"{model}: non-finite gradient in the first step")
    check(float(grads["gen_latent"].abs().max()) > 0,
          f"{model}: no gradient reached the gen-latent plane")
    moved = sum(not torch.equal(p.detach(), params0[n])
                for n, p in state.model.named_parameters())
    check(moved > 0, f"{model}: no parameter moved")
    del params0
    state(batch, generator=gen)
    torch.cuda.synchronize()
    times, losses, launches = [], [], []
    for _ in range(NOVEL_WARM_STEPS):
        reset_counts()
        t2 = time.perf_counter()
        m = state(batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t2)
        launches.append(read_counts())
        losses.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    check(all(c == per_step for c in launches),
          f"{model}: launches per step {launches}, expected {per_step}")
    measured = tuple(map(sum, zip(*launches)))
    check(all(np.isfinite(v) for x in losses for v in x.values())
          and sorted(losses[0]) == ["antibias", "rgb_fine", "total",
                                    "vgg_fine"], f"{model}: {losses}")
    check(peak <= mem_limit, f"{model}: peak {peak} B")
    s_step = statistics.median(times)
    emit(phase, config=f"{model}, configs/train_novel_facescape.yaml "
         f"(ResNet34, ResnetFC 5x512, 40 of 1000 samples, 15 Gaussians, "
         f"64x64 patch, f32); sphere {NOVEL_HW[0]}x{NOVEL_HW[1]}, "
         f"{NOVEL_NV} views, {KNN_V} mesh vertices", nvidia_smi=smi,
         rays_per_step=cfg.rays_per_step, cli_steps=NOVEL_CLI_STEPS,
         cli_s=t_cli, cli_peak_mem_bytes=res["peak"],
         cli_launches=res["launches"], model_init_s=t_model,
         first_step_s=t_first, time_to_first_step_s=t_model + t_first,
         s_per_step=s_step, s_per_step_all=times,
         rays_per_s=cfg.rays_per_step / s_step, peak_mem_bytes=peak,
         memory_limit_bytes=mem_limit, launches_per_step=launches,
         expected_launches_per_step=per_step, params_moved=moved,
         losses=losses)
    profile_once(phase + "_profile", lambda: state(batch, generator=gen))
    return state, batch, {
        phase: measured,
        phase.replace("_train", "_cli"): tuple(res["launches"])}


def phase_novel_render(state, batch):
    """One 256×256 target through ``render_rays_novel`` in 4,096-ray
    chunks with the trained NOVEL state (batch statistics, as the DINER
    eval step encodes): a first image, then 2 timed. Checks: a finite image
    of the right shape; per image kernel A 16 times, B never, C 13 and the
    kNN 3 times per chunk."""
    from diner_tpu_torch.models.novel.renderer import render_rays_novel
    from diner_tpu_torch.models.novel.train import NOVEL_KEYS, gen_context_of
    from diner_tpu_torch.train.diner import (SRC_KEYS, batch_to_device,
                                             target_rays)
    model, cfg = state.model, state.cfg
    b = batch_to_device(batch, "cuda")
    H, W = NOVEL_HW
    chunk = cfg.renderer.ray_chunk
    n_chunks = -(-H * W // chunk)

    @torch.no_grad()
    def render(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        ctx = model.encode(*(b[k] for k in SRC_KEYS))
        gen = gen_context_of(model, b, W, H)
        rays = target_rays(cfg, b, H, W)
        rgb, depth = [], []
        for s in range(0, H * W, chunk):
            o = render_rays_novel(model.field, ctx, gen,
                                  rays[:, s:s + chunk].contiguous(),
                                  *(b[k] for k in NOVEL_KEYS), cfg.renderer,
                                  generator=g)
            rgb.append(o.rgb)
            depth.append(o.depth)
        torch.cuda.synchronize()
        return (torch.cat(rgb, 1).reshape(1, H, W, 3),
                torch.cat(depth, 1).reshape(1, H, W))

    times, counts = [], []
    for seed in range(3):
        reset_counts()
        t0 = time.perf_counter()
        rgb, depth = render(seed)
        times.append(time.perf_counter() - t0)
        counts.append(read_counts())
    expected = (n_chunks, 0, NOVEL_C_PER_STEP[False] * n_chunks, 0,
                NOVEL_KNN_PER_STEP * n_chunks, 0)
    check(rgb.shape == (1, H, W, 3) and bool(torch.isfinite(rgb).all())
          and bool(torch.isfinite(depth).all()),
          f"NOVEL render: {rgb.shape}, finite {torch.isfinite(rgb).all()}")
    check(all(c == expected for c in counts),
          f"NOVEL render launches per image {counts}, expected {expected}")
    emit("novel_render", image_hw=NOVEL_HW, chunks=n_chunks,
         first_image_s=times[0], s_per_image=statistics.median(times[1:]),
         s_per_image_all=times, launches_per_image=counts,
         expected_launches_per_image=expected,
         rgb_mean=float(rgb.mean()), depth_mean=float(depth.mean()))
    return {"novel_render": tuple(map(sum, zip(*counts)))}


def phase_novel_small_reference(use_pe):
    """One small NOVEL (NOVEL_PE) step on the card against the same step on
    the CPU: 24×24 sphere, resnet18 with 2 levels, d_hidden 32, a 16×16
    plane, 8 of 64 samples, MSE + VGG + antibias on an 8×8 patch,
    non-zero random mesh offsets; same weights, VGG, pixels and noise, f32.
    The loss and every gradient over its norm are held to the DINER
    ``train_small_reference``'s tolerances."""
    import copy

    from diner_tpu_torch.data.synthetic_dataset import SphereDataset
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.models.novel.model import NovelPixelNeRFConfig
    from diner_tpu_torch.models.novel.train import (NovelConfig,
                                                    compute_novel_losses,
                                                    create_novel_model)
    from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
    from diner_tpu_torch.renderer import RendererConfig, draw_noise
    from diner_tpu_torch.train.diner import batch_to_device, select_pixels
    model = "NOVEL_PE" if use_pe else "NOVEL"
    cfg = NovelConfig(
        nerf=NovelPixelNeRFConfig(
            encoder=SpatialEncoderConfig(backbone="resnet18", num_layers=2,
                                         image_padding=8),
            d_hidden=32, gen_latent_hw=16, gen_latent_ch=128,
            use_pe_maps=use_pe),
        renderer=RendererConfig(n_samples=8, n_depth_candidates=64,
                                n_gaussian=3, white_bkgd=True),
        w_vgg=0.1, vgg_spatch=8, w_antibias=1.0)
    s = SphereDataset("train", n=2, H=24, W=24, nv=2, model=model,
                      n_vertices=300)[1]
    batch = {k: v[None] for k, v in s.items() if isinstance(v, np.ndarray)}
    rng = np.random.default_rng(3)
    for k in ("offset_target_to_source", "offset_target_to_gen"):
        batch[k] = rng.normal(0, 0.02, batch[k].shape).astype(np.float32)
    cpu_model = create_novel_model(cfg, seed=0, device="cpu")
    cpu_vgg = init_vgg19(0, device="cpu")
    g = torch.Generator().manual_seed(2)
    pix = select_pixels(cfg, batch_to_device(batch, "cpu"), g)
    noise = draw_noise(cfg.renderer, 1, cfg.rays_per_step, generator=g)
    res = {}
    for where, dev in (("cpu", "cpu"), ("card", "cuda")):
        m = copy.deepcopy(cpu_model).to(dev)
        reset_counts()
        total, _ = compute_novel_losses(
            m, cfg, batch_to_device(batch, dev),
            copy.deepcopy(cpu_vgg).to(dev), pix_idcs=pix.to(dev),
            noise=tuple(t.to(dev) for t in noise))
        total.backward()
        res[where] = (total.item(), grads_of(m), read_counts())
    expected = novel_step_launches(use_pe)
    check(res["card"][2] == expected and res["cpu"][2] == (0, 0, 0, 0, 0, 0),
          f"{model} card step launches {res['card'][2]}, expected "
          f"{expected}; CPU step {res['cpu'][2]}")
    loss_err = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    worst, name, nonzero = grad_errs(res["card"][1], res["cpu"][1])
    emit("novel_pe_small_reference" if use_pe else "novel_small_reference",
         rays=cfg.rays_per_step, loss_card=res["card"][0],
         loss_cpu=res["cpu"][0], loss_rel_err=loss_err,
         worst_grad_err_over_norm=worst, worst_param=name,
         params=len(res["cpu"][1]), params_grad_nonzero=nonzero, tol=1e-3)
    check(loss_err <= 1e-4 and worst <= 1e-3,
          f"{model} card vs CPU step: loss {loss_err}, grad {worst} at "
          f"{name}")


def phases_novel(smi):
    """The NOVEL phases in order; their files are deleted after. Returns
    {path: (A, B, C, DCN backward, kNN) launches}."""
    state, batch, launches = phase_novel_train(smi, use_pe=False)
    launches.update(phase_novel_render(state, batch))
    del state, batch
    torch.cuda.empty_cache()
    launches.update(phase_novel_train(smi, use_pe=True)[2])
    torch.cuda.empty_cache()
    phase_novel_small_reference(use_pe=False)
    phase_novel_small_reference(use_pe=True)
    shutil.rmtree(NOVEL_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------------ KeypointNeRF

KPN_CONFIG = ROOT / "configs" / "train_keypointnerf_facescape.yaml"
KPN_DIR = OUT_DIR / "keypointnerf"
KPN_N_KPT = 68          # FaceScape's 3-D landmarks (KeypointNeRFConfig)
KPN_CLI_STEPS = 3
KPN_WARM_STEPS = 5
# the small reference's seed: seed 0's draw of ``KPN_SMALL`` has a dead
# density head, relu(radiance + noise) = 0 at every sample of its batch,
# and its step passes no gradient at all (the model's init has no reroll,
# in either package); seed 1's draw is alive
KPN_SMALL_SEED = 1
# row gathers of one query pass: 4 corners of each of its 5 bilinear
# samples (source masks, geometry coarse and full-resolution levels,
# source images, texture features); a step and a render call run the
# coarse and the fine pass; the backward is index_add_
KPN_C_PER_PASS = 20
KPN_C_PER_STEP = 2 * KPN_C_PER_PASS
KPN_CALLS_PER_IMAGE = 16  # 256 strided tiles of 16×16, 16 a call
KPN_RENDERS = 3  # a first image and 2 timed
# parameters whose gradient is zero but for rounding: the texture
# encoder's convolution biases before an instance norm; the colour head's
# last bias, an offset of every view's logit that the view softmax
# ignores; and, with 2 source views, its ani_al (once the smaller view's
# exp term is subtracted the two anisotropy weights are 0 and 1 whatever
# ani_al is). They are held below KPN_ZERO_GRAD_TOL of the step's largest
# gradient norm instead of to their own norm
KPN_ZERO_GRAD = re.compile(
    r"tex_encoder\.(down_\d+|res_\d+_conv[12]|up_\d+|conv_in)\.bias$"
    r"|mlp_tex\.(out_layer_2\.bias|ani_al)$")
KPN_ZERO_GRAD_TOL = 1e-4
KPN_SMALL = dict(n_kpt=8, sp_level=2, geo_out_ch=16, geo_n_downsample=2,
                 tex_ngf=8, tex_n_blocks=1, mlp_dims1=(0, 32, 32, 24, 16),
                 mlp_dims2=(32, 16, 16, 2), gcompress_out=8,
                 ibr_in_channels=16, train_out_h=8, train_out_w=8,
                 sample_per_ray_c=8, sample_per_ray_f=8, znear=0.8,
                 zfar=2.4)


def kpn_yaml():
    """``configs/train_keypointnerf_facescape.yaml`` with only ``data``
    swapped for the sphere at FaceScape's shape (256×256, 2 source views,
    68 keypoints) and the run written under ``KPN_DIR``; written as JSON
    (valid YAML) → its path."""
    from diner_tpu_torch.train.config import load_train_config
    raw = load_train_config(KPN_CONFIG).raw
    sphere = {"module": "synthetic_sphere", "kwargs": {
        "n": 8, "H": NOVEL_HW[0], "W": NOVEL_HW[1], "nv": NOVEL_NV,
        "n_kpt": KPN_N_KPT}}
    for stage in ("train", "val"):
        raw["data"][stage]["dataset"] = sphere
    raw["logger"]["kwargs"].update(save_dir=str(KPN_DIR / "runs"),
                                   version="KeypointNeRF")
    KPN_DIR.mkdir(parents=True, exist_ok=True)
    path = KPN_DIR / "KeypointNeRF.yaml"
    path.write_text(json.dumps(raw, indent=1))
    return path


def phase_keypointnerf_train(smi):
    """KeypointNeRF training at ``configs/train_keypointnerf_facescape
    .yaml``'s width (``KeypointNeRFConfig``'s defaults) on the sphere at
    FaceScape's shape: ``python -m diner_tpu_torch.train <yaml>
    KeypointNeRF --max-steps 3`` in a subprocess (``NOVEL_CLI``, the train
    CLI under ``counted_cli``), then in this process
    ``create_keypointnerf_state`` and the train step: 1 warm-up and
    ``KPN_WARM_STEPS`` timed steps, one step under the profiler. Checks:
    the CLI's checkpoint and launches, each step's launches (C
    ``KPN_C_PER_STEP``, no other kernel), finite losses and gradients, the
    geometry encoder's gradient, moved parameters, both peaks within
    ``MEMORY_SHARE_LIMIT`` of the card. Returns the train step, a batch and
    {path: launches}."""
    from diner_tpu_torch.data.loader import DataLoader
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.models.keypointnerf.train import (
        build_keypointnerf_run_config, create_keypointnerf_state)
    from diner_tpu_torch.train import checkpoint as ckpt_lib
    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.loop import arrays_of
    path = kpn_yaml()
    run_cfg = load_train_config(path, model_name="KeypointNeRF")
    total_mem = torch.cuda.get_device_properties(0).total_memory
    mem_limit = int(MEMORY_SHARE_LIMIT * total_mem)
    per_step = (0, 0, KPN_C_PER_STEP, 0, 0, 0)

    import gc
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cli = subprocess.run(
        [sys.executable, "-c", NOVEL_CLI, str(path), "KeypointNeRF",
         "--max-steps", str(KPN_CLI_STEPS), "--device", "cuda"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    t_cli = time.perf_counter() - t0
    (KPN_DIR / "cli.log").write_text(cli.stdout + cli.stderr)
    check(cli.returncode == 0 and NOVEL_TAG in cli.stdout,
          f"KeypointNeRF CLI exited {cli.returncode}: {cli.stderr[-2000:]}")
    res = json.loads(cli.stdout.split(NOVEL_TAG)[-1].splitlines()[0])
    ckpt = ckpt_lib.latest_checkpoint(run_cfg.run_dir / "checkpoints")
    saved = ckpt_lib.load_state(ckpt)
    check(saved["step"] == KPN_CLI_STEPS and all(
        bool(torch.isfinite(v).all()) for v in saved["model"].values()),
        f"KeypointNeRF CLI checkpoint {ckpt}: step {saved['step']}")
    cli_expected = [n * KPN_CLI_STEPS for n in per_step]
    check(res["launches"] == cli_expected,
          f"KeypointNeRF CLI launches {res['launches']}, expected "
          f"{cli_expected}")
    check(res["peak"] <= mem_limit, f"KeypointNeRF CLI peak {res['peak']} B")
    del saved

    cfg = build_keypointnerf_run_config(run_cfg)
    check(cfg.model.n_kpt == KPN_N_KPT and cfg.model.sp_dim == 476,
          f"KeypointNeRF config {cfg.model}")
    batch = arrays_of(next(iter(DataLoader(run_cfg.build_dataset("train"),
                                           1, num_workers=0))))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = create_keypointnerf_state(cfg, device="cuda",
                                      vgg=init_vgg19(0, device="cuda"))
    torch.cuda.synchronize()
    t_model = time.perf_counter() - t0
    params0 = {n: p.detach().clone()
               for n, p in state.model.named_parameters()}
    gen = torch.Generator(device="cuda").manual_seed(1)
    t1 = time.perf_counter()
    state(batch, generator=gen)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t1
    grads = {n: p.grad for n, p in state.model.named_parameters()}
    check(all(bool(torch.isfinite(g).all()) for g in grads.values()),
          "KeypointNeRF: non-finite gradient in the first step")
    check(float(grads["geo_encoder.conv1.weight"].abs().max()) > 0,
          "KeypointNeRF: no gradient reached the geometry encoder")
    moved = sum(not torch.equal(p.detach(), params0[n])
                for n, p in state.model.named_parameters())
    check(moved > 0, "KeypointNeRF: no parameter moved")
    del params0
    times, losses, launches = [], [], []
    for _ in range(KPN_WARM_STEPS):
        reset_counts()
        t2 = time.perf_counter()
        m = state(batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t2)
        launches.append(read_counts())
        losses.append({k: float(v) for k, v in m.items()})
    peak = torch.cuda.max_memory_allocated()
    check(all(c == per_step for c in launches),
          f"KeypointNeRF: launches per step {launches}, expected {per_step}")
    measured = tuple(map(sum, zip(*launches)))
    check(all(np.isfinite(v) for x in losses for v in x.values())
          and sorted(losses[0]) == ["e_all", "e_pix_c", "e_pix_l1",
                                    "e_vgg"], f"KeypointNeRF: {losses}")
    check(peak <= mem_limit, f"KeypointNeRF: peak {peak} B")
    s_step = statistics.median(times)
    R = cfg.model.train_out_h * cfg.model.train_out_w
    emit("keypointnerf_train", config="KeypointNeRF, configs/"
         "train_keypointnerf_facescape.yaml (HGFilterV2 64 ch, 1 stack, 4 "
         "downsamples; ResBlk ngf 64, 3 down, 4 blocks, 2 up, 8 ch; 64x64 "
         "patch, 64 + 64 samples, L1 1.0 / 10.0 + 0.5 VGG, f32); sphere "
         f"{NOVEL_HW[0]}x{NOVEL_HW[1]}, {NOVEL_NV} views, {KPN_N_KPT} "
         "keypoints", nvidia_smi=smi, rays_per_step=R,
         points_per_step=R * (cfg.model.sample_per_ray_c * 2
                              + cfg.model.sample_per_ray_f) * NOVEL_NV,
         cli_steps=KPN_CLI_STEPS, cli_s=t_cli,
         cli_peak_mem_bytes=res["peak"], cli_launches=res["launches"],
         model_init_s=t_model, first_step_s=t_first,
         time_to_first_step_s=t_model + t_first, s_per_step=s_step,
         s_per_step_all=times, rays_per_s=R / s_step, peak_mem_bytes=peak,
         memory_limit_bytes=mem_limit, launches_per_step=launches,
         expected_launches_per_step=per_step, params_moved=moved,
         losses=losses)
    profile_once("keypointnerf_train_profile",
                 lambda: state(batch, generator=gen))
    return state, batch, {"keypointnerf_train": measured,
                          "keypointnerf_cli": tuple(res["launches"])}


def phase_keypointnerf_render(state, batch):
    """One 256×256 target through ``render_full_image`` (the encoders once,
    16 calls of 16 strided 16×16 tiles) with the trained state: a first
    image, then 2 timed. Checks: finite colour and depth of the right
    shapes; per image kernel C ``KPN_C_PER_STEP`` times per call and no
    other kernel."""
    from diner_tpu_torch.models.keypointnerf.train import render_full_image
    H, W = NOVEL_HW
    times, counts = [], []
    for _ in range(KPN_RENDERS):
        reset_counts()
        t0 = time.perf_counter()
        color, depth = render_full_image(state.model, state.cfg.model, batch)
        times.append(time.perf_counter() - t0)
        counts.append(read_counts())
    expected = (0, 0, KPN_C_PER_STEP * KPN_CALLS_PER_IMAGE, 0, 0, 0)
    check(color.shape == (H, W, 3) and depth.shape == (H, W)
          and np.isfinite(color).all() and np.isfinite(depth).all(),
          f"KeypointNeRF render: {color.shape} {depth.shape}, finite "
          f"{np.isfinite(color).all()} {np.isfinite(depth).all()}")
    check(all(c == expected for c in counts),
          f"KeypointNeRF render launches per image {counts}, expected "
          f"{expected}")
    emit("keypointnerf_render", image_hw=NOVEL_HW,
         calls=KPN_CALLS_PER_IMAGE, first_image_s=times[0],
         s_per_image=statistics.median(times[1:]), s_per_image_all=times,
         launches_per_image=counts, expected_launches_per_image=expected,
         color_mean=float(color.mean()), depth_mean=float(depth.mean()))
    return {"keypointnerf_render": tuple(map(sum, zip(*counts)))}


def kpn_grad_errs(got, ref):
    """:func:`grad_errs` over the gradients that are not rounding noise,
    and the largest of those that are (``KPN_ZERO_GRAD``), in either
    result, over the reference's largest gradient norm → (worst, its name,
    nonzero, worst noise ratio)."""
    noise = [n for n in ref if KPN_ZERO_GRAD.search(n)]
    scale = max(float(g.float().norm()) for g in ref.values())
    worst_noise = max(float(g[n].abs().max()) for g in (got, ref)
                      for n in noise) / max(scale, 1e-30)
    kept = {n: g for n, g in ref.items() if n not in noise}
    return grad_errs(got, kept) + (worst_noise,)


def phase_keypointnerf_small_reference():
    """One small KeypointNeRF step on the card against the same step on
    the CPU (``KPN_SMALL``: 64×64 sphere, 2 views, 8 keypoints, narrow
    encoders and MLPs, 8 + 8 samples, an 8×8 patch, L1 + VGG): same
    weights, VGG, patch centre and draws, f32. The loss is held to 1e-4
    relative and every gradient to 1e-3 of its norm, as the NOVEL phase
    holds its step."""
    import copy

    from diner_tpu_torch.data.synthetic_dataset import SphereDataset
    from diner_tpu_torch.losses import init_vgg19
    from diner_tpu_torch.models.keypointnerf.model import (KeypointNeRFConfig,
                                                           draw_render_noise)
    from diner_tpu_torch.models.keypointnerf.train import (
        KeypointNeRFTrainConfig, compute_losses, create_keypointnerf_model,
        patch_center)
    from diner_tpu_torch.train.diner import batch_to_device
    cfg = KeypointNeRFTrainConfig(model=KeypointNeRFConfig(**KPN_SMALL))
    s = SphereDataset("train", n=4, H=64, W=64, nv=2, model="KeypointNeRF",
                      n_kpt=8)[1]
    batch = {k: v[None] for k, v in s.items() if isinstance(v, np.ndarray)}
    rng = np.random.default_rng(3)
    batch["src_rgbs"] = np.clip(batch["src_rgbs"] + rng.normal(
        0, 0.1, batch["src_rgbs"].shape), 0, 1).astype(np.float32)
    cpu_model = create_keypointnerf_model(cfg.model, seed=KPN_SMALL_SEED,
                                          device="cpu")
    cpu_vgg = init_vgg19(0, device="cpu")
    g = torch.Generator().manual_seed(2)
    center = patch_center(torch.from_numpy(batch["target_mask"]), g)
    noise = draw_render_noise(cfg.model, 1, 64, 2, generator=g)
    res = {}
    for where, dev in (("cpu", "cpu"), ("card", "cuda")):
        m = copy.deepcopy(cpu_model).to(dev)
        reset_counts()
        total, _ = compute_losses(
            m, cfg, batch_to_device(batch, dev),
            copy.deepcopy(cpu_vgg).to(dev), center=center.to(dev),
            noise=type(noise)(*(x.to(dev) for x in noise)))
        total.backward()
        res[where] = (total.item(), grads_of(m), read_counts())
    expected = (0, 0, KPN_C_PER_STEP, 0, 0, 0)
    check(res["card"][2] == expected and res["cpu"][2] == (0, 0, 0, 0, 0, 0),
          f"KeypointNeRF card step launches {res['card'][2]}, expected "
          f"{expected}; CPU step {res['cpu'][2]}")
    loss_err = abs(res["card"][0] - res["cpu"][0]) / abs(res["cpu"][0])
    worst, name, nonzero, noise_ratio = kpn_grad_errs(res["card"][1],
                                                      res["cpu"][1])
    emit("keypointnerf_small_reference", rays=64, loss_card=res["card"][0],
         loss_cpu=res["cpu"][0], loss_rel_err=loss_err,
         worst_grad_err_over_norm=worst, worst_param=name,
         params=len(res["cpu"][1]), params_grad_nonzero=nonzero, tol=1e-3,
         zero_grad_over_largest_norm=noise_ratio,
         zero_grad_tol=KPN_ZERO_GRAD_TOL)
    check(loss_err <= 1e-4 and worst <= 1e-3
          and noise_ratio <= KPN_ZERO_GRAD_TOL,
          f"KeypointNeRF card vs CPU step: loss {loss_err}, grad {worst} "
          f"at {name}, zero-gradient parameters {noise_ratio}")


def phases_keypointnerf(smi):
    """The KeypointNeRF phases in order; their files are deleted after.
    Returns {path: (A, B, C, DCN backward, kNN) launches}."""
    state, batch, launches = phase_keypointnerf_train(smi)
    launches.update(phase_keypointnerf_render(state, batch))
    del state, batch
    torch.cuda.empty_cache()
    phase_keypointnerf_small_reference()
    shutil.rmtree(KPN_DIR, ignore_errors=True)
    return launches


# ------------------------------------------------------------ TransMVSNet

MVS_DIR = OUT_DIR / "mvs"
MVS_FIXTURE = MVS_DIR / "dtu"  # the MVS layout: 1200×1600 renders
MVS_WRITE_HW = (512, 640)  # MVSDTUDataset's crop: the maps DINER reads
# the quad grid's corners, whose depth write_prediction maps and DINER reads
# as source views (data/dtu.py:SRC_CAM_IDCS, in its order), and the target
# DINER renders from them
MVS_SOURCE_CAMS = (30, 10, 6, 35)
MVS_TARGET_CAM = 24
# fixture processes, each rendering every MVS_FIXTURE_JOBS-th camera
MVS_FIXTURE_JOBS = 8
MVS_TEST_HW = (864, 1152)  # scripts/mvs_test.py's --max_h / --max_w
MVS_TEST_VIEWS = 5         # and its --num_view
# the small card-vs-CPU forward; TransMVSNet needs H and W divisible by 32
MVS_SMALL_HW = (64, 96)
# the seeded model's cost regularisers' last convolutions are scaled by
# this, so the softmax over the hypotheses is not flat: at 48/32/8
# hypotheses stage 2 needs it for 90 % of its pixels to be decisive (with
# the tests' gain of 10, at 8/8/8 there, 34 % were in a CPU run)
MVS_PROB_GAIN = 100.0
# kernel C launches per depth map of the default TransMVSNet by views:
# 324 DCN taps plus 44 plane-sweep gathers per source view
MVS_C_PER_MAP = {4: 456, 5: 500}
# the share of the ground-truth pixels each fusion backend must keep (a CPU
# run of the same fixture and cameras kept 0.902 and 0.888)
MVS_GT_FUSED_SHARE = 0.8


def mvs_row_gathers_per_map(cfg, views):
    """Kernel C launches of one TransMVSNet forward: 4 corners for each of
    the 9 taps of its 9 DCN layers (3 heads of 3; all views in one batch),
    and per source view 4 corners for each plane-sweep chunk of each stage
    (``DepthNet._similarity``'s chunks)."""
    chunks = 0
    for nd in cfg.ndepths:
        c = min(nd, cfg.sweep_chunk)
        chunks += nd // c if nd % c == 0 else nd
    return 3 * 3 * 9 * 4 + 4 * chunks * (views - 1)


def seeded_transmvsnet(seed, prob_gain=MVS_PROB_GAIN, offset_std=0.2):
    """The default TransMVSNet (eval mode, on the CPU) drawn from
    ``seed``: the module init, then BN statistics and affines, the DCN
    offset/mask convolutions (weights N(0, ``offset_std``): at 0.2
    offsets of a few pixels, masks away from 0.5) and the cost
    regularisers' last convolutions × ``prob_gain``."""
    from diner_tpu_torch.mvs.blocks import BatchNorm
    from diner_tpu_torch.mvs.model import TransMVSNet, TransMVSNetConfig
    torch.manual_seed(seed)
    model = TransMVSNet(TransMVSNetConfig())
    g = torch.Generator().manual_seed(seed + 1)

    def draw(t, scale, shift=0.0, uniform=False):
        r = (torch.rand if uniform else torch.randn)(t.shape, generator=g)
        t.copy_(shift + scale * r)

    with torch.no_grad():
        for name, m in model.named_modules():
            if isinstance(m, (torch.nn.modules.batchnorm._BatchNorm,
                              BatchNorm)):
                draw(m.running_mean, 0.1)
                draw(m.running_var, 1.0, 0.5, uniform=True)
                draw(m.weight, 0.1, 1.0)
                draw(m.bias, 0.1)
            elif name.endswith("conv_offset_mask"):
                draw(m.weight, offset_std)
                draw(m.bias, 0.2)
            elif name.endswith(".prob"):
                m.weight.mul_(prob_gain)
    return model.eval()


def mvs_depth_bounds(cfg, depth_values):
    """The depths the cascade can reach from these global hypotheses:
    stage 1 samples [first, last]; each later stage adds ndepth / 2 of its
    intervals (ratio × (last − first) / D) on either side."""
    lo, hi = float(depth_values[0]), float(depth_values[-1])
    interval = (hi - lo) / len(depth_values)
    ext = sum(nd / 2 * r * interval for nd, r in
              zip(cfg.ndepths[1:], cfg.depth_intervals_ratio[1:]))
    return lo - ext, hi + ext


def spy_run_model(records):
    """Wrap ``mvs/predict.py:run_model``, which both MVS CLIs call once
    per depth map, to append per call: its end time, forward seconds,
    kernel A, B and C launches, the sample's name and hypotheses and the
    depth map on the host. Returns the function that restores it."""
    from diner_tpu_torch.mvs import predict
    run = predict.run_model

    def spied(model, sample, device):
        before = read_counts()
        t0 = time.perf_counter()
        out = run(model, sample, device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        records.append(dict(
            end=t1, forward_s=t1 - t0,
            launches=tuple(a - b for a, b in zip(read_counts(), before)),
            name=sample.get("dpath") or sample.get("filename"),
            depth_values=np.asarray(sample["depth_values"]),
            depth=out["depth"][0].float().cpu()))
        return out

    predict.run_model = spied
    return lambda: setattr(predict, "run_model", run)


def reset_counts():
    from diner_tpu_torch.ops import (composite_cuda, dcn_cuda, gather_cuda,
                                     knn_cuda, rasterize_cuda)
    composite_cuda.launches = composite_cuda.bwd_launches = 0
    gather_cuda.launches = dcn_cuda.launches = knn_cuda.launches = 0
    rasterize_cuda.launches = 0


def read_counts():
    """Launches of kernels A, B, C, the DCN sampler's backward, the top-1
    kNN and kernel R (the mesh z-buffer: its setup and raster kernels, two
    launches a call)."""
    from diner_tpu_torch.ops import (composite_cuda, dcn_cuda, gather_cuda,
                                     knn_cuda, rasterize_cuda)
    return (composite_cuda.launches, composite_cuda.bwd_launches,
            gather_cuda.launches, dcn_cuda.launches, knn_cuda.launches,
            rasterize_cuda.launches)


def map_times(t0, records):
    """Time to the first depth map from ``t0`` and the warm seconds per
    map (between consecutive maps' ends: model and data I/O)."""
    ends = [r["end"] for r in records]
    warm = [b - a for a, b in zip(ends, ends[1:])]
    return dict(maps=len(records), time_to_first_map_s=ends[0] - t0,
                s_per_map_warm=statistics.median(warm) if warm else None,
                s_per_map_warm_all=warm,
                forward_s=[r["forward_s"] for r in records])


def phase_mvs_fixture():
    """``python -m diner_tpu_torch.data.dtu_fixture`` writes one scan (the
    7 lights as links to one render) of all 49 cameras (the pipeline's
    DINER stage takes any of them as its target; TransMVSNet's training
    reads the 34 of its quad grid): 49 cam files, 1200×1600 renders and
    ground-truth depths, in ``MVS_FIXTURE_JOBS`` processes that each render
    a share of the cameras."""
    shutil.rmtree(MVS_DIR, ignore_errors=True)
    cams = list(range(49))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "diner_tpu_torch.data.dtu_fixture",
         str(MVS_FIXTURE), "--cams", ",".join(map(str, part))], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for part in (cams[j::MVS_FIXTURE_JOBS]
                     for j in range(MVS_FIXTURE_JOBS))]
    for proc in procs:
        _, err = proc.communicate(timeout=900)
        check(proc.returncode == 0, f"dtu_fixture exited {proc.returncode}: "
              f"{err[-2000:]}")
    seconds = time.perf_counter() - t0
    n_cams = len(list((MVS_FIXTURE / "Cameras/train").glob("*_cam.txt")))
    n_rect = len(list((MVS_FIXTURE / "Rectified/scan1_train").glob(
        "rect_*_r5000.png")))
    n_pfm = len(list((MVS_FIXTURE / "Depths/scan1").glob("depth_map_*.pfm")))
    emit("mvs_fixture", seconds=seconds, cams=cams, processes=MVS_FIXTURE_JOBS,
         cam_files=n_cams, renders=n_rect, depth_maps=n_pfm)
    check(n_cams == 49 and n_rect == 7 * len(cams) and n_pfm == len(cams),
          f"fixture: {n_cams} cam files, {n_rect} renders, {n_pfm} depths")


def phase_mvs_write_prediction(smi):
    """``python -m diner_tpu_torch.mvs --mode write_prediction`` (``main``
    in this process) at full width: the default TransMVSNet (ndepths
    48/32/8, 192 hypotheses, f32) from a seeded checkpoint in the
    reference trainer's schema (``{"model": …}``, DDP ``module.`` keys)
    maps the fixture's 4 quad-grid targets at 512×640 from 4 views.
    Checks: the loaded weights are the checkpoint's bit for bit; 3 PNGs per
    target; each depth map finite, inside the cascade's reach of its
    hypotheses, and its PNG within one unit of it; kernel C
    ``MVS_C_PER_MAP[4]`` times per map, A and B never."""
    from diner_tpu_torch.data.io import DEPTH_PNG_SCALE, read_depth_png
    from diner_tpu_torch.mvs import __main__ as mvs_cli
    from diner_tpu_torch.mvs import predict
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    cfg = TransMVSNetConfig()
    per_map = MVS_C_PER_MAP[4]
    check(mvs_row_gathers_per_map(cfg, 4) == per_map,
          f"derived kernel C launches {mvs_row_gathers_per_map(cfg, 4)}")
    weights = seeded_transmvsnet(0).state_dict()
    ckpt = MVS_DIR / "TransMVSNet.ckpt"
    torch.save({"model": {"module." + k: v for k, v in weights.items()},
                "epoch": 15}, ckpt)

    models, records = [], []
    create = predict.create_model

    def spied_create(*args, **kwargs):
        models.append(create(*args, **kwargs))
        return models[-1]

    predict.create_model = spied_create
    restore = spy_run_model(records)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t0 = time.perf_counter()
        written = mvs_cli.main([
            "--mode", "write_prediction", "--trainpath", str(MVS_FIXTURE),
            "--trainlist", str(MVS_FIXTURE / "list.txt"), "--ckpt",
            str(ckpt), "--device", "cuda"])
        t_cli = time.perf_counter() - t0
    finally:
        predict.create_model = create
        restore()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    loaded = models[0].state_dict()
    same = sorted(loaded) == sorted(weights) and all(
        torch.equal(loaded[k].cpu(), weights[k]) for k in weights)

    maps = []
    for r in records:
        stem = MVS_FIXTURE / r["name"][:-len(".pfm")]
        d = r["depth"].numpy()
        lo, hi = mvs_depth_bounds(cfg, r["depth_values"])
        png = (read_depth_png(f"{stem}_TransMVSNet.png")
               * predict.DTU_DEPTH_UNSCALE)
        maps.append(dict(
            name=r["name"], shape=list(d.shape),
            finite=bool(np.isfinite(d).all()), depth_min=float(d.min()),
            depth_max=float(d.max()), reach=[lo, hi],
            share_in_global_range=float(
                ((d >= r["depth_values"][0])
                 & (d <= r["depth_values"][-1])).mean()),
            png_max_abs_err=float(np.abs(png - d).max()),
            pngs=[Path(f"{stem}_TransMVSNet{x}.png").exists()
                  for x in ("", "_conf", "_vis")]))
    emit("mvs_write_prediction", config="TransMVSNet default (ndepths "
         "48/32/8, ratios 4/2/1, FMT 8 layers, base_channels 8, f32), DTU "
         "fixture 512×640, 4 views", nvidia_smi=smi, cli_s=t_cli,
         **map_times(t0, records), peak_mem_bytes=peak, launches=launches,
         launches_per_map=[r["launches"] for r in records],
         loaded_bit_for_bit=same, written=len(written), depth_maps=maps)
    check(same, "the loaded TransMVSNet weights are not the checkpoint's")
    check(len(written) == 4 and len(records) == 4, f"{len(written)} maps")
    check(all(r["launches"] == (0, 0, per_map, 0, 0, 0) for r in records)
          and launches == (0, 0, 4 * per_map, 0, 0, 0),
          f"launches per map {[r['launches'] for r in records]}, expected "
          f"(0, 0, {per_map}, 0, 0, 0)")
    lsb = DEPTH_PNG_SCALE * predict.DTU_DEPTH_UNSCALE
    for m in maps:
        check(m["shape"] == list(MVS_WRITE_HW) and m["finite"]
              and m["reach"][0] <= m["depth_min"]
              and m["depth_max"] <= m["reach"][1], f"depth map {m}")
        check(m["pngs"] == [True] * 3 and m["png_max_abs_err"] <= 1.001 * lsb,
              f"PNGs of {m}")
    return dict(launches=launches, records=records, model=models[0])


def capture_mvs_gathers(model, sample, base_channels):
    """{kind: (table, idx)} of the first row gather of each kind in one
    TransMVSNet forward: the plane sweep's at stages 1, 2 and 3 (rows of
    4, 2 and 1 × ``base_channels`` f32) and a DCN tap at full resolution
    (stage 3's head)."""
    from diner_tpu_torch.mvs import dcn, predict
    from diner_tpu_torch.ops import gather_cuda, grid_sample
    V, H, W = sample["imgs"].shape[:3]
    bc = base_channels
    sweep = {4 * bc: "sweep_stage1", 2 * bc: "sweep_stage2",
             bc: "sweep_stage3"}
    found = {}

    def spy(kind_of):
        def gather(table, idx):
            kind = kind_of(table)
            if kind is not None and kind not in found:
                found[kind] = (table, idx)
            return gather_cuda.row_gather(table, idx)
        return gather

    saved = grid_sample.row_gather, dcn.row_gather
    grid_sample.row_gather = spy(lambda t: sweep.get(t.shape[1]))
    dcn.row_gather = spy(lambda t: "dcn_stage3" if t.shape[0] == V * H * W
                         else None)
    try:
        predict.run_model(model, sample, "cuda")
    finally:
        grid_sample.row_gather, dcn.row_gather = saved
    return found


def phase_gather_mvs(model):
    """Kernel C at the indices a real 512×640 depth map hands it: one
    plane-sweep chunk of each stage (rows of 128, 64 and 32 B) and one
    stage-3 DCN tap (128 B), warm and with L2 flushed, beside
    ``index_select``; each must equal it exactly. Before that, one warm
    forward of that map under the profiler (``mvs_profile``)."""
    from diner_tpu_torch.mvs import predict
    from diner_tpu_torch.mvs.datasets import MVSDTUDataset
    from diner_tpu_torch.ops import gather_cuda
    sample = MVSDTUDataset(MVS_FIXTURE, MVS_FIXTURE / "list.txt", "val")[0]
    profile_once("mvs_profile",
                 lambda: predict.run_model(model, sample, "cuda"))
    found = capture_mvs_gathers(model, sample, model.cfg.base_channels)
    check(sorted(found) == ["dcn_stage3", "sweep_stage1", "sweep_stage2",
                            "sweep_stage3"], f"captured {sorted(found)}")
    rows = []
    with torch.no_grad():
        for kind, (table, idx) in sorted(found.items()):
            size = table.element_size()
            regime, unit = gather_cuda.plan(table.shape[1] * size,
                                            table.stride(0) * size,
                                            table.data_ptr(), 0)
            row = dict(case=f"mvs_{kind}_c{table.shape[1]}_f32", kind=kind,
                       regime=regime, unit_bytes=unit,
                       **gather_row(table, idx, runs=20, cold=True))
            emit("gather_mvs", **row)
            check(row["exact"], f"row gather kernel vs plain {row}")
            rows.append(row)
    del found
    torch.cuda.empty_cache()
    return rows


def write_test_scan(root, cams):
    """The fixture's renders (light 3) of ``cams`` as a test-layout scan:
    ``images/<id>.jpg``, ``cams/<id>_cam.txt`` (the renders' 1200×1600
    intrinsics, which the test set divides by 4, and the depth line
    ``425.0 2.5``) and ``pair.txt`` with every other view as a source."""
    from PIL import Image

    from diner_tpu_torch.data.dtu_fixture import (fixture_intrinsics,
                                                  make_camera)
    _, K = fixture_intrinsics()
    scan = root / "scan1"
    (scan / "images").mkdir(parents=True)
    (scan / "cams").mkdir()
    for vid in cams:
        Image.open(MVS_FIXTURE / "Rectified" / "scan1_train" /
                   f"rect_{vid + 1:03d}_3_r5000.png").convert("RGB").save(
            scan / "images" / f"{vid:08d}.jpg", quality=95)
        lines = ["extrinsic"]
        lines += [" ".join(f"{x:.6f}" for x in row)
                  for row in make_camera(vid)]
        lines += ["", "intrinsic"]
        lines += [" ".join(f"{x:.6f}" for x in row) for row in K]
        lines += ["", "425.0 2.5"]
        (scan / "cams" / f"{vid:08d}_cam.txt").write_text(
            "\n".join(lines) + "\n")
    lines = [str(len(cams))]
    for ref in cams:
        srcs = [s for s in cams if s != ref]
        lines += [str(ref), " ".join([str(len(srcs))]
                                     + [f"{s} {100.0 - abs(s - ref)}"
                                        for s in srcs])]
    (scan / "pair.txt").write_text("\n".join(lines) + "\n")


def fuse_ground_truth(cams):
    """The fixture's ground-truth depths of ``cams`` (consistent by
    construction) with confidence 1 and the cameras of
    ``write_test_scan``'s cam files (the ones the fusion CLI reads), every
    other view a source, fused by the reprojection-consistency backend and
    by the C++ library at ``scripts/mvs_test.py``'s defaults (conf 0.9, 3
    consistent views) → each backend's points, share of the pixels and
    seconds, and the PLY the library's points were written to
    (``gipuma_ply``, which ``pipeline`` holds the fusion CLI's against)."""
    from diner_tpu_torch.data.dtu import read_cam_file
    from diner_tpu_torch.data.io import read_pfm, read_rgb
    from diner_tpu_torch.fusion.consistency import filter_and_fuse
    from diner_tpu_torch.fusion.fusion import (fake_normals, fuse_depth_maps,
                                               write_ply)
    cam_files = [read_cam_file(MVS_DIR / "test" / "scan1" / "cams" /
                               f"{c:08d}_cam.txt") for c in cams]
    K, Es = cam_files[0][0], [E for _, E, _ in cam_files]
    depths = [np.asarray(read_pfm(MVS_FIXTURE / "Depths" / "scan1" /
                                  f"depth_map_{c:04d}.pfm")[0], np.float32)
              for c in cams]
    images = [read_rgb(MVS_FIXTURE / "Rectified" / "scan1_train" /
                       f"rect_{c + 1:03d}_3_r5000.png")[..., :3]
              for c in cams]
    n = len(cams)
    pairs = [(i, [j for j in range(n) if j != i]) for i in range(n)]
    pixels = sum(d.size for d in depths)
    t0 = time.perf_counter()
    pts, _, _ = filter_and_fuse(depths, [np.ones_like(d) for d in depths],
                                [K] * n, Es, pairs, images=images,
                                conf_thresh=0.9, thres_view=3)
    t1 = time.perf_counter()
    P = np.stack([(K @ E[:3]).astype(np.float32) for E in Es])
    fused = fuse_depth_maps(np.stack(depths),
                            np.stack([fake_normals(d) for d in depths]), P,
                            np.full(n, K[0, 0], np.float32),
                            np.stack(images), num_consistent=3)
    t2 = time.perf_counter()
    ply = MVS_DIR / "ground_truth_gipuma.ply"
    write_ply(ply, fused)
    return dict(pixels=pixels, normal_points=len(pts),
                normal_share=len(pts) / pixels, normal_s=t1 - t0,
                gipuma_points=len(fused), gipuma_share=len(fused) / pixels,
                gipuma_s=t2 - t1, gipuma_ply=str(ply.relative_to(ROOT)))


def phase_mvs_test(smi):
    """``python -m diner_tpu_torch.mvs.evaluate`` (``main`` in this
    process) on a test-layout scan of the fixture's 5 views at the
    script's defaults (864×1152, 5 views, the checkpoint of
    ``mvs_write_prediction``), fused with ``--filter_method normal`` and
    then ``gipuma`` (a second run). Checks: kernel C
    ``MVS_C_PER_MAP[5]`` times per map; every PFM finite and 864×1152; a
    PLY that parses with the reported count. Then the fixture's
    ground-truth depths go through both backends, which must keep more than
    ``MVS_GT_FUSED_SHARE`` of the pixels: seeded weights give no
    consistent depth, so this shows fusion working on the card's host."""
    from diner_tpu_torch.data.io import read_pfm
    from diner_tpu_torch.fusion.fusion import read_ply
    from diner_tpu_torch.mvs import evaluate as mvs_evaluate
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    cams = sorted(MVS_SOURCE_CAMS + (MVS_TARGET_CAM,))
    check(len(cams) == MVS_TEST_VIEWS, f"{len(cams)} test views")
    per_map = MVS_C_PER_MAP[MVS_TEST_VIEWS]
    check(mvs_row_gathers_per_map(TransMVSNetConfig(), MVS_TEST_VIEWS)
          == per_map, "derived kernel C launches per test map")
    test_root = MVS_DIR / "test"
    write_test_scan(test_root, cams)
    runs = {}
    for method in ("normal", "gipuma"):
        out = MVS_DIR / f"test_{method}"
        records = []
        restore = spy_run_model(records)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        try:
            t0 = time.perf_counter()
            res = mvs_evaluate.main([
                "--testpath", str(test_root), "--testlist", "scan1",
                "--ckpt", str(MVS_DIR / "TransMVSNet.ckpt"), "--outdir",
                str(out), "--filter_method", method, "--max_h",
                str(MVS_TEST_HW[0]), "--max_w", str(MVS_TEST_HW[1]),
                "--num_view", str(MVS_TEST_VIEWS), "--device", "cuda"])
            t_cli = time.perf_counter() - t0
        finally:
            restore()
        launches = read_counts()
        pfms = sorted((out / "scan1").glob("*/*.pfm"))
        arrays = [read_pfm(p)[0] for p in pfms]
        names, floats, colors = read_ply(res["scan1"]["ply"])
        runs[method] = dict(
            **map_times(t0, records), cli_s=t_cli,
            fusion_s=t0 + t_cli - records[-1]["end"],
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            launches=launches,
            launches_per_map=[r["launches"] for r in records],
            pfms=len(pfms), pfms_finite=all(np.isfinite(a).all()
                                            for a in arrays),
            pfm_shapes=sorted({a.shape for a in arrays}),
            ply_properties=names, ply_colors=colors is not None,
            points=res["scan1"]["points"])
        check(len(records) == len(cams) and all(
            r["launches"] == (0, 0, per_map, 0, 0, 0) for r in records),
            f"{method}: launches per map {runs[method]['launches_per_map']}, "
            f"expected (0, 0, {per_map}, 0, 0, 0)")
        check(len(pfms) == 2 * len(cams) and runs[method]["pfms_finite"]
              and runs[method]["pfm_shapes"] == [MVS_TEST_HW],
              f"{method}: PFMs {len(pfms)}, shapes "
              f"{runs[method]['pfm_shapes']}")
        check(len(floats) == runs[method]["points"],
              f"{method}: PLY of {len(floats)} vertices")
    gt = fuse_ground_truth(cams)
    emit("mvs_test", config="scripts/mvs_test.py defaults (864×1152, 5 "
         "views, TransMVSNet default, f32), fixture scan of 5 views",
         nvidia_smi=smi, runs=runs, ground_truth_fusion=gt)
    check(gt["normal_share"] > MVS_GT_FUSED_SHARE
          and gt["gipuma_share"] > MVS_GT_FUSED_SHARE,
          f"ground-truth fusion kept {gt['normal_share']} / "
          f"{gt['gipuma_share']} of the pixels")
    return {m: r["launches"] for m, r in runs.items()}, gt


def phase_mvs_small_reference():
    """The default TransMVSNet at ``MVS_SMALL_HW``, 3 views, on the card
    against the same model and inputs on the CPU (TF32 off): where both
    sides' hypotheses agree, probability volumes and confidences within
    1e-4, and the same winning bin at every pixel whose top two
    probabilities differ by more than 1e-4; the other pixels are counted.
    At least 90 % of each stage's pixels must be compared."""
    import copy
    H, W = MVS_SMALL_HW
    V = 3
    model = seeded_transmvsnet(2)
    g = torch.Generator().manual_seed(3)
    imgs = torch.rand((1, V, H, W, 3), generator=g)
    K = torch.tensor([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]])
    projs = {}
    for stage, scale in (("stage1", 4), ("stage2", 2), ("stage3", 1)):
        pm = torch.zeros(1, V, 2, 4, 4)
        for v in range(V):
            pm[0, v, 0] = torch.eye(4)
            pm[0, v, 0, 0, 3] = 0.1 * v
            pm[0, v, 1, :3, :3] = K
            pm[0, v, 1, :2] /= scale
        projs[stage] = pm
    dv = torch.linspace(2.0, 6.0, 192)[None]
    with torch.no_grad():
        ref = model(imgs, projs, dv)
        gpu = copy.deepcopy(model).cuda()
        got = gpu(imgs.cuda(), {k: p.cuda() for k, p in projs.items()},
                  dv.cuda())
    stages, ok = {}, True
    for stage in ("stage1", "stage2", "stage3"):
        r = {k: ref[stage][k].numpy() for k in ref[stage]}
        c = {k: got[stage][k].cpu().numpy() for k in got[stage]}
        tol = 1e-5 * float(np.abs(r["depth_values"]).max())
        same = np.all(np.abs(c["depth_values"] - r["depth_values"]) <= tol,
                      axis=1)
        top = np.sort(r["prob_volume"], axis=1)
        decisive = top[:, -1] - top[:, -2] > 1e-4
        keep = same & decisive
        prob_err = float(np.abs(c["prob_volume"] - r["prob_volume"])
                         .max(axis=1)[same].max())
        conf_err = float(np.abs(c["photometric_confidence"]
                                - r["photometric_confidence"])[same].max())
        wta_differs = int((np.argmax(c["prob_volume"], 1)
                           != np.argmax(r["prob_volume"], 1))[keep].sum())
        depth_err = float(np.abs(c["depth"] - r["depth"])[keep].max())
        stages[stage] = dict(
            pixels=int(same.size), hypotheses_differ=int((~same).sum()),
            ties=int((same & ~decisive).sum()), compared=int(keep.sum()),
            prob_max_abs_err=prob_err, conf_max_abs_err=conf_err,
            wta_bin_differs=wta_differs, depth_max_abs_err=depth_err)
        ok &= (prob_err <= 1e-4 and conf_err <= 1e-4 and wta_differs == 0
               and depth_err <= tol and keep.mean() >= 0.9)
    emit("mvs_small_reference", hw=list(MVS_SMALL_HW), views=V,
         prob_tol=1e-4, tie_margin=1e-4, stages=stages)
    check(ok, f"TransMVSNet card vs CPU: {stages}")
    del gpu
    torch.cuda.empty_cache()


MVS_TRAIN_DIR = MVS_DIR / "train"
MVS_TRAIN_STEPS = 6      # the f32 run
MVS_TRAIN_BF16_STEPS = 2  # the bf16 run
MVS_TRAIN_AUTOGRAD_STEPS = 3  # DCN_CUSTOM_VJP = False
MVS_TRAIN_RESUME_STEPS = 2    # the second process, after the f32 run
MVS_TRAIN_TAG = "mvs_train_result="
# ``python -m diner_tpu_torch.mvs ARGS`` under ``counted_cli``, with the DCN
# sampler's gradient chosen by the first argument ("1": the Function, "0":
# autograd of the gathers), which the script takes off before main's
MVS_TRAIN_CLI = counted_cli(
    "diner_tpu_torch.mvs.__main__", MVS_TRAIN_TAG,
    setup="from diner_tpu_torch.mvs import dcn\n"
          "dcn.DCN_CUSTOM_VJP = sys.argv.pop(1) == '1'\n")


def mvs_train_launches(cfg, views, custom_vjp=True):
    """(kernel C, DCN backward) launches of one training step: the
    forward's gathers (``mvs_row_gathers_per_map``), again for what remat
    recomputes in the backward (FeatureNet's 324 with ``remat_feature``,
    the sweeps' per source view), and one DCN backward per tap with the
    Function. The gathers' own backward is ``index_add_``."""
    per = mvs_row_gathers_per_map(cfg, views)
    dcn_c = 3 * 3 * 9 * 4
    if cfg.remat:
        per += (per - dcn_c) + (dcn_c if cfg.remat_feature else 0)
    return per, DCN_BWD_PER_STEP if custom_vjp else 0


def run_mvs_train_cli(args, custom_vjp=True):
    """The MVS CLI in a subprocess (``MVS_TRAIN_CLI``, its standard error
    merged into its output) → its records, launches, peak, the seconds from
    its start to each step's line, its wall time and output."""
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", MVS_TRAIN_CLI, "1" if custom_vjp else "0",
         *map(str, args)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    step_t, lines, result = [], [], None
    for line in proc.stdout:
        lines.append(line.rstrip())
        if line.startswith("epoch "):
            step_t.append(time.perf_counter() - t0)
        elif line.startswith(MVS_TRAIN_TAG):
            result = json.loads(line[len(MVS_TRAIN_TAG):])
    proc.wait(timeout=60)
    wall = time.perf_counter() - t0
    check(proc.returncode == 0 and result is not None,
          f"MVS CLI {args} exited {proc.returncode}: "
          + "\n".join(lines[-40:]))
    return dict(result, step_seconds_from_start=step_t, wall_s=wall,
                out=lines)


def phase_mvs_train(smi):
    """TransMVSNet training through ``python -m diner_tpu_torch.mvs --mode
    train`` (subprocesses, ``MVS_TRAIN_CLI``) at the CLI's defaults
    (``scripts/mvs_train.py``'s: 512×640, 4 views, base_channels 8,
    ndepths 48/32/8, ratios 4/2/1, 192 hypotheses, batch 1) on the
    fixture's scan: f32 for ``MVS_TRAIN_STEPS``, bf16 for
    ``MVS_TRAIN_BF16_STEPS``, autograd of the DCN gathers for
    ``MVS_TRAIN_AUTOGRAD_STEPS``, ``--remat`` full and selective one step
    each; a second process resumes the f32 run for
    ``MVS_TRAIN_RESUME_STEPS``; ``--mode write_prediction --ckpt`` the f32
    run's checkpoint (in this process); ``--mode profile`` (in this
    process) and one warm step under the profiler. Checks: every loss
    finite, no step skipped, the step counts, kernel C and the DCN
    backward's launches per step (``mvs_train_launches``), each process's
    peak within ``MEMORY_SHARE_LIMIT`` of the card, the resume from step
    ``MVS_TRAIN_STEPS``, 4 finite maps, the trace file."""
    from diner_tpu_torch.mvs import __main__ as mvs_cli
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    shutil.rmtree(MVS_TRAIN_DIR, ignore_errors=True)
    base = ["--mode", "train", "--trainpath", str(MVS_FIXTURE),
            "--trainlist", str(MVS_FIXTURE / "list.txt"), "--device", "cuda"]
    total_mem = torch.cuda.get_device_properties(0).total_memory
    mem_limit = int(MEMORY_SHARE_LIMIT * total_mem)
    views = 4
    runs = {}
    plan = [
        ("f32", MVS_TRAIN_STEPS, [], True, TransMVSNetConfig()),
        ("bf16", MVS_TRAIN_BF16_STEPS, ["--dtype", "bfloat16"], True,
         TransMVSNetConfig()),
        ("autograd_dcn", MVS_TRAIN_AUTOGRAD_STEPS, [], False,
         TransMVSNetConfig()),
        ("remat_full", 1, ["--remat"], True, TransMVSNetConfig(remat=True)),
        ("remat_selective", 1, ["--remat", "--remat-mode", "selective"], True,
         TransMVSNetConfig(remat=True, remat_feature=False)),
    ]
    torch.cuda.empty_cache()
    for name, steps, extra, custom, cfg in plan:
        logdir = MVS_TRAIN_DIR / name
        r = run_mvs_train_cli([*base, "--logdir", logdir, "--max-steps",
                               steps, *extra], custom_vjp=custom)
        recs = r["records"]
        per_c, per_d = mvs_train_launches(cfg, views, custom)
        s = [x["s"] for x in recs]
        runs[name] = dict(
            steps=len(recs), losses=[x["loss"] for x in recs],
            depth_losses=[x["depth_loss"] for x in recs],
            skipped=sum(x["skipped"] for x in recs), s_per_step=s,
            s_per_step_warm=statistics.median(s[1:]) if len(s) > 1 else None,
            time_to_first_step_s=r["step_seconds_from_start"][0],
            wall_s=r["wall_s"], peak_mem_bytes=r["peak"],
            launches=r["launches"],
            expected_launches_per_step=[0, 0, per_c, per_d, 0, 0])
        check(len(recs) == steps and [x["step"] for x in recs]
              == list(range(1, steps + 1)), f"{name}: steps {recs}")
        check(all(np.isfinite(x["loss"]) for x in recs)
              and runs[name]["skipped"] == 0, f"{name}: {runs[name]}")
        expected = [0, 0, per_c * steps, per_d * steps, 0, 0]
        check(r["launches"] == expected,
              f"{name}: kernel A, B, C, DCN backward and kNN launches "
              f"{r['launches']}, expected {expected}")
        check(r["peak"] <= mem_limit, f"{name}: peak {r['peak']} B over "
              f"{MEMORY_SHARE_LIMIT} of {total_mem} B")

    f32_dir = MVS_TRAIN_DIR / "f32"
    r = run_mvs_train_cli([*base, "--logdir", f32_dir, "--max-steps",
                           MVS_TRAIN_STEPS + MVS_TRAIN_RESUME_STEPS])
    recs = r["records"]
    runs["resume"] = dict(
        steps=[x["step"] for x in recs], losses=[x["loss"] for x in recs],
        s_per_step=[x["s"] for x in recs], wall_s=r["wall_s"],
        peak_mem_bytes=r["peak"], launches=r["launches"],
        resumed_line=next((ln for ln in r["out"]
                           if ln.startswith("resumed from")), None))
    check([x["step"] for x in recs] == list(range(
        MVS_TRAIN_STEPS + 1, MVS_TRAIN_STEPS + MVS_TRAIN_RESUME_STEPS + 1))
        and all(np.isfinite(x["loss"]) and x["skipped"] == 0 for x in recs)
        and runs["resume"]["resumed_line"] is not None,
        f"resume: {runs['resume']}")
    per = runs["f32"]["expected_launches_per_step"]
    check(r["launches"] == [n * MVS_TRAIN_RESUME_STEPS for n in per],
          f"resume: kernel A, B, C, DCN backward and kNN launches "
          f"{r['launches']}, expected {per} a step")

    ckpt = f32_dir / "checkpoints" / \
        f"step_{MVS_TRAIN_STEPS + MVS_TRAIN_RESUME_STEPS:08d}"
    records = []
    restore = spy_run_model(records)
    reset_counts()
    try:
        t0 = time.perf_counter()
        written = mvs_cli.main([
            "--mode", "write_prediction", "--trainpath", str(MVS_FIXTURE),
            "--trainlist", str(MVS_FIXTURE / "list.txt"), "--ckpt",
            str(ckpt), "--outpath", str(MVS_TRAIN_DIR / "pred"),
            "--device", "cuda"])
        t_wp = time.perf_counter() - t0
    finally:
        restore()
    wp_launches = read_counts()
    maps_finite = [bool(np.isfinite(x["depth"].numpy()).all())
                   for x in records]
    runs["write_prediction"] = dict(
        ckpt=str(ckpt.relative_to(ROOT)), maps=len(written), cli_s=t_wp,
        launches=wp_launches, finite=maps_finite)
    check(len(written) == 4 and all(maps_finite)
          and wp_launches == (0, 0, 4 * MVS_C_PER_MAP[views], 0, 0, 0),
          f"write_prediction from the trained checkpoint: "
          f"{runs['write_prediction']}")

    prof_dir = MVS_TRAIN_DIR / "profile"
    t0 = time.perf_counter()
    mvs_cli.main([*base[2:], "--mode", "profile", "--logdir",
                  str(prof_dir)])
    trace_file = prof_dir / "trace" / "trace.json"
    runs["profile_cli"] = dict(seconds=time.perf_counter() - t0,
                               trace_bytes=trace_file.stat().st_size
                               if trace_file.exists() else 0)
    check(runs["profile_cli"]["trace_bytes"] > 0, "no profiler trace")
    emit("mvs_train", config="TransMVSNet default (base_channels 8, ndepths "
         "48/32/8, ratios 4/2/1, 192 hypotheses), DTU fixture 512×640, 4 "
         "views, batch 1, Adam lr 1e-3 with warmup", nvidia_smi=smi,
         memory_limit_bytes=mem_limit, runs=runs)
    mvs_train_profile()
    return {"mvs_train_f32": tuple(runs["f32"]["launches"]),
            "mvs_train_bf16": tuple(runs["bf16"]["launches"])}


def mvs_train_profile():
    """One warm f32 training step at the CLI's defaults under the profiler
    (``mvs_train_profile``: the device's idle share, the top ops and each
    port kernel's device time and launches, the DCN backward's
    ``DCN_BWD_PER_STEP``), then 3 more steps timed between CUDA events
    (``utils/profiling.py:time_fn``, TF32 off: ``mvs_train_step``)."""
    from diner_tpu_torch.mvs.datasets import MVSDTUDataset
    from diner_tpu_torch.mvs.train import (MVSTrainConfig, batch_to_device,
                                           create_mvs_state,
                                           make_mvs_train_step)
    from diner_tpu_torch.data.loader import collate
    ds = MVSDTUDataset(MVS_FIXTURE, MVS_FIXTURE / "list.txt", "train")
    batch = batch_to_device(collate([ds[0]]), "cuda")
    cfg = MVSTrainConfig()
    state = create_mvs_state(cfg, seed=0, device="cuda")
    step = make_mvs_train_step(state, cfg)
    step(batch)
    port = profile_once("mvs_train_profile", lambda: step(batch))
    check(port["dcn_sample_bwd"]["launches"] == DCN_BWD_PER_STEP,
          f"mvs_train_profile: DCN backward launches "
          f"{port['dcn_sample_bwd']}, expected {DCN_BWD_PER_STEP}")
    timed = time_fn(step, batch, warmup=0, iters=3)
    emit("mvs_train_step", **timed)
    check(state.step == 5, f"in-process train steps: {state.step}")
    del state, step
    torch.cuda.empty_cache()


def mvs_small_batch(H, W, V, seed):
    """A batch of 1 at H×W with V views (cameras 0.1 apart in x), 192
    hypotheses 2..6 and random ground truth inside them."""
    g = torch.Generator().manual_seed(seed)
    K = torch.tensor([[0.8 * W, 0, W / 2], [0, 0.8 * W, H / 2], [0, 0, 1]])
    projs, depth, mask = {}, {}, {}
    for stage, scale in (("stage1", 4), ("stage2", 2), ("stage3", 1)):
        pm = torch.zeros(1, V, 2, 4, 4)
        for v in range(V):
            pm[0, v, 0] = torch.eye(4)
            pm[0, v, 0, 0, 3] = 0.1 * v
            pm[0, v, 1, :3, :3] = K
            pm[0, v, 1, :2] /= scale
        projs[stage] = pm
        h, w = H // scale, W // scale
        depth[stage] = 3.0 + 2.0 * torch.rand((1, h, w), generator=g)
        mask[stage] = (torch.rand((1, h, w), generator=g) > 0.1).float()
    return {"imgs": torch.rand((1, V, H, W, 3), generator=g),
            "proj_matrices": projs, "depth_values":
            torch.linspace(2.0, 6.0, 192)[None], "depth": depth,
            "mask": mask}


def to_device(tree, device):
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


# PixelwiseNet's max over the depth planes routes each pixel's gradient to
# one plane, picked by rounding where two nearly tie: 2e-2 of the norm
MVS_PWN = "DepthNet.pixel_wise_net."
# the biases of FeatureNet's DCN layers that a train-mode BN follows: BN
# subtracts the batch mean, so their gradient is 0 but for rounding, and
# its error is taken over the norm of the same layer's weight gradient
MVS_BIAS_BEFORE_BN = re.compile(r"feature\.out[123]\.[14]\.bias$")
# the draw whose train-mode step is well conditioned at MVS_SMALL_HW:
# probability gain 1 and DCN offsets of a fraction of a pixel. With the
# seeded draw's gain 100 and offsets of a few pixels, a 1e-7 relative
# change of the images moves train-mode gradients by 3-8e-2 of a norm on
# the CPU alone, with this one by 5e-3 (lab/mvs_train_conditioning.py)
MVS_CONDITIONED_DRAW = dict(prob_gain=1.0, offset_std=0.02)
# card against CPU, train mode, the conditioned draw: each gradient's
# error over its norm, PixelwiseNet's too. An H100 read 2.5e-3 (5.7e-3
# without cuDNN); the CPU alone moves 4.9e-3 under a 1e-7 change of the
# images and 2.2e-2 under 1e-6
MVS_TRAIN_GRAD_RTOL = 1e-2


def mvs_small_model(**draw):
    """``seeded_transmvsnet(4, **draw)`` at ndepths 8/8/8 (CPU)."""
    from diner_tpu_torch.mvs.model import TransMVSNet, TransMVSNetConfig
    model = TransMVSNet(TransMVSNetConfig(ndepths=(8, 8, 8)))
    model.load_state_dict(seeded_transmvsnet(4, **draw).state_dict())
    return model


def mvs_small_step(model, batch, device, train, eps=0.0, noise_seed=0):
    """One forward and backward of a copy of ``model`` on ``device``, BN
    in train mode or on its running statistics, the images times (1 +
    ``eps``·N(0, 1)) where ``eps``: the loss, the launches, the gradients,
    the BN running statistics after, each stage's probability volume and
    the winning bins of stages 1 and 2 (on the host)."""
    import copy

    from diner_tpu_torch.mvs.loss import trans_mvsnet_loss
    m = copy.deepcopy(model).to(device).train(train)
    b = to_device(batch, device)
    imgs = b["imgs"]
    if eps:
        g = torch.Generator().manual_seed(noise_seed)
        imgs = imgs * (1 + eps * torch.randn(imgs.shape, generator=g)
                       .to(device))
    reset_counts()
    out = m(imgs, b["proj_matrices"], b["depth_values"])
    total = trans_mvsnet_loss(out, b["depth"], b["mask"], (0.5, 1.0, 2.0))[0]
    total.backward()
    if device == "cuda":
        torch.cuda.synchronize()
    return dict(
        loss=float(total.detach()), launches=read_counts(),
        grads={n: p.grad.detach().cpu() for n, p in m.named_parameters()},
        stats={n: v.detach().cpu() for n, v in m.state_dict().items()
               if "running" in n},
        prob={st: out[st]["prob_volume"].detach().cpu()
              for st in ("stage1", "stage2", "stage3")},
        wta={st: out[st]["prob_volume"].argmax(1).cpu()
             for st in ("stage1", "stage2")})


def mvs_step_errors(ref, got, train):
    """How far ``got`` is from ``ref`` (both ``mvs_small_step``'s): the
    loss, the largest gradient error over its norm outside PixelwiseNet
    (with its parameter; in ``train`` mode the biases before a BN over
    their weight's), PixelwiseNet's, the BN statistics, the probabilities
    and the winning bins that differ."""
    errs = {}
    for n, g in ref["grads"].items():
        norm = (ref["grads"][n[:-len("bias")] + "weight"]
                if train and MVS_BIAS_BEFORE_BN.search(n) else g).norm()
        errs[n] = float((got["grads"][n] - g).norm() / norm.clamp_min(1e-30))
    pwn = {n: e for n, e in errs.items() if n.startswith(MVS_PWN)}
    rest = {n: e for n, e in errs.items() if n not in pwn}
    worst = max(rest, key=rest.get)
    return dict(
        loss_ref=ref["loss"], loss=got["loss"],
        loss_rel_err=abs(got["loss"] - ref["loss"]) / abs(ref["loss"]),
        grad_max_err_over_norm=rest[worst], worst_param=worst,
        pixel_wise_net_grad_max_err_over_norm=max(pwn.values()),
        bn_stats_max_abs_err=max(float((got["stats"][n] - v).abs().max())
                                 for n, v in ref["stats"].items()),
        prob_max_abs_diff={st: float((got["prob"][st] - p).abs().max())
                           for st, p in ref["prob"].items()},
        wta_bins_differ={st: int((got["wta"][st] != w).sum())
                         for st, w in ref["wta"].items()})


def phase_mvs_train_small_reference():
    """One training step's forward and backward at ``MVS_SMALL_HW``, 3
    views, ndepths 8/8/8 on the card (kernel C and the DCN backward
    kernel) against the same on the CPU (their plain versions), from the
    same seeded weights and batch, three times:

    - in train mode (batch statistics, the step's own), the seeded draw
      (``seeded_transmvsnet``): the loss within 1e-4 relative, the BN
      running statistics within 1e-4, the winning bins of stages 1 and 2
      (which set the next stage's hypotheses) the same; its gradients are
      reported, not held: its large DCN offsets and prob gain make the
      train-mode step chaotic at this size (``MVS_CONDITIONED_DRAW``);
    - in train mode, the conditioned draw (``MVS_CONDITIONED_DRAW``): the
      same, and every gradient within ``MVS_TRAIN_GRAD_RTOL`` of its norm,
      PixelwiseNet's too;
    - with the running statistics (eval-mode BN), the seeded draw: every
      gradient within 1e-3 of its norm (PixelwiseNet's 2e-2: its max over
      the depth planes routes each pixel's gradient to one plane, picked by
      rounding where two nearly tie), the loss within 1e-4.
    """
    H, W = MVS_SMALL_HW
    batch = mvs_small_batch(H, W, 3, seed=5)
    seeded, conditioned = mvs_small_model(), mvs_small_model(
        **MVS_CONDITIONED_DRAW)
    rows = {}
    for mode, model, train in (("train", seeded, True),
                               ("train_conditioned", conditioned, True),
                               ("running_stats", seeded, False)):
        ref = mvs_small_step(model, batch, "cpu", train)
        got = mvs_small_step(model, batch, "cuda", train)
        rows[mode] = dict(mvs_step_errors(ref, got, train),
                          launches_card=got["launches"],
                          launches_cpu=ref["launches"])
        check(got["launches"][2] > 0 and got["launches"][3] == DCN_BWD_PER_STEP
              and ref["launches"] == (0, 0, 0, 0, 0, 0),
              f"{mode}: launches card {got['launches']}, cpu "
              f"{ref['launches']}")
    emit("mvs_train_small_reference", hw=list(MVS_SMALL_HW), views=3,
         ndepths=[8, 8, 8], conditioned_draw=MVS_CONDITIONED_DRAW,
         train_grad_rtol=MVS_TRAIN_GRAD_RTOL, **rows)
    for mode in ("train", "train_conditioned"):
        tr = rows[mode]
        check(not any(tr["wta_bins_differ"].values()),
              f"{mode}: winning bins differ between card and CPU: "
              f"{tr['wta_bins_differ']}")
        check(tr["loss_rel_err"] <= 1e-4
              and tr["bn_stats_max_abs_err"] <= 1e-4,
              f"{mode}: training step card vs CPU: loss "
              f"{tr['loss_rel_err']}, BN statistics "
              f"{tr['bn_stats_max_abs_err']}")
    tc, rs = rows["train_conditioned"], rows["running_stats"]
    check(tc["grad_max_err_over_norm"] <= MVS_TRAIN_GRAD_RTOL
          and tc["pixel_wise_net_grad_max_err_over_norm"]
          <= MVS_TRAIN_GRAD_RTOL,
          f"train-mode backward (conditioned draw), card vs CPU: {tc}")
    check(rs["loss_rel_err"] <= 1e-4 and rs["grad_max_err_over_norm"] <= 1e-3
          and rs["pixel_wise_net_grad_max_err_over_norm"] <= 2e-2,
          f"backward with running statistics, card vs CPU: {rs}")
    torch.cuda.empty_cache()


# ------------------------------------------------------------ the pipeline

PIPELINE_DIR = OUT_DIR / "pipeline"
PIPELINE_TAG = "pipeline_stage_result="
PIPELINE_LOSS_TAG = "pipeline_step_losses="
PIPELINE_INIT_TAG = "pipeline_init_launches="
# ``python -m diner_tpu_torch.pipeline``'s full recipe with only its depth
# cut: 3 MVS steps (of 30), 25 DINER steps (of 2000: the template logs a row
# every 25), one validation hook at the last step (2 views, one sweep of 2
# frames: of 100 views and 4 sweeps of 30), 1 image scored (of 3; 2 until
# PR 16)
PIPELINE_MVS_STEPS = 3
PIPELINE_DINER_STEPS = 25
PIPELINE_VAL_VIEWS, PIPELINE_SWEEPS, PIPELINE_SWEEP_FRAMES = 2, 1, 2
PIPELINE_EVAL_N = 1
PIPELINE_CUTS = [
    "--mvs-steps", PIPELINE_MVS_STEPS, "--diner-steps", PIPELINE_DINER_STEPS,
    "--val-interval", PIPELINE_DINER_STEPS, "--val-views",
    PIPELINE_VAL_VIEWS, "--n-sweeps", PIPELINE_SWEEPS, "--sweep-frames",
    PIPELINE_SWEEP_FRAMES, "--eval-n", PIPELINE_EVAL_N]
# the stages' setups under ``counted_cli``: write_prediction saves each
# depth map it writes as ``<stem>.npy`` in MAPS_DIR; DINER training and the
# prediction folder print, when they exit, the launches of each
# ``create_model`` (its probe of the init, redrawn while dead) and DINER
# training every step's loss
PIPELINE_SAVE_MAPS = (
    "import numpy as np\n"
    "from pathlib import Path\n"
    "from diner_tpu_torch.mvs import predict as _predict\n"
    "_run_model = _predict.run_model\n"
    "def _saving_run_model(model, sample, device):\n"
    "    out = _run_model(model, sample, device)\n"
    "    np.save(Path(MAPS_DIR) / (Path(sample['dpath']).stem + '.npy'),\n"
    "            out['depth'][0].float().cpu().numpy())\n"
    "    return out\n"
    "_predict.run_model = _saving_run_model\n")
PIPELINE_INIT_LAUNCHES = (
    "import atexit\n"
    "from diner_tpu_torch.train import diner as _diner, loop as _loop\n"
    "_inits, _create = [], _diner.create_model\n"
    "def _counted_create(*a, **k):\n"
    "    before = read_counts()\n"
    "    model = _create(*a, **k)\n"
    "    _inits.append([x - y for x, y in zip(read_counts(), before)])\n"
    "    return model\n"
    "_diner.create_model = _loop.create_model = _counted_create\n"
    f"atexit.register(lambda: print({PIPELINE_INIT_TAG!r} + "
    "json.dumps(_inits)))\n")
PIPELINE_STEP_LOSSES = (
    "from diner_tpu_torch.train.diner import TrainStep\n"
    "_losses, _call = [], TrainStep.__call__\n"
    "def _logged_call(self, *a, **k):\n"
    "    out = _call(self, *a, **k)\n"
    "    _losses.append(float(out['total']))\n"
    "    return out\n"
    "TrainStep.__call__ = _logged_call\n"
    f"atexit.register(lambda: print({PIPELINE_LOSS_TAG!r} + "
    "json.dumps(_losses)))\n")
PIPELINE_SETUPS = {"train": PIPELINE_INIT_LAUNCHES + PIPELINE_STEP_LOSSES,
                   "predict": PIPELINE_INIT_LAUNCHES}


def pipeline_runner(stages, maps_dir):
    """A stage runner for ``pipeline.main``: the stage's ``main`` under
    ``counted_cli`` in a subprocess (every launch count 0 just before it,
    read just after), its output appended to the pipeline's log. Appends
    to ``stages`` the stage's name, seconds, launches, peak allocation,
    main's return value, the launches of each DINER ``create_model`` and
    DINER training's loss at each step; a stage that fails fails the
    run."""
    def run(module, args, log):
        args = [str(a) for a in args]
        name = module.split(".")[-1]
        if name == "mvs":
            name = "mvs_" + args[args.index("--mode") + 1]
        setup = PIPELINE_SETUPS.get(name, "")
        if name == "mvs_write_prediction":
            setup = PIPELINE_SAVE_MAPS.replace("MAPS_DIR",
                                               repr(str(maps_dir)))
        package = name.startswith("mvs") or name == "train"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", counted_cli(
                module + (".__main__" if package else ""), PIPELINE_TAG,
                setup), *args],
            cwd=ROOT, capture_output=True, text=True, timeout=900)
        seconds = time.perf_counter() - t0
        with open(log, "a") as f:
            f.write(f"\n$ python -m {module} {' '.join(args)}\n"
                    f"{proc.stdout}{proc.stderr}")
        found = {tag: json.loads(ln[len(tag):])
                 for ln in proc.stdout.splitlines()
                 for tag in (PIPELINE_TAG, PIPELINE_LOSS_TAG,
                             PIPELINE_INIT_TAG)
                 if ln.startswith(tag)}
        check(proc.returncode == 0 and PIPELINE_TAG in found,
              f"pipeline stage {name} exited {proc.returncode}: "
              f"{(proc.stdout + proc.stderr)[-3000:]}")
        result = found[PIPELINE_TAG]
        stages.append(dict(stage=name, seconds=seconds,
                           launches=result["launches"],
                           peak_mem_bytes=result["peak"],
                           records=result["records"],
                           init_launches=found.get(PIPELINE_INIT_TAG, []),
                           step_losses=found.get(PIPELINE_LOSS_TAG)))
    return run


def pipeline_expected_launches(work):
    """(A, B, C, DCN backward, kNN, R) launches each stage must make:
    TransMVSNet's steps with full remat (``mvs_train_launches``); 4 maps
    of ``MVS_C_PER_MAP[4]``; DINER's steps (A 1, B 1, C 6) and the
    validation hook's images (A 1 and C 6 a ray chunk); the prediction
    folder's images at 512×640; none for the scores. A ``create_model``'s
    probe of its init comes on top (``pipeline_runner``)."""
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    from diner_tpu_torch.train.config import load_train_config
    per_c, per_d = mvs_train_launches(TransMVSNetConfig(remat=True), 4)

    def chunks(cfg_name):
        run = load_train_config(work / cfg_name)
        ds = run.raw["data"]["val"]["dataset"]["kwargs"]["downsample"]
        return -(-int(512 * ds) * int(640 * ds)
                 // run.diner.renderer.ray_chunk)

    steps, mvs = PIPELINE_DINER_STEPS, PIPELINE_MVS_STEPS
    val = (PIPELINE_VAL_VIEWS + PIPELINE_SWEEPS * PIPELINE_SWEEP_FRAMES
           ) * chunks("train_diner_pipeline.yaml")
    ev = PIPELINE_EVAL_N * chunks("eval_diner_pipeline.yaml")
    return {"mvs_train": [0, 0, per_c * mvs, per_d * mvs, 0, 0],
            "mvs_write_prediction": [0, 0, 4 * MVS_C_PER_MAP[4], 0, 0, 0],
            "train": [steps + val, steps, 6 * (steps + val), 0, 0, 0],
            "predict": [ev, 0, 6 * ev, 0, 0, 0],
            "evaluate": [0, 0, 0, 0, 0, 0]}


def pipeline_seam(work, maps_dir):
    """The MVS → DINER seam: the prediction stage's ``DTUDataset(
    depth_fname="TransMVSNet")`` (downsample 1) reads, as the source views
    of ``MVS_TARGET_CAM``, the PNGs decoded and rescaled exactly, each
    within one PNG unit of the map write_prediction made; the training
    stage's dataset reads the same files (its ``Depths`` is the fixture's,
    its depth name TransMVSNet)."""
    from diner_tpu_torch.data.dtu import DTU_SCALE_FACTOR
    from diner_tpu_torch.data.io import DEPTH_PNG_SCALE, read_depth_png
    from diner_tpu_torch.mvs.predict import DTU_DEPTH_UNSCALE
    from diner_tpu_torch.train.config import load_train_config
    ds = load_train_config(work / "eval_diner_pipeline.yaml").build_dataset(
        "val")
    train_ds = load_train_config(
        work / "train_diner_pipeline.yaml").build_dataset("train")
    idx = next(i for i, m in enumerate(ds.metas)
               if int(ds.cam_dict["ids"][m["cam_idx"]]) == MVS_TARGET_CAM)
    sample = ds[idx]
    decoded_equal, png_err, model_err = True, 0.0, 0.0
    for j, cam in enumerate(MVS_SOURCE_CAMS):
        got = sample["src_depths"][j, ..., 0]
        d = read_depth_png(MVS_FIXTURE / "Depths" / "scan1" /
                           f"depth_map_{cam:04d}_TransMVSNet.png")
        made = np.load(maps_dir / f"depth_map_{cam:04d}.npy")
        png_err = max(png_err, float(np.abs(d * DTU_DEPTH_UNSCALE
                                            - made).max()))
        decoded_equal &= np.array_equal(got, d / DTU_SCALE_FACTOR
                                        * ds.scale_factor)
        model_err = max(model_err, float(np.abs(
            got / ds.scale_factor - made).max()))
    lsb = DEPTH_PNG_SCALE * DTU_DEPTH_UNSCALE
    seam = dict(target_cam=MVS_TARGET_CAM, downsample=ds.downsample,
                src_view_ids=sample["src_view_ids"].tolist(),
                src_depths_are_the_pngs=decoded_equal,
                png_max_abs_err_vs_map=png_err,
                src_depth_max_abs_err_vs_map=model_err, png_unit=lsb,
                train_depths=str(train_ds.data_dir / "Depths"),
                train_depth_fname=train_ds.depth_fname,
                train_downsample=train_ds.downsample)
    check(seam["src_view_ids"] == list(MVS_SOURCE_CAMS),
          f"source views {seam['src_view_ids']}")
    check(decoded_equal, "DTUDataset's source depths are not the PNGs")
    check(png_err <= 1.001 * lsb and model_err <= 1.001 * lsb,
          f"PNGs {png_err} / source depths {model_err} from the maps")
    check((train_ds.data_dir / "Depths").resolve()
          == (MVS_FIXTURE / "Depths").resolve()
          and train_ds.depth_fname == "TransMVSNet",
          f"the training stage reads {seam['train_depths']} "
          f"({train_ds.depth_fname})")
    return seam


def ply_records(path):
    """A binary PLY's header and its vertex records, each one byte string,
    sorted: the fusion core's threads append points in any order (one
    sort of byte strings, many times faster than a row-wise lexsort of
    floats on millions of points)."""
    data = Path(path).read_bytes()
    end = data.index(b"end_header\n") + len(b"end_header\n")
    header = data[:end].decode("ascii").splitlines()
    n = int(header[2].split()[-1])
    width = sum(4 if h.split()[1] == "float" else 1 for h in header
                if h.startswith("property "))
    return header, np.sort(np.frombuffer(data, f"S{width}", n, end))


def start_fusion_cli(scan_dir, out):
    """Start ``python -m diner_tpu_torch.fusion`` at its defaults on a
    dense folder; returns a function that waits for it and gives the
    points it reports."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "diner_tpu_torch.fusion", "--scan_dir",
         str(scan_dir), "--out", str(out)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    def points():
        stdout, err = proc.communicate(timeout=600)
        check(proc.returncode == 0, f"fusion CLI on {scan_dir} exited "
              f"{proc.returncode}: {err[-2000:]}")
        return int(stdout.split()[1])
    return points


def write_ground_truth_folder(cams, dst):
    """The fixture's ground truth of ``cams`` as a dense folder: the test
    scan's cam files, the depth PFMs and light-3 renders linked, and a
    confidence of 1."""
    from diner_tpu_torch.data.io import write_pfm
    for sub in ("cams", "depth_est", "confidence", "images"):
        (dst / sub).mkdir(parents=True)
    for c in cams:
        stem = f"{c:08d}"
        shutil.copy(MVS_DIR / "test" / "scan1" / "cams" / f"{stem}_cam.txt",
                    dst / "cams")
        depth = MVS_FIXTURE / "Depths" / "scan1" / f"depth_map_{c:04d}.pfm"
        (dst / "depth_est" / f"{stem}.pfm").symlink_to(depth)
        (dst / "images" / f"{stem}.png").symlink_to(
            MVS_FIXTURE / "Rectified" / "scan1_train" /
            f"rect_{c + 1:03d}_3_r5000.png")
        write_pfm(dst / "confidence" / f"{stem}.pfm",
                  np.ones((1200, 1600), np.float32))


def phase_pipeline(smi, gt):
    """``python -m diner_tpu_torch.pipeline`` (``main`` in this process,
    each stage a subprocess through ``pipeline_runner``) on the fixture at
    the full recipe's widths (TransMVSNet 512×640, 48/32/8 of 192, bf16,
    remat; DINER ResNet34, ResnetFC 5 × 512, 40 of 1000 samples, 15
    Gaussians, 128 rays, a 64 px VGG patch at downsample 0.5; the
    prediction folder at 512×640 with 64 samples), its depth cut
    (``PIPELINE_CUTS``). After the chain, with nothing else running,
    ``python -m diner_tpu_torch.fusion`` at its defaults fuses the
    fixture's ground truth and ``mvs_test``'s gipuma dense folder (two
    processes at once). Checks: every stage exits 0 with the launches its
    path makes (``pipeline_expected_launches``); finite MVS losses, no step
    skipped, 4 maps written; the seam (``pipeline_seam``); every DINER
    step's loss and every logged row finite; 2 pred / gt pairs; finite
    scores in ``PIPELINE_RESULT.json``; each stage's peak within
    ``MEMORY_SHARE_LIMIT`` of the card; both fusion CLIs exit 0, and on the
    ground truth their PLY holds the header and the points, byte for byte,
    of ``mvs_test``'s in-process fusion (``gt``; on ``mvs_test``'s folder,
    where the seeded weights leave no consistent depth, only the count of
    its gipuma PLY). Returns the launches of all stages."""
    import gc

    from diner_tpu_torch import pipeline
    shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    maps_dir = PIPELINE_DIR / "maps"
    maps_dir.mkdir(parents=True)
    work = PIPELINE_DIR / "work"
    stages = []
    gc.collect()
    torch.cuda.empty_cache()  # the stages need all but the context's memory
    t0 = time.perf_counter()
    summary = pipeline.main(
        ["--root", str(MVS_FIXTURE), "--workdir", str(work), "--device",
         "cuda", *map(str, PIPELINE_CUTS)],
        run_stage=pipeline_runner(stages, maps_dir))
    t_pipeline = time.perf_counter() - t0

    test_dir = MVS_DIR / "test_gipuma"
    write_ground_truth_folder(sorted(MVS_SOURCE_CAMS + (MVS_TARGET_CAM,)),
                              PIPELINE_DIR / "ground_truth")
    t0 = time.perf_counter()
    gt_points = start_fusion_cli(PIPELINE_DIR / "ground_truth",
                                 PIPELINE_DIR / "fused_gt.ply")
    test_points = start_fusion_cli(test_dir / "scan1",
                                   PIPELINE_DIR / "fused_test.ply")
    n_gt, n_test = gt_points(), test_points()
    t_fusion = time.perf_counter() - t0
    gt_header, gt_cli = ply_records(PIPELINE_DIR / "fused_gt.ply")
    gt_ref_header, gt_ref = ply_records(ROOT / gt["gipuma_ply"])
    same_gt = gt_header == gt_ref_header and np.array_equal(gt_cli, gt_ref)
    del gt_cli, gt_ref
    by_stage = {s["stage"]: s for s in stages}
    expected = pipeline_expected_launches(work)
    check([s["stage"] for s in stages] == list(expected),
          f"pipeline stages {[s['stage'] for s in stages]}")
    for name, s in by_stage.items():
        init = [sum(x) for x in zip([0] * 6, *s["init_launches"])]
        path = [x - y for x, y in zip(s["launches"], init)]
        check(path == expected[name] and init[:2] == [0, 0]
              and init[3:] == [0, 0, 0]
              and len(s["init_launches"]) == (name in PIPELINE_SETUPS),
              f"pipeline {name}: kernel A, B, C, DCN backward, kNN and R "
              f"launches {s['launches']} of which create_model "
              f"{s['init_launches']}, expected {expected[name]} besides")
    total_mem = torch.cuda.get_device_properties(0).total_memory
    check(all(s["peak_mem_bytes"] <= MEMORY_SHARE_LIMIT * total_mem
              for s in stages), f"pipeline peaks "
          f"{[s['peak_mem_bytes'] for s in stages]} of {total_mem} B")

    mvs = by_stage["mvs_train"]["records"]
    check([r["step"] for r in mvs] == list(range(1, PIPELINE_MVS_STEPS + 1))
          and all(np.isfinite(r["loss"]) and r["skipped"] == 0
                  for r in mvs), f"pipeline MVS steps {mvs}")
    written = by_stage["mvs_write_prediction"]["records"]
    maps = sorted(maps_dir.glob("*.npy"))
    check(len(written) == 4 and len(maps) == 4
          and all(np.isfinite(np.load(m)).all() for m in maps),
          f"write_prediction wrote {written}, maps {maps}")
    seam = pipeline_seam(work, maps_dir)

    losses = by_stage["train"]["step_losses"]
    run_dir = work / "diner" / "DINER_pipeline"
    rows = [json.loads(ln) for ln in
            (run_dir / "logs" / "metrics.jsonl").read_text().splitlines()]
    check(len(losses) == PIPELINE_DINER_STEPS
          and all(np.isfinite(x) for x in losses),
          f"DINER step losses {losses}")
    check([r["step"] for r in rows if "total" in r] == [PIPELINE_DINER_STEPS]
          and any("valscores_psnr" in r for r in rows)
          and all(np.isfinite(v) for r in rows for v in r.values()),
          f"DINER logged rows {rows}")
    pred = work / "prediction"
    pairs = (len(list(pred.glob("*-pred.png"))),
             len(list(pred.glob("*-gt.png"))))
    result = json.loads((work / "PIPELINE_RESULT.json").read_text())
    check(pairs == (PIPELINE_EVAL_N, PIPELINE_EVAL_N),
          f"prediction folder pairs {pairs}")
    check(result == summary and all(np.isfinite(result["scores"][k])
                                    for k in ("psnr", "ssim", "l1", "l2")),
          f"PIPELINE_RESULT.json {result}")

    test_ply_points = len(ply_records(test_dir / "mvsnet_scan1.ply")[1])
    fusion = dict(seconds=t_fusion, ground_truth_points=n_gt,
                  ground_truth_share=n_gt / gt["pixels"],
                  ground_truth_points_in_process=gt["gipuma_points"],
                  ground_truth_ply_equal=same_gt, test_points=n_test,
                  test_points_gipuma_ply=test_ply_points)
    check(same_gt and n_gt == gt["gipuma_points"]
          and n_gt / gt["pixels"] > MVS_GT_FUSED_SHARE,
          f"fusion CLI on the ground truth: {fusion}")
    check(n_test == test_ply_points, f"fusion CLI on {test_dir}: {fusion}")

    launches = tuple(sum(s["launches"][i] for s in stages) for i in range(6))
    emit("pipeline", config="python -m diner_tpu_torch.pipeline, the full "
         "recipe (TransMVSNet 512×640 48/32/8 of 192 bf16 remat; DINER "
         "ResNet34, ResnetFC 5×512, 40 of 1000 samples, 15 Gaussians, 128 "
         "rays, 64 px VGG patch, downsample 0.5, bf16; prediction folder "
         "512×640 with 64 samples) on the DTU fixture",
         cuts=dict(mvs_steps=f"{PIPELINE_MVS_STEPS} of 30",
                   diner_steps=f"{PIPELINE_DINER_STEPS} of 2000",
                   validation_hooks="1 (at the last step) of 4",
                   val_views=f"{PIPELINE_VAL_VIEWS} of 100",
                   cam_sweeps=f"{PIPELINE_SWEEPS} of 4, "
                   f"{PIPELINE_SWEEP_FRAMES} frames of 30",
                   eval_n=f"{PIPELINE_EVAL_N} of 3"),
         nvidia_smi=smi, seconds=t_pipeline,
         stages_s={s["stage"]: s["seconds"] for s in stages},
         result_stages_s=result["stages_s"], scores=result["scores"],
         launches=launches,
         launches_by_stage={s["stage"]: s["launches"] for s in stages},
         init_launches_by_stage={s["stage"]: s["init_launches"]
                                 for s in stages},
         expected_launches_by_stage=expected,
         peak_mem_bytes_by_stage={s["stage"]: s["peak_mem_bytes"]
                                  for s in stages},
         mvs_losses=[r["loss"] for r in mvs], diner_losses=losses,
         diner_logged_rows=rows, seam=seam, prediction_pairs=pairs,
         fusion=fusion)
    return launches


def phases_mvs(smi):
    """The TransMVSNet phases in order, then the pipeline; their files are
    deleted after. Returns {path: (A, B, C, DCN backward, kNN, R)
    launches} and kernel C's MVS rows."""
    phase_mvs_fixture()
    wp = phase_mvs_write_prediction(smi)
    gather_rows = phase_gather_mvs(wp.pop("model"))
    test_l, gt = phase_mvs_test(smi)
    phase_mvs_small_reference()
    train_l = phase_mvs_train(smi)
    phase_mvs_train_small_reference()
    pipeline_l = phase_pipeline(smi, gt)
    shutil.rmtree(MVS_DIR, ignore_errors=True)
    shutil.rmtree(PIPELINE_DIR, ignore_errors=True)
    return ({"mvs_write_prediction": wp["launches"],
             "mvs_test": test_l["normal"],
             "mvs_test_gipuma": test_l["gipuma"],
             **train_l, "pipeline": pipeline_l}, gather_rows)


# ------------------------------------------------------------------ kernel R
# and the preprocessing / multiface paths

RASTER_HW = (2048, 1334)  # multiface's frames (scripts/preprocess_multiface.py)
# operations of one test of a pixel centre inside a face's box (grown by
# one pixel): d (2), the two cross products (6), b1 and b2 (2 divisions), b0
# (2) and the inside test (3); a covered pair adds the depth (3 divisions, 2
# sums, the clamp, 1 division), not counted
RASTER_OPS_PER_PAIR = 15
# kernel R's launches per call with F > 0: its bin, scan, scatter and tile
# kernels (ops/rasterize_cuda.py)
RASTER_LAUNCHES_PER_CALL = 4
HEAD_LAT, HEAD_LON = 126, 200  # 50,400 faces, 25,202 vertices
# kernel R's dense-mesh case: the head at 20× the faces (1,008,000 faces,
# 504,002 vertices), a stand-in for a full-resolution raw scan
DENSE_LAT, DENSE_LON = 630, 800
# the same two sizes without poles (cube_head_mesh): 50,400 faces, 25,986
# vertices, and 1,008,000 faces, 507,486 vertices
CUBE_HEAD, CUBE_DENSE = (60, 75), (280, 310)
MF_DIR = OUT_DIR / "multiface"
MF_SUBJECT = "m--20200101--0000--0000000--GHS"
MF_SEQ = "SEQ1"
MF_FRAMES = ("000000", "000001")  # tracked meshes; images for the first
MF_CAMS = 16               # tests/test_multiface.py's _ring_cameras(16)
MF_FOCAL = 100.0 * RASTER_HW[0] / 64  # its K (f 100 at 64 px), scaled
MF_REF_CENTERS = [[0, 90, 100], [630, 90, 360], [0, 90, 1900],
                  [-630, 90, 360], [880, 90, 820], [-880, 90, 820]]
MF_RENDERS = 2             # images multiface_render scores
MF_MVS_STEPS = 2
FS_DIR = OUT_DIR / "facescape"
FS_VIEWS = 4
FS_CROP = 256
# kernel C under collect_vertex_colors: 1 nearest and 4 bilinear corner
# gathers per view (ops/grid_sample.py)
FS_C_PER_VIEW = 5


def head_radius(th, ph):
    """The head's radial factor at polar angle ``th`` from −y and azimuth
    ``ph`` (0 at +z): 1, with a nose and brow ridge at ph = π."""
    front = np.exp(-((ph - np.pi) ** 2 / 0.05 + (th - 1.75) ** 2 / 0.03))
    brow = np.exp(-((ph - np.pi) ** 2 / 0.4 + (th - 1.25) ** 2 / 0.01))
    return 1 + 0.25 * front + 0.05 * brow


def posed(pts, frame, centre):
    """Head points (mm) turned by 3° about y per ``frame``, moved to
    ``centre`` → f32."""
    a = np.deg2rad(3.0 * frame)
    rot = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                    [-np.sin(a), 0, np.cos(a)]])
    return (pts @ rot.T + np.asarray(centre)).astype(np.float32)


def head_mesh(frame=0, centre=(0.0, 0.0, 1000.0), n_lat=HEAD_LAT,
              n_lon=HEAD_LON):
    """A closed head-sized mesh in mm: an ellipsoid of radii 80 / 110 / 95
    with a nose and brow ridge, ``n_lat`` rings of ``n_lon`` vertices and
    two poles (2·n_lat·n_lon faces, 50,400 by default, consistently
    wound), turned by 3° about y per ``frame`` → (verts (V, 3) f32, faces
    (F, 3) int32)."""
    lat = np.pi * (np.arange(1, n_lat + 1) / (n_lat + 1))
    lon = 2 * np.pi * np.arange(n_lon) / n_lon
    th, ph = np.meshgrid(lat, lon, indexing="ij")
    r = head_radius(th, ph)
    x = 80 * r * np.sin(th) * np.sin(ph)
    y = -110 * np.cos(th) * np.ones_like(r)
    z = 95 * r * np.sin(th) * np.cos(ph)
    pts = np.concatenate([[[0, -110, 0]], np.stack([x, y, z], -1)
                          .reshape(-1, 3), [[0, 110, 0]]])
    verts = posed(pts, frame, centre)
    ring = lambda i: 1 + i * n_lon  # noqa: E731
    j = np.arange(n_lon)
    jn = (j + 1) % n_lon
    faces = [np.stack([np.zeros_like(j), ring(0) + jn, ring(0) + j], -1)]
    for i in range(n_lat - 1):
        a0, a1 = ring(i) + j, ring(i) + jn
        b0, b1 = ring(i + 1) + j, ring(i + 1) + jn
        faces += [np.stack([a0, a1, b0], -1), np.stack([a1, b1, b0], -1)]
    last = len(pts) - 1
    faces.append(np.stack([np.full_like(j, last), ring(n_lat - 1) + j,
                           ring(n_lat - 1) + jn], -1))
    return verts, np.concatenate(faces).astype(np.int32)


def cube_head_mesh(n_xz, n_y, frame=0, centre=(0.0, 0.0, 1000.0)):
    """``head_mesh``'s head without poles: the six faces of a cube, gridded
    in ``n_xz`` cells along x and z and ``n_y`` along y (equal angles),
    pushed onto the head's surface; every vertex is shared by at most six
    faces, so no tile holds a fan of slivers (4·(2·n_xz·n_y + n_xz²)
    faces, consistently wound; the cube's edges are duplicated at equal
    positions) → (verts (V, 3) f32, faces (F, 3) int32)."""
    def grid(n):
        g = np.tan(np.pi / 4 * np.linspace(-1.0, 1.0, n + 1))
        g[0], g[-1] = -1.0, 1.0
        return g
    grids = (grid(n_xz), grid(n_y), grid(n_xz))
    pts, faces = [], []
    for axis, (a, b) in enumerate(((1, 2), (2, 0), (0, 1))):
        for sign in (1.0, -1.0):
            if sign < 0:  # a × b = the face's outward normal
                a, b = b, a
            u, v = np.meshgrid(grids[a], grids[b], indexing="ij")
            p = np.zeros(u.shape + (3,))
            p[..., axis], p[..., a], p[..., b] = sign, u, v
            idx = sum(len(q) for q in pts) + np.arange(u.size) \
                .reshape(u.shape)
            q00, q10 = idx[:-1, :-1], idx[1:, :-1]
            q01, q11 = idx[:-1, 1:], idx[1:, 1:]
            faces += [np.stack([q00, q10, q01], -1).reshape(-1, 3),
                      np.stack([q10, q11, q01], -1).reshape(-1, 3)]
            pts.append(p.reshape(-1, 3))
    d = np.concatenate(pts)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    r = head_radius(np.arccos(-d[:, 1]),
                    np.arctan2(d[:, 0], d[:, 2]) % (2 * np.pi))
    xyz = np.stack([80 * r * d[:, 0], 110 * d[:, 1], 95 * r * d[:, 2]], -1)
    return posed(xyz, frame, centre), np.concatenate(faces).astype(np.int32)


def write_obj(path, verts, faces):
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in verts]
    lines += [f"f {a + 1} {b + 1} {c + 1}" for a, b, c in faces]
    path.write_text("\n".join(lines) + "\n")


def ring_cameras(n, radius=900.0, target=(0.0, 0.0, 1000.0)):
    """``tests/test_multiface.py:_ring_cameras`` at the frame's size: n
    cameras on a ring around ``target`` looking at it (mm), K's focal
    ``MF_FOCAL`` and the principal point at the frame's centre →
    {name: (K, [R | t])}."""
    H, W = RASTER_HW
    cams = {}
    target = np.asarray(target)
    for i in range(n):
        a = 2 * np.pi * i / n
        eye = target + radius * np.array([np.sin(a), 0.1, -np.cos(a)])
        fwd = (target - eye) / np.linalg.norm(target - eye)
        right = np.cross(fwd, [0, 1, 0])
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        K = np.array([[MF_FOCAL, 0, W / 2], [0, MF_FOCAL, H / 2],
                      [0, 0, 1]])
        cams[f"40000{i:02d}"] = (K, np.hstack([R, (-R @ eye)[:, None]]))
    return cams


def krt_text(cams):
    lines = []
    for name, (K, E) in cams.items():
        lines.append(name)
        lines += [" ".join(repr(float(v)) for v in row) for row in K]
        lines.append("0 0 0 0 0")
        lines += [" ".join(repr(float(v)) for v in row) for row in E]
        lines.append("")
    return "\n".join(lines) + "\n"


def smooth_image(rng, H, W):
    """A seeded smooth RGB image (uint8): a few sinusoids per channel."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.zeros((H, W, 3), np.float32)
    for c in range(3):
        fx, fy, p = rng.uniform(0.002, 0.02, 2).tolist() + [rng.uniform(6)]
        out[..., c] = 0.5 + 0.4 * np.sin(fx * x + fy * y + p)
    return (out * 255).astype(np.uint8)


def write_multiface_subject():
    """The fabricated multiface subject under ``MF_DIR``: a KRT file of
    ``MF_CAMS`` ring cameras at the frame's size, the tracked head mesh of
    each of ``MF_FRAMES`` (OBJ, mm), a seeded image of the first frame
    from every camera, and split files with the 6 reference centres of
    ``tests/test_multiface.py`` (DINER) and their first 4 (MVS) → (root,
    split6, split4)."""
    from PIL import Image
    shutil.rmtree(MF_DIR, ignore_errors=True)
    root = MF_DIR / "data"
    subj = root / MF_SUBJECT
    (subj / "tracked_mesh" / MF_SEQ).mkdir(parents=True)
    cams = ring_cameras(MF_CAMS)
    (subj / "KRT").write_text(krt_text(cams))
    for k, frame in enumerate(MF_FRAMES):
        write_obj(subj / "tracked_mesh" / MF_SEQ / f"{frame}.obj",
                  *head_mesh(k))
    rng = np.random.RandomState(5)
    H, W = RASTER_HW
    for cam in cams:
        d = subj / "images" / MF_SEQ / cam
        d.mkdir(parents=True)
        Image.fromarray(smooth_image(rng, H, W)).save(
            d / f"{MF_FRAMES[0]}.png", compress_level=1)
    splits = []
    for n in (6, 4):
        stage = {"subjects": [MF_SUBJECT], "sequences": [MF_SEQ],
                 "ref_centers": MF_REF_CENTERS[:n]}
        p = MF_DIR / f"split{n}.json"
        p.write_text(json.dumps({"train": stage, "val": stage}))
        splits.append(p)
    return (root, *splits)


def rasterize_edge_cases(device, seed=0):
    """name → (uv, z, faces, H, W), the projected inputs of kernel R:
    both windings overlapping; |denom| just above and just below 1e-12 at
    a pixel centre (tiny right triangles with exact f32 edges, the one
    below nearer: dropped, it must not win); a collapsed face beside a
    real one; vertices at z = znear, just past it, at 0 and behind (through
    ``project``); edges along rows and columns of pixel centres; slivers;
    a face larger than the image, faces off screen and partly off; F = 0;
    H, W and F no multiples of the tile (16) or the chunk (256); 1,000
    faces crowding one tile; faces wider than the bins' span (the large
    list) beside small ones, vertices at ±1e10 and a face wholly off the
    map."""
    from diner_tpu_torch.ops.rasterize_cuda import project
    rng = np.random.RandomState(seed)

    def case(uv, z, faces, H, W):
        return (torch.as_tensor(np.asarray(uv, np.float32), device=device),
                torch.as_tensor(np.asarray(z, np.float32), device=device),
                torch.as_tensor(np.asarray(faces, np.int32).reshape(-1, 3),
                                device=device), H, W)

    def random_tris(F, H, W, size, off=0.0):
        c = rng.uniform([-off * W, -off * H], [W * (1 + off), H * (1 + off)],
                        (F, 2))
        uv = c[:, None] + rng.normal(size=(F, 3, 2)) * size
        z = rng.uniform(0.5, 3.0, (F, 3))
        return uv.reshape(-1, 2), z.ravel(), np.arange(3 * F)

    ulp = 2.0 ** -24  # of values in [0.5, 1)
    c0 = [0.5, 0.5]
    tiny = [c0, [0.5 + 17 * ulp, 0.5], [0.5, 0.5 + 17 * ulp],   # 1.03e-12
            c0, [0.5 + 16 * ulp, 0.5], [0.5, 0.5 + 17 * ulp],   # 0.97e-12
            c0, [0.5, 0.5 + 17 * ulp], [0.5 + 17 * ulp, 0.5]]   # −1.03e-12
    verts3 = np.array([[-1, -1, 2], [1, -1, 2], [0, 1, 2],      # valid
                       [-1, 1, 1e-4], [1, 1, 2], [0, -1, 2],    # z == znear
                       [-1, 0, 2e-4], [1, 0, 2], [0, 1, 3],     # just past
                       [0.5, 0.5, 0.0], [1, -0.5, 2], [0, 1, 2],  # z = 0
                       [0.2, 0.2, -1], [1, 0, 2], [0, 1, 2]], np.float32)
    K3 = torch.tensor([[20.0, 0, 20.0], [0, 21.0, 15.0], [0, 0, 1]])
    uv3, z3 = project(torch.from_numpy(verts3), K3, torch.eye(4))
    sl_a = rng.uniform(0, 40, (12, 2))
    sl_b = rng.uniform(0, 40, (12, 2))
    normal = (sl_b - sl_a)[:, ::-1] * [1, -1]
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    sl_c = (sl_a + sl_b) / 2 + normal * np.geomspace(1e-5, 0.3, 12)[:, None]
    slivers = np.stack([sl_a, sl_b, sl_c], 1).reshape(-1, 2)
    crowd = random_tris(1000, 16, 16, 3.0)
    crowd[0][:] = np.clip(crowd[0], 16.5, 31.5)  # all in tile (1, 1)

    def spanning_and_far():
        # faces ~100 px across on a 90×150 map (wider than 4 tiles: the
        # large list) over small ones; vertices at ±1e10; the last face
        # wholly at 1e10 (valid, off the map)
        uv, z, idx = random_tris(60, 90, 150, 40.0, off=0.2)
        tri = uv.reshape(60, 3, 2)[10:]  # faces 10-59 shrunk to a tenth
        tri[:] = tri.mean(1, keepdims=True) * 0.9 + tri * 0.1
        uv[0:90:9, 0] = 1e10
        uv[4:90:15, 1] = -1e10
        uv[-3:] = [[1e10, 5e9], [2e10, 5e9], [1e10, 9e9]]
        return uv, z, idx
    return {
        "orientations": case(
            [[3.2, 4.1], [30.7, 6.3], [12.9, 25.8], [28.1, 2.2], [5.5, 27.9],
             [31.3, 20.4]], [1.0, 1.5, 2.0, 1.2, 0.9, 1.8],
            [[0, 1, 2], [3, 4, 5]], 29, 37),
        "denom_threshold": case(tiny, [2.0, 2.0, 2.0, 1.0, 1.0, 1.0, 2.5,
                                       2.5, 2.5],
                                [[0, 1, 2], [3, 4, 5], [6, 7, 8]], 3, 3),
        "collapsed_face": case([[2.0, 3.0], [14.0, 5.0], [6.0, 13.0],
                                [7.3, 7.7]], [2.0, 2.0, 2.0, 1.0],
                               [[0, 1, 2], [3, 3, 3]], 16, 16),
        "znear_and_z0": (uv3.to(device), z3.to(device), torch.arange(
            15, dtype=torch.int32, device=device).reshape(5, 3), 30, 40),
        "axis_aligned": case([[2.5, 2.5], [12.5, 2.5], [2.5, 9.5],
                              [12.5, 9.5]], [1.0, 2.0, 1.5, 1.2],
                             [[0, 1, 2], [1, 3, 2], [0, 2, 1]], 12, 15),
        "slivers": case(slivers, rng.uniform(0.5, 3.0, 36),
                        np.arange(36), 40, 40),
        "large_and_off_screen": case(
            [[-1e4, -1e4], [1e4, -50.0], [-50.0, 1e4],
             [60.0, 3.0], [75.0, 9.0], [66.0, 20.0],
             [-20.0, 5.0], [6.0, 8.0], [-3.0, 30.0]],
            [5.0, 6.0, 7.0, 1.0, 1.0, 1.0, 2.0, 1.5, 1.0],
            [[0, 1, 2], [3, 4, 5], [6, 7, 8]], 24, 40),
        "no_faces": case(np.zeros((3, 2)), np.ones(3), np.zeros((0, 3)),
                         17, 19),
        "odd_sizes_f777": case(*random_tris(777, 33, 47, 4.0, off=0.1),
                               33, 47),
        "crowded_tile_f1000": case(*crowd, 40, 40),
        "spanning_and_far_f60": case(*spanning_and_far(), 90, 150),
    }


def raster_pairs_in_boxes(uv, z, faces, H, W, znear=1e-4):
    """The pixel-face tests a z-buffer needs, whatever its tiling: for each
    valid face, the pixel centres of the map inside its box grown by one
    pixel."""
    from diner_tpu_torch.ops.rasterize_cuda import face_terms
    t = face_terms(uv, z, faces, znear)
    counts = []
    for lo, hi, n in ((t["xlo"], t["xhi"], W), (t["ylo"], t["yhi"], H)):
        a = torch.ceil(lo.double() - 0.5).clamp(min=0)
        b = torch.floor(hi.double() - 0.5).clamp(max=n - 1)
        counts.append((b - a + 1).clamp(min=0))
    return int((counts[0] * counts[1])[t["valid"]].sum())


def raster_bin_plan(uv, z, faces, H, W, znear=1e-4):
    """Kernel R's bins as its kernels make them, with tensor ops in f32
    (``csrc/rasterize_depth.cu:tile_range``): each valid face's tiles are
    those whose pixel centres ceil / floor of its grown box − 0.5 can
    reach, clamped to the map; a face spanning more than ``SPAN`` tiles on
    an axis goes to the large list, which every tile tests against its own
    extreme pixel centres. → {"x0", "x1", "y0", "y1": (F,) each face's
    tile range, "hit": (F,) the range is on the map, "large": (F,) the face
    is on the large list, "binned": (F,) it is in its tiles' lists,
    "counts": (gy, gx) ids a tile's list holds (on the host), "entries":
    their sum, "n_large": the large list's length, "pairs_after_cull": the
    pixel tests the tile kernel makes, each tile's pixels in the map times
    the faces it evaluates (its list and the large faces that meet it)}."""
    from diner_tpu_torch.ops import rasterize_cuda as rc
    t = rc.face_terms(uv, z, faces, znear)
    T, S = rc.TILE, rc.SPAN
    lay = rc.bin_layout(faces.shape[0], H, W)
    gx, gy = lay["gx"], lay["gy"]
    c0 = [torch.clamp(torch.ceil(t[k] - 0.5), min=0) for k in ("xlo", "ylo")]
    c1 = [torch.clamp(torch.floor(t[k] - 0.5), max=n - 1)
          for k, n in (("xhi", W), ("yhi", H))]
    hit = t["valid"] & (c0[0] <= c1[0]) & (c0[1] <= c1[1])
    lo, hi = ([torch.where(hit, c, torch.zeros_like(c)).long() // T
               for c in cs] for cs in (c0, c1))
    large = hit & ((hi[0] - lo[0] >= S) | (hi[1] - lo[1] >= S))
    binned = hit & ~large
    counts = torch.zeros(gy * gx, dtype=torch.int64, device=uv.device)
    for dy in range(S):
        for dx in range(S):
            on = (binned & (lo[0] + dx <= hi[0]) & (lo[1] + dy <= hi[1]))
            counts += torch.bincount(((lo[1] + dy) * gx + lo[0] + dx)[on],
                                     minlength=gy * gx)
    tx = torch.arange(gx, device=uv.device) * T
    ty = torch.arange(gy, device=uv.device) * T
    # the tile kernel's extreme pixel centres and pixels in the map
    x_lo, y_lo = tx.float() + 0.5, ty.float() + 0.5
    x_hi = torch.clamp(tx + T, max=W).float() - 0.5
    y_hi = torch.clamp(ty + T, max=H).float() - 0.5
    pixels = ((torch.clamp(ty + T, max=H) - ty)[:, None]
              * (torch.clamp(tx + T, max=W) - tx)[None]).reshape(-1)
    met = torch.zeros(gy * gx, dtype=torch.int64, device=uv.device)
    for f in large.nonzero().flatten().tolist():
        met += ((t["xlo"][f] <= x_hi)[None] & (t["xhi"][f] >= x_lo)[None]
                & (t["ylo"][f] <= y_hi)[:, None]
                & (t["yhi"][f] >= y_lo)[:, None]).reshape(-1)
    return dict(x0=lo[0], x1=hi[0], y0=lo[1], y1=hi[1], hit=hit,
                large=large, binned=binned,
                counts=counts.reshape(gy, gx).int().cpu(),
                entries=int(counts.sum()), n_large=int(large.sum()),
                pairs_after_cull=int(((counts + met) * pixels).sum()))


def raster_bound(pairs, V, F, H, W):
    """(bound ms, what bounds it): ``pairs`` tests of
    ``RASTER_OPS_PER_PAIR`` over the FP32 rate (``raster_pairs_in_boxes``),
    or the bytes (uv and z read, the faces read, the map written once) over
    the memory rate."""
    ops_ms = 1e3 * pairs * RASTER_OPS_PER_PAIR / F32_FLOPS_PER_S
    bytes_ms = 1e3 * (V * 12 + F * 12 + H * W * 4) / HBM_BYTES_PER_S
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def raster_timed_case(name, uv, z, faces, H, W):
    """One timed case of kernel R on the card: the kernel against its plain
    version bit for bit, a second kernel call equal to the first (the
    bins' order changes from run to run, the map must not), the kernel's
    bins equal to ``raster_bin_plan``'s; ``ms`` (a graph of 20 calls),
    ``call_ms``, ``plain_ms`` (its one comparison call between CUDA
    events), the bound of the pairs a z-buffer needs (pixel centres in
    each face's grown box) beside the pairs the bins leave, the ids they
    hold, the large faces and the dense bound of H·W·F pairs.
    → (row, the plain map)."""
    from diner_tpu_torch.ops import rasterize_cuda as rc

    def kernel():
        return rc.rasterize_depth_kernel(uv, z, faces, H, W)

    got, bins = rc.rasterize_depth_kernel_bins(uv, z, faces, H, W)
    again = kernel()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    ref = rc.rasterize_depth_plain(uv, z, faces, H, W, pixel_block=16384,
                                   face_chunk=8192)
    end.record()
    torch.cuda.synchronize()
    plan = raster_bin_plan(uv, z, faces, H, W)
    pairs = raster_pairs_in_boxes(uv, z, faces, H, W)
    V, F = uv.shape[0], faces.shape[0]
    bound, by = raster_bound(pairs, V, F, H, W)
    dense = H * W * F
    row = dict(case=name, H=H, W=W, V=V, F=F, exact=torch.equal(got, ref),
               repeat_exact=torch.equal(got, again),
               max_abs_err=float((got - ref).abs().max()),
               covered=int((got > 0).sum()), ms=device_time_ms(kernel, n=20),
               call_ms=cuda_time_ms(kernel, 10, 2),
               plain_ms=start.elapsed_time(end),
               plain_timing="its one comparison call between CUDA events "
               "(tiles of 16,384 pixels × 8,192 faces, faces culled to each "
               "tile's rows)",
               bin_entries=bins["entries"], large_faces=bins["large"],
               occupied_tiles=int((bins["counts"] > 0).sum()),
               tiles=bins["counts"].numel(),
               bins_match_plan=torch.equal(bins["counts"], plan["counts"])
               and bins["large"] == plan["n_large"],
               pairs_in_boxes=pairs,
               pairs_after_cull=plan["pairs_after_cull"], dense_pairs=dense,
               dense_bound_ms=1e3 * dense * RASTER_OPS_PER_PAIR
               / F32_FLOPS_PER_S, bound_ms=bound, bound_by=by,
               library_ms=None)
    emit("kernel_rasterize", **row)
    check(row["exact"] and row["repeat_exact"] and row["bins_match_plan"]
          and row["covered"] > 0.02 * H * W,
          f"kernel R vs plain, {name}: {row}")
    return row, ref


def phase_kernel_rasterize(mf_root):
    """Kernel R against its plain version on the card, bit for bit: every
    case of ``rasterize_edge_cases`` (with the kernel's bins held to
    ``raster_bin_plan``), then two timed cases at the frame's 2048×1334
    from camera 0 of the multiface subject, which ``preprocess_multiface``
    renders too: the main case, its first tracked mesh (50,400 faces,
    read from its OBJ), and the dense-mesh case, the same head at
    ``DENSE_LAT`` × ``DENSE_LON`` rings (1,008,000 faces), then the head
    without poles at both sizes (``cube_head_mesh`` at ``CUBE_HEAD`` and
    ``CUBE_DENSE``) (``raster_timed_case``).
    Returns the rows and the plain map of the main case (on the host)."""
    from diner_tpu_torch.data.multiface import load_krt
    from diner_tpu_torch.ops import rasterize_cuda as rc
    from diner_tpu_torch.preprocessing.rasterize import (
        load_obj_vertices_faces)
    rows, maps = [], {}
    cases = rasterize_edge_cases("cuda")
    for name, (uv, z, faces, H, W) in cases.items():
        got, bins = rc.rasterize_depth_kernel_bins(uv, z, faces, H, W)
        ref = rc.rasterize_depth_plain(uv, z, faces, H, W)
        plan = raster_bin_plan(uv, z, faces, H, W)
        row = dict(case=name, H=H, W=W, F=faces.shape[0],
                   exact=torch.equal(got, ref), covered=int((got > 0).sum()),
                   max_abs_err=float((got - ref).abs().max()),
                   bin_entries=bins["entries"], large_faces=bins["large"],
                   bins_match_plan=torch.equal(bins["counts"], plan["counts"])
                   and bins["large"] == plan["n_large"])
        emit("kernel_rasterize", **row)
        check(row["exact"] and row["bins_match_plan"],
              f"kernel R vs plain, {name}: {row}")
        rows.append(row)
        maps[name] = got
    # the cases' own expectations: the face above the threshold covers its
    # pixel centre at its depth, the one below is dropped; the collapsed
    # face [3, 3, 3] adds nothing to the map of the real triangle alone
    uv, z, faces, H, W = cases["collapsed_face"]
    alone = rc.rasterize_depth_plain(uv, z, faces[:1], H, W)
    thr = maps["denom_threshold"]
    check(float(thr[0, 0]) == 2.0 and int((thr > 0).sum()) == 1
          and int((maps["no_faces"] > 0).sum()) == 0
          and torch.equal(maps["collapsed_face"], alone)
          and int((alone > 0).sum()) > 0
          and rows[list(cases).index("spanning_and_far_f60")]["large_faces"]
          > 0, f"kernel R edge expectations: {rows}")

    subj = mf_root / MF_SUBJECT
    cam = sorted(load_krt(subj / "KRT").items())[0][1]
    H, W = RASTER_HW
    meshes = {"multiface_head": lambda: load_obj_vertices_faces(
        subj / "tracked_mesh" / MF_SEQ / f"{MF_FRAMES[0]}.obj"),
        "dense_head": lambda: head_mesh(0, n_lat=DENSE_LAT, n_lon=DENSE_LON),
        "cube_head": lambda: cube_head_mesh(*CUBE_HEAD),
        "cube_dense": lambda: cube_head_mesh(*CUBE_DENSE)}
    plain_map = None
    for name, make in meshes.items():
        verts, faces = make()
        uv, z = rc.project(torch.from_numpy(verts).cuda(),
                           torch.from_numpy(cam["intrin"]).cuda(),
                           torch.from_numpy(cam["extrin"]).cuda())
        row, ref = raster_timed_case(name, uv, z, torch.from_numpy(faces)
                                     .cuda(), H, W)
        rows.append(row)
        if plain_map is None:
            plain_map = ref.cpu().numpy()
        del uv, z, ref
        torch.cuda.empty_cache()
    return rows, plain_map


def multiface_map_breakdown(root):
    """Host seconds of each step of one multiface map as ``process_frame``
    takes them (camera 0, the first frame; the mesh read is once a
    frame): the OBJ read and upload, R (synchronised), the copy to the
    host, the uint16 codec, the depth PNG, the mask PNG."""
    from PIL import Image

    from diner_tpu_torch import preprocess_multiface as pm
    from diner_tpu_torch.data.multiface import load_krt
    from diner_tpu_torch.preprocessing.rasterize import (
        load_obj_vertices_faces, rasterize_depth)
    subj = root / MF_SUBJECT
    out = MF_DIR / "breakdown"
    out.mkdir(exist_ok=True)
    t = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        t.append(time.perf_counter())
    verts, faces = load_obj_vertices_faces(
        subj / "tracked_mesh" / MF_SEQ / f"{MF_FRAMES[0]}.obj")
    verts = torch.as_tensor(verts, device="cuda")
    faces = torch.as_tensor(faces, device="cuda")
    lap()
    cam = sorted(load_krt(subj / "KRT").items())[0][1]
    depth = rasterize_depth(verts, faces, cam["intrin"], cam["extrin"],
                            *RASTER_HW)
    lap()
    depth = depth.cpu().numpy()
    lap()
    q = pm.float32_2_uint16(depth)
    lap()
    Image.fromarray(q).save(out / "depth.png")
    lap()
    Image.fromarray(((depth != 0) * 255).astype(np.uint8)).save(
        out / "mask.png")
    lap()
    names = ("mesh_read_s", "rasterize_s", "to_host_s", "codec_s",
             "depth_png_s", "mask_png_s")
    return {n: b - a for n, a, b in zip(names, t, t[1:])}


def phase_preprocess_multiface(smi, root, plain_map):
    """``python -m diner_tpu_torch.preprocess_multiface`` at
    ``RASTER_HW`` (its defaults, 2048×1334) on the fabricated subject:
    every camera and frame's depth and mask PNG. Checks: kernel R once per
    camera and frame (``RASTER_LAUNCHES_PER_CALL`` launches a call) and no
    other kernel; the first camera's first-frame PNG decodes to
    ``float32_2_uint16`` of ``kernel_rasterize``'s plain map; every mask is
    255 where its depth is not 0 and 0 elsewhere."""
    from PIL import Image

    from diner_tpu_torch import preprocess_multiface as pm
    n_maps = MF_CAMS * len(MF_FRAMES)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    written = pm.main(["--root", str(root), "-H", str(RASTER_HW[0]), "-W",
                       str(RASTER_HW[1]), "--device", "cuda"])
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    first = sorted(written)[0]
    png_equal = np.array_equal(np.asarray(Image.open(first)),
                               pm.float32_2_uint16(plain_map))
    masks_ok, covered = True, []
    for d in written:
        m = d.parents[3] / "masks" / d.relative_to(d.parents[2])
        depth = np.asarray(Image.open(d))
        mask = np.asarray(Image.open(m))
        masks_ok &= np.array_equal(mask, np.where(depth != 0, 255, 0))
        covered.append(float((depth != 0).mean()))
    breakdown = multiface_map_breakdown(root)
    emit("preprocess_multiface", nvidia_smi=smi, H=RASTER_HW[0],
         W=RASTER_HW[1], cameras=MF_CAMS, frames=len(MF_FRAMES),
         maps=len(written), cli_s=cli_s, s_per_depth_map=cli_s / n_maps,
         launches=launches, first_png=str(first.relative_to(root)),
         first_png_is_plain_map=png_equal, masks_are_depth_ne_0=masks_ok,
         covered_share=[min(covered), max(covered)],
         one_map_breakdown=breakdown,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    check(len(written) == n_maps, f"{len(written)} depth maps")
    check(launches == (0, 0, 0, 0, 0, RASTER_LAUNCHES_PER_CALL * n_maps),
          f"preprocess_multiface launches {launches}, expected kernel R "
          f"{n_maps} times")
    check(png_equal, f"{first} is not float32_2_uint16 of the plain map")
    check(masks_ok and min(covered) > 0.02, f"masks / coverage {covered}")
    return launches


def multiface_config(root, split):
    """``configs/evaluate_diner_on_multiface.yaml`` with ``root`` and
    ``split_config`` of both stages pointed at the fabricated subject and
    the run under ``MF_DIR``, written as JSON → its path."""
    from diner_tpu_torch.train.config import load_train_config
    raw = load_train_config(ROOT / "configs" /
                            "evaluate_diner_on_multiface.yaml").raw
    for stage in ("train", "val"):
        raw["data"][stage]["dataset"]["kwargs"].update(
            root=str(root), split_config=str(split))
    raw["logger"]["kwargs"]["save_dir"] = str(MF_DIR / "runs")
    path = MF_DIR / "evaluate_diner_on_multiface.yaml"
    path.write_text(json.dumps(raw, indent=1))
    return path


def phase_multiface_render(smi, root, split):
    """``python -m diner_tpu_torch.predict --config
    configs/evaluate_diner_on_multiface.yaml`` (``data`` on the fabricated
    subject, whose depth and mask PNGs ``preprocess_multiface`` wrote) at
    the config's full width (ResNet34 with the 64 px ring, ResnetFC 5 ×
    512, 40 of 1000 samples, 15 Gaussians, white background, 4 source
    views at 256×160) renders and scores ``MF_RENDERS`` images from a
    seeded reference Lightning ``.ckpt``. Checks: the source depths the
    loader gives DINER are the PNGs decoded and resized; the loaded weights
    are the checkpoint's; 4 files per sample; finite scores; kernels A and
    C per image as ``make_eval_step`` launches them (A once and C 6 times
    per ray chunk), B, the DCN backward, the kNN and R never."""
    from diner_tpu_torch import predict
    from diner_tpu_torch.data.io import read_depth_png, resize_nearest
    from diner_tpu_torch.data.multiface import MultifaceDataset
    from diner_tpu_torch.train import diner
    from diner_tpu_torch.train.config import load_train_config

    cfg_path = multiface_config(root, split)
    run_cfg = load_train_config(cfg_path)
    dcfg = run_cfg.diner
    ds = MultifaceDataset(root, "val", split_config=split, downsample=8)
    sample = ds[0]
    H, W = sample["target_rgb"].shape[:2]
    meta = ds.metas[0]
    srcs_equal = all(np.array_equal(
        sample["src_depths"][j, ..., 0],
        resize_nearest(read_depth_png(
            root / MF_SUBJECT / "depths" / MF_SEQ / sid /
            f"{MF_FRAMES[0]}.png"), H, W))
        for j, sid in enumerate(meta["ref_ids"][2:]))
    batch = {k: v[None] for k, v in sample.items()
             if isinstance(v, np.ndarray)}
    ckpt = MF_DIR / "DINER.ckpt"
    weights = lightning_checkpoint(dcfg, batch, ckpt)
    n_chunks = -(-H * W // dcfg.renderer.ray_chunk)
    expected = (n_chunks, 0, 6 * n_chunks, 0, 0, 0)

    make_eval = diner.make_eval_step
    calls, models = [], []

    def spied_make_eval(model, cfg, *args, **kwargs):
        models.append(model)
        step = make_eval(model, cfg, *args, **kwargs)

        def timed(*a, **k):
            before = read_counts()
            out = step(*a, **k)
            torch.cuda.synchronize()
            calls.append((tuple(x - y for x, y in zip(read_counts(),
                                                      before)),
                          time.perf_counter()))
            return out
        return timed

    out = MF_DIR / "predict"
    diner.make_eval_step = spied_make_eval
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    try:
        t0 = time.perf_counter()
        scores = predict.main(["--config", str(cfg_path), "--ckpt",
                               str(ckpt), "--out", str(out), "--n",
                               str(MF_RENDERS), "--device", "cuda"])
        t_cli = time.perf_counter() - t0
    finally:
        diner.make_eval_step = make_eval
    launches = read_counts()
    loaded = models[0].state_dict()
    same = all(torch.equal(loaded[k].cpu(), weights[reference_key(k)])
               for k in loaded)
    files, suffixes = folder_files(out)
    ends = [t0] + [c[1] for c in calls]
    emit("multiface_render", nvidia_smi=smi,
         config="configs/evaluate_diner_on_multiface.yaml, data: the "
         "fabricated multiface subject (16 ring cameras, 2048×1334, depth "
         "from preprocess_multiface), reference Lightning .ckpt",
         H=H, W=W, n_samples=dcfg.renderer.n_samples,
         n_gaussian=dcfg.renderer.n_gaussian, src_views=len(
             meta["ref_ids"][2:]), src_depths_are_the_pngs=srcs_equal,
         loaded_bit_for_bit=same, images=len(calls), cli_s=t_cli,
         s_per_image=[b - a for a, b in zip(ends, ends[1:])],
         launches=launches, launches_per_image=[c[0] for c in calls],
         expected_launches_per_image=expected, scores=scores,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    check((H, W) == tuple(int(n / 8 // 32 * 32) for n in RASTER_HW)
          and len(meta["ref_ids"][2:]) == 4,
          f"multiface sample {H}×{W}, {meta['ref_ids']}")
    check(srcs_equal, "the source depths DINER reads are not the PNGs")
    check(same, "the loaded weights are not the checkpoint's")
    check(len(files) == MF_RENDERS and all(v == suffixes
                                           for v in files.values()),
          f"prediction folder {files}")
    check(all(np.isfinite(v) for v in scores.values()), f"scores {scores}")
    check(len(calls) == MF_RENDERS and all(c[0] == expected for c in calls),
          f"launches per image {[c[0] for c in calls]}, expected "
          f"{expected}")
    return launches


def phase_mvs_multiface(smi, root, split4):
    """``python -m diner_tpu_torch.mvs --dataset multiface --mode train
    --max-steps 2`` (a subprocess, ``MVS_TRAIN_CLI``) at the CLI's defaults
    (base_channels 8, ndepths 48/32/8, 192 hypotheses, 4 views, the
    loader's 1/8: 256×160) on the fabricated subject, 4 reference centres.
    Checks: finite losses, no step skipped, kernel C and the DCN backward
    per step as ``mvs_train_launches`` derives them, the peak within
    ``MEMORY_SHARE_LIMIT`` of the card."""
    from diner_tpu_torch.mvs.model import TransMVSNetConfig
    logdir = MF_DIR / "mvs"
    total_mem = torch.cuda.get_device_properties(0).total_memory
    r = run_mvs_train_cli(["--mode", "train", "--dataset", "multiface",
                           "--trainpath", root, "--split_config", split4,
                           "--logdir", logdir, "--max-steps", MF_MVS_STEPS,
                           "--device", "cuda"])
    recs = r["records"]
    per_c, per_d = mvs_train_launches(TransMVSNetConfig(), 4)
    expected = [0, 0, per_c * MF_MVS_STEPS, per_d * MF_MVS_STEPS, 0, 0]
    s = [x["s"] for x in recs]
    emit("mvs_multiface", nvidia_smi=smi, steps=len(recs),
         losses=[x["loss"] for x in recs], s_per_step=s,
         skipped=sum(x["skipped"] for x in recs),
         time_to_first_step_s=r["step_seconds_from_start"][0],
         wall_s=r["wall_s"], peak_mem_bytes=r["peak"],
         launches=r["launches"], expected_launches=expected)
    check(len(recs) == MF_MVS_STEPS and all(
        np.isfinite(x["loss"]) and x["skipped"] == 0 for x in recs),
        f"mvs_multiface records {recs}")
    check(r["launches"] == expected, f"mvs_multiface launches "
          f"{r['launches']}, expected {expected}")
    check(r["peak"] <= MEMORY_SHARE_LIMIT * total_mem,
          f"mvs_multiface peak {r['peak']} B")
    return tuple(r["launches"])


def textured_view(rng, verts, faces, K, E, H, W, device):
    """One raw view of the head mesh (mm) through the pinhole K, [R | t]:
    a smooth colour field of the surface's world point (so every view sees
    one texture), shifted by this view's own affine colour gain and
    offset (a camera's colour response), on a seeded smooth background →
    (H, W, 3) uint8. The depth comes from kernel R."""
    from diner_tpu_torch.ops import rasterize_cuda as rc
    uv, z = rc.project(*(torch.as_tensor(np.asarray(a, np.float32),
                                         device=device)
                         for a in (verts, K, E)))
    depth = rc.rasterize(uv, z, torch.as_tensor(faces, device=device), H,
                         W).cpu().numpy().astype(np.float64)
    y, x = np.mgrid[0:H, 0:W] + 0.5
    cam = np.stack([(x - K[0, 2]) / K[0, 0] * depth,
                    (y - K[1, 2]) / K[1, 1] * depth, depth], -1)
    world = (cam - E[:, 3]) @ E[:, :3]  # R^T (x_cam − t)
    freq = np.array([[0.031, 0.017, -0.023], [-0.014, 0.029, 0.021],
                     [0.019, -0.026, 0.015]])  # rad / mm
    tex = 0.45 + 0.15 * np.sin(world @ freq.T + [0.3, 1.9, 4.1])
    gain = rng.uniform(0.92, 1.08, 3)
    offset = rng.uniform(-0.03, 0.03, 3)
    img = smooth_image(rng, H, W).astype(np.float64) / 255
    img = np.where(depth[..., None] > 0, tex * gain + offset, img)
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


def write_facescape_raw(device="cuda"):
    """A fabricated raw FaceScape subject under ``FS_DIR``: pose
    ``1_neutral`` with ``FS_VIEWS`` views at 2048×1334 (JPEG,
    ``textured_view``: one texture seen through a per-view affine colour
    shift, which the colour calibration fits and corrects) on a ring
    around the head mesh (binary PLY, mm, at the origin), small
    distortions, and an identity ``Rt_scale_dict.json`` → (raw subject
    dir, rt_scale path)."""
    from PIL import Image
    shutil.rmtree(FS_DIR, ignore_errors=True)
    raw = FS_DIR / "RAW" / "1"
    pose = raw / "1_neutral"
    pose.mkdir(parents=True)
    H, W = RASTER_HW
    cams = ring_cameras(8, target=(0.0, 0.0, 0.0))
    params = {}
    rng = np.random.RandomState(7)
    verts, faces = head_mesh(0, centre=(0.0, 0.0, 0.0))
    for i, (K, E) in enumerate(list(cams.values())[:FS_VIEWS]):
        params.update({f"{i}_K": K.tolist(), f"{i}_Rt": E.tolist(),
                       f"{i}_distortion": [0.01, -0.002, 0.0005, 0.0003, 0.0],
                       f"{i}_width": W, f"{i}_height": H, f"{i}_valid": True})
        Image.fromarray(textured_view(rng, verts, faces, K, E, H, W,
                                      device)).save(pose / f"{i}.jpg",
                                                    quality=90)
    (pose / "params.json").write_text(json.dumps(params))
    with open(raw / "1_neutral.ply", "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n"
                + f"element vertex {len(verts)}\n".encode()
                + b"property float x\nproperty float y\nproperty float z\n"
                + f"element face {len(faces)}\n".encode()
                + b"property list uchar int vertex_indices\nend_header\n")
        rec = np.zeros(len(faces), [("n", "u1"), ("idx", "<i4", 3)])
        rec["n"] = 3
        rec["idx"] = faces
        f.write(verts.astype("<f4").tobytes() + rec.tobytes())
    rt_scale = FS_DIR / "Rt_scale_dict.json"
    rt_scale.write_text(json.dumps(
        {"1": {"1": [1.0, [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]]]}}))
    return raw, rt_scale


def facescape_readback(out):
    """The written views through the port's ``FacescapeDataset`` (DINER,
    ``depth_type="mesh"``): each view gets the dataset's file names (the
    calibrated image, else ``rgba.png``, as ``rgba_colorcalib_v2.png``;
    ``depth.png`` as ``depth_mesh.png`` and as each third of the triptych)
    and a split of one val meta (target 0, sources 1 and 2) → whether the
    sample's source images and depths are the written PNGs."""
    from PIL import Image

    from diner_tpu_torch.data.facescape import (DEPTH_FNAME,
                                                DEPTH_MESH_FNAME,
                                                FacescapeDataset,
                                                RGBA_FNAME, read_rgba)
    from diner_tpu_torch.data.io import DEPTH_PNG_SCALE
    scan = out / "01"
    for view in sorted(scan.glob("view_*")):
        calib = view / "rgba_colorcalib.png"
        shutil.copy(calib if calib.exists() else view / "rgba.png",
                    view / RGBA_FNAME)
        depth = np.asarray(Image.open(view / "depth.png"))
        shutil.copy(view / "depth.png", view / DEPTH_MESH_FNAME)
        Image.fromarray(np.concatenate([depth] * 3, axis=1)).save(
            view / DEPTH_FNAME)
    split_dir = FS_DIR / "splits"
    split_dir.mkdir(exist_ok=True)
    (split_dir / "val_metas_binocular.txt").write_text(json.dumps([{
        "scan_path": f"{out.name}/01", "targets_val": ["0"],
        "l_refs_val": ["1"], "r_refs_val": ["2"]}]))
    ds = FacescapeDataset(out.parent, "val", depth_type="mesh",
                          split_dir=split_dir, n_repeat=1)
    s = ds[0]
    ok = s["src_rgbs"].shape == (2, FS_CROP, FS_CROP, 3)
    for j, vid in enumerate((1, 2)):
        view = scan / f"view_{vid:05d}"
        rgb, _ = read_rgba(view / RGBA_FNAME)
        depth = np.asarray(Image.open(view / "depth.png")).astype(
            np.float32) * DEPTH_PNG_SCALE
        ok &= np.array_equal(s["src_rgbs"][j], rgb)
        ok &= np.array_equal(s["src_depths"][j, ..., 0], depth)
    return bool(ok)


def facescape_view_breakdown(raw, out):
    """Host seconds of each step of one raw FaceScape view as
    ``process_pose`` takes it (view 0), and of the whole colour
    calibration of the written scan (which writes its images again)."""
    from PIL import Image

    from diner_tpu_torch.preprocessing import facescape_pipeline as fp
    pose = raw / "1_neutral"
    cam = json.loads((pose / "params.json").read_text())
    K = np.asarray(cam["0_K"], np.float64)
    t = [time.perf_counter()]

    def lap():
        torch.cuda.synchronize()
        t.append(time.perf_counter())
    verts, faces = fp.load_ply(raw / "1_neutral.ply")
    lap()
    rgb = np.asarray(Image.open(pose / "0.jpg"), np.float64)[..., :3] / 255
    lap()
    rgb = fp.undistort_image(rgb, K, np.asarray(cam["0_distortion"]))
    lap()
    E = np.asarray(cam["0_Rt"], np.float32)
    fp.rasterize_depth(verts, faces, K.astype(np.float32), E, *RASTER_HW,
                       device="cuda").cpu().numpy()
    lap()
    fp.area_resize(rgb[:RASTER_HW[1]], FS_CROP)
    lap()
    # the mesh as process_pose hands it to the calibration (the identity
    # alignment: the capture-studio axes, mm → m)
    verts = (verts @ fp.FACESCAPE_2_CAPSTUDIO.T / 1000).astype(np.float32)
    fp.calibrate_colors_scan(out / "01", verts, faces, device="cuda")
    lap()
    names = ("ply_read_s", "jpeg_decode_s", "undistort_s", "rasterize_s",
             "crop_resize_s", "calibration_s")
    return {n: b - a for n, a, b in zip(names, t, t[1:])}


def phase_preprocess_facescape(smi):
    """``python -m diner_tpu_torch.preprocess_facescape --crop_out 256`` on
    a fabricated raw subject (``FS_VIEWS`` views at 2048×1334, a 50,400-face
    PLY scan): undistortion, kernel R at each view's raw size, the
    silhouette crop and resize, then the colour calibration (kernel R at
    the crop size, kernel C under ``collect_vertex_colors``, the affine
    fit and the corrected images). Checks: R once per view at the raw
    size and once per view in the calibration, C ``FS_C_PER_VIEW`` times
    per view, no other kernel; every view written; the calibration passed
    at least one view through its gate and corrected it (its
    ``rgba_colorcalib.png`` is not ``rgba.png``); the views read back
    through ``FacescapeDataset``."""
    from PIL import Image

    from diner_tpu_torch.preprocess_facescape import main
    raw, rt_scale = write_facescape_raw()
    out = FS_DIR / "OUT" / "001"
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    done = main(["--dir_in", str(raw), "--dir_out", str(out), "--rt_scale",
                 str(rt_scale), "--crop_out", str(FS_CROP), "--device",
                 "cuda"])
    cli_s = time.perf_counter() - t0
    launches = read_counts()
    expected = (0, 0, FS_C_PER_VIEW * FS_VIEWS, 0, 0,
                2 * FS_VIEWS * RASTER_LAUNCHES_PER_CALL)
    views = sorted(p.name for p in (out / "01").glob("view_*"))
    calibrated = sorted(p.parent.name for p in
                        (out / "01").glob("view_*/rgba_colorcalib.png"))
    corrected = [v for v in calibrated if not np.array_equal(
        *(np.asarray(Image.open(out / "01" / v / f)) for f in
          ("rgba_colorcalib.png", "rgba.png")))]
    cams = json.loads((out / "01" / "cameras.json").read_text())
    breakdown = facescape_view_breakdown(raw, out)
    readback = facescape_readback(out)
    emit("preprocess_facescape", nvidia_smi=smi, raw_H=RASTER_HW[0],
         raw_W=RASTER_HW[1], crop_out=FS_CROP, views=views,
         calibrated=calibrated, corrected=corrected, poses=done, cli_s=cli_s,
         s_per_pose=cli_s / len(done), launches=launches,
         expected_launches=expected, one_view_breakdown=breakdown,
         readback_equal=readback,
         peak_mem_bytes=torch.cuda.max_memory_allocated())
    check(done == {"1_neutral": True}, f"poses {done}")
    check(len(views) == FS_VIEWS and sorted(cams, key=int) == [
        str(i) for i in range(FS_VIEWS)], f"views {views}, cameras {cams}")
    check(launches == expected, f"preprocess_facescape launches {launches}, "
          f"expected {expected}")
    check(len(corrected) > 0, f"the colour calibration corrected no view: "
          f"calibrated {calibrated}")
    check(readback, "FacescapeDataset does not read back the written views")
    return launches


def phases_preprocessing(smi, mf_root, split6, split4, plain_map):
    """The preprocessing and multiface phases after ``kernel_rasterize``
    → their launches by path."""
    out = {"preprocess_multiface": phase_preprocess_multiface(
        smi, mf_root, plain_map)}
    torch.cuda.empty_cache()
    out["multiface_render"] = phase_multiface_render(smi, mf_root, split6)
    torch.cuda.empty_cache()
    out["mvs_multiface"] = phase_mvs_multiface(smi, mf_root, split4)
    torch.cuda.empty_cache()
    out["preprocess_facescape"] = phase_preprocess_facescape(smi)
    shutil.rmtree(MF_DIR, ignore_errors=True)
    shutil.rmtree(FS_DIR, ignore_errors=True)
    return out


def clean_outputs():
    """Delete what the phases wrote under ``OUT_DIR`` but its logs (the
    JSON log and the profile tables)."""
    for p in OUT_DIR.iterdir():
        if p.is_dir():
            shutil.rmtree(p, ignore_errors=True)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this run needs an "
                         "NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = phase_device()
    build_s = phase_build()
    rows = phase_kernel()
    bwd_rows = phase_kernel_bwd()
    gather_rows = phase_kernel_gather()
    dcn_rows = phase_kernel_dcn_bwd()
    knn_rows = phase_kernel_knn()
    mf_root, mf_split6, mf_split4 = write_multiface_subject()
    raster_rows, raster_plain_map = phase_kernel_rasterize(mf_root)
    eval_l, ev = phase_path()
    pairs_l = phase_path_pairs(ev)
    pruned_l = phase_path_pruned(ev)
    del ev
    torch.cuda.empty_cache()
    phase_small_reference()
    train_l, state, vgg, b = phase_train_path()
    phase_train_grad_f32(state, vgg, b)
    parallel_l, parallel_cli_l = phase_parallel_train(state, vgg, b)
    del state, vgg, b
    torch.cuda.empty_cache()
    train_pruned_l = phase_train_path(pruned=True)[0]
    torch.cuda.empty_cache()
    phase_train_small_reference()
    phase_train_small_reference(pruned=True)
    torch.cuda.empty_cache()
    predict_l, folder = phase_predict(smi, build_s)
    phase_pretrained(folder)
    torch.cuda.empty_cache()
    novel_l = phases_novel(smi)
    torch.cuda.empty_cache()
    kpn_l = phases_keypointnerf(smi)
    torch.cuda.empty_cache()
    prep_l = phases_preprocessing(smi, mf_root, mf_split6, mf_split4,
                                  raster_plain_map)
    torch.cuda.empty_cache()
    mvs_l, mvs_gather_rows = phases_mvs(smi)
    torch.cuda.empty_cache()
    train_loop_l = phase_train_loop()
    clean_outputs()

    paths = {"eval_render": eval_l, "eval_render_pairs": pairs_l,
             "eval_render_pruned": pruned_l, "train_steps": train_l,
             "train_steps_pruned": train_pruned_l,
             "parallel_train": parallel_l,
             "train_cli_mesh": parallel_cli_l,
             "predict": predict_l["nsamples64"],
             "predict_nsamples32": predict_l["nsamples32"],
             **novel_l, **kpn_l, **prep_l, **mvs_l,
             "train_loop": train_loop_l}

    def entry(name, row_list, main, replaces, which, library_ms=None):
        # launches per path: (A, B, C, DCN backward, kNN, R)
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

    knn_main = next(r for r in knn_rows if r["case"] == "render_chunk")
    dcn_f32 = next(r for r in dcn_rows if r["case"] == "tap_stage3"
                   and r["dtype"] == "torch.float32")
    # kernel C's row: one eval latent corner (the path's largest gather
    # by bytes, 320 of an image's 480 launches); every timed case beside it
    corner = next(r for r in gather_rows
                  if r["case"] == "latent_corner_c512_bf16")
    raster_main, raster_dense = (next(r for r in raster_rows
                                      if r["case"] == c)
                                 for c in ("multiface_head", "dense_head"))
    raster_timed_keys = ("plain_timing", "bin_entries", "large_faces",
                         "occupied_tiles", "tiles", "pairs_in_boxes",
                         "pairs_after_cull", "dense_pairs", "dense_bound_ms")
    timed = ("ms", "call_ms", "plain_ms", "library_ms", "bound_ms")
    tl_R, tl_K = train_loop_composite_shape()

    def train_loop_case(row_list, *errs):
        """Kernel A's or B's largest errors at the train loop's shape."""
        at = [r for r in row_list if (r["R"], r["K"]) == (tl_R, tl_K)]
        return {"R": tl_R, "K": tl_K, "checks": len(at),
                **{e: max(r[e] for r in at) for e in errs}}

    kernels = [
        dict(entry("composite_fwd", rows,
                   next(r for r in rows if (r["R"], r["K"]) == (4096, 64)
                        and "ms" in r),
                   "diner_tpu/ops/pallas/composite_pallas.py:29", 0),
             cases=[{k: r[k] for k in ("R", "K") + timed if k in r}
                    for r in rows if "ms" in r],
             train_loop_case=train_loop_case(rows, "max_abs_err")),
        # the train step's case: R = 4096, K = 40, only g_rgb
        dict(entry("composite_bwd", bwd_rows,
                   next(r for r in bwd_rows if "ms" in r
                        and not r["g_depth_and_g_w"]),
                   "diner_tpu/ops/pallas/composite_pallas.py:54", 1),
             err_d_sigma_over_scale={
                 pattern: max(r["err_d_sigma_over_scale"] for r in bwd_rows
                              if r["pattern"] == pattern)
                 for pattern in BWD_PATTERNS},
             train_loop_case=train_loop_case(bwd_rows, "err_d_rgb",
                                             "err_d_sigma_over_scale")),
        dict(entry("row_gather", gather_rows, corner,
                   "diner_tpu/ops/pallas/gather_pallas.py:45", 2,
                   library_ms=corner["library_ms"]),
             main_case=corner["case"],
             cases=[{k: r[k] for k in ("case", "regime", "unit_bytes", "C",
                                       "P") + timed}
                    for r in gather_rows if "ms" in r],
             launches_per_keypointnerf_step=paths["keypointnerf_train"][2]
             / KPN_WARM_STEPS,
             launches_per_keypointnerf_image=paths["keypointnerf_render"][2]
             / KPN_RENDERS,
             path_cases=[{k: r[k] for k in ("config", "call", "kind", "P",
                                            "distinct_rows", "ms_cold_l2",
                                            "library_ms_cold_l2") + timed}
                         for r in LOG if r["phase"] == "gather_path"],
             mvs_cases=[{k: r[k] for k in ("case", "regime", "C", "P",
                                           "distinct_rows", "ms_cold_l2",
                                           "library_ms_cold_l2") + timed}
                        for r in mvs_gather_rows]),
        # the stage-3 training tap in f32; every case's errors beside it
        dict(entry("dcn_sample_bwd", dcn_rows, dcn_f32,
                   "diner_tpu/mvs/dcn.py:81", 3),
             library_ms_note="no single PyTorch call computes this "
             "backward (torchvision's deform_conv2d is not installed); "
             "autograd of the corner gathers at the same tap beside it",
             autograd_bwd_ms=dcn_f32["autograd_bwd_ms"],
             function_fwd_bwd_ms=dcn_f32["function_fwd_bwd_ms"],
             autograd_fwd_bwd_ms=dcn_f32["autograd_fwd_bwd_ms"],
             launches_per_step=paths["mvs_train_f32"][3] / MVS_TRAIN_STEPS,
             launches_per_call=DCN_BWD_LAUNCHES_PER_CALL,
             spill_share=dcn_f32["spill_share"],
             cases=[{k: r[k] for k in ("case", "design", "dtype", "H", "W",
                                       "C", "with_scale", "err_d_img_f32",
                                       "err_d_xy_scale", "spill_share")
                     + timed if k in r}
                    for r in dcn_rows]),
        # the train step's sampler shape (4,096 rays × 1,000 candidates on
        # 26,317 vertices) on ray-ordered points, as the path makes them;
        # the uniform cube and deform_points' shape beside it
        dict(entry("knn1", knn_rows, knn_main, "diner_tpu/ops/knn.py:16",
                   4, library_ms=knn_main["library_ms"]),
             main_case=knn_main["case"],
             tiles_culled=knn_main["tiles_culled"],
             tested_pairs=knn_main["tested_pairs"],
             tested_pairs_ms=knn_main["tested_pairs_ms"],
             brute_force_ms=knn_main["brute_force_ms"],
             library_ms_note="no single PyTorch call computes a top-1 "
             "index: torch.cdist(points, vertices).argmin(-1) in the plain "
             "version's 2,048-point chunks; at the sampler's shape plain_ms "
             "and library_ms are 1 call between CUDA events, not a graph; "
             "bound_ms is the larger of the bytes (points, vertices and "
             "indices once) and one point-vertex test a point, from the "
             "inputs alone; tested_pairs_ms is the tests the kernel made "
             "(tiles it did not cull, and the representatives) at the FP32 "
             "rate and brute_force_ms every pair's, neither a bound",
             launches_per_step={p: paths[p][4] / NOVEL_WARM_STEPS
                                for p in ("novel_train", "novel_pe_train")},
             index_disagreements=sum(r["index_disagreements"]
                                     for r in knn_rows),
             distance_gap=max(r.get("distance_gap", 0.0) for r in knn_rows),
             cases=[{k: r[k] for k in (
                 "case", "SB", "N", "V", "index_disagreements",
                 "distance_gap", "deformed_max_abs_err", "plain_timing",
                 "tiles_culled", "tested_pairs", "tested_pairs_ms",
                 "brute_force_ms")
                 + timed if k in r} for r in knn_rows]),
        # the multiface frame (2048×1334, 50,400 faces); the dense-mesh
        # case, the pole-free head at both sizes and the edge cases'
        # exactness beside it
        dict(entry("rasterize_depth", raster_rows, raster_main,
                   "diner_tpu/preprocessing/rasterize.py:24", 5),
             main_case=raster_main["case"],
             library_ms_note="no PyTorch call computes a z-buffer",
             launches_per_call=RASTER_LAUNCHES_PER_CALL,
             launches_per_multiface_map=paths["preprocess_multiface"][5]
             / (MF_CAMS * len(MF_FRAMES)),
             **{k: raster_main[k] for k in raster_timed_keys},
             dense_mesh_case={k: raster_dense[k] for k in (
                 "case", "V", "F", "ms", "call_ms", "plain_ms", "bound_ms",
                 "bound_by") + raster_timed_keys},
             pole_free_cases=[{k: r[k] for k in (
                 "case", "V", "F", "ms", "call_ms", "plain_ms", "bound_ms",
                 "bound_by") + raster_timed_keys}
                 for r in raster_rows if r["case"].startswith("cube_")],
             cases=[{k: r[k] for k in ("case", "H", "W", "F", "exact",
                                       "covered", "bin_entries",
                                       "large_faces")}
                    for r in raster_rows]),
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
