"""Traffic driver ``render_images``: the program's full-image eval step
(``make_eval_step``) on whole target images, back to back.

A pool of scenes is made on the card from the seed; image ``i`` renders
scene ``i`` of the pool in turn with its own whole-image noise, drawn on
the card from a generator seeded by (seed, i). Set-up renders image 0; the
window renders images 1, 2, ... until ``--seconds`` have passed and the
image in flight completes. With ``--trace 1`` one image runs under the
profiler instead, then the benchmark's spans around one image's sampler
and field calls.

``correct``: once the window has closed and the program is freed, one of
the window's images, drawn from the seed, is rendered again by the plain
reference in float32 with TF32 off from the same scene, weights and
noise; the mean absolute gap of its colour and that of its depth over
the reference depth's spread are compared with their limits.

``FAULTS`` are the faults a render cell can have (``benchmark/faults.py``)
and ``calibrate`` the readings its limits are set from
(``benchmark/calibrate.py``).
"""

from __future__ import annotations

import random
import sys
import time

import torch

from benchmark import faults, flops, harness, weights
from benchmark.reference import precision
from benchmark.reference import steps as ref_steps
from benchmark.traffic import sphere


def make_scenes(cell, seed: int, device) -> list:
    gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, 1))
    return [sphere.make_scenes(cell.config, cell.traffic, 1, gen, device)
            for _ in range(cell.traffic["pool"])]


def image_noise(cell, seed: int, i: int, device):
    H, W = cell.config["image_hw"]
    gen = torch.Generator(device=device).manual_seed(
        harness.sub_seed(seed, 100 + i))
    return sphere.renderer_noise(cell.config["render"]["renderer"], 1, H * W,
                                 gen, device)


def build_program(cell, seed: int, device):
    c = cell.config
    from diner_tpu_torch.train.diner import make_eval_step
    cfg, model = cell.family.program(c, "render", device)
    model.load_state_dict(weights.draw(model.state_dict(),
                                       harness.sub_seed(seed, 2), device))
    step = make_eval_step(model, cfg, use_running_stats=not c["render"][
        "batch_statistics"])
    return cfg, model, step


def reference_image(cell, seed: int, scene, noise, device, spec=None):
    """The reference's (rgb, depth) of one image, in float32 with TF32
    off or in the precision ``spec`` states."""
    c = cell.config
    spec = spec or {}
    rounding = precision.fp8 if spec.get("gemm_inputs") == "fp8" else None
    with precision.tf32(spec.get("tf32", False)), \
            precision.gemm_inputs(rounding):
        model, rcfg = cell.family.reference(
            c, "render", device, spec.get("compute_dtype", "float32"))
        model.load_state_dict(weights.draw(
            model.state_dict(), harness.sub_seed(seed, 2), device))
        return ref_steps.render_image(model, rcfg, c["znear"], c["zfar"],
                                      scene, noise)


def compare(cell, prog, ref) -> dict:
    """The mean absolute gap of the colour, and of the depth over the
    reference depth's mean absolute deviation (its spread across the
    image: how opaque a field is sets the depth's scale)."""
    (rgb, depth), (rgb_r, depth_r) = ([t.float().cpu() for t in x]
                                      for x in (prog, ref))
    spread = (depth_r - depth_r.mean()).abs().mean()
    return {
        "rgb": float((rgb - rgb_r).abs().mean()),
        "depth": float((depth - depth_r).abs().mean() / spread.clamp_min(
            1e-12)),
    }


def run(cell, args, t_start: float, device="cuda") -> dict:
    c = cell.config
    harness.set_tf32(cell)
    H, W = c["image_hw"]
    scenes = make_scenes(cell, args.seed, device)
    cfg, model, step = build_program(cell, args.seed, device)
    P = len(scenes)

    def image(i):
        return step(scenes[i % P], noise=image_noise(cell, args.seed, i,
                                                     device))

    image(0)
    torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t_start}
    images = []
    if not args.trace:
        with harness.Window() as w:
            while True:
                images.append(image(len(images) + 1))
                if w.elapsed() >= args.seconds:
                    break
        out["image_px_per_s"] = len(images) * H * W / w.seconds
        peak = torch.cuda.max_memory_allocated()
        ctx = None
    else:
        n = cell.traffic["trace_images"]
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        trace = harness.profile(lambda i: images.append(image(i + 1)), n)
        traced_peak = torch.cuda.max_memory_allocated()
        peak = max(peak, traced_peak)
        rc = c["render"]["renderer"]
        chunk = rc["ray_chunk"]
        noise = image_noise(cell, args.seed, 1, device)
        spans = {k: harness.span_ms(fn, runs=1)
                 for k, fn in cell.family.image_spans(
                     cfg, model, scenes[1 % P], lambda j: tuple(
                         None if t is None else
                         t[:, j * chunk:(j + 1) * chunk] for t in noise)
                 ).items()}
        del noise
        ctx = dict(kind="image", cell=cell, trace=trace, units=n,
                   px_per_unit=H * W, flops_per_unit=flops.image(c),
                   peak_bytes=traced_peak, spans=spans, peaks=harness.peaks())
    attempted = len(images)
    failed = sum(not bool(torch.isfinite(rgb).all() & torch.isfinite(d).all())
                 for rgb, d in images)
    j = random.Random(harness.sub_seed(args.seed, 5)).randrange(attempted)
    prog = tuple(t.cpu() for t in images[j])
    del step, model, images
    harness.free()
    ref = reference_image(cell, args.seed, scenes[(j + 1) % P],
                          image_noise(cell, args.seed, j + 1, device),
                          device)
    return dict(out=out, attempted=attempted, failed=failed, peak=peak,
                readings=compare(cell, prog, ref), trace_ctx=ctx)


# ---------------------------------------------------------------- faults

def half_image(mp):
    """The eval step's lower half of the image left black, depth 0."""
    build = build_program

    def broken(*a, **k):
        cfg, model, step = build(*a, **k)

        def half(*b, **kw):
            rgb, depth = step(*b, **kw)
            H = rgb.shape[1]
            return (torch.cat([rgb[:, :H // 2], 0 * rgb[:, H // 2:]], 1),
                    torch.cat([depth[:, :H // 2], 0 * depth[:, H // 2:]], 1))
        return cfg, model, half
    mp.setattr(sys.modules[__name__], "build_program", broken)


FAULTS = (faults.answer_altered, half_image)


# ---------------------------------------------------------------- calibrate

def calibrate(cell, seed: int, opts, device="cuda") -> dict:
    """The readings of one seed (``benchmark/calibrate.py``) on the
    window's first image: the program's against the reference, and with
    ``opts`` the control's, the bfloat16 witness's and each planted
    fault's; ``opts.dump`` adds statistics of the gaps."""
    harness.set_tf32(cell)
    scenes = make_scenes(cell, seed, device)
    scene = scenes[1 % len(scenes)]
    noise = image_noise(cell, seed, 1, device)

    def program():
        _, _, step = build_program(cell, seed, device)
        got = tuple(t.cpu() for t in step(scene, noise=noise))
        del step
        harness.free()
        return got

    prog = program()
    planted = {}
    for fault in (FAULTS if opts.faults else ()):
        with faults.planted(fault):
            planted[fault.__name__] = program()
    ref = tuple(t.cpu() for t in reference_image(cell, seed, scene, noise,
                                                  device))
    harness.free()
    out = {"program": compare(cell, prog, ref)}
    if opts.dump:
        out["program_stats"] = image_stats(prog, ref)
    for name, spec in (("control", cell.config["control"] if opts.control
                        else None),
                       ("witness", harness.WITNESS if opts.witness
                        else None)):
        if spec is not None:
            got = reference_image(cell, seed, scene, noise, device, spec)
            harness.free()
            out[name] = compare(cell, got, ref)
            if opts.dump:
                out[name + "_stats"] = image_stats(got, ref)
    for name, got in planted.items():
        out["fault_" + name] = compare(cell, got, ref)
    return out


def image_stats(got, ref) -> dict:
    """Statistics of an image's gaps, what a look at a reading starts
    from."""
    out = {}
    for name, a, b in (("rgb", got[0], ref[0]), ("depth", got[1], ref[1])):
        a, b = a.float().cpu().flatten(), b.float().cpu().flatten()
        d = (a - b).abs()
        q = torch.quantile(d[torch.randperm(d.numel())[:1_000_000]],
                           torch.tensor([0.5, 0.9, 0.99]))
        out[name] = dict(mae=float(d.mean()), q50=float(q[0]),
                         q90=float(q[1]), q99=float(q[2]),
                         max=float(d.max()),
                         ref_spread=float((b - b.mean()).abs().mean()),
                         ref_mean=float(b.mean()))
    return out
