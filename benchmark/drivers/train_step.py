"""Traffic driver ``train_step``: the program's training step, fed from a
pool of batches made on the card from the seed.

Set-up builds the step once (the benchmark's weights, Adam), and drives it
through its first three steps on the pool's first three feeds: those are
the warm-up, and the steps the reference follows. The window then calls
the same step on the pool's feeds in turn until ``--seconds`` have passed
and the step in flight completes; it synchronises only there. With
``--trace 1`` a few steps run under the profiler instead, then the
benchmark's own spans around the layers' calls.

``correct``: once the window has closed and the program is freed, the
plain reference (``benchmark/reference``) takes the same weights and the
same three feeds, in float32 with TF32 off. The numbers: the first
step's loss, and its worst term (MSE, VGG, antibias); the patch of
colours the first step rendered, by the mean absolute gap (read where the
loss takes it: the input of the perceptual loss's VGG); the first step's
gradient as Adam holds it, by the median leaf's gap of norms; each
parameter's change over the three steps, by the worst leaf's (leaves
whose reference gradient is under a thousandth of the median leaf's left
out: Adam moves them by rounding alone); and each batch-norm statistic's
change in the first step, by the worst one. A cell's limits file names
those it compares; PERF.md gives the readings each limit was set from,
and why a number is left out.

``FAULTS`` are the faults a training cell can have (``benchmark/faults.py``)
and ``calibrate`` the readings its limits are set from
(``benchmark/calibrate.py``).
"""

from __future__ import annotations

import statistics
import sys
import time

import torch

from benchmark import faults, flops, harness, weights
from benchmark.reference import precision
from benchmark.reference.nn.spatial_encoder import (IMAGENET_MEAN,
                                                    IMAGENET_STD)
from benchmark.traffic import sphere

FIRST_STEPS = 3
QUIET_GRAD = 1e-3  # a leaf whose gradient is under this share of the median


def make_pool(cell, seed: int, device) -> list:
    c, t = cell.config, cell.traffic
    m = c["train"]
    if not m["w_vgg"]:
        raise ValueError("train_step feeds a VGG patch: w_vgg must be > 0")
    gen = torch.Generator(device=device).manual_seed(harness.sub_seed(seed, 1))
    pool = []
    for _ in range(t["pool"]):
        b = sphere.make_scenes(c, t, m["scenes_per_step"], gen, device)
        pix = sphere.patch_pixels(b["target_alpha"], m["vgg_spatch"], gen)
        noise = sphere.renderer_noise(m["renderer"], pix.shape[0],
                                      pix.shape[1], gen, device)
        pool.append({"batch": b, "pix": pix, "noise": noise})
    return pool


def adam_first_grads(optimizer, model) -> dict:
    """Each leaf's norm of the first step's gradient, from Adam's first
    moment after one step (it holds (1 − β1)·g); 0 for a leaf Adam has not
    stepped."""
    beta1 = optimizer.param_groups[0]["betas"][0]
    state = optimizer.state
    return {n: (float(state[p]["exp_avg"].norm()) / (1 - beta1)
                if p in state else 0.0)
            for n, p in model.named_parameters()}


def first_vgg_input(vgg, seen: list):
    """Hook ``vgg`` so that its first call appends the colours it was
    given, (N, H, W, 3) in [0, 1] (the perceptual loss passes the rendered
    patch ImageNet-normalised, first): the handle to remove it."""
    def hook(_, args):
        if not seen:
            x = args[0].detach().float()
            mean, std = (torch.tensor(v, device=x.device)
                         for v in (IMAGENET_MEAN, IMAGENET_STD))
            seen.append((x * std + mean).cpu())
    return vgg.register_forward_pre_hook(hook)


def follow(model, optimizer, call, pool, vgg) -> dict:
    """Run ``call(feed)`` on the pool's first feeds and read what the
    comparison needs: each step's loss; in the first step the patch it
    rendered, and after it each leaf's gradient and each batch-norm
    statistic's change; after the third each parameter's and statistic's
    change."""
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    s0 = {n: b.detach().clone() for n, b in model.named_buffers()}
    losses, grads, stats, first, patch = [], None, None, None, []
    for i in range(FIRST_STEPS):
        hook = first_vgg_input(vgg, patch) if i == 0 else None
        try:
            metrics = call(pool[i])
        finally:
            if hook is not None:
                hook.remove()
        losses.append(float(metrics["total"]))
        if i == 0:
            first = {k: float(v) for k, v in metrics.items()}
            grads = adam_first_grads(optimizer, model)
            stats = {n: float((b - s0[n]).norm())
                     for n, b in model.named_buffers()}
    return {
        "losses": losses, "first": first, "grads": grads, "stats": stats,
        "patch": patch[0],
        "change": {n: float((p.detach() - p0[n]).norm())
                   for n, p in model.named_parameters()},
        "stats3": {n: float((b - s0[n]).norm())
                   for n, b in model.named_buffers()},
    }


def build_program(cell, seed: int, device):
    c, fam = cell.config, cell.family
    cfg, model = fam.program(c, "train", device)
    model.load_state_dict(weights.draw(model.state_dict(),
                                       harness.sub_seed(seed, 2), device))
    vgg = fam.program_vgg(device)
    vgg.load_state_dict(weights.draw(vgg.state_dict(),
                                     harness.sub_seed(seed, 3), device))
    return cfg, fam.program_step(cfg, model, vgg)


def program_call(step):
    return lambda f: step(f["batch"], noise=f["noise"], pix_idcs=f["pix"])


def reference_readings(cell, seed: int, pool, device, spec=None):
    """The reference's readings on the same weights and feeds, in float32
    with TF32 off, or in the precision ``spec`` states (the configuration's
    ``control``: compute dtype, rounding of the products' inputs, TF32)."""
    c, fam = cell.config, cell.family
    spec = spec or {}
    dtype = spec.get("compute_dtype", "float32")
    rounding = precision.fp8 if spec.get("gemm_inputs") == "fp8" else None
    with precision.tf32(spec.get("tf32", False)), \
            precision.gemm_inputs(rounding):
        model, rcfg = fam.reference(c, "train", device, dtype)
        model.load_state_dict(weights.draw(
            model.state_dict(), harness.sub_seed(seed, 2), device))
        vgg = fam.reference_vgg(device)
        vgg.load_state_dict(weights.draw(vgg.state_dict(),
                                         harness.sub_seed(seed, 3), device))
        opt = torch.optim.Adam(model.parameters(), lr=c["train"]["lr"])
        vgg_dtype = (model.dtype if fam.VGG_IN_COMPUTE_DTYPE
                     else torch.float32)
        block = cell.settings["reference_block_rays"]
        return follow(model, opt, lambda f: fam.reference_train_step(
            model, opt, c, rcfg, f, vgg, block, vgg_dtype), pool, vgg)


def patch_gap(patch, ref) -> float:
    """Mean absolute gap of the rendered patch's colours; a patch of
    another shape (scenes or rays left out) reads 1, every colour
    missing."""
    if patch.shape != ref.shape:
        return 1.0
    return float((patch - ref).abs().mean())


def compare(prog: dict, ref: dict) -> dict:
    """The numbers ``correct`` is decided on (see the module docstring)."""
    med = statistics.median(ref["grads"].values())
    moving = [n for n, g in ref["grads"].items() if g >= QUIET_GRAD * med]
    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-30)

    return {
        "loss": rel(prog["losses"][0], ref["losses"][0]),
        "terms": max(rel(v, ref["first"][k]) for k, v in prog["first"].items()
                     if k != "total"),
        "patch_rgb": patch_gap(prog["patch"], ref["patch"]),
        "grad": harness.median_leaf_gap(prog["grads"], ref["grads"]),
        "change": harness.worst_leaf_gap(prog["change"], ref["change"],
                                         moving)[0],
        "stats": harness.worst_leaf_gap(prog["stats"], ref["stats"])[0],
    }


def unjudged(prog: dict, ref: dict) -> dict:
    """Readings kept beside the comparison but not held to a limit (see
    PERF.md): the worst leaf's first gradient, the median leaf's change,
    the later steps' losses and the statistics after three steps."""
    return {
        "grad_worst_leaf": harness.worst_leaf_gap(prog["grads"],
                                                  ref["grads"])[0],
        "change_median_leaf": harness.median_leaf_gap(prog["change"],
                                                      ref["change"]),
        "loss_steps_2_3": max(abs(a - b) / max(abs(b), 1e-30) for a, b in
                              zip(prog["losses"][1:], ref["losses"][1:])),
        "stats_3": harness.worst_leaf_gap(prog["stats3"], ref["stats3"])[0],
    }


def leaf_report(prog: dict, ref: dict, k: int = 5) -> dict:
    """The ``k`` worst leaves of each per-leaf number, with both norms:
    what a look at a reading starts from."""
    out = {}
    for key in ("grads", "change", "stats", "stats3"):
        med = statistics.median(ref[key].values())
        rows = sorted(((abs(prog[key][n] - r) / max(r, med, 1e-30), n,
                        prog[key][n], r) for n, r in ref[key].items()),
                      reverse=True)[:k]
        out[key] = [[n, g, p, r] for g, n, p, r in rows]
    out["losses"] = [prog["losses"], ref["losses"]]
    out["first"] = [prog["first"], ref["first"]]
    return out


def run(cell, args, t_start: float, device="cuda") -> dict:
    c = cell.config
    m = c["train"]
    harness.set_tf32(cell)
    pool = make_pool(cell, args.seed, device)
    cfg, step = build_program(cell, args.seed, device)
    prog = follow(step.model, step.optimizer, program_call(step), pool,
                  step.vgg)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    px_per_step = m["scenes_per_step"] * m["vgg_spatch"] ** 2
    P = len(pool)
    call = program_call(step)
    out = {"setup_s": setup_s}

    if not args.trace:
        losses = []
        with harness.Window() as w:
            while True:
                losses.append(call(pool[(FIRST_STEPS + len(losses)) % P])
                              ["total"])
                if w.elapsed() >= args.seconds:
                    break
        attempted = len(losses)
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        out["train_px_per_s"] = attempted * px_per_step / w.seconds
        peak = torch.cuda.max_memory_allocated()
        ctx = None
    else:
        n = cell.traffic["trace_steps"]
        peak = torch.cuda.max_memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        losses = []
        trace = harness.profile(
            lambda i: losses.append(call(pool[(FIRST_STEPS + i) % P])
                                    ["total"]), n)
        attempted = n
        failed = int((~torch.isfinite(torch.stack(losses))).sum())
        traced_peak = torch.cuda.max_memory_allocated()
        peak = max(peak, traced_peak)
        gen = torch.Generator(device=device).manual_seed(
            harness.sub_seed(args.seed, 4))
        spans = {k: harness.span_ms(fn) for k, fn in cell.family.train_spans(
            cfg, step.model, step.vgg, pool[0], gen).items()}
        ctx = dict(kind="train", cell=cell, trace=trace, units=n,
                   px_per_unit=px_per_step, flops_per_unit=flops.train_step(c),
                   peak_bytes=traced_peak, spans=spans, peaks=harness.peaks())
    del step, call
    harness.free()
    ref = reference_readings(cell, args.seed, pool, device)
    readings = compare(prog, ref)
    return dict(out=out, attempted=attempted, failed=failed, peak=peak,
                readings=readings, trace_ctx=ctx)


# ---------------------------------------------------------------- faults

def state_unchanged(mp):
    """The optimizer's step does nothing."""
    build = build_program

    def broken(*a, **k):
        cfg, step = build(*a, **k)
        step.optimizer.step = lambda *_, **__: None
        return cfg, step
    mp.setattr(sys.modules[__name__], "build_program", broken)


def half_batch(mp):
    """Half of the scenes (or of the rays, with one scene) left out; the
    loss is the mean over the rest."""
    call = program_call

    def broken(step):
        inner = call(step)

        def half(f):
            SB, NR = f["pix"].shape
            if SB > 1:
                keep = slice(0, SB // 2)
                batch = {k: v[keep] for k, v in f["batch"].items()}
            else:
                keep, batch = (slice(None), slice(0, NR // 2)), f["batch"]
            return inner(dict(batch=batch, pix=f["pix"][keep], noise=tuple(
                None if t is None else t[keep] for t in f["noise"])))
        return half
    mp.setattr(sys.modules[__name__], "program_call", broken)


FAULTS = (state_unchanged, half_batch, faults.answer_altered)


# ---------------------------------------------------------------- calibrate

def calibrate(cell, seed: int, opts, device="cuda") -> dict:
    """The readings of one seed (``benchmark/calibrate.py``): the
    program's against the reference, and with ``opts`` the control's, the
    bfloat16 witness's and each planted fault's; ``opts.dump`` adds each
    side's raw norms."""
    harness.set_tf32(cell)
    pool = make_pool(cell, seed, device)

    def program():
        _, step = build_program(cell, seed, device)
        got = follow(step.model, step.optimizer, program_call(step), pool,
                     step.vgg)
        del step
        harness.free()
        return got

    prog = program()
    planted = {}
    for fault in (FAULTS if opts.faults else ()):
        with faults.planted(fault):
            planted[fault.__name__] = program()
    ref = reference_readings(cell, seed, pool, device)
    harness.free()
    out = {"program": compare(prog, ref), "unjudged": unjudged(prog, ref),
           "program_leaves": leaf_report(prog, ref)}
    sides = {"program": prog, "reference": ref}
    for name, spec in (("control", cell.config["control"] if opts.control
                        else None),
                       ("witness", harness.WITNESS if opts.witness
                        else None)):
        if spec is not None:
            got = reference_readings(cell, seed, pool, device, spec)
            harness.free()
            out[name] = compare(got, ref)
            out[name + "_unjudged"] = unjudged(got, ref)
            out[name + "_leaves"] = leaf_report(got, ref)
            sides[name] = got
    for name, got in planted.items():
        out["fault_" + name] = compare(got, ref)
        sides["fault_" + name] = got
    if opts.dump:
        out["raw"] = {k: {n: v for n, v in side.items() if n != "patch"}
                      for k, side in sides.items()}
    return out
