"""The program's spans (``diner_tpu_torch/utils/profiling.py``) in the
DINER and NOVEL_PE train steps and the eval image, on the small CPU
models of the port's tests: with ``torch.profiler`` off a step records
nothing, registers no hook, creates no event and leaves the sync-debug
mode alone; with it on each step leaves its span tree, the backward's
parts in order and tiling it; the numbers are the same bit for bit either
way. On the card (``cuda``): a host-to-device copy counts one sync and an
op on the device none, a span reads a device sleep's length, and a traced
step launches the same kernels with spans as without.

No JAX here: the ``cuda`` test runs on the card with ``--noconftest``.
"""

import contextlib
import warnings

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from diner_tpu_torch.data.synthetic_dataset import SphereDataset
from diner_tpu_torch.losses import init_vgg19
from diner_tpu_torch.models.novel.model import NovelPixelNeRFConfig
from diner_tpu_torch.models.novel.train import NovelConfig, create_novel_state
from diner_tpu_torch.models.pixelnerf import PixelNeRFConfig
from diner_tpu_torch.nn.spatial_encoder import SpatialEncoderConfig
from diner_tpu_torch.renderer import RendererConfig
from diner_tpu_torch.train.diner import (DinerConfig, create_model,
                                         make_eval_step, make_train_step)
from diner_tpu_torch.utils import profiling

H, W = 24, 32
NERF = dict(encoder=SpatialEncoderConfig(backbone="resnet18", num_layers=2),
            d_hidden=32, n_blocks=2, combine_layer=1)
RENDERER = RendererConfig(n_samples=8, n_depth_candidates=32, n_gaussian=3,
                          ray_chunk=256)
LOSSES = dict(w_vgg=0.1, vgg_spatch=16, w_antibias=1.0,
              antibias_downsampling=2)
CASES = ("diner", "novel_pe", "image")
TRAIN_SPANS = ["optimizer", "encode", "sampler", "field", "composite", "loss",
               "backward", "loss.bwd", "composite.bwd", "field.bwd",
               "encode.bwd", "optimizer", "train_step"]
LAYER_SPANS = {"train_step", "eval_image", "optimizer", "encode", "sampler",
               "field", "composite", "loss", "backward"}


def _batch(model, n_vertices=64):
    s = SphereDataset("train", n=2, H=H, W=W, nv=2, model=model,
                      n_vertices=n_vertices)[1]
    return {k: np.asarray(v)[None] for k, v in s.items()
            if isinstance(v, np.ndarray)}


class Unit:
    """One case's model and its unit of work (a train step or an image),
    built afresh from fixed seeds: ``run()`` does the next unit and returns
    its outputs; ``state()`` the parameters, their gradients and the
    buffers."""

    def __init__(self, case, device):
        self.case, self.device = case, device
        self.gen = torch.Generator(device=device).manual_seed(5)
        if case == "novel_pe":
            cfg = NovelConfig(
                nerf=NovelPixelNeRFConfig(**NERF, gen_latent_hw=12,
                                          gen_latent_ch=128,
                                          use_pe_maps=True),
                renderer=RENDERER, **LOSSES)
            self.batch = _batch("NOVEL_PE")
            self.step = create_novel_state(cfg, seed=0, device=device,
                                           vgg=init_vgg19(0, device))
            self.model = self.step.model
            return
        cfg = DinerConfig(nerf=PixelNeRFConfig(**NERF), renderer=RENDERER,
                          **LOSSES)
        self.batch = _batch("DINER")
        self.model = create_model(cfg, self.batch, seed=0, device=device)
        self.step = (make_eval_step(self.model, cfg) if case == "image" else
                     make_train_step(self.model, cfg,
                                     init_vgg19(0, device)))

    def run(self):
        out = self.step(self.batch, generator=self.gen)
        return list(out.values()) if isinstance(out, dict) else list(out)

    def state(self):
        m = self.model
        return ([p.detach() for p in m.parameters()]
                + [p.grad for p in m.parameters() if p.grad is not None]
                + list(m.buffers()))


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


@pytest.fixture(autouse=True)
def drained():
    profiling.take()
    yield
    profiling.take()


@pytest.mark.parametrize("case", CASES)
def test_off_records_and_changes_nothing(case, monkeypatch):
    unit = Unit(case, "cpu")
    opened = []
    record_function = torch.autograd.profiler.record_function

    def counted(name, *a, **k):
        opened.append(name)
        return record_function(name, *a, **k)

    def refused(*_a, **_k):
        raise AssertionError("called with the profiler off")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", counted)
    for owner, name in ((torch.Tensor, "register_hook"),
                        (torch.cuda, "Event"),
                        (torch.cuda, "set_sync_debug_mode"),
                        (torch.cuda, "get_sync_debug_mode")):
        monkeypatch.setattr(owner, name, refused)
    shown = warnings.showwarning
    unit.run()
    unit.run()
    assert profiling.take() == []
    assert not LAYER_SPANS & set(opened)
    assert warnings.showwarning is shown


@pytest.mark.parametrize("case", CASES)
def test_on_records_the_span_tree(case):
    unit = Unit(case, "cpu")
    _traced(unit.run)
    spans = profiling.take()
    names = [s.name for s in spans]
    root = spans[-1]
    assert root.parent is None and root.syncs == 0
    assert {s.root for s in spans} == {root.root}
    assert all(s.syncs == 0 and s.device_ms == s.host_ms for s in spans)
    if case == "image":
        chunks = H * W // RENDERER.ray_chunk
        assert names == (["encode"] + ["sampler", "field", "composite"]
                         * chunks + ["eval_image"])
        assert all(s.parent == "eval_image" for s in spans[:-1])
        return
    assert names == TRAIN_SPANS
    parts = spans[7:11]
    assert all(s.parent == "backward" for s in parts)
    assert all(s.parent == "train_step" for s in spans[:7] + spans[11:12])
    # the parts tile the backward: each starts where the one before ends
    assert sum(s.host_ms for s in parts) == pytest.approx(spans[6].host_ms,
                                                          rel=1e-9)
    inner = sum(s.host_ms for s in spans[:7] + spans[11:12])
    assert 0 < inner <= root.host_ms


@pytest.mark.parametrize("case", CASES)
def test_on_and_off_give_the_same_numbers(case):
    off = Unit(case, "cpu")
    got_off = [off.run() for _ in range(2)], off.state()
    on = Unit(case, "cpu")
    got_on = [_traced(on.run) for _ in range(2)], on.state()
    assert len(profiling.take()) > 0
    flat_off, flat_on = (sum(outs, []) + state
                         for outs, state in (got_off, got_on))
    assert len(flat_off) == len(flat_on)
    for a, b in zip(flat_off, flat_on):
        assert torch.equal(a, b)


def test_a_span_outside_a_step_keeps_host_time():
    assert profiling.span("x") is profiling.span("y")  # the one no-op
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer", "cpu"):
            with profiling.span("inner"):
                torch.ones(3).sum()
    inner, outer = profiling.take()
    assert (inner.name, inner.parent, outer.parent) == ("inner", "outer",
                                                        None)
    assert inner.root == outer.root and inner.host_ms <= outer.host_ms


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the chip machine")
    return torch.device("cuda")


def _kernels(prof) -> int:
    """Device kernels in a trace, as the benchmark counts them: the
    profiler's annotation ranges, copies and fills left out."""
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)
               and not e.name.startswith(("Memcpy", "Memset")))


@pytest.mark.cuda
def test_spans_on_the_card(cuda, monkeypatch):
    a = torch.ones(1000, device=cuda)
    cycles = 50_000_000
    torch.cuda._sleep(cycles)  # warm
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    torch.cuda._sleep(cycles)
    end.record()
    end.synchronize()
    sleep_ms = start.elapsed_time(end)
    mode = torch.cuda.get_sync_debug_mode()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):
        with profiling.span("root", cuda):
            with profiling.span("copy"):
                torch.tensor([1.0], device=cuda)
            with profiling.span("on_device"):
                (a * 2).sum()
            with profiling.span("sleep"):
                torch.cuda._sleep(cycles)
        torch.cuda.synchronize()
    spans = {s.name: s for s in profiling.take()}
    assert torch.cuda.get_sync_debug_mode() == mode
    assert spans["copy"].syncs == 1 and spans["on_device"].syncs == 0
    assert spans["root"].syncs == 0
    assert spans["sleep"].device_ms == pytest.approx(sleep_ms, rel=0.1)

    unit = Unit("diner", cuda)
    unit.run()  # builds the kernels
    torch.cuda.synchronize()
    counts = []
    for spans_on in (True, False):
        unit.gen.manual_seed(7)
        with monkeypatch.context() as mp:
            if not spans_on:
                mp.setattr(profiling, "span",
                           lambda *_a, **_k: contextlib.nullcontext())
                mp.setattr(profiling, "mark", lambda *_a, **_k: None)
            with profile(activities=acts) as prof:
                unit.run()
                torch.cuda.synchronize()
        counts.append(_kernels(prof))
        assert bool(profiling.take()) == spans_on
    assert counts[0] == counts[1] > 0
