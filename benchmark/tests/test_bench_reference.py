"""The plain reference against the program at a tiny size on the CPU,
both in float32: the same weights, scenes, pixels and noise give the same
losses, patches, gradients, changes, statistics and images. Every cell of
``BENCHMARK.json`` whose traffic driver is named here."""

import pytest

from benchmark import harness
from benchmark.drivers import render_images, train_step
from benchmark.tests import tiny


def cells_of(driver):
    return [n for n in harness.workload_names()
            if harness.load_cell(n).traffic["driver"] == driver]


def f32(cell):
    cell.config = dict(cell.config, compute_dtype="float32")
    return cell


@pytest.mark.parametrize("name", cells_of("train_step"))
def test_reference_follows_the_program_step(name):
    cell = f32(tiny.tiny_cell(name))
    pool = train_step.make_pool(cell, 5, "cpu")
    _, step = train_step.build_program(cell, 5, "cpu")
    prog = train_step.follow(step.model, step.optimizer,
                             train_step.program_call(step), pool, step.vgg)
    ref = train_step.reference_readings(cell, 5, pool, "cpu")
    assert len(prog["grads"]) == len(ref["grads"]) > 10
    assert min(ref["grads"].values()) > 0, "a leaf took no gradient"
    s = cell.config["train"]["vgg_spatch"]
    assert ref["patch"].shape == (cell.config["train"]["scenes_per_step"],
                                  s, s, 3)
    gaps = train_step.compare(prog, ref)
    assert max(gaps.values()) < 1e-4, gaps


@pytest.mark.parametrize("name", cells_of("render_images"))
def test_reference_renders_the_program_image(name):
    cell = f32(tiny.tiny_cell(name))
    scenes = render_images.make_scenes(cell, 6, "cpu")
    _, _, step = render_images.build_program(cell, 6, "cpu")
    noise = render_images.image_noise(cell, 6, 1, "cpu")
    prog = step(scenes[1], noise=noise)
    ref = render_images.reference_image(cell, 6, scenes[1], noise, "cpu")
    gaps = render_images.compare(cell, prog, ref)
    assert max(gaps.values()) < 1e-5, gaps
    assert float((prog[1] > 0).float().mean()) > 0.5  # the field renders
