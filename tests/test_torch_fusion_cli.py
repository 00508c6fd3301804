"""``python -m diner_tpu_torch.fusion`` against ``scripts/fuse.py``, on the
CPU.

Both fuse the same dense folder (``tests/test_torch_fusion.py``'s two
planes seen by four cameras, written in the test CLI's layout) into a PLY.
The PLYs must hold the same header and the same points and colours,
exactly: both read the same files and call the same fusion core (the JAX
package's and the port's copy of ``fusion.cpp``), whose OpenMP threads
append points in any order, so rows are compared sorted. The CLI at its
defaults must also give the points of ``mvs/evaluate.py``'s ``gipuma``
fusion of that folder: both go through ``fusion/fusion.py:
fuse_dense_folder``, the CLI with the folder's stems, ``fuse_scan`` with
its pair file's views.
"""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from diner_tpu_torch.fusion import __main__ as fusion_cli
from diner_tpu_torch.fusion.fusion import read_ply
from diner_tpu_torch.mvs import evaluate as pevaluate
from tests.test_torch_fusion import in_order, two_plane_scene, write_protocol
from tests.test_torch_mvs_data import import_script

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def fuse_script():
    return import_script("fuse")


def dense_folder(tmp_path, images="jpg", seed=1):
    """The scene's dense folder → its path; ``images`` "png" re-saves
    the views as PNGs, ``None`` removes them (no colours)."""
    write_protocol(tmp_path / "out", tmp_path / "scenes",
                   two_plane_scene(seed=seed))
    scan = tmp_path / "out" / "scan1"
    for p in sorted((scan / "images").glob("*.jpg")):
        if images == "png":
            Image.open(p).save(p.with_suffix(".png"))
        if images != "jpg":
            p.unlink()
    return scan


def rows(ply):
    names, floats, colors = read_ply(ply)
    if colors is not None:
        floats = np.concatenate([floats, colors.astype(np.float32)], axis=1)
    return names, colors is not None, in_order(floats)


def assert_same_ply(got, ref):
    g, r = rows(got), rows(ref)
    assert g[:2] == r[:2]
    np.testing.assert_array_equal(g[2], r[2])
    return len(g[2])


CASES = {
    "defaults": ("jpg", []),
    "png_views": ("png", []),
    "no_images": (None, []),
    "thresholds": ("jpg", ["--prob_threshold", "0.6", "--disp_threshold",
                           "0.5", "--normal_threshold", "0.3",
                           "--num_consistent", "2"]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fusion_cli_matches_fuse_script(case, tmp_path, fuse_script,
                                        monkeypatch):
    images, flags = CASES[case]
    scan = dense_folder(tmp_path, images)
    got, ref = tmp_path / "port.ply", tmp_path / "jax.ply"
    res = fusion_cli.main(["--scan_dir", str(scan), "--out", str(got),
                           *flags])
    monkeypatch.setattr(sys, "argv", ["fuse.py", "--scan_dir", str(scan),
                                      "--out", str(ref), *flags])
    fuse_script.main()
    n = assert_same_ply(got, ref)
    assert res == {"ply": str(got), "points": n} and n > 0


def test_fusion_cli_defaults_equal_the_gipuma_backend(tmp_path):
    """At its defaults (confidence 0.9, 0.25 px, 0.52 rad, 3 views) the CLI
    fuses what ``mvs/evaluate.py``'s gipuma method fused into
    ``mvsnet_scan1.ply`` from the same folder."""
    scan = dense_folder(tmp_path, seed=2)
    args = types.SimpleNamespace(testpath=str(tmp_path / "scenes"),
                                 filter_method="gipuma", conf=0.9,
                                 thres_view=3)
    backend = pevaluate.fuse_scan(args, "scan1", tmp_path / "out")
    res = fusion_cli.main(["--scan_dir", str(scan), "--out",
                           str(tmp_path / "cli.ply")])
    assert assert_same_ply(tmp_path / "cli.ply", backend["ply"]) == \
        backend["points"] == res["points"]


def test_fusion_cli_runs_as_a_module(tmp_path):
    """``python -m diner_tpu_torch.fusion`` writes the PLY and reports its
    count; a folder with no depth maps is refused."""
    scan = dense_folder(tmp_path)
    out = tmp_path / "m.ply"
    p = subprocess.run([sys.executable, "-m", "diner_tpu_torch.fusion",
                        "--scan_dir", str(scan), "--out", str(out)],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == f"fused {len(rows(out)[2])} points -> {out}"
    with pytest.raises(SystemExit, match="no depth_est"):
        fusion_cli.main(["--scan_dir", str(tmp_path), "--out",
                         str(tmp_path / "x.ply")])
