"""Port parity of the evaluation suite and its helpers: the metrics, the
LPIPS proxy, the folder protocol, the colour map, the image writer and the
scalar meters.

The same numpy images go through the JAX package and the port. PSNR, SSIM,
L1 and L2 are the same numpy code and must be exact; the LPIPS proxy is
VGG16 convolutions summed in another order (flax on the CPU against torch
on the CPU), held within 1e-5. ``colorize`` reads the port's stored viridis
table and must equal matplotlib's colour map bit for bit.
"""

import json
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from diner_tpu.evaluation import metrics as j_metrics
from diner_tpu.evaluation import suite as j_suite
from diner_tpu.utils import meters as j_meters
from diner_tpu.utils import visual as j_visual
from diner_tpu_torch.evaluation import metrics, suite
from diner_tpu_torch.utils import meters, visual
from diner_tpu_torch.utils.convert import lpips_to_state_dict
from diner_tpu_torch.utils.viridis import VIRIDIS


def _pair(seed, H=32, W=36):
    rng = np.random.RandomState(seed)
    x = rng.rand(H, W, 3).astype(np.float32)
    y = np.clip(x + rng.randn(H, W, 3).astype(np.float32) * 0.1, 0, 1)
    return x, y


@pytest.mark.parametrize("seed", [0, 1])
def test_image_metrics_exact(seed):
    x, y = _pair(seed)
    for name in ("psnr", "mse", "l1", "ssim"):
        assert getattr(metrics, name)(x, y) == getattr(j_metrics, name)(x, y)
    assert metrics.ssim(x[..., 0], y[..., 0]) == j_metrics.ssim(x[..., 0],
                                                                y[..., 0])
    assert metrics.psnr(x, x) == math.inf == j_metrics.psnr(x, x)


def _jax_proxy_numpy(seed=0):
    p = j_metrics.init_lpips_proxy(seed)
    return {"vgg": {k: {n: np.asarray(v) for n, v in d.items()}
                    for k, d in p["vgg"].items()},
            "lins": tuple(np.asarray(w) for w in p["lins"])}, p


def test_lpips_proxy_bridged_matches_jax():
    np_params, j_params = _jax_proxy_numpy()
    bridged = metrics.LPIPSVGG()
    bridged.load_state_dict(lpips_to_state_dict(np_params))
    # the port draws the same proxy from the same numpy generator
    own = metrics.init_lpips_proxy(device="cpu")
    for k, v in own.state_dict().items():
        assert torch.equal(v, bridged.state_dict()[k]), k
    rng = np.random.RandomState(1)
    a = rng.rand(2, 32, 40, 3).astype(np.float32) * 2 - 1
    b = rng.rand(2, 32, 40, 3).astype(np.float32) * 2 - 1
    want = np.asarray(j_metrics.lpips_distance(j_params, jnp.asarray(a),
                                               jnp.asarray(b)))
    got = metrics.lpips_distance(bridged, a, b).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert float(metrics.lpips_distance(own, a, a)[0]) == 0.0


def _write_folder(vis, seed=2, n=3, H=24, W=28):
    """A prediction folder of the suite's layout, as JAX's tests build
    one."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    vis.mkdir()
    for i in range(n):
        gt = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        pred = np.clip(gt.astype(float) + rng.randn(H, W, 3) * 10, 0,
                       255).astype(np.uint8)
        for suffix, img in ((suite.GT_SUFFIX, gt), (suite.PRED_SUFFIX, pred),
                            (suite.REF_SUFFIX, np.concatenate([gt, gt], 1)),
                            (suite.DEPTH_SUFFIX, gt)):
            Image.fromarray(img).save(vis / f"s{i:03d}{suffix}")


def test_evaluate_folder_matches_jax(tmp_path):
    vis = tmp_path / "vis"
    _write_folder(vis)
    got = suite.evaluate_folder(vis, tmp_path / "ours", device="cpu")
    want = j_suite.evaluate_folder(vis, tmp_path / "jax",
                                   lpips_params="proxy")
    assert set(got) == set(want) == {"ssim", "psnr", "l1", "l2",
                                     "lpips_proxy"}
    for k in ("ssim", "psnr", "l1", "l2"):
        assert got[k] == want[k], k
    assert abs(got["lpips_proxy"] - want["lpips_proxy"]) <= 1e-5
    reports = [json.loads((tmp_path / d / suite.AVERAGE_SCORE_FILENAME)
                          .read_text()) for d in ("ours", "jax")]
    assert reports[0].pop("lpips_proxy") == pytest.approx(
        reports[1].pop("lpips_proxy"), abs=1e-5)
    assert reports[0] == reports[1]  # scores and the proxy's note
    details = [json.loads((tmp_path / d / suite.REPORT_DETAIL_FILENAME)
                          .read_text()) for d in ("ours", "jax")]
    assert [r["path"] for r in details[0]] == [r["path"] for r in details[1]]
    from PIL import Image
    np.testing.assert_array_equal(
        np.asarray(Image.open(tmp_path / "ours" / suite.EXAMPLE_PLOT_FILENAME)),
        np.asarray(Image.open(tmp_path / "jax" / suite.EXAMPLE_PLOT_FILENAME)))
    for name in ("PRED_SUFFIX", "GT_SUFFIX", "REF_SUFFIX", "DEPTH_SUFFIX",
                 "AVERAGE_SCORE_FILENAME", "REPORT_DETAIL_FILENAME"):
        assert getattr(suite, name) == getattr(j_suite, name)
    assert suite.evaluate_folder(vis, tmp_path / "none", lpips_params=None,
                                 device="cpu").keys() == {"ssim", "psnr",
                                                          "l1", "l2"}


def test_viridis_table_is_matplotlibs():
    from matplotlib import colormaps
    cmap = colormaps["viridis"]
    np.testing.assert_array_equal(np.asarray(VIRIDIS, np.float64),
                                  np.asarray(cmap.colors, np.float64))


@pytest.mark.parametrize("kw", [{}, {"vmin": 0.2, "vmax": 0.7}])
def test_colorize_matches_jax(kw):
    rng = np.random.RandomState(5)
    depth = rng.rand(17, 19, 1).astype(np.float32)
    depth[1, :, 0] = [0.0, 1.0] * 9 + [0.5]  # both ends of the range
    if kw:  # NaN is black; with a NaN in it the default range is NaN too
        depth[0, 0] = np.nan
    np.testing.assert_array_equal(visual.colorize(depth, **kw),
                                  j_visual.colorize(depth, **kw))
    flat = np.full((4, 5), 2.0)
    np.testing.assert_array_equal(visual.colorize(flat),
                                  j_visual.colorize(flat))


def test_save_image_matches_jax(tmp_path):
    from PIL import Image
    img = np.random.RandomState(6).rand(10, 12, 3) * 1.2 - 0.1
    visual.save_image(tmp_path / "a.png", img)
    j_visual.save_image(tmp_path / "b.png", img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.png")),
                                  np.asarray(Image.open(tmp_path / "b.png")))


def test_meters_match_jax():
    ours, ref = meters.DictAverageMeter(), j_meters.DictAverageMeter()
    for i, n in ((1, 1), (2, 3), (5, 2)):
        for m in (ours, ref):
            m.update({"loss": 0.1 * i, "psnr": 20.0 + i}, n=n)
    assert ours.mean() == ref.mean()
    ours.reset()
    assert ours.mean() == {} and ours.count == 0
    scalars = {"b": 2.5, "a": 1.0}
    assert meters.reduce_scalar_dict(scalars) == \
        j_meters.reduce_scalar_dict(scalars)
    meters.synchronize()


def test_meters_allreduce_core_matches_jax(tmp_path):
    """The collective path on a one-process gloo group equals the JAX
    all-gather core on one process."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        scalars = {"b": 2.5, "a": 1.0 / 3}
        for average in (True, False):
            assert meters._allreduce(scalars, average) == \
                j_meters._allgather_reduce(scalars, average)
    finally:
        dist.destroy_process_group()
