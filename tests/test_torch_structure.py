"""Structure of the PyTorch port: it imports no JAX and nothing of the JAX
package, its entry points default to the GPU, and its kernels (A and B,
compositing forward and backward; C, the row gather) are held against their
plain versions on a card (tests marked ``cuda``, which skip without one;
``chip_smoke.py`` runs the same comparisons at the eval and training
paths' shapes)."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import diner_tpu_torch
from diner_tpu_torch.data.synthetic import make_sphere_scene
from diner_tpu_torch.device import resolve_device
from diner_tpu_torch.losses import init_vgg19
from diner_tpu_torch.ops import composite as plain
from diner_tpu_torch.ops import composite_cuda, cuda_build, gather_cuda
from diner_tpu_torch.train.diner import DinerConfig, create_model

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diner_tpu")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        diner_tpu_torch.__path__, "diner_tpu_torch."))


def test_import_pulls_in_no_jax():
    modules = _port_modules()
    for m in ("train.config", "train.loop", "train.checkpoint",
              "train.__main__", "data.loader", "data.io", "data.dtu",
              "data.synthetic_dataset", "evaluation.metrics",
              "evaluation.suite", "utils.meters", "utils.visual",
              "utils.pretrained", "utils.convert", "import_pretrained",
              "predict", "evaluate", "mvs.__main__", "mvs.blocks", "mvs.dcn",
              "mvs.fmt", "mvs.homography", "mvs.model", "mvs.datasets",
              "mvs.eval_datasets", "mvs.predict", "mvs.evaluate",
              "fusion.consistency", "fusion.fusion", "data.dtu_fixture",
              "mvs.loss", "mvs.train", "mvs.facescape_dataset",
              "ops.dcn_cuda", "utils.profiling", "ops.knn", "ops.knn_cuda",
              "models.novel.model", "models.novel.renderer",
              "models.novel.train", "models.novel.regressor",
              "data.facescape", "data.facescape_novel",
              "data.facescape_regressor", "models.keypointnerf.modules",
              "models.keypointnerf.model", "models.keypointnerf.losses",
              "models.keypointnerf.train", "ops.rasterize_cuda",
              "preprocessing.rasterize", "preprocessing.facescape",
              "preprocessing.facescape_pipeline", "preprocess_facescape",
              "preprocess_multiface", "geometry.cam_paths", "data.multiface",
              "data.debug", "mvs.multiface_dataset", "pipeline",
              "fusion.__main__", "parallel", "parallel.distributed",
              "parallel.sharding", "parallel.train", "train.import_jax"):
        assert f"diner_tpu_torch.{m}" in modules, m
    code = ("import importlib, sys\n"
            f"for m in {_port_modules()!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _forbidden_imports(source: str, name: str = "<src>"):
    found = []
    for node in ast.walk(ast.parse(source, name)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        found += [n for n in names if n.split(".")[0] in FORBIDDEN]
    return found


def test_no_jax_import_in_port_sources():
    files = sorted((ROOT / "diner_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        assert _forbidden_imports(f.read_text(), str(f)) == [], f
    # the scan is not vacuous
    assert _forbidden_imports("from diner_tpu.ops import composite\n"
                              "import jax.numpy\nimport torch") == [
        "diner_tpu.ops", "jax.numpy"]


def test_export_script_imports_neither_torch_nor_a_package():
    """``export_jax_checkpoint.py`` is the JAX side's half of the orbax
    import: it runs where JAX is, and needs neither torch nor either
    package (orbax and numpy only)."""
    source = (ROOT / "export_jax_checkpoint.py").read_text()
    imported = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            imported += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            imported.append((node.module or "").split(".")[0])
    assert "orbax" in imported and "numpy" in imported
    for bad in ("torch", "diner_tpu", "diner_tpu_torch"):
        assert bad not in imported, bad


def test_mesh_and_import_entry_points_default_to_cuda(monkeypatch,
                                                      tmp_path):
    """``--mesh``, ``parallel.initialize`` and the orbax importer run on the
    card unless the CPU is asked for, and raise without a GPU before a
    process group is joined or a file is read."""
    from diner_tpu_torch.parallel import initialize
    from diner_tpu_torch.train.__main__ import main as train_main
    from diner_tpu_torch.train.import_jax import main as import_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main([str(ROOT / "configs" / "train_synthetic.yaml"),
                    "--mesh"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        initialize()
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        import_main([str(tmp_path / "absent.npz"),
                     str(ROOT / "configs" / "train_synthetic.yaml"), "DINER",
                     str(tmp_path / "out")])


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_model(DinerConfig(), make_sphere_scene(H=8, W=8, nv=2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_vgg19()
    assert resolve_device("cpu").type == "cpu"


def test_training_entry_points_default_to_cuda(monkeypatch, tmp_path):
    from diner_tpu_torch.evaluation.metrics import init_lpips_proxy
    from diner_tpu_torch.evaluation.suite import evaluate_folder
    from diner_tpu_torch.train.__main__ import main as train_main
    from diner_tpu_torch.train.config import load_train_config
    from diner_tpu_torch.train.loop import Trainer
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_train_config(ROOT / "configs" / "train_synthetic.yaml")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main([str(ROOT / "configs" / "train_synthetic.yaml")])
    for model in ("NOVEL", "NOVEL_PE"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_main([str(ROOT / "configs" / "train_novel_facescape.yaml"),
                        model])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_main([str(ROOT / "configs" /
                        "train_keypointnerf_facescape.yaml"), "KeypointNeRF"])
    from diner_tpu_torch.models.keypointnerf.train import (
        KeypointNeRFTrainConfig, create_keypointnerf_state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_keypointnerf_state(KeypointNeRFTrainConfig())
    from diner_tpu_torch.models.novel.regressor import (
        DenseRegressorConfig, create_regressor_state)
    from diner_tpu_torch.models.novel.train import (NovelConfig,
                                                    create_novel_state)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_novel_state(NovelConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_regressor_state(DenseRegressorConfig(num_point=4))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_lpips_proxy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_folder(tmp_path, tmp_path / "scores")


def test_user_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """predict and evaluate run on the card unless --device cpu; the
    weights import needs no device."""
    from diner_tpu_torch.evaluate import main as evaluate_main
    from diner_tpu_torch.import_pretrained import main as import_main
    from diner_tpu_torch.predict import main as predict_main
    from diner_tpu_torch.utils.pretrained import load_vgg19
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        predict_main(["--config", str(ROOT / "configs" /
                                      "train_synthetic.yaml"),
                      "--ckpt", str(tmp_path), "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_main([str(tmp_path)])
    monkeypatch.setenv("DINER_TPU_PRETRAINED", str(tmp_path))
    assert import_main([]) == []
    assert load_vgg19() is None  # nothing to load: no device touched


def test_mvs_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """The two TransMVSNet CLIs run on the card unless --device cpu, in
    every mode; the device is resolved before any data is read or a model
    is built."""
    from diner_tpu_torch.mvs.__main__ import main as mvs_main
    from diner_tpu_torch.mvs.evaluate import main as mvs_evaluate_main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mode in ("write_prediction", "train", "profile"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mvs_main(["--mode", mode, "--trainpath", str(tmp_path),
                      "--trainlist", str(tmp_path / "list.txt")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mvs_evaluate_main(["--testpath", str(tmp_path), "--testlist",
                           "scan1"])


def test_preprocessing_entry_points_default_to_cuda(monkeypatch, tmp_path):
    """Both preprocess CLIs and ``rasterize_depth`` run on the card unless
    the CPU is asked for, and raise without a GPU before reading data; the
    kernel entry of kernel R refuses CPU tensors."""
    from diner_tpu_torch.ops import rasterize_cuda
    from diner_tpu_torch.preprocess_facescape import main as facescape_main
    from diner_tpu_torch.preprocess_multiface import main as multiface_main
    from diner_tpu_torch.preprocessing import rasterize_depth
    from diner_tpu_torch.preprocessing.facescape import collect_vertex_colors
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    verts = np.array([[0, 0, 1], [1, 0, 1], [0, 1, 1]], np.float32)
    faces = np.array([[0, 1, 2]], np.int32)
    K = np.eye(3, dtype=np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rasterize_depth(verts, faces, K, np.eye(4, dtype=np.float32), 4, 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        collect_vertex_colors(np.zeros((4, 4, 3)), np.zeros((4, 4)),
                              np.zeros((1, 2)), np.ones(1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multiface_main(["--root", str(tmp_path / "absent")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        facescape_main(["--dir_in", str(tmp_path / "absent"), "--dir_out",
                        str(tmp_path / "out"), "--rt_scale",
                        str(tmp_path / "absent.json")])
    assert rasterize_depth(verts, faces, K, np.eye(4, dtype=np.float32), 4,
                           4, device="cpu").shape == (4, 4)
    uv, z = rasterize_cuda.project(torch.from_numpy(verts),
                                   torch.from_numpy(K), torch.eye(4))
    with pytest.raises(ValueError, match="CUDA"):
        rasterize_cuda.rasterize_depth_kernel(uv, z, torch.from_numpy(faces),
                                              4, 4)
    with pytest.raises(ValueError, match="expected"):
        rasterize_cuda.rasterize_depth_kernel(uv, z[:2],
                                              torch.from_numpy(faces), 4, 4)


def test_kernel_build_goes_to_ignored_build_dir():
    assert sorted(cuda_build.SOURCES) == ["composite_bwd", "composite_fwd",
                                          "dcn_sample_bwd", "knn1",
                                          "rasterize_depth", "row_gather"]
    for name, src in cuda_build.SOURCES.items():
        path = cuda_build.library_path(name)
        assert path.parent == ROOT / "build" / "kernels"
        assert (cuda_build.PKG_DIR / src).exists()
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    assert "arch=compute_90a,code=sm_90a" in cuda_build.NVCC_FLAGS


def test_kernel_wrapper_refuses_cpu_tensors():
    x = torch.zeros(1, 4, 3)
    with pytest.raises(ValueError, match="CUDA"):
        composite_cuda.composite_kernel(torch.zeros(1, 4, 3, 3), x, x,
                                        torch.zeros(1, 4, 8))
    with pytest.raises(ValueError, match="shapes"):
        composite_cuda.composite_kernel(x, x[..., 0], x, torch.zeros(1, 4))
    with pytest.raises(ValueError, match="CUDA"):
        composite_cuda.composite_bwd_kernel(
            torch.zeros(1, 4, 3, 3), x, x, torch.zeros(1, 4, 8),
            torch.zeros(1, 4, 3))


def test_row_gather_kernel_refuses_what_it_does_not_take():
    table = torch.zeros(10, 6)
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        gather_cuda.row_gather_kernel(table, idx)
    with pytest.raises(ValueError, match="contiguous"):
        gather_cuda.row_gather(table.t(), idx)  # (6, 10), column-major
    with pytest.raises(ValueError, match="contiguous"):
        gather_cuda.row_gather(torch.zeros(1, 6).expand(10, 6), idx)
    with pytest.raises(ValueError, match="int32 or int64"):
        gather_cuda.row_gather(table, idx.to(torch.int16))
    with pytest.raises(ValueError, match="int32 or int64"):
        gather_cuda.row_gather(table, idx.float())
    with pytest.raises(ValueError, match=r"\(R, C\) and \(P,\)"):
        gather_cuda.row_gather(table[None], idx)
    with pytest.raises(ValueError, match=r"\(R, C\) and \(P,\)"):
        gather_cuda.row_gather(table, idx[None])
    with pytest.raises(ValueError, match="empty table"):
        gather_cuda.row_gather(torch.zeros(0, 6), idx)
    with pytest.raises(ValueError, match="dtype"):
        gather_cuda.row_gather(table.bool(), idx)


def test_row_gather_unit_width():
    assert gather_cuda.unit_bytes(2048, 2048, 256, 512) == 16
    assert gather_cuda.unit_bytes(20, 20, 256, 512) == 4     # C = 5 f32
    assert gather_cuda.unit_bytes(4, 4, 256, 512) == 4       # C = 1 f32
    assert gather_cuda.unit_bytes(1024, 1024, 256 + 20, 512) == 4  # row view
    assert gather_cuda.unit_bytes(14, 14, 256, 512) == 2     # C = 7 bf16
    assert gather_cuda.unit_bytes(24, 40, 256, 512) == 8     # strided rows
    assert gather_cuda.unit_bytes(3, 3, 256, 512) == 1


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this on the H100")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _field_case(R, K, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    out = torch.rand((1, R, K, 4), generator=g)
    out[..., 3] = torch.randn((1, R, K), generator=g) * 2
    z = torch.sort(torch.rand((1, R, K), generator=g) * 1.5 + 0.5).values
    rays = torch.zeros((1, R, 8))
    rays[..., 7] = 2.5
    return [t.to(device) for t in (out, z, rays)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(4096, 64), (4097, 40)])
@pytest.mark.parametrize("white", [False, True])
def test_kernel_matches_plain_version(cuda, R, K, white):
    out, z, rays = _field_case(R, K, R + K, cuda)
    before = composite_cuda.launches
    got = composite_cuda.composite(out[..., :3], out[..., 3], z, rays, white)
    torch.cuda.synchronize()
    assert composite_cuda.launches == before + 1
    ref = plain.composite(out[..., :3], out[..., 3], z, rays, white)
    for a, b in zip(got, ref):  # f32 sums in another order
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   atol=1e-5, rtol=0)


def _cotangents(R, K, seed, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return [t.to(device) for t in (torch.randn((1, R, 3), generator=g),
                                   torch.randn((1, R), generator=g),
                                   torch.randn((1, R, K), generator=g))]


@pytest.mark.cuda
@pytest.mark.parametrize("R,K", [(4096, 40), (4096, 64), (4097, 40)])
@pytest.mark.parametrize("white", [False, True])
@pytest.mark.parametrize("with_g_w", [False, True])
def test_bwd_kernel_matches_plain_version(cuda, R, K, white, with_g_w):
    out, z, rays = _field_case(R, K, R + K, cuda)
    g_rgb, g_depth, g_w = _cotangents(R, K, K, cuda)
    if not with_g_w:  # as in the train step: only the rgb output is read
        g_depth = g_w = None
    before = composite_cuda.bwd_launches
    got = composite_cuda.composite_bwd_kernel(
        out[..., :3], out[..., 3], z, rays, g_rgb, g_depth, g_w, white)
    torch.cuda.synchronize()
    assert composite_cuda.bwd_launches == before + 1
    ref = plain.composite_bwd(out[..., :3], out[..., 3], z, rays[..., 7],
                              g_rgb, g_depth, g_w, white)
    # d_rgb 1e-5 absolute; d_sigma 1e-4 of its largest value (T and the
    # suffix sums run in tree order within each chunk here, sequentially
    # in the plain version)
    np.testing.assert_allclose(got[0].cpu().numpy(), ref[0].cpu().numpy(),
                               atol=1e-5, rtol=0)
    scale = float(ref[1].abs().max())
    np.testing.assert_allclose(got[1].cpu().numpy(), ref[1].cpu().numpy(),
                               atol=1e-4 * scale, rtol=0)


@pytest.mark.cuda
def test_composite_function_runs_kernels_a_and_b(cuda):
    out, z, rays = _field_case(256, 40, 7, cuda)
    out.requires_grad_()
    before = (composite_cuda.launches, composite_cuda.bwd_launches)
    o = composite_cuda.composite(out[..., :3], out[..., 3], z, rays)
    (o.rgb ** 2).sum().backward()
    torch.cuda.synchronize()
    assert (composite_cuda.launches, composite_cuda.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    ref = out.detach().clone().requires_grad_()
    r = plain.composite(ref[..., :3], ref[..., 3], z, rays)
    (r.rgb ** 2).sum().backward()
    np.testing.assert_allclose(out.grad.cpu().numpy(),
                               ref.grad.cpu().numpy(), atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_kernel_refuses_foreign_layouts(cuda):
    out, z, rays = _field_case(64, 8, 0, cuda)
    out2, rays2 = out.reshape(2, 32, 8, 4), rays.reshape(2, 32, 8)
    z2 = z.reshape(32, 2, 8).transpose(0, 1)  # (2, 32, 8), rays not mergeable
    with pytest.raises(ValueError, match="without a copy"):
        composite_cuda.composite(out2[..., :3], out2[..., 3], z2, rays2)
    with pytest.raises(ValueError, match="float32"):
        composite_cuda.composite(out[..., :3].double(), out[..., 3], z, rays)


# (R, C, dtype, P) of the path's row gathers at reduced P (chip_smoke.py
# runs them at full P): sampler maps C = 5 f32, latent corners C = 512
# bf16, depth C = 1 f32, pair table C = 1024 bf16; then the lab's C = 128
# f32 proxy, an unaligned C = 3 f32 and an odd C = 7 bf16, P = 1 and R = 1
GATHER_CASES = [(1_310_720, 5, torch.float32, 400_000),
                (491_520, 512, torch.bfloat16, 65_536),
                (1_310_720, 1, torch.float32, 200_000),
                (491_520, 1024, torch.bfloat16, 32_768),
                (300, 128, torch.float32, 2500),
                (1000, 3, torch.float32, 3001),
                (1000, 7, torch.bfloat16, 3001),
                (300, 16, torch.float32, 1),
                (1, 16, torch.float32, 77)]


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,dtype,P", GATHER_CASES)
@pytest.mark.parametrize("index_dtype", [torch.int64, torch.int32])
def test_row_gather_kernel_matches_plain_version(cuda, R, C, dtype, P,
                                                 index_dtype):
    g = torch.Generator(device="cuda").manual_seed(R + C + P)
    table = torch.randn((R, C), generator=g, device=cuda).to(dtype)
    idx = torch.randint(0, R, (P,), generator=g, device=cuda,
                        dtype=index_dtype)
    before = gather_cuda.launches
    got = gather_cuda.row_gather(table, idx)
    torch.cuda.synchronize()
    assert gather_cuda.launches == before + 1
    assert got.dtype == dtype and got.shape == (P, C)
    assert torch.equal(got, gather_cuda.row_gather_plain(table, idx))


@pytest.mark.cuda
def test_row_gather_kernel_on_misaligned_and_strided_tables(cuda):
    g = torch.Generator(device="cuda").manual_seed(1)
    wide = torch.randn((1001, 9), generator=g, device=cuda)
    idx = torch.randint(0, 1000, (5000,), generator=g, device=cuda)
    cases = [wide.reshape(-1)[9:9 + 1000 * 5].view(1000, 5),  # 36 B offset
             wide[1:, 2:7],                                   # strided rows
             wide.bfloat16().reshape(-1)[1:1 + 1000 * 7].view(1000, 7)]
    for table in cases:
        assert torch.equal(gather_cuda.row_gather(table, idx),
                           gather_cuda.row_gather_plain(table, idx))
    # out-of-range indices are clamped to [0, R - 1] as in JAX's gather
    bad = torch.tensor([-5, 0, 999, 1000, 10 ** 9], device=cuda)
    got = gather_cuda.row_gather_kernel(cases[0], bad)
    assert torch.equal(got, cases[0][bad.clamp(0, 999)])
    # P = 0 launches nothing
    before = gather_cuda.launches
    empty = gather_cuda.row_gather(cases[0], idx[:0])
    assert empty.shape == (0, 5) and gather_cuda.launches == before


@pytest.mark.cuda
def test_row_gather_function_backward(cuda):
    g = torch.Generator(device="cuda").manual_seed(2)
    table = torch.randn((50, 8), generator=g, device=cuda).requires_grad_()
    idx = torch.randint(0, 50, (400,), generator=g, device=cuda)
    cot = torch.randn((400, 8), generator=g, device=cuda)
    before = gather_cuda.launches
    gather_cuda.row_gather(table, idx).backward(cot)
    assert gather_cuda.launches == before + 1
    ref = table.detach().clone().requires_grad_()
    ref.index_select(0, idx).backward(cot)
    assert torch.allclose(table.grad, ref.grad, atol=1e-5, rtol=0)
