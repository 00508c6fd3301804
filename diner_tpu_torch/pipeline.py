"""The one-command pipeline, the port's counterpart of
``scripts/run_pipeline.py`` (the reference's workflow, README.md:105-131):

    TransMVSNet training → write_prediction (the uint16 depth / confidence
    PNGs, into the dataset tree) → DINER training on those PNGs through
    ``data/dtu.py`` → the prediction folder → its scores

Each stage is the CLI a user runs by hand, ``python -m diner_tpu_torch.mvs``
(train, then write_prediction), ``.train``, ``.predict`` and ``.evaluate``,
so the run goes through the real seams: the PNGs the DINER loader reads are
the ones TransMVSNet just wrote.

Usage (from the repository root; on the GPU unless ``--device cpu``):

    python -m diner_tpu_torch.data.dtu_fixture /tmp/dtu_fix   # once
    python -m diner_tpu_torch.pipeline --root /tmp/dtu_fix \\
        --workdir outputs/pipeline [--mvs-steps 30] [--diner-steps 2000]
    python -m diner_tpu_torch.pipeline --root <fixture> --workdir <dir> \\
        --tiny --device cpu --dtype float32

The flags are those of ``scripts/run_pipeline.py`` with the same defaults,
and ``--device`` is passed to every stage. A stage that fails ends the run
with a nonzero exit and the tail of ``<workdir>/pipeline.log``; nothing is
retried. Every stage can be re-entered: the training CLIs resume from their
latest checkpoint, ``--skip-mvs`` reuses the PNGs in the tree and
``--skip-diner`` the workdir's DINER checkpoint. The result,
``<workdir>/PIPELINE_RESULT.json``, holds each stage's seconds and the
scores.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

DINER_CFG_TEMPLATE = """\
# generated by python -m diner_tpu_torch.pipeline — DINER-on-DTU-fixture
# (reference configs/train_dtu.yaml recipe at lr 1e-4)
logger:
  kwargs:
    save_dir: "{workdir}/diner"
    version: "DINER_pipeline"
data:
  train:
    dataset:
      module: src.data.dtu.DTUDataSet
      kwargs: {{root: {root}, depth_fname: TransMVSNet, split_dir: {split_dir}, downsample: {downsample}{train_extra}}}
    dataloader:
      kwargs: {{shuffle: true, batch_size: 1}}
  val:
    dataset:
      module: src.data.dtu.DTUDataSet
      kwargs: {{root: {root}, depth_fname: TransMVSNet, split_dir: {split_dir}, downsample: {downsample}{val_extra}}}
    dataloader:
      kwargs: {{shuffle: false, batch_size: 1}}
nerf:
  module: src.models.pixelnerf.PixelNeRF
  kwargs:
    encoder_conf:
      module: src.models.image_encoder.SpatialEncoder
      kwargs: {{backbone: {backbone}, image_padding: {image_padding}, padding_pe: 4}}
    poscode_conf:
      kwargs: {{num_freqs: 6, freq_factor: 6.28, include_input: true}}
    mlp_fine_conf:
      module: src.models.resnetfc.ResnetFC
      kwargs: {{n_blocks: 5, d_hidden: {d_hidden}, combine_layer: 3, combine_type: average}}
    compute_dtype: {compute_dtype}
renderer:
  module: src.models.nerf_renderer.NeRFRendererDGS
  kwargs:
    n_samples: {n_samples}
    n_depth_candidates: {n_cand}
    n_gaussian: {n_gaussian}
    white_bkgd: False
    ray_chunk: {ray_chunk}{pruned_extra}
optimizer:
  kwargs:
    w_vgg: 0.1
    w_antibias: 1.0
    vgg_spatch: {vgg_spatch}
    ray_batch_size: {ray_batch_size}
    lr: 1e-4
    n_samples_score_eval: {val_views}
    cam_sweep_settings: {{nframes: {sweep_frames}, n_cam_sweeps: {n_sweeps}}}
trainer:
  kwargs:
    val_check_interval: {val_interval}
    log_every_n_steps: 25
    limit_val_batches: {val_batches}
    max_epochs: -1
checkpointing:
  kwargs:
    every_n_train_steps: {val_interval}
"""

PRUNED_YAML = "\n    n_coarse_candidates: 125\n    n_refine_bins: 16"


def make_diner_tree(mvs_root: Path, diner_root: Path) -> None:
    """Derive DINER's layout of a DTU tree from TransMVSNet's.

    TransMVSNet reads the 1200×1600 ``Rectified`` images and crops them to
    its 512×640 canvas in its loader (``mvs/datasets.py:prepare_img``);
    DINER's tree holds that canvas (its loader only downsamples; the cam
    files, quarter-resolution K, are the same in both). So each image is
    halved (bilinear) and cropped as ``prepare_img`` crops (rows 44:556,
    cols 80:720) once; a light variant that links to another render becomes
    a relative link to that render's copy. ``Depths`` is a link to the MVS
    tree's, so what write_prediction writes there is in both trees;
    ``Cameras/train`` and ``list.txt`` are copied. The renders are
    converted on a pool of threads (PIL releases the GIL while it decodes,
    resizes and encodes).
    """
    import shutil
    from concurrent.futures import ThreadPoolExecutor

    (diner_root / "Cameras").mkdir(parents=True, exist_ok=True)
    if not (diner_root / "Cameras/train").exists():
        shutil.copytree(mvs_root / "Cameras/train",
                        diner_root / "Cameras/train")
    if not (diner_root / "Depths").exists():
        os.symlink(mvs_root / "Depths", diner_root / "Depths")
    (diner_root / "list.txt").write_text((mvs_root / "list.txt").read_text())

    done = {}
    for src in sorted((mvs_root / "Rectified").rglob("rect_*.png")):
        dst = diner_root / "Rectified" / src.parent.name / src.name
        if dst.exists():
            continue
        dst.parent.mkdir(parents=True, exist_ok=True)
        real = src.resolve()
        if real in done:
            # relative, so the link resolves wherever the tree is read from
            os.symlink(os.path.relpath(done[real], dst.parent), dst)
            continue
        done[real] = dst
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        for _ in pool.map(convert_render, done, done.values()):
            pass


def convert_render(src: Path, dst: Path) -> None:
    """One 1200×1600 render → DINER's 512×640 canvas: halved (bilinear),
    then cropped at the centre as ``prepare_img`` crops."""
    from PIL import Image
    img = Image.open(src)
    w, h = img.size
    img = img.resize((w // 2, h // 2), Image.BILINEAR)
    w, h = img.size
    sw, sh = (w - 640) // 2, (h - 512) // 2
    img.crop((sw, sh, sw + 640, sh + 512)).save(dst)


def run_module(module: str, args, log: Path) -> None:
    """The default stage runner: ``python -m <module> <args>`` from the
    repository's root, its output appended to ``log``. A stage that fails
    ends the run: the log's tail goes to standard error and the exit code
    is nonzero."""
    cmd = [sys.executable, "-m", module, *map(str, args)]
    line = " ".join(cmd)
    print(f"[pipeline] $ {line}", flush=True)
    with open(log, "ab") as f:
        f.write(f"\n$ {line}\n".encode())
        f.flush()
        rc = subprocess.run(cmd, cwd=REPO, stdout=f,
                            stderr=subprocess.STDOUT).returncode
    if rc != 0:
        sys.stderr.write(Path(log).read_text(errors="replace")[-4000:])
        raise SystemExit(f"stage failed (exit {rc}): python -m {module}")


def recipe(args):
    """(numdepth, the template's DINER fields, eval downsample, eval
    samples) of ``--tiny`` or the reference's DTU recipe, with the
    training downsample, the pruned sampler and the held-out target
    cameras of the options; sets the tiny recipe's MVS depths on
    ``args``."""
    if args.tiny:
        args.ndepths, args.depth_inter_r = "8,8,8", "4,1,0.5"
        numdepth, eval_downsample, eval_nsamples = 32, 0.25, None
        diner = dict(backbone="resnet18", image_padding=8, d_hidden=64,
                     n_samples=8, n_cand=64, n_gaussian=2, ray_chunk=2048,
                     ray_batch_size=64, vgg_spatch=32, downsample=0.25,
                     compute_dtype="float32")
    else:
        # the reference's DTU recipe: train at downsample 0.5 (256×320,
        # configs/train_dtu.yaml), score the full 512×640 protocol with 64
        # depth-guided samples (configs/evaluate_diner_on_dtu.yaml)
        numdepth, eval_downsample, eval_nsamples = 192, 1.0, 64
        diner = dict(backbone="resnet34", image_padding=64, d_hidden=512,
                     n_samples=40, n_cand=1000, n_gaussian=15,
                     ray_chunk=4096, ray_batch_size=128, vgg_spatch=64,
                     downsample=0.5, compute_dtype=args.dtype)
    if args.train_downsample is not None:
        diner["downsample"] = args.train_downsample
    diner["pruned_extra"] = (PRUNED_YAML if args.pruned in ("train", "both")
                             else "")
    holdout = ([int(c) for c in args.holdout_cams.split(",")]
               if args.holdout_cams else [])
    cams = ", ".join(map(str, holdout))
    diner["train_extra"] = f", exclude_cams: [{cams}]" if holdout else ""
    diner["val_extra"] = f", only_cams: [{cams}]" if holdout else ""
    return numdepth, diner, eval_downsample, eval_nsamples


def write_splits(root: Path, split_dir: Path, val_scans=None):
    """``dtu_train_all.txt`` and ``dtu_val_all.txt``: the scans of
    ``root/list.txt``, all of them in both unless ``val_scans`` (a comma
    list) names the validation split (the reference splits by scan,
    ``src/data/dtu.py:130-140``)."""
    split_dir.mkdir(parents=True, exist_ok=True)
    scans = [s for s in (root / "list.txt").read_text().split() if s]
    if val_scans:
        val = [s for s in val_scans.split(",") if s]
        if not set(val) <= set(scans):
            raise SystemExit(f"--val-scans {val} not all in {scans}")
        train = [s for s in scans if s not in val]
        if not train:
            raise SystemExit("--val-scans leaves no scan to train on")
    else:
        train = val = scans
    (split_dir / "dtu_train_all.txt").write_text("\n".join(train) + "\n")
    (split_dir / "dtu_val_all.txt").write_text("\n".join(val) + "\n")


def build_parser():
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.pipeline")
    ap.add_argument("--root", required=True, help="DTU(-fixture) tree")
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--mvs-steps", type=int, default=30)
    ap.add_argument("--diner-steps", type=int, default=2000)
    ap.add_argument("--eval-n", type=int, default=3,
                    help="images for the final prediction folder")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--ndepths", default="48,32,8")
    ap.add_argument("--depth_inter_r", default="4,1,0.5")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny-shape CPU smoke: 8 MVS hypotheses a stage, "
                         "a small DINER, quarter-resolution renders")
    ap.add_argument("--skip-mvs", action="store_true",
                    help="reuse existing TransMVSNet PNGs in the tree")
    ap.add_argument("--skip-diner", action="store_true",
                    help="reuse the workdir's existing DINER checkpoint")
    ap.add_argument("--val-interval", type=int, default=None,
                    help="DINER val-hook cadence in steps (default: "
                         "diner_steps/4)")
    ap.add_argument("--sweep-frames", type=int, default=30,
                    help="cam-sweep frames per val hook (reference: 30)")
    ap.add_argument("--n-sweeps", type=int, default=4,
                    help="cam sweeps per val hook")
    ap.add_argument("--val-views", type=int, default=100,
                    help="views rendered and scored per val hook "
                         "(reference create_prediction_folder subset: 100)")
    ap.add_argument("--train-downsample", type=float, default=None,
                    help="training image downsample (default: the "
                         "recipe's, 0.5 = 256x320 in the reference's; 1.0 "
                         "trains on the full 512x640 canvas)")
    ap.add_argument("--val-scans", default=None,
                    help="comma-separated scan names of the val split "
                         "(default: every scan in both splits)")
    ap.add_argument("--pruned", choices=["none", "train", "both"],
                    default="none",
                    help="the two-stage pruned sampler (125 candidates, 16 "
                         "bins) for DINER training ('train') or training "
                         "and the prediction folder ('both')")
    ap.add_argument("--holdout-cams", default=None,
                    help="comma-separated target cameras held out of "
                         "training and used only as val / eval targets "
                         "(single-scan novel-view protocol)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the device of every stage")
    return ap


def main(argv=None, run_stage=run_module):
    """Run the pipeline; ``run_stage(module, args, log)`` runs one stage
    (``run_module`` by default) and raises when it fails. Returns the
    result written to ``PIPELINE_RESULT.json``."""
    args = build_parser().parse_args(argv)
    from diner_tpu_torch.device import resolve_device
    resolve_device(args.device)

    root = Path(args.root).resolve()
    work = Path(args.workdir).resolve()
    work.mkdir(parents=True, exist_ok=True)
    log = work / "pipeline.log"
    stages = {}

    def stage(key, module, stage_args):
        t0 = time.perf_counter()
        run_stage(module, [*stage_args, "--device", args.device], log)
        stages[key] = time.perf_counter() - t0
        print(f"[pipeline]   {key} {stages[key]:.1f} s", flush=True)

    numdepth, diner, eval_downsample, eval_nsamples = recipe(args)
    split_dir = work / "splits"
    # written first: MVS training sees only the train scans
    write_splits(root, split_dir, args.val_scans)

    # ---- TransMVSNet training, then its depth PNGs into the tree
    if not args.skip_mvs:
        mvs_common = [
            "--trainpath", root, "--ndepths", args.ndepths,
            "--depth_inter_r", args.depth_inter_r, "--numdepth", numdepth,
            "--dtype", args.dtype, "--logdir", work / "mvs",
        ] + ([] if args.tiny else ["--remat"])
        stage("mvs_train_s", "diner_tpu_torch.mvs", mvs_common + [
            "--trainlist", split_dir / "dtu_train_all.txt",
            "--mode", "train", "--max-steps", args.mvs_steps])
        stage("mvs_write_s", "diner_tpu_torch.mvs", mvs_common + [
            "--trainlist", root / "list.txt", "--mode", "write_prediction",
            "--outpath", root])
        produced = sorted(root.rglob("depth_map_*_TransMVSNet.png"))
        if not produced:
            raise SystemExit("write_prediction produced no depth PNGs")
        print(f"[pipeline] MVS wrote {len(produced)} depth maps "
              f"(+conf/vis)", flush=True)

    # ---- DINER training on the MVS PNGs through data/dtu.py
    diner_root = work / "dtu_diner"
    t0 = time.perf_counter()
    make_diner_tree(root, diner_root)
    stages["diner_tree_s"] = time.perf_counter() - t0

    cfg_path = work / "train_diner_pipeline.yaml"
    cfg_path.write_text(DINER_CFG_TEMPLATE.format(
        workdir=work, root=diner_root, split_dir=split_dir,
        val_interval=args.val_interval or max(args.diner_steps // 4, 1),
        val_batches=2 if args.tiny else 4, val_views=args.val_views,
        sweep_frames=args.sweep_frames, n_sweeps=args.n_sweeps, **diner))
    if not args.skip_diner:
        stage("diner_train_s", "diner_tpu_torch.train",
              [cfg_path, "DINER", "--max-steps", args.diner_steps])

    ckpt_root = work / "diner" / "DINER_pipeline" / "checkpoints"
    ckpts = sorted(p for p in ckpt_root.glob("step_*") if p.is_dir())
    if not ckpts:
        raise SystemExit(f"no checkpoint under {ckpt_root}")

    # ---- the prediction folder and its scores (the full 512×640 protocol
    # with 64 samples in the reference's recipe)
    eval_cfg_path = work / "eval_diner_pipeline.yaml"
    ecfg = dict(diner, downsample=eval_downsample,
                pruned_extra=PRUNED_YAML if args.pruned == "both" else "")
    eval_cfg_path.write_text(DINER_CFG_TEMPLATE.format(
        workdir=work, root=diner_root, split_dir=split_dir,
        val_interval=10 ** 9, val_batches=1, val_views=args.val_views,
        sweep_frames=args.sweep_frames, n_sweeps=args.n_sweeps, **ecfg))
    pred_dir = work / "prediction"
    render_args = ["--config", eval_cfg_path, "--ckpt", ckpts[-1],
                   "--out", pred_dir, "--n", args.eval_n]
    if eval_nsamples:
        render_args += ["--nsamples", eval_nsamples]
    stage("render_s", "diner_tpu_torch.predict", render_args)
    stage("eval_s", "diner_tpu_torch.evaluate", [pred_dir])

    scores = json.loads((pred_dir / "average_scores.json").read_text())
    eval_hw = (int(512 * eval_downsample), int(640 * eval_downsample))
    rays = args.eval_n * eval_hw[0] * eval_hw[1]
    summary = {"stages_s": {k: round(v, 1) for k, v in stages.items()},
               "scores": scores,
               "n_images": args.eval_n,
               "eval_image_hw": list(eval_hw),
               "eval_rays_total": rays,
               "eval_rays_per_sec_incl_compile": round(
                   rays / stages["render_s"], 1),
               "config": str(cfg_path)}
    (work / "PIPELINE_RESULT.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
