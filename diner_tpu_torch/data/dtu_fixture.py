"""Fabricate geometrically consistent DTU-protocol scans.

Port-side copy of ``scripts/make_dtu_fixture.py``. Renders procedurally
textured, gently curved surfaces from the DTU rig's 49 cameras (reference
``deps/TransMVSNet/datasets/dtu_yao.py``): 1200x1600 ``Rectified`` images,
1200x1600 PFM GT depths + ``depth_visual`` masks, and ``Cameras/train``
cam.txt files whose intrinsics are stage1-scale (128x160), matching the
``prepare_img`` crop chain (x1/2 nearest, centre-crop 512x640). Depths are
metric-plausible (surfaces around z = 600 mm, DTU's 425..~900 sweep).

It exists so TransMVSNet and DINER can run on the GPU without the
(licensed) DTU data. ``--scans N`` gives each scan a distinct
deterministic geometry and texture; ``--light-gains`` materialises the 7
DTU light conditions as brightness variants (without it, lights are
symlinks to one render); ``--cams`` renders only the listed cameras (all
49 cam files are written either way).

Usage:
    python -m diner_tpu_torch.data.dtu_fixture <outdir> [--scans 6]
        [--lights 7] [--light-gains] [--jobs 8] [--cams 6,10,24,30,35]
"""

import argparse
from pathlib import Path

import numpy as np

from diner_tpu_torch.data.io import write_pfm

# brightness multipliers for the 7 DTU light conditions when --light-gains
# is on (DTU's r5000 renders vary illumination strongly; exact photometry
# is irrelevant, cross-light variation is what the protocol needs)
LIGHT_GAINS = (0.55, 0.70, 0.85, 1.00, 1.15, 1.30, 1.45)


def scan_params(k: int) -> dict:
    """Deterministic per-scan geometry/texture perturbation. k=0 reproduces
    the original single-scan fixture exactly."""
    if k == 0:
        return dict(tp=(0.0, 0.0, 0.0), tf=1.0, z0=600.0,
                    amp=(60.0, 25.0), gf=1.0, gp=(0.0, 0.0))
    rng = np.random.RandomState(1234 + k)
    return dict(
        tp=tuple(rng.uniform(0, 2 * np.pi, 3)),       # texture phases
        tf=float(rng.uniform(0.7, 1.5)),              # texture freq scale
        z0=float(rng.uniform(540.0, 680.0)),          # surface base depth
        amp=(float(rng.uniform(35.0, 75.0)),          # bump amplitudes
             float(rng.uniform(12.0, 35.0))),
        gf=float(rng.uniform(0.7, 1.4)),              # geometry freq scale
        gp=tuple(rng.uniform(0, 2 * np.pi, 2)),       # geometry phases
    )


def _texture(x, y, p):
    """Procedural RGB texture over world (x, y) mm — high-frequency enough
    for photometric matching to be meaningful."""
    f, (p0, p1, p2) = p["tf"], p["tp"]
    r = 0.5 + 0.25 * np.sin(x * 0.11 * f + p0) * np.cos(y * 0.13 * f) \
        + 0.25 * np.sin(0.031 * f * (x + 2 * y) + p1)
    g = 0.5 + 0.25 * np.cos(x * 0.07 * f + 1.0 + p2) * np.sin(y * 0.17 * f) \
        + 0.25 * np.cos(0.023 * f * (2 * x - y) + p0)
    b = 0.5 + 0.5 * np.sin(0.05 * f * x + 0.09 * f * y + 2.0 + p1)
    return np.clip(np.stack([r, g, b], -1), 0.0, 1.0)


def _surface_z(x, y, p):
    """Curved surface z(x, y) in mm."""
    f, (q0, q1) = p["gf"], p["gp"]
    return p["z0"] + p["amp"][0] * np.sin(x * 0.012 * f + q0) \
        * np.cos(y * 0.015 * f) \
        + p["amp"][1] * np.sin(0.03 * f * (x - y) + q1)


def render_view(K_hr, E, H, W, p):
    """Ray-march (4 fixed-point iters; gentle slopes) the surface from a
    camera with world-to-cam extrinsic E; returns (rgb float 0..1, depth f32).

    The iteration converges to *cam-space* depth only because every
    generated extrinsic is a pure translation (R = I, see main()): then
    world z == cam z and ``z`` below is the returned depth directly. If the
    camera grid ever gains rotations, compute cam-space z explicitly as
    ``(R @ p + t)[2]``."""
    R, t = E[:3, :3], E[:3, 3]
    cam_origin = (-R.T @ t).astype(np.float32)  # camera center in world
    R = R.astype(np.float32)
    # float32 throughout: the transcendental-heavy march is ~2x faster and
    # mm-scale depths (~600) lose nothing that matters to a synthetic scan
    u, v = np.meshgrid(np.arange(W, dtype=np.float32) + 0.5,
                       np.arange(H, dtype=np.float32) + 0.5)
    K_hr = K_hr.astype(np.float32)
    d_cam = np.stack([(u - K_hr[0, 2]) / K_hr[0, 0],
                      (v - K_hr[1, 2]) / K_hr[1, 1],
                      np.ones_like(u)], -1)
    d_world = d_cam @ R  # == R.T @ d_cam per-pixel
    z = np.full((H, W), p["z0"], np.float32)
    for _ in range(4):
        # cam-space depth z == t_ray * d_cam_z (d_cam_z = 1 by construction)
        pt = cam_origin + d_world * z[..., None]
        z = z + 0.8 * (_surface_z(pt[..., 0], pt[..., 1], p)
                       - pt[..., 2])  # move along ray toward the surface
    pt = cam_origin + d_world * z[..., None]
    rgb = _texture(pt[..., 0], pt[..., 1], p)
    return rgb, z.astype(np.float32)


def fixture_intrinsics():
    """(K_s1, K_hr): the stage1-scale (128x160) intrinsics the cam files
    hold, and those of the 1200x1600 renders (x4 to 512x640, x2 to the
    half-res canvas, the ``prepare_img`` crop's offset undone)."""
    K_s1 = np.array([[180.0, 0, 80.0], [0, 180.0, 64.0], [0, 0, 1]])
    K_hr = K_s1.copy()
    K_hr[:2] *= 8.0
    K_hr[0, 2] += 160.0  # undo prepare_img crop (cols 80 @ half-res)
    K_hr[1, 2] += 88.0   # rows 44 @ half-res
    return K_s1, K_hr


def make_camera(i):
    E = np.eye(4)
    E[0, 3] = 12.0 * (i % 7 - 3)
    E[1, 3] = 9.0 * (i // 7 - 3)
    return E


def write_scan(root: Path, scan: str, scan_idx: int, lights: int,
               light_gains: bool, H: int, W: int, K_hr, cams=range(49)
               ) -> None:
    (root / "Rectified" / f"{scan}_train").mkdir(parents=True, exist_ok=True)
    (root / "Depths" / scan).mkdir(parents=True, exist_ok=True)
    from PIL import Image

    p = scan_params(scan_idx)
    for i in cams:
        # resume guard: the pfm is the last artifact written per cam, so
        # its presence means this cam's images are already complete
        if (root / "Depths" / scan / f"depth_map_{i:04d}.pfm").exists():
            continue
        E = make_camera(i)
        rgb, depth = render_view(K_hr, E, H, W, p)
        img0 = root / "Rectified" / f"{scan}_train" / \
            f"rect_{i + 1:03d}_0_r5000.png"
        if light_gains:
            for light in range(lights):
                out = (np.clip(rgb * LIGHT_GAINS[light], 0, 1)
                       * 255).astype(np.uint8)
                # compress_level=1: these are throwaway synthetic renders;
                # encode speed dominates fixture build time at 7 lights
                Image.fromarray(out).save(
                    img0.with_name(f"rect_{i + 1:03d}_{light}_r5000.png"),
                    compress_level=1)
        else:
            Image.fromarray((rgb * 255).astype(np.uint8)).save(
                img0, compress_level=1)
            for light in range(1, lights):
                dst = img0.with_name(f"rect_{i + 1:03d}_{light}_r5000.png")
                if not dst.exists():
                    dst.symlink_to(img0.name)
        write_pfm(root / "Depths" / scan / f"depth_map_{i:04d}.pfm", depth)
        Image.fromarray(np.full((H, W), 255, np.uint8)).save(
            root / "Depths" / scan / f"depth_visual_{i:04d}.png")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m diner_tpu_torch.data."
                                 "dtu_fixture")
    ap.add_argument("outdir")
    ap.add_argument("--lights", type=int, default=7,
                    help="how many of the 7 light conditions to materialize")
    ap.add_argument("--light-gains", action="store_true",
                    help="materialize lights as real brightness variants "
                         "instead of symlinks to one render")
    ap.add_argument("--scan", default="scan1",
                    help="scan name when --scans is 1")
    ap.add_argument("--scans", type=int, default=1,
                    help="generate scan1..scanN, each with distinct "
                         "deterministic geometry + texture")
    ap.add_argument("--jobs", type=int, default=1,
                    help="parallel scan-rendering processes")
    ap.add_argument("--cams", default=None,
                    help="comma-separated camera ids to render (default: "
                         "all 49)")
    args = ap.parse_args(argv)
    cams = (range(49) if args.cams is None
            else [int(c) for c in args.cams.split(",")])

    root = Path(args.outdir)
    (root / "Cameras/train").mkdir(parents=True, exist_ok=True)

    H, W = 1200, 1600
    K_s1, K_hr = fixture_intrinsics()

    for i in range(49):
        E = make_camera(i)
        lines = ["extrinsic"]
        lines += [" ".join(f"{x:.6f}" for x in row) for row in E]
        lines += ["", "intrinsic"]
        lines += [" ".join(f"{x:.6f}" for x in row) for row in K_s1]
        lines += ["", "425.0 2.5"]
        (root / "Cameras/train" / f"{i:08d}_cam.txt").write_text(
            "\n".join(lines) + "\n")

    scans = ([args.scan] if args.scans == 1
             else [f"scan{k + 1}" for k in range(args.scans)])
    jobs = [(root, s, k, args.lights, args.light_gains, H, W, K_hr, cams)
            for k, s in enumerate(scans)]
    if args.jobs > 1 and len(jobs) > 1:
        import multiprocessing as mp
        with mp.get_context("spawn").Pool(min(args.jobs, len(jobs))) as pool:
            pool.starmap(write_scan, jobs)
    else:
        for j in jobs:
            write_scan(*j)

    listfile = root / "list.txt"
    listfile.write_text("\n".join(scans) + "\n")
    print(f"fixture at {root} (list: {listfile})")
    return root


if __name__ == "__main__":
    main()
