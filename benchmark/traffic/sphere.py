"""The one traffic generator: analytic sphere scenes, drawn on the card.

A scene is a sphere (radius and centre drawn from the seed) seen by
``source_views`` cameras on a ring at ``camera_distance`` and one target
camera between them, at the configuration's image size. Colour is
lambertian shading of the normals on a white background; each source view
carries its closed-form z-depth and a constant depth deviation where the
sphere is hit. A NOVEL configuration adds the canonical camera,
``mesh_vertices`` points on the sphere, seeded per-vertex offsets to the
source and canonical expressions, and smooth positional-encoding maps.

Every seed gives scenes of the same sizes; only the values differ. The
parameters (ranges, pool size, offsets) come from the traffic file.
"""

from __future__ import annotations

import math

import torch


def _uniform(gen, n, lo, hi, device):
    return lo + (hi - lo) * torch.rand(n, generator=gen, device=device)


def look_at(eye, target):
    """(B, 3) eyes and targets → (B, 4, 4) world→camera extrinsics, the
    camera's y axis pointing down the image."""
    up = torch.tensor([0.0, 1.0, 0.0], device=eye.device).expand_as(eye)
    fwd = torch.nn.functional.normalize(target - eye, dim=-1)
    right = torch.nn.functional.normalize(torch.cross(fwd, up, dim=-1),
                                          dim=-1)
    down = torch.cross(fwd, right, dim=-1)
    R = torch.stack([right, down, fwd], dim=1)  # rows: camera axes
    E = torch.eye(4, device=eye.device).repeat(eye.shape[0], 1, 1)
    E[:, :3, :3] = R
    E[:, :3, 3] = -(R @ eye[..., None])[..., 0]
    return E


def intrinsics(H: int, W: int, device):
    f = 1.2 * max(H, W)
    return torch.tensor([[f, 0.0, W / 2], [0.0, f, H / 2], [0.0, 0.0, 1.0]],
                        device=device)


def render_sphere(E, K, H: int, W: int, radius, centre):
    """Cameras (B, 4, 4), intrinsics (3, 3), spheres (B,), (B, 3) →
    rgb (B, H, W, 3), z-depth (B, H, W) (0 off the sphere), hit (B, H, W)."""
    dev = E.device
    R, t = E[:, :3, :3], E[:, :3, 3]
    cam = -(R.transpose(1, 2) @ t[..., None])[..., 0]          # (B, 3)
    xs = (torch.arange(W, device=dev) + 0.5 - K[0, 2]) / K[0, 0]
    ys = (torch.arange(H, device=dev) + 0.5 - K[1, 2]) / K[1, 1]
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    d_cam = torch.nn.functional.normalize(
        torch.stack([gx, gy, torch.ones_like(gx)], -1), dim=-1)
    dirs = torch.einsum("hwj,bij->bhwi", d_cam, R.transpose(1, 2))
    oc = (cam - centre)[:, None, None, :]
    b = 2.0 * (dirs * oc).sum(-1)
    cq = (oc * oc).sum(-1) - radius[:, None, None] ** 2
    disc = b * b - 4.0 * cq
    s = (-b - torch.sqrt(disc.clamp_min(0.0))) / 2.0
    hit = (disc > 0) & (s > 0)
    pts = cam[:, None, None, :] + s[..., None] * dirs
    z = torch.einsum("bhwj,bij->bhwi", pts, R)[..., 2] + t[:, None, None, 2]
    z = torch.where(hit, z, torch.zeros_like(z))
    normals = (pts - centre[:, None, None, :]) / radius[:, None, None, None]
    light = torch.nn.functional.normalize(
        torch.tensor([0.5, 0.7, 0.5], device=dev), dim=0)
    lam = (normals @ light).clamp(0.0, 1.0)
    base = (normals * 0.5 + 0.5).clamp(0.0, 1.0)
    rgb = 0.2 * base + 0.8 * base * lam[..., None]
    rgb = torch.where(hit[..., None], rgb, torch.ones_like(rgb))
    return rgb, z, hit.float()


def pe_map(H: int, W: int, phase, device):
    """(B,) phases → (B, H, W, 3) smooth positional-encoding stamps."""
    y, x = torch.meshgrid(torch.linspace(-1, 1, H, device=device),
                          torch.linspace(-1, 1, W, device=device),
                          indexing="ij")
    p = phase[:, None, None]
    return torch.stack([torch.sin(3 * x + p), torch.cos(3 * y - p),
                        torch.sin(2 * (x + y)).expand_as(3 * x + p)], -1)


def make_scenes(config: dict, traffic: dict, n: int, gen, device) -> dict:
    """``n`` scenes as one batch of tensors on ``device`` (the program's
    batch keys, scene axis first), drawn from the generator ``gen``."""
    H, W = config["image_hw"]
    nv = config["source_views"]
    tr = traffic
    dist = tr["camera_distance"]
    radius = _uniform(gen, n, *tr["radius"], device)
    centre = (torch.rand((n, 3), generator=gen, device=device) * 2 - 1) \
        * tr["centre_jitter"]
    a0 = _uniform(gen, n, 0.0, 2 * math.pi, device)
    K = intrinsics(H, W, device)

    src_a = a0[:, None] + 0.3 + torch.arange(nv, device=device) * (
        2 * math.pi / nv)                                       # (n, nv)
    eyes = torch.stack([dist * torch.sin(src_a),
                        torch.full_like(src_a, tr["source_height"]),
                        -dist * torch.cos(src_a)], -1).reshape(-1, 3)
    E_src = look_at(eyes, torch.zeros_like(eyes))
    rgb, z, _ = render_sphere(E_src, K, H, W, radius.repeat_interleave(nv),
                              centre.repeat_interleave(nv, 0))

    t_a = a0 + 0.3 + _uniform(gen, n, *tr["target_angle_offset"], device)
    t_h = _uniform(gen, n, *tr["target_height"], device)
    t_eye = torch.stack([dist * torch.sin(t_a), t_h, -dist * torch.cos(t_a)],
                        -1)
    E_t = look_at(t_eye, torch.zeros_like(t_eye))
    t_rgb, t_z, t_hit = render_sphere(E_t, K, H, W, radius, centre)

    depth = z.reshape(n, nv, H, W, 1)
    batch = dict(
        src_rgbs=rgb.reshape(n, nv, H, W, 3),
        src_depths=depth,
        src_depth_stds=torch.where(depth > 0, tr["depth_std"], 0.0),
        src_extrinsics=E_src.reshape(n, nv, 4, 4),
        src_intrinsics=K.expand(n, nv, 3, 3).contiguous(),
        target_rgb=t_rgb, target_alpha=t_hit[..., None],
        target_depth=t_z[..., None], target_extrinsics=E_t,
        target_intrinsics=K.expand(n, 3, 3).contiguous())
    if config["family"] == "novel":
        batch.update(novel_keys(config, traffic, n, gen, device, radius,
                                centre, K, a0))
    return batch


def novel_keys(config, traffic, n, gen, device, radius, centre, K, a0):
    """The canonical camera, the target mesh, its offsets and the PE maps."""
    H, W = config["image_hw"]
    nv, V = config["source_views"], config["mesh_vertices"]
    eye = torch.tensor([0.0, 0.35, -traffic["camera_distance"]],
                       device=device).expand(n, 3)
    d = torch.nn.functional.normalize(
        torch.randn((n, V, 3), generator=gen, device=device), dim=-1)
    verts = centre[:, None, :] + radius[:, None, None] * d
    std = traffic["vertex_offset_std"]
    keys = dict(
        gen_extrinsics=look_at(eye, torch.zeros_like(eye)),
        gen_intrinsics=K.expand(n, 3, 3).contiguous(),
        target_vertices=verts,
        offset_target_to_source=std * torch.randn(
            (n, V, 3), generator=gen, device=device),
        offset_target_to_gen=std * torch.randn(
            (n, V, 3), generator=gen, device=device))
    if config.get("use_pe_maps"):
        phases = a0[:, None] + 0.5 * torch.arange(nv, device=device)
        keys["src_pos_encodings"] = pe_map(
            H, W, phases.reshape(-1), device).reshape(n, nv, H, W, 3)
        keys["target_pos_encoding"] = pe_map(H, W, a0 + 1.0, device)
    return keys


def patch_pixels(target_alpha, spatch: int, gen):
    """(SB, spatch²) flat indices of a square patch per scene whose centre
    is drawn in proportion to the target's alpha, borders of
    ``(spatch + 1) // 2`` left out; the patch's pixels row by row."""
    SB, H, W, _ = target_alpha.shape
    pad = (spatch + 1) // 2
    fg = torch.zeros_like(target_alpha[..., 0])
    fg[:, pad:-pad, pad:-pad] = target_alpha[:, pad:-pad, pad:-pad, 0]
    centres = torch.multinomial(fg.reshape(SB, H * W), 1,
                                generator=gen)[:, 0]
    cx, cy = centres % W, centres // W
    d = torch.arange(spatch, device=fg.device)
    px = cx[:, None, None] + d[None, None, :] - pad
    py = cy[:, None, None] + d[None, :, None] - pad
    return (px + py * W).reshape(SB, spatch * spatch)


def renderer_noise(rcfg: dict, SB: int, NR: int, gen, device):
    """``(u_coarse, gauss, u_fill)`` for ``NR`` rays of ``SB`` scenes."""
    kw = dict(generator=gen, device=device)
    gauss = (torch.randn((SB, NR, rcfg["n_gaussian"]), **kw)
             if rcfg["n_gaussian"] > 0 else None)
    return (torch.rand((SB, NR, rcfg["n_depth_candidates"]), **kw), gauss,
            torch.rand((SB, NR, rcfg["n_samples"]), **kw))
