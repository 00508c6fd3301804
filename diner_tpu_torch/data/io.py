"""Host-side image / depth codecs (framework-free numpy and PIL).

Port-side copy of ``diner_tpu/data/io.py``. Parity targets: reference ``src/util/io.py`` (PFM), the uint16 depth-PNG
protocol (×1e-4 meters, ``src/data/dtu.py:104-108``,
``deps/TransMVSNet/utils.py:21``), and torchvision-style nearest resize.
"""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

DEPTH_PNG_SCALE = 1e-4  # uint16 → meters


def read_pfm(path):
    """Read a PFM file → (data, scale). Handles endianness and flipud."""
    with open(path, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"Not a PFM file: {path}")
        dims = f.readline().decode("utf-8")
        m = re.match(r"^(\d+)\s(\d+)\s$", dims)
        if not m:
            raise ValueError(f"Malformed PFM header: {dims!r}")
        width, height = map(int, m.groups())
        scale = float(f.readline().decode("utf-8").rstrip())
        endian = "<" if scale < 0 else ">"
        scale = abs(scale)
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    data = np.reshape(data, shape)
    return np.flipud(data), scale


def write_pfm(path, image: np.ndarray, scale: float = 1.0):
    """Write a (H, W) or (H, W, 3) float32 array as PFM (little-endian)."""
    image = np.asarray(image, np.float32)
    color = image.ndim == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-scale}\n".encode())
        np.flipud(image).astype("<f").tofile(f)


def read_depth_png(path) -> np.ndarray:
    """uint16 depth PNG → float32 meters (H, W)."""
    from PIL import Image
    img = np.asarray(Image.open(path))
    return img.astype(np.float32) * DEPTH_PNG_SCALE


def write_depth_png(path, depth_m: np.ndarray):
    """float32 meters → uint16 depth PNG (×1e4, clipped to uint16 range)."""
    from PIL import Image
    q = np.clip(np.asarray(depth_m, np.float64) / DEPTH_PNG_SCALE, 0, 65535)
    Image.fromarray(q.astype(np.uint16)).save(path)


def read_rgb(path, downsample: float | None = None) -> np.ndarray:
    """PNG/JPG → float32 (H, W, C) in [0, 1]; optional PIL resize (bicubic,
    like the reference's PIL default)."""
    from PIL import Image
    img = Image.open(path)
    if downsample and downsample != 1:
        w, h = img.size
        img = img.resize((int(w * downsample), int(h * downsample)))
    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr


def resize_bilinear(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv2.INTER_LINEAR semantics: half-pixel centers, edge clamp.

    img: (H, W) or (H, W, C) float.
    """
    H, W = img.shape[:2]
    ys = (np.arange(h) + 0.5) * (H / h) - 0.5
    xs = (np.arange(w) + 0.5) * (W / w) - 0.5
    y0 = np.clip(np.floor(ys), 0, H - 1).astype(int)
    x0 = np.clip(np.floor(xs), 0, W - 1).astype(int)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)
    wx = np.clip(xs - x0, 0.0, 1.0)
    if img.ndim == 3:
        wy_ = wy[:, None, None]
        wx_ = wx[None, :, None]
    else:
        wy_ = wy[:, None]
        wx_ = wx[None, :]
    top = img[y0][:, x0] * (1 - wx_) + img[y0][:, x1] * wx_
    bot = img[y1][:, x0] * (1 - wx_) + img[y1][:, x1] * wx_
    return (top * (1 - wy_) + bot * wy_).astype(img.dtype, copy=False)


def resize_nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """torch F.interpolate(mode='nearest') semantics: src = floor(dst·in/out).

    img: (H, W) or (H, W, C).
    """
    H, W = img.shape[:2]
    rows = np.floor(np.arange(h) * (H / h)).astype(int)
    cols = np.floor(np.arange(w) * (W / w)).astype(int)
    return img[rows][:, cols]
