"""Host-side visualization helpers: a colour map, an image writer and a
video writer.

Port of ``diner_tpu/utils/visual.py`` (reference
``src/util/torch_helpers.py:43-97``): ``colorize`` looks values up in the
viridis table stored in ``utils/viridis.py`` exactly as matplotlib's
``ListedColormap`` does, ``save_image`` writes 8-bit images with PIL, and
``save_video`` writes an mp4 where imageio has an ffmpeg backend and
otherwise an animated GIF with PIL, as the JAX version falls back to GIF.
None of them needs matplotlib; only the mp4 needs imageio.
"""

from __future__ import annotations

import numpy as np

from diner_tpu_torch.utils.viridis import VIRIDIS

_VIRIDIS = np.asarray(VIRIDIS, np.float64)  # (256, 3)


def colorize(x: np.ndarray, cmap: str = "viridis", vmin=None, vmax=None
             ) -> np.ndarray:
    """(H, W) or (H, W, 1) scalar map → (H, W, 3) float RGB in [0, 1]."""
    if cmap != "viridis":
        raise ValueError(f"colorize: only viridis is stored, not {cmap!r}")
    x = np.asarray(x, np.float64)
    if x.ndim == 3:
        x = x[..., 0]
    lo = np.min(x) if vmin is None else vmin
    hi = np.max(x) if vmax is None else vmax
    denom = (hi - lo) if hi > lo else 1.0
    x = (x - lo) / denom
    # matplotlib's float lookup: index floor(256 x), 1.0 the last entry;
    # below 0 the first, above 1 the last, NaN black
    n = len(_VIRIDIS)
    xa = x * n
    xa[xa == n] = n - 1
    bad = np.isnan(xa)
    with np.errstate(invalid="ignore"):
        idx = np.clip(np.where(bad, 0, xa), 0, n - 1).astype(int)
    rgb = _VIRIDIS[idx]
    rgb[bad] = 0.0
    return rgb.astype(np.float32)


def save_image(path, img: np.ndarray):
    """float (H, W, 3) in [0, 1] → 8-bit PNG."""
    from PIL import Image

    img = np.clip(np.asarray(img), 0.0, 1.0)
    Image.fromarray((img * 255).astype(np.uint8)).save(str(path))


def save_video(path, frames: np.ndarray, fps: int = 5) -> str:
    """frames (N, H, W, 3) in [0, 1] → an mp4 at ``path`` where imageio can
    write one, else an animated GIF beside it (``.gif``, 1/fps s a frame,
    looping); returns the path written."""
    frames8 = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    path = str(path)
    try:
        import imageio.v2 as imageio
        imageio.mimwrite(path, frames8, fps=fps, quality=10)
        return path
    except Exception:  # no imageio, or no ffmpeg backend for it
        pass
    from PIL import Image
    gif = path.rsplit(".", 1)[0] + ".gif"
    images = [Image.fromarray(f) for f in frames8]
    images[0].save(gif, save_all=True, append_images=images[1:],
                   duration=int(round(1000 / fps)), loop=0)
    return gif
