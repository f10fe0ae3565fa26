"""Attention heatmaps: per-patch attention scores + coords -> rendered image.

Counterpart of :mod:`toad_tpu.pipeline.heatmap`, in numpy and the standard
library. Scores are rank-normalized to percentiles (robust to the long
attention tail over 10^4+ patches), painted onto a downscaled slide canvas at
each patch's coordinate and colorized, optionally blended over a slide
thumbnail. matplotlib (colormaps) and Pillow (image writing) are used where
they are installed and imported only inside the functions; without them the
built-in jet ramp and the stdlib PNG writer run.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def to_percentiles(scores: np.ndarray) -> np.ndarray:
    """Rank-normalize to [0, 1] (ties get their average rank)."""
    scores = np.asarray(scores, np.float64).ravel()
    order = scores.argsort()
    ranks = np.empty_like(order, dtype=np.float64)
    # average ranks for ties
    if len(scores) > 1:
        sorted_scores = scores[order]
        _, inv, counts = np.unique(sorted_scores, return_inverse=True, return_counts=True)
        start = np.concatenate([[0], np.cumsum(counts)[:-1]])
        avg = start + (counts - 1) / 2.0
        ranks[order] = avg[inv]
        return ranks / max(len(scores) - 1, 1)
    return np.zeros_like(scores)


_JET_STOPS = np.array(
    [
        (0.00, (0, 0, 143)),
        (0.125, (0, 0, 255)),
        (0.375, (0, 255, 255)),
        (0.625, (255, 255, 0)),
        (0.875, (255, 0, 0)),
        (1.00, (128, 0, 0)),
    ],
    dtype=object,
)


def colorize(values: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """[...,] floats in [0,1] -> [..., 3] uint8. Uses matplotlib when
    available; falls back to a built-in jet ramp."""
    values = np.clip(np.asarray(values, np.float32), 0.0, 1.0)
    try:
        from matplotlib import colormaps
    except ImportError:
        if cmap != "jet":
            raise ValueError(f"cmap {cmap!r} needs matplotlib (not installed); only the built-in 'jet' works without it")
        xs = np.array([s[0] for s in _JET_STOPS], np.float32)
        cs = np.array([s[1] for s in _JET_STOPS], np.float32)
        out = np.stack([np.interp(values, xs, cs[:, i]) for i in range(3)], axis=-1)
        return out.astype(np.uint8)
    if cmap not in colormaps:
        raise ValueError(f"unknown colormap {cmap!r}; see matplotlib.colormaps for choices")
    rgba = colormaps[cmap](values)
    return (rgba[..., :3] * 255).astype(np.uint8)


def canvas_shape(coords: np.ndarray, patch_size: int, downscale: int) -> tuple[int, int]:
    """(H, W) of the rendered canvas for these coords — the single source of
    truth shared by render_heatmap and callers that pre-resize backgrounds."""
    coords = np.asarray(coords)
    w0 = int(coords[:, 0].max()) + patch_size if len(coords) else patch_size
    h0 = int(coords[:, 1].max()) + patch_size if len(coords) else patch_size
    return max(1, h0 // downscale), max(1, w0 // downscale)


def render_heatmap(
    coords: np.ndarray,
    scores: np.ndarray,
    patch_size: int = 256,
    downscale: int = 32,
    cmap: str = "jet",
    percentile: bool = True,
    canvas_wh: tuple[int, int] | None = None,
    background: np.ndarray | None = None,
    alpha: float = 0.5,
) -> np.ndarray:
    """Paint per-patch scores at slide coordinates.

    Args:
      coords: [N, 2] top-left (x, y) patch coordinates in level-0 pixels.
      scores: [N] attention scores (raw; percentile-normalized by default).
      patch_size: patch edge in level-0 pixels.
      downscale: canvas downscale factor relative to level 0.
      canvas_wh: explicit canvas (width, height) at level 0; inferred from
        coords extent when omitted.
      background: optional [H, W, 3] uint8 thumbnail already at the canvas
        size to alpha-blend under the heatmap.
      alpha: heatmap opacity over the background.

    Returns [H, W, 3] uint8 image.
    """
    coords = np.asarray(coords, np.int64)
    scores = np.asarray(scores, np.float32).ravel()
    if coords.shape[0] != scores.shape[0]:
        raise ValueError(f"coords ({coords.shape[0]}) and scores ({scores.shape[0]}) disagree")
    if percentile and len(scores):
        scores = to_percentiles(scores).astype(np.float32)

    if canvas_wh is None:
        H, W = canvas_shape(coords, patch_size, downscale)
    else:
        w0, h0 = canvas_wh
        W, H = max(1, w0 // downscale), max(1, h0 // downscale)
    ps = max(1, patch_size // downscale)

    # Vectorized rectangle painting (10^4-10^5 patches on a 1-core host — a
    # per-patch Python loop costs seconds per /heatmap request): scatter each
    # patch's four difference-array corners, then a 2-D cumsum paints every
    # ps x ps extent at once. Exact same sums as the naive loop.
    xy = coords // downscale
    keep = (xy[:, 0] >= 0) & (xy[:, 1] >= 0) & (xy[:, 0] < W) & (xy[:, 1] < H)
    xs, ys = xy[keep, 0], xy[keep, 1]
    x2, y2 = np.minimum(xs + ps, W), np.minimum(ys + ps, H)

    def _paint(vals: np.ndarray) -> np.ndarray:
        diff = np.zeros((H + 1, W + 1), np.float64)
        np.add.at(diff, (ys, xs), vals)
        np.add.at(diff, (ys, x2), -vals)
        np.add.at(diff, (y2, xs), -vals)
        np.add.at(diff, (y2, x2), vals)
        return diff.cumsum(axis=0).cumsum(axis=1)[:H, :W].astype(np.float32)

    acc = _paint(scores[keep].astype(np.float64))
    cnt = _paint(np.ones(int(keep.sum()), np.float64))
    covered = cnt > 0.5  # counts are integers up to fp noise
    heat = np.zeros((H, W), np.float32)
    heat[covered] = acc[covered] / cnt[covered]

    rgb = colorize(heat, cmap=cmap)
    if background is not None:
        bg = np.asarray(background, np.uint8)
        if bg.shape[:2] != (H, W):
            raise ValueError(f"background {bg.shape[:2]} != canvas {(H, W)}")
        out = bg.astype(np.float32)
        out[covered] = (1 - alpha) * out[covered] + alpha * rgb[covered].astype(np.float32)
        return out.astype(np.uint8)
    rgb[~covered] = 255  # white background where no tissue patches
    return rgb


def encode_png(image: np.ndarray) -> bytes:
    """RGB uint8 [H, W, 3] -> PNG bytes (PIL when present, else a minimal
    stdlib writer). Shared by file export and the serving /heatmap route."""
    try:
        from io import BytesIO

        from PIL import Image

        buf = BytesIO()
        Image.fromarray(image).save(buf, format="PNG")
        return buf.getvalue()
    except ImportError:  # minimal PNG writer fallback
        import struct
        import zlib

        h, w = image.shape[:2]
        raw = b"".join(b"\x00" + image[i].tobytes() for i in range(h))

        def chunk(tag, data):
            c = tag + data
            return struct.pack(">I", len(data)) + c + struct.pack(">I", zlib.crc32(c))

        return (
            b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw))
            + chunk(b"IEND", b"")
        )


def save_png(path: str | os.PathLike, image: np.ndarray) -> None:
    """Write the image; non-.png extensions keep PIL's format-by-extension
    behavior (e.g. ``out.jpg`` really is a JPEG) when PIL is available."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix.lower() not in ("", ".png"):
        try:
            from PIL import Image

            Image.fromarray(image).save(path)
            return
        except ImportError:
            pass  # stdlib fallback can only write PNG bytes
    path.write_bytes(encode_png(image))
