"""``python -m toad_tpu_torch heatmap``: render a heatmap PNG from a saved
attention file (``infer --save_attention``'s ``.h5`` or ``.npz``), or from
any ``.h5`` / ``.npz`` holding ``attention`` (or ``scores``) and ``coords``.

Rendering apart from inference lets users try colormaps and downscales
without running the model again. The same command as ``python -m toad_tpu
heatmap``; ``.h5`` files need h5py and ``--background`` needs Pillow.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch heatmap", description=__doc__)
    p.add_argument("--attention", type=str, required=True, help=".h5 or .npz with attention/scores + coords")
    p.add_argument("--out", type=str, required=True, help="output PNG")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--downscale", type=int, default=32)
    p.add_argument("--cmap", type=str, default="jet")
    p.add_argument("--no_percentile", action="store_true",
                   help="min-max normalize raw scores instead of rank percentiles")
    p.add_argument("--background", type=str, default=None, help="thumbnail image to blend under the heatmap")
    p.add_argument("--alpha", type=float, default=0.5)
    return p


def read_attention(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(scores, coords) of an attention file: ``attention`` or ``scores``, and
    ``coords``, from an ``.npz`` or an ``.h5``."""
    if Path(path).suffix.lower() == ".npz":
        f = np.load(path)
        names = list(f.files)
    else:
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"reading {path} needs h5py, which is not installed; save the attention as .npz") from e
        f = h5py.File(path, "r")
        names = list(f)
    with f:
        key = "attention" if "attention" in names else ("scores" if "scores" in names else None)
        if key is None:
            raise KeyError(f"{path}: no 'attention'/'scores' dataset (found: {names})")
        if "coords" not in names:
            raise KeyError(f"{path}: no 'coords' dataset — heatmaps need patch positions")
        return np.asarray(f[key][:]), np.asarray(f["coords"][:])


def main(argv=None) -> None:
    from toad_tpu_torch.pipeline.heatmap import canvas_shape, render_heatmap, save_png

    args = make_parser().parse_args(argv)
    scores, coords = read_attention(args.attention)

    if args.no_percentile and len(scores):
        # raw attention scores are unbounded; min-max them into the colormap
        # domain (render_heatmap clips to [0, 1])
        lo, hi = float(scores.min()), float(scores.max())
        scores = (scores - lo) / (hi - lo) if hi > lo else np.zeros_like(scores)

    background = None
    if args.background:
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(f"--background {args.background} needs Pillow (PIL), which is not installed") from e

        h, w = canvas_shape(coords, args.patch_size, args.downscale)
        with Image.open(args.background) as im:
            background = np.asarray(im.convert("RGB").resize((w, h)))

    img = render_heatmap(
        coords,
        scores,
        patch_size=args.patch_size,
        downscale=args.downscale,
        cmap=args.cmap,
        percentile=not args.no_percentile,
        background=background,
        alpha=args.alpha,
    )
    save_png(args.out, img)
    print(f"wrote {Path(args.out).absolute()} ({img.shape[1]}x{img.shape[0]})")


if __name__ == "__main__":
    main()
