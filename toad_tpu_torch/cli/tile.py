"""``python -m toad_tpu_torch tile``: raster images -> CLAM-style patch files.

The same command as ``python -m toad_tpu tile``: every PNG/JPEG/TIFF/BMP in
``--image_dir`` is grid-tiled with a saturation tissue filter and written to
``--patch_dir`` as ``{name}.h5``; where h5py is not installed, as
``{name}.npz`` with the same ``imgs`` and ``coords`` keys, which
``featurize`` reads too. Reading the images needs Pillow. No device work.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".tif", ".tiff", ".bmp")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch tile", description=__doc__)
    p.add_argument("--image_dir", type=str, required=True, help="dir of RGB slide images")
    p.add_argument("--patch_dir", type=str, required=True, help="output dir for {name}.h5 (or .npz) patch files")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--stride", type=int, default=None, help="default: patch_size (no overlap)")
    p.add_argument("--tissue_thresh", type=float, default=0.05,
                   help="keep tiles with mean saturation above this; negative disables filtering")
    p.add_argument("--skip_done", action="store_true")
    return p


def _patch_ext() -> str:
    try:
        import h5py  # noqa: F401
    except ImportError:
        print("h5py is not installed: writing .npz patch files (keys imgs, coords)", file=sys.stderr)
        return ".npz"
    return ".h5"


def main(argv=None) -> None:
    from toad_tpu_torch.pipeline.tiling import image_to_patch_file

    args = make_parser().parse_args(argv)
    image_dir, patch_dir = Path(args.image_dir), Path(args.patch_dir)
    patch_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(p for p in image_dir.iterdir() if p.suffix.lower() in IMAGE_EXTS)
    if not files:
        raise FileNotFoundError(f"no images ({'/'.join(IMAGE_EXTS)}) in {image_dir}")
    ext = _patch_ext()
    thresh = None if args.tissue_thresh < 0 else args.tissue_thresh
    total = 0
    for i, src in enumerate(files):
        out = patch_dir / f"{src.stem}{ext}"
        if args.skip_done and out.exists():
            print(f"[{i + 1}/{len(files)}] {src.stem}: exists, skipped")
            continue
        stats = image_to_patch_file(src, out, patch_size=args.patch_size, stride=args.stride, tissue_threshold=thresh)
        total += stats["n_patches"]
        print(f"[{i + 1}/{len(files)}] {src.stem}: {stats['n_patches']}/{stats['n_grid']} tiles kept -> {out}")
    print(json.dumps({"slides": len(files), "patches": total}))


if __name__ == "__main__":
    main()
