"""Image tiling: RGB images -> CLAM-style patch files (``imgs`` + ``coords``).

Counterpart of :mod:`toad_tpu.pipeline.tiling`: grid tiling of plain raster
images (PNG/JPEG/TIFF via Pillow) with a saturation-based tissue filter (H&E
background is near-white, i.e. of low saturation), written in the layout the
featurizer reads. A patch file is an ``.h5`` (needs h5py) or an ``.npz`` with
the same ``imgs`` and ``coords`` keys, for machines without h5py. Pillow and
h5py are imported only by the functions that need them.

Pyramidal scanner formats (.svs etc.) need openslide; their users bring CLAM
patch files directly.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np


def saturation(tiles: np.ndarray, chunk: int = 1024) -> np.ndarray:
    """Mean HSV saturation per tile, vectorized from RGB uint8.
    tiles: [N, H, W, 3] -> [N] floats in [0, 1]. Computed in chunks, so the
    float temporaries stay a chunk's size on slides of tens of thousands of
    tiles."""
    out = np.empty(len(tiles), np.float32)
    for i in range(0, len(tiles), chunk):
        # uint8 min/max first: the only float array is [n, H, W], not [n, H, W, 3]
        mx8 = tiles[i : i + chunk].max(axis=-1)
        mn8 = tiles[i : i + chunk].min(axis=-1)
        mx = mx8.astype(np.float32)
        sat = np.where(mx8 > 0, (mx - mn8.astype(np.float32)) / np.maximum(mx, 1e-6), 0.0)
        out[i : i + chunk] = sat.mean(axis=(1, 2))
    return out


def tile_image(
    image: np.ndarray,  # [H, W, 3] uint8 RGB
    patch_size: int = 256,
    stride: int | None = None,
    tissue_threshold: float | None = 0.05,
) -> tuple[np.ndarray, np.ndarray]:
    """Grid-tile an image. Returns (imgs [N, P, P, 3] uint8, coords [N, 2]
    int64 as (x, y) top-left, the CLAM convention). Partial edge tiles are
    dropped. ``tissue_threshold`` keeps tiles whose mean saturation exceeds
    it (None keeps everything)."""
    if image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"expected [H, W, 3] RGB, got {image.shape}")
    stride = stride or patch_size
    h, w = image.shape[:2]
    xs = range(0, w - patch_size + 1, stride)
    ys = range(0, h - patch_size + 1, stride)
    coords = [(x, y) for y in ys for x in xs]
    if not coords:
        return np.zeros((0, patch_size, patch_size, 3), np.uint8), np.zeros((0, 2), np.int64)
    imgs = np.stack([image[y : y + patch_size, x : x + patch_size] for x, y in coords]).astype(np.uint8)
    coords_arr = np.asarray(coords, np.int64)
    if tissue_threshold is not None:
        keep = saturation(imgs) > tissue_threshold
        imgs, coords_arr = imgs[keep], coords_arr[keep]
    return imgs, coords_arr


def write_patch_h5(path: str | os.PathLike, imgs: np.ndarray, coords: np.ndarray) -> None:
    """The patch file as ``.h5`` (``imgs`` chunked 64 tiles at a time)."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"writing {path} needs h5py, which is not installed; write an .npz patch file") from e
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        # h5py rejects chunk shapes larger than the data shape, so an empty
        # stack (tiny or background-only slide) is written contiguous
        chunks = (min(64, len(imgs)), *imgs.shape[1:]) if len(imgs) else None
        f.create_dataset("imgs", data=imgs, chunks=chunks)
        f.create_dataset("coords", data=coords)


def write_patch_file(path: str | os.PathLike, imgs: np.ndarray, coords: np.ndarray) -> None:
    """The patch file in the format its extension names: ``.h5`` or ``.npz``
    (the same ``imgs`` and ``coords`` keys)."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".h5":
        write_patch_h5(path, imgs, coords)
    elif ext == ".npz":
        path.parent.mkdir(parents=True, exist_ok=True)
        np.savez(path, imgs=imgs, coords=coords)
    else:
        raise ValueError(f"unsupported patch file {path} (expected .h5 or .npz)")


def read_image(src: str | os.PathLike) -> np.ndarray:
    """An image file as [H, W, 3] uint8 RGB (Pillow)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {src} needs Pillow (PIL), which is not installed") from e
    Image.MAX_IMAGE_PIXELS = None  # WSIs are huge by design
    with Image.open(src) as im:
        return np.asarray(im.convert("RGB"))


def image_to_patch_file(
    src: str | os.PathLike,
    out: str | os.PathLike,
    patch_size: int = 256,
    stride: int | None = None,
    tissue_threshold: float | None = 0.05,
) -> dict:
    """Load an image file, tile it, write the patch file (``.h5`` or
    ``.npz``, by ``out``'s extension)."""
    arr = read_image(src)
    imgs, coords = tile_image(arr, patch_size=patch_size, stride=stride, tissue_threshold=tissue_threshold)
    write_patch_file(out, imgs, coords)
    step = stride or patch_size
    total = ((arr.shape[1] - patch_size) // step + 1) * ((arr.shape[0] - patch_size) // step + 1) \
        if min(arr.shape[:2]) >= patch_size else 0
    return {"n_patches": int(len(imgs)), "n_grid": int(max(total, 0)), "image_hw": arr.shape[:2], "out": str(out)}
