"""Patch featurization: tile images -> 1024-d feature bags, on the device.

PyTorch counterpart of :mod:`toad_tpu.pipeline.featurize`. A CLAM-style patch
file (``imgs`` [N, H, W, 3] uint8 + ``coords`` [N, 2]) streams through the
truncated ResNet-50 or the ViT encoder in fixed-size batches, and the resulting bag is written in any
supported format. The patch file is an ``.h5`` (needs h5py, tiles stream from
disk) or an ``.npz`` with the same two keys (read whole), so that the path
also runs where h5py is absent. A directory of tile images is the other
layout (decoded with PIL on a producer thread).

Tiles go to the card from pinned memory with ``non_blocking`` copies, so the
host reads and stages batch i+1 while the card computes batch i; the features
stay on the card and come back once per slide.
"""

from __future__ import annotations

import contextlib
import os
import queue
import re
import threading
import time
from pathlib import Path
from typing import Any, Callable, Iterator

import numpy as np
import torch

from toad_tpu_torch.data.bags import save_int8_bag
from toad_tpu_torch.models.resnet_encoder import ResNetEncoder
from toad_tpu_torch.models.vit_encoder import ViTEncoder

PATCH_FILE_EXTS = (".h5", ".npz")


def read_patch_file(path: str | os.PathLike):
    """Open a CLAM-style patch file and return (handle to close, imgs, coords
    or None). From an ``.h5``, ``imgs`` stays an h5py dataset (lazy) so huge
    slides stream without loading all tiles at once; an ``.npz`` is read
    whole."""
    path = Path(path)
    ext = path.suffix.lower()
    if ext == ".h5":
        try:
            import h5py
        except ImportError as e:
            raise ImportError(
                f"reading {path} needs h5py, which is not installed; store the tiles as an .npz "
                "with the same 'imgs' and 'coords' keys"
            ) from e
        f = h5py.File(path, "r")
    elif ext == ".npz":
        f = np.load(path)
    else:
        raise ValueError(f"unsupported patch file {path} (expected one of {'/'.join(PATCH_FILE_EXTS)})")
    key = "imgs" if "imgs" in f else ("patches" if "patches" in f else None)
    if key is None:
        found = list(f)
        f.close()
        raise KeyError(f"{path}: no 'imgs'/'patches' dataset (found: {found})")
    coords = np.asarray(f["coords"][:]) if "coords" in f else None
    return f, f[key], coords


def iter_tile_batches(imgs, batch_size: int) -> Iterator[tuple[np.ndarray, int]]:
    """Yield (batch [B, H, W, 3] uint8, n_valid); the last batch is
    zero-padded to the full batch size so every step has the same shape."""
    n = imgs.shape[0]
    for start in range(0, n, batch_size):
        stop = min(start + batch_size, n)
        chunk = np.asarray(imgs[start:stop])
        valid = stop - start
        if valid < batch_size:
            pad = np.zeros((batch_size - valid, *chunk.shape[1:]), chunk.dtype)
            chunk = np.concatenate([chunk, pad], axis=0)
        yield chunk, valid


class TileEmbedder:
    """uint8 tiles -> features with a fixed batch shape, on the device the
    encoder lives on, through either encoder's ``embed``. The counterpart of
    the JAX ``TileEmbedder``; a ResNet encoder whose config asks for it
    (``fold_bn``) has its BN folded once here, as the JAX ``make_embedder``
    folds it. Its mesh (tile batches sharded over several devices) is not
    ported yet."""

    _STAGES = 2  # pinned staging buffers: the host fills one while the other's copy is in flight

    def __init__(self, encoder: ResNetEncoder | ViTEncoder, batch_size: int = 128):
        if isinstance(encoder, ResNetEncoder) and encoder.config.fold_bn:
            encoder.fold_bn()
        self.encoder = encoder
        self.config = encoder.config
        self.batch_size = batch_size
        self.device = next(encoder.parameters()).device
        self.batches = 0  # batches embedded so far
        self._stage: list[tuple[torch.Tensor, torch.cuda.Event]] = []
        self._next = 0

    def _put(self, tiles_uint8: np.ndarray) -> torch.Tensor:
        tiles = torch.from_numpy(np.ascontiguousarray(tiles_uint8))
        if self.device.type != "cuda":
            return tiles
        if not self._stage or self._stage[0][0].shape != tiles.shape:
            self._stage = [(torch.empty(tiles.shape, dtype=torch.uint8).pin_memory(), torch.cuda.Event())
                           for _ in range(self._STAGES)]
        buf, copied = self._stage[self._next]
        self._next = (self._next + 1) % self._STAGES
        copied.synchronize()  # the copy that last read this buffer has run
        buf.copy_(tiles)
        out = buf.to(self.device, non_blocking=True)
        copied.record(torch.cuda.current_stream(self.device))
        return out

    def __call__(self, tiles_uint8: np.ndarray) -> torch.Tensor:
        """One batch: [B, H, W, 3] uint8 -> [B, D] f32 on the device; does not
        wait for the device."""
        self.batches += 1
        return self.encoder.embed(self._put(tiles_uint8))

    def gather(self, outs: list[torch.Tensor], valids: list[int]) -> np.ndarray:
        """The batches' valid rows as one [N, D] array: one device-to-host copy."""
        if not outs:
            return np.zeros((0, self.config.out_dim), np.float32)
        return torch.cat([o[:v] for o, v in zip(outs, valids)]).cpu().numpy()

    def embed_all(self, imgs, progress: Callable[[int, int], None] | None = None) -> np.ndarray:
        """Stream every tile of an (h5 dataset or array) into a [N, D] bag."""
        n = int(imgs.shape[0])
        outs: list[torch.Tensor] = []
        valids: list[int] = []
        done = 0
        for chunk, valid in iter_tile_batches(imgs, self.batch_size):
            outs.append(self(chunk))
            valids.append(valid)
            done += valid
            if progress is not None:
                progress(done, n)
        return self.gather(outs, valids)


TILE_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff")


def list_tile_files(tile_dir: str | os.PathLike) -> list[Path]:
    """Sorted tile-image files (PNG/JPEG/BMP/TIFF) directly under a directory:
    one image file per tile, what generic tiling tools emit. Sorted by name so
    bag row order is deterministic."""
    tile_dir = Path(tile_dir)
    files = sorted(p for p in tile_dir.iterdir() if p.suffix.lower() in TILE_IMAGE_EXTS)
    if not files:
        raise FileNotFoundError(f"no tile images ({'/'.join(TILE_IMAGE_EXTS)}) in {tile_dir}")
    return files


def parse_tile_coords(files: list[Path]) -> np.ndarray | None:
    """Recover (x, y) coords from ``..._{x}_{y}.ext`` filenames (the common
    tile-export convention). Returns [N, 2] int64, or None unless EVERY file
    parses: partial coords would silently misalign heatmaps."""
    pat = re.compile(r"(\d+)_(\d+)$")
    coords = []
    for f in files:
        m = pat.search(f.stem)
        if m is None:
            return None
        coords.append((int(m.group(1)), int(m.group(2))))
    return np.asarray(coords, np.int64)


def iter_decoded_tile_batches(
    files: list[Path],
    batch_size: int,
    prefetch: int = 4,
    stats: dict | None = None,
) -> Iterator[tuple[np.ndarray, int]]:
    """Decode tile images on a producer thread into padded uint8 batches.

    Yields ``(batch [B, H, W, 3] uint8, n_valid)`` like
    :func:`iter_tile_batches`; the last batch is zero-padded. Decode (PIL)
    runs in a daemon thread feeding a bounded queue, so the decode of batch
    ``i+1`` overlaps the device's work on batch ``i``. All tiles must share
    one shape; a mismatch raises with both shapes. When the consumer stops
    early (closes the generator, or raises), the producer is told to stop and
    joined: it never stays blocked on the full queue.

    ``stats`` (optional dict) receives ``decode_s``, the cumulative seconds
    the producer spent in decode."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("decoding tile images needs Pillow (PIL), which is not installed; "
                          "store the tiles as an .npz or .h5 patch file") from e

    q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()
    _END = object()

    def put(item) -> bool:
        """Hand ``item`` to the consumer; False once it has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def produce() -> None:
        try:
            batch: np.ndarray | None = None
            filled = 0
            for f in files:
                if stop.is_set():
                    return
                t0 = time.perf_counter()
                with Image.open(f) as im:
                    arr = np.asarray(im.convert("RGB"), np.uint8)
                if stats is not None:
                    stats["decode_s"] = stats.get("decode_s", 0.0) + (time.perf_counter() - t0)
                if batch is None:
                    batch = np.zeros((batch_size, *arr.shape), np.uint8)
                elif arr.shape != batch.shape[1:]:
                    raise ValueError(
                        f"{f}: tile shape {arr.shape} != first tile's {tuple(batch.shape[1:])}"
                    )
                batch[filled] = arr
                filled += 1
                if filled == batch_size:
                    if not put((batch, filled)):
                        return
                    batch, filled = None, 0
            if filled and not put((batch, filled)):
                return
            put(_END)
        except BaseException as e:  # surface decode errors in the consumer
            put(e)

    producer = threading.Thread(target=produce, daemon=True, name="toad-tile-decode")
    producer.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        producer.join(timeout=30)


def featurize_tile_dir(
    embedder: TileEmbedder,
    tile_dir: str | os.PathLike,
    out: str | os.PathLike,
    progress: Callable[[int, int], None] | None = None,
    int8: bool = False,
    prefetch: int = 4,
) -> dict[str, Any]:
    """One slide from a directory of tile images: decode (overlapped producer
    thread) -> encoder -> feature bag on disk. Coords are recovered from
    ``..._{x}_{y}`` filenames when every tile has them (heatmaps work), else
    omitted. Pixels-from-disk counterpart of :func:`featurize_patch_file`."""
    files = list_tile_files(tile_dir)
    n = len(files)
    stats: dict[str, float] = {}
    t0 = time.perf_counter()
    outs: list[torch.Tensor] = []
    valids: list[int] = []
    done = 0
    with contextlib.closing(iter_decoded_tile_batches(files, embedder.batch_size, prefetch, stats)) as batches:
        for chunk, valid in batches:
            outs.append(embedder(chunk))
            valids.append(valid)
            done += valid
            if progress is not None:
                progress(done, n)
    feats = embedder.gather(outs, valids)
    dt = time.perf_counter() - t0
    write_bag(out, feats, parse_tile_coords(files), int8=int8)
    return {
        "n_patches": n,
        "seconds": dt,
        "patches_per_s": n / dt if dt > 0 else float("inf"),
        "decode_s": round(stats.get("decode_s", 0.0), 4),
        "out": str(out),
    }


def write_bag(
    path: str | os.PathLike,
    features: np.ndarray,
    coords: np.ndarray | None = None,
    int8: bool = False,
) -> None:
    """Write a feature bag in the format the extension names: ``.npy``,
    ``.npz``, ``.pt`` (a bare f32 tensor) or ``.h5`` (features + coords;
    needs h5py). ``.npy`` and ``.pt`` cannot embed coords, which go to a
    ``{stem}.coords.npy`` sidecar. With ``int8=True`` (``.npz`` only) the
    rows are quantized on write (:func:`~toad_tpu_torch.data.bags.save_int8_bag`)."""
    path = Path(path)
    ext = path.suffix.lower()
    if int8:
        save_int8_bag(path, features, coords)
        return
    path.parent.mkdir(parents=True, exist_ok=True)
    if ext == ".h5":
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"writing {path} needs h5py, which is not installed; write .pt, .npy or .npz") from e
        with h5py.File(path, "w") as f:
            f.create_dataset("features", data=features)
            if coords is not None:
                f.create_dataset("coords", data=coords)
    elif ext == ".npy":
        np.save(path, features)
    elif ext == ".npz":
        np.savez(path, features=features, **({"coords": coords} if coords is not None else {}))
    elif ext == ".pt":
        torch.save(torch.from_numpy(np.ascontiguousarray(features, np.float32)), path)
    else:
        raise ValueError(f"unsupported bag format: {path}")
    if coords is not None and ext in (".npy", ".pt"):
        np.save(path.with_suffix(".coords.npy"), coords)


def featurize_patch_file(
    embedder: TileEmbedder,
    src: str | os.PathLike,
    out: str | os.PathLike,
    progress: Callable[[int, int], None] | None = None,
    int8: bool = False,
) -> dict[str, Any]:
    """One slide: patch file (.h5 or .npz) -> feature bag on disk. Returns
    throughput stats; the seconds end when the features are on the host."""
    f, imgs, coords = read_patch_file(src)
    try:
        t0 = time.perf_counter()
        feats = embedder.embed_all(imgs, progress=progress)  # numpy: the device has finished
        dt = time.perf_counter() - t0
        write_bag(out, feats, coords, int8=int8)
    finally:
        f.close()
    n = int(feats.shape[0])
    return {"n_patches": n, "seconds": dt, "patches_per_s": n / dt if dt > 0 else float("inf"), "out": str(out)}
