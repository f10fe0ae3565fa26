"""``python -m toad_tpu_torch convert``: re-encode a feature-bag store.

Users arrive with f32 ``.pt`` bags and convert them once, typically to the
int8 store (``--format int8``: row-quantized ``.npz``, 4x less disk, which
``serve --int8`` reads straight onto the int8 path without quantizing
again). Any supported format converts to any other (``h5`` needs h5py);
coords are carried over when the source has them. The same store layout
as ``python -m toad_tpu convert``.
"""

from __future__ import annotations

import argparse
from pathlib import Path

BAG_EXTS = (".pt", ".h5", ".npy", ".npz")


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch convert", description=__doc__)
    p.add_argument("--data_dir", type=str, required=True, help="source bag store")
    p.add_argument("--out_dir", type=str, required=True, help="destination directory")
    p.add_argument("--format", type=str, choices=["int8", "npy", "npz", "h5", "pt"], default="int8",
                   help="output format; 'int8' writes row-quantized .npz bags (4x smaller, "
                        "read by serve --int8 without quantizing again)")
    p.add_argument("--skip_done", action="store_true", help="skip slides whose output bag already exists")
    return p


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    src, dst = Path(args.data_dir), Path(args.out_dir)
    if not src.is_dir():
        raise SystemExit(f"--data_dir {src} is not a directory")
    if src.resolve() == dst.resolve():
        raise SystemExit("--out_dir must differ from --data_dir (conversion is not in-place)")

    import numpy as np

    from toad_tpu_torch.data.bags import load_bag
    from toad_tpu_torch.pipeline.featurize import write_bag

    int8 = args.format == "int8"
    ext = ".npz" if int8 else f".{args.format}"
    # coords sidecars are per-bag metadata, not bags: load_bag picks them up
    files = sorted(
        p for p in src.iterdir()
        if p.suffix.lower() in BAG_EXTS and not p.name.lower().endswith(".coords.npy")
    )
    if not files:
        raise SystemExit(f"no bag files ({'/'.join(BAG_EXTS)}) in {src}")
    # two sources sharing a stem (s0.pt and s0.npz) would overwrite each other's output
    stems: dict[str, Path] = {}
    for f in files:
        if f.stem in stems:
            raise SystemExit(
                f"duplicate bag stem {f.stem!r} ({stems[f.stem].name} and {f.name}) "
                f"would collide at {f.stem}{ext}: clean up the source store first"
            )
        stems[f.stem] = f
    dst.mkdir(parents=True, exist_ok=True)

    n_done = n_skipped = 0
    bytes_in = bytes_out = 0
    for f in files:
        out = dst / (f.stem + ext)
        if args.skip_done and out.exists():
            n_skipped += 1
            continue
        feats, coords = load_bag(f, with_coords=True)
        write_bag(out, np.asarray(feats, np.float32), coords=coords, int8=int8)
        bytes_in += f.stat().st_size
        bytes_out += out.stat().st_size
        n_done += 1
    ratio = ""
    if bytes_out and bytes_in:
        ratio = (f", {bytes_in / bytes_out:.1f}x smaller" if bytes_out <= bytes_in
                 else f", {bytes_out / bytes_in:.1f}x larger")
    print(f"converted {n_done} bags -> {dst} ({args.format}{ratio}); skipped {n_skipped}")


if __name__ == "__main__":
    main()
