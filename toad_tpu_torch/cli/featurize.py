"""``python -m toad_tpu_torch featurize``: patch tiles -> feature bags on the GPU.

Every patch file in ``--patch_dir`` (CLAM layout: ``imgs`` [N, H, W, 3] uint8
+ ``coords``; ``{slide_id}.h5``, or ``{slide_id}.npz`` with the same keys
where h5py is absent), or every per-slide subdirectory of tile images in
``--tile_dir``, is embedded through the truncated ResNet-50 (the default) or
the ViT encoder and written to ``--feat_dir`` as a feature bag usable by
serving and inference. The same command as ``python -m toad_tpu featurize``.
"""

from __future__ import annotations

import argparse
import json
import zipfile
from pathlib import Path

from toad_tpu_torch.cli.common import XLA_ONLY, refuse_flags

# flags of the JAX CLI that are not ported: (flag, its "off" value, where ROADMAP.md queues it)
_NOT_PORTED = (
    ("data_shards", None, "multi-GPU (ROADMAP.md queue 1.7)"),
    ("profile", None, "profiling and debugging tools (ROADMAP.md queue 1.6)"),
    ("compile_cache", None, XLA_ONLY),
)


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch featurize", description=__doc__)
    p.add_argument("--patch_dir", type=str, default=None, help="dir of {slide_id}.h5 or {slide_id}.npz patch files")
    p.add_argument("--tile_dir", type=str, default=None,
                   help="dir of per-slide SUBDIRECTORIES of tile images (PNG/JPEG/...); "
                        "the pixels-from-disk layout: decode runs on an overlapped "
                        "producer thread; coords recovered from ..._{x}_{y} filenames")
    p.add_argument("--feat_dir", type=str, required=True, help="output dir for feature bags")
    p.add_argument("--format", type=str, choices=["h5", "npy", "npz", "pt", "int8"], default="h5",
                   help="bag format; 'int8' writes row-quantized .npz bags (4x smaller, "
                        "loads transparently, feeds --int8 serving without requantization)")
    p.add_argument("--encoder", type=str, choices=["resnet50", "vit"], default="resnet50",
                   help="patch encoder family: truncated ResNet-50 or UNI-style ViT-L")
    p.add_argument("--weights", type=str, default=None,
                   help="encoder weights: torchvision resnet50 .pth or timm ViT .bin (random init if omitted)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--no_bf16", action="store_true",
                   help="compute in float32 instead of bfloat16 (TF32 off for the ResNet's cuDNN convs)")
    p.add_argument("--no_fold_bn", action="store_true", help="keep the ResNet's BatchNorm unfolded")
    p.add_argument("--skip_done", action="store_true", help="skip slides whose bag already exists")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default), cuda:<i> or cpu")
    # flags of the JAX CLI that are not ported; accepted so that they can be refused by name
    p.add_argument("--data_shards", type=int, default=None, help="not ported")
    p.add_argument("--profile", type=str, default=None, help="not ported")
    p.add_argument("--compile_cache", type=str, default=None, help="no counterpart: nothing is compiled ahead of a run")
    return p


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)
    refuse_flags(args, _NOT_PORTED)
    if (args.patch_dir is None) == (args.tile_dir is None):
        raise SystemExit("give exactly one of --patch_dir (patch files) or --tile_dir (tile images)")

    import torch

    from toad_tpu_torch.pipeline.featurize import PATCH_FILE_EXTS, TileEmbedder

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"error: --device {args.device} but CUDA is not available here; pass --device cpu to featurize on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise SystemExit(f"error: --device must be cuda, cuda:<i> or cpu, got {args.device!r}")

    encoder = _vit(args) if args.encoder == "vit" else _resnet(args)
    embedder = TileEmbedder(encoder.to(device).eval(), batch_size=args.batch_size)

    feat_dir = Path(args.feat_dir)
    feat_dir.mkdir(parents=True, exist_ok=True)
    if args.tile_dir is not None:
        src_root = Path(args.tile_dir)
        files = sorted(p for p in src_root.iterdir() if p.is_dir())
        if not files:
            raise FileNotFoundError(f"no per-slide tile subdirectories in {src_root}")
    else:
        patch_dir = Path(args.patch_dir)
        files = sorted(p for p in patch_dir.iterdir() if p.suffix.lower() in PATCH_FILE_EXTS)
        if not files:
            raise FileNotFoundError(f"no {'/'.join(PATCH_FILE_EXTS)} patch files in {patch_dir}")
        stems = [p.stem for p in files]
        twice = sorted({s for s in stems if stems.count(s) > 1})
        if twice:
            raise SystemExit(f"patch files in more than one format for {twice}: both would write {twice[0]}.*; keep one")
    _run_all(args, files, feat_dir, embedder)


def _vit(args):
    import dataclasses

    import torch

    from toad_tpu_torch.models.vit_encoder import ViTConfig, ViTEncoder, encoder_from_state_dict, load_timm_weights

    compute_dtype = "float32" if args.no_bf16 else "bfloat16"
    if args.weights:
        sd, cfg = load_timm_weights(args.weights)
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
        print(f"loaded ViT weights from {args.weights} (width {cfg.width}, depth {cfg.depth})")
        return encoder_from_state_dict(sd, cfg)
    print("WARNING: no --weights given; using random ViT-L init (features are untrained)")
    return ViTEncoder(ViTConfig(compute_dtype=compute_dtype), torch.Generator().manual_seed(0))


def _resnet(args):
    import torch

    from toad_tpu_torch.config import EncoderConfig
    from toad_tpu_torch.models.resnet_encoder import ResNetEncoder, encoder_from_state_dict, load_torchvision_weights

    cfg = EncoderConfig(compute_dtype="float32" if args.no_bf16 else "bfloat16", fold_bn=not args.no_fold_bn)
    if args.no_bf16:
        torch.backends.cudnn.allow_tf32 = False  # f32 means f32: cuDNN's convs would otherwise run in TF32
    if args.weights:
        sd = load_torchvision_weights(args.weights, cfg)
        print(f"loaded encoder weights from {args.weights}")
        return encoder_from_state_dict(sd, cfg)  # BN folded by TileEmbedder when cfg.fold_bn
    print("WARNING: no --weights given; using random encoder init (features are untrained)")
    return ResNetEncoder(cfg, torch.Generator().manual_seed(0))


def _bag_matches_format(path: Path, int8: bool) -> bool:
    """Does an existing bag file actually hold the requested format?
    int8 and f32 bags share the .npz extension, so --skip_done must look
    inside (zip member names only) rather than trust the filename."""
    if path.suffix != ".npz":
        return not int8
    try:
        with zipfile.ZipFile(path) as zf:
            return ("features_int8.npy" in zf.namelist()) == int8
    except (OSError, zipfile.BadZipFile):
        return False  # corrupt/partial: re-featurize


def _run_all(args, files, feat_dir, embedder) -> None:
    import torch

    from toad_tpu_torch.ops import cuda_mha
    from toad_tpu_torch.pipeline.featurize import featurize_patch_file, featurize_tile_dir

    total_patches, total_s = 0, 0.0
    int8 = args.format == "int8"
    ext = "npz" if int8 else args.format
    # a bag store resolves {stem}.pt before .h5/.npy/.npz (bag_path of the
    # dataset layer): a stale bag in a higher-priority format would silently
    # shadow the new one
    shadow_exts = {"pt": [], "h5": ["pt"], "npy": ["pt", "h5"],
                   "npz": ["pt", "h5", "npy"], "int8": ["pt", "h5", "npy"]}[args.format]
    shadowed = []
    for i, src in enumerate(files):
        out = feat_dir / f"{src.stem}.{ext}"
        stale = [feat_dir / f"{src.stem}.{e}" for e in shadow_exts]
        shadowed.extend(str(p) for p in stale if p.exists())
        if args.skip_done and out.exists() and _bag_matches_format(out, int8):
            print(f"[{i + 1}/{len(files)}] {src.stem}: exists, skipped")
            continue
        featurize = featurize_tile_dir if src.is_dir() else featurize_patch_file
        stats = featurize(embedder, src, out, int8=int8)
        total_patches += stats["n_patches"]
        total_s += stats["seconds"]
        print(
            f"[{i + 1}/{len(files)}] {src.stem}: {stats['n_patches']} patches "
            f"in {stats['seconds']:.2f}s ({stats['patches_per_s']:.0f} patches/s) -> {out}"
        )
    if shadowed:
        print(
            f"WARNING: {len(shadowed)} stale bag(s) in other formats shadow the "
            f".{ext} output at load time (bag_path prefers .pt/.h5/.npy); delete "
            f"them to use the new bags: {shadowed[:5]}{' ...' if len(shadowed) > 5 else ''}"
        )
    dev = embedder.device
    print(json.dumps({
        "slides": len(files),
        "patches": total_patches,
        "patches_per_s": total_patches / total_s if total_s else 0.0,
        "shadowed_stale_bags": len(shadowed),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "batches": embedder.batches,
        "attention_kernel_launches": cuda_mha.LAUNCHES,
    }))


if __name__ == "__main__":
    main()
