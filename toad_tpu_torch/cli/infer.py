"""``python -m toad_tpu_torch infer``: one slide -> ranked origins (+ heatmap).

Either a feature bag (``--bag``) or a patch file (``--patches`` with the
ResNet-50's ``--weights``: tiles -> features -> prediction), printing the
ranked origin predictions as JSON and optionally writing the attention
heatmap and the raw per-patch attention. The same command as ``python -m
toad_tpu infer``; it runs on the card unless ``--device cpu`` is given, where
the pooling kernel's scored mode computes the attention (K1 in f32, K2 with
``--int8``). ``--save_attention`` writes an ``.h5`` (needs h5py) or, for a
path ending in ``.npz``, an ``.npz`` with the same ``attention``, ``coords``
and ``task`` entries.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np


def make_parser() -> argparse.ArgumentParser:
    from toad_tpu_torch.cli.common import add_buckets_arg, add_temperature_from_arg, add_xla_only_args

    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch infer", description=__doc__)
    p.add_argument("--ckpt", type=str, required=True, help="reference-layout s_k_checkpoint.pt")
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--bag", type=str, help="feature bag (.pt/.h5/.npy/.npz)")
    src.add_argument("--patches", type=str, help="patch file (.h5 or .npz: imgs + coords)")
    p.add_argument("--weights", type=str, default=None, help="ResNet-50 weights .pth (required with --patches)")
    p.add_argument("--sex", type=str, required=True, help="patient sex: F/M or 0/1")
    p.add_argument("--task", type=str, default=None, help="task name/JSON for class label names")
    p.add_argument("--n_classes", type=int, default=18)
    p.add_argument("--encoding_size", type=int, default=1024)
    p.add_argument("--topk", type=int, default=5)
    p.add_argument("--heatmap", type=str, default=None, help="write the attention heatmap PNG here")
    p.add_argument("--save_attention", type=str, default=None,
                   help="write the raw per-patch attention (+coords) to this .h5, or .npz where the path ends so")
    p.add_argument("--attention_task", type=str, choices=["origin", "site"], default="origin",
                   help="which task's attention drives the heatmap/export")
    p.add_argument("--patch_size", type=int, default=256)
    p.add_argument("--downscale", type=int, default=32)
    p.add_argument("--batch_size", type=int, default=64, help="tile batch for --patches")
    p.add_argument("--int8", action="store_true", default=False,
                   help="quantized pooling (int8 kernel GEMMs; heads stay f32)")
    p.add_argument("--ensemble", action="store_true", default=False,
                   help="mean-of-folds ensemble: --ckpt is a training results dir (every "
                        "s_<k>_checkpoint becomes a member) or a comma-separated checkpoint "
                        "list; probabilities are the per-member softmax mean and attention "
                        "(incl. --heatmap) the mean of the members' softmaxed pooling weights")
    p.add_argument("--temperature", type=float, default=1.0,
                   help="calibrated softmax temperature for class probabilities (fit with eval --calibrate)")
    add_temperature_from_arg(p)
    add_buckets_arg(p)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default), cuda:<i> or cpu")
    add_xla_only_args(p, "pallas")
    return p


def main(argv=None) -> None:
    from toad_tpu_torch.cli.common import build_inference, label_names, note_xla_only, parse_sex, resolve_device_arg

    args = make_parser().parse_args(argv)
    note_xla_only(args)
    sex = parse_sex(args.sex)
    if args.patches and not args.weights:
        raise SystemExit("--patches requires --weights (encoder checkpoint)")
    device = resolve_device_arg(args.device)
    inference = build_inference(args, device)

    from toad_tpu_torch.pipeline.infer import infer_feature_bag, infer_patch_file

    if args.bag:
        pred, coords = infer_feature_bag(inference, args.bag, sex)
    else:
        from toad_tpu_torch.config import EncoderConfig
        from toad_tpu_torch.models.resnet_encoder import encoder_from_state_dict, load_torchvision_weights
        from toad_tpu_torch.pipeline.featurize import TileEmbedder

        ecfg = EncoderConfig()
        encoder = encoder_from_state_dict(load_torchvision_weights(args.weights, ecfg), ecfg)
        embedder = TileEmbedder(encoder.to(device).eval(), batch_size=args.batch_size)
        pred, coords = infer_patch_file(embedder, inference, args.patches, sex)

    inv = label_names(args.task)
    result = {
        "y_hat": pred.y_hat,
        "prediction": inv.get(pred.y_hat, str(pred.y_hat)) if inv else str(pred.y_hat),
        "topk": [
            {"class": inv.get(i, str(i)) if inv else str(i), "prob": round(p, 6)}
            for i, p in pred.topk[: args.topk]
        ],
        "site": "Metastatic" if pred.site_hat else "Primary",
        "site_prob": [round(float(x), 6) for x in pred.site_prob],
        "n_patches": int(pred.attention.shape[0]),
    }

    attn = pred.attention if args.attention_task == "origin" else pred.site_attention
    if args.save_attention:
        out = Path(args.save_attention)
        save_attention(out, attn, coords, args.attention_task)
        result["attention_file"] = str(out.absolute())
        result["attention_task"] = args.attention_task

    if args.heatmap:
        if coords is None:
            result["heatmap"] = "skipped: no coords in input"
        else:
            from toad_tpu_torch.pipeline.heatmap import render_heatmap, save_png

            img = render_heatmap(coords, attn, patch_size=args.patch_size, downscale=args.downscale)
            save_png(args.heatmap, img)
            result["heatmap"] = str(Path(args.heatmap).absolute())

    print(json.dumps(result, indent=2))


def save_attention(path: Path, attention: np.ndarray, coords: np.ndarray | None, task: str) -> None:
    """The raw attention, its task's name and the coords (where known): an
    ``.npz`` for a path ending in ``.npz``, else an ``.h5`` (h5py), as the
    JAX CLI writes it."""
    path.parent.mkdir(parents=True, exist_ok=True)
    if path.suffix.lower() == ".npz":
        payload = {"attention": attention, "task": np.array(task)}
        if coords is not None:
            payload["coords"] = coords
        np.savez(path, **payload)
        return
    try:
        import h5py
    except ImportError as e:
        raise ImportError(f"writing {path} needs h5py, which is not installed; give a path ending in .npz") from e
    with h5py.File(path, "w") as f:
        d = f.create_dataset("attention", data=attention)
        d.attrs["task"] = task
        if coords is not None:
            f.create_dataset("coords", data=coords)


if __name__ == "__main__":
    main()
