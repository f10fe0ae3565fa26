"""``python -m toad_tpu_torch export``: a checkpoint -> the reference's torch
``s_{fold}_checkpoint.pt`` layout.

For users who still run the reference: the output holds the reference's
``nn.Sequential`` key indices, which shift with dropout (``--drop_out``).
``--ckpt`` is a reference-layout ``.pt`` in either key layout, or the
trainer's ``s_{fold}_resume.pt`` snapshot. The same command as ``python -m
toad_tpu export``, except that an Orbax directory is refused: convert it
with ``python -m toad_tpu export`` where the JAX package runs.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch export", description=__doc__)
    p.add_argument("--ckpt", type=str, required=True, help="a reference-layout .pt or an s_k_resume.pt snapshot")
    p.add_argument("--out", type=str, required=True, help="output .pt path (reference state_dict layout)")
    p.add_argument("--encoding_size", type=int, default=1024)
    p.add_argument("--n_classes", type=int, default=18)
    p.add_argument(
        "--drop_out", action="store_true", default=False,
        help="emit the dropout-variant key layout (reference models built with --drop_out)",
    )
    return p


def load_state_dict(ckpt: str, cfg) -> dict:
    """The port's state_dict (f32) of a reference-layout ``.pt`` or of a
    resume snapshot (a dict holding the model's state_dict under ``model``
    beside ``optimizer``)."""
    import torch

    from toad_tpu_torch.models.interop import check_shapes
    from toad_tpu_torch.train.checkpoint import load_params_any

    p = Path(ckpt)
    if p.is_file():
        obj = torch.load(p, map_location="cpu", weights_only=True)
        if isinstance(obj, dict) and "model" in obj and "optimizer" in obj:
            sd = {k: v.detach().float() for k, v in obj["model"].items()}
            check_shapes(sd, cfg)
            return sd
    return load_params_any(p, cfg)


def main(argv=None) -> None:
    args = make_parser().parse_args(argv)

    import torch

    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.models.interop import reference_state_dict

    sd = load_state_dict(args.ckpt, ModelConfig(in_dim=args.encoding_size, n_classes=args.n_classes))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(reference_state_dict(sd, dropout=args.drop_out), out)
    print(f"exported {args.ckpt} -> {out} (reference state_dict layout, drop_out={args.drop_out})")


if __name__ == "__main__":
    main()
