"""Unified CLI dispatcher: ``python -m toad_tpu_torch <command> [args]``.

Mirrors ``python -m toad_tpu``; lists only the commands ported so far.
"""

from __future__ import annotations

import sys

COMMANDS = {
    "make-dummy": ("toad_tpu_torch.cli.make_dummy", "generate a synthetic fixture (csv + bags + task JSON)"),
    "create-splits": ("toad_tpu_torch.cli.create_splits", "stratified k-fold split files"),
    "train": ("toad_tpu_torch.cli.train", "k-fold training"),
    "eval": ("toad_tpu_torch.cli.evaluate", "evaluate checkpoints (fold_k.csv, summary.csv)"),
    "report": ("toad_tpu_torch.cli.report", "aggregate k-fold metrics (mean/std across folds)"),
    "validate": ("toad_tpu_torch.cli.validate", "pre-flight dataset + bag-store checks"),
    "serve": ("toad_tpu_torch.cli.serve", "online prediction HTTP server (dynamic batching)"),
    "convert": ("toad_tpu_torch.cli.convert", "re-encode a bag store (e.g. f32 .pt -> int8 .npz)"),
    "tile": ("toad_tpu_torch.cli.tile", "raster slides -> patch files (tissue-filtered grid)"),
    "featurize": ("toad_tpu_torch.cli.featurize", "patch files -> feature bags (ResNet-50 / ViT-L)"),
}


def _usage() -> str:
    lines = ["usage: python -m toad_tpu_torch <command> [args]", "", "commands:"]
    for name, (_, desc) in COMMANDS.items():
        lines.append(f"  {name:<15} {desc}")
    lines.append("")
    lines.append("run `python -m toad_tpu_torch <command> --help` for per-command flags")
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}\n\n{_usage()}", file=sys.stderr)
        return 2
    import importlib

    module = importlib.import_module(COMMANDS[cmd][0])
    rc = module.main(rest)
    return rc if isinstance(rc, int) else 0  # validate's exit status gates pipelines; other commands return their results


if __name__ == "__main__":
    sys.exit(main())
