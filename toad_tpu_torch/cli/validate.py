"""``python -m toad_tpu_torch validate``: pre-flight dataset and bag-store checks.

Counterpart of :mod:`toad_tpu.cli.validate`. The reference validates no
data: a missing ``.pt`` raises deep inside a DataLoader worker mid-epoch, and
a wrong feature dim only surfaces as a shape error in the first forward.
This command front-loads everything that can be checked from metadata
(labels are validated loudly at load already, ``LabelVocabularyError``):

- every slide's bag file exists (per-source routing included),
- feature dims match ``--encoding_size`` (header and metadata reads only,
  :func:`toad_tpu_torch.data.bags.bag_shape`),
- the patch-count distribution and a suggested bucket ladder (quantiles
  rounded up to multiples of 128) with the padding overhead of the default
  and the suggested ladder.

Exit status 1 when anything is missing or mismatched, so it gates pipelines.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from toad_tpu_torch.cli.common import add_task_arg, build_dataset
from toad_tpu_torch.config import DEFAULT_BUCKETS
from toad_tpu_torch.data.bags import bag_shape
from toad_tpu_torch.data.batching import suggest_buckets


def make_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m toad_tpu_torch validate", description="TOAD dataset validation")
    add_task_arg(p)
    p.add_argument("--data_root_dir", type=str, required=True)
    p.add_argument("--encoding_size", type=int, default=1024, help="expected feature dim")
    p.add_argument("--max_report", type=int, default=10, help="cap per-problem path listings")
    return p


def padding_overhead(counts: np.ndarray, buckets: list[int]) -> float:
    """Mean padded slots / real slots - 1 over the dataset for a ladder (bags
    beyond the top rung are cut to it, as the batcher cuts them)."""
    if len(counts) == 0 or not buckets:
        return 0.0
    tops = np.asarray(sorted(buckets))
    idx = np.searchsorted(tops, np.minimum(counts, tops[-1]))
    padded = tops[np.minimum(idx, len(tops) - 1)]
    real = np.minimum(counts, tops[-1])
    return float(padded.sum() / real.sum() - 1.0)


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    _, ds = build_dataset(args, data_dir=args.data_root_dir, print_info=False)

    missing, bad_dim, counts = [], [], []
    for i in range(ds.n_slides):
        p = ds.bag_file(i)
        if not p.exists():
            missing.append(str(p))
            continue
        try:
            n, d = bag_shape(p)
        except Exception as e:  # whatever a corrupt file raises: listed as missing, with the reason
            missing.append(f"{p} (unreadable: {type(e).__name__})")
            continue
        if d != args.encoding_size:
            bad_dim.append(f"{p} (dim {d})")
            continue  # unusable until re-featurized: kept out of the ladder's statistics
        counts.append(n)

    counts = np.asarray(counts)
    current = list(DEFAULT_BUCKETS)
    suggested = suggest_buckets(counts)
    report = {
        "n_slides": int(ds.n_slides),
        "n_ok": int(len(counts)),
        "n_missing": len(missing),
        "n_dim_mismatch": len(bad_dim),
        "missing": missing[: args.max_report],
        "dim_mismatch": bad_dim[: args.max_report],
        "patch_counts": (
            {
                "min": int(counts.min()),
                "p50": int(np.median(counts)),
                "p90": int(np.quantile(counts, 0.9)),
                "max": int(counts.max()),
            }
            if len(counts)
            else None
        ),
        "bucket_ladder_default": current,
        "bucket_ladder_suggested": suggested,
        "padding_overhead_default": round(padding_overhead(counts, current), 4),
        "padding_overhead_suggested": round(padding_overhead(counts, suggested), 4),
    }
    print(json.dumps(report, indent=2))
    return 1 if (missing or bad_dim) else 0


if __name__ == "__main__":
    raise SystemExit(main())
