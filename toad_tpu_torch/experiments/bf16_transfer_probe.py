"""Disk-fed path: the bfloat16 wire against the float32 wire, both with the
producer thread's copy to the card.

Counterpart of ``experiments/bf16_transfer_probe.py``. The model computes in
bf16 either way, so the float32 wire moves twice the bytes only for them to
be rounded on the card; the bfloat16 wire (``BagBatcher(transfer_dtype=
'bfloat16')``, what ``--bf16`` and ``--bf16_transfer`` choose) rounds them on
the host, in the native loader's threads (or the producer thread on the numpy
feed), and halves the pinned ring's and the copy's bytes. The fixture, the
model (TOAD at full width in bf16, seeded; its forward launches K1 in
classification mode) and the timing (one warm-up epoch, the best of 2 runs
of 4 epochs) are :mod:`.io_overlap_probe`'s.

Numerics: one more epoch a wire collects the per-slide ``y_prob``. Both
sides round to nearest even before the same K1 bf16 launch, so the rows must
be the same: ``max_prob_dev`` 0.0.

Run: python -m toad_tpu_torch.experiments.bf16_transfer_probe [--data_dir DIR] [--device cpu]
Prints one JSON line: the JAX probe's keys, then ``k1_launches`` and ``device``.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from toad_tpu_torch.data.batching import BagBatcher
from toad_tpu_torch.experiments import device_name, resolve_device
from toad_tpu_torch.experiments import io_overlap_probe as iop
from toad_tpu_torch.ops import cuda_pool


def main(argv: list[str] | None = None) -> int:
    args = iop.probe_parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    launches = cuda_pool.LAUNCHES
    with iop.fixture_dir(args.data_dir) as data_dir:
        split = iop.fixture_split(data_dir, "bf16_probe")
        model = iop.seeded_model(dev)

        def batcher(wire: str) -> BagBatcher:
            return BagBatcher(split, batch_size=iop.BATCH, bucket_sizes=(iop.BAG_N,), mode="sequential",
                              transfer_dtype=wire, device=dev)

        f32_rate = iop.slides_per_sec(model, lambda: batcher("float32"), dev)
        bf16_rate = iop.slides_per_sec(model, lambda: batcher("bfloat16"), dev)
        # the per-slide probability rows, not their sums (a softmax row sums
        # to 1 whatever its input, so a sum would check nothing)
        max_prob_dev = float(np.abs(iop.slide_probs(model, batcher("float32"), dev)
                                    - iop.slide_probs(model, batcher("bfloat16"), dev)).max())
    print(json.dumps({
        "f32_transfer_slides_per_sec": round(f32_rate, 2),
        "bf16_transfer_slides_per_sec": round(bf16_rate, 2),
        "speedup": round(bf16_rate / f32_rate, 3),
        "max_prob_dev": max_prob_dev,
        "k1_launches": cuda_pool.LAUNCHES - launches,
        "device": device_name(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
