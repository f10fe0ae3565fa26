"""A/B on the disk-fed path: the copy to the card started by the batcher's
producer thread against a copy made when the step takes the batch.

Counterpart of ``experiments/io_overlap_probe.py``. The fixture's 16 ``.pt``
bags (8,192 x 1024 f32 each, :func:`~toad_tpu_torch.data.synthetic.write_io_fixture`)
go through ``BagBatcher`` in sequential order at batch 8 and bucket 8,192,
and each batch through TOAD at full width in bf16 (weights from a seeded
generator), whose forward launches the pooling kernel K1 (``csrc/pool.cu``)
in classification mode. The two arms:

- ``dispatch_h2d``: ``BagBatcher(device=None)``; the step copies the batch
  from host memory to the card before its forward (the JAX arm
  ``device_put=False``);
- ``producer_device_put``: ``BagBatcher(device=card)``; the producer thread
  packs each batch into a pinned ring slot and starts its copy on a side
  stream, so that the copy of batch k+1 runs under the forward of batch k
  (the JAX arm ``device_put=True``).

Each arm runs one warm-up epoch (the kernels' build, the page cache, the
native loader's build), then the best of 2 runs of 4 epochs; every step reads
the sum of its probabilities back, as the JAX probe's ``float(step(...))``
does. After the timings, one more epoch an arm collects the per-slide
``y_prob``: the two arms feed the same bytes to the same kernel, so they must
agree exactly.

Run: python -m toad_tpu_torch.experiments.io_overlap_probe [--data_dir DIR] [--device cpu]
Prints one JSON line: the JAX probe's keys, then ``max_prob_dev`` (the
largest |difference| of the arms' per-slide ``y_prob``), ``k1_launches``
(K1's launches in this run) and ``device``.

The fixture's set-up, the model and the timing loop are shared with
:mod:`.bf16_transfer_probe` and :mod:`.patient_native_probe`.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.data.batching import BagBatcher
from toad_tpu_torch.data.synthetic import dummy_task, write_io_fixture
from toad_tpu_torch.data.wsi_dataset import WSIBagDataset
from toad_tpu_torch.experiments import device_name, resolve_device
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops import cuda_pool

N_SLIDES, BATCH, EPOCHS = 16, 8, 4
BAG_N, DIM, N_CLASSES = 8192, 1024, 18
RUNS = 2  # timed runs of EPOCHS epochs, the best kept (against the host's jitter)


def probe_parser(doc: str) -> argparse.ArgumentParser:
    """The flags the disk-fed probes share: the fixture's directory and the device."""
    ap = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--data_dir", type=str, default=None,
                    help="directory of the fixture (written there once, reused after); a temporary one by default")
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu")
    return ap


@contextlib.contextmanager
def fixture_dir(data_dir: str | None):
    """``data_dir``, or a temporary directory removed afterwards."""
    if data_dir is not None:
        yield Path(data_dir)
        return
    with tempfile.TemporaryDirectory(prefix="toad_io_fixture_") as tmp:
        yield Path(tmp)


def fixture_split(data_dir: Path, name: str):
    """The fixture's slides as a ``WSIBagSplit``, in manifest order."""
    _, csv_path = write_io_fixture(data_dir, N_SLIDES, BAG_N, DIM)
    task = dummy_task(str(csv_path), name=name)
    return WSIBagDataset(task, csv_path, data_dir=str(data_dir)).subset(range(N_SLIDES))


def seeded_model(dev: torch.device) -> ToadMIL:
    """TOAD "big" at the fixture's width in bf16 compute, weights from a seeded generator."""
    cfg = ModelConfig(in_dim=DIM, n_classes=N_CLASSES, compute_dtype="bfloat16")
    return ToadMIL(cfg, generator=torch.Generator().manual_seed(0)).to(dev).eval()


def batch_probs(model: ToadMIL, b, dev: torch.device) -> torch.Tensor:
    """The batch's class probabilities [B, n_classes]: a batch the producer
    placed on the card is waited for; one left on the host is copied now."""
    b.wait()
    x, mask = (torch.as_tensor(t).to(dev) for t in (b.features, b.patch_mask))
    return model(x, mask, torch.as_tensor(b.sex).to(dev), need_attention=False).y_prob


@torch.inference_mode()
def slides_per_sec(model: ToadMIL, make_batcher: Callable[[], BagBatcher], dev: torch.device) -> float:
    """Slides/s over EPOCHS epochs, the best of RUNS after one warm-up epoch;
    each step reads its probabilities' sum back."""

    def epoch() -> float:
        acc = 0.0
        for b in make_batcher():
            acc += float(batch_probs(model, b, dev).sum())
        return acc

    epoch()  # warm-up: the kernels' build, the page cache, the native loader
    best = float("inf")
    for _ in range(RUNS):
        t0 = time.perf_counter()
        for _ in range(EPOCHS):
            epoch()
        best = min(best, time.perf_counter() - t0)
    return N_SLIDES * EPOCHS / best


@torch.inference_mode()
def slide_probs(model: ToadMIL, batcher: BagBatcher, dev: torch.device) -> np.ndarray:
    """Every real bag's ``y_prob`` [n_bags, n_classes] in the batcher's order."""
    rows = [batch_probs(model, b, dev).float().cpu().numpy()[b.bag_mask > 0] for b in batcher]
    return np.concatenate(rows)


def main(argv: list[str] | None = None) -> int:
    args = probe_parser(__doc__).parse_args(argv)
    dev = resolve_device(args.device)
    launches = cuda_pool.LAUNCHES
    with fixture_dir(args.data_dir) as data_dir:
        split = fixture_split(data_dir, "io_probe")
        model = seeded_model(dev)

        def batcher(device: torch.device | None) -> BagBatcher:
            return BagBatcher(split, batch_size=BATCH, bucket_sizes=(BAG_N,), mode="sequential", device=device)

        base = slides_per_sec(model, lambda: batcher(None), dev)
        overlapped = slides_per_sec(model, lambda: batcher(dev), dev)
        max_prob_dev = float(np.abs(slide_probs(model, batcher(None), dev) - slide_probs(model, batcher(dev), dev)).max())
    print(json.dumps({
        "dispatch_h2d_slides_per_sec": round(base, 2),
        "producer_device_put_slides_per_sec": round(overlapped, 2),
        "speedup": round(overlapped / base, 3),
        "max_prob_dev": max_prob_dev,
        "k1_launches": cuda_pool.LAUNCHES - launches,
        "device": device_name(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
