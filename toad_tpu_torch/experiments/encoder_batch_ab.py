"""The ResNet encoder's tiles/s at batch 128, 256 and 512, interleaved.

Counterpart of ``experiments/encoder_batch_ab.py``: the truncated ResNet-50
at full width, its BN folded, in bf16 (cuDNN convs in ``channels_last`` on
the card; weights from a seeded generator), at 256 px. The three batch sizes
take turns within one process over 3 reps, so that drift of the machine
cannot favour one of them; each timed call embeds the same 1,536 tiles (a
chain of 1536 / B forwards, each input the first tiles plus bf16(the running
sum of the features * 1e-12), so that no forward can start before the last
ends), drawn on the device from a seeded generator, and ends with one scalar
read (``vit_probe_common.serial_time``: the best of 2 after a warm-up).

Run: python -m toad_tpu_torch.experiments.encoder_batch_ab [--device cpu]
Prints the JAX probe's lines: ``compiled B=...`` a batch size, then one line
a rep with each batch size's patches/s.
"""

from __future__ import annotations

import argparse
import sys

import torch

from toad_tpu_torch.config import EncoderConfig
from toad_tpu_torch.experiments import resolve_device
from toad_tpu_torch.experiments.vit_probe_common import serial_time
from toad_tpu_torch.models.resnet_encoder import ResNetEncoder

HW = 256
TOTAL = 1536  # tiles a timed call, divisible by every batch size
BATCHES = (128, 256, 512)
REPS = 3


def make_fn(enc: ResNetEncoder, b: int, hw: int, total: int):
    """fn(seed) -> f32 scalar on the encoder's device: ``total // b``
    dependent forwards of b tiles [b, hw, hw, 3] drawn uniform in [0, 1)."""
    k = total // b
    dev = enc.conv1.weight.device

    @torch.inference_mode()
    def fn(seed: int) -> torch.Tensor:
        g = torch.Generator(device=dev).manual_seed(seed)
        tiles = torch.rand(b, hw, hw, 3, generator=g, device=dev).to(torch.bfloat16)
        t, acc = tiles, torch.zeros((), dtype=torch.float32, device=dev)
        for _ in range(k):
            feats = enc.apply_folded(t)
            t = t + (acc * 1e-12).to(torch.bfloat16)
            acc = acc + feats.sum()
        return acc

    return fn


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    enc = ResNetEncoder(EncoderConfig(), generator=torch.Generator().manual_seed(0)).fold_bn().to(dev).eval()
    fns = {b: make_fn(enc, b, HW, TOTAL) for b in BATCHES}
    # every batch size once first, so that the reps time the steady state (cuDNN's plans chosen)
    for b in BATCHES:
        float(fns[b](0))
        print(f"compiled B={b}", flush=True)
    for rep in range(REPS):
        out = []
        for b in BATCHES:
            t = serial_time(fns[b], 1 + rep, runs=2)
            out.append(f"B={b}: {TOTAL / t:.0f} p/s")
        print(f"rep{rep}: " + "  ".join(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
