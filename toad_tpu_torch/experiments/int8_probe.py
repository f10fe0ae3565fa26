"""int8 chain variants of the fused pooling kernel on the card.

Counterpart of ``experiments/int8_probe.py``: what the int8 tensor-core path
gives the pooling chain, and what its requantization and an in-kernel
quantization of the rows cost. Each variant is a kernel instance
(``csrc/pool_int8_probe.cu``; ``bf16`` is ``csrc/pool_probe.cu``'s full),
at T_PAD = 8 task columns:

- bf16:              the production math in bf16 (mfu_probe's full)
- int8_chain:        int8 GEMMs from pre-quantized rows, per-row
                     requantization between them (K2's arithmetic)
- int8_gemms:        the same GEMMs with activations cast to int8 at unit
                     scale: wrong numerics by design, the bound without the
                     requantization's work
- int8_inquant:      bf16 rows quantized per row inside the kernel (f32 math)
- int8_inquant_bf16: the same with the quantizer's arithmetic in bf16
- int8_h_only:       x W1 in bf16, only h1 and h2 quantized (bf16 math)

The last two run by name (--variants). Timing as in
:mod:`~toad_tpu_torch.experiments.mfu_probe` (bf16 inputs bumped by
bf16(sum(M) * 1e-12); pre-quantized ones by an int8 that is always 0 and
still orders the calls). pct_peak is against the card's dense peak of the
variant's operands: 989 TFLOP/s bf16, 1,979 TOP/s int8 (H100 SXM). A
variant that fails ends the run with the error: it is a fault, not a line.

Run: python -m toad_tpu_torch.experiments.int8_probe [--batch 32 --n 8192]
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from toad_tpu_torch.experiments import device_name, resolve_device, time_chain
from toad_tpu_torch.experiments.mfu_probe import make_pool, run_chain
from toad_tpu_torch.ops import probe_pool_int8
from toad_tpu_torch.ops.probe_pool import A, D, H
from toad_tpu_torch.ops.quantize import quantize_rows

PEAK = {"bf16": 989.0, "int8": 1979.0}  # dense TFLOP/s and TOP/s, H100 SXM at 700 W
DEFAULT_VARIANTS = "bf16,int8_chain,int8_inquant,int8_gemms"


def make_int8_pool(variant: str, qparams):
    """pool(x, sx, mask) -> [B, 8, H] f32: the kernel instance on a CUDA
    tensor, the plain version on a CPU one."""
    if variant not in probe_pool_int8.VARIANTS:
        raise ValueError(f"unknown int8 probe variant {variant!r}: {', '.join(('bf16',) + probe_pool_int8.VARIANTS)}")
    ops = probe_pool_int8.pack_probe_qparams(qparams) if qparams[0].device.type == "cuda" else None

    def pool(x, sx, mask):
        if x.device.type == "cuda":
            return probe_pool_int8.probe_pool_int8(ops, x, sx, mask, variant)
        if x.device.type != "cpu":
            raise ValueError(f"no probe path for device {x.device} (cuda or cpu)")
        return probe_pool_int8.plain_probe_pool_int8(qparams, x, sx, mask, variant)

    return pool


def run_chain_int8(pool, xq: torch.Tensor, sx: torch.Tensor, mask: torch.Tensor, k: int) -> float:
    """``int8_probe.run_int8``'s chain: the bump is int8(sum(M) * 1e-9 >=
    1e30), always 0, which keeps the calls serially dependent."""
    acc = torch.zeros((), dtype=torch.float32, device=xq.device)
    for _ in range(k):
        s = pool(xq, sx, mask).sum()
        xq = xq + (s * 1e-9 >= 1e30).to(torch.int8)
        acc = acc + s
    return float(acc)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--n", type=int, default=8192)
    ap.add_argument("--tile", type=int, default=1024)
    ap.add_argument("--k", type=int, default=24)
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--variants", type=str, default=DEFAULT_VARIANTS)
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu for the plain versions")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = [v for v in variants if v != "bf16" and v not in probe_pool_int8.VARIANTS]
    if unknown:
        raise ValueError(f"unknown int8 probe variant(s) {unknown}: {', '.join(('bf16',) + probe_pool_int8.VARIANTS)}")
    dev = resolve_device(args.device)
    counted = 2 * args.batch * args.n * (D * H + H * H + 2 * H * A) * args.k
    b, n = args.batch, args.n

    def draw(i):
        g = torch.Generator(device=dev).manual_seed(7 + i)
        return torch.randn(b, n, D, generator=g, device=dev)

    mask = torch.ones(b, n, device=dev)
    for variant in variants:
        if variant == "bf16":
            pool = make_pool("bf16", probe_pool_int8.probe_bf16_weights(0, dev), args.tile)

            def f(i, pool=pool):
                return run_chain(pool, draw(i).to(torch.bfloat16), mask, args.k)
        elif variant in probe_pool_int8.PREQUANTIZED:
            pool8 = make_int8_pool(variant, probe_pool_int8.probe_qparams(0, device=dev))

            def f(i, pool8=pool8):
                xq, sx = quantize_rows(draw(i))
                return run_chain_int8(pool8, xq, sx, mask, args.k)
        else:
            pool8 = make_int8_pool(variant, probe_pool_int8.probe_qparams(0, h_only=variant == "int8_h_only", device=dev))

            def f(i, pool8=pool8):
                return run_chain(lambda x, m: pool8(x, None, m), draw(i).to(torch.bfloat16), mask, args.k)

        t = time_chain(f, args.runs)
        kind = "bf16" if variant == "bf16" else "int8"
        rate = counted / t / 1e12 if dev.type == "cuda" else None  # no device rate from a CPU run
        print(json.dumps({
            "variant": variant,
            "device": device_name(dev),
            "tflops_counted" if kind == "bf16" else "tops_counted": rate,
            "pct_peak": 100 * rate / PEAK[kind] if rate is not None else None,
            "ms_per_call": t / args.k * 1e3,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
