"""Ablation ladder of the fused pooling kernel on the card.

Counterpart of ``experiments/mfu_probe.py``: the same variants of K1's body
at T_PAD = 8 task columns, each a kernel instance of ``csrc/pool_probe.cu``
(:mod:`toad_tpu_torch.ops.probe_pool`), to attribute K1's distance from its
bound:

- full:      the production math (trunk -> gate -> online softmax pool)
- fusedab:   the JAX probe's fused [Wa|Wb], already production: full's kernel
- exp2:      tanh and sigmoid written through exp
- nogate:    transcendentals removed (a = u/8, g = v/8 + 1/2), GEMMs kept
- nosoftmax: gate kept, the online softmax replaced by a plain sum of min(s, 1)
- trunkonly: the two trunk GEMMs and 1^T h only
- eager:     the same math as PyTorch ops (cuBLAS GEMMs, h through device
             memory, softmax over N): the counterpart of the JAX probe's
             ``xla`` variant
- b2:        two bags a block, their rows one GEMM chain

Timing follows the JAX probe: each run draws x on the card from a seeded
``torch.Generator`` and makes k serially dependent calls (each input is the
last one plus bf16(sum(M) * 1e-12)), then reads the total back (the one
synchronisation); the best of --runs, divided by k. Counted FLOPs use the
JAX probe's formula, 2·B·N·(D·H + H·H + 2·H·A) per call, and pct_peak is
against the card's dense bf16 peak (989 TFLOP/s for an H100 SXM).

Run: python -m toad_tpu_torch.experiments.mfu_probe [--batch 32 --n 8192 --k 24]
Prints one JSON line per variant.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from toad_tpu_torch.experiments import PEAK_BF16, device_name, resolve_device, time_chain
from toad_tpu_torch.ops import probe_pool
from toad_tpu_torch.ops.probe_pool import A, D, H
DEFAULT_VARIANTS = "full,fusedab,exp2,nogate,nosoftmax,trunkonly,eager,b2"


def make_pool(variant: str, params, tile: int):
    """pool(x, mask) -> [B, 8, H] f32 for ``variant``: its kernel instance on
    a CUDA tensor, its plain version on a CPU one (``eager``: the framework's
    ops on either)."""
    if variant == "eager":
        return lambda x, mask: probe_pool.eager_probe_pool(params, x, mask)
    probe_pool.instance(variant)
    ops = probe_pool.pack_probe_params(params) if params[0].device.type == "cuda" else None

    def pool(x, mask):
        if x.device.type == "cuda":
            return probe_pool.probe_pool(ops, x, mask, variant, tile)
        if x.device.type != "cpu":
            raise ValueError(f"no probe path for device {x.device} (cuda or cpu)")
        return probe_pool.plain_probe_pool(params, x, mask, variant, tile)

    return pool


def run_chain(pool, x: torch.Tensor, mask: torch.Tensor, k: int) -> float:
    """k serially dependent calls: the total of sum(M), each call's input the
    last one's plus bf16(sum(M) * 1e-12) (``mfu_probe.run_chain``)."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for _ in range(k):
        s = pool(x, mask).sum()
        x = x + (s * 1e-12).to(torch.bfloat16)
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
    for variant in variants:
        if variant != "eager":
            probe_pool.instance(variant)  # an unknown variant ends the run before the first line
    dev = resolve_device(args.device)
    params = probe_pool.probe_weights(0, dev)
    counted = 2 * args.batch * args.n * (D * H + H * H + 2 * H * A) * args.k

    for variant in variants:
        pool = make_pool(variant, params, args.tile)

        def f(i, pool=pool):
            g = torch.Generator(device=dev).manual_seed(7 + i)
            x = torch.randn(args.batch, args.n, D, generator=g, device=dev).to(torch.bfloat16)
            return run_chain(pool, x, torch.ones(args.batch, args.n, device=dev), args.k)

        t = time_chain(f, args.runs)
        tf = counted / t / 1e12 if dev.type == "cuda" else None  # no device rate from a CPU run
        print(json.dumps({
            "variant": variant,
            "kernel": "eager" if variant == "eager" else probe_pool.instance(variant),
            "device": device_name(dev),
            "tflops_counted": tf,
            "pct_peak": 100 * tf / PEAK_BF16 if tf is not None else None,
            "ms_per_call": t / args.k * 1e3,
        }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
