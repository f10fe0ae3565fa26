"""Where the time of one long bag goes (B=1, N=131,072 rows of 1024-d).

Counterpart of ``experiments/longbag_probe.py``, on ``ToadMIL`` in bf16 on
the card (weights from a seeded generator):

1. full_bump:    the bench harness: k forwards, each input the last one plus
                 bf16(sum of the probabilities * 1e-12), which rewrites the
                 whole 268 MB bag between forwards;
2. element_bump: the same chain with the dependency carried by one element
                 of the bag (no rewrite of the bag);
3. split_2048:   the element-bump chain over K1 alone
                 (``ops/cuda_pool.pool``) launched with 2,048-row splits,
                 the long-bag probe's 2,048-row tiles (``pool_tile2048``).
                 The JAX arm sums the kernel's 8 padded task rows; K1
                 computes the 2 real ones, and this arm sums those 2.

Each arm runs at k and 4k forwards (the JAX probe's 8 and 32), each timed
the best of 3 with the bag drawn inside the timed run, and reports the
marginal (T(4k) - T(k)) / 3k (set-up, the draw included, amortized out) and
TFLOP/s counted by the JAX probe's formula 2·N·(1024·512 + 512·512 +
512·768) over that marginal. K1's launches in each arm are counted.

Run: python -m toad_tpu_torch.experiments.longbag_probe [--n 131072 --k 8]
Prints one JSON line per arm.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.experiments import device_name, resolve_device, time_chain
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops import cuda_pool
from toad_tpu_torch.ops.fused_pool import plain_pool

DIM, N_CLASSES = 1024, 18
ROWS_PER_SPLIT = 2048
RUNS = 3  # timed runs of each chain, the best kept (the JAX probe's time_best)


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--n", type=int, default=131072)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu for the plain versions")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, k = args.n, args.k
    model = ToadMIL(ModelConfig(in_dim=DIM, n_classes=N_CLASSES, compute_dtype="bfloat16"),
                    generator=torch.Generator().manual_seed(0)).to(dev).eval()
    mask = torch.ones(1, n, device=dev)
    sex = torch.zeros(1, dtype=torch.int64, device=dev)

    def draw(i):
        g = torch.Generator(device=dev).manual_seed(2 + i)
        return torch.randn(1, n, DIM, generator=g, device=dev).to(torch.bfloat16)

    def forward_sum(x):
        out = model(x, mask, sex, need_attention=False)
        return out.y_prob.sum() + out.site_prob.sum()

    def split_pool_sum(x):
        if x.device.type == "cuda":
            m, _ = cuda_pool.pool(model.kernel_operands(torch.bfloat16), x, mask, False, rows_per_split=ROWS_PER_SPLIT)
        else:
            m, _ = plain_pool(model.pool_params(), x, mask, torch.bfloat16, False)
        return m.sum()

    def full_bump(kk):
        def f(i):
            x, acc = draw(i), torch.zeros((), device=dev)
            for _ in range(kk):
                out = model(x, mask, sex, need_attention=False)
                x = x + ((out.y_prob.sum() + out.site_prob.sum()) * 1e-12).to(torch.bfloat16)
                acc = acc + out.y_prob.sum()
            return float(acc)
        return f

    def element_bump(pool_sum, kk):
        def f(i):
            x, acc = draw(i), torch.zeros((), device=dev)
            for _ in range(kk):
                s = pool_sum(x)
                x[:, :1, :1] += (s * 1e-12).to(torch.bfloat16)
                acc = acc + s
            return float(acc)
        return f

    flops = 2 * n * (DIM * 512 + 512 * 512 + 512 * 768)
    arms = (("full_bump", full_bump), ("element_bump", lambda kk: element_bump(forward_sum, kk)),
            ("split_2048", lambda kk: element_bump(split_pool_sum, kk)))
    marginals = {}
    with torch.inference_mode():
        for name, make in arms:
            before = cuda_pool.LAUNCHES
            t_k = time_chain(make(k), RUNS)
            t_4k = time_chain(make(4 * k), RUNS)
            marginal = (t_4k - t_k) / (3 * k)
            marginals[name] = marginal
            line = {
                "arm": name,
                "device": device_name(dev),
                "n": n,
                "ms_per_bag_k": t_k / k * 1e3,
                "ms_per_bag_4k": t_4k / (4 * k) * 1e3,
                "k": k,
                "marginal_ms": marginal * 1e3,
                "setup_ms": (t_k - marginal * k) * 1e3,
                "tflops_counted": flops / marginal / 1e12 if marginal > 0 and dev.type == "cuda" else None,
                "k1_launches": cuda_pool.LAUNCHES - before,
            }
            if name == "split_2048":
                line.update(rows_per_split=ROWS_PER_SPLIT, pooled_rows_summed=2,
                            element_marginal_over_this=marginals["element_bump"] / marginal if marginal > 0 else None)
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
