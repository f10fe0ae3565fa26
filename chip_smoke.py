"""Chip smoke test of the PyTorch/CUDA port (toad_tpu_torch) on one GPU.

Run from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is not 0):

1. CUDA present with compute capability (9, 0); the card's name and power limit.
2. Build the kernels (toad_tpu_torch/csrc/pool.cu, K1 and its partial mode
   K1p; pool_common.cuh, the combines; pool_int8.cu, K2; mha.cu, K3;
   stage.cu, KS) with nvcc, one process per source, all started together;
   shared memory per block and ptxas's register counts.
3. K1 vs its plain PyTorch version at full TOAD width (D=1024, H=512,
   A=384, T=2), f32 and bf16, scored and classification modes, including a
   bag whose tiles past bucket/2+1 are padding and a fully-masked bag: M,
   raw scores and the heads' logits, within the tolerances stated below.
   Then K1p: per shard pool_partial vs plain_pool_partial (max, denominator,
   acc / denom), and bag_sharded_pool (K1p per shard, then the shard combine
   kernel) vs its plain combine, vs K1 on the whole bag and vs plain_pool, for
   B=1 and B=2 x 163,840 rows with 150,000 live in 2, 4 and 8 shards, a bag of
   30,000 live rows in 8 shards (6 of them fully masked) and a fully masked
   bag, f32 and bf16, within K1's tolerances; then bag_sharded_pool as a
   caller uses it (the main path of K1p and the combine: their counts are
   set to 0 before and read after).
   Then K2 (int8) vs plain_int8_pool on the same cases. Then K3 (the ViT
   attention core) vs plain_mha at ViT-L/16 width (16 heads of 64), bf16 and
   f32, B=64 x 197 tokens and B=3 x 257 tokens (a ragged last query block).
4. Serve end to end: a reference-layout checkpoint and .pt bags from a seed,
   ``python -m toad_tpu_torch serve --bf16`` on port 0, a burst of 24
   concurrent requests over the octet-stream f32/bf16, JSON features_b64 and
   bag_path routes, with and without attention; every answer checked against
   the plain forward on the card. Twice: at the default 5 ms batching window
   (the main path of K1: its kernel launch count is the one reported, and its
   requests/s and p50 are timed), then at a 300 ms window, where /stats must
   show coalescing; SIGTERM drain with requests in flight.
   Then ``serve --int8`` (the main path of K2) at the default window, no
   warmup: 24 concurrent requests over the octet int8, JSON
   features_int8_b64, bag_path (an int8 store made by
   ``python -m toad_tpu_torch convert``) and octet f32 (quantized on the
   handler thread) routes, each answer checked against the plain int8
   forward and the plain bf16 forward on the card; /stats must count int8
   kernel launches >= batches.
5. Featurize end to end (the main path of K3): two slides of seeded uint8
   tiles (136 and 200 of 224 x 224 x 3, so that each slide's last batch is
   padded) as .npz patch files, a seeded full-width, full-depth ViT-L/16
   state_dict, then ``python -m toad_tpu_torch featurize --encoder vit
   --format npz --batch_size 64`` as a child process. Its last JSON line,
   each bag's shape and coords, its K3 launch count (24 per tile batch) and
   its features against the same encoder with plain_mha in place of the
   kernel on the card. Then ``--format int8`` for one slide, read back with
   load_bag_quantized.
7. Train end to end (the trainer's validation and final passes are a main
   path of K1): toad_tpu_torch.data.synthetic writes a seeded dataset at full
   width (72 slides of 2,000-30,000 patches x 1024 as .npy, 18 origins with at
   least 3 slides each), generate_splits writes one fold, then ``python -m
   toad_tpu_torch train --max_epochs 3 --batch_size 4 --early_stopping
   --resume`` (f32) as a child process, and a run of one epoch with ``--bf16
   --drop_out``. Checked: exit code 0; every epoch's train and val loss
   finite and the train loss falling; s_0_checkpoint.pt, splits_0.csv,
   split_0_results.pkl and summary.csv written; the trainer's pooling-kernel
   launches equal its eval batches; the checkpoint reloaded with
   load_params_any into a fresh model on the card reproduces summary.csv's
   test accuracy and AUC; one train step on the card against the same step
   on the CPU from the same weights and batch (f32, dropout off, TF32 off:
   torch.backends.cuda.matmul.allow_tf32 stays False): loss within 1e-4,
   every gradient within 1e-3 of its largest entry.
8. Evaluate end to end (``eval`` is a main path of K1 and, with ``--int8``,
   of K2), inside phase 7's work directory, each command a child process as
   a user runs it: ``python -m toad_tpu_torch eval --models_exp_code
   smoke_f32_s1 --k 1 --batch_size 4`` on the test split: fold_0.csv holds
   the test split's slides in split order under the reference's columns, and
   summary.csv reproduces the trainer's own test accuracy (1e-6) and AUC
   (1e-4); pooling kernel launches = eval batches. The same with ``--bf16
   --drop_out`` on the bf16 run. With ``--int8``: the int8 kernel's launches
   = eval batches and none of the float kernel, the wire is int8, every
   probability within 0.02 of the f32 run's; with ``--int8 --transfer_dtype
   float32`` (rows quantized on the card) within 1e-6 of the int8-wire run.
   Once ``--split all --calibrate --bootstrap 200``: the confusion matrix,
   the calibration report (a finite positive temperature) and the intervals
   (each brackets its point value) parse; ``report --dir`` on that directory
   gives n_folds 1 and the summary's means in its last JSON line. In
   process: evaluate_split on the card against evaluate_split on the CPU from
   the same checkpoint (f32, bags cut to 8,192 rows): probabilities within
   1e-4; a second pass on the card reuses the first one's pinned ring and no
   producer thread is left. Reported: slides/s and data-wait share of each pass by the CLI's
   own clock, the bytes each wire carried, the peak device memory.
6. Timing: kernel launches vs plain versions (CUDA events, median of 5 after
   warm-up, in the order plain, kernel, kernel, plain), for K3 also the
   library call F.scaled_dot_product_attention on the same qkv (timed only,
   never used by the package), the encoder's time per batch of 64 tiles, and
   the serving bursts' requests/s and p50 latency, each with the card's name
   and power limit. Each kernel's bound (the least time the card could take:
   the larger of its bytes over the memory rate and its operations over the
   peak rate of their type) is computed from the shapes timed.
9. The truncated ResNet-50 (run after phase 5): KS, the fused bottleneck
   stage kernel (toad_tpu_torch/csrc/stage.cu), against plain_stage at full
   width for layer1, layer2 and layer3, B=64 at 256 px and B=3 at 224 px
   (edge tiles masked), bf16 and f32 (TF32 off), and refused shapes raise
   without a launch; fused_stage over the BN-folded encoder's three stages
   on the stem's output of 64 seeded tiles (the main path of KS, 13
   launches, counted from 0); KS, plain_stage and the encoder's cuDNN blocks
   timed per stage and for the three, each with its bound; the encoder's ms
   per batch of 64 split by stem (stem_s2d on and off), stages and pool.
   Then featurization with the default encoder: a seeded 2048 x 3072 slide
   with a near-white region through tiling.tile_image, a second slide of
   200 seeded tiles, both as .npz patch files, a seeded torchvision-layout
   state_dict (.pth), then ``python -m toad_tpu_torch featurize --weights
   ... --format npz --batch_size 64`` without ``--encoder`` as a child
   process: its last JSON line, each bag's shape and coords, its features
   against the same encoder in process (within the encoder's own bf16 noise
   against f32 compute), and the f32 encoder on the card against the CPU on
   8 tiles; tiles/s by the CLI's clock and warm.

The second-to-last line is the kernels' JSON record, the last line the device
record. Weights and data are random, made from --seed.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# Tolerances, kernel vs plain version on the card.
# f32: both compute in full f32 (no TF32); they differ only in summation
# order, as the TPU kernel's parity test (tests/test_pallas.py) allows.
TOL_F32 = dict(atol=2e-3, rtol=2e-3)
# bf16: the plain version rounds each activation after adding its bias in
# bf16 (x@W in bf16, then + b in bf16), the kernel adds the f32 bias to the
# f32 accumulator and rounds once, and the kernel rounds the softmax weights
# to bf16 before e^T h (the TPU kernel's rounding points). Each intermediate
# may then differ by about one bf16 ulp (2^-8 relative), which the 384-wide
# score head can sum to ~1e-2 on O(1) scores; pooled means average it down.
TOL_BF16_M = dict(atol=1e-2, rtol=1e-2)
TOL_BF16_S = dict(atol=4e-2, rtol=4e-2)
TOL_BF16_LOGITS = dict(atol=2e-2, rtol=2e-2)
TOL_PROB = 1e-2  # served class probabilities vs the plain forward (bf16 compute)
# int8, K2 vs plain_int8_pool: the integer GEMMs and every dequantization
# and requantization step round identically (explicitly rounded kernel
# arithmetic), so scores differ only where tanhf/expf round a gated value to
# the other side of a bf16 tie (~1e-4 on a score); the kernel's online
# softmax rounds e to bf16 against a running max, the plain version against
# the bag's max, which moves pooled means by ~1 bf16 ulp of e averaged over
# the bag.
TOL_INT8_S = dict(atol=1e-3, rtol=1e-3)
TOL_INT8_M = dict(atol=2e-3, rtol=2e-3)
TOL_INT8_LOGITS = dict(atol=2e-3, rtol=2e-3)
# served int8 answers: vs the plain int8 forward on the card, as TOL_PROB;
# vs the plain bf16 forward, the quantization budget of tests/test_int8.py
TOL_INT8_VS_BF16 = 0.02
# K3 vs plain_mha. f32: both in full f32, summation order apart. bf16: the
# same rounding points (f32 scores and softmax, p and the context rounded to
# bf16), so a value differs only where summation order tips a rounding: one
# bf16 ulp, at most 2^-7 = 7.8e-3 relative; atol for contexts that cancel
# to near 0.
TOL_MHA_F32 = dict(atol=5e-5, rtol=5e-5)
TOL_MHA_BF16 = dict(atol=2e-3, rtol=1e-2)
# ViT-L/16 features (f32, LayerNorm output of unit scale) from the featurize
# child process vs the same encoder with plain_mha on the card. In f32 the
# two paths agree to summation order (TOL_FEATURES_F32, checked on one batch).
# In bf16 the one-ulp differences above pass through 24 bf16 blocks, and two
# bf16 evaluations that differ anywhere end as far from each other as each is
# from the f32 evaluation: measured on an H100 with these weights, mean
# |difference| 1.0e-2 and at most 0.13 between the kernel and plain paths,
# 1.2e-2 and 0.10 between either and f32. So: each value within about twice
# the largest difference seen, and the mean |difference| within twice the
# mean seen; a wrong head or a wrong row moves the mean by far more.
TOL_FEATURES_F32 = dict(atol=1e-4, rtol=1e-4)
TOL_FEATURES = dict(atol=0.25, rtol=3e-2)
TOL_FEATURES_MEAN = 2e-2
# KS vs plain_stage, relative to the largest |output| of the stage. f32: both
# in full f32 (no TF32), summation order apart (measured on an H100: 2e-6).
# bf16: the same rounding points, but a summation-order difference that tips
# one bf16 rounding of h1 or h2 passes through the next product (measured:
# up to 1.2e-2 of the largest output, on layer3).
TOL_STAGE_F32 = 1e-4
TOL_STAGE_BF16 = 2e-2
# the ResNet-50 encoder in f32 (TF32 off) on the card vs the CPU, relative to
# the largest |feature|: summation order through 13 blocks
TOL_RESNET_F32 = 1e-4

# Published dense peaks of one H100 SXM at its 700 W limit: device memory
# bytes/s, and operations/s by operand type.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def check_close(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    err = (got - want).abs()
    bad = err > tol["atol"] + tol["rtol"] * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} values outside {tol}, max abs err {err.max().item():.3e}")
    return err.max().item()


def seeded_model(seed: int):
    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.models.toad_mil import ToadMIL

    g = torch.Generator().manual_seed(seed)
    model = ToadMIL(ModelConfig(in_dim=1024, n_classes=18), generator=g)
    with torch.no_grad():  # reference init zeroes the biases; random ones exercise the bias paths
        for m in model.modules():
            if isinstance(m, torch.nn.Linear):
                m.bias.copy_(torch.randn(m.bias.shape, generator=g) * 0.05)
    return model


def plain_forward(model, x, mask, sex, compute_dtype, need_attention):
    """The model's forward with the plain pooling in place of the kernel."""
    from toad_tpu_torch.ops.fused_pool import plain_pool

    m, scores = plain_pool(model.pool_params(), x, mask, compute_dtype, with_scores=need_attention)
    return model._finish(m, scores, mask, sex, False)


def cast_params(params: dict, dtype: torch.dtype) -> dict:
    """The plain pool's params already in the compute dtype, so that timing
    it leaves out the per-call weight casts, as the kernel's packed operands do."""
    return {k: cast_params(v, dtype) if isinstance(v, dict) else v.to(dtype) for k, v in params.items()}


# -- phases -------------------------------------------------------------------


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False: this check needs a CUDA GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap}, the kernels are built for sm_90a (9, 0)")
    line = gpu_line()
    log(f"phase 1 device: {torch.cuda.get_device_name(0)} capability {cap}, "
        f"torch {torch.__version__} cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    return torch.cuda.get_device_name(0), line


def phase_build(card: str) -> None:
    from toad_tpu_torch.ops import _build, cuda_mha, cuda_pool, cuda_pool_int8

    t0 = time.perf_counter()
    _build.load_library()
    took = time.perf_counter() - t0
    how = f"nvcc {_build.build_seconds:.2f} s" if _build.build_seconds is not None else "found built in _build/"
    log(f"phase 2 build: {_build.library_path().name} ready in {took:.2f} s ({how}); "
        f"pool smem/block bf16 {cuda_pool.smem_bytes(torch.bfloat16, 512, 384)} B, "
        f"f32 {cuda_pool.smem_bytes(torch.float32, 512, 384)} B, "
        f"int8 {cuda_pool_int8.smem_bytes(384)} B; attention smem/block bf16 "
        f"{cuda_mha.smem_bytes(torch.bfloat16, 197)} B (197 tokens), {cuda_mha.smem_bytes(torch.bfloat16, 257)} B (257), "
        f"f32 {cuda_mha.smem_bytes(torch.float32, 197)} B (197) [{card}]")
    # ptxas -v: each kernel's registers and spills
    kernel = None
    for line in _build.build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel is not None and ("registers" in line or "spill stores" in line):
            names = {"pool_int8_kernel": "K2 int8", "pool_kernelIf": "K1 f32", "pool_kernelI13": "K1 bf16",
                     "pool_combine_kernelILb1": "combine", "pool_combine_kernelILb0": "combine without division (K1p)", "mha_bf16_kernelILi13": "K3 bf16 (up to 208 tokens)",
                     "mha_bf16_kernelILi17": "K3 bf16 (up to 272 tokens)", "mha_f32_kernel": "K3 f32",
                     **{f"stage_block_kernelI{m}Li{w}E": f"KS {d} ({16 * w}-pixel tiles)"
                        for m, d in (("f", "f32"), ("13__nv_bfloat16", "bf16")) for w in (1, 2, 4)}}
            name = next((v for k, v in names.items() if k in kernel), kernel)
            log(f"phase 2 build: {name}: {line.split(':', 1)[-1].strip()}")


def compare_cases(g: torch.Generator) -> list:
    """(label, B, N, mask) at the serving shapes, at two shapes that only
    ``eval`` sends (a rung of an ``--buckets auto`` ladder: a multiple of 128
    that is no power of two, and a ``--patient_bags`` bucket past 65,536
    rows), a bag at bucket/2+1 and a fully-masked bag between live ones."""
    dev = torch.device("cuda")
    cases = []
    for b, n in ((1, 8192), (3, 8192), (32, 8192), (1, 65536), (4, 29568), (2, 131072)):
        cases.append((f"B={b} N={n}", b, n, (torch.rand(b, n, device=dev, generator=g) < 0.9).float()))
    tail = torch.zeros(2, 8192, device=dev)
    tail[0, : 8192 // 2 + 1] = 1.0  # bag at bucket/2+1: every later tile is padding
    tail[1, :100] = 1.0
    cases.append(("padding tiles B=2 N=8192", 2, 8192, tail))
    masked = torch.ones(3, 4096, device=dev)
    masked[1] = 0.0  # one fully-masked bag between live ones
    cases.append(("fully-masked bag B=3 N=4096", 3, 4096, masked))
    return cases


def check_modes(label: str, mask, outs: dict, tols: tuple) -> float:
    """Checks one case's kernel and plain outputs in scored and classification
    mode; ``outs[scored] = (M_k, scores_k, logits_k, M_p, scores_p,
    logits_p)``. Returns the largest error of M and scores."""
    tol_m, tol_s, tol_l = tols
    worst = 0.0
    for scored, (mk, sk, lk, mp, sp, lp) in outs.items():
        mode = "scored" if scored else "classification"
        em = check_close(f"{label} {mode} M", mk, mp, tol_m)
        el = check_close(f"{label} {mode} logits", lk, lp, tol_l)
        es = check_close(f"{label} {mode} scores", sk, sp, tol_s) if scored else 0.0
        if not scored and sk is not None:
            raise AssertionError("classification mode returned scores")
        dead = mask.sum(1) == 0
        if dead.any() and (mk[dead].abs().max().item() != 0.0):
            raise AssertionError(f"{label}: a fully-masked bag pooled to nonzero M")
        worst = max(worst, em, es)
        log(f"phase 3 compare {label} {mode}: max abs err M {em:.2e} scores {es:.2e} logits {el:.2e}")
    return worst


def phase_compare(model, seed: int) -> float:
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = model.pool_params()
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = 0.0
    for label, b, n, mask in compare_cases(g):
        x = torch.randn(b, n, 1024, device=dev, generator=g)
        sex = torch.arange(b, device=dev) % 2
        for dt, tols in (
            (torch.float32, (TOL_F32, TOL_F32, TOL_F32)),
            (torch.bfloat16, (TOL_BF16_M, TOL_BF16_S, TOL_BF16_LOGITS)),
        ):
            outs = {}
            for scored in (True, False):
                with torch.inference_mode():
                    mk, sk = cuda_pool.pool(model.kernel_operands(dt), x, mask, with_scores=scored)
                    mp, sp = plain_pool(params, x, mask, dt, with_scores=scored)
                    lk = model._finish(mk, None, mask, sex, False).logits
                    lp = model._finish(mp, None, mask, sex, False).logits
                torch.cuda.synchronize()
                outs[scored] = (mk, sk, lk, mp, sp, lp)
            worst = max(worst, check_modes(f"{label} {str(dt)[6:]}", mask, outs, tols))
    return worst


def phase_compare_partial(model, seed: int) -> tuple[float, float]:
    """K1p (the pooling kernel's partial mode) against plain_pool_partial per
    shard, and bag_sharded_pool (K1p per shard, then the combine kernel)
    against K1 on the whole bag and against plain_pool, on bags of 163,840
    rows. Returns the largest error of (the shards' statistics, the
    combined M)."""
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool, plain_pool_partial
    from toad_tpu_torch.ops.pooling import NEG_INF
    from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool, plain_combine_partial_pool

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    params = model.pool_params()
    g = torch.Generator(device=dev).manual_seed(seed + 3)
    n = 163_840
    # (label, live rows per bag, shard counts)
    cases = (("B=1 150,000 live", (150_000,), (2, 4, 8)), ("B=2 150,000 live", (150_000, 150_000), (2, 4, 8)),
             ("B=1 30,000 live", (30_000,), (8,)), ("B=2 one bag fully masked", (0, 150_000), (4,)))
    worst_stats = worst_m = 0.0
    for label, live, shard_counts in cases:
        b = len(live)
        x = torch.randn(b, n, 1024, device=dev, generator=g)
        mask = torch.zeros(b, n, device=dev)
        for i, rows in enumerate(live):
            mask[i, :rows] = (torch.rand(rows, device=dev, generator=g) < 0.95).float()
        for dt, tol_m, tol_s in ((torch.float32, TOL_F32, TOL_F32), (torch.bfloat16, TOL_BF16_M, TOL_BF16_S)):
            name = f"{label} {str(dt)[6:]}"
            with torch.inference_mode():
                ops = model.kernel_operands(dt)
                m_whole, _ = cuda_pool.pool(ops, x, mask, with_scores=False)
                m_plain, _ = plain_pool(params, x, mask, dt, with_scores=False)
                for n_shards in shard_counts:
                    per = n // n_shards
                    masked_shards, e_max, e_den, e_mean = 0, 0.0, 0.0, 0.0
                    accs, stats = [], []
                    for s in range(n_shards):
                        xs, ms = x[:, s * per:(s + 1) * per], mask[:, s * per:(s + 1) * per]
                        acc_k, st_k = cuda_pool.pool_partial(ops, xs, ms)
                        acc_p, st_p = plain_pool_partial(params, xs, ms, dt)
                        accs.append(acc_k)
                        stats.append(st_k)
                        dead = ms.sum(1) == 0  # [B]
                        masked_shards += int(dead.sum())
                        if dead.any() and not (bool((st_k[dead, 0] == NEG_INF).all()) and bool((st_k[dead, 1] == 0).all())
                                               and bool((acc_k[dead] == 0).all())):
                            raise AssertionError(f"{name} shard {s}/{n_shards}: a masked shard is not (NEG_INF, 0, 0)")
                        if (~dead).any():
                            lv = ~dead
                            # the max as a score; the denominator, brought to the plain version's max,
                            # relative to it (its error is the scores'); acc / denom, the shard's own pooled mean, as M
                            e_max = max(e_max, check_close(f"{name} shard {s}/{n_shards} max", st_k[lv, 0], st_p[lv, 0], tol_s))
                            den_k = st_k[lv, 1] * torch.exp(st_k[lv, 0] - st_p[lv, 0])
                            e_den = max(e_den, check_close(f"{name} shard {s}/{n_shards} denom / plain denom",
                                                           den_k / st_p[lv, 1], torch.ones_like(den_k), tol_s))
                            e_mean = max(e_mean, check_close(
                                f"{name} shard {s}/{n_shards} acc / denom", acc_k[lv] / st_k[lv, 1, :, None],
                                acc_p[lv] / st_p[lv, 1, :, None], tol_m))
                    m_sharded = bag_sharded_pool(ops, x, mask, n_shards)
                    # the combine kernel alone, on the kernel's own partials, against its plain version
                    e_comb = check_close(f"{name} {n_shards} shards combine vs plain combine", m_sharded,
                                         plain_combine_partial_pool(torch.stack(accs), torch.stack(stats)), TOL_F32)
                    e_whole = check_close(f"{name} {n_shards} shards vs K1 on the whole bag", m_sharded, m_whole, tol_m)
                    e_plain = check_close(f"{name} {n_shards} shards vs plain_pool", m_sharded, m_plain, tol_m)
                    dead_bags = mask.sum(1) == 0
                    if dead_bags.any() and m_sharded[dead_bags].abs().max().item() != 0.0:
                        raise AssertionError(f"{name}: a fully-masked bag pooled to nonzero M")
                    torch.cuda.synchronize()
                    worst_stats = max(worst_stats, e_max, e_mean)
                    worst_m = max(worst_m, e_whole, e_plain, e_comb)
                    log(f"phase 3 compare partial pool {name} N={n} in {n_shards} shards ({masked_shards} fully masked): "
                        f"per shard vs plain_pool_partial max abs err of max {e_max:.2e}, of denom / plain denom "
                        f"{e_den:.2e} (tolerance {tol_s}), of acc / denom {e_mean:.2e}; bag_sharded_pool vs its plain "
                        f"combine {e_comb:.2e} (tolerance {TOL_F32}), vs K1 on the whole bag {e_whole:.2e}, "
                        f"vs plain_pool {e_plain:.2e} (tolerance {tol_m})")
        del x, mask
    return worst_stats, worst_m


def phase_compare_int8(model, seed: int) -> float:
    """K2 against plain_int8_pool on the cases of phase_compare, from rows
    quantized on the card."""
    from toad_tpu_torch.ops import cuda_pool_int8
    from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.inference_mode():
        qparams, ops = model.int8_operands()
    worst = 0.0
    for label, b, n, mask in compare_cases(g):
        xq, sx = quantize_rows(torch.randn(b, n, 1024, device=dev, generator=g))
        sex = torch.arange(b, device=dev) % 2
        outs = {}
        for scored in (True, False):
            with torch.inference_mode():
                mk, sk = cuda_pool_int8.pool_int8(ops, xq, sx, mask, with_scores=scored)
                mp, sp = plain_int8_pool(qparams, xq, sx, mask, with_scores=scored)
                lk = model._finish(mk, None, mask, sex, False).logits
                lp = model._finish(mp, None, mask, sex, False).logits
            torch.cuda.synchronize()
            outs[scored] = (mk, sk, lk, mp, sp, lp)
        worst = max(worst, check_modes(f"{label} int8", mask, outs, (TOL_INT8_M, TOL_INT8_S, TOL_INT8_LOGITS)))
    return worst


def phase_compare_mha(seed: int) -> float:
    """K3 against plain_mha at ViT-L/16 width; also that a shape without an
    instance raises and launches nothing."""
    from toad_tpu_torch.ops import cuda_mha
    from toad_tpu_torch.ops.vit_attention import fused_mha, plain_mha

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    worst = 0.0
    for dt, tol in ((torch.bfloat16, TOL_MHA_BF16), (torch.float32, TOL_MHA_F32)):
        for b, n in ((64, 197), (3, 257)):
            qkv = torch.randn(b, n, 3 * 16 * 64, device=dev, generator=g).to(dt)
            with torch.inference_mode():
                out = fused_mha(qkv, 16, 64)
                ref = plain_mha(qkv, 16, 64)
            torch.cuda.synchronize()
            err = check_close(f"attention {str(dt)[6:]} B={b} N={n}", out, ref, tol)
            log(f"phase 3 compare attention {str(dt)[6:]} B={b} N={n} H=16 Dh=64: max abs err {err:.2e} "
                f"(tolerance {tol})")
            worst = max(worst, err)
    before = cuda_mha.LAUNCHES
    for shape, heads, head_dim in (((1, 300, 3 * 1024), 16, 64), ((1, 197, 3 * 512), 16, 32)):
        try:
            fused_mha(torch.zeros(shape, device=dev, dtype=torch.bfloat16), heads, head_dim)
        except ValueError as e:
            log(f"phase 3 compare attention: unsupported shape raises: {e}")
        else:
            raise AssertionError(f"attention kernel took unsupported shape {shape}, head_dim {head_dim}")
    if cuda_mha.LAUNCHES != before:
        raise AssertionError("a refused shape counted as a launch")
    return worst


def cuda_ms(fn, reps: int = 5, inner: int = 1) -> float:
    """Median of ``reps`` CUDA-event timings of fn() after two warm-up calls.
    ``inner`` > 1 times that many back-to-back calls per reading and divides:
    for a call of a fraction of a millisecond, whose single reading would be
    mostly the idle card waiting for the launch."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def time_pair(label: str, plain_fn, kernel_fn, work: dict, gpu: str, library_fn=None, inner: int = 1) -> dict:
    """Kernel vs plain version, timed plain, kernel, kernel, plain so that
    drift on the card hits both alike, each the better of its two medians;
    ``library_fn`` (one PyTorch call computing the same function) is timed
    between the kernel's two turns; ``inner`` as in :func:`cuda_ms`. ``work`` is the call's ``bytes`` (each
    input read once, each output written once), ``ops`` and their ``kind``
    (a key of PEAK_OPS_S). Returns the kernel record's ms, plain_ms,
    library_ms, bound_ms and bound_by."""
    fns = (plain_fn, kernel_fn, *((library_fn, library_fn) if library_fn else ()), kernel_fn, plain_fn)
    p1, k1, *lib, k2, p2 = (cuda_ms(fn, inner=inner) for fn in fns)
    k, p = min(k1, k2), min(p1, p2)
    library = min(lib) if lib else None
    t_bytes, t_ops = work["bytes"] / PEAK_BYTES_S * 1e3, work["ops"] / PEAK_OPS_S[work["kind"]] * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    unit = "TOP/s" if work["kind"] == "int8" else "TFLOP/s"
    verdict = "kernel faster" if k < p else "kernel SLOWER than plain"
    lib_text = f", library call {library:.3f} ms ({lib[0]:.3f}/{lib[1]:.3f})" if lib else ""
    log(f"phase 6 timing {label}: kernel {k:.3f} ms ({k1:.3f}/{k2:.3f}), plain {p:.3f} ms ({p1:.3f}/{p2:.3f})"
        f"{lib_text}, {work['ops'] / (k * 1e-3) / 1e12:.1f} {unit}, {work['bytes'] / (k * 1e-3) / 1e9:.0f} GB/s, "
        f"{verdict}; bound {bound_ms:.4f} ms by {bound_by} ({t_bytes:.4f} ms for {work['bytes'] / 1e6:.1f} MB, "
        f"{t_ops:.4f} ms for {work['ops'] / 1e9:.1f} G{work['kind']} operations), kernel at "
        f"{100 * bound_ms / k:.1f} % of it [{gpu}]")
    return dict(ms=k, plain_ms=p, library_ms=library, bound_ms=bound_ms, bound_by=bound_by)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def phase_timing(model, gpu: str) -> dict:
    """Kernel launches on pre-packed operands against the plain versions on
    pre-cast (or pre-quantized) weights: both leave out the weight
    preparation a model does once. Returns {(kernel, B): time_pair's record}."""
    import torch.nn.functional as F

    from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
    from toad_tpu_torch.ops.fused_pool import plain_pool
    from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_rows
    from toad_tpu_torch.ops.vit_attention import fused_mha, plain_mha

    dev = torch.device("cuda")
    out = {}
    for b, n in ((32, 8192), (1, 65536)):
        x = torch.randn(b, n, 1024, device=dev)
        mask = torch.ones(b, n, device=dev)
        ops_per_call = cuda_pool.flops_per_row(1024, 512, 384) * b * n
        out_bytes = b * 2 * 512 * 4  # M [B, 2, H] f32
        with torch.inference_mode():
            for dt in (torch.bfloat16, torch.float32):
                xd = x.to(dt)
                ops, params = model.kernel_operands(dt), cast_params(model.pool_params(), dt)
                out[(str(dt)[6:], b)] = time_pair(
                    f"pool {str(dt)[6:]} B={b} N={n} D=1024 classification",
                    lambda: plain_pool(params, xd, mask, dt, False), lambda: cuda_pool.pool(ops, xd, mask, False),
                    dict(bytes=nbytes(xd, mask, *ops) + out_bytes, ops=ops_per_call,
                         kind={torch.bfloat16: "bf16", torch.float32: "f32"}[dt]), gpu)
                del xd
            xq, sx = quantize_rows(x)
            qparams, ops8 = model.int8_operands()
            out[("int8", b)] = time_pair(
                f"pool int8 B={b} N={n} D=1024 classification",
                lambda: plain_int8_pool(qparams, xq, sx, mask, False),
                lambda: cuda_pool_int8.pool_int8(ops8, xq, sx, mask, False),
                dict(bytes=nbytes(xq, sx, mask, *ops8) + out_bytes, ops=ops_per_call, kind="int8"), gpu)
        del x, xq
    # K3 at the shape a batch of 64 tiles of 224 px gives it, 24 times a batch (bf16: the main path)
    b, n, heads, head_dim = 64, 197, 16, 64
    for kind, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qkv = torch.randn(b, n, 3 * heads * head_dim, device=dev).to(dt)
        q, k, v = qkv.view(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)  # [B, H, N, Dh] views for the library call
        with torch.inference_mode():
            out[("mha_" + kind, b)] = time_pair(
                f"attention {kind} B={b} N={n} H={heads} Dh={head_dim}",
                lambda: plain_mha(qkv, heads, head_dim), lambda: fused_mha(qkv, heads, head_dim),
                dict(bytes=nbytes(qkv) + nbytes(qkv) // 3, ops=4 * b * heads * n * n * head_dim, kind=kind), gpu,
                library_fn=lambda: F.scaled_dot_product_attention(q, k, v), inner=20)
    return out


def _post(url: str, data: bytes, headers: dict) -> dict:
    req = urllib.request.Request(url, data=data, headers=headers, method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        return json.loads(r.read())


def _get(url: str) -> dict:
    with urllib.request.urlopen(url, timeout=60) as r:
        return json.loads(r.read())


def make_requests(seed: int, bag_dir: Path, routes: list[str]) -> list[dict]:
    """24 requests of 3,000-60,000 patches over four routes, attention on
    half. bag_path requests get their bag saved as an f32 .pt under
    ``bag_dir``; int8 routes carry the rows quantized on the client."""
    from toad_tpu_torch.ops.quantize import quantize_rows_np

    rng = np.random.default_rng(seed)
    sizes = [3000, 5000, 7000, 9000, 12000, 20000, 30000, 60000]
    reqs = []
    for i in range(24):
        route = routes[i % 4]
        n = sizes[(i * 3) % len(sizes)]
        if route == "json_b64":
            n = min(n, 9000)  # base64 JSON is the slow convenience route
        elif route == "json_int8":
            n = min(n, 20000)  # int8 rows are a quarter of the f32 bytes
        feats = rng.standard_normal((n, 1024), dtype=np.float32)
        if route == "octet_bf16":
            feats = torch.from_numpy(feats).bfloat16().float().numpy()  # what the client sends, exactly
        path = None
        if route == "bag_path":
            path = bag_dir / f"slide_{i}.pt"
            torch.save(torch.from_numpy(feats), path)
        req = dict(route=route, feats=feats, sex=i % 2, attention=(i // 4) % 2 == 1, path=path)
        if route in ("octet_int8", "json_int8"):
            req["xq"], req["sx"] = quantize_rows_np(feats)
        reqs.append(req)
    return reqs


ROUTES = ["octet_f32", "octet_bf16", "json_b64", "bag_path"]
ROUTES_INT8 = ["octet_int8", "json_int8", "bag_path", "octet_f32"]


def send(base: str, r: dict) -> tuple[dict, float]:
    t0 = time.perf_counter()
    if r["route"].startswith("octet"):
        dtype = r["route"].split("_")[1]
        if dtype == "bf16":
            body = torch.from_numpy(r["feats"]).bfloat16().view(torch.int16).numpy().tobytes()
        elif dtype == "int8":
            body = r["xq"].tobytes() + r["sx"].tobytes()
        else:
            body = r["feats"].tobytes()
        hdr = {"Content-Type": "application/octet-stream", "X-Toad-Shape": f"{len(r['feats'])},1024",
               "X-Toad-Dtype": {"bf16": "bfloat16", "f32": "float32"}.get(dtype, dtype), "X-Toad-Sex": str(r["sex"]),
               "X-Toad-Attention": "1" if r["attention"] else "0"}
        out = _post(base + "/predict", body, hdr)
    else:
        doc = {"sex": r["sex"], "attention": r["attention"], "top_k": 3}
        if r["route"] == "bag_path":
            doc["bag_path"] = r["path"].name
        elif r["route"] == "json_int8":
            doc["features_int8_b64"] = base64.b64encode(r["xq"].tobytes()).decode()
            doc["scales_b64"] = base64.b64encode(r["sx"].tobytes()).decode()
            doc["shape"] = list(r["xq"].shape)
        else:
            doc["features_b64"] = base64.b64encode(r["feats"].tobytes()).decode()
            doc["shape"] = list(r["feats"].shape)
        out = _post(base + "/predict", json.dumps(doc).encode(), {"Content-Type": "application/json"})
    return out, time.perf_counter() - t0


def burst(base: str, reqs: list[dict]) -> tuple[list, float]:
    """All requests at once, one client thread each: (answers, wall seconds)."""
    results: list = [None] * len(reqs)
    errors: list = []

    def worker(i: int) -> None:
        try:
            results[i] = send(base, reqs[i])
        except Exception as e:  # handed to the main thread, which raises
            errors.append((i, repr(e)))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(reqs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(600)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads) or any(r is None for r in results):
        raise AssertionError(f"requests failed: {errors}")
    return results, wall


def plain_bf16_reference(model, r: dict):
    """The plain bf16 forward of one request on the card."""
    dev = torch.device("cuda")
    x = torch.from_numpy(r["feats"]).to(dev)[None]
    mask = torch.ones(1, x.shape[1], device=dev)
    with torch.inference_mode():
        return plain_forward(model, x, mask, torch.tensor([r["sex"]], device=dev), torch.bfloat16, r["attention"])


def plain_int8_reference(model, r: dict):
    """The plain int8 forward of one request on the card, from its rows
    quantized on the host (what every int8 route serves: the client's rows,
    the store's rows, or the handler thread's quantization of f32 rows)."""
    from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_rows_np

    dev = torch.device("cuda")
    xq, sx = (torch.from_numpy(a).to(dev)[None] for a in quantize_rows_np(r["feats"]))
    mask = torch.ones(1, xq.shape[1], device=dev)
    with torch.inference_mode():
        qparams, _ = model.int8_operands()
        m, scores = plain_int8_pool(qparams, xq, sx, mask, with_scores=r["attention"])
        return model._finish(m, scores, mask, torch.tensor([r["sex"]], device=dev), False)


def check_answers(model, reqs: list[dict], results: list, reference=plain_bf16_reference,
                  tol_attention: dict = TOL_BF16_S) -> tuple[float, int]:
    """Every answer against a plain forward on the card: (max |y_prob
    error|, near-ties)."""
    near_ties = 0
    worst = 0.0
    for r, (out, _lat) in zip(reqs, results):
        ref = reference(model, r)
        p_ref = ref.y_prob[0].cpu().numpy()
        p_got = np.asarray(out["y_prob"])
        err = float(np.abs(p_got - p_ref).max())
        worst = max(worst, err)
        if err > TOL_PROB:
            raise AssertionError(f"{r['route']} n={len(r['feats'])}: y_prob off by {err:.3e} > {TOL_PROB}")
        if out["y_hat"] != int(p_ref.argmax()):
            top2 = np.sort(p_ref)[-2:]
            if top2[1] - top2[0] > 2 * TOL_PROB:
                raise AssertionError(f"{r['route']}: y_hat {out['y_hat']} != plain {int(p_ref.argmax())}")
            near_ties += 1  # the two best classes are closer than the tolerance
        if r["attention"]:
            a_ref = ref.attention[0, 0].cpu().numpy()
            a_got = np.asarray(out["attention"])
            if a_got.shape != a_ref.shape:
                raise AssertionError(f"attention shape {a_got.shape} != {a_ref.shape}")
            check_close(f"{r['route']} attention", torch.from_numpy(a_got), torch.from_numpy(a_ref), tol_attention)
        elif "attention" in out:
            raise AssertionError("attention returned without being asked for")
    return worst, near_ties


def child_env() -> dict:
    """The environment of a child process that imports the package from this checkout."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


class Server:
    """``python -m toad_tpu_torch serve --bf16`` on port 0 in a child process."""

    def __init__(self, ckpt: Path, bag_dir: Path, workdir: Path, extra: list[str]):
        env = child_env()
        cmd = [sys.executable, "-m", "toad_tpu_torch", "serve", "--ckpt", str(ckpt), "--task", "dummy_mtl_concat",
               "--bf16", "--port", "0", "--bag_root", str(bag_dir), *extra]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=workdir)
        self.lines: list[str] = []

    def __enter__(self) -> "Server":
        deadline = time.monotonic() + 300
        port = None
        while port is None:
            line = self.proc.stdout.readline()
            if not line:
                raise RuntimeError(f"server exited before serving (rc {self.proc.poll()}):\n{''.join(self.lines)}")
            self.lines.append(line)
            if line.startswith("serving on "):
                port = int(line.split()[2].rsplit(":", 1)[1])
            if time.monotonic() > deadline:
                raise RuntimeError("server did not start within 300 s")
        threading.Thread(target=lambda: self.lines.extend(self.proc.stdout), daemon=True).start()
        self.base = f"http://127.0.0.1:{port}"
        return self

    def stop(self, signalled: bool = False) -> int:
        """SIGTERM (graceful drain) unless already sent; the exit code, which
        must be 0."""
        if not signalled:
            self.proc.send_signal(signal.SIGTERM)
        rc = self.proc.wait(timeout=300)
        if rc != 0 or not any("in-flight requests drained" in ln for ln in self.lines):
            raise AssertionError(f"server did not drain and exit 0 (rc {rc}):\n{''.join(self.lines[-20:])}")
        return rc

    def __exit__(self, *exc) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)


def write_checkpoint(model, workdir: Path) -> Path:
    """The model as a reference-layout s_0_checkpoint.pt."""
    from toad_tpu_torch.models.interop import reference_state_dict

    ckpt = workdir / "s_0_checkpoint.pt"
    torch.save({k: v.cpu() for k, v in reference_state_dict(model.state_dict(), dropout=True).items()}, ckpt)
    return ckpt


def p50_by_route(reqs: list[dict], results: list, routes: list[str]) -> str:
    return ", ".join(
        f"{route} {statistics.median(res[1] for r, res in zip(reqs, results) if r['route'] == route) * 1e3:.1f}"
        for route in routes)


def phase_serve(model, seed: int, gpu: str, workdir: Path) -> dict:
    ckpt = write_checkpoint(model, workdir)
    bag_dir = workdir / "bags"
    bag_dir.mkdir()
    reqs = make_requests(seed, bag_dir, ROUTES)
    attn = sum(r["attention"] for r in reqs)

    # main path: the server as a user starts it (default 5 ms batching window,
    # no --warmup). Its kernel launch count starts at 0 in the fresh process;
    # /stats reads it after the burst.
    with Server(ckpt, bag_dir, workdir, []) as srv:
        health = _get(srv.base + "/healthz")
        if health.get("device") != gpu.split(",")[0].strip():
            raise AssertionError(f"/healthz device {health} is not the card {gpu}")
        before = _get(srv.base + "/stats")
        if before["kernel_launches"] != 0 or before["int8_kernel_launches"] != 0 or before["requests"] != 0:
            raise AssertionError(f"fresh server already counts work: {before}")
        results, wall = burst(srv.base, reqs)
        stats = _get(srv.base + "/stats")
        worst, near_ties = check_answers(model, reqs, results)
        if stats["requests"] != len(reqs) or stats["kernel_launches"] < max(1, stats["batches"]):
            raise AssertionError(f"kernel launches {stats['kernel_launches']} < batches {stats['batches']}: {stats}")
        if stats["int8_kernel_launches"] != 0:
            raise AssertionError(f"the bf16 server launched the int8 kernel: {stats}")
        srv.stop()
    log(f"phase 4 serve (5 ms window): p50 latency by route (ms): {p50_by_route(reqs, results, ROUTES)} [{gpu}]")
    lat = sorted(res[1] for res in results)
    log(f"phase 4 serve (5 ms window): {len(reqs)} concurrent requests ({', '.join(ROUTES)}; attention on "
        f"{attn}), {stats['batches']} batches, mean batch {stats['mean_batch_size']}, kernel launches "
        f"{stats['kernel_launches']}, max |y_prob - plain| {worst:.2e}, near-ties {near_ties}; "
        f"burst wall {wall:.3f} s, dispatch thread in batch assembly {stats['assemble_s']:.3f} s, "
        f"in device forwards {stats['forward_s']:.3f} s [{gpu}]")
    main = dict(launches=stats["kernel_launches"], batches=stats["batches"], worst=worst,
                rps=len(reqs) / wall, p50=statistics.median(lat), wall=wall)

    # coalescing and drain: a 300 ms window gathers the burst into shared forwards
    with Server(ckpt, bag_dir, workdir, ["--max_wait_ms", "300"]) as srv:
        results, wall = burst(srv.base, reqs)
        stats = _get(srv.base + "/stats")
        worst, near_ties = check_answers(model, reqs, results)
        if not stats["batches"] < stats["requests"] == len(reqs):
            raise AssertionError(f"no coalescing: {stats}")
        if stats["kernel_launches"] < stats["batches"]:
            raise AssertionError(f"kernel launches {stats['kernel_launches']} < batches {stats['batches']}")
        lat = sorted(res[1] for res in results)
        log(f"phase 4 serve (300 ms window): {stats['batches']} batches, mean batch {stats['mean_batch_size']}, "
            f"kernel launches {stats['kernel_launches']}, max |y_prob - plain| {worst:.2e}, near-ties {near_ties}, "
            f"{len(reqs) / wall:.2f} requests/s, p50 {statistics.median(lat) * 1e3:.1f} ms; burst wall "
            f"{wall:.3f} s, assembly {stats['assemble_s']:.3f} s, forwards {stats['forward_s']:.3f} s [{gpu}]")

        # graceful drain: SIGTERM while accepted requests are still in flight
        tail: list = [None] * 4
        errors: list = []

        def worker(i: int) -> None:
            try:
                tail[i] = send(srv.base, reqs[i])
            except Exception as e:  # handed to the main thread, which raises
                errors.append((i, repr(e)))

        threads = [threading.Thread(target=worker, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 120
        while _get(srv.base + "/stats")["requests"] < stats["requests"] + 4:
            if time.monotonic() > deadline:
                raise AssertionError("drain requests never reached the batcher")
            time.sleep(0.01)
        srv.proc.send_signal(signal.SIGTERM)
        for t in threads:
            t.join(300)
        rc = srv.stop(signalled=True)
        if errors or any(res is None for res in tail):
            raise AssertionError(f"drain failed: errors {errors}")
        check_answers(model, reqs[:4], tail)
    log(f"phase 4 drain: SIGTERM with 4 requests in flight, all answered, server exit {rc}")
    return main


def phase_serve_int8(model, seed: int, gpu: str, workdir: Path) -> dict:
    """``serve --int8`` as a user starts it (default 5 ms window, no
    --warmup), fed by an int8 store that ``convert`` makes from .pt bags."""
    ckpt = write_checkpoint(model, workdir)
    src, store = workdir / "bags8_f32", workdir / "bags8"
    src.mkdir()
    reqs = make_requests(seed + 1, src, ROUTES_INT8)
    env = child_env()
    t0 = time.perf_counter()
    conv = subprocess.run([sys.executable, "-m", "toad_tpu_torch", "convert", "--data_dir", str(src), "--out_dir",
                           str(store), "--format", "int8"], capture_output=True, text=True, env=env, cwd=workdir,
                          timeout=600)
    if conv.returncode != 0:
        raise AssertionError(f"convert failed ({conv.returncode}):\n{conv.stdout}{conv.stderr}")
    log(f"phase 4 serve int8: {conv.stdout.strip()} in {time.perf_counter() - t0:.2f} s")
    for r in reqs:
        if r["path"] is not None:
            r["path"] = store / f"{r['path'].stem}.npz"
    attn = sum(r["attention"] for r in reqs)

    with Server(ckpt, store, workdir, ["--int8"]) as srv:
        before = _get(srv.base + "/stats")
        if before["int8_kernel_launches"] != 0 or before["kernel_launches"] != 0 or before["requests"] != 0:
            raise AssertionError(f"fresh server already counts work: {before}")
        if before["config"]["int8"] is not True:
            raise AssertionError(f"/stats does not show int8 mode: {before['config']}")
        results, wall = burst(srv.base, reqs)
        stats = _get(srv.base + "/stats")
        srv.stop()
    worst, near_ties = check_answers(model, reqs, results, plain_int8_reference, TOL_INT8_S)
    if stats["requests"] != len(reqs) or stats["int8_kernel_launches"] < max(1, stats["batches"]):
        raise AssertionError(f"int8 kernel launches {stats['int8_kernel_launches']} < batches {stats['batches']}: {stats}")
    if stats["kernel_launches"] != 0:
        raise AssertionError(f"the int8 server launched the float kernel: {stats}")
    # against the bf16 plain forward: the quantization budget
    vs_bf16, top1 = 0.0, 0
    for r, (out, _lat) in zip(reqs, results):
        p_ref = plain_bf16_reference(model, r).y_prob[0].cpu().numpy()
        vs_bf16 = max(vs_bf16, float(np.abs(np.asarray(out["y_prob"]) - p_ref).max()))
        top1 += out["y_hat"] == int(p_ref.argmax())
    if vs_bf16 > TOL_INT8_VS_BF16:
        raise AssertionError(f"int8 answers off the bf16 forward by {vs_bf16:.3e} > {TOL_INT8_VS_BF16}")
    lat = sorted(res[1] for res in results)
    log(f"phase 4 serve int8 (5 ms window): p50 latency by route (ms): {p50_by_route(reqs, results, ROUTES_INT8)} [{gpu}]")
    log(f"phase 4 serve int8 (5 ms window): {len(reqs)} concurrent requests ({', '.join(ROUTES_INT8)}; attention "
        f"on {attn}), {stats['batches']} batches, mean batch {stats['mean_batch_size']}, int8 kernel launches "
        f"{stats['int8_kernel_launches']}, max |y_prob - plain int8| {worst:.2e}, near-ties {near_ties}; "
        f"max |y_prob - plain bf16| {vs_bf16:.2e}, top-1 agreement with bf16 {top1}/{len(reqs)}; burst wall "
        f"{wall:.3f} s, dispatch thread in batch assembly {stats['assemble_s']:.3f} s, in device forwards "
        f"{stats['forward_s']:.3f} s [{gpu}]")
    return dict(launches=stats["int8_kernel_launches"], batches=stats["batches"], worst=worst,
                rps=len(reqs) / wall, p50=statistics.median(lat), wall=wall)


def seeded_vit(seed: int):
    """ViT-L/16 at full width and depth with random weights from the seed.
    The reference init (zero biases, LayerScale 1e-5) would hide the blocks
    behind the residual stream: LayerScale of order 0.1-1 and nonzero biases
    let every block, and so the attention kernel, move the features."""
    from toad_tpu_torch.models.vit_encoder import ViTConfig, ViTEncoder

    g = torch.Generator().manual_seed(seed)
    enc = ViTEncoder(ViTConfig(), generator=g)
    with torch.no_grad():
        for name, p in enc.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "gamma":
                p.copy_(0.1 + 0.9 * torch.rand(p.shape, generator=g))
            elif leaf == "bias" or name == "cls_token":
                p.copy_(torch.randn(p.shape, generator=g) * 0.05)
    return enc.eval()


def plain_attention_embed(enc, tiles: torch.Tensor) -> torch.Tensor:
    """``enc.embed`` with plain_mha standing in for fused_mha: the reference
    the kernel path is held against on the card."""
    from toad_tpu_torch.models import vit_encoder
    from toad_tpu_torch.ops.vit_attention import plain_mha

    fused = vit_encoder.fused_mha
    vit_encoder.fused_mha = plain_mha
    try:
        return enc.embed(tiles)
    finally:
        vit_encoder.fused_mha = fused


def run_featurize(workdir: Path, weights: Path, patch_dir: Path, feat_dir: Path, fmt: str) -> tuple[dict, float]:
    """``python -m toad_tpu_torch featurize --encoder vit`` as a user runs it,
    in a child process: (its last JSON line, wall seconds)."""
    env = child_env()
    cmd = [sys.executable, "-m", "toad_tpu_torch", "featurize", "--encoder", "vit", "--weights", str(weights),
           "--patch_dir", str(patch_dir), "--feat_dir", str(feat_dir), "--format", fmt, "--batch_size", "64"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=workdir, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"featurize failed ({run.returncode}):\n{run.stdout}{run.stderr}")
    for line in run.stdout.strip().splitlines()[:-1]:
        log(f"phase 5 featurize ({fmt}): {line}")
    return json.loads(run.stdout.strip().splitlines()[-1]), wall


def phase_featurize(seed: int, card: str, gpu: str, workdir: Path) -> dict:
    """The featurization path at ViT-L/16's full width and depth."""
    from toad_tpu_torch.data.bags import load_bag, load_bag_quantized
    from toad_tpu_torch.models import vit_encoder
    from toad_tpu_torch.ops import cuda_mha
    from toad_tpu_torch.pipeline.featurize import iter_tile_batches

    dev = torch.device("cuda")
    batch_size, depth = 64, 24
    t0 = time.perf_counter()
    enc = seeded_vit(seed)
    weights = workdir / "vit_l16.bin"
    torch.save(enc.state_dict(), weights)
    rng = np.random.default_rng(seed)
    slides = {}
    patch_dir, patch_dir8 = workdir / "patches", workdir / "patches_int8"
    patch_dir.mkdir()
    patch_dir8.mkdir()
    for name, n in (("slide_a", 136), ("slide_b", 200)):
        slides[name] = (rng.integers(0, 256, (n, 224, 224, 3), dtype=np.uint8),
                        rng.integers(0, 100_000, (n, 2), dtype=np.int64))
        np.savez(patch_dir / f"{name}.npz", imgs=slides[name][0], coords=slides[name][1])
    shutil.copyfile(patch_dir / "slide_b.npz", patch_dir8 / "slide_b.npz")
    n_batches = sum(-(-len(imgs) // batch_size) for imgs, _ in slides.values())
    log(f"phase 5 featurize: ViT-L/16 state_dict ({enc.param_count() / 1e6:.1f} M parameters, "
        f"{weights.stat().st_size / 1e6:.0f} MB) and {len(slides)} .npz patch files "
        f"({', '.join(f'{len(v[0])} tiles' for v in slides.values())}) written in {time.perf_counter() - t0:.1f} s")

    # main path: the CLI in a fresh process, whose launch count starts at 0
    said, wall = run_featurize(workdir, weights, patch_dir, workdir / "feats", "npz")
    want = {"slides": 2, "patches": sum(len(imgs) for imgs, _ in slides.values()), "shadowed_stale_bags": 0,
            "device": card, "batches": n_batches, "attention_kernel_launches": depth * n_batches}
    if {k: said.get(k) for k in want} != want or not said["patches_per_s"] > 0:
        raise AssertionError(f"featurize's last line {said} does not say {want}")

    # the same encoder on the card with plain_mha in place of the kernel
    enc = enc.to(dev)
    worst = 0.0
    for name, (imgs, coords) in slides.items():
        got, got_coords = load_bag(workdir / "feats" / f"{name}.npz", with_coords=True)
        if got.shape != (len(imgs), 1024) or got.dtype != np.float32 or not np.array_equal(got_coords, coords):
            raise AssertionError(f"{name}: bag {got.shape} {got.dtype} or its coords are not the slide's")
        ref = torch.cat([plain_attention_embed(enc, torch.from_numpy(chunk).to(dev))[:valid]
                         for chunk, valid in iter_tile_batches(imgs, batch_size)]).cpu()
        err = check_close(f"{name} features", torch.from_numpy(got), ref, TOL_FEATURES)
        mean_err = float((torch.from_numpy(got) - ref).abs().mean())
        if mean_err > TOL_FEATURES_MEAN:
            raise AssertionError(f"{name}: mean |features - plain-attention encoder| {mean_err:.3e} > {TOL_FEATURES_MEAN}")
        worst = max(worst, err)
        log(f"phase 5 featurize: {name} bag {got.shape}, coords equal, |features - plain-attention encoder| max "
            f"{err:.2e} mean {mean_err:.2e} (features' max |value| {float(ref.abs().max()):.2f}; tolerance "
            f"{TOL_FEATURES}, mean {TOL_FEATURES_MEAN})")

    # in process: the kernel's count over one slide, and the encoder's time per batch
    cuda_mha.LAUNCHES = 0
    imgs_b = slides["slide_b"][0]
    again = torch.cat([enc.embed(torch.from_numpy(chunk).to(dev))[:valid]
                       for chunk, valid in iter_tile_batches(imgs_b, batch_size)])
    torch.cuda.synchronize()
    if cuda_mha.LAUNCHES != depth * -(-len(imgs_b) // batch_size):
        raise AssertionError(f"in-process pass launched the attention kernel {cuda_mha.LAUNCHES} times")
    check_close("slide_b features, second pass", again.cpu(), torch.from_numpy(load_bag(workdir / "feats" / "slide_b.npz")),
                TOL_FEATURES)
    batch = torch.from_numpy(imgs_b[:batch_size]).to(dev)
    batch_ms = cuda_ms(lambda: enc.embed(batch))

    # the same weights computing in f32: kernel path (the FMA instance) against plain path on one batch
    enc32 = vit_encoder.ViTEncoder(dataclasses.replace(enc.config, compute_dtype="float32"), init=False)
    enc32.load_state_dict(enc.state_dict(), assign=True)
    enc32 = enc32.to(dev).eval()
    feats32 = enc32.embed(batch)
    err32 = check_close("f32 features", feats32, plain_attention_embed(enc32, batch), TOL_FEATURES_F32)
    log(f"phase 5 featurize: f32 compute, one batch of {batch_size}: max |kernel path - plain-attention path| "
        f"{err32:.2e} (tolerance {TOL_FEATURES_F32})")
    # the encoder's own bf16 noise, the yardstick of TOL_FEATURES: bf16 against f32, both through the kernel
    noise = (enc.embed(batch) - feats32).abs()
    check_close("bf16 features vs f32 features", enc.embed(batch), feats32, TOL_FEATURES)
    log(f"phase 5 featurize: bf16 compute against f32 compute on that batch (both through the kernel): "
        f"max {float(noise.max()):.2e} mean {float(noise.mean()):.2e}")
    del enc32, feats32

    # int8 bags for one slide
    said8, wall8 = run_featurize(workdir, weights, patch_dir8, workdir / "feats_int8", "int8")
    stored = load_bag_quantized(workdir / "feats_int8" / "slide_b.npz")
    if stored is None:
        raise AssertionError("--format int8 did not write an int8 bag")
    xq, scales, coords8 = stored
    f32 = load_bag(workdir / "feats" / "slide_b.npz")
    if xq.shape != (200, 1024) or xq.dtype != np.int8 or scales.shape != (200,) or not np.array_equal(coords8, slides["slide_b"][1]):
        raise AssertionError(f"int8 bag: {xq.shape} {xq.dtype}, scales {scales.shape}, or coords differ")
    # a row requantizes to within half a step of the features it was made from;
    # those are a second run's, equal to the first's up to TOL_FEATURES
    off = np.abs(xq.astype(np.float32) * scales[:, None] - f32) - 0.5 * scales[:, None]
    if said8["attention_kernel_launches"] != depth * 4 or off.max() > TOL_FEATURES["atol"]:
        raise AssertionError(f"int8 bag off its f32 features by {off.max():.3e} beyond half a step, or {said8}")
    log(f"phase 5 featurize: int8 bag {xq.shape} + scales {scales.shape} read back with load_bag_quantized, within "
        f"half a quantization step (+{max(off.max(), 0):.1e}) of the f32 bag; child process {wall8:.1f} s")
    log(f"phase 5 featurize: {said['patches']} tiles in {said['batches']} batches of {batch_size}, attention kernel "
        f"launches {said['attention_kernel_launches']} (= {depth} x batches), {said['patches_per_s']:.1f} tiles/s by the "
        f"CLI's own clock (first-call setup included), child process {wall:.1f} s; in process {batch_ms:.2f} ms per "
        f"batch = {batch_size / batch_ms * 1e3:.1f} tiles/s [{gpu}]")
    return dict(launches=said["attention_kernel_launches"], batches=said["batches"], worst=worst,
                cli_tiles_s=said["patches_per_s"], batch_ms=batch_ms, batch_size=batch_size, depth=depth)


def seeded_resnet(seed: int):
    """The truncated ResNet-50 at full width with random weights from the
    seed, unfolded, in torchvision's layout. The reference init (BN gamma 1,
    beta 0, mean 0, var 1) would make folding a no-op: random statistics and
    affine terms give every folded bias and scale something to do."""
    from toad_tpu_torch.config import EncoderConfig
    from toad_tpu_torch.models.resnet_encoder import ResNetEncoder

    g = torch.Generator().manual_seed(seed)
    enc = ResNetEncoder(EncoderConfig(), generator=g)
    with torch.no_grad():
        for name, t in [*enc.named_parameters(), *enc.named_buffers()]:
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif name.endswith("running_mean") or (name.endswith("bias") and t.dim() == 1):
                t.copy_(torch.randn(t.shape, generator=g) * 0.1)
            elif name.endswith("weight") and t.dim() == 1:  # BN scale
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
    return enc.eval()


def stage_input(enc, tiles: torch.Tensor) -> torch.Tensor:
    """The stem's output on uint8 tiles: layer1's input, NHWC."""
    dt = getattr(torch, enc.config.compute_dtype)
    w = enc._weights(dt)
    with torch.no_grad():
        return enc._stem(w, enc.preprocess(tiles).to(dt)).permute(0, 2, 3, 1)


def phase_compare_stage(enc, seed: int) -> tuple[float, float]:
    """KS against plain_stage on the card at full width, for layer1, layer2
    and layer3: B=64 at 256 px (maps 64, 32, 16) and B=3 at 224 px (56, 28,
    14: edge tiles masked), bf16 and f32 (TF32 off). Each stage takes the
    plain output of the one before; layer1 takes the stem's output on seeded
    tiles. Returns the largest (absolute, relative) error of bf16, the main
    path's dtype."""
    from toad_tpu_torch.ops import fused_stage as fs

    dev = next(enc.parameters()).device
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    worst_abs = worst_rel = 0.0
    for dt, tol in ((torch.bfloat16, TOL_STAGE_BF16), (torch.float32, TOL_STAGE_F32)):
        for b, px in ((64, 256), (3, 224)):
            x = stage_input(enc, torch.randint(0, 256, (b, px, px, 3), device=dev, dtype=torch.uint8, generator=g))
            x = x.to(dt)
            for (stage, stride), name in zip(enc.stages(), ("layer1", "layer2", "layer3")):
                with torch.inference_mode():
                    got = fs.fused_stage(stage, x, first_stride=stride, compute_dtype=dt)
                    want = fs.plain_stage(stage, x, stride, dt)
                torch.cuda.synchronize()
                scale = float(want.float().abs().max())
                err = check_close(f"stage {name} {str(dt)[6:]} B={b} {px} px", got, want, dict(atol=tol * scale, rtol=0.0))
                width = stage[0].conv1.weight.shape[0]
                log(f"phase 9 compare stage {name} {str(dt)[6:]} B={b} x {tuple(x.shape)} -> {tuple(got.shape)}: max abs "
                    f"err {err:.3e} = {err / scale:.2e} of the largest |output| {scale:.1f} (tolerance {tol:g} of it); "
                    f"tiles {fs.tile(dt, width, stride)} (first block) and {fs.tile(dt, width, 1)}, "
                    f"{fs.smem_bytes(dt, width, stride)} / {fs.smem_bytes(dt, width, 1)} B shared memory a block")
                if dt == torch.bfloat16:
                    worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
                x = want
    before = fs.LAUNCHES
    identity, downsample = fs.stage_weights(enc.layer1, torch.bfloat16)[1], fs.stage_weights(enc.layer2, torch.bfloat16)[0]
    # an identity skip at stride 2; a map whose side is not a multiple of the stride; a width of 96
    for ops, shape, stride in ((identity, (1, 48, 48, 256), 2), (downsample, (1, 7, 7, 256), 2),
                               (identity._replace(w1=torch.zeros(256, 96, device=dev, dtype=torch.bfloat16)),
                                (1, 8, 8, 256), 1)):
        try:
            fs.stage_block(ops, torch.zeros(shape, device=dev, dtype=torch.bfloat16), stride)
        except ValueError as e:
            log(f"phase 9 compare stage: unsupported shape raises: {e}")
        else:
            raise AssertionError(f"stage kernel took {shape} at stride {stride}")
    if fs.LAUNCHES != before:
        raise AssertionError("a refused shape counted as a launch")
    return worst_abs, worst_rel


def drive_fused_stage(enc, seed: int) -> dict:
    """The main path of KS, the probe's path: fused_stage over the folded
    encoder's layer1, layer2 and layer3 on the stem's output of a batch of 64
    seeded tiles of 256 px, bf16, as a caller uses it. The count is set to 0
    just before and read just after; the features pooled from its output are
    held against those of plain_stage and of the encoder's own cuDNN blocks."""
    from toad_tpu_torch.ops import fused_stage as fs

    dev = next(enc.parameters()).device
    g = torch.Generator(device=dev).manual_seed(seed + 10)
    x0 = stage_input(enc, torch.randint(0, 256, (64, 256, 256, 3), device=dev, dtype=torch.uint8, generator=g))
    fs.LAUNCHES = 0
    x = x0
    for stage, stride in enc.stages():
        x = fs.fused_stage(stage, x, first_stride=stride)
    torch.cuda.synchronize()
    launches = fs.LAUNCHES
    want = sum(len(stage) for stage, _ in enc.stages())
    if launches != want:
        raise AssertionError(f"fused_stage over three stages launched KS {launches} times, not {want}")
    feats = x.float().mean(dim=(1, 2))
    plain = x0
    cudnn = x0.permute(0, 3, 1, 2)
    with torch.inference_mode():
        for stage, stride in enc.stages():
            plain = fs.plain_stage(stage, plain, stride, torch.bfloat16)
            cudnn = enc.run_stage(stage, cudnn, stride)
    f_plain, f_cudnn = plain.float().mean(dim=(1, 2)), cudnn.float().mean(dim=(2, 3))
    scale = float(f_plain.abs().max())
    err = check_close("fused_stage features vs plain_stage", feats, f_plain, dict(atol=TOL_STAGE_BF16 * scale, rtol=0.0))
    # the encoder's blocks round each conv and its bias add to bf16 (the JAX encoder's points), the stage
    # keeps them in f32: a different rounding, so this is the bf16 noise between the two, not a tolerance
    noise = float((feats - f_cudnn).abs().max())
    log(f"phase 9 fused stages: {launches} KS launches over layer1-3 (B=64, 256 px, bf16); pooled features vs "
        f"plain_stage max abs err {err:.3e} ({err / scale:.2e} of the largest |feature| {scale:.1f}), vs the "
        f"encoder's cuDNN blocks {noise:.3e} ({noise / scale:.2e}; other rounding points)")
    if noise > 0.1 * scale:
        raise AssertionError(f"fused stages far from the encoder's own blocks: {noise:.3e} of {scale:.1f}")
    return dict(launches=launches, x0=x0)


def phase_timing_stage(enc, x0: torch.Tensor, gpu: str) -> dict:
    """KS, plain_stage and the encoder's cuDNN blocks for each stage and for
    the three together (bf16, B=64 at 256 px), each with its bound; then the
    encoder's time per batch of 64 split by stem, stages and pool, the stem
    with stem_s2d on and off."""
    from toad_tpu_torch.ops import fused_stage as fs

    dev = next(enc.parameters()).device
    dt = torch.bfloat16
    out = {}
    xs, total_ops, total_bytes = {}, 0, 0
    x = x0
    with torch.inference_mode():
        for (stage, stride), name in zip(enc.stages(), ("layer1", "layer2", "layer3")):
            xs[name] = x
            ops = fs.stage_weights(stage, dt)
            flops = moved = 0
            shape = tuple(x.shape)
            for i, o in enumerate(ops):
                s = stride if i == 0 else 1
                f, m = fs.block_work(o, shape, s)
                flops, moved = flops + f, moved + m
                shape = (shape[0], shape[1] // s, shape[2] // s, o.w3.shape[1])
            total_ops, total_bytes = total_ops + flops, total_bytes + moved
            xc = x.permute(0, 3, 1, 2)
            out[name] = time_pair(
                f"stage {name} bf16 B={x.shape[0]} {tuple(x.shape[1:])} ({len(ops)} blocks, one launch each)",
                lambda: fs.plain_stage(stage, x, stride, dt), lambda: fs.fused_stage(stage, x, first_stride=stride),
                dict(bytes=moved, ops=flops, kind="bf16"), gpu, library_fn=lambda: enc.run_stage(stage, xc, stride))
            x = fs.fused_stage(stage, x, first_stride=stride)

        def all_stages_cudnn():
            y = x0.permute(0, 3, 1, 2)  # the encoder's blocks keep NCHW (channels_last memory) from stage to stage
            for stage, stride in enc.stages():
                y = enc.run_stage(stage, y, stride)
            return y

        def all_stages(fn):
            def run():
                y = x0
                for stage, stride in enc.stages():
                    y = fn(stage, y, stride)
                return y
            return run

        out["all"] = time_pair(
            "stages layer1-3 bf16 B=64 at 256 px (13 launches)",
            all_stages(lambda st, y, s: fs.plain_stage(st, y, s, dt)),
            all_stages(lambda st, y, s: fs.fused_stage(st, y, first_stride=s)),
            dict(bytes=total_bytes, ops=total_ops, kind="bf16"), gpu, library_fn=all_stages_cudnn)

        # the encoder's batch, split
        tiles = torch.randint(0, 256, (64, 256, 256, 3), device=dev, dtype=torch.uint8)
        w = enc._weights(dt)
        xn = enc.preprocess(tiles).to(dt)
        t_pre = cuda_ms(lambda: enc.preprocess(tiles).to(dt))
        t_stem = cuda_ms(lambda: enc._stem(w, xn))
        enc.config = dataclasses.replace(enc.config, stem_s2d=False)
        t_stem_plain = cuda_ms(lambda: enc._stem(w, xn))
        enc.config = dataclasses.replace(enc.config, stem_s2d=True)
        t_stages = [cuda_ms(lambda: enc.run_stage(stage, xs[name].permute(0, 3, 1, 2), stride))
                    for (stage, stride), name in zip(enc.stages(), ("layer1", "layer2", "layer3"))]
        last = x.permute(0, 3, 1, 2)
        t_pool = cuda_ms(lambda: last.float().mean(dim=(2, 3)), inner=20)
        t_batch = cuda_ms(lambda: enc.embed(tiles))
    stem_flops = 2 * 64 * 128 * 128 * 7 * 7 * 3 * 64
    log(f"phase 9 timing encoder: ResNet-50 layer1-3 bf16, {t_batch:.3f} ms per batch of 64 tiles of 256 px "
        f"({64 / t_batch * 1e3:.1f} tiles/s): preprocess {t_pre:.3f} ms, stem + max-pool {t_stem:.3f} ms with "
        f"stem_s2d ({t_stem_plain:.3f} ms without; {stem_flops / 1e9:.1f} GFLOP), layer1 {t_stages[0]:.3f}, layer2 "
        f"{t_stages[1]:.3f}, layer3 {t_stages[2]:.3f} ms (cuDNN blocks), pool {t_pool:.3f} ms [{gpu}]")
    out["encoder"] = dict(batch=t_batch, pre=t_pre, stem=t_stem, stem_plain=t_stem_plain, stages=t_stages, pool=t_pool)
    return out


def phase_featurize_resnet(enc, seed: int, card: str, gpu: str, workdir: Path) -> dict:
    """Featurization with the default encoder: a seeded slide through
    tiling.tile_image (in process: the card's machine has no Pillow), a
    second slide of 200 seeded tiles, a seeded torchvision-layout state_dict,
    then ``python -m toad_tpu_torch featurize`` without ``--encoder`` as a
    child process."""
    from toad_tpu_torch.data.bags import load_bag
    from toad_tpu_torch.models.resnet_encoder import encoder_from_state_dict, load_torchvision_weights
    from toad_tpu_torch.pipeline.featurize import TileEmbedder
    from toad_tpu_torch.pipeline.tiling import tile_image

    dev = torch.device("cuda")
    batch_size = 64
    rng = np.random.default_rng(seed + 9)
    t0 = time.perf_counter()
    image = rng.integers(0, 256, (2048, 3072, 3), dtype=np.uint8)
    image[:1024, :1280] = rng.integers(236, 256, (1024, 1280, 1), dtype=np.uint8)  # near-white background
    imgs_a, coords_a = tile_image(image, patch_size=256)
    grid = (2048 // 256) * (3072 // 256)
    if not 0 < len(imgs_a) < grid:
        raise AssertionError(f"the tissue filter kept {len(imgs_a)} of {grid} tiles")
    slides = {"slide_a": (imgs_a, coords_a),
              "slide_b": (rng.integers(0, 256, (200, 256, 256, 3), dtype=np.uint8),
                          rng.integers(0, 100_000, (200, 2), dtype=np.int64))}
    patch_dir = workdir / "patches"
    patch_dir.mkdir()
    for name, (imgs, coords) in slides.items():
        np.savez(patch_dir / f"{name}.npz", imgs=imgs, coords=coords)
    sd = dict(seeded_resnet(seed).state_dict())
    sd.update({"fc.weight": torch.zeros(1000, 8), "fc.bias": torch.zeros(1000),
               "layer4.0.conv1.weight": torch.zeros(8, 8, 1, 1), "bn1.num_batches_tracked": torch.tensor(0)})
    weights = workdir / "resnet50.pth"
    torch.save({"state_dict": {f"module.{k}": v for k, v in sd.items()}}, weights)
    n_batches = sum(-(-len(v[0]) // batch_size) for v in slides.values())
    log(f"phase 9 featurize: tile_image kept {len(imgs_a)} of {grid} tiles of a 2048 x 3072 slide; 2 .npz patch "
        f"files ({len(imgs_a)} and 200 tiles of 256 px), a torchvision-layout state_dict ({weights.stat().st_size / 1e6:.0f} "
        f"MB, module./state_dict wrapped, with layer4/fc keys) written in {time.perf_counter() - t0:.1f} s")

    cmd = [sys.executable, "-m", "toad_tpu_torch", "featurize", "--weights", str(weights), "--patch_dir",
           str(patch_dir), "--feat_dir", str(workdir / "feats"), "--format", "npz", "--batch_size", str(batch_size)]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, env=child_env(), cwd=workdir, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"featurize failed ({run.returncode}):\n{run.stdout}{run.stderr}")
    for line in run.stdout.strip().splitlines()[:-1]:
        log(f"phase 9 featurize: {line}")
    said = json.loads(run.stdout.strip().splitlines()[-1])
    want = {"slides": 2, "patches": len(imgs_a) + 200, "shadowed_stale_bags": 0, "device": card, "batches": n_batches,
            "attention_kernel_launches": 0}
    if {k: said.get(k) for k in want} != want or not said["patches_per_s"] > 0:
        raise AssertionError(f"featurize's last line {said} does not say {want}")

    # the same weights in process on the card: bf16 features, and the encoder's own bf16 noise against f32
    loaded = load_torchvision_weights(weights, enc.config)
    embedder = TileEmbedder(encoder_from_state_dict(loaded, enc.config).to(dev).eval(), batch_size=batch_size)
    torch.backends.cudnn.allow_tf32 = False
    enc32 = encoder_from_state_dict(loaded, dataclasses.replace(enc.config, compute_dtype="float32")).to(dev)
    embedder32 = TileEmbedder(enc32, batch_size=batch_size)
    worst = 0.0
    for name, (imgs, coords) in slides.items():
        got, got_coords = load_bag(workdir / "feats" / f"{name}.npz", with_coords=True)
        if got.shape != (len(imgs), 1024) or got.dtype != np.float32 or not np.array_equal(got_coords, coords):
            raise AssertionError(f"{name}: bag {got.shape} {got.dtype} or its coords are not tile_image's")
        ref = embedder.embed_all(imgs)
        noise = np.abs(ref - embedder32.embed_all(imgs))
        err = np.abs(got - ref)
        if err.max() > noise.max() or err.mean() > noise.mean():
            raise AssertionError(f"{name}: |CLI - in process| max {err.max():.3e} mean {err.mean():.3e} beyond the "
                                 f"encoder's bf16 noise max {noise.max():.3e} mean {noise.mean():.3e}")
        worst = max(worst, float(err.max()))
        log(f"phase 9 featurize: {name} bag {got.shape}, coords equal to tile_image's, |CLI - same encoder in process| "
            f"max {err.max():.3e} mean {err.mean():.3e} (within the bf16 noise against f32 compute: max "
            f"{noise.max():.3e} mean {noise.mean():.3e}; features' max |value| {np.abs(ref).max():.2f})")

    # f32 on the card against the CPU on 8 tiles, TF32 off
    tiles8 = torch.from_numpy(slides["slide_b"][0][:8])
    on_card = enc32.embed(tiles8.to(dev)).cpu()
    on_cpu = enc32.cpu().embed(tiles8)
    scale = float(on_cpu.abs().max())
    err32 = check_close("f32 features card vs CPU", on_card, on_cpu, dict(atol=TOL_RESNET_F32 * scale, rtol=0.0))
    log(f"phase 9 featurize: f32 encoder on the card vs the CPU, 8 tiles: max abs err {err32:.3e} = "
        f"{err32 / scale:.2e} of the largest |feature| (tolerance {TOL_RESNET_F32:g} of it; TF32 off)")
    batch = torch.from_numpy(slides["slide_b"][0][:batch_size]).to(dev)
    batch_ms = cuda_ms(lambda: embedder.encoder.embed(batch))
    log(f"phase 9 featurize: {said['patches']} tiles in {said['batches']} batches of {batch_size}, "
        f"{said['patches_per_s']:.1f} tiles/s by the CLI's own clock (first-call setup included), child process "
        f"{wall:.1f} s; warm in process {batch_ms:.3f} ms per batch = {batch_size / batch_ms * 1e3:.1f} tiles/s [{gpu}]")
    del enc32, embedder, embedder32
    return dict(cli_tiles_s=said["patches_per_s"], batch_ms=batch_ms, worst=worst, wall=wall)


def phase_resnet(seed: int, card: str, gpu: str, workdir: Path, dev: torch.device = torch.device("cuda")) -> dict:
    """Phase 9: KS against plain_stage, its main path, timings, and
    featurization with the default encoder."""
    t0 = time.perf_counter()
    enc = seeded_resnet(seed).fold_bn().to(dev)
    worst_abs, worst_rel = phase_compare_stage(enc, seed)
    driven = drive_fused_stage(enc, seed)
    times = phase_timing_stage(enc, driven.pop("x0"), gpu)
    featurized = phase_featurize_resnet(enc, seed, card, gpu, workdir)
    torch.backends.cudnn.allow_tf32 = False
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return dict(launches=driven["launches"], worst=worst_abs, worst_rel=worst_rel, times=times, featurized=featurized)


def drive_bag_sharded(model, seed: int) -> dict:
    """The main path of K1p and the shard combine: ``bag_sharded_pool`` as a
    caller uses it (the params dict, bf16 compute) on one bag of 163,840
    rows in 4 shards. The kernels' counts are set to 0 just before and read
    just after."""
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool
    from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    n, n_shards = 163_840, 4
    x = torch.randn(1, n, 1024, device=dev, generator=g).bfloat16()
    mask = torch.zeros(1, n, device=dev)
    mask[0, :150_000] = 1.0
    with torch.inference_mode():
        cuda_pool.PARTIAL_LAUNCHES = cuda_pool.COMBINE_LAUNCHES = 0
        m = bag_sharded_pool(model.pool_params(), x, mask, n_shards, compute_dtype=torch.bfloat16)
        torch.cuda.synchronize()
        counts = dict(partial=cuda_pool.PARTIAL_LAUNCHES, combine=cuda_pool.COMBINE_LAUNCHES)
        ref, _ = plain_pool(model.pool_params(), x, mask, torch.bfloat16, with_scores=False)
    err = check_close("bag_sharded_pool (main path) vs plain_pool", m, ref, TOL_BF16_M)
    if counts != dict(partial=n_shards, combine=1):
        raise AssertionError(f"bag_sharded_pool in {n_shards} shards launched {counts}")
    log(f"phase 3 bag_sharded_pool main path: B=1 N={n} bf16 in {n_shards} shards: partial-mode launches "
        f"{counts['partial']}, combine launches {counts['combine']}, max abs err vs plain_pool {err:.2e} "
        f"(tolerance {TOL_BF16_M})")
    return counts


def run_train(workdir: Path, exp_code: str, extra: list[str], timeout: int = 900) -> tuple[list[str], float]:
    """``python -m toad_tpu_torch train`` as a user runs it, in a child
    process: (its output lines, wall seconds)."""
    cmd = [sys.executable, "-m", "toad_tpu_torch", "train", "--task", str(workdir / "tasks" / "dummy_mtl_concat.json"),
           "--data_root_dir", str(workdir / "bags"), "--split_dir", str(workdir / "splits" / "dummy_mtl_concat_100"),
           "--results_dir", str(workdir / "results"), "--exp_code", exp_code, "--k", "1", "--batch_size", "4", *extra]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, env=child_env(), cwd=workdir, timeout=timeout)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"train failed ({run.returncode}):\n{run.stdout[-4000:]}{run.stderr[-4000:]}")
    return run.stdout.splitlines(), wall


def check_train_run(label: str, lines: list[str], results: Path, card: str, gpu: str, model_cfg, test_split,
                    wall: float) -> dict:
    """One training run's log and artefacts; its checkpoint reloaded on the
    card must reproduce the trainer's own test error and AUC."""
    import csv as csv_mod
    import pickle
    import re

    from toad_tpu_torch.data.batching import BagBatcher, resolve_transfer_dtype
    from toad_tpu_torch.evaluate.runner import make_eval_step, run_eval_pass
    from toad_tpu_torch.models.toad_mil import ToadMIL
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.train.checkpoint import load_params_any

    train_losses = [float(m.group(1)) for ln in lines if (m := re.search(r"epoch \d+: train cls_loss (\S+) ", ln))]
    val_losses = [float(m.group(1)) for ln in lines if (m := re.search(r"epoch \d+: val cls_loss (\S+) ", ln))]
    rates = [(float(m.group(1)), m.group(2)) for ln in lines if (m := re.search(r"\| (\S+) slides/s \(data wait (\S+)\)", ln))]
    if not train_losses or len(train_losses) != len(val_losses) or not all(np.isfinite(train_losses + val_losses)):
        raise AssertionError(f"{label}: losses missing or not finite: train {train_losses} val {val_losses}")
    if len(train_losses) > 1 and not train_losses[-1] < train_losses[0]:
        raise AssertionError(f"{label}: train loss did not fall: {train_losses}")
    if not any(card in ln for ln in lines if "model params" in ln):
        raise AssertionError(f"{label}: the trainer does not name the card {card}")
    for name in ("s_0_checkpoint.pt", "splits_0.csv", "split_0_results.pkl", "summary.csv"):
        if not (results / name).exists():
            raise AssertionError(f"{label}: {results / name} missing")
    counts = next((re.search(r"eval batches (\d+), pooling kernel launches (\d+)", ln) for ln in lines
                   if "pooling kernel launches" in ln), None)
    if counts is None:
        raise AssertionError(f"{label}: the trainer reported no kernel launches")
    eval_batches, launches = int(counts.group(1)), int(counts.group(2))
    if eval_batches < 1 or launches != eval_batches:
        raise AssertionError(f"{label}: pooling kernel launches {launches} != eval batches {eval_batches}")
    with open(results / "summary.csv", newline="") as f:
        summary = list(csv_mod.DictReader(f))
    if len(summary) != 1 or list(summary[0])[:3] != ["", "folds", "cls_test_auc"]:
        raise AssertionError(f"{label}: summary.csv columns {list(summary[0]) if summary else summary}")
    with open(results / "split_0_results.pkl", "rb") as f:
        per_slide = pickle.load(f)
    if len(per_slide) != len(test_split):
        raise AssertionError(f"{label}: split_0_results.pkl holds {len(per_slide)} slides, the test split {len(test_split)}")

    # the checkpoint, reloaded into a fresh model on the card, over the test split
    model = ToadMIL(model_cfg)
    model.load_state_dict(load_params_any(results / "s_0_checkpoint.pt", model_cfg))
    model = model.cuda().eval()
    batcher = BagBatcher(test_split, batch_size=4, mode="sequential",
                         transfer_dtype=resolve_transfer_dtype("auto", model_cfg.compute_dtype), device="cuda")
    before = cuda_pool.LAUNCHES
    test = run_eval_pass(make_eval_step(model), batcher, model_cfg.n_classes, "cuda")
    if cuda_pool.LAUNCHES - before != test["n_batches"]:
        raise AssertionError(f"{label}: reloaded eval pass launched the kernel {cuda_pool.LAUNCHES - before} times "
                             f"for {test['n_batches']} batches")
    acc, auc = float(summary[0]["cls_test_acc"]), float(summary[0]["cls_test_auc"])
    # the same kernel on the same bags: equal up to the one argmax a near-tie could flip
    if abs((1.0 - test["cls_error"]) - acc) > 1e-6 or abs(test["cls_auc"] - auc) > 1e-4:
        raise AssertionError(f"{label}: reloaded checkpoint gives test acc {1.0 - test['cls_error']:.6f} auc "
                             f"{test['cls_auc']:.6f}, summary.csv says {acc:.6f} / {auc:.6f}")
    log(f"phase 7 train ({label}): {len(train_losses)} epochs, train cls_loss {train_losses[0]:.4f} -> "
        f"{train_losses[-1]:.4f}, val cls_loss {val_losses[0]:.4f} -> {val_losses[-1]:.4f}; eval batches {eval_batches} "
        f"= pooling kernel launches {launches}; s_0_checkpoint.pt reloaded with load_params_any reproduces test acc "
        f"{acc:.4f} and auc {auc:.4f} (|d auc| {abs(test['cls_auc'] - auc):.1e}); slides/s and data-wait share per epoch: "
        f"{', '.join(f'{r:.1f} ({w})' for r, w in rates)}; child process {wall:.1f} s [{gpu}]")
    return dict(launches=launches, eval_batches=eval_batches, rates=rates, wall=wall)


def check_step_against_cpu(dataset_split, model_cfg, seed: int) -> None:
    """One train step (forward, backward, Adam) on the card against the same
    step on the CPU from the same weights and batch: f32, dropout off, TF32
    off (torch.backends.cuda.matmul.allow_tf32 = False, PyTorch's default)."""
    from toad_tpu_torch.config import OptimConfig
    from toad_tpu_torch.data.batching import BagBatcher
    from toad_tpu_torch.evaluate.runner import batch_to_dict
    from toad_tpu_torch.models.toad_mil import ToadMIL
    from toad_tpu_torch.train.loop import make_loss_fn, make_train_step, unpack_metrics
    from toad_tpu_torch.train.optim import make_optimizer

    torch.backends.cuda.matmul.allow_tf32 = False
    batch = next(iter(BagBatcher(dataset_split, batch_size=4, mode="sequential", prefetch=0, max_bag_size=8192)))
    sides = {}
    for dev in ("cpu", "cuda"):
        model = ToadMIL(model_cfg, generator=torch.Generator().manual_seed(seed)).to(dev).train()
        bd = batch_to_dict(batch, dev)
        loss, _ = make_loss_fn(model, 0.75, 0.25)(bd, None)
        loss.backward()
        grads = {k: p.grad.detach().cpu().clone() for k, p in model.named_parameters()}
        opt = make_optimizer(OptimConfig(), model.parameters())
        stepped = unpack_metrics(make_train_step(model, opt, 0.75, 0.25)(bd, None))
        sides[dev] = (float(loss.detach()), grads, stepped["loss"], {k: v.detach().cpu() for k, v in model.state_dict().items()})
    (l_c, g_c, s_c, w_c), (l_g, g_g, s_g, w_g) = sides["cpu"], sides["cuda"]
    # each gradient's error relative to its largest entry; attn.c.bias has no gradient but rounding noise (a
    # softmax does not feel a shift of its scores), so a gradient's scale is floored at 1e-4 of the largest of all
    floor = 1e-4 * max(float(g.abs().max()) for g in g_c.values())
    worst, worst_name = max((float((g_g[k] - g_c[k]).abs().max() / g_c[k].abs().max().clamp_min(floor)), k) for k in g_c)
    moved = max(float((w_g[k] - w_c[k]).abs().max()) for k in w_c)
    if abs(l_g - l_c) > 1e-4 or abs(s_g - s_c) > 1e-4 or worst > 1e-3 or not all(torch.isfinite(g).all() for g in g_g.values()):
        raise AssertionError(f"train step on the card vs the CPU: loss {l_g} vs {l_c}, worst relative gradient error {worst:.3e} ({worst_name})")
    log(f"phase 7 train step, card vs CPU (f32, dropout off, TF32 off, B=4 x {batch.bucket} x 1024): |loss difference| "
        f"{abs(l_g - l_c):.2e} (tolerance 1e-4), largest gradient error relative to the gradient's largest entry "
        f"{worst:.2e} ({worst_name}; tolerance 1e-3), parameters after one Adam step differ by at most {moved:.2e}")


def phase_train(seed: int, card: str, gpu: str, workdir: Path) -> dict:
    """The training path at TOAD's full width: a seeded synthetic dataset,
    one fold, ``python -m toad_tpu_torch train`` in a child process (f32 with
    early stopping and resume, then a shorter bf16 run with dropout)."""
    import dataclasses as dc

    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.data.splits import generate_splits, save_split_columnar, split_file
    from toad_tpu_torch.data.synthetic import dummy_task, write_dummy_bags, write_dummy_csv
    from toad_tpu_torch.data.wsi_dataset import WSIBagDataset

    t0 = time.perf_counter()
    csv_path = workdir / "dataset_csv" / "dummy_dataset.csv"
    for manifest_seed in range(seed, seed + 1000):  # the first seed whose manifest has 3 slides of every origin
        manifest = write_dummy_csv(csv_path, n_patients=36, max_slides_per_patient=3, seed=manifest_seed)
        per_class = np.unique([r["label"] for r in manifest], return_counts=True)[1]
        if len(per_class) == 18 and per_class.min() >= 3:
            break
    else:
        raise AssertionError("no manifest with 3 slides of every origin")
    task = dummy_task(str(csv_path))
    (workdir / "tasks").mkdir()
    (workdir / "tasks" / "dummy_mtl_concat.json").write_text(task.to_json())
    write_dummy_bags(workdir / "bags", manifest, task, n_patches_range=(2000, 30000), dim=1024, fmt="npy", seed=seed)
    ds = WSIBagDataset(task, data_dir=str(workdir / "bags"))
    counts = np.array([len(c) for c in ds.slide_cls_ids])
    spec = next(generate_splits(ds.slide_cls_ids, np.maximum(counts // 4, 1), np.maximum(counts // 4, 1), ds.n_slides,
                                n_splits=1, seed=seed + 1))
    spec.validate_disjoint()
    split_dir = workdir / "splits" / "dummy_mtl_concat_100"
    split_dir.mkdir(parents=True)
    save_split_columnar({k: list(ds.slide_ids[getattr(spec, k)]) for k in ("train", "val", "test")},
                        split_file(split_dir, 0))
    train_split, _, test_split = ds.return_splits_from_csv(split_file(split_dir, 0))
    n_bytes = sum(f.stat().st_size for f in (workdir / "bags").iterdir())
    log(f"phase 7 train: {ds.n_slides} slides of 2,000-30,000 patches x 1024 ({n_bytes / 1e9:.2f} GB of .npy bags, "
        f"18 origins with at least {per_class.min()} slides each; manifest seed {manifest_seed}), one fold: train "
        f"{len(spec.train)} / val {len(spec.val)} / test {len(spec.test)}; written in {time.perf_counter() - t0:.1f} s")

    cfg32 = ModelConfig(in_dim=1024, n_classes=18)
    lines, wall = run_train(workdir, "smoke_f32", ["--max_epochs", "3", "--early_stopping", "--resume"])
    main_run = check_train_run("f32, early stopping, resume", lines, workdir / "results" / "smoke_f32_s1", card, gpu,
                               cfg32, test_split, wall)
    lines, wall = run_train(workdir, "smoke_bf16", ["--max_epochs", "1", "--bf16", "--drop_out"])
    check_train_run("bf16, dropout", lines, workdir / "results" / "smoke_bf16_s1", card, gpu,
                    dc.replace(cfg32, compute_dtype="bfloat16", dropout=True), test_split, wall)
    check_step_against_cpu(train_split, cfg32, seed)
    return dict(main_run, dataset=ds, test_split=test_split, model_cfg=cfg32)


EVAL_COLUMNS = ["slide_id", "sex", "Y", "Y_hat", "site", "site_hat", *[f"p_{c}" for c in range(18)], "site_p"]
TOL_EVAL_INT8_VS_F32 = 0.02  # eval --int8 probabilities vs eval in f32: the quantization budget of tests/test_int8.py
TOL_EVAL_WIRE_VS_DEVICE = 1e-6  # rows quantized in the producer thread vs on the card: the quantizers are exact twins
TOL_EVAL_CARD_VS_CPU = 1e-4  # evaluate_split on the card (K1, f32) vs on the CPU (plain version, f32): summation order


def read_csv_rows(path: Path) -> list[dict]:
    import csv as csv_mod

    with open(path, newline="") as f:
        return list(csv_mod.DictReader(f))


def run_eval(workdir: Path, models: str, save_code: str, extra: list[str], timeout: int = 600) -> dict:
    """``python -m toad_tpu_torch eval`` as a user runs it, in a child process
    in ``workdir``. Returns what its own lines report (batches, launches by
    kernel, each pass's bags, seconds, slides/s, data-wait share, wire and
    bytes; peak device memory) and its output directory."""
    import re

    cmd = [sys.executable, "-m", "toad_tpu_torch", "eval", "--task", str(workdir / "tasks" / "dummy_mtl_concat.json"),
           "--data_root_dir", str(workdir / "bags"), "--results_dir", str(workdir / "results"), "--models_exp_code", models,
           "--save_exp_code", save_code, "--k", "1", "--batch_size", "4", *extra]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, env=child_env(), cwd=workdir, timeout=timeout)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"eval {extra} failed ({run.returncode}):\n{run.stdout[-4000:]}{run.stderr[-4000:]}")
    counts = re.search(r"\[fold 0\] eval batches (\d+), pooling kernel launches (\d+) \(float kernel (\d+), int8 kernel (\d+)\), "
                       r"peak device memory (\S+) GB on (.+)", run.stdout)
    passes = [dict(what=m.group(1), bags=int(m.group(2)), seconds=float(m.group(3)), rate=float(m.group(4)),
                   wait=m.group(5), wire=m.group(6), bytes=int(m.group(7)))
              for m in re.finditer(r"\[fold 0\] (\w+) pass: (\d+) bags in (\S+) s, (\S+) slides/s \(data wait (\S+)\), "
                                   r"wire (\w+), (\d+) bytes to the device", run.stdout)]
    if counts is None or not passes:
        raise AssertionError(f"eval {extra}: no batch, launch or pass line in its output:\n{run.stdout[-3000:]}")
    return dict(batches=int(counts.group(1)), launches=int(counts.group(2)), k1=int(counts.group(3)), k2=int(counts.group(4)),
                peak_gb=float(counts.group(5)), card=counts.group(6).strip(), passes=passes, wall=wall,
                out=workdir / "eval_results" / f"EVAL_{save_code}", stdout=run.stdout)


def check_eval_run(label: str, ev: dict, kernel: str, trainer_summary: Path | None, test_ids: list[str], card: str, gpu: str) -> np.ndarray:
    """One ``eval`` run on the test split: schema and order of fold_0.csv,
    launches of the right kernel = eval batches, and (given the trainer's
    summary.csv) the trainer's own test accuracy and AUC. Returns the
    probabilities [N, 19] (classes, then site_p)."""
    rows = read_csv_rows(ev["out"] / "fold_0.csv")
    if list(rows[0]) != EVAL_COLUMNS or [r["slide_id"] for r in rows] != test_ids:
        raise AssertionError(f"eval ({label}): fold_0.csv columns {list(rows[0])} or slide order differ from the test split's")
    probs = np.array([[float(r[c]) for c in EVAL_COLUMNS[6:]] for r in rows])
    if not np.isfinite(probs).all() or np.abs(probs[:, :18].sum(1) - 1.0).max() > 1e-4:
        raise AssertionError(f"eval ({label}): probabilities not finite or not summing to 1")
    want = dict(k1=ev["batches"], k2=0) if kernel == "float" else dict(k1=0, k2=ev["batches"])
    if ev["batches"] < 1 or dict(k1=ev["k1"], k2=ev["k2"]) != want or ev["card"] != card:
        raise AssertionError(f"eval ({label}): {ev['batches']} eval batches but float kernel launches {ev['k1']}, int8 kernel "
                             f"launches {ev['k2']} on {ev['card']}")
    summary = read_csv_rows(ev["out"] / "summary.csv")
    if len(summary) != 1 or list(summary[0])[:3] != ["", "folds", "cls_test_auc"]:
        raise AssertionError(f"eval ({label}): summary.csv columns {list(summary[0]) if summary else summary}")
    agree = ""
    if trainer_summary is not None:
        trained = read_csv_rows(trainer_summary)[0]
        d_acc = abs(float(summary[0]["cls_test_acc"]) - float(trained["cls_test_acc"]))
        d_auc = abs(float(summary[0]["cls_test_auc"]) - float(trained["cls_test_auc"]))
        if d_acc > 1e-6 or d_auc > 1e-4:
            raise AssertionError(f"eval ({label}): test acc {summary[0]['cls_test_acc']} auc {summary[0]['cls_test_auc']}, the "
                                 f"trainer's summary.csv says {trained['cls_test_acc']} / {trained['cls_test_auc']}")
        agree = (f"summary.csv reproduces the trainer's test acc {float(trained['cls_test_acc']):.4f} (|d| {d_acc:.1e}) and auc "
                 f"{float(trained['cls_test_auc']):.4f} (|d| {d_auc:.1e}); ")
    p = ev["passes"][0]
    log(f"phase 8 eval ({label}): fold_0.csv holds the test split's {len(rows)} slides in split order; {agree}eval batches "
        f"{ev['batches']} = {kernel} pooling kernel launches {ev['launches']}; {p['rate']:.1f} slides/s (data wait {p['wait']}) by the "
        f"CLI's clock, wire {p['wire']}, {p['bytes']} bytes to the card, peak device memory {ev['peak_gb']:.2f} GB; child process "
        f"{ev['wall']:.1f} s [{gpu}]")
    return probs


def phase_eval(trained: dict, card: str, gpu: str, workdir: Path) -> dict:
    """The evaluation path at TOAD's full width on phase 7's dataset, fold and
    results dirs: ``eval`` in f32, bf16 and int8 as child processes, one run
    with calibration and bootstrap intervals, ``report``, and the engine on
    the card against the engine on the CPU."""
    import math

    from toad_tpu_torch.evaluate.engine import evaluate_checkpoint

    test_split = trained["test_split"]
    test_ids = [str(s) for s in test_split.slide_ids]
    results = workdir / "results"

    ev32 = run_eval(workdir, "smoke_f32_s1", "f32", [])
    p32 = check_eval_run("f32", ev32, "float", results / "smoke_f32_s1" / "summary.csv", test_ids, card, gpu)
    ev16 = run_eval(workdir, "smoke_bf16_s1", "bf16", ["--bf16", "--drop_out"])
    check_eval_run("bf16, dropout layout", ev16, "float", results / "smoke_bf16_s1" / "summary.csv", test_ids, card, gpu)
    ev8 = run_eval(workdir, "smoke_f32_s1", "int8", ["--int8"])
    p8 = check_eval_run("int8, int8 wire", ev8, "int8", None, test_ids, card, gpu)
    ev8d = run_eval(workdir, "smoke_f32_s1", "int8_dev", ["--int8", "--transfer_dtype", "float32"])
    p8d = check_eval_run("int8, float32 wire, rows quantized on the card", ev8d, "int8", None, test_ids, card, gpu)
    wires = {k: e["passes"][0]["wire"] for k, e in (("f32", ev32), ("bf16", ev16), ("int8", ev8), ("int8_dev", ev8d))}
    if wires != dict(f32="float32", bf16="bfloat16", int8="int8", int8_dev="float32"):
        raise AssertionError(f"eval: the batcher's wires were {wires}")
    d_q, d_w = float(np.abs(p8 - p32).max()), float(np.abs(p8d - p8).max())
    if d_q > TOL_EVAL_INT8_VS_F32 or d_w > TOL_EVAL_WIRE_VS_DEVICE:
        raise AssertionError(f"eval --int8: probabilities differ from the f32 run's by {d_q:.3e} (tolerance {TOL_EVAL_INT8_VS_F32}), "
                             f"int8 wire vs quantization on the card by {d_w:.3e} (tolerance {TOL_EVAL_WIRE_VS_DEVICE})")
    b32, b16, b8 = (e["passes"][0]["bytes"] for e in (ev32, ev16, ev8))
    log(f"phase 8 eval --int8: every probability within {d_q:.2e} of the f32 run's (tolerance {TOL_EVAL_INT8_VS_F32}); rows "
        f"quantized in the producer thread vs on the card differ by {d_w:.1e} (tolerance {TOL_EVAL_WIRE_VS_DEVICE}: the quantizers "
        f"are exact twins); bytes to the card f32 {b32}, bf16 {b16} ({b32 / b16:.2f}x fewer), int8 {b8} ({b32 / b8:.2f}x fewer); peak "
        f"device memory with rows quantized on the card {ev8d['peak_gb']:.2f} GB against {ev8['peak_gb']:.2f} GB on the int8 wire [{gpu}]")

    # once with everything around the pass: the whole dataset, a temperature from the val split, bootstrap intervals
    ev_all = run_eval(workdir, "smoke_f32_s1", "all", ["--split", "all", "--calibrate", "--bootstrap", "200"])
    if ev_all["k1"] != ev_all["batches"] or [p["what"] for p in ev_all["passes"]] != ["eval", "val"]:
        raise AssertionError(f"eval --split all --calibrate: {ev_all['batches']} batches, {ev_all['k1']} launches, passes {ev_all['passes']}")
    out = ev_all["out"]
    n_all = len(read_csv_rows(out / "fold_0.csv"))
    confusion = read_csv_rows(out / "fold_0_confusion.csv")
    n_conf = sum(int(v) for r in confusion for k, v in r.items() if k != "")
    calib = json.loads((out / "fold_0_calibration.json").read_text())
    cis = json.loads((out / "fold_0_ci.json").read_text())
    summary = read_csv_rows(out / "summary.csv")[0]
    if n_all != trained["dataset"].n_slides or len(confusion) != 18 or n_conf != n_all:
        raise AssertionError(f"eval --split all: {n_all} slides scored, the confusion matrix counts {n_conf} in {len(confusion)} rows")
    t = calib["temperature"]
    if not (math.isfinite(t) and t > 0 and all(math.isfinite(calib[k]) for k in ("ece_before", "ece_after", "nll_before", "nll_after"))):
        raise AssertionError(f"eval --calibrate: {calib}")
    points = {"cls_auc": "cls_test_auc", "cls_acc": "cls_test_acc", "cls_top3_acc": "cls_top3_acc", "site_auc": "site_test_auc"}
    for name, col in points.items():
        lo, hi, point = cis[name]["lo"], cis[name]["hi"], float(summary[col])
        if not (lo <= point <= hi) or float(summary[f"{name}_ci_lo"]) != lo or float(summary[f"{name}_ci_hi"]) != hi:
            raise AssertionError(f"eval --bootstrap: {name} interval [{lo}, {hi}] does not bracket {point} or is not in summary.csv")
    rep = subprocess.run([sys.executable, "-m", "toad_tpu_torch", "report", "--dir", str(out)], capture_output=True, text=True,
                         env=child_env(), cwd=workdir, timeout=300)
    if rep.returncode != 0:
        raise AssertionError(f"report failed ({rep.returncode}):\n{rep.stdout[-2000:]}{rep.stderr[-2000:]}")
    flat = json.loads(rep.stdout.strip().splitlines()[-1])
    if flat["n_folds"] != 1 or any(abs(flat[f"{col}_mean"] - float(summary[col])) > 1e-12 for col in points.values()) \
            or abs(flat["calibration_temperature_mean"] - t) > 1e-12:
        raise AssertionError(f"report: {flat} against summary.csv {summary}")
    pa, pv = ev_all["passes"]
    log(f"phase 8 eval --split all --calibrate --bootstrap 200: {n_all} slides, {ev_all['batches']} batches = pooling kernel launches "
        f"{ev_all['k1']}; temperature {t:.3f} (ece {calib['ece_before']:.4f} -> {calib['ece_after']:.4f}); intervals bracket their "
        f"points (cls auc {float(summary['cls_test_auc']):.4f} in [{cis['cls_auc']['lo']:.4f}, {cis['cls_auc']['hi']:.4f}]); report: "
        f"n_folds 1 and the summary's means; eval pass {pa['rate']:.1f} slides/s (data wait {pa['wait']}), val pass {pv['rate']:.1f} "
        f"slides/s (data wait {pv['wait']}); child process {ev_all['wall']:.1f} s [{gpu}]")

    # in process: the engine on the card against the engine on the CPU, the same checkpoint and bags (cut to 8,192 rows)
    kw = dict(batch_size=4, max_bag_size=8192)
    ckpt = results / "smoke_f32_s1" / "s_0_checkpoint.pt"
    def pinned_bytes() -> int | None:
        """Pinned host memory PyTorch holds (rings in use and blocks cached for reuse), where it reports it."""
        stats = torch.cuda.host_memory_stats() if hasattr(torch.cuda, "host_memory_stats") else {}
        return stats.get("allocated_bytes.current")

    on_card = evaluate_checkpoint(ckpt, test_split, trained["model_cfg"], **kw)
    pinned_first = pinned_bytes()
    # a second pass builds a second batcher and a second pinned ring (as eval --calibrate does): the first
    # ring's slots must have been given back, so that the process holds no more pinned memory than before
    again = evaluate_checkpoint(ckpt, test_split, trained["model_cfg"], **kw)
    pinned_second = pinned_bytes()
    d_again = float(np.abs(again.probs() - on_card.probs()).max())
    if d_again > TOL_EVAL_WIRE_VS_DEVICE or (pinned_first is not None and pinned_second > pinned_first):
        raise AssertionError(f"a second eval pass in one process: probabilities differ by {d_again:.3e}, "
                             f"pinned host memory {pinned_first} -> {pinned_second} bytes")
    leftover = [t.name for t in threading.enumerate() if t.name == "bag-prefetch"]
    if leftover:
        raise AssertionError(f"producer threads left after the eval passes: {leftover}")
    on_cpu = evaluate_checkpoint(ckpt, test_split, trained["model_cfg"], device="cpu", **kw)
    d_cpu = max(float(np.abs(on_card.probs() - on_cpu.probs()).max()), float(np.abs(on_card.df["site_p"] - on_cpu.df["site_p"]).max()))
    if d_cpu > TOL_EVAL_CARD_VS_CPU or list(on_card.df["slide_id"]) != list(on_cpu.df["slide_id"]):
        raise AssertionError(f"evaluate_split on the card vs the CPU: probabilities differ by {d_cpu:.3e} (tolerance {TOL_EVAL_CARD_VS_CPU})")
    log(f"phase 8 evaluate_split, card vs CPU (f32, {len(test_ids)} bags cut to 8,192 rows, batch 4): probabilities differ by at most "
        f"{d_cpu:.2e} (tolerance {TOL_EVAL_CARD_VS_CPU}); cls auc {on_card.cls_auc:.4f} vs {on_cpu.cls_auc:.4f}; a second pass on "
        f"the card gives the same probabilities (|d| {d_again:.1e}) and leaves pinned host memory at {pinned_first} -> {pinned_second} bytes (the first "
        f"ring's slots are reused), no producer thread left")
    runs = dict(f32=ev32, bf16=ev16, int8=ev8, int8_dev=ev8d, all=ev_all)
    return dict(k1_launches=ev32["k1"] + ev16["k1"] + ev_all["k1"], k2_launches=ev8["k2"] + ev8d["k2"], runs=runs)


def phase_timing_train(gpu: str, seed: int) -> dict:
    """K1p and the combine against their plain versions, the sharded pool
    against K1 in one launch, and the train step (forward + backward + Adam)."""
    from toad_tpu_torch.config import ModelConfig, OptimConfig
    from toad_tpu_torch.models.toad_mil import ToadMIL
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool, plain_pool_partial
    from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool, plain_combine_partial_pool
    from toad_tpu_torch.train.loop import make_train_step
    from toad_tpu_torch.train.optim import make_optimizer

    dev = torch.device("cuda")
    out = {}
    model = seeded_model(seed).cuda().eval()
    n, n_shards = 163_840, 4
    per = n // n_shards
    mask = torch.ones(1, n, device=dev)
    with torch.inference_mode():
        for dt, kind in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
            x = torch.randn(1, n, 1024, device=dev).to(dt)
            ops, params = model.kernel_operands(dt), cast_params(model.pool_params(), dt)
            xs, ms = x[:, :per], mask[:, :per]
            out[("partial_" + kind, 1)] = time_pair(
                f"partial pool {kind} B=1 N={per} D=1024 (one shard of {n_shards})",
                lambda: plain_pool_partial(params, xs, ms, dt), lambda: cuda_pool.pool_partial(ops, xs, ms),
                dict(bytes=nbytes(xs, ms, *ops) + (2 * 512 + 4) * 4, ops=cuda_pool.flops_per_row(1024, 512, 384) * per,
                     kind=kind), gpu)
            # the whole sharded pool (4 partial launches + the combine) against K1 in one launch on the same bag
            t_plain = cuda_ms(lambda: plain_pool(params, x, mask, dt, False))
            t_whole = cuda_ms(lambda: cuda_pool.pool(ops, x, mask, False))
            t_shard = cuda_ms(lambda: bag_sharded_pool(ops, x, mask, n_shards))
            t_shard8 = cuda_ms(lambda: bag_sharded_pool(ops, x, mask, 8))
            t_whole2 = cuda_ms(lambda: cuda_pool.pool(ops, x, mask, False))
            log(f"phase 6 timing bag_sharded_pool {kind} B=1 N={n}: {n_shards} shards {t_shard:.3f} ms, 8 shards "
                f"{t_shard8:.3f} ms, K1 in one launch {min(t_whole, t_whole2):.3f} ms ({t_whole:.3f}/{t_whole2:.3f}), "
                f"plain_pool {t_plain:.3f} ms [{gpu}]")
            out[("sharded_" + kind, 1)] = dict(shards4=t_shard, shards8=t_shard8, whole=min(t_whole, t_whole2), plain=t_plain)
            del x
        acc = torch.randn(n_shards, 1, 2, 512, device=dev)
        stats = torch.stack([torch.randn(n_shards, 1, 2, device=dev), torch.rand(n_shards, 1, 2, device=dev) + 1.0], dim=2)
        out[("combine", 1)] = time_pair(
            f"shard combine S={n_shards} B=1 H=512", lambda: plain_combine_partial_pool(acc, stats),
            lambda: cuda_pool.combine_shards(acc, stats),
            dict(bytes=nbytes(acc, stats) + 2 * 512 * 4, ops=3 * n_shards * 2 * 512, kind="f32"), gpu, inner=50)

    # the train step: forward + backward + Adam, plain autograd (no hand-written kernel, as in the JAX package)
    for kind in ("float32", "bfloat16"):
        for b, n_rows in ((4, 8192), (1, 65536)):
            tm = ToadMIL(ModelConfig(in_dim=1024, n_classes=18, compute_dtype=kind),
                         generator=torch.Generator().manual_seed(seed)).cuda().train()
            step = make_train_step(tm, make_optimizer(OptimConfig(), tm.parameters()), 0.75, 0.25)
            batch = {"features": torch.randn(b, n_rows, 1024, device=dev).to(getattr(torch, kind)),
                     "patch_mask": torch.ones(b, n_rows, device=dev), "bag_mask": torch.ones(b, device=dev),
                     "label": torch.arange(b, device=dev) % 18, "site": torch.arange(b, device=dev) % 2,
                     "sex": torch.arange(b, device=dev) % 2}
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step(batch, None))
            flops = 3 * cuda_pool.flops_per_row(1024, 512, 384) * b * n_rows  # forward + two backward products
            log(f"phase 6 timing train step {kind} B={b} N={n_rows} D=1024 (forward + backward + Adam, plain autograd): "
                f"{ms:.3f} ms, {flops / (ms * 1e-3) / 1e12:.1f} TFLOP/s at 3x the forward's operations, peak device "
                f"memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB [{gpu}]")
            out[("step_" + kind, b)] = ms
            del tm, step, batch
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t_start = time.perf_counter()

    def elapsed(after: str) -> None:
        log(f"elapsed after {after}: {time.perf_counter() - t_start:.1f} s")

    card, gpu = phase_device()
    log(gpu)
    phase_build(gpu)
    elapsed("phase 2")
    model = seeded_model(args.seed).cuda().eval()
    worst = phase_compare(model, args.seed)
    worst_partial, worst_sharded = phase_compare_partial(model, args.seed)
    sharded = drive_bag_sharded(model, args.seed)
    worst8 = phase_compare_int8(model, args.seed)
    worst_mha = phase_compare_mha(args.seed)
    elapsed("phase 3")
    with tempfile.TemporaryDirectory(prefix="toad_smoke_") as tmp:
        served = phase_serve(model, args.seed, gpu, Path(tmp))
    with tempfile.TemporaryDirectory(prefix="toad_smoke_int8_") as tmp:
        served8 = phase_serve_int8(model, args.seed, gpu, Path(tmp))
    elapsed("phase 4")
    with tempfile.TemporaryDirectory(prefix="toad_smoke_vit_") as tmp:
        featurized = phase_featurize(args.seed, card, gpu, Path(tmp))
    elapsed("phase 5")
    with tempfile.TemporaryDirectory(prefix="toad_smoke_resnet_") as tmp:
        resnet = phase_resnet(args.seed, card, gpu, Path(tmp))
    elapsed("phase 9")
    with tempfile.TemporaryDirectory(prefix="toad_smoke_train_") as tmp:
        trained = phase_train(args.seed, card, gpu, Path(tmp))
        elapsed("phase 7")
        evaluated = phase_eval(trained, card, gpu, Path(tmp))
    elapsed("phase 8")
    times = phase_timing(model, gpu)
    times.update(phase_timing_train(gpu, args.seed))
    elapsed("phase 6")
    mha = times[("mha_bf16", 64)]
    log(f"phase 6 timing encoder: ViT-L/16 bf16, {featurized['batch_ms']:.2f} ms per batch of "
        f"{featurized['batch_size']} tiles ({featurized['batch_size'] / featurized['batch_ms'] * 1e3:.1f} tiles/s); "
        f"its {featurized['depth']} attention launches take {featurized['depth'] * mha['ms']:.2f} ms = "
        f"{100 * featurized['depth'] * mha['ms'] / featurized['batch_ms']:.1f} % of it [{gpu}]")
    for label, res in (("bf16 compute", served), ("int8", served8)):
        log(f"phase 6 timing serve ({label}): {res['rps']:.2f} requests/s, p50 latency {res['p50'] * 1e3:.1f} ms "
            f"over a burst of 24 concurrent requests (3,000-60,000 patches, default 5 ms batching window, "
            f"no warmup) [{gpu}]")
    record = {"kernels": [
        {
            "name": "fused_trunk_attention_pool",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool.cu",
            "replaces": "toad_tpu/ops/pallas_pool.py:93",
            "launches": served["launches"] + evaluated["k1_launches"],  # the bf16 serving burst and the eval passes
            "max_abs_err": worst,
            **times[("bfloat16", 32)],
        },
        {
            "name": "int8_trunk_attention_pool",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool_int8.cu",
            "replaces": "toad_tpu/ops/pallas_pool.py:259",
            "launches": served8["launches"] + evaluated["k2_launches"],  # the int8 serving burst and eval --int8
            "max_abs_err": worst8,
            **times[("int8", 32)],
        },
        {
            "name": "vit_fused_mha",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/mha.cu",
            "replaces": "toad_tpu/ops/vit_attention.py:42",
            "launches": featurized["launches"],
            "max_abs_err": worst_mha,
            **mha,
        },
        {
            "name": "fused_pool_partial",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool.cu",
            "replaces": "toad_tpu/ops/pallas_pool.py:636",
            "launches": sharded["partial"],
            "max_abs_err": worst_partial,
            **times[("partial_bf16", 1)],
        },
        {
            "name": "combine_partial_pool",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool_common.cuh",
            "replaces": "toad_tpu/parallel/bag_shard.py:28",
            "launches": sharded["combine"],
            "max_abs_err": worst_sharded,
            **times[("combine", 1)],
        },
        {
            "name": "resnet_fused_bottleneck_stage",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/stage.cu",
            "replaces": "experiments/pallas_stage_fusion.py:100",
            "launches": resnet["launches"],  # fused_stage over layer1-3: one launch per bottleneck block
            "max_abs_err": resnet["worst"],
            **resnet["times"]["all"],
        },
    ]}
    log(f"phase 7 train: the trainer's validation and final passes launched the pooling kernel "
        f"{trained['launches']} times for {trained['eval_batches']} eval batches")
    log(f"phase 8 eval: the eval passes launched the float pooling kernel {evaluated['k1_launches']} times and the int8 "
        f"pooling kernel {evaluated['k2_launches']} times, one per eval batch (serving bursts: {served['launches']} and "
        f"{served8['launches']})")
    enc_t, st = resnet["times"]["encoder"], resnet["times"]
    log(f"phase 9 timing summary: KS / plain_stage / cuDNN stage, bound (ms), bf16 B=64 at 256 px: " + "; ".join(
        f"{k} {st[k]['ms']:.3f} / {st[k]['plain_ms']:.3f} / {st[k]['library_ms']:.3f}, {st[k]['bound_ms']:.4f} by "
        f"{st[k]['bound_by']}" for k in ("layer1", "layer2", "layer3", "all")) + f"; the encoder {enc_t['batch']:.3f} ms "
        f"a batch, ResNet featurize {resnet['featurized']['cli_tiles_s']:.1f} tiles/s by the CLI's clock [{gpu}]")
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    log(gpu)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
