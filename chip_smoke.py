"""Chip smoke test of the PyTorch/CUDA port (toad_tpu_torch) on one GPU.

Run from the repository root on a machine with one Hopper card:

    python3 chip_smoke.py

Phases (each prints its lines; any failure raises and the exit code is not 0):

1. CUDA present with compute capability (9, 0); the card's name and power limit.
2. Build the kernels (toad_tpu_torch/csrc/pool.cu, K1 and its partial mode
   K1p and the one-launch sharded pool, each ending in its own merge;
   pool_common.cuh, that merge (pool_tail) and the combine kernel; pool_int8.cu, K2; mha.cu, K3 and P7;
   stage.cu, KS; pool_probe.cu and pool_int8_probe.cu, P1-P5) with nvcc, one
   process per source, all started together; shared memory per block and
   ptxas's register counts; cuobjdump -sass of the library shows K1's bf16
   instance and both instances of its f32 kernel on wgmma (HGMMA) and none on
   mma.sync (HMMA), and K2 on int8 wgmma (IGMMA) and none on int8 mma.sync
   (IMMA). Beside them, the native bag loader
   (toad_tpu_torch/csrc/bagio.cpp, host C++) with g++; its command is logged.
3. K1 vs its plain PyTorch version at full TOAD width (D=1024, H=512,
   A=384, T=2), f32 and bf16, scored and classification modes, including a
   bag whose tiles past bucket/2+1 are padding and a fully-masked bag: M,
   raw scores and the heads' logits, within the tolerances stated below; in
   both dtypes the kernel and the plain version also against the pool in
   float64 (plain_pool_f64), the kernel's largest error on M and on the
   scores at most F64_ERR_RATIO times the plain version's in its dtype.
   Then K1p: per shard pool_partial (on the shard as a view of the batch,
   read in place, the bits of its copy) vs plain_pool_partial (max,
   denominator, acc / denom), the combine kernel on K1p's partials vs its
   plain version, and bag_sharded_pool (one launch over every shard, merged
   at its end) vs K1p per shard with the combine, vs K1 on the whole bag and
   vs plain_pool, for B=1 and B=2 x 163,840 rows with 150,000 live in 2, 4
   and 8 shards, a bag of 30,000 live rows in 8 shards (6 of them fully
   masked) and a fully masked bag, f32 and bf16, within K1's tolerances (in
   bf16 K1p's acc / denom and the sharded pool also against plain_pool_f64);
   then bag_sharded_pool as a caller uses it on B=1 x 163,840 and on B=4 x
   40,960 rows sliced out of a batch (the main path of the one-launch
   sharded pool: one launch a call, no K1p or combine launch, counted from
   0), and a profiler's list of the device kernels of one call each of K1,
   K1p and the sharded pool (one each).
   Then K2 (int8) vs plain_int8_pool on the same cases, and a profiler's
   list of the device kernels of one K2 call (one: its merge is pool_tail at
   the end of its own launch). Then an un-gated
   ToadMIL (gate=False) in f32 at B=4 x 3,000 rows on the card, which pools
   through the plain version there (ops/fused_pool.kernel_pools, as the JAX
   package takes its XLA path), against the same forward on the CPU
   (TOL_F32), K1 not launched. Then K3 (the ViT
   attention core) vs plain_mha at ViT-L/16 width (16 heads of 64), bf16 and
   f32, B=64 x 197 tokens and B=3 x 257 tokens (a ragged last query block),
   in bf16 also B=128 and B=8 x 197 (the ViT probes' shapes, phase 11),
   then one launch each at ragged shapes, N in (1, 15, 16, 17, 63, 64, 65,
   193, 197, 208, 209, 257, 272) x B in (1, 3) x H in (1, 16), both dtypes
   (one-row last query tiles, both instances, one- and two-buffer plans,
   unit counts no multiple of the persistent grid), and P7 against
   plain_mha_new at N = 17 and 257 (TOL_P7_SHARE).
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
   ``python -m toad_tpu_torch convert``, its main run in process) and octet
   f32 (quantized on the
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
   kernel on the card. Then, with cuDNN's TF32 flag at PyTorch's default
   (every earlier phase puts back the flags it sets), the f32 encoder's patch
   tokens against the same convolution under cudnn.flags(allow_tf32=False)
   (TOL_FEATURES_F32; the TF32 convolution's difference is logged) and its
   features through the kernel against plain_mha on one batch. Then
   ``--format int8`` for one slide (the CLI's main in process, which spares
   a second child's start-up), read back with load_bag_quantized. Then
   ``featurize --encoder vit --profile DIR`` in process over one batch of 64
   of slide_b's tiles: the trace JSON written to DIR must hold device kernel
   events and K3 (``mha_bf16_kernel``) 24 times inside the batch's
   ``toad.featurize.embed_dispatch`` span (by each kernel's launch, matched
   on its correlation id); the batch's device time is split into K3, GEMMs,
   LayerNorm, elementwise and other, with the device's idle share of the
   batch's window.
7. Train end to end (run after phase 11; the trainer's validation and final
   passes are a main path of K1): toad_tpu_torch.data.synthetic writes a
   seeded dataset at full width (72 slides of 2,000-30,000 patches x 1024 as
   .npy, 18 origins with at least 3 slides each; on a writer thread while
   phases 10 and 11 run), generate_splits writes one fold, then ``python -m
   toad_tpu_torch train --max_epochs 2 --batch_size 4 --early_stopping
   --resume`` (f32) as a child process, and a run of one epoch with ``--bf16
   --drop_out``, both at ``--native_io auto``, so the .npy cohort goes through
   the native feed. Checked: exit code 0; every pass (train, val, final)
   logs the native feed; every epoch's train and val loss
   finite and the train loss falling; s_0_checkpoint.pt, splits_0.csv,
   split_0_results.pkl and summary.csv written; the trainer's pooling-kernel
   launches equal its eval batches; the checkpoint reloaded with
   load_params_any into a fresh model on the card reproduces summary.csv's
   test accuracy and AUC; one train step on the card against the same step
   on the CPU from the same weights and batch (f32, dropout off, TF32 off:
   torch.backends.cuda.matmul.allow_tf32 stays False): loss within 1e-4,
   every gradient within 1e-3 of its largest entry.
8. Evaluate end to end (``eval`` is a main path of K1 and, with ``--int8``,
   of K2), inside phase 7's work directory, as a user runs it (the f32 run a
   child process; the ``--int8`` and ``--bf16`` runs the CLI's main in this
   process, with the work directory as the current one): ``python -m
   toad_tpu_torch eval --models_exp_code
   smoke_f32_s1 --k 1 --batch_size 4`` on the test split: fold_0.csv holds
   the test split's slides in split order under the reference's columns, and
   summary.csv reproduces the trainer's own test accuracy (1e-6) and AUC
   (1e-4); pooling kernel launches = eval batches. With ``--int8``: the
   int8 kernel's launches = eval batches and none of the float kernel, the
   wire is int8, every probability within 0.02 of the f32 run's. In process,
   what ``--int8 --transfer_dtype float32`` runs (the float32 wire, rows
   quantized on the card, then K2): int8 kernel launches = eval batches and
   every probability within 1e-6 of the int8 wire's. Once ``--bf16 --drop_out --split all
   --calibrate --bootstrap 200`` on the bf16 run: the bf16 wire, the
   confusion matrix,
   the calibration report (a finite positive temperature) and the intervals
   (each brackets its point value) parse; ``report --dir`` on that directory
   gives n_folds 1 and the summary's means in its last JSON line. In
   process: evaluate_split on the card against evaluate_split on the CPU from
   the same checkpoint (f32, bags cut to 8,192 rows): probabilities within
   1e-4; a second pass on the card reuses the first one's pinned ring and no
   producer thread is left. Every pass, in the children and in process, must
   have run the native feed. Then, in process, the native feed against the
   numpy feed on the card (BagBatcher native='on' against 'off' over the test
   split, each wire: float32, bfloat16, int8): the same batch order and
   metadata, every plane equal bit for bit; and the producer's own rate (one
   pass over all 72 slides, the consumer only waiting for each batch's copy,
   numpy then native, on the float32 wire; warm page cache). Reported:
   slides/s and data-wait share of each pass by the CLI's
   own clock, the bytes each wire carried, the peak device memory, the
   producer's batches/s and GB/s.
6. Timing: kernel launches vs plain versions (CUDA events, median of 5 after
   warm-up, in the order plain, kernel, kernel, plain), for K3 also the
   library call F.scaled_dot_product_attention on the same qkv (timed only,
   never used by the package), the encoder's time per batch of 64 tiles, and
   the serving bursts' requests/s and p50 latency, each with the card's name
   and power limit. Each kernel's bound (the least time the card could take:
   the larger of its bytes over the memory rate and its operations over the
   peak rate of their type) is computed from the shapes timed; K1's f32
   instance runs three TF32 tensor-core products for each f32 one (3xTF32),
   and its FFMA bound (its products at the f32 FMA peak) is logged beside.
   The one-launch sharded pool in 4 and 8 shards against K1 in one launch on
   the same 163,840 rows, in turns; K1 at B=1 x 8,192 (predict's shape).
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
10. The pooling-kernel probes (run after phase 9): every kernel instance of
   toad_tpu_torch/csrc/pool_probe.cu (P1 full, exp2, nogate, nosoftmax,
   trunkonly; P2 b2) and csrc/pool_int8_probe.cu (P3/P4 int8_chain,
   int8_gemms, int8_inquant, int8_inquant_bf16, int8_h_only) against its
   plain version at full width with seeded biases and a seeded Wc over all
   8 task columns, B=4 x 4,096 rows (a ragged bag, a fully masked one, one
   live on 2,500 rows; int8_gemms also with b1 pushing h1 past 127), B=2 x
   4,160 rows at a probe tile of 64 (P1/P5's last 128-row tile half past the
   bag's end; P2's 64 + 64 rows a tile) and at the main path's B=32 x 8,192
   (the same kinds of bag; there every block runs several row tiles, checked
   from the split plans), each task row
   within TOL_PROBE of its own largest |output|; a wrong gate or uniform
   softmax weights move the plain output by at least PROBE_SEPARATION x
   TOL_PROBE; refused shapes raise without a launch; K1 at 2,048-row splits
   against its default plan and plain_pool on a bag of 131,072 rows; each
   instance timed against its plain version at B=32 x 8,192 with its
   bound (after phase 6 the bf16 ladder is logged as shares of P1 full
   beside K1 bf16, the int8 one as shares of int8_chain beside K2). Then
   the main path, each
   count from 0: ``toad_tpu_torch.experiments.mfu_probe.main()``,
   ``int8_probe.main()`` (and its two by-name variants) and
   ``longbag_probe.main()`` in process at their default sizes (B=32 x
   8,192, k=24; 131,072 rows), every JSON line parsed, every kernel
   instance launched; and ``python -m toad_tpu_torch.experiments.mfu_probe
   --variants full --k 4 --runs 1`` as a child process.
11. The ViT-L decomposition probes (run after phase 10): P7, the second
   softmax instance of toad_tpu_torch/csrc/mha.cu (q pre-scaled by
   Dh^-1/2 * log2(e), exp2, the context divided at the end), against
   plain_mha_new at ViT-L/16 width, bf16 at B=128, 64, 8 and 3 x 197 tokens
   (a ragged last query block) and B=8 x 272, f32 at 197: one bf16 ulp
   (TOL_MHA_BF16) and at most TOL_P7_SHARE of the elements differing, while
   K3 against the same plain version differs in at least P7_SEPARATION times
   that share; refused shapes raise without a launch; P7 timed against its
   plain version, K3 and F.scaled_dot_product_attention at B=64 x 197 with
   its bound; the probes' einsum attention (bf16 products on the tensor
   cores) against plain_mha at B=128 x 197 and x 256 (TOL_MHA_BF16). Then
   the main path, the counts from 0 before each probe:
   the main() of vit_softmax_probe, vit_attn_probe, vit_ceiling2_probe,
   vit_elementwise_probe, vit_profile and vit_int8_probe
   (toad_tpu_torch.experiments) in process at their JAX sizes (B=128 tiles
   of 224 px, k=4; M=25,216; two timed runs of each arm, ``--runs 2``),
   every JSON line parsed, each arm's K3 and P7
   launches as the arm says; and ``python -m
   toad_tpu_torch.experiments.vit_ceiling2_probe --k 1 --runs 1`` as a
   child process.
12. Slide inference (run after phase 8, inside phase 7's work directory, on
   its two checkpoints and .npy cohort): ``python -m toad_tpu_torch predict``
   on the f32 checkpoint over the test split (a manifest with its sexes) as
   a child process: one row a slide in split order, every probability
   within TOL_PREDICT_VS_EVAL of phase 8's f32 ``eval`` fold_0.csv (the same
   checkpoint and K1 f32, other batches and buckets), Y_hat equal where the
   top two differ by more, K1 f32 launches in scored mode = the slide count
   (the child's stderr line, with its slides/s). SlideInference(int8=True)
   in process over the same slides: K2 launches in scored mode = the slide
   count, every probability within 0.02 of predict's. ``infer --bag`` on a
   test slide given a coords sidecar, ``--heatmap h.png --save_attention
   a.npz``, as a child process: its JSON parses, its attention within 1e-6
   of SlideInference on the card and within 1e-4 of its largest |score|
   from the plain forward's raw scores, h.png decodes (zlib and the PNG
   header) to canvas_shape's size and to the heatmap of that attention. In
   process: ``heatmap`` on a.npz (the built-in jet ramp and the stdlib PNG
   writer where matplotlib and Pillow are absent), ``infer --ensemble`` over
   the f32 and bf16 runs' checkpoints against the mean of the two single
   predictions (2 K1 launches), and, in phase 9's directory, ``infer
   --patches`` with its seeded ResNet-50 .pth against SlideInference.predict
   on the bag phase 9's featurize wrote (2e-5). Then K1 f32 in scored mode
   against classification mode at B=1 x 65,536, timed in turns (phase 6 times
   both modes at predict's 1 x 8,192).
13. Ensemble serving and /heatmap (run after phase 12, in phase 7's work
   directory): phase 7's f32 and bf16 checkpoints laid out as a results dir
   of two folds (both members computed in f32), ``python -m toad_tpu_torch
   serve --ensemble`` as a child process at the default 5 ms window with no
   warmup, and a burst of 24 concurrent requests over the octet f32 and
   bag_path routes, with and without attention: every answer against
   EnsembleInference on the card from the same members (probabilities
   within TOL_ENSEMBLE_PROB, attention weights within
   TOL_ENSEMBLE_ATTENTION, y_hat equal); from /stats, K1 launches = 2 x
   batches and K1 launches in scored mode = 2 x the batches that asked for
   attention; ``POST /heatmap`` on phase 12's slide with coords, its PNG
   decoded with zlib to canvas_shape; the same burst on ``serve`` with the
   first member alone (K1 launches = batches, against SlideInference), for
   the second member's cost. Then the int8 ensemble in process (12 of the
   requests)
   through serve_in_thread (K2 launches = 2 x batches, against
   EnsembleInference(int8=True)); the forward of one assembled batch (B=8 x
   8,192) by a 1-member and a 2-member batcher, in turns (CUDA events); and
   ``toad_tpu_torch.experiments.serve_load.main()`` in process over wires
   none and raw (--bag_n 8192 --requests 96 --concurrency 8 --timestamps),
   its line parsed and its K1 launches = its batches, and each request's
   largest gap between its stages (sent, accepted, queued, answered).
14. The ops tooling (run after phase 13, in phase 7's work directory): ``train
   --profile DIR --bf16 --max_epochs 1 --batch_size 3`` as a child on phase
   7's cohort: the trace has ProfilerStep#0..9 and device kernel events, and
   every whole step launched kernels; reported: kernel launches a step, the
   device-busy share over the traced steps and the five longest kernels. In
   process, on one batch of the test split on the card: the checked step
   (``--debug_checks``) against the production step from the same state
   (TOL_CHECKED_STEP), a batch with an origin label of 25 and one with a NaN
   feature each refused with the JAX check's text and the parameters' and
   Adam state's bytes unchanged; then ``enable_debug_nans()`` with a NaN
   planted in one weight of phase 7's f32 checkpoint: one classification-
   mode eval step raises FloatingPointError naming ToadMIL, K1 launched once
   (the kernel ran, the hook caught its output). A trace on the card without
   device kernel events fails its phase.
15. The disk-fed and ceiling probes (run after phase 14), each as a child
   process (``python -m toad_tpu_torch.experiments.NAME``) at its JAX
   sizes: the disk-fed fixture (16 .pt bags of 8,192 x 1024 f32 and their
   manifest, data/synthetic.write_io_fixture) written once by the writer
   thread beside phases 10 and 11, then io_overlap_probe (the producer
   thread's copy to the card against a copy at dispatch) and bf16_transfer_probe (the bfloat16 wire
   against the float32 wire), both through TOAD's bf16 forward (K1 bf16,
   its launches counted in each child: 40 each), each arm's per-slide y_prob
   equal to the other's (0.0 apart); patient_native_probe (two slides a
   patient, the native and numpy feeds on the bfloat16 and int8 wires, host
   only); matmul_ceiling (cuBLAS bf16 at the JAX probe's 8 shapes, each
   chain a CUDA graph); encoder_batch_ab (the folded ResNet-50 at B=128,
   256, 512) and encoder_stages (stem, layer1-3, the encoder, two 3x3 conv
   ceilings; cuDNN). Every arm's line is parsed; a child that exits
   non-zero or misses a line fails the phase.
16. The ('data', 'bag') mesh (run after phase 15, in process, at TOAD's full
   width), each mesh over cuda:0 repeated (one card holds every shape): one
   SGD step with dropout at (1, 2), (2, 1) and (2, 2) on a batch of phase
   7's cohort against the unsharded step from the same weights and
   generator (loss and every parameter, TOL_MESH_STEP); one eval pass of
   phase 7's f32 checkpoint over the test split at (1, 2) and (2, 2)
   against the unsharded pass (probabilities, TOL_MESH_PROB): the main path
   of K1p (shards x batches launches) and the combine (one a batch), and no
   other launch of the library (no split merge); the
   serving batcher over (1, 2) answering six requests with and without
   attention against the unsharded batcher; phase 9's tiles through the
   ResNet-50 embedder with a data mesh of two against one device (to the
   bit, or within the encoder's bf16 noise as phase 9 states it);
   train_folds_parallel over two folds of one epoch on a 16-slide subset
   over two devices against each fold's sequential run (bit for bit); and
   make_mesh refusing a data axis past the visible cards with the JAX text.

The second-to-last line is the kernels' JSON record, the last line the device
record. Weights and data are random, made from --seed.

``python3 chip_smoke.py --mesh-cards`` (two or more cards; not part of the
default run) runs phases 1-2, then the mesh with each cell on its own card:
the mesh steps, eval forwards (float and int8) and served answers of phase
16 over (n, 1), (1, n) and (2, n/2), each against cuda:0 alone, their wall
times, the ResNet embedder over a data mesh of the n cards, and ``train
--data_shards/--bag_shards``, ``train --fold_devices n`` and ``eval
--fold_devices n`` as children on a seeded cohort of 54 bags, each fold
against the sequential run.

``python3 chip_smoke.py --k2-ablations [DIR ...]`` runs phases 1-2, then K2
at B=32 x 8,192 against builds of itself without products, without weight
copies and without the requantization (copies of the package under
_work/k2_ablate/ with csrc/pool_int8.cu's TOAD_K2_ABLATE set), and against
the package checkouts DIR if given, each in a child process.
"""

from __future__ import annotations

import argparse
import base64
import concurrent.futures
import dataclasses
import functools
import itertools
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
# The probe kernels (phase 10) vs their plain versions, each task row of the
# output [B, 8, H] relative to its own largest |value|. Both round at the same
# points (bias added to the f32 sums, then bf16), so they differ where
# summation order tips one bf16 rounding of h1, h2, gated or e (and, int8, one
# requantized step), and by the online softmax's running max against the
# bag's max. Measured on an H100: at most 2.9e-4 of a row's largest |value|
# (B=32 x 8,192; trunkonly 1e-5). The compare's Wc fills all 8 task columns
# (scale 0.5: scores of O(1) spread), so that every row depends on the gate
# and the softmax; the smoke checks that a wrong gate (nogate's) or uniform
# softmax weights move the plain output by at least PROBE_SEPARATION times
# this tolerance (measured: about 100 times).
TOL_PROBE = 1e-3
PROBE_SEPARATION = 10
# K1 at 2,048-row splits vs its default plan on the same bag: other splits
# round e to bf16 against other running maxes, K1's bf16 budget.
TOL_SPLIT = TOL_BF16_M
# P7 (phase 11) vs plain_mha_new: the same rounding points (q * c rounded to
# the dtype, f32 scores, the unrounded f32 p summed, p rounded for p v, the
# context divided by the f32 sum and rounded once), so a value differs only
# where the order of an f32 sum or an ulp of exp2 tips one bf16 rounding: at
# most one bf16 ulp (K3's TOL_MHA_BF16), and in few elements. K3 normalises p
# before rounding it, so against the same plain version it is off by that
# same one ulp, but in a large share of the elements (0.54 of them on the
# CPU at 197 tokens): the largest error cannot tell the two apart, the share
# of differing elements can. TOL_P7_SHARE bounds P7's share; K3's must exceed
# it P7_SEPARATION times. f32: summation order only, as K3's TOL_MHA_F32.
TOL_P7_SHARE = 0.02
P7_SEPARATION = 10

# Published dense peaks of one H100 SXM at its 700 W limit: device memory
# bytes/s, and operations/s by operand type.
PEAK_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12, "f32": 67e12}


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    return out.splitlines()[0]


def restores_tf32(phase):
    """Runs ``phase`` and puts both TF32 flags (``torch.backends.cuda.matmul``
    and ``torch.backends.cudnn``) back as it found them, whatever it set: a
    phase that turns TF32 off for its own comparisons leaves the next phase
    PyTorch's defaults."""
    @functools.wraps(phase)
    def run(*args, **kwargs):
        found = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        try:
            return phase(*args, **kwargs)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = found
    return run


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


def seeded_model(seed: int, gate: bool = True):
    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.models.toad_mil import ToadMIL

    g = torch.Generator().manual_seed(seed)
    model = ToadMIL(ModelConfig(in_dim=1024, n_classes=18, gate=gate), generator=g)
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


def plain_trunk_f64(params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The trunk and scores in float64 throughout: (h [B, N, H], scores [B, 2, N])."""
    p = cast_params(params, torch.float64)
    trunk, attn = p["trunk"], p["attn"]
    h = torch.relu(x.double() @ trunk["fc1"]["w"] + trunk["fc1"]["b"])
    h = torch.relu(h @ trunk["fc2"]["w"] + trunk["fc2"]["b"])
    gated = torch.tanh(h @ attn["a"]["w"] + attn["a"]["b"]) * torch.sigmoid(h @ attn["b"]["w"] + attn["b"]["b"])
    return h, (gated @ attn["c"]["w"] + attn["c"]["b"]).transpose(1, 2)


def pool_f64(h: torch.Tensor, scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """M [B, 2, H] = the masked softmax of float64 scores [B, 2, N] over h [B, N, H]."""
    from toad_tpu_torch.ops.pooling import masked_softmax

    return torch.bmm(masked_softmax(scores, mask[:, None, :], dim=-1), h)


def plain_pool_f64(params: dict, x: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pool in float64 throughout (trunk, gate, scores, softmax, M):
    (M [B, 2, H], scores [B, 2, N]), the truth that both instances of K1 and
    the plain versions in f32 and bf16 are held against."""
    h, scores = plain_trunk_f64(params, x)
    return pool_f64(h, scores, mask), scores


def pool_ops(dt: torch.dtype, ops: int) -> dict:
    """K1's operations by the type the card runs them in (time_pair's
    ``ops``): bf16 products, or in f32 three TF32 products (3xTF32) for each
    f32 one."""
    return {"tf32": 3 * ops} if dt == torch.float32 else {"bf16": ops}


def log_ffma_bound(label: str, rec: dict, ops: int, gpu: str) -> None:
    """The f32 instance's second bound beside time_pair's 3xTF32 one: its f32
    products as FMA at the card's f32 peak, the first kernel's arithmetic."""
    ffma = ops / PEAK_OPS_S["f32"] * 1e3
    log(f"phase 6 timing {label}: bounds 3xTF32 {rec['bound_ms']:.4f} ms (3 x {ops / 1e9:.1f} GFLOP at "
        f"{PEAK_OPS_S['tf32'] / 1e12:.0f} TFLOP/s TF32), FFMA {ffma:.4f} ms ({ops / 1e9:.1f} GFLOP at "
        f"{PEAK_OPS_S['f32'] / 1e12:.0f} TFLOP/s f32); kernel {rec['ms']:.3f} ms at {100 * rec['bound_ms'] / rec['ms']:.1f} % "
        f"of the 3xTF32 bound, {100 * ffma / rec['ms']:.1f} % of the FFMA bound [{gpu}]")


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
    from toad_tpu_torch import native
    from toad_tpu_torch.ops import _build, cuda_mha, cuda_pool, cuda_pool_int8, probe_pool, probe_pool_int8

    # the native bag loader (host C++, g++) builds in a thread while nvcc builds the kernels
    bagio: dict = {}
    def build_bagio() -> None:
        try:
            t = time.perf_counter()
            native.get_lib()
            bagio["seconds"] = time.perf_counter() - t
        except BaseException as e:  # raised below, in this thread
            bagio["error"] = e

    loader = threading.Thread(target=build_bagio, name="bagio-build")
    loader.start()
    t0 = time.perf_counter()
    _build.load_library()
    took = time.perf_counter() - t0
    loader.join()
    if "error" in bagio:
        raise bagio["error"]
    how8 = (f"`{' '.join(native.build_command)}` in {native.build_seconds:.2f} s" if native.build_command
            else "found built in _build/")
    log(f"phase 2 build: native bag loader {native.library_path().name} ready in {bagio['seconds']:.2f} s ({how8})")
    how = f"nvcc {_build.build_seconds:.2f} s" if _build.build_seconds is not None else "found built in _build/"
    lib = _build.load_library()
    for dt, code in ((torch.bfloat16, 1), (torch.float32, 0)):
        p = cuda_pool.plan(dt, 512, 384)
        lib_smem = cuda_pool.smem_bytes(dt, 512, 384)
        if (p.rows, p.smem) != (lib.toad_pool_rows_per_tile(code), lib_smem) or p.smem > cuda_pool.MAX_SMEM:
            raise AssertionError(f"K1 {dt}: the Python plan {p} disagrees with the library (rows "
                                 f"{lib.toad_pool_rows_per_tile(code)}, smem {lib_smem} B)")
        log(f"phase 2 build: K1 {str(dt)[6:]} plan at H=512 A=384: {p.rows} rows a tile, {p.threads} threads, "
            f"{p.slots} ring slots, {p.smem} B of shared memory (the library agrees)")
    for pair in (False, True):
        pp = probe_pool.plan(pair)
        if (pp.rows_per_bag, pp.smem) != (lib.toad_probe_pool_rows_per_tile(int(pair)), probe_pool.smem_bytes()) \
                or pp.smem > cuda_pool.MAX_SMEM:
            raise AssertionError(f"the bf16 probe{' pair' if pair else ''}: the Python plan {pp} disagrees with the "
                                 f"library (rows of a bag {lib.toad_probe_pool_rows_per_tile(int(pair))}, smem "
                                 f"{probe_pool.smem_bytes()} B)")
        log(f"phase 2 build: bf16 probe {'pair (P2)' if pair else '(P1/P5)'} plan: {pp.rows} rows a tile "
            f"({pp.rows_per_bag} of each bag), {pp.threads} threads, {pp.slots} ring slots, {pp.smem} B of shared "
            "memory (the library agrees)")
    pi8 = probe_pool_int8.plan(384)
    if (pi8.rows, pi8.smem) != (lib.toad_probe_int8_rows_per_tile(), probe_pool_int8.smem_bytes()) \
            or pi8.smem > cuda_pool.MAX_SMEM:
        raise AssertionError(f"the int8 probe: the Python plan {pi8} disagrees with the library (rows "
                             f"{lib.toad_probe_int8_rows_per_tile()}, smem {probe_pool_int8.smem_bytes()} B)")
    log(f"phase 2 build: int8 probe (P3/P4) plan: {pi8.rows} rows a tile, {pi8.threads} threads, {pi8.slots} ring "
        f"slots of {cuda_pool_int8.SLOT_BYTES} B (K2's stream), {pi8.smem} B of shared memory (the library agrees)")
    p8, lib_smem8 = cuda_pool_int8.plan(384), cuda_pool_int8.smem_bytes(384)
    if (p8.rows, p8.smem) != (lib.toad_pool_int8_rows_per_tile(), lib_smem8) or p8.smem > cuda_pool.MAX_SMEM:
        raise AssertionError(f"K2: the Python plan {p8} disagrees with the library (rows "
                             f"{lib.toad_pool_int8_rows_per_tile()}, smem {lib_smem8} B)")
    log(f"phase 2 build: K2 int8 plan at H=512 A=384: {p8.rows} rows a tile, {p8.threads} threads, {p8.slots} ring "
        f"slots of {cuda_pool_int8.SLOT_BYTES} B, {p8.smem} B of shared memory (the library agrees)")
    log(f"phase 2 build: {_build.library_path().name} ready in {took:.2f} s ({how}); "
        f"pool smem/block bf16 {cuda_pool.smem_bytes(torch.bfloat16, 512, 384)} B, "
        f"f32 {cuda_pool.smem_bytes(torch.float32, 512, 384)} B, "
        f"int8 {cuda_pool_int8.smem_bytes(384)} B; attention smem/block (one (image, head) buffer, two where they "
        f"fit) bf16 {cuda_mha.smem_bytes(torch.bfloat16, 197)} B (197 tokens), {cuda_mha.smem_bytes(torch.bfloat16, 257)} "
        f"B (257), f32 {cuda_mha.smem_bytes(torch.float32, 197)} B (197), {cuda_mha.smem_bytes(torch.float32, 257)} B "
        f"(257); probe smem/block bf16 {probe_pool.smem_bytes()} B, "
        f"int8 {probe_pool_int8.smem_bytes()} B [{card}]")
    for kernel, line in ptxas_lines(_build.build_log):
        names = {"pool_int8_kernel": "K2 int8 (64-row tiles, 2 warpgroups of int8 wgmma, one 3-slot weight stream)",
                 "pool_kernel_f32ILi256": "K1 f32 (64-row tiles, 2 warpgroups of tf32 wgmma, H=512)",
                 "pool_kernel_f32ILi128": "K1 f32 (64-row tiles, 2 warpgroups of tf32 wgmma, H=256)",
                 "pool_kernel_bf16": "K1 bf16 (128-row tiles, 2 warpgroups of bf16 wgmma m64n256k16)",
                 # K1, K1p, the one-launch sharded pool and K2 merge their partials in pool_tail at the end of their own
                 # launch; the combine kernel is a launch of its own only after the probes and for the mesh's shard
                 # partials (combine_shards)
                 "pool_int8_cu": "the merge at the end of K2 (pool_tail, not inlined)",
                 "pool_tail": "the merge at the end of K1, K1p and the sharded pool (pool_tail, not inlined)",
                 "pool_cu": "combine of the mesh's shard partials (a launch of its own)",
                 "pool_combine_kernelILi8E": "probe combine (8 tasks, a launch of its own)",
                 **{f"mha_bf16_kernelILi{kt}ELi{sm}E": f"{k} bf16 (up to {16 * kt} tokens)"
                    for kt in (13, 17) for sm, k in ((0, "K3"), (1, "P7"))},
                 **{f"mha_f32_kernelILi{kpl}ELi{sm}E": f"{k} f32 (up to {8 * kpl} tokens)"
                    for kpl in (26, 34) for sm, k in ((0, "K3"), (1, "P7"))},
                 **{f"stage_block_kernelI{m}Li{wm}ELi{mt}ELi{mb}E":
                    f"KS {d} ({16 * wm * mt}-pixel tiles, registers for {mb} CTA{'s' if mb > 1 else ''} an SM)"
                    for m, d in (("f", "f32"), ("13__nv_bfloat16", "bf16"))
                    for wm, mt in ((1, 1), (2, 1), (4, 1), (4, 2)) for mb in (1, 2)},
                 **{f"probe_pool_kernelIL{g}ELi{m}ELi{nb}E": f"P{1 + (nb == 2)} {v} (128-row tiles, 8 warps)"
                    for g, m, nb, v in (("i0", 0, 1, "full"), ("i1", 0, 1, "exp2"), ("i2", 0, 1, "nogate"),
                                        ("i0", 1, 1, "nosoftmax"), ("in1", 2, 1, "trunkonly"), ("i0", 0, 2, "b2"))},
                 **{f"probe_int8_kernelILi{i}ELi{r}E": f"P3/P4 {v} (K2's pass at 8 tasks)" for i, r, v in (
                     (0, 0, "int8_chain"), (0, 2, "int8_gemms"), (1, 0, "int8_inquant"),
                     (2, 1, "int8_inquant_bf16"), (3, 1, "int8_h_only"))}}
        name = next((v for k, v in names.items() if k in kernel), kernel)
        log(f"phase 2 build: {name}: {line}")
    for line in _build.build_log.splitlines():  # ptxas's word where it serialises a kernel's wgmma
        if "wgmma" in line:
            log(f"phase 2 build: ptxas: {line.strip()}")
    sass = pool_sass()
    k1 = {fn: c for fn, c in sass.items() if "pool_int8_kernel" not in fn}
    k2 = [c for fn, c in sass.items() if "pool_int8_kernel" in fn]
    if len(k1) != 3 or sum("pool_kernel_bf16" in fn for fn in k1) != 1 \
            or any(c["HGMMA"] == 0 or c["HMMA"] or c["IGMMA"] or c["IMMA"] for c in k1.values()):
        raise AssertionError(f"K1's SASS: {k1}; want its bf16 instance and both f32 instances on wgmma (HGMMA) "
                             "and no mma.sync (HMMA)")
    if len(k2) != 1 or k2[0]["IGMMA"] == 0 or k2[0]["IMMA"] or k2[0]["HGMMA"] or k2[0]["HMMA"]:
        raise AssertionError(f"K2's SASS: {k2}; want int8 wgmma (IGMMA) and no int8 mma.sync (IMMA)")
    log("phase 2 build: the pooling kernels' SASS (cuobjdump -sass): " + ", ".join(
        f"{fn} " + ", ".join(f"{c[op]} {op}" for op in POOL_SASS_OPS) for fn, c in sass.items()))


POOL_SASS_OPS = ("HGMMA", "HMMA", "IGMMA", "IMMA")  # wgmma and mma.sync, float and int8


def pool_sass() -> dict:
    """{function: {op: n}} for each instance of K1's kernel
    (``pool_kernel_bf16`` and both ``pool_kernel_f32``) and K2's
    (``pool_int8_kernel``) in ``cuobjdump -sass`` of the built library: their
    wgmma and mma.sync instructions, float (HGMMA, HMMA) and int8 (IGMMA,
    IMMA)."""
    from toad_tpu_torch.ops import _build

    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    dump = subprocess.run([str(cuobjdump), "-sass", str(_build.library_path())], capture_output=True, text=True,
                          check=True).stdout
    counts, fn = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            fn = fn if any(k in fn for k in ("pool_kernel_f32", "pool_kernel_bf16", "pool_int8_kernel")) else None
            if fn is not None:
                counts[fn] = dict.fromkeys(POOL_SASS_OPS, 0)
        elif fn is not None:
            for op in POOL_SASS_OPS:
                counts[fn][op] += f" {op}." in line
    return counts


def ptxas_lines(build_log: str):
    """(mangled kernel name, line) for each line of ptxas -v about a kernel's
    registers or spills in ``build_log``."""
    kernel = None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif kernel is not None and ("registers" in line or "spill stores" in line):
            yield kernel, line.split(":", 1)[-1].strip()


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


# K1 against the f64 pool: its largest error on M and on the scores, over
# every case of phase 3, at most this many times the plain version's in the
# same compute dtype on the same inputs (f32: cuBLAS in f32, TF32 off; bf16:
# bf16 products, the plain version's own rounding points). The f32 kernel's
# 3xTF32 products are as accurate as f32 FMA (tests/test_torch_port_pool_plan.py
# models them); one TF32 product would miss this ~50-fold. The bf16 kernel
# rounds where the TPU kernel does (h1, h2, gated and e), its sums in wgmma's
# order.
F64_ERR_RATIO = 2.0


def check_f64_ratio(what: str, vs64: dict) -> None:
    """vs64 {output: {"kernel": err, "plain": err}} against plain_pool_f64:
    logs each and raises where the kernel's error passes F64_ERR_RATIO x the
    plain version's."""
    for key, e in vs64.items():
        log(f"{what} {key} vs plain_pool_f64: largest error {e['kernel']:.3e}, the plain version's {e['plain']:.3e} "
            f"(ratio {e['kernel'] / e['plain']:.2f}, limit {F64_ERR_RATIO})")
        if e["kernel"] > F64_ERR_RATIO * e["plain"]:
            raise AssertionError(f"{what} {key}: the largest error against plain_pool_f64, {e['kernel']:.3e}, is over "
                                 f"{F64_ERR_RATIO} x the plain version's {e['plain']:.3e}")


def f64_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.double() - want).abs().max().item()


def worst_vs64(vs64: dict, key: str, kernel: float, plain: float) -> None:
    """vs64[key] <- the larger errors of both, against plain_pool_f64."""
    e = vs64.setdefault(key, {"kernel": 0.0, "plain": 0.0})
    e["kernel"], e["plain"] = max(e["kernel"], kernel), max(e["plain"], plain)


@restores_tf32
def phase_compare(model, seed: int) -> dict:
    """K1 against its plain version at every case of compare_cases, f32 and
    bf16, both modes, and both against plain_pool_f64. Returns the largest
    error of M and scores by compute dtype."""
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = model.pool_params()
    g = torch.Generator(device=dev).manual_seed(seed)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    vs64 = {}
    for label, b, n, mask in compare_cases(g):
        x = torch.randn(b, n, 1024, device=dev, generator=g)
        sex = torch.arange(b, device=dev) % 2
        with torch.inference_mode():
            m64, s64 = plain_pool_f64(params, x, mask)
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
            worst[dt] = max(worst[dt], check_modes(f"{label} {str(dt)[6:]}", mask, outs, tols))
            mk, sk, _, mp, sp, _ = outs[True]
            errs = {"kernel M": max(f64_err(o[0], m64) for o in outs.values()),
                    "plain M": max(f64_err(o[3], m64) for o in outs.values()),
                    "kernel scores": f64_err(sk, s64), "plain scores": f64_err(sp, s64)}
            for what in ("M", "scores"):
                worst_vs64(vs64, f"K1 {str(dt)[6:]} {what}", errs[f"kernel {what}"], errs[f"plain {what}"])
            log(f"phase 3 compare {label} {str(dt)[6:]} vs plain_pool_f64: K1 M {errs['kernel M']:.2e} scores "
                f"{errs['kernel scores']:.2e}; plain M {errs['plain M']:.2e} scores {errs['plain scores']:.2e}")
        del x, m64, s64
    check_f64_ratio("phase 3 compare over every case:", vs64)
    return worst


@restores_tf32
def phase_compare_partial(model, seed: int) -> tuple[float, float, float]:
    """K1p (the pooling kernel's partial mode) per shard, on the shard as a
    view of the batch (read in place, B=2 strided) and on its copy (the same
    bits), against plain_pool_partial on the copy; the combine kernel on
    K1p's partials against its plain version; and bag_sharded_pool (one
    launch over every shard, its merge at its end) against K1 on the whole
    bag, against plain_pool and against the combine of K1p's partials, on
    bags of 163,840 rows; in bf16 K1p's acc / denom and the sharded pool also
    against plain_pool_f64 (F64_ERR_RATIO). Returns the largest error of (the
    shards' statistics, the combine kernel, the one-launch sharded pool)."""
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
    worst_stats = worst_comb = worst_m = 0.0
    vs64 = {}  # bf16 K1p's acc / denom and the bf16 sharded pool against plain_pool_f64
    for label, live, shard_counts in cases:
        b = len(live)
        x = torch.randn(b, n, 1024, device=dev, generator=g)
        mask = torch.zeros(b, n, device=dev)
        for i, rows in enumerate(live):
            mask[i, :rows] = (torch.rand(rows, device=dev, generator=g) < 0.95).float()
        with torch.inference_mode():
            h64, s64 = plain_trunk_f64(params, x)
        for dt, tol_m, tol_s in ((torch.float32, TOL_F32, TOL_F32), (torch.bfloat16, TOL_BF16_M, TOL_BF16_S)):
            name = f"{label} {str(dt)[6:]}"
            with torch.inference_mode():
                ops = model.kernel_operands(dt)
                m_whole, _ = cuda_pool.pool(ops, x, mask, with_scores=False)
                m_plain, _ = plain_pool(params, x, mask, dt, with_scores=False)
                m64 = pool_f64(h64, s64, mask) if dt == torch.bfloat16 else None
                for n_shards in shard_counts:
                    per = n // n_shards
                    masked_shards, e_max, e_den, e_mean = 0, 0.0, 0.0, 0.0
                    accs, stats = [], []
                    for s in range(n_shards):
                        xs, ms = x[:, s * per:(s + 1) * per], mask[:, s * per:(s + 1) * per]
                        acc_k, st_k = cuda_pool.pool_partial(ops, xs, ms)  # the view, read in place
                        copies = xs.contiguous(), ms.contiguous()
                        if not all(map(torch.equal, (acc_k, st_k), cuda_pool.pool_partial(ops, *copies))):
                            raise AssertionError(f"{name} shard {s}/{n_shards}: K1p on the view is not its copy's bits")
                        acc_p, st_p = plain_pool_partial(params, *copies, dt)
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
                            mean_k, mean_p = acc_k[lv] / st_k[lv, 1, :, None], acc_p[lv] / st_p[lv, 1, :, None]
                            e_mean = max(e_mean, check_close(
                                f"{name} shard {s}/{n_shards} acc / denom", mean_k, mean_p, tol_m))
                            if dt == torch.bfloat16:
                                sl = slice(s * per, (s + 1) * per)
                                want = pool_f64(h64[:, sl], s64[:, :, sl], ms)[lv]
                                worst_vs64(vs64, "K1p bf16 acc / denom", f64_err(mean_k, want), f64_err(mean_p, want))
                    m_sharded = bag_sharded_pool(ops, x, mask, n_shards)  # one launch
                    # the combine kernel alone, on K1p's partials, against its plain version; the one-launch pool
                    # against it (its runs differ from the per-shard launches': bf16 rounds e against other maxes)
                    acc_all, st_all = torch.stack(accs), torch.stack(stats)
                    m_comb = cuda_pool.combine_shards(acc_all, st_all)
                    e_comb = check_close(f"{name} {n_shards} shards combine vs plain combine", m_comb,
                                         plain_combine_partial_pool(acc_all, st_all), TOL_F32)
                    e_regroup = check_close(f"{name} {n_shards} shards one launch vs K1p per shard + combine",
                                            m_sharded, m_comb, tol_m)
                    e_whole = check_close(f"{name} {n_shards} shards vs K1 on the whole bag", m_sharded, m_whole, tol_m)
                    e_plain = check_close(f"{name} {n_shards} shards vs plain_pool", m_sharded, m_plain, tol_m)
                    if dt == torch.bfloat16:
                        worst_vs64(vs64, "bag_sharded_pool bf16 M", f64_err(m_sharded, m64), f64_err(m_plain, m64))
                    dead_bags = mask.sum(1) == 0
                    if dead_bags.any() and m_sharded[dead_bags].abs().max().item() != 0.0:
                        raise AssertionError(f"{name}: a fully-masked bag pooled to nonzero M")
                    torch.cuda.synchronize()
                    worst_stats = max(worst_stats, e_max, e_mean)
                    worst_comb = max(worst_comb, e_comb)
                    worst_m = max(worst_m, e_whole, e_plain, e_regroup)
                    log(f"phase 3 compare partial pool {name} N={n} in {n_shards} shards ({masked_shards} fully masked): "
                        f"per shard (B={b} strided views, the bits of their copies) vs plain_pool_partial max abs err "
                        f"of max {e_max:.2e}, of denom / plain denom {e_den:.2e} (tolerance {tol_s}), of acc / denom "
                        f"{e_mean:.2e}; the combine kernel on K1p's partials vs its plain version {e_comb:.2e} "
                        f"(tolerance {TOL_F32}); bag_sharded_pool in one launch vs K1p + combine {e_regroup:.2e}, "
                        f"vs K1 on the whole bag {e_whole:.2e}, vs plain_pool {e_plain:.2e} (tolerance {tol_m})")
        del x, mask, h64, s64
    check_f64_ratio("phase 3 compare partial pool over every case:", vs64)
    return worst_stats, worst_comb, worst_m


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
    # one K2 call is one launch: each bag's split partials merge in pool_tail at the end of the kernel
    with torch.inference_mode():
        listed = one_call_kernels(lambda: cuda_pool_int8.pool_int8(ops, xq, sx, mask, False))
    if len(listed) != 1 or "pool_int8_kernel" not in listed[0]:
        raise AssertionError(f"one K2 call, the device kernels the profiler listed: {listed}")
    log(f"phase 3 compare int8: the profiler's device kernels of one K2 call ({label}): {listed}")
    return worst


@restores_tf32
def phase_compare_ungated(seed: int) -> float:
    """An un-gated ToadMIL's eval forward on the card, where it pools through
    the plain version (ops/fused_pool.kernel_pools, as the JAX package takes
    its XLA path), against the same forward on the CPU: f32 (TF32 off), B=4
    x 3,000 rows with a ragged and a short bag, in scored mode; K1 must not
    launch. Returns the largest error."""
    from toad_tpu_torch.ops import cuda_pool

    torch.backends.cuda.matmul.allow_tf32 = False
    model = seeded_model(seed + 4, gate=False).eval()
    g = torch.Generator().manual_seed(seed + 4)
    x = torch.randn(4, 3000, 1024, generator=g)
    mask = (torch.rand(4, 3000, generator=g) < 0.9).float()
    mask[1, 700:] = 0.0
    sex = torch.tensor([0, 1, 1, 0])
    with torch.inference_mode():
        want = model(x, mask, sex)
    model.cuda()
    before = cuda_pool.LAUNCHES
    with torch.inference_mode():
        got = model(x.cuda(), mask.cuda(), sex.cuda())
        torch.cuda.synchronize()
    if cuda_pool.LAUNCHES != before:
        raise AssertionError("the un-gated forward launched K1, which computes the gated variant only")
    live = mask[:, None, :].expand_as(want.attention) > 0
    worst = max(check_close(f"un-gated forward {k}", getattr(got, k).cpu(), getattr(want, k), TOL_F32)
                for k in ("logits", "y_prob", "site_logits", "features"))
    worst = max(worst, check_close("un-gated forward attention", got.attention.cpu()[live], want.attention[live], TOL_F32))
    log(f"phase 3 compare un-gated ToadMIL f32 B=4 N=3000 on the card (the plain version there) vs the CPU: max abs err "
        f"{worst:.2e} (tolerance {TOL_F32}), K1 launches {cuda_pool.LAUNCHES - before}")
    return worst


def phase_compare_mha(seed: int) -> float:
    """K3 against plain_mha at ViT-L/16 width and at ragged shapes (P7 at two
    of them); also that a shape without an instance raises and launches
    nothing."""
    from toad_tpu_torch.ops import cuda_mha
    from toad_tpu_torch.ops.vit_attention import fused_mha, fused_mha_new, plain_mha, plain_mha_new

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    worst = 0.0
    # bf16 also at B=128 and B=8 x 197, the ViT probes' shapes (phase 11)
    for dt, tol, shapes in ((torch.bfloat16, TOL_MHA_BF16, ((64, 197), (3, 257), (128, 197), (8, 197))),
                            (torch.float32, TOL_MHA_F32, ((64, 197), (3, 257)))):
        for b, n in shapes:
            qkv = torch.randn(b, n, 3 * 16 * 64, device=dev, generator=g).to(dt)
            with torch.inference_mode():
                out = fused_mha(qkv, 16, 64)
                ref = plain_mha(qkv, 16, 64)
            torch.cuda.synchronize()
            err = check_close(f"attention {str(dt)[6:]} B={b} N={n}", out, ref, tol)
            log(f"phase 3 compare attention {str(dt)[6:]} B={b} N={n} H=16 Dh=64: max abs err {err:.2e} "
                f"(tolerance {tol})")
            worst = max(worst, err)
    # ragged shapes, one launch each: a one-row last query tile (N = 1, 17, 65, 193, 209, 257), whole tiles
    # (16, 64, 208, 272), the 17-key-tile bf16 instance and the one-buffer plans (N > 208), and unit counts
    # (B x H = 1, 3, 16, 48) that are no multiple of the persistent grid
    ragged = (1, 15, 16, 17, 63, 64, 65, 193, 197, 208, 209, 257, 272)
    errs = {}
    for dt, tol in ((torch.bfloat16, TOL_MHA_BF16), (torch.float32, TOL_MHA_F32)):
        for n in ragged:
            for b in (1, 3):
                for heads in (1, 16):
                    qkv = torch.randn(b, n, 3 * heads * 64, device=dev, generator=g).to(dt)
                    with torch.inference_mode():
                        out, ref = fused_mha(qkv, heads, 64), plain_mha(qkv, heads, 64)
                    torch.cuda.synchronize()
                    err = check_close(f"attention {str(dt)[6:]} B={b} N={n} H={heads}", out, ref, tol)
                    errs[str(dt)[6:]] = max(errs.get(str(dt)[6:], 0.0), err)
                    worst = max(worst, err)
    log(f"phase 3 compare attention, ragged N in {ragged} x B in (1, 3) x H in (1, 16): max abs err "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + f" (tolerance bf16 {TOL_MHA_BF16}, f32 {TOL_MHA_F32})")
    # P7 at two of them: a one-row tail in the 13-tile instance, and in the 17-tile one-buffer instance
    for dt, tol in ((torch.bfloat16, TOL_MHA_BF16), (torch.float32, TOL_MHA_F32)):
        for n in (17, 257):
            qkv = torch.randn(3, n, 3 * 16 * 64, device=dev, generator=g).to(dt)
            with torch.inference_mode():
                got, want = fused_mha_new(qkv, 16, 64), plain_mha_new(qkv, 16, 64)
            torch.cuda.synchronize()
            label = f"P7 {str(dt)[6:]} B=3 N={n}"
            err = check_close(label, got, want, tol)
            share = (got != want).float().mean().item()
            if dt == torch.bfloat16 and share > TOL_P7_SHARE:
                raise AssertionError(f"{label}: {share:.3e} of the elements differ from plain_mha_new, over {TOL_P7_SHARE}")
            log(f"phase 3 compare {label} H=16 vs plain_mha_new: max abs err {err:.2e} (tolerance {tol}), "
                f"{share:.2e} of the elements differ (limit {TOL_P7_SHARE} in bf16)")
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
    # ops: a count of one kind, or {kind: count} for a kernel whose products mix operand types
    ops_by_kind = work["ops"] if isinstance(work["ops"], dict) else {work["kind"]: work["ops"]}
    work = dict(work, ops=sum(ops_by_kind.values()), kind="+".join(ops_by_kind))
    t_bytes = work["bytes"] / PEAK_BYTES_S * 1e3
    t_ops = sum(n / PEAK_OPS_S[kind] for kind, n in ops_by_kind.items()) * 1e3
    bound_ms, bound_by = max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"
    unit = "TOP/s" if "int8" in ops_by_kind else "TFLOP/s"
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
                label = f"pool {str(dt)[6:]} B={b} N={n} D=1024 classification"
                out[(str(dt)[6:], b)] = time_pair(
                    label, lambda: plain_pool(params, xd, mask, dt, False), lambda: cuda_pool.pool(ops, xd, mask, False),
                    dict(bytes=nbytes(xd, mask, *ops) + out_bytes, ops=pool_ops(dt, ops_per_call)), gpu)
                if dt == torch.float32:
                    log_ffma_bound(label, out[(str(dt)[6:], b)], ops_per_call, gpu)
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


def time_attention() -> dict:
    """K3 (bf16 and f32), P7 (bf16) and F.scaled_dot_product_attention at the
    main path's B=64 x 197, H=16, Dh=64 (CUDA events, 20 launches a reading):
    the times ``--attention-ab`` compares across trees."""
    import torch.nn.functional as F

    from toad_tpu_torch.ops.vit_attention import fused_mha, fused_mha_new

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    b, n, heads, head_dim = 64, 197, 16, 64
    out = {}
    for kind, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qkv = torch.randn(b, n, 3 * heads * head_dim, device=dev, generator=g).to(dt)
        q, k, v = qkv.view(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
        with torch.inference_mode():
            out[f"k3_{kind}_ms"] = cuda_ms(lambda: fused_mha(qkv, heads, head_dim), inner=20)
            if dt == torch.bfloat16:
                out["p7_bf16_ms"] = cuda_ms(lambda: fused_mha_new(qkv, heads, head_dim), inner=20)
            out[f"sdpa_{kind}_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v), inner=20)
    return out


def ab_runs(flag: str, what: str, parent: Path, gpu: str) -> list[tuple[str, dict]]:
    """Another tree (``parent``, a checkout of the package) against this one
    on the same card: ``chip_smoke.py FLAG ROOT`` in a child process for each,
    in the order parent, this, this, parent. Logs each run's numbers and, for
    each, the better of each tree's two; returns the runs' records."""
    runs = []
    for label, root in (("parent", parent), ("this", REPO), ("this", REPO), ("parent", parent)):
        run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), flag, str(root)],
                             capture_output=True, text=True, env=child_env(), timeout=900)
        if run.returncode != 0:
            raise AssertionError(f"{flag} {root} failed ({run.returncode}):\n{run.stdout}{run.stderr[-3000:]}")
        runs.append((label, json.loads(run.stdout.strip().splitlines()[-1])))
        numbers = {k: v for k, v in runs[-1][1].items() if isinstance(v, (int, float))}
        log(f"{what} A/B {label} tree ({root}): {json.dumps(numbers)} [{gpu}]")
    keys = dict.fromkeys(k for _, r in runs for k, v in r.items() if isinstance(v, (int, float)))
    for key in keys:
        best = {lab: min((r[key] for l2, r in runs if l2 == lab and key in r), default=None)
                for lab in ("parent", "this")}
        if best["parent"] is None:
            log(f"{what} A/B {key}: this tree {best['this']:.4f} (not in the parent) [{gpu}]")
            continue
        ratio = f"parent / this {best['parent'] / best['this']:.2f}" if best["this"] else "none in this tree"
        log(f"{what} A/B {key}: parent {best['parent']:.4f}, this tree {best['this']:.4f} ({ratio}) [{gpu}]")
    return runs


# Plans timed against the default in --stage-ab, on the first block of their
# width and stride (bf16, B=64 at 256 px): (width, stride, th, tw, rows, stages).
STAGE_AB_PLANS = (
    (64, 1, 8, 8, 112, 3),
    (128, 2, 8, 8, 192, 2),    # 64 pixels a CTA at stride 2
    (128, 1, 8, 8, 112, 2),    # 64 pixels a CTA
    (128, 1, 8, 16, 192, 3),   # one halo pass, one CTA an SM
    (256, 2, 8, 8, 64, 3),
    (256, 1, 8, 16, 192, 2),
)


def time_stage(seed: int = 0) -> dict:
    """KS per block and per stage at B=64 x 256 px in bf16, with the encoder's
    cuDNN stage beside it (CUDA events, 5 launches a reading, 20 for a block), and a sha256 of
    every block's bf16 and f32 output on seeded inputs (B=64 at 256 px, B=3 at
    224 px; each block takes the kernel's output of the block before; and
    :func:`streamed_ds_block`'s): what
    ``--stage-ab`` compares across trees. Where the package has plans, each of
    STAGE_AB_PLANS is timed too, and its output's digest must be the default
    plan's."""
    import hashlib

    from toad_tpu_torch.ops import fused_stage as fs

    def digest(t: torch.Tensor) -> str:
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]

    dev = torch.device("cuda")
    enc = seeded_resnet(seed).fold_bn().to(dev)
    g = torch.Generator(device=dev).manual_seed(seed + 13)
    out, digests, alts_timed = {}, {}, set()
    names = ("layer1", "layer2", "layer3")
    with torch.inference_mode():
        for dt in (torch.bfloat16, torch.float32):
            for b, px in ((64, 256), (3, 224)):
                x = stage_input(enc, torch.randint(0, 256, (b, px, px, 3), device=dev, dtype=torch.uint8, generator=g))
                x = x.to(dt)
                timed = dt == torch.bfloat16 and b == 64
                for (stage, stride), name in zip(enc.stages(), names):
                    if timed:
                        out[f"ks_{name}_ms"] = cuda_ms(lambda: fs.fused_stage(stage, x, first_stride=stride), inner=5)
                        xc = x.permute(0, 3, 1, 2)
                        out[f"cudnn_{name}_ms"] = cuda_ms(lambda: enc.run_stage(stage, xc, stride), inner=5)
                    for i, ops in enumerate(fs.stage_weights(stage, dt)):
                        s = stride if i == 0 else 1
                        y = fs.stage_block(ops, x, s)
                        key = f"{name}.{i} {str(dt)[6:]} B={b} {px}px"
                        digests[key] = digest(y)
                        if timed:
                            out[f"{name}.{i}_ms"] = cuda_ms(lambda: fs.stage_block(ops, x, s), inner=20)
                            width = ops.w1.shape[1]
                            for alt in STAGE_AB_PLANS if hasattr(fs, "plan") else ():
                                if alt[:2] != (width, s) or alt in alts_timed:
                                    continue
                                alts_timed.add(alt)
                                p = fs.StagePlan(*alt[2:4], fs.halo_rows(alt[2], alt[3], s), *alt[4:],
                                                 fs.plan_bytes(dt, *alt))
                                tag = f"{name}.{i} plan {p.th}x{p.tw} rows {p.rows} slots {p.stages}"
                                if digest(fs.stage_block(ops, x, s, p)) != digests[key]:
                                    raise AssertionError(f"{tag}: output differs from the default plan's")
                                out[f"{tag} ms"] = cuda_ms(lambda: fs.stage_block(ops, x, s, p), inner=20)
                        x = y
        for dt in (torch.bfloat16, torch.float32):
            ops, x = streamed_ds_block(dt, g)
            digests[f"streamed downsample {str(dt)[6:]}"] = digest(fs.stage_block(ops, x, 2))
    torch.cuda.synchronize()
    out["digests"] = digests
    return out


def stage_ab(parent: Path, gpu: str) -> None:
    """KS of another tree against this one's: :func:`time_stage` in each
    (:func:`ab_runs`); every block's bf16 and f32 output must be the same bits
    in both trees."""
    runs = ab_runs("--time-stage", "stage", parent, gpu)
    want = runs[0][1]["digests"]
    for label, r in runs[1:]:
        differ = sorted(k for k in want if r["digests"].get(k) != want[k])
        if differ or r["digests"].keys() != want.keys():
            raise AssertionError(f"stage A/B: the {label} tree's outputs differ from the parent's at {differ}")
    log(f"stage A/B: all {len(want)} outputs (13 blocks, bf16 and f32, B=64 at 256 px and B=3 at 224 px; the streamed "
        f"downsample block in both dtypes) have the same sha256 in both trees, in all four runs")


# K2's shapes in --pool-ab: (B, N) of the smoke's timing, one bag of a long
# eval bucket, the eval rung of compare_cases; the controls' shapes: K1p's
# shard, P6's bag, and the probes' small batch
POOL_AB_SHAPES = ((32, 8192), (1, 65536), (4, 29568))
POOL_AB_PARTIAL = (1, 40960)
POOL_AB_STRIDED = (2, 40960)  # K1p on half of each bag's rows: a strided shard
POOL_AB_SPLIT = (1, 131072)
POOL_AB_SHARDED = (1, 163840)  # the bf16 sharded pool against float64
POOL_AB_PROBE = (4, 4096)


# the int8 probe's ladder in --pool-ab and after phase 6: (minuend, subtrahend, what the difference is)
INT8_LADDER = (("int8_chain", "int8_gemms", "the requantization of the mma.sync pass"),
               ("int8_inquant", "int8_chain", "x quantized in the kernel"),
               ("int8_inquant_bf16", "int8_inquant", "the bf16 quantizer against the f32 one"),
               ("int8_h_only", "int8_inquant_bf16", "a bf16 GEMM1 against int8"))


def int8_ladder(ms: dict, k2_ms: float) -> str:
    """The int8 probe's instances as x K2, and its ladder as shares of
    int8_chain, from ``ms`` {variant: ms} at B=32 x 8,192."""
    chain = ms["int8_chain"]
    return (", ".join(f"{v} {t:.3f} ms = {t / k2_ms:.2f} x K2" for v, t in ms.items()) + "; the ladder as shares of "
            "int8_chain: " + ", ".join(f"{a} - {b} ({what}) {100 * (ms[a] - ms[b]) / chain:+.1f} %"
                                       for a, b, what in INT8_LADDER))


def time_pool(seed: int = 0) -> dict:
    """K2 (the subject) in classification mode at B=32 x 8,192 and 1 x
    65,536 and in scored mode at predict's B=1 x 8,192, and the int8 probe's
    instances beside it at B=32 x 8,192 (the probes' shape, mask all ones),
    on seeded inputs (CUDA events, 5 readings of one launch), K2's device
    time and call span from a profiler trace of 10 calls at B=32 x 8,192:
    what ``--pool-ab`` compares across trees. K2 is held to
    plain_int8_pool at POOL_AB_SHAPES in both modes (``int8``: its largest
    error beside the tolerance, and whether it is within), and its bits
    are kept apart (``K2 digests``: its scores at every shape and its M
    under :func:`~toad_tpu_torch.ops.cuda_pool.split_plan`'s split, passed
    where the package's ``pool_int8`` takes a split); its M in
    classification mode at POOL_AB_SHAPES is saved under _work/pool_ab/,
    whose path it returns. ``digests`` holds a sha256 of every output of
    the controls, which must be the same bits in both trees: K1 in both
    dtypes and modes at every shape, K1p in both dtypes (whole and on a
    strided B=2 shard), P6, the bf16 sharded pool, P1 full and every int8
    probe instance (P3/P4, on K2's old pass). Also ptxas's lines of K1, its
    merge, K2 and the int8 probe where this process built them."""
    import hashlib
    import inspect

    from toad_tpu_torch.ops import _build, cuda_pool, cuda_pool_int8, probe_pool, probe_pool_int8
    from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_rows
    from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool

    def digest(t: torch.Tensor) -> str:
        return hashlib.sha256(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()[:16]

    def vs_plain(tag: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> None:
        err = (got - want).abs()
        int8[tag] = {"err": err.max().item(), "within": bool((err <= tol["atol"] + tol["rtol"] * want.abs()).all())}

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = seeded_model(seed).cuda().eval()
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    takes_split = "split" in inspect.signature(cuda_pool_int8.pool_int8).parameters
    out, digests, k2_digests, int8, saved = {}, {}, {}, {}, {}

    def inputs(b, n):
        x = torch.randn(b, n, 1024, device=dev, generator=g)
        return x, (torch.rand(b, n, device=dev, generator=g) < 0.9).float()

    with torch.inference_mode():
        qparams, ops8 = model.int8_operands()
        ops = {dt: model.kernel_operands(dt) for dt in (torch.bfloat16, torch.float32)}
        for b, n in POOL_AB_SHAPES:
            x, mask = inputs(b, n)
            xq, sx = quantize_rows(x)
            for scored in (False, True):
                shape = f"{'scored' if scored else 'classification'} B={b} N={n}"
                m, s = cuda_pool_int8.pool_int8(ops8, xq, sx, mask, scored)
                mp, sp = plain_int8_pool(qparams, xq, sx, mask, scored)
                vs_plain(f"K2 {shape} M", m, mp, TOL_INT8_M)
                if scored:
                    vs_plain(f"K2 {shape} scores", s, sp, TOL_INT8_S)
                    k2_digests[f"K2 {shape} scores"] = digest(s)
                else:
                    saved[f"K2 {shape} M"] = m
                if takes_split:
                    m = cuda_pool_int8.pool_int8(ops8, xq, sx, mask, scored,
                                                 split=cuda_pool.split_plan(b, n, 64, n_sms))[0]
                k2_digests[f"K2 {shape} M at split_plan"] = digest(m)
                for dt in (torch.float32, torch.bfloat16):
                    m, s = cuda_pool.pool(ops[dt], x.to(dt), mask, scored)
                    digests[f"K1 {str(dt)[6:]} {shape} M"] = digest(m)
                    if scored:
                        digests[f"K1 {str(dt)[6:]} {shape} scores"] = digest(s)
            del x, xq
        # K1p whole, and on the second half of a B=2 batch's rows, a strided view
        for (b, n), rows in ((POOL_AB_PARTIAL, slice(None)), (POOL_AB_STRIDED, slice(POOL_AB_STRIDED[1], None))):
            x, mask = inputs(b, n if rows.start is None else 2 * n)
            tag = f"B={b} N={n}" + ("" if rows.start is None else f" (rows {n}.. of {2 * n}, a view)")
            for dt in (torch.float32, torch.bfloat16):
                digests.update(zip((f"K1p {str(dt)[6:]} {tag} acc", f"K1p {str(dt)[6:]} {tag} stats"), map(
                    digest, cuda_pool.pool_partial(ops[dt], x.to(dt)[:, rows], mask[:, rows]))))
        del x
        for (b, n), shards in ((POOL_AB_SPLIT, None), (POOL_AB_SHARDED, 4)):
            x, mask = inputs(b, n)
            xb = x.to(torch.bfloat16)
            got = (cuda_pool.pool(ops[torch.bfloat16], xb, mask, False, rows_per_split=2048)[0] if shards is None
                   else bag_sharded_pool(ops[torch.bfloat16], xb, mask, shards))
            digests[f"P6 bf16 B={b} N={n} M" if shards is None
                    else f"bag_sharded_pool bf16 B={b} N={n} {shards} shards M"] = digest(got)
            del x, xb
        x, mask = inputs(*POOL_AB_PROBE)
        mask[1] = 0.0
        params, _, qp, qp_h, _ = probe_operands(seed, dev)
        tag = f"B={POOL_AB_PROBE[0]} N={POOL_AB_PROBE[1]}"
        digests[f"P1 full {tag} tile 1024"] = digest(
            probe_pool.probe_pool(probe_pool.pack_probe_params(params), x.to(torch.bfloat16), mask, "full", 1024))
        qops = {False: probe_pool_int8.pack_probe_qparams(qp), True: probe_pool_int8.pack_probe_qparams(qp_h)}

        def int8_args(v, x):
            return qops[v == "int8_h_only"], *(quantize_rows(x) if v in probe_pool_int8.PREQUANTIZED
                                                else (x.to(torch.bfloat16), None))

        for v in probe_pool_int8.VARIANTS:
            o, xin, sx = int8_args(v, x)
            digests[f"{'P4' if v in probe_pool_int8.PREQUANTIZED else 'P3'} {v} {tag}"] = digest(
                probe_pool_int8.probe_pool_int8(o, xin, sx, mask, v))
        del x
        # the subject: K2 at the batch, the long bag and predict's shape, and the int8 probe's instances beside it
        x = torch.randn(32, 8192, 1024, device=dev, generator=g)
        ones = torch.ones(32, 8192, device=dev)
        xq, sx = quantize_rows(x)
        k2_batch = lambda: cuda_pool_int8.pool_int8(ops8, xq, sx, ones, False)  # noqa: E731
        out["K2 classification B=32 N=8192 ms"] = cuda_ms(k2_batch)
        out.update({f"K2 classification B=32 N=8192 {k}": v for k, v in device_us(k2_batch).items()})
        del xq, sx
        for v in probe_pool_int8.VARIANTS:
            o, xin, sxv = int8_args(v, x)
            out[f"probe {v} B=32 N=8192 ms"] = cuda_ms(
                lambda o=o, xin=xin, sxv=sxv, v=v: probe_pool_int8.probe_pool_int8(o, xin, sxv, ones, v))
            del xin, sxv
        del x
        for (b, n), scored in (((1, 65536), False), ((1, 8192), True)):
            x, mask = inputs(b, n)
            xq, sx = quantize_rows(x)
            out[f"K2 {'scored' if scored else 'classification'} B={b} N={n} ms"] = cuda_ms(
                lambda: cuda_pool_int8.pool_int8(ops8, xq, sx, mask, scored))
            del x, xq
    torch.cuda.synchronize()
    out["ptxas"] = [f"{name}: {line}" for kernel, line in ptxas_lines(_build.build_log)
                    for key, name in (("pool_int8_kernel", "K2"), ("probe_int8_kernel", kernel),
                                      ("pool_kernel_f32", f"K1 f32 {kernel}"),
                                      ("pool_kernel_bf16", "K1 bf16"), ("pool_tail", "pool_tail"))
                    if key in kernel]
    path = REPO / "_work" / "pool_ab" / f"outputs_{os.getpid()}.pt"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({k: v.cpu() for k, v in saved.items()}, path)
    out["digests"] = digests
    out["K2 digests"] = k2_digests
    out["int8"] = int8
    out["saved"] = str(path)
    return out


# The builds of K2 that leave one part out (csrc/pool_int8.cu's TOAD_K2_ABLATE), timed by --k2-ablations
K2_ABLATIONS = {1: "without products", 2: "without weight copies", 3: "without the requantization (a saturating cast)"}


def time_k2(seed: int = 0) -> dict:
    """K2 in classification mode at B=32 x 8,192 (mask all ones; CUDA events,
    5 readings of one launch) of the package under sys.path, and ptxas's K2
    lines: what ``--k2-ablations`` compares across builds."""
    from toad_tpu_torch.ops import _build, cuda_pool_int8
    from toad_tpu_torch.ops.quantize import quantize_rows

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 17)
    model = seeded_model(seed).cuda().eval()
    with torch.inference_mode():
        _, ops8 = model.int8_operands()
        xq, sx = quantize_rows(torch.randn(32, 8192, 1024, device=dev, generator=g))
        ones = torch.ones(32, 8192, device=dev)
        ms = cuda_ms(lambda: cuda_pool_int8.pool_int8(ops8, xq, sx, ones, False))
    return {"K2 classification B=32 N=8192 ms": ms,
            "ptxas": [line for kernel, line in ptxas_lines(_build.build_log) if "pool_int8_kernel" in kernel]}


def k2_ablations(gpu: str, others: list[Path]) -> None:
    """K2 against builds of itself that each leave one part out
    (K2_ABLATIONS): each a copy of this tree's package under
    _work/k2_ablate/ with TOAD_K2_ABLATE defined at the top of
    csrc/pool_int8.cu, and against the package checkouts ``others`` (other
    designs of K2), each timed by :func:`time_k2` in a child process, in the
    order kernel, each ablation, each other, kernel. Logs each build's time
    (the kernel: the better of its two) and its share of the kernel's, and
    its ptxas lines."""
    roots = [("kernel", REPO)]
    for n in K2_ABLATIONS:
        root = REPO / "_work" / "k2_ablate" / str(n)
        shutil.rmtree(root, ignore_errors=True)
        shutil.copytree(REPO / "toad_tpu_torch", root / "toad_tpu_torch",
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        src = root / "toad_tpu_torch" / "csrc" / "pool_int8.cu"
        src.write_text(f"#define TOAD_K2_ABLATE {n}\n" + src.read_text())
        roots.append((n, root))
    roots += [(str(other), other) for other in others] + [("kernel", REPO)]
    runs = []
    for label, root in roots:
        run = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), "--time-k2", str(root)],
                             capture_output=True, text=True, env=child_env(), timeout=900)
        if run.returncode != 0:
            raise AssertionError(f"--time-k2 {root} failed ({run.returncode}):\n{run.stdout}{run.stderr[-3000:]}")
        runs.append((label, json.loads(run.stdout.strip().splitlines()[-1])))
    key = "K2 classification B=32 N=8192 ms"
    kernel = min(r[key] for label, r in runs if label == "kernel")
    for label, r in runs:
        what = ("the kernel" if label == "kernel" else f"ablation {label}, {K2_ABLATIONS[label]}"
                if label in K2_ABLATIONS else f"the checkout {label}")
        log(f"k2 ablations: {what}: {r[key]:.3f} ms at B=32 x 8,192 = {100 * r[key] / kernel:.1f} % of the kernel's "
            f"{kernel:.3f}; ptxas {'; '.join(r['ptxas']) or 'as in phase 2 (built there)'} [{gpu}]")


def device_us(fn, calls: int = 10) -> dict:
    """A profiler's reading of ``calls`` calls of ``fn`` in one trace, each
    call the pooling kernel's launch and any combine launches after it: the
    median device microseconds of the pooling kernel, of the combine kernel
    (where a call launches one) and of the call's span on the card (its
    pooling kernel's start to its last kernel's end), over the calls whose
    records the trace kept."""
    def calls_fn():
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    per_call = []  # [pool kernel us, combine us, start, end] a call
    for e in sorted(traced_kernels(calls_fn), key=lambda e: e["ts"]):
        if "pool_kernel" in e["name"] or "pool_int8_kernel" in e["name"]:
            per_call.append([e["dur"], 0.0, e["ts"], e["ts"] + e["dur"]])
        elif "pool_combine_kernel" in e["name"] and per_call:
            per_call[-1][1] += e["dur"]
            per_call[-1][3] = e["ts"] + e["dur"]
    # the profiler now and then drops a kernel's record: the medians take what it kept
    if len(per_call) < calls // 2:
        raise AssertionError(f"the profiler's trace of {calls} pooling calls holds {len(per_call)} pooling kernels")
    return {"pool kernel us": statistics.median(c[0] for c in per_call),
            "combine kernel us": statistics.median(c[1] for c in per_call),
            "span us": statistics.median(c[3] - c[2] for c in per_call)}


def pool_ab(parent: Path, gpu: str) -> None:
    """The pooling kernels of another tree against this one's:
    :func:`time_pool` in each (:func:`ab_runs`). K2, the kernel under
    change, within TOL_INT8_M / TOL_INT8_S of plain_int8_pool in every run of
    both trees, its M under each tree's default split within TOL_INT8_M of
    the parent's (the splits may differ: e is rounded to bf16 against other
    running maxes), whether it kept the parent's bits logged, and its median
    over each tree's two runs faster than the parent's at B=32 x 8,192 and 1
    x 65,536 and within the parent's spread at predict's 1 x 8,192 (scored).
    Every control digest (K1 both dtypes, K1p, P6, the bf16 sharded pool, P1
    full, P3/P4) the same bits in both trees. Logs each tree's ptxas lines
    and, for each run, K2's device time and span, each int8 probe instance
    as x K2 and the ladder as shares of int8_chain (the probes run K2's old
    pass)."""
    from toad_tpu_torch.ops.probe_pool_int8 import VARIANTS

    runs = ab_runs("--time-pool", "pool", parent, gpu)
    for label, r in runs:
        for line in r["ptxas"]:
            log(f"pool A/B {label} tree: ptxas {line}")
        k2_ms = r["K2 classification B=32 N=8192 ms"]
        log(f"pool A/B {label} tree: K2 {k2_ms:.3f} ms at B=32 x 8,192; its device time "
            f"{r['K2 classification B=32 N=8192 pool kernel us']:.1f} us + a combine launch "
            f"{r['K2 classification B=32 N=8192 combine kernel us']:.1f} us, a call's span "
            f"{r['K2 classification B=32 N=8192 span us']:.1f} us (profiler); " + int8_ladder(
                {v: r[f"probe {v} B=32 N=8192 ms"] for v in VARIANTS}, k2_ms) + f" [{gpu}]")
    want = runs[0][1]["digests"]
    for label, r in runs[1:]:
        differ = sorted(k for k in want if r["digests"].get(k) != want[k])
        if differ or r["digests"].keys() != want.keys():
            raise AssertionError(f"pool A/B: the {label} tree's control outputs differ from the parent's at {differ}")
    # K2, the kernel under change, against plain_int8_pool in every run of both trees
    for label, r in runs:
        off = [k for k, v in r["int8"].items() if not v["within"]]
        log(f"pool A/B {label} tree: K2 against plain_int8_pool, max abs err " + ", ".join(
            f"{k} {v['err']:.3e}" for k, v in r["int8"].items()) + f" (M {TOL_INT8_M}, scores {TOL_INT8_S})")
        if off:
            raise AssertionError(f"pool A/B: the {label} tree's K2 is off plain_int8_pool at {off}")
    kept = {k: all(r["K2 digests"][k] == runs[0][1]["K2 digests"][k] for label, r in runs if label == "this")
            for k in runs[0][1]["K2 digests"]}
    log("pool A/B: K2 keeps the parent's bits at " + (", ".join(k for k, v in kept.items() if v) or "none")
        + "; not at " + (", ".join(k for k, v in kept.items() if not v) or "none"))
    # K2 in the same call: faster than the parent at the batch and the long bag, and at predict's shape no slower
    # than the parent by more than the parent's own spread
    for shape, strict in (("classification B=32 N=8192", True), ("classification B=1 N=65536", True),
                          ("scored B=1 N=8192", False)):
        key = f"K2 {shape} ms"
        t = {lab: sorted(r[key] for l2, r in runs if l2 == lab) for lab in ("parent", "this")}
        med = {lab: statistics.median(v) for lab, v in t.items()}
        spread = t["parent"][-1] - t["parent"][0]
        log(f"pool A/B {key}: parent {t['parent']} (median {med['parent']:.4f}, spread {spread:.4f}), this tree "
            f"{t['this']} (median {med['this']:.4f}) [{gpu}]")
        if med["this"] >= med["parent"] if strict else med["this"] > med["parent"] + spread:
            raise AssertionError(f"pool A/B: K2 {shape} takes {med['this']:.4f} ms, the parent "
                                 f"{med['parent']:.4f} ms" + ("" if strict else f" (its spread {spread:.4f})"))
    ref = torch.load(runs[0][1]["saved"])
    worst = {}
    for label, r in runs[1:]:
        got = torch.load(r["saved"])
        if got.keys() != ref.keys():
            raise AssertionError(f"pool A/B: the {label} tree saved {sorted(got)}, the parent {sorted(ref)}")
        for key, want_t in ref.items():
            worst[key] = max(worst.get(key, 0.0), check_close(f"pool A/B {label} {key}", got[key], want_t, TOL_INT8_M))
    log("pool A/B: " + "; ".join(f"{k} {v:.3e}" for k, v in worst.items()) + " against the parent's (K2 under each "
        f"tree's default split: max abs err, tolerance {TOL_INT8_M})")
    log(f"pool A/B: all {len(want)} control digests (K1 in both dtypes and modes at every shape, K1p in both dtypes, "
        "whole and on a strided shard, P6, the bf16 sharded pool, P1 full, P3/P4) equal the parent's in all four runs; "
        "K2 within its tolerances of plain_int8_pool in every run")


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
    """``python -m toad_tpu_torch serve --bf16`` (without ``--bf16`` when
    ``bf16`` is False) on port 0 in a child process."""

    def __init__(self, ckpt: Path, bag_dir: Path, workdir: Path, extra: list[str], bf16: bool = True):
        env = child_env()
        cmd = [sys.executable, "-m", "toad_tpu_torch", "serve", "--ckpt", str(ckpt), "--task", "dummy_mtl_concat",
               *(["--bf16"] if bf16 else []), "--port", "0", "--bag_root", str(bag_dir), *extra]
        self.proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=workdir)
        self.lines: list[str] = []
        self.base: str | None = None

    def __enter__(self) -> "Server":
        """Waits for the 'serving on' line; once that has come, returns at once."""
        if self.base is not None:
            return self
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
    # both servers start before the requests are made, so that their start-ups overlap that and each other;
    # both are serving and idle before the first burst's clock starts, and the 300 ms one idles through it
    fast = Server(ckpt, bag_dir, workdir, [])
    slow = Server(ckpt, bag_dir, workdir, ["--max_wait_ms", "300"])
    try:
        reqs = make_requests(seed, bag_dir, ROUTES)
        attn = sum(r["attention"] for r in reqs)
        fast.__enter__()
        slow.__enter__()

        # main path: the server as a user starts it (default 5 ms batching window,
        # no --warmup). Its kernel launch count starts at 0 in the fresh process;
        # /stats reads it after the burst.
        with fast as srv:
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
        with slow as srv:
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
    finally:
        fast.__exit__()
        slow.__exit__()


def phase_serve_int8(model, seed: int, gpu: str, workdir: Path) -> dict:
    """``serve --int8`` as a user starts it (default 5 ms window, no
    --warmup), fed by an int8 store that ``convert`` makes from .pt bags."""
    ckpt = write_checkpoint(model, workdir)
    src, store = workdir / "bags8_f32", workdir / "bags8"
    src.mkdir()
    # the server starts before the requests and the store are made (it reads the store only when asked)
    srv = Server(ckpt, store, workdir, ["--int8"])
    try:
        reqs = make_requests(seed + 1, src, ROUTES_INT8)
        t0 = time.perf_counter()
        # the CLI's main in this process: the command without a child's start-up
        conv_out, _ = run_cli(["convert", "--data_dir", str(src), "--out_dir", str(store), "--format", "int8"], workdir,
                              in_process=True)
        log(f"phase 4 serve int8: {conv_out.strip()} in {time.perf_counter() - t0:.2f} s (in process)")
        for r in reqs:
            if r["path"] is not None:
                r["path"] = store / f"{r['path'].stem}.npz"
        attn = sum(r["attention"] for r in reqs)

        with srv:
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
    finally:
        srv.__exit__()


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


def check_patch_tokens(enc32, batch: torch.Tensor) -> tuple[float, float]:
    """The f32 encoder's patch tokens (``_embed_tokens``, which turns cuDNN's
    TF32 off itself) against the same convolution under an explicit
    ``cudnn.flags(allow_tf32=False)``, the global flag left as it is. Returns
    (their largest difference, that of the same convolution in TF32): the
    second is the error the guard keeps out."""
    import torch.nn.functional as F

    c, cd = enc32.config, torch.backends.cudnn
    w = enc32._weights(torch.float32)
    pw, pb = w["patch"]
    with torch.no_grad():
        x = enc32.preprocess(batch)
        got = enc32._embed_tokens(x, w, torch.float32)[:, 1:]
        pos = enc32._pos(w, torch.float32, x.shape[1] // c.patch_size, x.shape[2] // c.patch_size)[:, 1:]

        def conv(tf32: bool) -> torch.Tensor:
            with cd.flags(enabled=cd.enabled, benchmark=cd.benchmark, deterministic=cd.deterministic, allow_tf32=tf32):
                t = F.conv2d(x.permute(0, 3, 1, 2), pw, stride=c.patch_size) + pb[None, :, None, None]
            return t.flatten(2).transpose(1, 2) + pos

        exact, in_tf32 = conv(False), conv(True)
    err = check_close("f32 patch tokens vs the convolution without TF32", got, exact, TOL_FEATURES_F32)
    return err, (in_tf32 - exact).abs().max().item()


def run_featurize(workdir: Path, weights: Path, patch_dir: Path, feat_dir: Path) -> tuple[dict, float]:
    """``python -m toad_tpu_torch featurize --encoder vit`` as a user runs it,
    in a child process: (its last JSON line, wall seconds)."""
    env = child_env()
    cmd = [sys.executable, "-m", "toad_tpu_torch", "featurize", "--encoder", "vit", "--weights", str(weights),
           "--patch_dir", str(patch_dir), "--feat_dir", str(feat_dir), "--format", "npz", "--batch_size", "64"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True, env=env, cwd=workdir, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"featurize failed ({run.returncode}):\n{run.stdout}{run.stderr}")
    for line in run.stdout.strip().splitlines()[:-1]:
        log(f"phase 5 featurize (npz): {line}")
    return json.loads(run.stdout.strip().splitlines()[-1]), wall


# Reading a torch.profiler trace (the Chrome trace JSON a user opens in Perfetto): device activity, the host
# launch of each kernel (by correlation id), and the host spans (record_function, ProfilerStep#k) it fell in.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
K3_SYMBOLS = ("mha_bf16_kernel", "mha_f32_kernel")  # csrc/mha.cu's __global__ functions
# kernel name -> class for the device-time split (demangled names; the first class whose word is in the name)
KERNEL_CLASSES = (
    ("K3", K3_SYMBOLS),
    ("GEMM", ("gemm", "nvjet", "xmma", "cutlass", "cublas")),
    ("LayerNorm", ("layer_norm", "LayerNorm")),
    ("elementwise", ("elementwise",)),
)


def read_trace(log_dir: Path) -> list[dict]:
    """The events of the one trace file a ``--profile DIR`` run wrote."""
    files = sorted(Path(log_dir).glob("*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"{log_dir}: {len(files)} trace files, not 1: {files}")
    with open(files[0]) as f:
        return json.load(f)["traceEvents"]


def host_spans(events: list[dict], prefix: str) -> list[dict]:
    """Host ``user_annotation`` spans whose name starts with ``prefix``, in time order."""
    return sorted((e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e.get("name", "").startswith(prefix)), key=lambda e: e["ts"])


def device_in_span(events: list[dict], span: dict) -> list[dict]:
    """Device activity (kernels, copies, memsets) whose host launch lies in
    ``span`` on its thread, or, where the launch was not recorded, that runs
    inside a ``gpu_user_annotation`` of the span's name."""
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in LAUNCH_CATS and "correlation" in e.get("args", {})}
    lo, hi = span["ts"], span["ts"] + span["dur"]
    gpu_spans = [(g["ts"], g["ts"] + g["dur"]) for g in events
                 if g.get("cat") == "gpu_user_annotation" and g.get("name") == span["name"]]
    out = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        if launch is not None:
            if launch["tid"] == span["tid"] and lo <= launch["ts"] <= hi:
                out.append(e)
        elif any(a <= e["ts"] and e["ts"] + e["dur"] <= b for a, b in gpu_spans):
            out.append(e)
    return out


def busy_us(device_events: list[dict], lo: float | None = None, hi: float | None = None) -> tuple[float, float]:
    """(the union of the events' device intervals, the window) in µs; the
    window is [lo, hi], or the first start to the last end where not given."""
    iv = sorted((e["ts"], e["ts"] + e["dur"]) for e in device_events)
    if not iv:
        return 0.0, 0.0
    lo = iv[0][0] if lo is None else lo
    hi = max(b for _, b in iv) if hi is None else hi
    busy, end = 0.0, lo
    for a, b in iv:
        a, b = max(a, end), min(b, hi)
        if b > a:
            busy += b - a
            end = b
    return busy, hi - lo


def op_names(events: list[dict]) -> dict:
    """External id -> the name of the host op (``aten::bmm``, ...) that
    launched the device work carrying it."""
    return {e["args"]["External id"]: e["name"] for e in events
            if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}


def longest_kernels(kernels: list[dict], ops: dict, n: int = 5) -> str:
    """The ``n`` kernels that take the most device time, summed by name:
    total ms, count and the host op that launched them."""
    by_name: dict[str, list] = {}
    for e in kernels:
        by_name.setdefault(e["name"], []).append(e)
    top = sorted(by_name.items(), key=lambda kv: -sum(e["dur"] for e in kv[1]))[:n]
    return "; ".join(
        f"{name[:64]} {sum(e['dur'] for e in ks) / 1e3:.3f} ms ×{len(ks)} "
        f"({'/'.join(sorted({ops.get(e.get('args', {}).get('External id'), '?') for e in ks}))})" for name, ks in top)


def kernel_class(name: str) -> str:
    return next((label for label, words in KERNEL_CLASSES if any(w in name for w in words)), "other")


def check_trace_has_device_events(events: list[dict], what: str) -> int:
    """A trace on the card with no device kernel event is a failed phase."""
    n = sum(1 for e in events if e.get("cat") == "kernel")
    if n == 0:
        raise AssertionError(f"{what}: the trace holds no device kernel event (CUPTI recorded no device activity)")
    return n


def phase_featurize_profiled(weights: Path, imgs: np.ndarray, workdir: Path, gpu: str) -> dict:
    """``featurize --encoder vit --profile DIR`` in process over one batch of
    64 tiles, its trace read from DIR: K3's 24 launches inside the batch's
    ``toad.featurize.embed_dispatch`` span, and the batch's device time by
    kernel class with the device's idle share of its window."""
    from toad_tpu_torch.data.bags import load_bag
    from toad_tpu_torch.ops import cuda_mha

    src = workdir / "patches_profiled"
    src.mkdir()
    np.savez(src / "slide_p.npz", imgs=imgs, coords=np.zeros((len(imgs), 2), np.int64))
    trace_dir = workdir / "vit_trace"
    t0 = time.perf_counter()
    cuda_mha.LAUNCHES = 0
    out, _ = run_cli(["featurize", "--encoder", "vit", "--weights", str(weights), "--patch_dir", str(src), "--feat_dir",
                      str(workdir / "feats_profiled"), "--format", "npz", "--batch_size", "64", "--profile",
                      str(trace_dir)], workdir, in_process=True)
    launched, wall = cuda_mha.LAUNCHES, time.perf_counter() - t0
    lines = out.strip().splitlines()
    if lines[-1] != f"[profile] trace written to {trace_dir}" or any("device kernel events" in ln for ln in lines):
        raise AssertionError(f"featurize --profile: {lines[-3:]}")
    events = read_trace(trace_dir)
    n_kernels = check_trace_has_device_events(events, "featurize --profile")
    spans = host_spans(events, "toad.featurize.embed_dispatch")
    if len(spans) != 1 or len(host_spans(events, "toad.featurize.slide")) != 1:
        raise AssertionError(f"featurize --profile: {len(spans)} embed_dispatch spans for one batch")
    inside = device_in_span(events, spans[0])
    kernels = [e for e in inside if e["cat"] == "kernel"]
    k3 = [e for e in kernels if any(w in e["name"] for w in K3_SYMBOLS)]
    if len(k3) != 24 or launched != 24:
        raise AssertionError(f"featurize --profile: {len(k3)} K3 kernels in the embed_dispatch span, {launched} "
                             "launches counted; want 24 (one a block)")
    split: dict[str, float] = {}
    for e in kernels:
        split[kernel_class(e["name"])] = split.get(kernel_class(e["name"]), 0.0) + e["dur"] / 1e3
    busy, window = busy_us(inside)
    got = torch.from_numpy(load_bag(workdir / "feats_profiled" / "slide_p.npz"))
    ref = torch.from_numpy(load_bag(workdir / "feats" / "slide_b.npz")[:len(imgs)])
    check_close("the profiled batch's features vs phase 5's first batch of slide_b", got, ref, TOL_FEATURES)
    total = sum(split.values())
    log(f"phase 5 featurize --profile (in process, one batch of {len(imgs)}): trace of {n_kernels} device kernels, "
        f"{len(kernels)} inside toad.featurize.embed_dispatch, K3 ({K3_SYMBOLS[0]}) {len(k3)} times = launches counted "
        f"{launched}; the batch's device time {total:.3f} ms: " + ", ".join(
            f"{k} {v:.3f} ms ({100 * v / total:.1f} %)" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))
        + f"; device busy {busy / 1e3:.3f} of the {window / 1e3:.3f} ms window (idle {100 * (1 - busy / window):.1f} %, "
        f"with the profiler on); the five longest kernels: {longest_kernels(kernels, op_names(events))}; {wall:.1f} s "
        f"[{gpu}]")
    return dict(launches=launched, split=split, idle=1 - busy / window, window_ms=window / 1e3)


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
    said, wall = run_featurize(workdir, weights, patch_dir, workdir / "feats")
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

    # the same weights computing in f32, with cuDNN's TF32 flag at PyTorch's default (True) as a caller
    # leaves it: the encoder turns it off for its own convolution (checked directly on the patch tokens),
    # then the kernel path (the FMA instance) against the plain path on one batch
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("torch.backends.cudnn.allow_tf32 is not at PyTorch's default (True) in phase 5: "
                             "an earlier phase left TF32 off, and the f32 checks below would not see the encoder's guard")
    enc32 = vit_encoder.ViTEncoder(dataclasses.replace(enc.config, compute_dtype="float32"), init=False)
    enc32.load_state_dict(enc.state_dict(), assign=True)
    enc32 = enc32.to(dev).eval()
    err_tok, tf32_err = check_patch_tokens(enc32, batch)
    if not torch.backends.cudnn.allow_tf32:
        raise AssertionError("the f32 encoder did not put torch.backends.cudnn.allow_tf32 back")
    log(f"phase 5 featurize: f32 patch tokens (cuDNN TF32 flag True outside the encoder) vs the same convolution "
        f"under cudnn.flags(allow_tf32=False): max abs err {err_tok:.2e} (tolerance {TOL_FEATURES_F32}); the same "
        f"convolution in TF32 is off by {tf32_err:.2e}, the error the encoder's guard keeps out [{gpu}]")
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

    # int8 bags for one slide: the CLI's main in process (its flags and writer, without a second child's
    # start-up), its launches counted from before the call
    from toad_tpu_torch.ops import cuda_mha

    mha_0, t8 = cuda_mha.LAUNCHES, time.perf_counter()
    out8, _ = run_cli(["featurize", "--encoder", "vit", "--weights", str(weights), "--patch_dir", str(patch_dir8),
                       "--feat_dir", str(workdir / "feats_int8"), "--format", "int8", "--batch_size", "64"],
                      workdir, in_process=True)
    said8, wall8 = dict(json.loads(out8.strip().splitlines()[-1]), attention_kernel_launches=cuda_mha.LAUNCHES - mha_0), \
        time.perf_counter() - t8
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
        f"half a quantization step (+{max(off.max(), 0):.1e}) of the f32 bag; featurize --format int8 in process {wall8:.1f} s")
    profiled = phase_featurize_profiled(weights, imgs_b[:batch_size], workdir, gpu)
    log(f"phase 5 featurize: {said['patches']} tiles in {said['batches']} batches of {batch_size}, attention kernel "
        f"launches {said['attention_kernel_launches']} (= {depth} x batches), {said['patches_per_s']:.1f} tiles/s by the "
        f"CLI's own clock (first-call setup included), child process {wall:.1f} s; in process {batch_ms:.2f} ms per "
        f"batch = {batch_size / batch_ms * 1e3:.1f} tiles/s [{gpu}]")
    return dict(launches=said["attention_kernel_launches"], batches=said["batches"], worst=worst,
                cli_tiles_s=said["patches_per_s"], batch_ms=batch_ms, batch_size=batch_size, depth=depth,
                profiled=profiled)


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


def streamed_ds_block(dt: torch.dtype, g: torch.Generator):
    """A downsample block that is no ResNet-50 block (Cin 1024, width 128,
    stride 2), with seeded weights on the card: its A rows x[::2, ::2, :]
    do not fit next to the output tile in shared memory, so KS streams them
    through the ring once a column group, the path no ResNet-50 block takes.
    Returns the operands and an input x [2, 16, 16, 1024]."""
    from toad_tpu_torch.ops import fused_stage as fs

    dev = torch.device("cuda")

    def w(*shape):
        return (torch.randn(*shape, device=dev, generator=g) / shape[-2] ** 0.5).to(dt)

    def b(n):
        return torch.randn(n, device=dev, generator=g) * 0.1

    ops = fs.BlockOperands(w(1024, 128), b(128), w(9, 128, 128), b(128), w(128, 512), b(512), w(1024, 512), b(512))
    return ops, torch.relu(torch.randn(2, 16, 16, 1024, device=dev, generator=g)).to(dt)


@restores_tf32
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
                first, rest = fs.plan(dt, width, stride), fs.plan(dt, width, 1)
                log(f"phase 9 compare stage {name} {str(dt)[6:]} B={b} x {tuple(x.shape)} -> {tuple(got.shape)}: max abs "
                    f"err {err:.3e} = {err / scale:.2e} of the largest |output| {scale:.1f} (tolerance {tol:g} of it); "
                    f"plans: first block {first}, {first.tiles(*got.shape[1:3])} tiles an image; the others {rest}, "
                    f"{rest.tiles(*got.shape[1:3])} tiles an image")
                if dt == torch.bfloat16:
                    worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, err / scale)
                x = want
    for dt, tol in ((torch.bfloat16, TOL_STAGE_BF16), (torch.float32, TOL_STAGE_F32)):
        ops, x = streamed_ds_block(dt, g)
        with torch.inference_mode():
            got, want = fs.stage_block(ops, x, 2), fs.plain_block(ops, x, 2)
        torch.cuda.synchronize()
        scale = float(want.float().abs().max())
        err = check_close(f"stage streamed downsample {str(dt)[6:]}", got, want, dict(atol=tol * scale, rtol=0.0))
        log(f"phase 9 compare stage: a downsample block streamed through the ring (Cin 1024, width 128, stride 2, "
            f"{str(dt)[6:]}, x {tuple(x.shape)}): max abs err {err:.3e} = {err / scale:.2e} of the largest |output| "
            f"{scale:.1f} (tolerance {tol:g} of it)")
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
    log(f"phase 9: {time.perf_counter() - t0:.1f} s")
    return dict(launches=driven["launches"], worst=worst_abs, worst_rel=worst_rel, times=times, featurized=featurized)


def traced_kernels(fn, tries: int = 3) -> list[dict]:
    """The device kernels (``name``, ``ts`` and ``dur`` in us) of one call of
    ``fn``, from a torch.profiler trace of that call alone (its Chrome trace's
    ``kernel`` events). A trace that caught no device activity at all is
    taken again, up to ``tries`` calls (the profiler's activity buffers now
    and then come back empty); AssertionError if every one was empty."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory(prefix="toad_trace_") as tmp:
            prof.export_chrome_trace(str(Path(tmp) / "trace.json"))
            with open(Path(tmp) / "trace.json") as f:
                events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("ph") == "X" and e.get("cat") == "kernel"]
        if kernels:
            return kernels
    raise AssertionError(f"{tries} profiler traces of one call held no device kernel")


def one_call_kernels(fn) -> list[str]:
    """The names of the device kernels one call of ``fn`` ran (after a warm-up call)."""
    fn()
    torch.cuda.synchronize()
    return [e["name"] for e in traced_kernels(fn)]


def drive_bag_sharded(model, seed: int) -> dict:
    """The main path of the one-launch sharded pool: ``bag_sharded_pool`` as
    a caller uses it (the params dict, bf16 compute) on one bag of 163,840
    rows in 4 shards, and on B=4 bags of 40,960 rows sliced out of a batch
    of 81,920 (read in place) in 4 shards. Each call must be one launch, no
    K1p launch and no combine; the kernels' counts are set to 0 just before
    and read just after. Then a profiler's list of the device kernels of one
    call each of K1, K1p (on a slice) and the sharded pool: one kernel each."""
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.fused_pool import plain_pool
    from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 4)
    n_shards = 4
    x = torch.randn(1, 163_840, 1024, device=dev, generator=g).bfloat16()
    mask = torch.zeros(1, 163_840, device=dev)
    mask[0, :150_000] = 1.0
    batch = torch.randn(4, 81_920, 1024, device=dev, generator=g).bfloat16()
    batch_mask = (torch.rand(4, 81_920, device=dev, generator=g) < 0.9).float()
    batch_mask[1, 30_000:] = 0.0  # bag 1: its slice's last shards are padding
    sl = slice(20_480, 61_440)
    cases = (("B=1 N=163,840", x, mask), ("B=4 N=40,960 (rows 20,480..61,440 of a batch, read in place)",
                                           batch[:, sl], batch_mask[:, sl]))
    params = model.pool_params()
    with torch.inference_mode():
        cuda_pool.PARTIAL_LAUNCHES = cuda_pool.COMBINE_LAUNCHES = cuda_pool.SHARDED_LAUNCHES = 0
        lib0 = cuda_pool.library_launches()
        pooled = [bag_sharded_pool(params, xc, mc, n_shards, compute_dtype=torch.bfloat16) for _, xc, mc in cases]
        torch.cuda.synchronize()
        counts = dict(sharded=cuda_pool.SHARDED_LAUNCHES, partial=cuda_pool.PARTIAL_LAUNCHES,
                      combine=cuda_pool.COMBINE_LAUNCHES, library=cuda_pool.library_launches() - lib0)
        errs = []
        for (label, xc, mc), m in zip(cases, pooled):
            ref, _ = plain_pool(params, xc, mc, torch.bfloat16, with_scores=False)
            errs.append(check_close(f"bag_sharded_pool (main path) {label} vs plain_pool", m, ref, TOL_BF16_M))
        ops = model.kernel_operands(torch.bfloat16)
        listed = {"K1": one_call_kernels(lambda: cuda_pool.pool(ops, x, mask, False)),
                  "K1p": one_call_kernels(lambda: cuda_pool.pool_partial(ops, batch[:, sl], batch_mask[:, sl])),
                  "sharded": one_call_kernels(lambda: cuda_pool.pool_sharded(ops, x, mask, n_shards))}
    if counts != dict(sharded=len(cases), partial=0, combine=0, library=len(cases)):
        raise AssertionError(f"bag_sharded_pool in {n_shards} shards, {len(cases)} calls, launched {counts}")
    if any(len(names) != 1 or "pool_kernel" not in names[0] for names in listed.values()):
        raise AssertionError(f"one call each, the device kernels the profiler listed: {listed}")
    log(f"phase 3 bag_sharded_pool main path, bf16 in {n_shards} shards: " + "; ".join(
        f"{label}: max abs err vs plain_pool {e:.2e}" for (label, _, _), e in zip(cases, errs))
        + f" (tolerance {TOL_BF16_M}); {len(cases)} calls launched the sharded pool {counts['sharded']} times, K1p "
        f"{counts['partial']}, the combine {counts['combine']}, the library {counts['library']} kernels in all; "
        "the profiler's device kernels of one call: " + "; ".join(f"{k} {v}" for k, v in listed.items()))
    return dict(counts, worst=max(errs))


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
    # the .npy cohort goes through the native feed under --native_io auto: every train, val and final pass says so
    feeds = [w for ln in lines if " feed " in ln for w in re.findall(r"(?:feed|val|test) (native|numpy)\b", ln)]
    if len(feeds) != 2 * len(train_losses) + 2 or set(feeds) != {"native"}:
        raise AssertionError(f"{label}: the trainer's passes did not all run the native feed: {feeds}")
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
        f"{', '.join(f'{r:.1f} ({w})' for r, w in rates)}; every pass ran the native feed ({len(feeds)} logged); "
        f"child process {wall:.1f} s [{gpu}]")
    return dict(launches=launches, eval_batches=eval_batches, rates=rates, wall=wall)


@restores_tf32
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


def write_cohort(seed: int, workdir: Path) -> dict:
    """Phase 7's seeded dataset at TOAD's full width (manifest, .npy bags, task
    JSON, one fold's split file) in ``workdir``. It runs on a thread while
    phases 10 and 11 keep the card busy: numpy's draws and ``np.save`` release
    the GIL, and those phases' rates are the card's. Returns the dataset, its
    splits and what phase 7 logs about it."""
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
    note = (f"phase 7 train: {ds.n_slides} slides of 2,000-30,000 patches x 1024 ({n_bytes / 1e9:.2f} GB of .npy bags, "
            f"18 origins with at least {per_class.min()} slides each; manifest seed {manifest_seed}), one fold: train "
            f"{len(spec.train)} / val {len(spec.val)} / test {len(spec.test)}; written in {time.perf_counter() - t0:.1f} s "
            f"on a thread beside phases 10 and 11")
    return dict(dataset=ds, train_split=train_split, test_split=test_split, note=note)


def write_fixtures(seed: int, train_dir: Path, probe_dir: Path) -> dict:
    """The data phases 7 and 15 read, written on the smoke's writer thread:
    phase 7's cohort (:func:`write_cohort`), then the disk-fed probes' fixture
    (``write_io_fixture``, which phase 15 then finds in place)."""
    from toad_tpu_torch.data.synthetic import write_io_fixture
    from toad_tpu_torch.experiments import io_overlap_probe as iop

    cohort = write_cohort(seed, train_dir)
    write_io_fixture(probe_dir, iop.N_SLIDES, iop.BAG_N, iop.DIM)
    return cohort


def phase_train(seed: int, card: str, gpu: str, workdir: Path, cohort: dict) -> dict:
    """The training path at TOAD's full width on the seeded dataset
    :func:`write_cohort` wrote in ``workdir``: ``python -m toad_tpu_torch
    train`` in a child process (f32 with early stopping and resume, then a
    shorter bf16 run with dropout)."""
    import dataclasses as dc

    from toad_tpu_torch.config import ModelConfig

    log(cohort["note"])
    ds, train_split, test_split = cohort["dataset"], cohort["train_split"], cohort["test_split"]
    cfg32 = ModelConfig(in_dim=1024, n_classes=18)
    lines, wall = run_train(workdir, "smoke_f32", ["--max_epochs", "2", "--early_stopping", "--resume"])
    main_run = check_train_run("f32, early stopping, resume", lines, workdir / "results" / "smoke_f32_s1", card, gpu,
                               cfg32, test_split, wall)
    lines, wall = run_train(workdir, "smoke_bf16", ["--max_epochs", "1", "--bf16", "--drop_out"])
    check_train_run("bf16, dropout", lines, workdir / "results" / "smoke_bf16_s1", card, gpu,
                    dc.replace(cfg32, compute_dtype="bfloat16", dropout=True), test_split, wall)
    check_step_against_cpu(train_split, cfg32, seed)
    return dict(main_run, dataset=ds, test_split=test_split, model_cfg=cfg32)


EVAL_COLUMNS = ["slide_id", "sex", "Y", "Y_hat", "site", "site_hat", *[f"p_{c}" for c in range(18)], "site_p"]
TOL_EVAL_INT8_VS_F32 = 0.02  # eval --int8 probabilities vs eval in f32: the quantization budget of tests/test_int8.py
TOL_EVAL_WIRE_VS_DEVICE = 1e-6  # eval --int8: int8 wire vs rows quantized on the card (the quantizers are twins)
TOL_EVAL_REPEAT = 1e-6  # a second evaluate_split pass in one process against the first: the same inputs and kernel
TOL_EVAL_CARD_VS_CPU = 1e-4  # evaluate_split on the card (K1, f32) vs on the CPU (plain version, f32): summation order


def read_csv_rows(path: Path) -> list[dict]:
    import csv as csv_mod

    with open(path, newline="") as f:
        return list(csv_mod.DictReader(f))


def run_eval(workdir: Path, models: str, save_code: str, extra: list[str], in_process: bool = False) -> dict:
    """``python -m toad_tpu_torch eval`` as a user runs it, in a child process
    in ``workdir`` (or its ``main(argv)`` in this process with ``workdir`` as
    the current directory: the same command without a child's start-up).
    Returns what its own lines report (batches, launches by kernel, each
    pass's bags, seconds, slides/s, data-wait share, wire, bytes and feed;
    peak device memory) and its output directory."""
    import contextlib
    import re

    args = ["eval", "--task", str(workdir / "tasks" / "dummy_mtl_concat.json"), "--data_root_dir", str(workdir / "bags"),
            "--results_dir", str(workdir / "results"), "--models_exp_code", models, "--save_exp_code", save_code, "--k", "1",
            "--batch_size", "4", *extra]
    t0 = time.perf_counter()
    if in_process:
        with contextlib.chdir(workdir):  # eval writes ./eval_results under the current directory
            stdout, _ = run_cli(args, workdir, in_process=True)
    else:
        stdout, _ = run_cli(args, workdir)
    wall = time.perf_counter() - t0
    counts = re.search(r"\[fold 0\] eval batches (\d+), pooling kernel launches (\d+) \(float kernel (\d+), int8 kernel (\d+)\), "
                       r"peak device memory (\S+) GB on (.+)", stdout)
    passes = [dict(what=m.group(1), bags=int(m.group(2)), seconds=float(m.group(3)), rate=float(m.group(4)),
                   wait=m.group(5), wire=m.group(6), bytes=int(m.group(7)), feed=m.group(8))
              for m in re.finditer(r"\[fold 0\] (\w+) pass: (\d+) bags in (\S+) s, (\S+) slides/s \(data wait (\S+)\), "
                                   r"wire (\w+), (\d+) bytes to the device, feed (\w+)", stdout)]
    if counts is None or not passes:
        raise AssertionError(f"eval {extra}: no batch, launch or pass line in its output:\n{stdout[-3000:]}")
    return dict(batches=int(counts.group(1)), launches=int(counts.group(2)), k1=int(counts.group(3)), k2=int(counts.group(4)),
                peak_gb=float(counts.group(5)), card=counts.group(6).strip(), passes=passes, wall=wall,
                out=workdir / "eval_results" / f"EVAL_{save_code}", stdout=stdout,
                where="in process" if in_process else "child process")


def check_native_feed(label: str, ev: dict) -> None:
    """Every pass of an ``eval`` child ran the native feed (the .npy cohort
    under the engine's native='auto')."""
    if any(p["feed"] != "native" for p in ev["passes"]):
        raise AssertionError(f"eval ({label}): a pass did not run the native feed: {[p['feed'] for p in ev['passes']]}")


def check_eval_run(label: str, ev: dict, kernel: str, trainer_summary: Path | None, test_ids: list[str], card: str, gpu: str) -> np.ndarray:
    """One ``eval`` run on the test split: schema and order of fold_0.csv,
    launches of the right kernel = eval batches, every pass through the
    native feed, and (given the trainer's summary.csv) the trainer's own test
    accuracy and AUC. Returns the probabilities [N, 19] (classes, then site_p)."""
    check_native_feed(label, ev)
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
        f"CLI's clock, wire {p['wire']}, feed {p['feed']}, {p['bytes']} bytes to the card, peak device memory {ev['peak_gb']:.2f} GB; {ev['where']} "
        f"{ev['wall']:.1f} s [{gpu}]")
    return probs


def phase_eval(trained: dict, card: str, gpu: str, workdir: Path) -> dict:
    """The evaluation path at TOAD's full width on phase 7's dataset, fold and
    results dirs: ``eval`` in f32 and int8 (the int8 wire) as child processes,
    one run in bf16 with calibration and bootstrap intervals, ``report``, and
    the engine on the card against the engine on the CPU."""
    import math

    from toad_tpu_torch.evaluate.engine import evaluate_checkpoint
    from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8

    test_split = trained["test_split"]
    test_ids = [str(s) for s in test_split.slide_ids]
    results = workdir / "results"

    ev32 = run_eval(workdir, "smoke_f32_s1", "f32", [])
    p32 = check_eval_run("f32", ev32, "float", results / "smoke_f32_s1" / "summary.csv", test_ids, card, gpu)
    ev8 = run_eval(workdir, "smoke_f32_s1", "int8", ["--int8"], in_process=True)
    p8 = check_eval_run("int8, int8 wire", ev8, "int8", None, test_ids, card, gpu)
    wires = {k: e["passes"][0]["wire"] for k, e in (("f32", ev32), ("int8", ev8))}
    if wires != dict(f32="float32", int8="int8"):
        raise AssertionError(f"eval: the batcher's wires were {wires}")
    d_q = float(np.abs(p8 - p32).max())
    if d_q > TOL_EVAL_INT8_VS_F32:
        raise AssertionError(f"eval --int8: probabilities differ from the f32 run's by {d_q:.3e} (tolerance {TOL_EVAL_INT8_VS_F32})")
    b32, b8 = (e["passes"][0]["bytes"] for e in (ev32, ev8))
    log(f"phase 8 eval --int8: every probability within {d_q:.2e} of the f32 run's (tolerance {TOL_EVAL_INT8_VS_F32}); bytes to "
        f"the card f32 {b32}, int8 {b8} ({b32 / b8:.2f}x fewer) [{gpu}]")

    # what `eval --int8 --transfer_dtype float32` runs, in process (no child's start-up): the float32 wire, rows
    # quantized on the card (quantize_rows), then K2; the same checkpoint, split, batch and default bucket ladder
    ckpt = results / "smoke_f32_s1" / "s_0_checkpoint.pt"
    k1_0, k2_0 = cuda_pool.LAUNCHES, cuda_pool_int8.LAUNCHES
    torch.cuda.reset_peak_memory_stats()
    on_dev = evaluate_checkpoint(ckpt, test_split, trained["model_cfg"], batch_size=4, int8=True, transfer_dtype="float32")
    peak_dev = torch.cuda.max_memory_allocated() / 1e9
    k1_d, k2_d = cuda_pool.LAUNCHES - k1_0, cuda_pool_int8.LAUNCHES - k2_0
    n_dev = on_dev.stats["n_batches"]
    if on_dev.stats["transfer_dtype"] != "float32" or k1_d or k2_d != n_dev or n_dev < 1 \
            or [str(s) for s in on_dev.df["slide_id"]] != test_ids:
        raise AssertionError(f"int8 eval on the float32 wire: wire {on_dev.stats['transfer_dtype']}, {n_dev} batches, "
                             f"float kernel launches {k1_d}, int8 kernel launches {k2_d}")
    d_w = float(np.abs(on_dev.probs() - p8[:, :18]).max())
    d_w = max(d_w, float(np.abs(np.asarray(on_dev.df["site_p"]) - p8[:, 18]).max()))
    if d_w > TOL_EVAL_WIRE_VS_DEVICE:
        raise AssertionError(f"eval --int8: int8 wire vs rows quantized on the card differ by {d_w:.3e} "
                             f"(tolerance {TOL_EVAL_WIRE_VS_DEVICE})")
    log(f"phase 8 int8 eval, float32 wire, rows quantized on the card (in process, as `eval --int8 --transfer_dtype float32`): "
        f"eval batches {n_dev} = int8 kernel launches {k2_d}, float kernel {k1_d}; vs the int8 wire's probabilities {d_w:.1e} "
        f"(tolerance {TOL_EVAL_WIRE_VS_DEVICE}: the quantizers are exact twins); {on_dev.stats['n'] / on_dev.stats['seconds']:.1f} "
        f"slides/s, {on_dev.stats['wire_bytes']} bytes to the card, peak device memory {peak_dev:.2f} GB [{gpu}]")

    # once with everything around the pass, on the bf16 run's checkpoint (dropout layout) in bf16: the whole
    # dataset, a temperature from the val split, bootstrap intervals
    ev_all = run_eval(workdir, "smoke_bf16_s1", "all", ["--bf16", "--drop_out", "--split", "all", "--calibrate", "--bootstrap", "200"],
                      in_process=True)
    check_native_feed("bf16, --split all", ev_all)
    if ev_all["k1"] != ev_all["batches"] or ev_all["k2"] or [p["what"] for p in ev_all["passes"]] != ["eval", "val"] \
            or ev_all["passes"][0]["wire"] != "bfloat16" or ev_all["card"] != card:
        raise AssertionError(f"eval --bf16 --split all --calibrate: {ev_all['batches']} batches, {ev_all['k1']} launches, passes "
                             f"{ev_all['passes']} on {ev_all['card']}")
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
    log(f"phase 8 eval --bf16 --drop_out --split all --calibrate --bootstrap 200 (the bf16 run): {n_all} slides, {ev_all['batches']} batches = pooling kernel launches "
        f"{ev_all['k1']}; temperature {t:.3f} (ece {calib['ece_before']:.4f} -> {calib['ece_after']:.4f}); intervals bracket their "
        f"points (cls auc {float(summary['cls_test_auc']):.4f} in [{cis['cls_auc']['lo']:.4f}, {cis['cls_auc']['hi']:.4f}]); report: "
        f"n_folds 1 and the summary's means; eval pass {pa['rate']:.1f} slides/s (data wait {pa['wait']}), val pass {pv['rate']:.1f} "
        f"slides/s (data wait {pv['wait']}), wire bfloat16; {ev_all['where']} {ev_all['wall']:.1f} s [{gpu}]")

    # in process: the engine on the card against the engine on the CPU, the same checkpoint and bags (cut to 8,192 rows)
    kw = dict(batch_size=4, max_bag_size=8192)
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
    if d_again > TOL_EVAL_REPEAT or (pinned_first is not None and pinned_second > pinned_first):
        raise AssertionError(f"a second eval pass in one process: probabilities differ by {d_again:.3e}, "
                             f"pinned host memory {pinned_first} -> {pinned_second} bytes")
    leftover = [t.name for t in threading.enumerate() if t.name == "bag-prefetch"]
    if leftover:
        raise AssertionError(f"producer threads left after the eval passes: {leftover}")
    on_cpu = evaluate_checkpoint(ckpt, test_split, trained["model_cfg"], device="cpu", **kw)
    d_cpu = max(float(np.abs(on_card.probs() - on_cpu.probs()).max()), float(np.abs(on_card.df["site_p"] - on_cpu.df["site_p"]).max()))
    feeds = {name: r.stats["feed"] for name, r in (("int8 on the float32 wire", on_dev), ("card", on_card),
                                                    ("card again", again), ("cpu", on_cpu))}
    if set(feeds.values()) != {"native"}:
        raise AssertionError(f"evaluate_split in process did not run the native feed: {feeds}")
    if d_cpu > TOL_EVAL_CARD_VS_CPU or list(on_card.df["slide_id"]) != list(on_cpu.df["slide_id"]):
        raise AssertionError(f"evaluate_split on the card vs the CPU: probabilities differ by {d_cpu:.3e} (tolerance {TOL_EVAL_CARD_VS_CPU})")
    log(f"phase 8 evaluate_split, card vs CPU (f32, {len(test_ids)} bags cut to 8,192 rows, batch 4): probabilities differ by at most "
        f"{d_cpu:.2e} (tolerance {TOL_EVAL_CARD_VS_CPU}); cls auc {on_card.cls_auc:.4f} vs {on_cpu.cls_auc:.4f}; a second pass on "
        f"the card gives the same probabilities (|d| {d_again:.1e}) and leaves pinned host memory at {pinned_first} -> {pinned_second} bytes (the first "
        f"ring's slots are reused), no producer thread left; every in-process pass ran the native feed")
    compare_feeds(test_split, gpu)
    time_feeds(trained["dataset"].subset(range(trained["dataset"].n_slides)), gpu)
    runs = dict(f32=ev32, int8=ev8, all=ev_all)
    return dict(k1_f32_launches=ev32["k1"], k1_bf16_launches=ev_all["k1"], k2_launches=ev8["k2"] + k2_d, runs=runs)


_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int8: torch.int8}


def compare_feeds(split, gpu: str) -> None:
    """The native feed against the numpy feed on the card, for each wire: a
    BagBatcher over ``split`` with native='on' and one with native='off', the
    batches taken side by side once their copies have landed; the same order
    and metadata, and every plane (features, int8 scales, patch mask) equal
    bit for bit (compared on the card as integers). No tolerance: the two
    feeds must give the same bytes."""
    from toad_tpu_torch.data.batching import BagBatcher

    said = []
    for wire in ("float32", "bfloat16", "int8"):
        kw = dict(batch_size=4, mode="sequential", transfer_dtype=wire, device="cuda")
        on, off = BagBatcher(split, native="on", **kw), BagBatcher(split, native="off", **kw)
        n = placed = 0
        t0 = time.perf_counter()
        for a, b in itertools.zip_longest(on, off):
            if a is None or b is None:
                raise AssertionError(f"feeds, {wire} wire: native and numpy give different numbers of batches")
            a.wait()
            b.wait()
            for name in ("bag_mask", "label", "site", "sex", "indices"):
                if not np.array_equal(getattr(a, name), getattr(b, name)):
                    raise AssertionError(f"feeds, {wire} wire, batch {n}: {name} differs (native {getattr(a, name)}, "
                                         f"numpy {getattr(b, name)})")
            for name in ("features", "scales", "patch_mask"):
                x, y = getattr(a, name), getattr(b, name)
                if (x is None) != (y is None):
                    raise AssertionError(f"feeds, {wire} wire, batch {n}: {name} on one side only")
                if x is None:
                    continue
                x, y = (torch.as_tensor(t).cuda() for t in (x, y))  # a batch above the feed's guard stays on the host
                if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x.view(_BITS[x.dtype]), y.view(_BITS[y.dtype])):
                    raise AssertionError(f"feeds, {wire} wire, batch {n}: {name} differs ({x.dtype} {tuple(x.shape)} "
                                         f"against {y.dtype} {tuple(y.shape)})")
            placed += int(getattr(a.features, "is_cuda", False))
            n += 1
        if (on.feed_kind, off.feed_kind) != ("native", "numpy") or not placed:
            raise AssertionError(f"feeds, {wire} wire: feeds {on.feed_kind} / {off.feed_kind}, {placed} batches placed by the "
                                 "native feed")
        said.append(f"{wire} {n} batches ({placed} packed into the pinned ring) in {time.perf_counter() - t0:.1f} s")
    log(f"phase 8 feeds: BagBatcher native='on' against native='off' on the card over the test split's {len(split)} bags, "
        f"batch 4: the same order and metadata, features, scales and patch mask equal bit for bit; {'; '.join(said)} [{gpu}]")


def time_feeds(split, gpu: str) -> dict:
    """The producer's own rate: one pass over ``split`` on the card per run,
    the consumer only waiting for each batch's copy event, numpy then
    native, on the float32 wire (the bfloat16 wire's bits are
    held to the numpy feed's by :func:`compare_feeds`); batches/s and the
    wire's GB/s. The bags were written in
    phase 7, so both feeds read a warm page cache; a cold read is not
    measured."""
    from toad_tpu_torch.data.batching import BagBatcher

    rec: dict = {}
    for wire in ("float32",):
        for mode in ("off", "on"):
            batcher = BagBatcher(split, batch_size=4, mode="sequential", transfer_dtype=wire, device="cuda", native=mode)
            n = wire_bytes = 0
            t0 = time.perf_counter()
            for b in batcher:
                if b.ready is not None:
                    b.ready.synchronize()
                n += 1
                wire_bytes += b.wire_bytes
            dt = time.perf_counter() - t0
            if batcher.feed_kind != ("native" if mode == "on" else "numpy"):
                raise AssertionError(f"producer rate, {wire} wire, native={mode}: the {batcher.feed_kind} feed ran")
            rec.setdefault(wire, []).append((batcher.feed_kind, n / dt, wire_bytes / dt / 1e9, dt, n))
        runs = rec[wire]
        best = {k: max(r[1] for r in runs if r[0] == k) for k in ("numpy", "native")}
        log(f"phase 8 producer rate, {wire} wire, {len(split)} bags at batch 4 ({runs[0][4]} batches; the consumer only waits for "
            f"each batch's copy; warm page cache, a cold read not measured): " + ", ".join(
                f"{k} {r:.2f} batches/s {g:.2f} GB/s ({t:.2f} s)" for k, r, g, t, _ in runs)
            + f"; native / numpy {best['native'] / best['numpy']:.2f}x [{gpu}]")
    return rec


def phase_timing_train(gpu: str, seed: int) -> dict:
    """K1p, the one-launch sharded pool and the combine (its mesh form)
    against their plain versions, the sharded pool in 4 and 8 shards against
    K1 in one launch on the same rows, K1 at predict's B=1 x 8,192, and the
    train step (forward + backward + Adam)."""
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
            label, flops = f"partial pool {kind} B=1 N={per} D=1024 (one shard of {n_shards})", \
                cuda_pool.flops_per_row(1024, 512, 384) * per
            out[("partial_" + kind, 1)] = time_pair(
                label, lambda: plain_pool_partial(params, xs, ms, dt), lambda: cuda_pool.pool_partial(ops, xs, ms),
                dict(bytes=nbytes(xs, ms, *ops) + (2 * 512 + 4) * 4, ops=pool_ops(dt, flops)), gpu)
            if dt == torch.float32:
                log_ffma_bound(label, out[("partial_" + kind, 1)], flops, gpu)
            # the sharded pool (one launch over every shard, the merge at its end) against K1 in one launch on the
            # same bag, in turns; its record times it against plain_pool on the whole bag (the same function)
            label, flops = f"sharded pool {kind} B=1 N={n} D=1024 in {n_shards} shards (one launch)", \
                cuda_pool.flops_per_row(1024, 512, 384) * n
            out[("sharded_pool_" + kind, 1)] = time_pair(
                label, lambda: plain_pool(params, x, mask, dt, False), lambda: bag_sharded_pool(ops, x, mask, n_shards),
                dict(bytes=nbytes(x, mask, *ops) + 2 * 512 * 4, ops=pool_ops(dt, flops)), gpu)
            t_whole = cuda_ms(lambda: cuda_pool.pool(ops, x, mask, False))
            t_shard = cuda_ms(lambda: bag_sharded_pool(ops, x, mask, n_shards))
            t_shard8 = cuda_ms(lambda: bag_sharded_pool(ops, x, mask, 8))
            t_shard8b = cuda_ms(lambda: bag_sharded_pool(ops, x, mask, 8))
            t_shardb = cuda_ms(lambda: bag_sharded_pool(ops, x, mask, n_shards))
            t_whole2 = cuda_ms(lambda: cuda_pool.pool(ops, x, mask, False))
            whole, s4, s8 = min(t_whole, t_whole2), min(t_shard, t_shardb), min(t_shard8, t_shard8b)
            log(f"phase 6 timing bag_sharded_pool {kind} B=1 N={n}, one launch each: {n_shards} shards {s4:.3f} ms "
                f"({t_shard:.3f}/{t_shardb:.3f}) = x{s4 / whole:.3f} K1, 8 shards {s8:.3f} ms ({t_shard8:.3f}/"
                f"{t_shard8b:.3f}) = x{s8 / whole:.3f} K1; K1 in one launch {whole:.3f} ms ({t_whole:.3f}/{t_whole2:.3f}), "
                f"plain_pool {out[('sharded_pool_' + kind, 1)]['plain_ms']:.3f} ms [{gpu}]")
            out[("sharded_" + kind, 1)] = dict(shards4=s4, shards8=s8, whole=whole)
            del x
            # K1 at predict's shape, one bag of 8,192 rows (phase 6's pool timing has B=1 x 65,536)
            xp, mp = torch.randn(1, 8192, 1024, device=dev).to(dt), torch.ones(1, 8192, device=dev)
            t_c, t_s = cuda_ms(lambda: cuda_pool.pool(ops, xp, mp, False)), cuda_ms(lambda: cuda_pool.pool(ops, xp, mp, True))
            log(f"phase 6 timing K1 {kind} B=1 N=8192 (predict's shape): classification {t_c:.4f} ms, scored "
                f"{t_s:.4f} ms [{gpu}]")
            out[("k1_8192_" + kind, 1)] = dict(classification=t_c, scored=t_s)
            del xp
        acc = torch.randn(n_shards, 1, 2, 512, device=dev)
        stats = torch.stack([torch.randn(n_shards, 1, 2, device=dev), torch.rand(n_shards, 1, 2, device=dev) + 1.0], dim=2)
        out[("combine", 1)] = time_pair(
            f"shard combine (the mesh's, a launch of its own) S={n_shards} B=1 H=512",
            lambda: plain_combine_partial_pool(acc, stats),
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


# Phase 12: slide inference (ROADMAP item 1.3). predict's probabilities vs phase 8's eval of the same checkpoint:
# the same K1 f32 on the same rows, in other batches and buckets (f32 summation order, 3xTF32 products)
TOL_PREDICT_VS_EVAL = 1e-4
TOL_INFER_REPEAT = 1e-6  # infer's exported attention vs SlideInference in process: the same kernel on the same bag
TOL_INFER_VS_PLAIN = 1e-4  # infer's raw attention vs the plain forward's on the card, of the largest |score| (f32)
TOL_PATCHES_VS_BAG = 2e-5  # infer --patches vs the bag featurize wrote from the same tiles (tests/test_pipeline.py)


def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit RGB PNG (the stdlib writer of toad_tpu_torch.pipeline.heatmap,
    what runs where Pillow is absent, writes its rows unfiltered; Pillow
    filters them) -> [H, W, 3] uint8, with zlib and the header; each chunk's
    CRC checked."""
    import struct
    import zlib

    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("not a PNG")
    pos, idat, header = 8, b"", None
    while pos < len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0] != zlib.crc32(tag + body):
            raise AssertionError(f"PNG chunk {tag} fails its CRC")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    w, h, depth, color, _, _, interlace = header
    if (depth, color, interlace) != (8, 2, 0):
        raise AssertionError(f"PNG of depth {depth}, colour type {color}, interlace {interlace}: not 8-bit RGB")
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 3 * w + 1).astype(np.int32)
    out = np.zeros((h + 1, 3 * w + 3), np.int32)  # a zero row above and 3 zero bytes left of every row
    for y in range(h):
        kind, line = raw[y, 0], raw[y, 1:]
        up = out[y, 3:]
        if kind in (0, 2):  # None, Up
            out[y + 1, 3:] = (line + (up if kind == 2 else 0)) & 255
            continue
        if kind not in (1, 3, 4):
            raise AssertionError(f"PNG row filter {kind}")
        for x in range(3 * w):  # Sub, Average, Paeth: each byte depends on the one 3 to its left
            a, b, cc = out[y + 1, x], up[x], out[y, x]
            if kind == 1:
                pred = a
            elif kind == 3:
                pred = (a + b) // 2
            else:
                pa, pb, pc = abs(b - cc), abs(a - cc), abs(a + b - 2 * cc)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else cc)
            out[y + 1, x + 3] = (line[x] + pred) & 255
    return out[1:, 3:].astype(np.uint8).reshape(h, w, 3)


def run_cli(args: list[str], workdir: Path, in_process: bool = False) -> tuple[str, str]:
    """(stdout, stderr) of ``python -m toad_tpu_torch ARGS``: a child process as
    a user runs it, or ``main(argv)`` of the command's module in this process."""
    import contextlib
    import importlib
    import io

    if in_process:
        from toad_tpu_torch.__main__ import COMMANDS

        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            importlib.import_module(COMMANDS[args[0]][0]).main(args[1:])
        return out.getvalue(), err.getvalue()
    run = subprocess.run([sys.executable, "-m", "toad_tpu_torch", *args], capture_output=True, text=True,
                         env=child_env(), cwd=workdir, timeout=600)
    if run.returncode != 0:
        raise AssertionError(f"{args[0]} failed ({run.returncode}):\n{run.stdout[-3000:]}{run.stderr[-3000:]}")
    return run.stdout, run.stderr


@restores_tf32
def phase_infer(model, trained: dict, evaluated: dict, card: str, gpu: str, workdir: Path, resnet_dir: Path) -> dict:
    """Slide inference (``predict``, ``infer``, ``heatmap``), inside phase 7's
    work directory on its two checkpoints and .npy cohort, and in phase 9's
    directory for ``infer --patches``. Returns the launches of this phase's
    main path by kernel, and its timings."""
    import re

    from toad_tpu_torch.cli.common import label_names
    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.data.bags import load_bag
    from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
    from toad_tpu_torch.pipeline.heatmap import canvas_shape, render_heatmap
    from toad_tpu_torch.pipeline.infer import SlideInference

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain forward below in full f32
    t0 = time.perf_counter()
    split = trained["test_split"]
    ids = [str(s) for s in split.slide_ids]
    sexes = [split.record(i).sex for i in range(len(ids))]
    ckpt32 = workdir / "results" / "smoke_f32_s1" / "s_0_checkpoint.pt"
    ckpt16 = workdir / "results" / "smoke_bf16_s1" / "s_0_checkpoint.pt"
    task = str(workdir / "tasks" / "dummy_mtl_concat.json")
    cfg = ModelConfig(in_dim=1024, n_classes=18)
    (workdir / "predict_manifest.csv").write_text("slide_id,sex\n" + "".join(f"{s},{x}\n" for s, x in zip(ids, sexes)))
    # one slide of the test split with a coords sidecar (the cohort has none), for infer's heatmap
    slide, bag = ids[0], split.bag_file(0)
    n_rows = np.load(bag, mmap_mode="r").shape[0]
    side = int(np.ceil(np.sqrt(n_rows)))
    coords = (np.stack([np.arange(n_rows) % side, np.arange(n_rows) // side], axis=1) * 256).astype(np.int64)
    sidecar = bag.with_suffix(".coords.npy")
    if not sidecar.exists():
        np.save(sidecar, coords)
    coords = np.load(sidecar)

    # predict, a child process: its stderr line says its slides/s and the kernels it launched
    out, err = run_cli(["predict", "--ckpt", str(ckpt32), "--data_dir", str(workdir / "bags"), "--csv",
                        str(workdir / "predict_manifest.csv"), "--task", task, "--out", str(workdir / "preds.csv")], workdir)
    said = re.search(r"predict: (\d+) slides in (\S+) s, (\S+) slides/s on (.+); pooling kernel launches (\d+) \(float kernel "
                     r"(\d+), (\d+) in scored mode; int8 kernel (\d+), (\d+) in scored mode\)", err)
    if said is None:
        raise AssertionError(f"predict: no rate or launch line on stderr:\n{err[-2000:]}")
    n_said, secs, rate, on, _, k1, k1_scored, k2, _ = said.groups()
    rows = read_csv_rows(workdir / "preds.csv")
    evals = {r["slide_id"]: r for r in read_csv_rows(evaluated["runs"]["f32"]["out"] / "fold_0.csv")}
    if [r["slide_id"] for r in rows] != ids or int(n_said) != len(ids) or on.strip() != card:
        raise AssertionError(f"predict: {len(rows)} rows for {len(ids)} slides ({n_said} said) on {on}")
    if (int(k1), int(k1_scored), int(k2)) != (len(ids), len(ids), 0):
        raise AssertionError(f"predict: {len(ids)} slides but float kernel launches {k1} ({k1_scored} scored), int8 {k2}")
    cols = [f"p_{c}" for c in range(18)] + ["site_p"]
    p_pred = np.array([[float(r[c]) for c in cols] for r in rows])
    p_eval = np.array([[float(evals[s][c]) for c in cols] for s in ids])
    d_eval = float(np.abs(p_pred - p_eval).max())
    if d_eval > TOL_PREDICT_VS_EVAL:
        raise AssertionError(f"predict vs eval's fold_0.csv: probabilities differ by {d_eval:.3e} (tolerance {TOL_PREDICT_VS_EVAL})")
    top2 = np.sort(p_eval[:, :18], axis=1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > TOL_PREDICT_VS_EVAL
    flips = [s for s, r, ok in zip(ids, rows, clear) if ok and r["Y_hat"] != evals[s]["Y_hat"]]
    if flips:
        raise AssertionError(f"predict's Y_hat differs from eval's on {flips}")
    log(f"phase 12 predict: {len(rows)} slides of the test split in split order, every probability within {d_eval:.2e} of "
        f"phase 8's f32 eval fold_0.csv (tolerance {TOL_PREDICT_VS_EVAL}), Y_hat equal on the {int(clear.sum())} slides "
        f"whose top two differ by more than that; K1 f32 launches {k1} = {k1_scored} in scored mode = the slide count, "
        f"int8 {k2}; {float(rate):.2f} slides/s by the CLI's clock ({float(secs):.2f} s) [{gpu}]")

    # SlideInference(int8=True) in process over the same slides: K2 in scored mode, one launch a slide
    bags = {s: load_bag(split.bag_file(i)) for i, s in enumerate(ids)}
    inf8 = SlideInference.from_checkpoint(ckpt32, cfg, int8=True)
    k2_0, k2s_0, k1_0 = cuda_pool_int8.LAUNCHES, cuda_pool_int8.SCORED_LAUNCHES, cuda_pool.LAUNCHES
    preds8 = [inf8.predict(bags[s], x) for s, x in zip(ids, sexes)]
    k2_int8, k2s = cuda_pool_int8.LAUNCHES - k2_0, cuda_pool_int8.SCORED_LAUNCHES - k2s_0
    if (k2_int8, k2s, cuda_pool.LAUNCHES - k1_0) != (len(ids), len(ids), 0):
        raise AssertionError(f"SlideInference(int8=True): {len(ids)} slides, K2 launches {k2_int8} ({k2s} scored), "
                             f"K1 {cuda_pool.LAUNCHES - k1_0}")
    p8 = np.array([np.append(p.y_prob, p.site_prob[1]) for p in preds8])
    d8 = float(np.abs(p8 - p_pred).max())
    if d8 > TOL_EVAL_INT8_VS_F32:
        raise AssertionError(f"SlideInference(int8=True) vs predict in f32: {d8:.3e} (tolerance {TOL_EVAL_INT8_VS_F32})")
    log(f"phase 12 SlideInference(int8=True), in process: {len(ids)} slides, K2 launches {k2_int8} = {k2s} in scored mode, "
        f"none of K1; every probability within {d8:.2e} of predict's f32 run (tolerance {TOL_EVAL_INT8_VS_F32})")

    # infer, a child process, on the slide with coords: JSON, the exported attention and the heatmap PNG
    infer_args = ["infer", "--ckpt", str(ckpt32), "--bag", str(bag), "--sex", str(sexes[0]), "--task", task, "--topk", "18"]
    out, _ = run_cli([*infer_args, "--heatmap", str(workdir / "h.png"), "--save_attention", str(workdir / "a.npz")], workdir)
    said = json.loads(out)
    saved = np.load(workdir / "a.npz")
    attn, saved_coords = saved["attention"], saved["coords"]
    inf32 = SlideInference.from_checkpoint(ckpt32, cfg)
    ref = inf32.predict(bags[slide], sexes[0])
    d_rep = float(np.abs(attn - ref.attention).max())
    x = torch.from_numpy(bags[slide]).cuda()[None]
    mask = torch.ones(x.shape[:2], device="cuda")
    with torch.no_grad():
        plain = plain_forward(inf32.model, x, mask, torch.tensor([sexes[0]], device="cuda"), torch.float32, True)
    plain_scores = plain.attention[0, 0].cpu().numpy()
    scale = float(np.abs(plain_scores).max())
    d_plain = float(np.abs(attn - plain_scores).max())
    png = decode_png((workdir / "h.png").read_bytes())
    want_hw = canvas_shape(saved_coords, 256, 32)
    if (said["n_patches"] != n_rows or said["y_hat"] != ref.y_hat or str(saved["task"]) != "origin"
            or not np.array_equal(saved_coords, coords) or d_rep > TOL_INFER_REPEAT or d_plain > TOL_INFER_VS_PLAIN * scale
            or png.shape[:2] != want_hw or not np.array_equal(png, render_heatmap(saved_coords, attn))):
        raise AssertionError(f"infer: n_patches {said['n_patches']} of {n_rows}, y_hat {said['y_hat']} vs {ref.y_hat}, "
                             f"attention vs in process {d_rep:.3e}, vs plain {d_plain:.3e} of {scale:.3e}, PNG {png.shape} "
                             f"for a canvas of {want_hw}")
    log(f"phase 12 infer: JSON parses ({', '.join(said)}); {n_rows} rows of attention within {d_rep:.1e} of "
        f"SlideInference in process on the card (tolerance {TOL_INFER_REPEAT}) and {d_plain / scale:.2e} of the largest "
        f"|score| from the plain forward's raw scores (tolerance {TOL_INFER_VS_PLAIN}); h.png decodes (zlib and the PNG "
        f"header) to {png.shape[1]} x {png.shape[0]} = canvas_shape, the heatmap of the exported attention")

    # in process: heatmap on the exported .npz (on this machine the built-in jet ramp and the stdlib PNG writer)
    k1_0, k1s_0 = cuda_pool.LAUNCHES, cuda_pool.SCORED_LAUNCHES
    run_cli(["heatmap", "--attention", str(workdir / "a.npz"), "--out", str(workdir / "h2.png")], workdir, in_process=True)
    if not np.array_equal(decode_png((workdir / "h2.png").read_bytes()), png):
        raise AssertionError("heatmap from a.npz differs from infer's own heatmap")
    # the ensemble of the f32 and bf16 runs' checkpoints (both members computed in f32): one K1 launch a member
    out, _ = run_cli([*infer_args, "--ensemble", "--ckpt", f"{ckpt32},{ckpt16}"], workdir, in_process=True)
    ens = json.loads(out)
    k1_ens, k1s_ens = cuda_pool.LAUNCHES - k1_0, cuda_pool.SCORED_LAUNCHES - k1s_0
    ref16 = SlideInference.from_checkpoint(ckpt16, cfg).predict(bags[slide], sexes[0])
    mean = np.mean([ref.y_prob, ref16.y_prob], axis=0)
    index = {name: c for c, name in label_names(task).items()}
    d_ens = max(abs(t["prob"] - float(mean[index[t["class"]]])) for t in ens["topk"])
    if (k1_ens, k1s_ens) != (2, 2) or len(ens["topk"]) != 18 or d_ens > 1e-6:
        raise AssertionError(f"infer --ensemble: K1 launches {k1_ens} ({k1s_ens} scored) for 2 members, probabilities "
                             f"{d_ens:.3e} from the mean of the two single predictions")
    log(f"phase 12 infer --ensemble (f32 and bf16 runs' checkpoints, in process): K1 f32 launches {k1_ens} = {k1s_ens} in "
        f"scored mode, one a member; ranked probabilities within {d_ens:.1e} of the mean of the two single predictions; "
        f"heatmap on a.npz in process gives infer's PNG")

    # infer --patches in phase 9's directory: the seeded ResNet-50 on a patch file, against the bag featurize wrote
    k1_0 = cuda_pool.LAUNCHES
    out, _ = run_cli(["infer", "--ckpt", str(ckpt32), "--patches", str(resnet_dir / "patches" / "slide_b.npz"), "--weights",
                      str(resnet_dir / "resnet50.pth"), "--sex", "0", "--topk", "18"], workdir, in_process=True)
    k1_patches = cuda_pool.LAUNCHES - k1_0
    by_patches = {int(t["class"]): t["prob"] for t in json.loads(out)["topk"]}
    from_bag = inf32.predict(load_bag(resnet_dir / "feats" / "slide_b.npz"), 0)
    d_patches = max(abs(p - float(from_bag.y_prob[c])) for c, p in by_patches.items())
    if len(by_patches) != 18 or d_patches > TOL_PATCHES_VS_BAG + 5e-7 or k1_patches != 1:
        raise AssertionError(f"infer --patches: {len(by_patches)} classes, {d_patches:.3e} from the featurized bag's "
                             f"prediction (tolerance {TOL_PATCHES_VS_BAG}), K1 launches {k1_patches}")
    log(f"phase 12 infer --patches (phase 9's slide_b.npz, its seeded ResNet-50 .pth, in process): y_prob within "
        f"{d_patches:.1e} of SlideInference.predict on the bag phase 9's featurize wrote (tolerance {TOL_PATCHES_VS_BAG}, "
        f"6-digit JSON rounding beside it); K1 launches {k1_patches}")

    # what scored mode costs: K1 f32 at B=1, scored against classification, in turns (at predict's 8,192 rows
    # phase 6 times both modes)
    with torch.no_grad():
        ops = model.kernel_operands(torch.float32)
    g = torch.Generator(device="cuda").manual_seed(12)
    scored = {}
    for n in (65536,):
        xb = torch.randn(1, n, 1024, device="cuda", generator=g)
        mb = torch.ones(1, n, device="cuda")
        cls, sco = (lambda: cuda_pool.pool(ops, xb, mb, with_scores=False)), (lambda: cuda_pool.pool(ops, xb, mb, with_scores=True))
        c1, s1, s2, c2 = (cuda_ms(fn) for fn in (cls, sco, sco, cls))
        scored[n] = dict(classification=min(c1, c2), scored=min(s1, s2))
        log(f"phase 12 timing K1 f32 at B=1 x {n}: scored mode {min(s1, s2):.3f} ms ({s1:.3f}/{s2:.3f}), classification "
            f"{min(c1, c2):.3f} ms ({c1:.3f}/{c2:.3f}): scored mode costs {100 * (min(s1, s2) / min(c1, c2) - 1):+.1f} % [{gpu}]")
    log(f"phase 12: {time.perf_counter() - t0:.1f} s")
    return dict(k1_f32_launches=int(k1) + k1_ens + k1_patches, k2_launches=k2_int8, predict_rate=float(rate),
                predict_seconds=float(secs), scored=scored)


# Phase 13: ensemble serving and /heatmap (ROADMAP item 1.4). Every served answer against EnsembleInference on the card
# from the same members: both launch each member's K1 f32 (3xTF32) on the same rows, the server in batches and the
# reference at B = 1 in the same bucket, so they differ by summation order only (phase 12: 6.0e-08 between batch
# sizes); the attention weights are ~1/n of 3,000-60,000 rows. Under --int8 the rows are the same integers (the two
# quantizers are twins) and each row's scores come out of the same per-row arithmetic, so the attention keeps
# TOL_ENSEMBLE_ATTENTION; but K2 combines a bag's tiles in another split when the batch differs, so the
# probabilities get the int8 kernel's logit budget.
TOL_ENSEMBLE_PROB = 1e-5
TOL_ENSEMBLE_ATTENTION = 1e-6
TOL_ENSEMBLE_INT8 = TOL_INT8_LOGITS["atol"]
ROUTES_ENSEMBLE = ["octet_f32", "bag_path", "octet_f32", "bag_path"]
SERVE_LOAD_ARGS = ["--bag_n", "8192", "--requests", "96", "--concurrency", "8"]
ENSEMBLE_TIMING_BATCH = (8, 8192)  # B x rows of the batch the forward is timed on


def check_ensemble_answers(ens, reqs: list[dict], results: list, tol_prob: float, tol_attention: float) -> tuple[float, float]:
    """Every answer against ``ens.predict`` on the same rows: (max |y_prob
    error|, max |attention error|). y_hat must be equal wherever the
    reference's top two differ by more than twice ``tol_prob``; attention,
    where asked for, is the members' mean softmaxed weights over the real rows."""
    worst_p = worst_a = 0.0
    for r, (out, _lat) in zip(reqs, results):
        ref = ens.predict(r["feats"], r["sex"])
        err = float(np.abs(np.asarray(out["y_prob"]) - ref.y_prob).max())
        worst_p = max(worst_p, err)
        top2 = np.sort(ref.y_prob)[-2:]
        if err > tol_prob or (out["y_hat"] != ref.y_hat and top2[1] - top2[0] > 2 * tol_prob):
            raise AssertionError(f"{r['route']} n={len(r['feats'])}: y_prob off by {err:.3e} (tolerance {tol_prob}), "
                                 f"y_hat {out['y_hat']} vs {ref.y_hat}")
        if r["attention"]:
            a = np.asarray(out["attention"])
            if a.shape != ref.attention.shape or abs(float(a.sum()) - 1.0) > 1e-4:
                raise AssertionError(f"{r['route']}: attention of shape {a.shape} summing to {a.sum():.6f}, "
                                     f"want {ref.attention.shape} summing to 1")
            err_a = float(np.abs(a - ref.attention).max())
            worst_a = max(worst_a, err_a)
            if err_a > tol_attention:
                raise AssertionError(f"{r['route']}: attention off by {err_a:.3e} (tolerance {tol_attention})")
        elif "attention" in out:
            raise AssertionError("attention returned without being asked for")
    return worst_p, worst_a


def post_png(url: str, doc: dict) -> bytes:
    req = urllib.request.Request(url, data=json.dumps(doc).encode(), headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=600) as r:
        if r.headers.get("Content-Type") != "image/png":
            raise AssertionError(f"/heatmap answered {r.headers.get('Content-Type')}")
        return r.read()


def time_ensemble_forward(sd32: dict, sd16: dict, cfg, seed: int, gpu: str) -> dict:
    """One assembled batch (B=8 x 8,192 rows, ragged, pinned as the batcher's)
    through a 1-member and a 2-member ensemble batcher, in turns 1, 2, 2, 1:
    the whole ``_device_forward`` (host-to-device copy, every member's K1, the
    combine, results back), and the members and the combine alone on inputs
    already on the card. CUDA events; with and without attention."""
    from toad_tpu_torch.serve import DynamicBatcher

    b_, n = ENSEMBLE_TIMING_BATCH
    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(seed + 13)
    feats = torch.randn(b_, n, 1024, generator=g).pin_memory()
    mask = torch.zeros(b_, n, pin_memory=True)
    for i in range(b_):
        live = n - (n // 11) * i
        mask[i, :live] = 1.0
        feats[i, live:] = 0.0
    sex = torch.tensor([i % 2 for i in range(b_)], dtype=torch.int32).pin_memory()
    on_card = [t.to(dev) for t in (feats, mask, sex)]
    out = {}
    with DynamicBatcher([sd32], cfg, device=dev) as one, DynamicBatcher([sd32, sd16], cfg, device=dev) as two:
        for attention in (False, True):
            def whole(b):
                return lambda: b._device_forward(feats, mask, sex, None, attention)

            def members(b):
                def run():
                    with torch.inference_mode():
                        return b._combine([m(*on_card, need_attention=attention) for m in b.members], on_card[1],
                                          attention)
                return run

            for label, make in (("forward", whole), ("members", members)):
                w1, w2, w2b, w1b = (cuda_ms(make(b)) for b in (one, two, two, one))
                k1, k2 = min(w1, w1b), min(w2, w2b)
                out[(label, attention)] = dict(one=k1, two=k2)
                log(f"phase 13 timing {'scored' if attention else 'classification'} batch B={b_} x {n} f32, "
                    f"{'_device_forward (copy in, members, combine, copy out)' if label == 'forward' else 'members and combine on the card'}: "
                    f"1 member {k1:.3f} ms ({w1:.3f}/{w1b:.3f}), 2 members {k2:.3f} ms ({w2:.3f}/{w2b:.3f}), "
                    f"x{k2 / k1:.2f} [{gpu}]")
    return out


@restores_tf32
def phase_serve_ensemble(trained: dict, card: str, gpu: str, workdir: Path, seed: int) -> dict:
    """Phase 13: ``serve --ensemble`` over phase 7's f32 and bf16 checkpoints
    (both members computed in f32) as a child process, ``/heatmap`` on phase
    12's coordinate-bearing slide, the same burst on the first member alone
    (another child, started beside the first), the int8 ensemble in process, the
    forward's cost by member count, and the serve_load probe in process.
    Returns the launches of this phase's main path by kernel, and its timings."""
    import contextlib
    import io

    from toad_tpu_torch.config import ModelConfig
    from toad_tpu_torch.experiments import serve_load
    from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
    from toad_tpu_torch.pipeline.heatmap import canvas_shape
    from toad_tpu_torch.pipeline.infer import EnsembleInference, SlideInference
    from toad_tpu_torch.serve import InferenceService, ServeConfig, serve_in_thread
    from toad_tpu_torch.train.checkpoint import load_params_any

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    cfg = ModelConfig(in_dim=1024, n_classes=18)
    results = workdir / "ensemble_results"
    results.mkdir()
    ckpts = [workdir / "results" / f"smoke_{run}_s1" / "s_0_checkpoint.pt" for run in ("f32", "bf16")]
    for k, ckpt in enumerate(ckpts):
        shutil.copy(ckpt, results / f"s_{k}_checkpoint.pt")
    bag_dir = workdir / "ensemble_bags"
    bag_dir.mkdir()
    # main path: `serve --ensemble` as a user starts it (default 5 ms window, no --warmup, f32 members); the
    # requests and the reference are made while the child starts
    srv = Server(results, bag_dir, workdir, ["--ensemble"], bf16=False)
    # the same burst on the first member alone, for the cost of the second
    single = Server(ckpts[0], bag_dir, workdir, [], bf16=False)
    try:
        reqs = make_requests(seed + 2, bag_dir, ROUTES_ENSEMBLE)
        # phase 12's slide with its coords sidecar, in the served root
        split = trained["test_split"]
        slide_bag = split.bag_file(0)
        for src in (slide_bag, slide_bag.with_suffix(".coords.npy")):
            shutil.copy(src, bag_dir / src.name)
        coords = np.load(slide_bag.with_suffix(".coords.npy"))
        attn_reqs = sum(r["attention"] for r in reqs)
        ens = EnsembleInference.from_models_dir(results, cfg, device=dev)
        laps = {"requests made": time.perf_counter() - t0}
        single.__enter__()  # both children serving and idle before the first burst's clock starts
        with srv:
            before = _get(srv.base + "/stats")
            if (before["kernel_launches"], before["int8_kernel_launches"], before["requests"]) != (0, 0, 0):
                raise AssertionError(f"fresh server already counts work: {before}")
            if before["config"]["ensemble_members"] != 2:
                raise AssertionError(f"/stats config {before['config']}: want 2 ensemble members")
            results_, wall = burst(srv.base, reqs)
            stats = _get(srv.base + "/stats")
            t_heatmap = time.perf_counter()
            png = post_png(srv.base + "/heatmap", {"bag_path": slide_bag.name, "sex": 0})
            heatmap_s = time.perf_counter() - t_heatmap
            after = _get(srv.base + "/stats")
            srv.stop()
        said = [ln.strip() for ln in srv.lines if ln.startswith("ensemble: ")]
        if said != [f"ensemble: 2 fold checkpoints from {results}"] or not any("POST /heatmap" in ln for ln in srv.lines):
            raise AssertionError(f"serve --ensemble printed {said} and no /heatmap in its banner:\n{''.join(srv.lines[:5])}")
        laps["serve child"] = time.perf_counter() - t0 - sum(laps.values())
        worst_p, worst_a = check_ensemble_answers(ens, reqs, results_, TOL_ENSEMBLE_PROB, TOL_ENSEMBLE_ATTENTION)
        laps["reference"] = time.perf_counter() - t0 - sum(laps.values())
        per_batch = 2  # members: one K1 launch each a batch
        if (stats["requests"] != len(reqs) or stats["kernel_launches"] != per_batch * stats["batches"]
                or stats["scored_kernel_launches"] != per_batch * stats["attention_batches"] or stats["int8_kernel_launches"]):
            raise AssertionError(f"2 members over {stats['batches']} batches ({stats['attention_batches']} with attention): "
                                 f"K1 launches {stats['kernel_launches']} ({stats['scored_kernel_launches']} scored), "
                                 f"K2 {stats['int8_kernel_launches']}")
        image = decode_png(png)
        want_hw = canvas_shape(coords, 256, 32)
        scored_heatmap = after["scored_kernel_launches"] - stats["scored_kernel_launches"]
        if image.shape[:2] != want_hw or after["attention_batches"] != stats["attention_batches"] + 1 or scored_heatmap != per_batch:
            raise AssertionError(f"/heatmap: PNG {image.shape} for a canvas of {want_hw}, {scored_heatmap} scored K1 launches")
        lat = sorted(res[1] for res in results_)
        log(f"phase 13 serve --ensemble (2 members, f32, 5 ms window): {len(reqs)} concurrent requests "
            f"({', '.join(ROUTES_ENSEMBLE[:2])}; attention on {attn_reqs}), {stats['batches']} batches "
            f"({stats['attention_batches']} with attention), mean batch {stats['mean_batch_size']}, K1 f32 launches "
            f"{stats['kernel_launches']} = 2 x batches, {stats['scored_kernel_launches']} in scored mode = 2 x attention "
            f"batches; every answer against EnsembleInference on the card: y_prob within {worst_p:.2e} (tolerance "
            f"{TOL_ENSEMBLE_PROB}), attention within {worst_a:.2e} (tolerance {TOL_ENSEMBLE_ATTENTION}), y_hat equal; "
            f"{len(reqs) / wall:.2f} requests/s, p50 {statistics.median(lat) * 1e3:.1f} ms, burst wall {wall:.3f} s, "
            f"dispatch thread in batch assembly {stats['assemble_s']:.3f} s, in device forwards {stats['forward_s']:.3f} s "
            f"({stats['forward_s'] / stats['batches'] * 1e3:.1f} ms a batch) [{gpu}]")
        log(f"phase 13 POST /heatmap on phase 12's slide ({len(coords)} rows, coords sidecar): image/png decodes (zlib) to "
            f"{image.shape[1]} x {image.shape[0]} = canvas_shape; one batch, K1 scored launches +{scored_heatmap}; "
            f"{heatmap_s:.3f} s by the client's clock [{gpu}]")
        main = dict(k1_launches=after["kernel_launches"], rps=len(reqs) / wall, p50=statistics.median(lat), wall=wall,
                    batches=stats["batches"], forward_s=stats["forward_s"], assemble_s=stats["assemble_s"],
                    heatmap_s=heatmap_s)

        with single:
            if _get(single.base + "/stats")["kernel_launches"] != 0:
                raise AssertionError("the single-model server already counts launches")
            results1, wall1 = burst(single.base, reqs)
            stats1 = _get(single.base + "/stats")
            single.stop()
    finally:
        srv.__exit__()  # the children must not outlive a failure
        single.__exit__()
    inf = SlideInference.from_checkpoint(ckpts[0], cfg, device=dev)
    worst1 = 0.0
    for r, (out, _lat) in zip(reqs, results1):
        ref = inf.predict(r["feats"], r["sex"])
        worst1 = max(worst1, float(np.abs(np.asarray(out["y_prob"]) - ref.y_prob).max()))
        if worst1 > TOL_ENSEMBLE_PROB or out["y_hat"] != ref.y_hat:
            raise AssertionError(f"single member: y_prob off SlideInference by {worst1:.3e}, y_hat {out['y_hat']} vs {ref.y_hat}")
    if stats1["kernel_launches"] != stats1["batches"] or stats1["config"]["ensemble_members"] != 1:
        raise AssertionError(f"single member: {stats1['batches']} batches, K1 launches {stats1['kernel_launches']}")
    per_req = (stats["forward_s"] / len(reqs), stats1["forward_s"] / len(reqs))
    log(f"phase 13 the same burst on `serve` with the first member alone: {len(reqs) / wall1:.2f} requests/s, p50 "
        f"{statistics.median(res[1] for res in results1) * 1e3:.1f} ms, {stats1['batches']} batches (mean "
        f"{stats1['mean_batch_size']}), K1 f32 launches {stats1['kernel_launches']} = batches, y_prob within "
        f"{worst1:.2e} of SlideInference; device forwards {stats1['forward_s']:.3f} s ({stats1['forward_s'] / stats1['batches'] * 1e3:.1f} "
        f"ms a batch), assembly {stats1['assemble_s']:.3f} s; two members / one: forwards a request x"
        f"{per_req[0] / per_req[1]:.2f} ({per_req[1] * 1e3:.1f} -> {per_req[0] * 1e3:.1f} ms) [{gpu}]")
    main["single"] = dict(rps=len(reqs) / wall1, forward_s=stats1["forward_s"], batches=stats1["batches"])
    laps["single member"] = time.perf_counter() - t0 - sum(laps.values())

    # --int8 ensemble serving in process through serve_in_thread: each member's own quantized trunk, K2 once a member;
    # half the burst (both routes, with and without attention), since its reference quantizes every bag per member
    reqs8 = reqs[:12]
    svc = InferenceService.from_checkpoint(results, cfg, ServeConfig(int8=True), bag_root=bag_dir, device=dev,
                                           ensemble=True)
    server, port = serve_in_thread(svc)
    k1_0, k2_0, k2s_0 = cuda_pool.LAUNCHES, cuda_pool_int8.LAUNCHES, cuda_pool_int8.SCORED_LAUNCHES
    try:
        results8, wall8 = burst(f"http://127.0.0.1:{port}", reqs8)
        stats8 = svc.stats()
    finally:
        server.shutdown()
        server.server_close()
        svc.close()
    k2, k2s, k1 = cuda_pool_int8.LAUNCHES - k2_0, cuda_pool_int8.SCORED_LAUNCHES - k2s_0, cuda_pool.LAUNCHES - k1_0
    if (k2, k2s, k1) != (per_batch * stats8["batches"], per_batch * stats8["attention_batches"], 0):
        raise AssertionError(f"int8 ensemble: {stats8['batches']} batches, K2 launches {k2} ({k2s} scored), K1 {k1}")
    ens8 = EnsembleInference.from_models_dir(results, cfg, int8=True, device=dev)
    worst8_p, worst8_a = check_ensemble_answers(ens8, reqs8, results8, TOL_ENSEMBLE_INT8, TOL_ENSEMBLE_ATTENTION)
    laps["int8 ensemble"] = time.perf_counter() - t0 - sum(laps.values())
    log(f"phase 13 serve --int8 --ensemble in process (serve_in_thread): {len(reqs8)} concurrent requests, "
        f"{stats8['batches']} batches, K2 launches {k2} = "
        f"2 x batches ({k2s} scored), none of K1; against EnsembleInference(int8=True) on the card: y_prob within "
        f"{worst8_p:.2e} (tolerance {TOL_ENSEMBLE_INT8}), attention within {worst8_a:.2e} (tolerance {TOL_ENSEMBLE_ATTENTION}); "
        f"{len(reqs8) / wall8:.2f} requests/s with the clients in the same process [{gpu}]")

    sd32, sd16 = (load_params_any(c, cfg) for c in ckpts)
    forward = time_ensemble_forward(sd32, sd16, cfg, seed, gpu)
    laps["forward timing"] = time.perf_counter() - t0 - sum(laps.values())

    # serve_load in process, by wire: its line parsed, K1 launches = its batches (one model, one launch a batch);
    # each request's stages (--timestamps), so that a stalled request names the stage that held it
    load = {}
    for wire in ("none", "raw"):
        k1_0 = cuda_pool.LAUNCHES
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            serve_load.main([*SERVE_LOAD_ARGS, "--wire", wire, "--timestamps"])
        lines = buf.getvalue().strip().splitlines()
        line, reqs = json.loads(lines[-1]), [json.loads(r) for r in lines[:-1]]
        launched = cuda_pool.LAUNCHES - k1_0
        if (len(reqs) != int(SERVE_LOAD_ARGS[3]) or line["wire"] != wire or line["requests"] != len(reqs)
                or line["device"] != card or launched != line["batches"]):
            raise AssertionError(f"serve_load --wire {wire}: {lines[-1]}, {len(reqs)} request lines, K1 launches "
                                 f"{launched}")
        load[wire] = line
        laps[f"serve_load {wire}"] = time.perf_counter() - t0 - sum(laps.values())
        worst = max(reqs, key=lambda r: r["largest_gap_ms"])
        by_stage = {st: sum(r["largest_gap"] == st for r in reqs) for st in serve_load.STAGES[1:]}
        log(f"phase 13 serve_load {' '.join(SERVE_LOAD_ARGS)} --wire {wire}: {json.dumps(line)}; K1 f32 launches "
            f"{launched} = its batches; the requests' largest gaps end at {by_stage}, the largest of all "
            f"{worst['largest_gap_ms']:.1f} ms before {worst['largest_gap']} (request {worst['request']}: "
            f"{json.dumps(worst)}) [{gpu}]")
    log(f"phase 13: {time.perf_counter() - t0:.1f} s (" + ", ".join(f"{k} {v:.1f} s" for k, v in laps.items()) + ")")
    return dict(main, k2_launches=k2, worst_p=worst_p, worst_a=worst_a, forward=forward, serve_load=load)


TOL_CHECKED_STEP = 1e-6  # the checked step vs the production step, of each parameter's largest entry

# Phase 16. A mesh step against the unsharded step: f32 (TF32 off) on both, the same dropout masks; they differ
# in summation order only (the per-shard products and the combine), so the JAX package's own sharding test's
# tolerances (tests/test_sharding.py): the loss within rtol 1e-5, every parameter within rtol 1e-4, atol 1e-5.
TOL_MESH_LOSS = 1e-5
TOL_MESH_STEP = dict(rtol=1e-4, atol=1e-5)
# An eval pass or a served answer over a mesh against the unsharded one: K1p per shard and the combine against
# K1 on the whole bag, f32 (3xTF32) on both; phase 3's K1p tolerance, on the probabilities and raw scores.
TOL_MESH_PROB = TOL_F32["atol"]
MESH_SHAPES_STEP = ((1, 2), (2, 1), (2, 2))
MESH_SHAPES_EVAL = ((1, 2), (2, 2))


def wall_ms(fn, devices, reps: int = 5) -> float:
    """Median wall milliseconds of fn() after two warm-up calls, every card
    of ``devices`` synchronized before and after each reading (work that
    spans cards has no one stream to time on)."""
    def sync():
        for d in {d for d in devices if d.type == "cuda"}:
            torch.cuda.synchronize(d)

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mesh_cards(seed: int, gpu: str, cards: list | None = None) -> None:
    """``--mesh-cards``: the mesh with each cell on its own card (``cards``:
    the visible cards), every result against cuda:0 alone."""
    from toad_tpu_torch.config import EncoderConfig, ModelConfig, OptimConfig
    from toad_tpu_torch.models.toad_mil import ToadMIL
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.ops.quantize import quantize_rows
    from toad_tpu_torch.parallel.mesh import make_mesh, visible_devices
    from toad_tpu_torch.parallel.sharding import shard_batch
    from toad_tpu_torch.pipeline.featurize import TileEmbedder
    from toad_tpu_torch.serve.batcher import DynamicBatcher, ServeConfig
    from toad_tpu_torch.train.loop import make_train_step, unpack_metrics
    from toad_tpu_torch.train.optim import make_optimizer

    cards = cards if cards is not None else visible_devices()
    n = len(cards)
    if n < 2:
        raise SystemExit(f"--mesh-cards needs two or more cards, {n} visible")
    dev0 = cards[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    shapes = [(n, 1), (1, n)] + ([(2, n // 2)] if n > 2 and n % 2 == 0 else [])
    log(f"mesh cards: {n} cards {[str(d) for d in cards]}, shapes {shapes} [{gpu}]")
    g = torch.Generator().manual_seed(seed + 16)
    b_, rows = 4, 8192
    batch = {
        "features": torch.randn(b_, rows, 1024, generator=g),
        "patch_mask": (torch.rand(b_, rows, generator=g) < 0.9).float(),
        "bag_mask": torch.ones(b_),
        "label": torch.randint(0, 18, (b_,), generator=g),
        "site": torch.randint(0, 2, (b_,), generator=g),
        "sex": torch.randint(0, 2, (b_,), generator=g).int(),
    }
    cfg = ModelConfig(in_dim=1024, n_classes=18)

    def model_on(config, dev):
        return ToadMIL(config, generator=torch.Generator().manual_seed(seed)).to(dev)

    def step(shape):
        model = model_on(dataclasses.replace(cfg, dropout=True), dev0).train()
        opt = make_optimizer(OptimConfig(name="sgd", lr=1e-3), model.parameters())
        placed = shard_batch(batch, make_mesh(*shape, devices=cards)) if shape else {k: v.to(dev0) for k, v in batch.items()}
        run = make_train_step(model, opt, 0.75, 0.25)
        metrics = unpack_metrics(run(placed, torch.Generator(device=dev0).manual_seed(seed)))
        ms = wall_ms(lambda: run(placed, torch.Generator(device=dev0).manual_seed(seed)), cards)
        return metrics["loss"], {k: v.detach() for k, v in model.state_dict().items()}, ms

    ref_loss, ref, ref_ms = step(None)
    model = model_on(cfg, dev0).eval()
    whole = {k: v.to(dev0) for k, v in batch.items()}
    xq, sx = quantize_rows(whole["features"])
    with torch.inference_mode():
        want = model(whole["features"], whole["patch_mask"], whole["sex"])
        want8 = model.forward_int8(xq, sx, whole["patch_mask"], whole["sex"])
        ref_fwd = wall_ms(lambda: model(whole["features"], whole["patch_mask"], whole["sex"], need_attention=False), cards)
    log(f"mesh cards: {dev0} alone, B={b_} x {rows} x 1024 f32: SGD step with dropout {ref_ms:.2f} ms, eval forward "
        f"{ref_fwd:.2f} ms (wall, median of 5) [{gpu}]")
    for shape in shapes:
        mesh = make_mesh(*shape, devices=cards)
        loss, state, ms = step(shape)
        bad = [k for k in ref if not torch.allclose(state[k], ref[k], **TOL_MESH_STEP)]
        d_param = max(float((state[k] - ref[k]).abs().max()) for k in ref)
        if abs(loss - ref_loss) > TOL_MESH_LOSS * abs(ref_loss) or bad:
            raise AssertionError(f"SGD step over {shape} on {n} cards: |loss| {abs(loss - ref_loss):.3e}, beyond: {bad}")
        placed = shard_batch(batch, mesh)
        placed8 = shard_batch({**batch, "features": xq.cpu(), "scales": sx.cpu()}, mesh)
        with torch.inference_mode():
            cuda_pool.PARTIAL_LAUNCHES = cuda_pool.COMBINE_LAUNCHES = 0
            got = model.forward_sharded(placed, need_attention=False)
            counts = (cuda_pool.PARTIAL_LAUNCHES, cuda_pool.COMBINE_LAUNCHES)
            scored = model.forward_sharded(placed)
            got8 = model.forward_sharded(placed8, int8=True)
            fwd = wall_ms(lambda: model.forward_sharded(placed, need_attention=False), cards)
        errs = (float((got.y_prob - want.y_prob).abs().max()), float((scored.attention - want.attention).nan_to_num(
            0.0, 0.0, 0.0).abs().max()), float((got8.logits - want8.logits).abs().max()))
        if errs[0] > TOL_MESH_PROB or errs[1] > TOL_MESH_PROB or errs[2] > TOL_INT8_LOGITS["atol"]:
            raise AssertionError(f"eval forward over {shape} on {n} cards: |y_prob| {errs[0]:.3e}, |attention| "
                                 f"{errs[1]:.3e}, |int8 logits| {errs[2]:.3e}")
        want_counts = (shape[0] * shape[1], 1) if shape[1] > 1 else (0, 0)
        if dev0.type == "cuda" and counts != want_counts:
            raise AssertionError(f"eval forward over {shape}: K1p, combine launches {counts}, not {want_counts}")
        log(f"mesh cards: {shape} over {n} cards: SGD step |loss difference| {abs(loss - ref_loss):.3e}, largest "
            f"parameter difference {d_param:.3e} (tolerance {TOL_MESH_STEP}); eval |y_prob| {errs[0]:.3e}, |raw "
            f"attention| {errs[1]:.3e} (tolerance {TOL_MESH_PROB:g}), int8 |logits| {errs[2]:.3e}; K1p {counts[0]} and "
            f"combine {counts[1]} launches a forward; wall ms: step {ms:.2f} ({dev0} alone {ref_ms:.2f}), forward "
            f"{fwd:.2f} ({ref_fwd:.2f}) [{gpu}]")

    # the serving batcher over (1, n): the same requests against one card
    sd = model.state_dict()
    rng = np.random.default_rng(seed + 17)
    bags = [rng.standard_normal((m, 1024)).astype(np.float32) for m in (4000, 8192, 6000, 8192)]
    answers = {}
    for name, mesh in (("one", None), ("mesh", make_mesh(1, n, devices=cards))):
        with DynamicBatcher(sd, cfg, ServeConfig(max_wait_ms=50.0), device=dev0, mesh=mesh) as batcher:
            futs = [batcher.submit(bag, i % 2, attention=i % 2 == 0) for i, bag in enumerate(bags)]
            answers[name] = [f.result(timeout=300) for f in futs]
    serve_err = max(float(np.abs(a.y_prob - o.y_prob).max()) for a, o in zip(answers["mesh"], answers["one"]))
    if serve_err > TOL_MESH_PROB:
        raise AssertionError(f"serving over (1, {n}): |y_prob| {serve_err:.3e}")
    log(f"mesh cards: the serving batcher over (1, {n}), 4 requests: |y_prob - one card| max {serve_err:.3e}")

    # the ResNet embedder over a data mesh of the n cards
    enc_cfg = EncoderConfig()
    enc = seeded_resnet(seed)
    tiles = np.random.default_rng(seed + 18).integers(0, 256, (64 * n, 224, 224, 3), dtype=np.uint8)
    one = TileEmbedder(enc.to(dev0).eval(), batch_size=64 * n)
    spread = TileEmbedder(seeded_resnet(seed).to(dev0).eval(), batch_size=64 * n, devices=cards)
    diff = np.abs(spread.embed_all(tiles) - one.embed_all(tiles))
    log(f"mesh cards: ResNet-50 ({enc_cfg.compute_dtype}, folded) embedder over a data mesh of {n} cards, {len(tiles)} "
        f"tiles: |difference from one card| max {diff.max():.3e} mean {diff.mean():.3e}; wall ms a batch of {64 * n}: "
        f"one card {wall_ms(lambda: one(tiles[:64 * n]), cards):.2f}, {n} cards "
        f"{wall_ms(lambda: spread(tiles[:64 * n]), cards):.2f} [{gpu}]")

    # the CLIs as a user runs them, children, on a seeded cohort
    from toad_tpu_torch.data.synthetic import dummy_task, write_dummy_bags, write_dummy_csv

    with tempfile.TemporaryDirectory(prefix="toad_mesh_cards_") as tmp:  # a seeded cohort of 54 bags
        work = Path(tmp)
        manifest = write_dummy_csv(work / "dataset_csv" / "dummy.csv", n_patients=54, max_slides_per_patient=1,
                                   seed=seed)
        task = dummy_task(str(work / "dataset_csv" / "dummy.csv"))
        (work / "tasks").mkdir()
        (work / "tasks" / "dummy_mtl_concat.json").write_text(task.to_json())
        write_dummy_bags(work / "bags", manifest, task, n_patches_range=(500, 4000), dim=1024, fmt="npy", seed=seed)
        run_cli(["create-splits", "--task", "tasks/dummy_mtl_concat.json", "--k", str(n), "--val_frac", "0.34",
                 "--test_frac", "0.34"], work)
        on = ["--device", "cpu"] if dev0.type == "cpu" else []  # (a rehearsal on the CPU)
        base = ["train", "--task", "tasks/dummy_mtl_concat.json", "--data_root_dir", "bags", "--k", str(n),
                "--max_epochs", "1", "--batch_size", "4", "--buckets", "1024,2048,4096",
                "--split_dir", "splits/dummy_mtl_concat_100", *on]
        summaries = {}
        axes = ["--data_shards", "2", "--bag_shards", str(n // 2)] if n % 2 == 0 else ["--data_shards", str(n)]
        for code, extra in (("seq", []), ("folds", ["--fold_devices", str(n)]), ("mesh", axes)):
            t0 = time.perf_counter()
            out, _ = run_cli([*base, "--exp_code", code, *extra], work)
            summaries[code] = (work / "results" / f"{code}_s1" / "summary.csv").read_text()
            log(f"mesh cards: train {' '.join(extra) or '(one card)'}, {n} folds of 1 epoch: {time.perf_counter() - t0:.1f} s")
        if summaries["folds"] != summaries["seq"]:
            raise AssertionError(f"train --fold_devices {n}: summary.csv differs from the sequential run")
        rows = {c: [line.split(",")[1:] for line in summaries[c].splitlines()[1:]] for c in ("seq", "mesh")}
        worst = max(abs(float(a) - float(b)) for ra, rb in zip(rows["seq"], rows["mesh"]) for a, b in zip(ra, rb)
                    if a and b)
        eval_base = ["eval", "--task", "tasks/dummy_mtl_concat.json", "--data_root_dir", "bags", "--models_exp_code",
                     "seq_s1", "--k", str(n), "--batch_size", "4", "--split", "all", *on]
        run_cli([*eval_base, "--save_exp_code", "e_seq"], work)
        run_cli([*eval_base, "--save_exp_code", "e_par", "--fold_devices", str(n)], work)
        same = all((work / "eval_results" / "EVAL_e_seq" / f).read_bytes() == (work / "eval_results" / "EVAL_e_par" / f)
                   .read_bytes() for f in [*(f"fold_{i}.csv" for i in range(n)), "summary.csv"])
        if not same:
            raise AssertionError(f"eval --fold_devices {n}: outputs differ from the sequential run")
        log(f"mesh cards: train --fold_devices {n} summary.csv equal to the sequential run's to the byte; train "
            f"{' '.join(axes)} within {worst:.3e} of it (AUCs and accuracies); eval --fold_devices {n}: every fold CSV "
            f"and summary.csv equal to the sequential run's [{gpu}]")


def phase_mesh(trained: dict, card: str, gpu: str, workdir: Path, resnet_dir: Path, seed: int,
               dev: torch.device = torch.device("cuda", 0)) -> dict:
    """Phase 16: the ('data', 'bag') mesh in process, every mesh over ``dev``
    (cuda:0) repeated. Returns the launch counts of the phase's drives (K1
    f32, K1p, the combine), counted from 0."""
    from toad_tpu_torch.config import DataConfig, EncoderConfig, OptimConfig, TrainConfig
    from toad_tpu_torch.data.batching import BagBatcher
    from toad_tpu_torch.evaluate.engine import evaluate_checkpoint
    from toad_tpu_torch.evaluate.runner import batch_to_dict
    from toad_tpu_torch.models.resnet_encoder import encoder_from_state_dict, load_torchvision_weights
    from toad_tpu_torch.models.toad_mil import ToadMIL
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.parallel.mesh import make_mesh
    from toad_tpu_torch.parallel.sharding import shard_batch
    from toad_tpu_torch.pipeline.featurize import TileEmbedder
    from toad_tpu_torch.serve.batcher import DynamicBatcher, ServeConfig
    from toad_tpu_torch.train.checkpoint import load_params_any
    from toad_tpu_torch.train.loop import FoldTrainer, make_train_step, unpack_metrics
    from toad_tpu_torch.train.optim import make_optimizer
    from toad_tpu_torch.train.parallel_folds import train_folds_parallel

    t0 = time.perf_counter()
    on_card = dev.type == "cuda"  # (the CPU runs the plain versions: no launch to count)
    torch.backends.cuda.matmul.allow_tf32 = False

    def mesh(d: int, b: int):
        return make_mesh(d, b, devices=[dev] * (d * b))

    # the refusal: a data axis past the visible cards, with the JAX text
    n_cards = torch.cuda.device_count()
    want = f"{n_cards} devices not divisible by data_shards={n_cards + 1}"
    try:
        make_mesh(data_shards=n_cards + 1)
    except ValueError as e:
        if str(e) != want:
            raise AssertionError(f"make_mesh(data_shards={n_cards + 1}) refused with {e!r}, not {want!r}") from None
    else:
        raise AssertionError(f"make_mesh(data_shards={n_cards + 1}) was not refused on {n_cards} card(s)")
    log(f"phase 16 mesh: make_mesh(data_shards={n_cards + 1}) over the {n_cards} visible card(s) refused: {want}")

    cuda_pool.LAUNCHES = cuda_pool.SCORED_LAUNCHES = cuda_pool.PARTIAL_LAUNCHES = cuda_pool.COMBINE_LAUNCHES = 0
    ds, test_split, cfg32 = trained["dataset"], trained["test_split"], trained["model_cfg"]

    # (a) one SGD step with dropout, each mesh against the unsharded step
    b = next(iter(BagBatcher(test_split, batch_size=4, mode="sequential", prefetch=0, max_bag_size=8192)))
    bd = batch_to_dict(b, "cpu")
    cfg_drop = dataclasses.replace(cfg32, dropout=True)

    def step(shape):
        model = ToadMIL(cfg_drop, generator=torch.Generator().manual_seed(seed)).to(dev).train()
        opt = make_optimizer(OptimConfig(name="sgd", lr=1e-3), model.parameters())
        batch = shard_batch(bd, mesh(*shape)) if shape else {k: v.to(dev) for k, v in bd.items()}
        metrics = unpack_metrics(make_train_step(model, opt, 0.75, 0.25)(batch, torch.Generator(device=dev).manual_seed(seed)))
        return metrics["loss"], {k: v.detach() for k, v in model.state_dict().items()}

    ref_loss, ref = step(None)
    steps = {}
    for shape in MESH_SHAPES_STEP:
        loss, state = step(shape)
        d_loss = abs(loss - ref_loss)
        d_param = max(float((state[k] - ref[k]).abs().max()) for k in ref)
        bad = [k for k in ref if not torch.allclose(state[k], ref[k], **TOL_MESH_STEP)]
        if d_loss > TOL_MESH_LOSS * abs(ref_loss) or bad:
            raise AssertionError(f"SGD step on mesh {shape}: |loss - unsharded| {d_loss:.3e}, parameters beyond "
                                 f"{TOL_MESH_STEP}: {bad}")
        steps[shape] = (d_loss, d_param)
        log(f"phase 16 mesh: SGD step with dropout (B=4 x {b.bucket} x {cfg32.in_dim}, f32, TF32 off) on mesh {shape} vs "
            f"unsharded: |loss difference| {d_loss:.3e} (tolerance {TOL_MESH_LOSS:g} of {abs(ref_loss):.4f}), largest "
            f"parameter difference {d_param:.3e} (tolerance {TOL_MESH_STEP})")

    # (b) eval passes of the phase-7 f32 checkpoint over the test split: the main path of K1p and the combine
    ckpt = workdir / "results" / "smoke_f32_s1" / "s_0_checkpoint.pt"
    base = evaluate_checkpoint(ckpt, test_split, cfg32, batch_size=4, device=dev)
    evals = {}
    for shape in MESH_SHAPES_EVAL:
        before = (cuda_pool.LAUNCHES, cuda_pool.PARTIAL_LAUNCHES, cuda_pool.COMBINE_LAUNCHES)
        lib0 = cuda_pool.library_launches() if on_card else 0
        t1 = time.perf_counter()
        res = evaluate_checkpoint(ckpt, test_split, cfg32, batch_size=4, mesh=mesh(*shape))
        secs = time.perf_counter() - t1
        k1, k1p, comb = (cuda_pool.LAUNCHES - before[0], cuda_pool.PARTIAL_LAUNCHES - before[1],
                         cuda_pool.COMBINE_LAUNCHES - before[2])
        lib = cuda_pool.library_launches() - lib0 if on_card else 0
        nb = res.stats["n_batches"]
        # every kernel the library launched is one of these: no split merge follows a K1p launch
        if on_card and ((k1, k1p, comb) != (0, shape[0] * shape[1] * nb, nb) or lib != k1p + comb):
            raise AssertionError(f"eval over mesh {shape}, {nb} batches: K1 {k1}, K1p {k1p}, combine {comb} launches, "
                                 f"{lib} kernels of the library in all")
        if list(res.df["slide_id"]) != list(base.df["slide_id"]):
            raise AssertionError(f"eval over mesh {shape} scored other slides")
        err = float(np.abs(res.probs() - base.probs()).max())
        if err > TOL_MESH_PROB:
            raise AssertionError(f"eval over mesh {shape}: |y_prob - unsharded| {err:.3e} > {TOL_MESH_PROB}")
        evals[shape] = err
        log(f"phase 16 mesh: eval pass of the f32 checkpoint over mesh {shape}, {res.stats['n']} slides in {nb} "
            f"batches ({secs:.2f} s, feed {res.stats['feed']}): K1p launches {k1p} (shards x batches), combine launches "
            f"{comb}, K1 {k1}, the library's kernels {lib} (no split merge); |y_prob - unsharded pass| max {err:.3e} "
            f"(tolerance {TOL_MESH_PROB:g}) [{gpu}]")

    # (c) the serving batcher over (1, 2): six requests of the cohort, half with attention
    sd = load_params_any(ckpt, cfg32)
    bags = [ds.load_bag(i)[:8192] for i in range(6)]
    answers = {}
    for name, m in (("one", None), ("mesh", mesh(1, 2))):
        with DynamicBatcher(sd, cfg32, ServeConfig(max_wait_ms=50.0), device=dev, mesh=m) as batcher:
            futs = [batcher.submit(bag, i % 2, attention=i % 2 == 0) for i, bag in enumerate(bags)]
            answers[name] = [f.result(timeout=300) for f in futs]
    serve_prob = max(float(np.abs(a.y_prob - o.y_prob).max()) for a, o in zip(answers["mesh"], answers["one"]))
    serve_attn = max(float(np.abs(a.attention - o.attention).max()) if len(o.attention) else 0.0
                     for a, o in zip(answers["mesh"], answers["one"]))
    if serve_prob > TOL_MESH_PROB or serve_attn > TOL_MESH_PROB:
        raise AssertionError(f"serving over mesh (1, 2): |y_prob| {serve_prob:.3e}, |attention| {serve_attn:.3e}")
    log(f"phase 16 mesh: the serving batcher over mesh (1, 2), 6 requests of {', '.join(str(len(x)) for x in bags)} "
        f"rows (3 with attention): |y_prob - unsharded batcher| max {serve_prob:.3e}, |raw attention| max "
        f"{serve_attn:.3e} (tolerance {TOL_MESH_PROB:g})")

    # (d) featurize --data_shards 2's embedder on phase 9's tiles
    enc_cfg = EncoderConfig()
    loaded = load_torchvision_weights(resnet_dir / "resnet50.pth", enc_cfg)
    tiles = np.load(resnet_dir / "patches" / "slide_b.npz")["imgs"]
    one = TileEmbedder(encoder_from_state_dict(loaded, enc_cfg).to(dev).eval(), batch_size=64).embed_all(tiles)
    two = TileEmbedder(encoder_from_state_dict(loaded, enc_cfg).to(dev).eval(), batch_size=64,
                       devices=[dev, dev]).embed_all(tiles)
    diff = np.abs(two - one)
    if diff.max() > 0:
        enc32 = encoder_from_state_dict(loaded, dataclasses.replace(enc_cfg, compute_dtype="float32")).to(dev)
        noise = np.abs(one - TileEmbedder(enc32, batch_size=64).embed_all(tiles))
        if diff.max() > noise.max() or diff.mean() > noise.mean():
            raise AssertionError(f"data-mesh features: max {diff.max():.3e} mean {diff.mean():.3e} beyond the encoder's "
                                 f"bf16 noise max {noise.max():.3e} mean {noise.mean():.3e}")
        said = f"max {diff.max():.3e} mean {diff.mean():.3e} (within the bf16 noise against f32: max {noise.max():.3e})"
    else:
        said = "equal to the bit"
    log(f"phase 16 mesh: ResNet-50 (bf16, folded) embedder over a data mesh of 2 on phase 9's {len(tiles)} tiles vs one "
        f"device: {said}")

    # (e) fold-parallel: two folds of one epoch on a 16-slide subset, over two devices, each against its sequential run
    idx = np.arange(ds.n_slides)
    splits = (ds.subset(idx[:8]), ds.subset(idx[8:12]), ds.subset(idx[12:16]))
    fcfg = TrainConfig(max_epochs=1, seed=seed, model=cfg32, data=DataConfig(batch_size=4, max_bag_size=8192))
    quiet = lambda msg: None  # noqa: E731
    t1 = time.perf_counter()
    seq = {f: FoldTrainer(fcfg, fold=f, results_dir=workdir / "mesh_seq", device=dev).train(*splits, log_fn=quiet)
           for f in (0, 1)}
    t2 = time.perf_counter()
    par = train_folds_parallel(fcfg, [(0, splits), (1, splits)], workdir / "mesh_par", n_devices=2, log_fn=quiet,
                               devices=[dev, dev])
    t3 = time.perf_counter()
    for f in (0, 1):
        differ = [k for k in seq[f]["params"] if not torch.equal(seq[f]["params"][k], par[f]["params"][k])]
        same_metrics = all(seq[f][k] == par[f][k] or (np.isnan(seq[f][k]) and np.isnan(par[f][k]))
                           for k in ("cls_val_auc", "cls_test_auc", "cls_test_acc", "site_test_auc"))
        if differ or not same_metrics:
            raise AssertionError(f"fold {f} under train_folds_parallel differs from its sequential run: {differ[:3]}")
    log(f"phase 16 mesh: train_folds_parallel, 2 folds of 1 epoch (8 / 4 / 4 slides, f32) over {dev} twice: each "
        f"fold's parameters and metrics equal to its sequential run to the bit; sequential {t2 - t1:.1f} s, "
        f"parallel {t3 - t2:.1f} s [{gpu}]")

    counts = dict(k1_f32=cuda_pool.LAUNCHES, partial=cuda_pool.PARTIAL_LAUNCHES, combine=cuda_pool.COMBINE_LAUNCHES)
    if on_card and (counts["partial"] <= 0 or counts["combine"] <= 0):
        raise AssertionError(f"phase 16 drove no K1p or combine launch: {counts}")
    log(f"phase 16 mesh: launches in this phase: K1p {counts['partial']}, combine {counts['combine']}, K1 f32 "
        f"{counts['k1_f32']}; {time.perf_counter() - t0:.1f} s")
    return dict(counts, steps=steps, evals=evals, serve=(serve_prob, serve_attn))


def state_bytes(model, optimizer) -> bytes:
    """The parameters' and the optimizer's state, serialized: equal bytes, equal state."""
    import io

    buf = io.BytesIO()
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict()}, buf)
    return buf.getvalue()


def phase_ops_tooling(trained: dict, card: str, gpu: str, workdir: Path, seed: int) -> dict:
    """Phase 14: the ops tooling in phase 7's work directory. (a) ``train
    --profile DIR --bf16 --max_epochs 1`` as a child on phase 7's cohort: its
    trace's ten ProfilerStep spans with device kernels, the kernel launches a
    step, the device-busy share over the traced steps and the five longest
    kernels. (b) In process, on one batch with the model on the card: the
    checked step against the production step; an out-of-range label and a
    NaN feature refused with the JAX text and the state's bytes unchanged;
    ``enable_debug_nans()`` catching the NaN that K1 computes from a NaN
    planted in phase 7's f32 checkpoint."""
    import re

    from toad_tpu_torch.config import OptimConfig
    from toad_tpu_torch.data.batching import BagBatcher
    from toad_tpu_torch.evaluate.runner import batch_to_dict, make_eval_step
    from toad_tpu_torch.models.toad_mil import ToadMIL
    from toad_tpu_torch.ops import cuda_pool
    from toad_tpu_torch.train.checkpoint import load_params_any
    from toad_tpu_torch.train.loop import make_train_step
    from toad_tpu_torch.train.optim import make_optimizer
    from toad_tpu_torch.utils.debug import CheckError, enable_debug_nans, make_checked_step

    t0 = time.perf_counter()
    # (a) main path: the trainer as a user profiles it; batch 3, so that the epoch has more than ten steps
    trace_dir = workdir / "train_trace"
    lines, wall = run_train(workdir, "smoke_profile", ["--profile", str(trace_dir), "--bf16", "--max_epochs", "1",
                                                       "--batch_size", "3"])
    if f"[profile] trace of 10 steps written to {trace_dir}" not in lines or any("device kernel events" in ln for ln in lines):
        raise AssertionError(f"train --profile: {[ln for ln in lines if '[profile]' in ln]}")
    counts = next((re.search(r"eval batches (\d+), pooling kernel launches (\d+)", ln) for ln in lines
                   if "pooling kernel launches" in ln), None)
    if counts is None or int(counts.group(1)) != int(counts.group(2)) or int(counts.group(1)) < 1:
        raise AssertionError(f"train --profile: pooling kernel launches != eval batches: {counts}")
    events = read_trace(trace_dir)
    n_kernels = check_trace_has_device_events(events, "train --profile")
    steps = host_spans(events, "ProfilerStep#")
    if [e["name"] for e in steps] != [f"ProfilerStep#{k}" for k in range(10)]:
        raise AssertionError(f"train --profile: spans {[e['name'] for e in steps]}, want ProfilerStep#0..9")
    full = steps[:-1]  # the last span only closes the trace (StepTracer)
    per_step = [[e for e in device_in_span(events, span) if e["cat"] == "kernel"] for span in full]
    if min(len(k) for k in per_step) == 0:
        raise AssertionError(f"train --profile: a traced step with no device kernel: {[len(k) for k in per_step]}")
    lo, hi = full[0]["ts"], full[-1]["ts"] + full[-1]["dur"]
    traced = [e for e in events if e.get("cat") in DEVICE_CATS and e["ts"] + e["dur"] > lo and e["ts"] < hi]
    busy, window = busy_us(traced, lo, hi)
    # a span is the wait for the next batch, then the step: the step's host time runs from its first kernel
    # launch to the span's end, after the metrics' copy to the host
    kernel_ids = {e.get("args", {}).get("correlation") for e in events if e.get("cat") == "kernel"}
    first = [min(e["ts"] for e in events if e.get("cat") in LAUNCH_CATS and e["tid"] == span["tid"]
                 and span["ts"] <= e["ts"] <= span["ts"] + span["dur"] and e["args"].get("correlation") in kernel_ids)
             for span in full]
    step_host = [span["ts"] + span["dur"] - t for span, t in zip(full, first)]
    step_busy = [busy_us(traced, t, t + h)[0] for t, h in zip(first, step_host)]
    kernel_ms = statistics.mean(sum(e["dur"] for e in k) for k in per_step) / 1e3
    launches = [len(k) for k in per_step]
    log(f"phase 14 train --profile --bf16 (batch 3, child process {wall:.1f} s): trace of {n_kernels} device kernels, "
        f"ProfilerStep#0..9 (#9 closes the trace); over the {len(full)} whole steps: {statistics.mean(launches):.1f} "
        f"kernel launches a step ({min(launches)}-{max(launches)}), {kernel_ms:.3f} ms of kernels a step; a span "
        f"{statistics.mean(s['dur'] for s in full) / 1e3:.3f} ms of host time (the wait for its batch included), the device "
        f"busy {busy / 1e3:.3f} of {window / 1e3:.3f} ms ({100 * busy / window:.1f} %); the step from its first launch "
        f"{statistics.mean(step_host) / 1e3:.3f} ms of host time ({min(step_host) / 1e3:.3f}-{max(step_host) / 1e3:.3f}), "
        f"the device busy {100 * sum(step_busy) / sum(step_host):.1f} % of it; the five longest kernels: "
        f"{longest_kernels([e for k in per_step for e in k], op_names(events))} [{gpu}]")

    # (b) in process, one batch of phase 7's cohort, the model on the card
    cfg32 = trained["model_cfg"]
    split = trained["test_split"]
    batch = next(iter(BagBatcher(split, batch_size=4, mode="sequential", prefetch=0, max_bag_size=8192)))
    bd = batch_to_dict(batch, "cuda")
    pairs = []
    for make in (make_train_step, make_checked_step):
        model = ToadMIL(cfg32, generator=torch.Generator().manual_seed(seed)).cuda().train()
        opt = make_optimizer(OptimConfig(), model.parameters())
        step = make(model, opt, 0.75, 0.25)
        step(bd, None)
        pairs.append((model, opt, step))
    torch.cuda.synchronize()
    (m_p, _, _), (m_c, o_c, chk) = pairs
    worst = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                for a, b in zip(m_p.state_dict().values(), m_c.state_dict().values()))
    if worst > TOL_CHECKED_STEP:
        raise AssertionError(f"checked step vs production step: parameters differ by {worst:.2e} of their largest entry")
    refused = []
    label, features = bd["label"].clone(), bd["features"].clone()
    label[1], features[0, 0, 0] = 25, float("nan")
    for what, bad, says in (
        ("an origin label of 25", {**bd, "label": label}, "origin label out of range [0, 18): min "),
        ("a NaN feature", {**bd, "features": features}, "non-finite feature values in batch"),
    ):
        before = state_bytes(m_c, o_c)
        try:
            chk(bad, None)
        except CheckError as e:
            if not str(e).startswith(says) or state_bytes(m_c, o_c) != before:
                raise AssertionError(f"{what}: {e}; state unchanged {state_bytes(m_c, o_c) == before}") from None
            refused.append(f"{what}: \"{e}\"")
        else:
            raise AssertionError(f"the checked step took a batch with {what}")

    # enable_debug_nans: a NaN planted in one weight of phase 7's f32 checkpoint comes out of K1
    model = ToadMIL(cfg32)
    model.load_state_dict(load_params_any(workdir / "results" / "smoke_f32_s1" / "s_0_checkpoint.pt", cfg32))
    with torch.no_grad():
        model.attn["a"].weight[0, 0] = float("nan")
    eval_step = make_eval_step(model.cuda().eval())
    cuda_pool.LAUNCHES = 0
    enable_debug_nans()
    try:
        eval_step(bd)
    except FloatingPointError as e:
        caught = str(e)
    else:
        raise AssertionError("enable_debug_nans() did not catch the NaN out of K1")
    finally:
        enable_debug_nans(False)
    k1 = cuda_pool.LAUNCHES
    if k1 != 1 or "ToadMIL" not in caught:
        raise AssertionError(f"enable_debug_nans: K1 launches {k1} (want 1), raised {caught!r}")
    log(f"phase 14 checked step (B=4 x {batch.bucket} x 1024, f32, on the card): parameters within {worst:.1e} of the "
        f"production step's (tolerance {TOL_CHECKED_STEP} of each one's largest entry); refused with the state's bytes "
        f"unchanged: {'; '.join(refused)}; enable_debug_nans() with a NaN in attn.a.weight of smoke_f32's checkpoint: "
        f"K1 launched {k1} time, FloatingPointError \"{caught}\"; {time.perf_counter() - t0:.1f} s")
    return dict(k1_bf16_launches=int(counts.group(2)), k1_f32_launches=k1, launches_per_step=statistics.mean(launches),
                busy=busy / window, step_busy=sum(step_busy) / sum(step_host), wall=wall)


def check_probe(name: str, got: torch.Tensor, want: torch.Tensor, tol: float) -> tuple[float, float]:
    """For a probe output [B, 8, H]: (max abs error, the largest error of a
    task row relative to that row's largest |want|); raises above ``tol``
    relative, on a shape mismatch or a non-finite value."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite values")
    diff = (got - want).abs()
    rel = (diff.amax(dim=(0, 2)) / want.abs().amax(dim=(0, 2)).clamp_min(1e-30)).max().item()
    if rel > tol:
        raise AssertionError(f"{name}: max abs err {diff.max().item():.3e}, {rel:.3e} of a task row's largest output, over {tol}")
    return diff.max().item(), rel


def probe_operands(seed: int, dev: torch.device):
    """The probes' trunk and gate weights with seeded biases (so that the bias
    paths are compared) and a seeded Wc over all 8 task columns (the probes'
    own has 2, the rest zero): (bf16 params, the same with bc shifted by +3
    for nosoftmax, whose denominators then stay positive and its outputs O(1),
    int8 qparams, h_only qparams, int8 qparams whose b1 pushes half of h1 past
    127)."""
    from toad_tpu_torch.ops import probe_pool, probe_pool_int8

    g = torch.Generator(device=dev).manual_seed(seed + 10)

    def bias(n, shift=0.0):
        return torch.randn(n, device=dev, generator=g) * 0.05 + shift

    w1, _, w2, _, wab, _, _, _ = probe_pool.probe_weights(0, dev)
    wc = (torch.randn(384, 8, device=dev, generator=g) * 0.5).to(torch.bfloat16)
    params = (w1, bias(512), w2, bias(512), wab, bias(768), wc, bias(8))
    params_pos = params[:7] + (params[7] + 3.0,)
    qbias = (bias(512), bias(512), bias(768), bias(8))

    def q(h_only, b1_shift=0.0):
        qp = list(probe_pool_int8.probe_qparams(0, h_only=h_only, device=dev))
        qp[2], qp[5], qp[8], qp[9], qp[10] = qbias[0].clone(), qbias[1], qbias[2], wc, qbias[3]
        qp[2][:256] += b1_shift
        return tuple(qp)

    return params, params_pos, q(False), q(True), q(False, 150.0)


@restores_tf32
def phase_probes(seed: int, gpu: str) -> dict:
    """Phase 10, the pooling-kernel probes: every instance of the two probe
    kernels against its plain version, K1 at 2,048-row splits against its
    default plan, each timed against its plain version at the probes' shape;
    then the probes' main() in process (the main path: counts from 0) and
    one child process as a user starts it."""
    import contextlib
    import io

    from toad_tpu_torch.experiments import int8_probe, longbag_probe, mfu_probe
    from toad_tpu_torch.ops import cuda_pool, probe_pool, probe_pool_int8
    from toad_tpu_torch.ops.fused_pool import plain_pool
    from toad_tpu_torch.ops.quantize import quantize_rows

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    model = seeded_model(seed).cuda().eval()  # outside inference_mode: its weights keep their version counters
    params, params_pos, qp, qp_h, qp_sat = probe_operands(seed, dev)
    ops, ops_pos = probe_pool.pack_probe_params(params), probe_pool.pack_probe_params(params_pos)
    qops = {False: probe_pool_int8.pack_probe_qparams(qp), True: probe_pool_int8.pack_probe_qparams(qp_h)}
    ops_sat = probe_pool_int8.pack_probe_qparams(qp_sat)

    def int8_args(variant, x):
        h_only = variant == "int8_h_only"
        xs = quantize_rows(x.float()) if variant in probe_pool_int8.PREQUANTIZED else (x, None)
        return (qp_h if h_only else qp), qops[h_only], xs

    def compare(x, mask, label, tile=1024):
        """Every kernel instance against its plain version on (x, mask) at the
        probe's ``tile``, bag 1 fully masked: the largest error of each, and
        the plain outputs."""
        errs, wants = {}, {}
        cases = [(v, lambda v=v: probe_pool.probe_pool(ops_pos if v == "nosoftmax" else ops, x, mask, v, tile),
                  lambda v=v: probe_pool.plain_probe_pool(params_pos if v == "nosoftmax" else params, x, mask, v, tile))
                 for v in probe_pool.KERNEL_VARIANTS]
        for v in probe_pool_int8.VARIANTS:
            q, o, (xin, sx) = int8_args(v, x)
            cases.append((v, lambda o=o, xin=xin, sx=sx, v=v: probe_pool_int8.probe_pool_int8(o, xin, sx, mask, v),
                          lambda q=q, xin=xin, sx=sx, v=v: probe_pool_int8.plain_probe_pool_int8(q, xin, sx, mask, v)))
        for variant, kernel, plain in cases:
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            err, rel = check_probe(f"probe {variant} {label}", got, want, TOL_PROBE)
            if variant != "trunkonly" and got[1].abs().max().item() != 0.0:  # trunkonly ignores the mask, as the probe does
                raise AssertionError(f"probe {variant} {label}: the fully masked bag pooled to nonzero M")
            errs[variant], wants[variant] = err, want
            log(f"phase 10 compare probe {variant} {label}: max abs err {err:.3e}, {rel:.2e} of its task row's largest "
                f"|output| at most (tolerance {TOL_PROBE})")
        return errs, wants

    # 1. kernel vs plain, B=4 x 4,096: bag 0 ragged, bag 1 fully masked, bag 2 ragged, bag 3 live on 2,500 rows
    g = torch.Generator(device=dev).manual_seed(seed + 11)
    b, n, tile = 4, 4096, 1024
    x = torch.randn(b, n, 1024, device=dev, generator=g).to(torch.bfloat16)
    mask = (torch.rand(b, n, device=dev, generator=g) < 0.9).float()
    mask[1] = 0.0
    mask[3, 2500:] = 0.0
    with torch.inference_mode():
        errs, wants = compare(x, mask, f"B={b} N={n}")
        # the limit separates a wrong kernel: a wrong gate, or softmax weights that ignore the scores
        wrong = {"nogate's gate": wants["nogate"],
                 "uniform softmax weights": probe_pool.plain_probe_pool(
                     params[:6] + (torch.zeros_like(params[6]), torch.zeros_like(params[7])), x, mask, "full", tile)}
        for what, other in wrong.items():
            d = ((other - wants["full"]).abs().amax(dim=(0, 2)) / wants["full"].abs().amax(dim=(0, 2))).min().item()
            if d < PROBE_SEPARATION * TOL_PROBE:
                raise AssertionError(f"probe compare: {what} moves the plain output by only {d:.2e} of a task row's largest "
                                     f"|value|, under {PROBE_SEPARATION} x the tolerance {TOL_PROBE}")
            log(f"phase 10 compare probe: {what} would move full's output by {d:.2e} of its task row's largest |value| in the "
                f"least moved row ({d / TOL_PROBE:.0f} x the tolerance {TOL_PROBE})")
        xq, sx = quantize_rows(x.float())
        err, rel = check_probe("probe int8_gemms, h1 past 127", probe_pool_int8.probe_pool_int8(ops_sat, xq, sx, mask, "int8_gemms"),
                               probe_pool_int8.plain_probe_pool_int8(qp_sat, xq, sx, mask, "int8_gemms"), TOL_PROBE)
        errs["int8_gemms"] = max(errs["int8_gemms"], err)
        log(f"phase 10 compare probe int8_gemms with b1 pushing h1 past 127 (the saturating cast): max abs err "
            f"{err:.3e}, {rel:.2e} of its task row's largest |output| at most")
        before = probe_pool.LAUNCHES
        for bad, kw in (((3, 4096), dict(variant="b2", tile=1024)), ((4, 4096), dict(variant="full", tile=1000))):
            try:
                probe_pool.probe_pool(ops, x[: bad[0]], mask[: bad[0]], **kw)
            except ValueError as e:
                log(f"phase 10 compare probe: refused without a launch: {e}")
            else:
                raise AssertionError(f"the probe kernel took {bad} {kw}")
        if probe_pool.LAUNCHES != before:
            raise AssertionError("a refused probe call counted as a launch")

        # rows that end mid-tile: at N = 4,160 each single-bag instance's last 128-row tile holds 64 rows past the
        # bag's end (zero-filled, excluded by their index, in trunkonly too) and the pair runs 64 + 64 rows a tile
        x2, m2 = torch.randn(2, 4160, 1024, device=dev, generator=g).to(torch.bfloat16), torch.ones(2, 4160, device=dev)
        m2[1] = 0.0
        m2[0, 4100:] = 0.0
        errs_mid, _ = compare(x2, m2, "B=2 N=4160 tile 64", tile=64)
        errs = {k: max(v, errs_mid[k]) for k, v in errs.items()}
        del x2, m2

        # 2. K1 at 2,048-row splits (the long-bag probe's tiling) vs its default plan and the plain version
        k1_ops, k1_params = model.kernel_operands(torch.bfloat16), cast_params(model.pool_params(), torch.bfloat16)
        xl = torch.randn(1, 131072, 1024, device=dev, generator=g).to(torch.bfloat16)
        ml = (torch.rand(1, 131072, device=dev, generator=g) < 0.95).float()
        m_split, _ = cuda_pool.pool(k1_ops, xl, ml, False, rows_per_split=2048)
        m_default, _ = cuda_pool.pool(k1_ops, xl, ml, False)
        m_plain, _ = plain_pool(k1_params, xl, ml, torch.bfloat16, False)
        torch.cuda.synchronize()
        e_split = check_close("K1 at 2,048-row splits vs its default plan", m_split, m_default, TOL_SPLIT)
        e_split_plain = check_close("K1 at 2,048-row splits vs plain_pool", m_split, m_plain, TOL_BF16_M)
        errs["split_2048"] = max(e_split, e_split_plain)
        p6_per, p6_splits = cuda_pool.fixed_split_plan(131072, cuda_pool.plan(torch.bfloat16, 512, 384).rows, 2048)
        log(f"phase 10 compare K1 B=1 N=131072 bf16 at 2,048-row splits ({p6_splits} splits of {p6_per} tiles): vs the "
            f"default plan {e_split:.3e}, vs plain_pool {e_split_plain:.3e} (tolerance {TOL_SPLIT})")

        # 3. kernel vs plain at the main path's shape, B=32 x 8,192, where each block runs several row tiles
        # (the running max and sums rescaled across tiles) and some blocks of the ragged bag see only padding:
        # bag 0 ragged, bag 1 fully masked, bag 3 live on 2,500 rows
        bt, nt = 32, 8192
        n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
        plans = {"single-bag instances": probe_pool.split(bt, nt, False, n_sms),
                 "b2 (64 + 64 rows a tile)": probe_pool.split(bt, nt, True, n_sms),
                 "int8": probe_pool_int8.split(bt, nt, n_sms)}
        if min(per for per, _ in plans.values()) < 2:
            raise AssertionError(f"the compare at B={bt} N={nt} runs one row tile a block: {plans}")
        xt = torch.randn(bt, nt, 1024, device=dev, generator=g).to(torch.bfloat16)
        mc = torch.ones(bt, nt, device=dev)
        mc[0] = (torch.rand(nt, device=dev, generator=g) < 0.9).float()
        mc[1] = 0.0
        mc[3, 2500:] = 0.0
        errs_main, _ = compare(xt, mc, f"B={bt} N={nt}")
        errs = {k: max(v, errs_main.get(k, 0.0)) for k, v in errs.items()}
        log(f"phase 10 compare probe at B={bt} N={nt}: (row tiles a block, blocks a bag) " +
            ", ".join(f"{k} {v}" for k, v in plans.items()))
        del mc

        # 4. timing at the probes' shape, B=32 x 8,192 (kernel vs plain, bound from the work each instance does)
        times = {}
        mt = torch.ones(bt, nt, device=dev)
        out_bytes = bt * 8 * 512 * 4
        for variant in probe_pool.KERNEL_VARIANTS:
            p, o = (params_pos, ops_pos) if variant == "nosoftmax" else (params, ops)
            times[variant] = time_pair(
                f"probe {variant} B={bt} N={nt}", lambda p=p, v=variant: probe_pool.plain_probe_pool(p, xt, mt, v, tile),
                lambda o=o, v=variant: probe_pool.probe_pool(o, xt, mt, v, tile),
                dict(bytes=nbytes(xt, mt, *o) + out_bytes, ops=probe_pool.ops_per_row(variant) * bt * nt, kind="bf16"), gpu)
        for variant in probe_pool_int8.VARIANTS:
            q, o, (xin, sx) = int8_args(variant, xt)
            inputs = (xin, mt) + ((sx,) if sx is not None else ())
            times[variant] = time_pair(
                f"probe {variant} B={bt} N={nt}",
                lambda q=q, xin=xin, sx=sx, v=variant: probe_pool_int8.plain_probe_pool_int8(q, xin, sx, mt, v),
                lambda o=o, xin=xin, sx=sx, v=variant: probe_pool_int8.probe_pool_int8(o, xin, sx, mt, v),
                dict(bytes=nbytes(*inputs, *o) + out_bytes,
                     ops={k: v * bt * nt for k, v in probe_pool_int8.ops_per_row(variant).items()}), gpu)
            del xin, sx
        del xt
        ml1 = torch.ones(1, 131072, device=dev)
        times["split_2048"] = time_pair(
            "K1 bf16 B=1 N=131072 at 2,048-row splits", lambda: plain_pool(k1_params, xl, ml1, torch.bfloat16, False),
            lambda: cuda_pool.pool(k1_ops, xl, ml1, False, rows_per_split=2048),
            dict(bytes=nbytes(xl, ml1, *k1_ops) + 2 * 512 * 4, ops=cuda_pool.flops_per_row(1024, 512, 384) * 131072,
                 kind="bf16"), gpu)
        t_default = cuda_ms(lambda: cuda_pool.pool(k1_ops, xl, ml1, False))
        log(f"phase 10 timing K1 bf16 B=1 N=131072 under its default plan: {t_default:.3f} ms [{gpu}]")
        del xl, model
    elapsed_compare = time.perf_counter() - t0

    # 5. the main path: the probes' entry points in process, each kernel's count from 0
    def run_main(fn, argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = fn(argv)
        if rc != 0:
            raise AssertionError(f"{fn.__module__}.main({argv}) returned {rc}")
        lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
        for line in lines:
            log(f"phase 10 {fn.__module__.rsplit('.', 1)[-1]} {' '.join(argv)}: {json.dumps(line)} [{gpu}]")
        return lines

    probe_pool.reset_launches()
    mfu_lines = run_main(mfu_probe.main, [])
    launches = {("mfu", k): v for k, v in probe_pool.INSTANCE_LAUNCHES.items()}
    if [line["variant"] for line in mfu_lines] != mfu_probe.DEFAULT_VARIANTS.split(","):
        raise AssertionError(f"mfu_probe printed {len(mfu_lines)} lines for {mfu_probe.DEFAULT_VARIANTS}")
    probe_pool.reset_launches()
    probe_pool_int8.reset_launches()
    int8_lines = run_main(int8_probe.main, []) + run_main(int8_probe.main, ["--variants", "int8_inquant_bf16,int8_h_only"])
    launches[("int8", "bf16")] = probe_pool.INSTANCE_LAUNCHES["full"]
    launches.update({("int8", k): v for k, v in probe_pool_int8.INSTANCE_LAUNCHES.items()})
    if len(int8_lines) != 6:
        raise AssertionError(f"int8_probe printed {len(int8_lines)} lines for 6 variants")
    cuda_pool.LAUNCHES = 0
    long_lines = run_main(longbag_probe.main, [])
    launches[("long", "split_2048")] = long_lines[-1]["k1_launches"]
    if [line["arm"] for line in long_lines] != ["full_bump", "element_bump", "split_2048"] or cuda_pool.LAUNCHES != sum(
            line["k1_launches"] for line in long_lines):
        raise AssertionError(f"longbag_probe's arms or K1 launches do not add up: {long_lines}, {cuda_pool.LAUNCHES}")
    for line in mfu_lines + int8_lines + long_lines:
        rate = line.get("tflops_counted", line.get("tops_counted"))
        if not (rate and rate > 0 and line["device"] == torch.cuda.get_device_name(0)):
            raise AssertionError(f"a probe line without a positive rate on the card: {line}")
    zero = [k for k, v in launches.items() if v == 0]
    if zero:
        raise AssertionError(f"probe kernels never launched on the main path: {zero}")
    by_probe = {probe: {k: v for (p, k), v in launches.items() if p == probe} for probe in ("mfu", "int8")}
    log(f"phase 10 main path launches (counted from 0 before each probe): mfu_probe {by_probe['mfu']}, "
        f"int8_probe {by_probe['int8']}, longbag_probe K1 at 2,048-row splits "
        f"{launches[('long', 'split_2048')]} (K1 in all its arms {cuda_pool.LAUNCHES})")

    # 6. one child process as a user starts it
    t_child = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "toad_tpu_torch.experiments.mfu_probe", "--variants", "full", "--k", "4",
                          "--runs", "1"], cwd=REPO, env=child_env(), capture_output=True, text=True, timeout=300)
    if out.returncode != 0:
        raise AssertionError(f"python -m toad_tpu_torch.experiments.mfu_probe failed ({out.returncode}):\n{out.stderr[-3000:]}")
    child = json.loads(out.stdout.strip().splitlines()[-1])
    if child["variant"] != "full" or not child["tflops_counted"] > 0:
        raise AssertionError(f"unexpected child line {child}")
    log(f"phase 10 child process `python -m toad_tpu_torch.experiments.mfu_probe --variants full --k 4 --runs 1`: "
        f"{json.dumps(child)} in {time.perf_counter() - t_child:.1f} s [{gpu}]")
    log(f"phase 10: {time.perf_counter() - t0:.1f} s (comparisons and timing {elapsed_compare:.1f} s)")
    return dict(errs=errs, times=times, launches=launches)


def probe_records(probes: dict) -> list[dict]:
    """The kernels line's entries of phase 10: each kernel instance with the
    TPU kernel it replaces, its launches on the main path, its error and its
    times (P5, the int8 probe's bf16 baseline, is full's instance)."""
    pool_src, int8_src = "toad_tpu_torch/csrc/pool_probe.cu", "toad_tpu_torch/csrc/pool_int8_probe.cu"
    rows = [(f"probe_pool_{v}", pool_src, "experiments/mfu_probe.py:52", ("mfu", v), v)
            for v in ("full", "exp2", "nogate", "nosoftmax", "trunkonly")]
    rows += [("probe_pool_b2", pool_src, "experiments/mfu_probe.py:162", ("mfu", "b2"), "b2"),
             ("probe_pool_bf16 (full's instance)", pool_src, "experiments/int8_probe.py:238", ("int8", "bf16"), "full")]
    rows += [(f"probe_{v}", int8_src, f"experiments/int8_probe.py:{59 if v in ('int8_chain', 'int8_gemms') else 134}",
              ("int8", v), v) for v in ("int8_chain", "int8_gemms", "int8_inquant", "int8_inquant_bf16", "int8_h_only")]
    rows += [("pool_rows_per_split_2048 (K1)", "toad_tpu_torch/csrc/pool.cu", "experiments/longbag_probe.py:127",
              ("long", "split_2048"), "split_2048")]
    return [dict(name=name, route="cuda", source=src, replaces=rep, launches=probes["launches"][key],
                 max_abs_err=probes["errs"][which], **probes["times"][which]) for name, src, rep, key, which in rows]


# the ViT probes in the order phase 11 runs them, each probe's arms (lines) in order, and which attention
# kernel each arm must launch: (K3, P7)
VIT_PROBE_RUNS = 2  # timed runs of each arm in phase 11 (the probes' own default is 3, vit_softmax_probe's 2)
VIT_PROBE_ARMS = {
    "vit_softmax_probe": {"rep0": (True, True), "rep1": (True, True), "rep2": (True, True), "deviation": (True, True)},
    "vit_attn_probe": {"A_full": (False, False), "E_identity": (False, False), "F_dpa": (False, False),
                       "G_bf16_scores": (False, False)},
    "vit_ceiling2_probe": {"A_full_fused": (True, False), "B_identity_attn": (False, False),
                           "C_fused_no_ln": (True, False), "D_identity_no_ln": (False, False)},
    "vit_elementwise_probe": {"A_prod": (True, False), "D1_bf16_ln": (True, False), "D2_tanh_gelu": (True, False),
                              "D3_both": (True, False)},
    "vit_profile": {"A_full": (True, False), "B_gemms": (False, False), "C_padded256": (False, False)},
    "vit_int8_probe": {"A_bf16": (False, False), "B_int8_full": (False, False), "C_int8_raw": (False, False)},
}


def compare_p7(seed: int) -> dict:
    """P7 against plain_mha_new at ViT-L/16 width (16 heads of 64), and K3
    against the same plain version: the largest error of P7's cases."""
    from toad_tpu_torch.ops import cuda_mha
    from toad_tpu_torch.ops.vit_attention import fused_mha, fused_mha_new, plain_mha_new

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed + 20)
    worst = 0.0
    # B=128 and B=8 x 197 are the probes' own shapes (vit_softmax_probe's timed reps and its deviation arm)
    for dt, b, n in ((torch.bfloat16, 128, 197), (torch.bfloat16, 64, 197), (torch.bfloat16, 8, 197),
                     (torch.bfloat16, 3, 197), (torch.bfloat16, 8, 272), (torch.float32, 64, 197), (torch.float32, 3, 197)):
        qkv = torch.randn(b, n, 3 * 16 * 64, device=dev, generator=g).to(dt)
        with torch.inference_mode():
            got, want, k3 = fused_mha_new(qkv, 16, 64), plain_mha_new(qkv, 16, 64), fused_mha(qkv, 16, 64)
        torch.cuda.synchronize()
        label = f"P7 {str(dt)[6:]} B={b} N={n}"
        tol = TOL_MHA_BF16 if dt == torch.bfloat16 else TOL_MHA_F32
        err = check_close(label, got, want, tol)
        share = (got != want).float().mean().item()
        k3_err = (k3.float() - want.float()).abs().max().item()
        k3_share = (k3 != want).float().mean().item()
        worst = max(worst, err)
        text = (f"phase 11 compare {label} H=16 Dh=64 vs plain_mha_new: max abs err {err:.2e} (tolerance {tol}), "
                f"{share:.2e} of the elements differ; K3 vs the same plain version: max abs err {k3_err:.2e}, "
                f"{k3_share:.2e} differ")
        if dt == torch.bfloat16:
            if share > TOL_P7_SHARE:
                raise AssertionError(f"{label}: {share:.3e} of the elements differ from plain_mha_new, over {TOL_P7_SHARE}")
            if k3_share < P7_SEPARATION * TOL_P7_SHARE:
                raise AssertionError(f"{label}: K3 differs from plain_mha_new in only {k3_share:.3e} of the elements, "
                                     f"under {P7_SEPARATION} x the limit {TOL_P7_SHARE}: the check cannot tell them apart")
            text += f" ({k3_share / TOL_P7_SHARE:.0f} x the limit {TOL_P7_SHARE} on the share; K3 / P7 {k3_share / max(share, 1e-9):.0f})"
        log(text)
    before = cuda_mha.NEW_LAUNCHES
    for shape, head_dim in (((1, 273, 3 * 1024), 64), ((1, 197, 3 * 512), 32)):
        try:
            fused_mha_new(torch.zeros(shape, device=dev, dtype=torch.bfloat16), 16, head_dim)
        except ValueError as e:
            log(f"phase 11 compare P7: unsupported shape raises: {e}")
        else:
            raise AssertionError(f"P7 took unsupported shape {shape}, head_dim {head_dim}")
    if cuda_mha.NEW_LAUNCHES != before:
        raise AssertionError("a refused P7 call counted as a launch")

    # the probes' einsum arm (vit_attn A_full, vit_profile C_padded256): bf16 tensor-core products, held against
    # plain_mha (f32 products of the widened operands) at the probes' B=128 x 197 and at 256 padded tokens
    from toad_tpu_torch.experiments.vit_probe_common import einsum_attention
    from toad_tpu_torch.models.vit_encoder import ViTConfig
    from toad_tpu_torch.ops.vit_attention import plain_mha

    for b, n in ((128, 197), (128, 256)):
        qkv = torch.randn(b, n, 3 * 16 * 64, device=dev, generator=g).to(torch.bfloat16)
        with torch.inference_mode():
            err = check_close(f"einsum attention B={b} N={n}", einsum_attention(ViTConfig())(qkv), plain_mha(qkv, 16, 64),
                              TOL_MHA_BF16)
        log(f"phase 11 compare the probes' einsum attention (torch.bmm, bf16 products, f32 scores) bf16 B={b} N={n} vs "
            f"plain_mha: max abs err {err:.2e} (tolerance {TOL_MHA_BF16})")
    return worst


@restores_tf32
def phase_vit_probes(seed: int, gpu: str) -> dict:
    """Phase 11, the ViT-L decomposition probes: P7 against its plain version
    (and K3 against P7's plain version), P7 timed against its plain version,
    K3 and the library call; then the six probes' main() in process at
    their JAX sizes (the main path: counts from 0) and one child process."""
    import contextlib
    import importlib
    import io

    import torch.nn.functional as F

    from toad_tpu_torch.ops import cuda_mha
    from toad_tpu_torch.ops.vit_attention import fused_mha, fused_mha_new, plain_mha_new

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    worst = compare_p7(seed)

    # timing at the shape a batch of 64 tiles of 224 px gives it: plain, P7, library, P7, plain, with K3 around
    b, n, heads, head_dim = 64, 197, 16, 64
    qkv = torch.randn(b, n, 3 * heads * head_dim, device=dev).to(torch.bfloat16)
    q, k, v = qkv.view(b, n, 3, heads, head_dim).permute(2, 0, 3, 1, 4)
    with torch.inference_mode():
        k3_first = cuda_ms(lambda: fused_mha(qkv, heads, head_dim), inner=20)
        times = time_pair(f"P7 bf16 B={b} N={n} H={heads} Dh={head_dim}", lambda: plain_mha_new(qkv, heads, head_dim),
                          lambda: fused_mha_new(qkv, heads, head_dim),
                          dict(bytes=nbytes(qkv) + nbytes(qkv) // 3, ops=4 * b * heads * n * n * head_dim, kind="bf16"),
                          gpu, library_fn=lambda: F.scaled_dot_product_attention(q, k, v), inner=20)
        k3_last = cuda_ms(lambda: fused_mha(qkv, heads, head_dim), inner=20)
    k3_ms = min(k3_first, k3_last)
    log(f"phase 11 timing K3 on the same qkv: {k3_ms:.3f} ms ({k3_first:.3f}/{k3_last:.3f}); K3 / P7 "
        f"{k3_ms / times['ms']:.3f} [{gpu}]")
    del qkv, q, k, v
    elapsed_compare = time.perf_counter() - t0

    # the main path: the six probes' entry points in process at their JAX sizes, the counts from 0
    launches, rates = {}, {}
    for name, want in VIT_PROBE_ARMS.items():
        cuda_mha.LAUNCHES = cuda_mha.NEW_LAUNCHES = 0
        t_probe = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = importlib.import_module(f"toad_tpu_torch.experiments.{name}").main(["--runs", str(VIT_PROBE_RUNS)])
        if rc != 0:
            raise AssertionError(f"{name}.main(['--runs', '{VIT_PROBE_RUNS}']) returned {rc}")
        lines = [json.loads(line) for line in buf.getvalue().splitlines() if line.strip()]
        if [line["arm"] for line in lines] != list(want):
            raise AssertionError(f"{name} printed the arms {[line['arm'] for line in lines]}, not {list(want)}")
        for line in lines:
            k3_on, p7_on = want[line["arm"]]
            if (line["k3_launches"] > 0) != k3_on or (line["p7_launches"] > 0) != p7_on or line["device"] != torch.cuda.get_device_name(0):
                raise AssertionError(f"{name} {line['arm']}: launches or device not as its arm says: {line}")
            values = [v for key, v in line.items() if key.endswith(("tiles_per_s", "_tflops", "tflops_counted", "ms"))]
            if line["arm"] != "deviation" and not (values and all(v is not None and v > 0 for v in values)):
                raise AssertionError(f"{name} {line['arm']}: a rate that is not positive: {line}")
            log(f"phase 11 {name}: {json.dumps(line)} [{gpu}]")
        launches[name] = (cuda_mha.LAUNCHES, cuda_mha.NEW_LAUNCHES)
        rates[name] = lines
        log(f"phase 11 {name}: K3 launches {cuda_mha.LAUNCHES}, P7 launches {cuda_mha.NEW_LAUNCHES}, "
            f"{time.perf_counter() - t_probe:.1f} s")
    dev_line = rates["vit_softmax_probe"][-1]
    if not all(0 <= dev_line[k] < 0.1 for k in ("old_kernel", "new_kernel", "new_vs_old")):
        raise AssertionError(f"vit_softmax_probe's deviations from the f32 truth are not small: {dev_line}")

    # one child process as a user starts it
    t_child = time.perf_counter()
    cmd = [sys.executable, "-m", "toad_tpu_torch.experiments.vit_ceiling2_probe", "--k", "1", "--runs", "1"]
    out = subprocess.run(cmd, cwd=REPO, env=child_env(), capture_output=True, text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"{' '.join(cmd[1:])} failed ({out.returncode}):\n{out.stderr[-3000:]}")
    child = [json.loads(line) for line in out.stdout.strip().splitlines()]
    if [line["arm"] for line in child] != list(VIT_PROBE_ARMS["vit_ceiling2_probe"]) or not all(
            line[f"{line['arm']}_tiles_per_s"] > 0 for line in child):
        raise AssertionError(f"unexpected child lines {child}")
    log(f"phase 11 child process `python -m toad_tpu_torch.experiments.vit_ceiling2_probe --k 1 --runs 1`: "
        f"{len(child)} lines, {'; '.join(json.dumps(line) for line in child)} in {time.perf_counter() - t_child:.1f} s [{gpu}]")
    log(f"phase 11: {time.perf_counter() - t0:.1f} s (comparisons and timing {elapsed_compare:.1f} s)")
    return dict(worst=worst, times=times, launches=launches["vit_softmax_probe"][1])


def run_probe(name: str, argv: list[str], workdir: Path, gpu: str) -> tuple[list[str], float]:
    """``python -m toad_tpu_torch.experiments.NAME ARGV`` as a child process in
    ``workdir``: its stdout lines (each logged) and its wall seconds."""
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m", f"toad_tpu_torch.experiments.{name}", *argv]
    run = subprocess.run(cmd, cwd=workdir, env=child_env(), capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if run.returncode != 0:
        raise AssertionError(f"{name} {argv} failed ({run.returncode}):\n{run.stdout[-3000:]}{run.stderr[-3000:]}")
    lines = [line for line in run.stdout.splitlines() if line.strip()]
    for line in lines:
        log(f"phase 15 {name}: {line} [{gpu}]")
    log(f"phase 15 {name}: child process {wall:.1f} s")
    return lines, wall


def probe_json(name: str, lines: list[str], keys: list[str]) -> list[dict]:
    """The probe's JSON lines, each holding ``keys`` first and in that order."""
    out = [json.loads(line) for line in lines]
    bad = [line for line in out if list(line)[:len(keys)] != keys]
    if not out or bad:
        raise AssertionError(f"{name}: a line without the JAX probe's keys {keys}: {bad or 'no line'}")
    return out


def phase_probe_children(card: str, gpu: str, workdir: Path) -> dict:
    """Phase 15, the disk-fed and ceiling probes as child processes at their
    JAX sizes: the fixture written once in ``workdir``, then io_overlap_probe
    and bf16_transfer_probe (K1 bf16 through TOAD's forward; both arms' per-
    slide y_prob equal), patient_native_probe (host only), matmul_ceiling,
    encoder_batch_ab and encoder_stages (cuBLAS and cuDNN); every arm's line
    parsed."""
    from toad_tpu_torch.data.synthetic import write_io_fixture
    from toad_tpu_torch.experiments import encoder_batch_ab, io_overlap_probe as iop, matmul_ceiling, patient_native_probe

    t0 = time.perf_counter()
    write_io_fixture(workdir, iop.N_SLIDES, iop.BAG_N, iop.DIM)  # reuses what the writer thread wrote
    log(f"phase 15 fixture: {iop.N_SLIDES} .pt bags of {iop.BAG_N} x {iop.DIM} f32 and io_{iop.N_SLIDES}.csv in "
        f"{workdir.name}, ready in {time.perf_counter() - t0:.1f} s (written beside phases 10 and 11)")
    data = ["--data_dir", str(workdir)]
    walls = {}
    # each A/B probe: 2 arms x (a warm-up epoch + RUNS x EPOCHS timed ones + one collecting y_prob) x its batches an epoch
    k1_want = 2 * (1 + iop.RUNS * iop.EPOCHS + 1) * -(-iop.N_SLIDES // iop.BATCH)
    ab = {}
    for name, keys in (("io_overlap_probe", ["dispatch_h2d_slides_per_sec", "producer_device_put_slides_per_sec", "speedup",
                                             "max_prob_dev", "k1_launches", "device"]),
                       ("bf16_transfer_probe", ["f32_transfer_slides_per_sec", "bf16_transfer_slides_per_sec", "speedup",
                                                "max_prob_dev", "k1_launches", "device"])):
        lines, walls[name] = run_probe(name, data, workdir, gpu)
        (line,) = probe_json(name, lines, keys)
        rates = [line[k] for k in keys[:2]]
        if not (all(r > 0 for r in rates) and line["device"] == card):
            raise AssertionError(f"{name}: a rate that is not positive, or not on the card: {line}")
        if line["max_prob_dev"] != 0.0:  # both arms round to bf16 (nearest even) before the same K1 launch
            raise AssertionError(f"{name}: the arms' per-slide y_prob differ by {line['max_prob_dev']}, not 0.0")
        if line["k1_launches"] != k1_want:
            raise AssertionError(f"{name}: K1 launched {line['k1_launches']} times, not {k1_want}")
        ab[name] = line

    lines, walls["patient_native_probe"] = run_probe("patient_native_probe", data, workdir, gpu)
    cases = [f"wire={w:9s} native={n:3s}" for w in patient_native_probe.WIRES for n in patient_native_probe.NATIVE]
    if lines[0] != f"{iop.N_SLIDES // 2} patient bags, 2x{iop.BAG_N}x{iop.DIM} f32 slides each" or [
            line.split(":")[0] for line in lines[1:]] != cases:
        raise AssertionError(f"patient_native_probe: not the JAX probe's lines: {lines}")
    patient = {case: float(line.split(":")[1].split()[0]) for case, line in zip(cases, lines[1:])}

    lines, walls["matmul_ceiling"] = run_probe("matmul_ceiling", [], workdir, gpu)
    mm = probe_json("matmul_ceiling", lines, ["shape", "mkn", "tflops", "pct_peak", "us_per_call"])
    if [(line["shape"], *line["mkn"]) for line in mm] != [tuple(s) for s in matmul_ceiling.SHAPES] or not all(
            line["tflops"] > 0 for line in mm):
        raise AssertionError(f"matmul_ceiling: not the 8 shapes with a positive rate: {mm}")

    lines, walls["encoder_batch_ab"] = run_probe("encoder_batch_ab", [], workdir, gpu)
    batches = encoder_batch_ab.BATCHES
    reps = [line for line in lines if line.startswith("rep")]
    if lines[:len(batches)] != [f"compiled B={b}" for b in batches] or len(reps) != encoder_batch_ab.REPS or any(
            [arm.split(":")[0] for arm in line.split(": ", 1)[1].split("  ")] != [f"B={b}" for b in batches] for line in reps):
        raise AssertionError(f"encoder_batch_ab: not the JAX probe's lines: {lines}")

    lines, walls["encoder_stages"] = run_probe("encoder_stages", [], workdir, gpu)
    stages = probe_json("encoder_stages", lines, ["stage", "tflops"])
    want = ["stem+pool", "layer1", "layer2", "layer3", "full", "conv_ceiling_3x3_256ch_16px", "conv_ceiling_3x3_128ch_64px"]
    if [line["stage"] for line in stages] != want or not all(line["tflops"] > 0 for line in stages):
        raise AssertionError(f"encoder_stages: not the JAX probe's stages with a positive rate: {stages}")

    io_line, bf_line = ab["io_overlap_probe"], ab["bf16_transfer_probe"]
    log(f"phase 15 summary: the producer's copy / a copy at dispatch x{io_line['speedup']}, the bf16 wire / the f32 wire "
        f"x{bf_line['speedup']} (y_prob equal across arms in both); patient bags, native / numpy feed: " + ", ".join(
            f"{w} x{patient[f'wire={w:9s} native=off'] / max(patient[f'wire={w:9s} native=on '], 1e-9):.2f}"
            for w in patient_native_probe.WIRES)
        + f"; cuBLAS bf16 {max(line['tflops'] for line in mm)} TFLOP/s at best, "
        + ", ".join(f"{line['shape']} {line['tflops']}" for line in mm if line["shape"].startswith(("trunk", "gate")))
        + f"; the encoder {stages[4]['patches_per_sec']} tiles/s at B=128 [{gpu}]")
    log(f"phase 15: {time.perf_counter() - t0:.1f} s (children: "
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + ")")
    return dict(k1_bf16_launches=io_line["k1_launches"] + bf_line["k1_launches"])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--attention-ab", type=Path, metavar="PARENT",
                    help="only phases 1-2, the attention comparisons of phases 3 and 11, then the attention kernel "
                         "of the package checkout PARENT timed against this tree's (parent, this, this, parent)")
    ap.add_argument("--time-attention", type=Path, metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--stage-ab", type=Path, metavar="PARENT",
                    help="only phases 1-2 and the stage comparisons of phase 9, then the stage kernel of the package "
                         "checkout PARENT timed against this tree's (parent, this, this, parent), their outputs "
                         "required to be the same bits")
    ap.add_argument("--time-stage", type=Path, metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--pool-ab", type=Path, metavar="PARENT",
                    help="only phases 1-2 and the K2 comparisons of phase 3, then K2 and the int8 probe's instances "
                         "of the package checkout PARENT timed against this tree's (parent, this, this, parent), K2 "
                         "held to plain_int8_pool in every run and faster than the parent, its M close to the "
                         "parent's, and the controls (K1 both dtypes, K1p, P6, the bf16 sharded pool, P1 full, "
                         "P3/P4) required to be the same bits")
    ap.add_argument("--time-pool", type=Path, metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--k2-ablations", nargs="*", type=Path, metavar="DIR",
                    help="only phases 1-2, then K2 at B=32 x 8,192 against builds of it without products, without "
                         "weight copies and without the requantization, and against the package checkouts DIR (other "
                         "designs of K2) if given (kernel, each, kernel)")
    ap.add_argument("--time-k2", type=Path, metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--mesh-cards", action="store_true",
                    help="only phases 1-2, then the mesh with each cell on its own card (two or more cards)")
    args = ap.parse_args()

    # a child of --attention-ab, --stage-ab, --pool-ab or --k2-ablations: the package under ROOT
    child = args.time_attention or args.time_stage or args.time_pool or args.time_k2
    if child is not None:
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda.is_available() is False: this check needs a CUDA GPU")
        sys.path.insert(0, str(child.resolve()))
        timer = time_attention if args.time_attention else functools.partial(
            time_stage if args.time_stage else time_pool if args.time_pool else time_k2, args.seed)
        print(json.dumps(timer()))
        return 0
    t_start = time.perf_counter()
    if args.mesh_cards or args.k2_ablations is not None:
        card, gpu = phase_device()
        log(gpu)
        phase_build(gpu)
        if args.mesh_cards:
            mesh_cards(args.seed, gpu)
        else:
            k2_ablations(gpu, [d.resolve() for d in args.k2_ablations])
        log(f"all phases: {time.perf_counter() - t_start:.1f} s")
        return 0
    if args.attention_ab is not None or args.stage_ab is not None or args.pool_ab is not None:
        card, gpu = phase_device()
        log(gpu)
        phase_build(gpu)
        if args.attention_ab is not None:
            phase_compare_mha(args.seed)
            compare_p7(args.seed)
            ab_runs("--time-attention", "attention", args.attention_ab.resolve(), gpu)
        if args.stage_ab is not None:
            phase_compare_stage(seeded_resnet(args.seed).fold_bn().cuda(), args.seed)
            stage_ab(args.stage_ab.resolve(), gpu)
        if args.pool_ab is not None:
            phase_compare_int8(seeded_model(args.seed).cuda().eval(), args.seed)
            pool_ab(args.pool_ab.resolve(), gpu)
        log(f"all phases: {time.perf_counter() - t_start:.1f} s")
        return 0

    def elapsed(after: str) -> None:
        log(f"elapsed after {after}: {time.perf_counter() - t_start:.1f} s")

    card, gpu = phase_device()
    log(gpu)
    phase_build(gpu)
    elapsed("phase 2")
    model = seeded_model(args.seed).cuda().eval()
    worst = phase_compare(model, args.seed)
    worst_partial, worst_combine, worst_sharded = phase_compare_partial(model, args.seed)
    sharded = drive_bag_sharded(model, args.seed)
    worst8 = phase_compare_int8(model, args.seed)
    phase_compare_ungated(args.seed)
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
    # phase 9's directory (patch files, the seeded .pth, its bags) stays for phase 12's infer --patches
    # phase 7's cohort and phase 15's fixture are written on a thread while phases 10 and 11 keep the card busy;
    # the executor's exit waits for it before the directories go
    with tempfile.TemporaryDirectory(prefix="toad_smoke_resnet_") as resnet_tmp, \
            tempfile.TemporaryDirectory(prefix="toad_smoke_train_") as tmp, \
            tempfile.TemporaryDirectory(prefix="toad_smoke_probes_") as probes_tmp, \
            concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix="smoke-writer") as writer:
        resnet = phase_resnet(args.seed, card, gpu, Path(resnet_tmp))
        elapsed("phase 9")
        cohort = writer.submit(write_fixtures, args.seed, Path(tmp), Path(probes_tmp))
        probes = phase_probes(args.seed, gpu)
        elapsed("phase 10")
        vit_probes = phase_vit_probes(args.seed, gpu)
        elapsed("phase 11")
        trained = phase_train(args.seed, card, gpu, Path(tmp), cohort.result())
        elapsed("phase 7")
        evaluated = phase_eval(trained, card, gpu, Path(tmp))
        elapsed("phase 8")
        inferred = phase_infer(model, trained, evaluated, card, gpu, Path(tmp), Path(resnet_tmp))
        elapsed("phase 12")
        ensembled = phase_serve_ensemble(trained, card, gpu, Path(tmp), args.seed)
        elapsed("phase 13")
        tooled = phase_ops_tooling(trained, card, gpu, Path(tmp), args.seed)
        elapsed("phase 14")
        probed = phase_probe_children(card, gpu, Path(probes_tmp))
        elapsed("phase 15")
        meshed = phase_mesh(trained, card, gpu, Path(tmp), Path(resnet_tmp), args.seed)
        elapsed("phase 16")
    times = phase_timing(model, gpu)
    times.update(phase_timing_train(gpu, args.seed))
    elapsed("phase 6")
    mha = times[("mha_bf16", 64)]
    log(f"phase 6 timing encoder: ViT-L/16 bf16, {featurized['batch_ms']:.2f} ms per batch of "
        f"{featurized['batch_size']} tiles ({featurized['batch_size'] / featurized['batch_ms'] * 1e3:.1f} tiles/s); "
        f"its {featurized['depth']} attention launches take {featurized['depth'] * mha['ms']:.2f} ms = "
        f"{100 * featurized['depth'] * mha['ms'] / featurized['batch_ms']:.1f} % of it [{gpu}]")
    k1_ms, pt = times[("bfloat16", 32)]["ms"], {v: r["ms"] for v, r in probes["times"].items()}
    # P1 runs the mma.sync pass that K1 bf16 ran before its wgmma GEMMs: its ladder splits that pass, not K1's
    log(f"phase 10 ladder of P1 (K1 bf16's mma.sync pass), B=32 x 8,192: P1 full {pt['full']:.3f} ms = "
        f"{pt['full'] / k1_ms:.2f} x K1 bf16 "
        f"({k1_ms:.3f} ms in phase 6); " + ", ".join(
            f"full - {v} {pt['full'] - pt[v]:+.3f} ms ({100 * (pt['full'] - pt[v]) / pt['full']:+.1f} % of full)"
            for v in ("nogate", "nosoftmax", "trunkonly", "exp2")) + f"; b2 {pt['b2']:.3f} ms [{gpu}]")
    k2_ms = times[("int8", 32)]["ms"]
    log(f"phase 10 ladder of P3/P4 (the mma.sync pass K2 ran before its wgmma GEMMs), B=32 x 8,192, beside K2 "
        f"({k2_ms:.3f} ms in phase 6): " + int8_ladder(
        {v: pt[v] for v in ("int8_chain", "int8_gemms", "int8_inquant", "int8_inquant_bf16", "int8_h_only")}, k2_ms)
        + f" [{gpu}]")
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
            # the bf16 instance: the bf16 serving burst, the eval --bf16 passes, phase 14's profiled bf16 trainer and
            # phase 15's io_overlap_probe and bf16_transfer_probe children
            "launches": served["launches"] + evaluated["k1_bf16_launches"] + tooled["k1_bf16_launches"]
            + probed["k1_bf16_launches"],
            "max_abs_err": worst[torch.bfloat16],
            **times[("bfloat16", 32)],
        },
        {
            "name": "fused_trunk_attention_pool (f32)",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool.cu",
            "replaces": "toad_tpu/ops/pallas_pool.py:93",
            # the f32 instance, the default of eval, train, predict, infer and serve: the f32 eval passes, the f32
            # trainer's passes, phase 12's predict child and in-process infer (scored mode), and phase 13's
            # `serve --ensemble` child (two launches a batch, its /heatmap among them), and phase 14's eval step under
            # enable_debug_nans()
            "launches": evaluated["k1_f32_launches"] + trained["launches"] + inferred["k1_f32_launches"]
            + ensembled["k1_launches"] + tooled["k1_f32_launches"] + meshed["k1_f32"],
            "max_abs_err": worst[torch.float32],
            **times[("float32", 32)],
        },
        {
            "name": "int8_trunk_attention_pool",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool_int8.cu",
            "replaces": "toad_tpu/ops/pallas_pool.py:259",
            # the int8 serving burst, eval --int8, phase 12's SlideInference(int8=True) (scored mode) and phase
            # 13's int8 ensemble served in process (two launches a batch)
            "launches": served8["launches"] + evaluated["k2_launches"] + inferred["k2_launches"] + ensembled["k2_launches"],
            "max_abs_err": worst8,
            **times[("int8", 32)],
        },
        {
            "name": "vit_fused_mha",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/mha.cu",
            "replaces": "toad_tpu/ops/vit_attention.py:42",
            "launches": featurized["launches"] + featurized["profiled"]["launches"],  # the featurize child, --profile
            "max_abs_err": worst_mha,
            **mha,
        },
        {
            "name": "fused_pool_partial",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool.cu",
            "replaces": "toad_tpu/ops/pallas_pool.py:636",
            # phase 16's eval passes and serving over a bag axis (bag_sharded_pool on one card is one launch of the
            # sharded pool: phase 3 counts none here)
            "launches": sharded["partial"] + meshed["partial"],
            "max_abs_err": worst_partial,
            **times[("partial_bf16", 1)],
        },
        {
            "name": "bag_sharded_pool (one launch)",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/pool.cu",
            "replaces": "toad_tpu/parallel/bag_shard.py:77",
            # phase 3's main path: every shard in one launch, its partials merged by pool_tail at its end
            "launches": sharded["sharded"],
            "max_abs_err": max(worst_sharded, sharded["worst"]),
            **times[("sharded_pool_bf16", 1)],
        },
        {
            "name": "combine_partial_pool",
            "route": "cuda",
            # the combine kernel, a launch of its own for the mesh's shard partials (phase 16); K1, K1p and the
            # sharded pool run the same arithmetic in pool_tail at the end of their own launch
            "source": "toad_tpu_torch/csrc/pool_common.cuh",
            "replaces": "toad_tpu/parallel/bag_shard.py:28",
            "launches": sharded["combine"] + meshed["combine"],
            "max_abs_err": worst_combine,
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
        *probe_records(probes),
        {
            "name": "vit_fused_mha_new (P7)",
            "route": "cuda",
            "source": "toad_tpu_torch/csrc/mha.cu",
            "replaces": "experiments/vit_softmax_probe.py:44",
            "launches": vit_probes["launches"],  # vit_softmax_probe.main() at its JAX sizes
            "max_abs_err": vit_probes["worst"],
            **vit_probes["times"],
        },
    ]}
    log(f"phase 7 train: the trainer's validation and final passes launched the pooling kernel "
        f"{trained['launches']} times for {trained['eval_batches']} eval batches")
    log(f"phase 8 eval: the eval passes launched the float pooling kernel {evaluated['k1_f32_launches']} times in f32 and "
        f"{evaluated['k1_bf16_launches']} in bf16, and the int8 pooling kernel {evaluated['k2_launches']} times, one per "
        f"eval batch (serving bursts: {served['launches']} and {served8['launches']})")
    log(f"phase 12 infer: predict launched K1 f32 in scored mode once a slide, {inferred['predict_rate']:.2f} slides/s by the "
        f"CLI's clock; phase 12's launches: K1 f32 {inferred['k1_f32_launches']}, K2 {inferred['k2_launches']}; scored mode at "
        f"B=1 costs " + ", ".join(f"{100 * (v['scored'] / v['classification'] - 1):+.1f} % at {n} rows"
                                  for n, v in inferred["scored"].items()) + f" [{gpu}]")
    fw = ensembled["forward"]
    log(f"phase 13 ensemble: serve --ensemble launched K1 f32 {ensembled['k1_launches']} times (2 a batch), the int8 "
        f"ensemble K2 {ensembled['k2_launches']} times; {ensembled['rps']:.2f} requests/s, p50 {ensembled['p50'] * 1e3:.1f} "
        f"ms over the burst of 24 (its first member alone: {ensembled['single']['rps']:.2f} requests/s); a "
        f"batch of B=8 x 8,192 costs 2 members / 1: " + ", ".join(
            f"{what} {'scored' if attn else 'classification'} x{v['two'] / v['one']:.2f} ({v['one']:.3f} -> "
            f"{v['two']:.3f} ms)" for (what, attn), v in fw.items()) + f"; serve_load host CPU ms a request: " + ", ".join(
            f"wire {w} {line['host_cpu_ms_per_req']}" for w, line in ensembled["serve_load"].items()) + f" [{gpu}]")
    enc_t, st = resnet["times"]["encoder"], resnet["times"]
    log(f"phase 9 timing summary: KS / plain_stage / cuDNN stage, bound (ms), bf16 B=64 at 256 px: " + "; ".join(
        f"{k} {st[k]['ms']:.3f} / {st[k]['plain_ms']:.3f} / {st[k]['library_ms']:.3f}, {st[k]['bound_ms']:.4f} by "
        f"{st[k]['bound_by']}" for k in ("layer1", "layer2", "layer3", "all")) + f"; the encoder {enc_t['batch']:.3f} ms "
        f"a batch, ResNet featurize {resnet['featurized']['cli_tiles_s']:.1f} tiles/s by the CLI's clock [{gpu}]")
    idle = [k["name"] for k in record["kernels"] if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels that their main path launched no time: {idle}")
    log(f"all phases: {time.perf_counter() - t_start:.1f} s")
    log(gpu)
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
