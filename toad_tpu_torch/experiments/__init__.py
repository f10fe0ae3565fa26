"""The probes on the card, counterparts of the TPU probes of the same names in
``experiments/``: the pooling-kernel probes (:mod:`.mfu_probe`,
:mod:`.int8_probe`, :mod:`.longbag_probe`), the ViT-L decomposition
probes (:mod:`.vit_softmax_probe`, :mod:`.vit_attn_probe`,
:mod:`.vit_ceiling2_probe`, :mod:`.vit_elementwise_probe`,
:mod:`.vit_profile`, :mod:`.vit_int8_probe`, with their harness
:mod:`.vit_probe_common`), the serving load test (:mod:`.serve_load`), the
disk-fed feed probes (:mod:`.io_overlap_probe`, :mod:`.bf16_transfer_probe`,
:mod:`.patient_native_probe`) and the ceiling probes (:mod:`.matmul_ceiling`,
:mod:`.encoder_batch_ab`, :mod:`.encoder_stages`).
Each runs as ``python -m toad_tpu_torch.experiments.NAME`` and prints one
JSON line per variant, arm or run (or the JAX probe's text lines)."""

from __future__ import annotations

import torch

PEAK_BF16 = 989.0  # TFLOP/s, dense bf16, H100 SXM at 700 W


def resolve_device(name: str) -> torch.device:
    """The device a probe runs on: the card unless the caller asks for the
    CPU (where the kernels' plain versions run and no device metric is
    claimed); SystemExit when the card is asked for and there is none."""
    if name == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch.cuda.is_available() is False: the probes time the CUDA kernels on a GPU "
                         "(--device cpu runs their plain versions)")
    if name not in ("cuda", "cpu"):
        raise SystemExit(f"--device must be cuda or cpu, got {name!r}")
    return torch.device(name)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def time_chain(f, runs: int) -> float:
    """Best of ``runs`` wall times of f(i) (each ends by reading a scalar
    back, which waits for the card), after one warm-up call f(-1)."""
    import time

    f(-1)
    best = float("inf")
    for i in range(runs):
        t0 = time.perf_counter()
        f(i)
        best = min(best, time.perf_counter() - t0)
    return best
