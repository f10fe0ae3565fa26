"""Where does a ViT-L/16 tile embedding's time go? (B=128, 224 px)

Counterpart of ``experiments/vit_profile.py``:

- A_full:      the encoder's own forward (``ViTEncoder.embed``: K3, tanh GELU
               under bf16), tiles/s and TFLOP/s counted by the probe's
               formula (:func:`gflop_per_tile`);
- B_gemms:     the block GEMMs alone at the same shapes (197 tokens a tile,
               as the JAX arm hard-codes; no LayerNorm, attention, bias or
               residual): the GEMMs' own ceiling;
- C_padded256: the full forward with the tokens padded 197 -> 256 (a
               multiple of 64) after the position embedding, through the
               encoder's block with the einsum attention (``einsum_attention``) and
               exact GELU, as the JAX arm calls ``_block`` (not
               numerically the same forward: the padded tokens take part in
               the softmax). Its TFLOP/s count the 197-token forward's work.

Run: python -m toad_tpu_torch.experiments.vit_profile [--batch 128 --hw 224 --k 4]
Prints one JSON line per arm.
"""

from __future__ import annotations

import sys

import torch
import torch.nn.functional as F

from toad_tpu_torch.experiments import PEAK_BF16, resolve_device
from toad_tpu_torch.experiments.vit_probe_common import (
    einsum_attention, emit, launch_counts, probe_parser, seeded_encoder, select_arms, serial_time, tile_chain)
from toad_tpu_torch.models.vit_encoder import ViTConfig, _block, _layer_norm

B, HW, K = 128, 224, 4
RUNS = 3
TOKENS = 197  # the JAX arm's token count, fixed whatever the tile size
C = ViTConfig()
ARMS = ["A_full", "B_gemms", "C_padded256"]


def gflop_per_tile(tokens: int = TOKENS) -> float:
    """The JAX probe's count: the block GEMMs and q k^T, a v per token."""
    d, mlp, depth = C.width, C.mlp_ratio * C.width, C.depth
    per_tok = 4 * d * d + 2 * d * mlp * 2  # qkv+proj (4d^2) + fc1+fc2 MACs
    attn = 2 * tokens * d  # qk^T + av MACs per token
    return 2 * depth * tokens * (per_tok + attn) / 1e9


def gemm_gflop_per_tile() -> float:
    return 2 * C.depth * TOKENS * (4 * C.width ** 2 + 2 * C.width * C.mlp_ratio * C.width) / 1e9


def make_gemms_only(enc):
    """The B arm: [B*197, width] bf16 rows through every block's four GEMMs,
    qkv -> its first width columns -> proj -> fc1 -> fc2, with a scalar
    dependency on the chained tiles."""
    dt = torch.bfloat16

    def fwd(tiles: torch.Tensor) -> torch.Tensor:
        h = torch.zeros(tiles.shape[0] * TOKENS, C.width, dtype=dt, device=tiles.device) + tiles.reshape(-1)[0].to(dt)
        for bw in enc._weights(dt)["blocks"]:
            qkv = h @ bw["qkv"][0].t()
            h = qkv[:, : C.width] @ bw["proj"][0].t()
            m = h @ bw["fc1"][0].t()
            h = m @ bw["fc2"][0].t()
        return h.float()

    return fwd


def make_padded(enc):
    """The C arm: tokens padded with zeros to a multiple of 64 after the
    position embedding, the encoder's block with the einsum attention and
    exact GELU, the final norm on the cls token."""
    dt = getattr(torch, C.compute_dtype)
    attn = einsum_attention(C)

    def fwd(tiles: torch.Tensor) -> torch.Tensor:
        w = enc._weights(dt)
        tokens = enc._embed_tokens(enc.preprocess(tiles), w, dt)
        n = tokens.shape[1]
        tokens = F.pad(tokens, (0, 0, 0, -(-n // 64) * 64 - n))
        for blk, bw in zip(enc.blocks, w["blocks"]):
            tokens = _block(tokens, bw, (blk.norm1, blk.norm2), C, dt, attn, tanh_gelu=False)
        return _layer_norm(tokens[:, 0, :], enc.norm, C.ln_eps).float()

    return fwd


def main(argv: list[str] | None = None) -> int:
    args = probe_parser(__doc__, B, HW, K, RUNS).parse_args(argv)
    names = select_arms(args.arms, ARMS)
    dev = resolve_device(args.device)
    enc = seeded_encoder(C, dev)
    steps = {"A_full": (enc.embed, gflop_per_tile()), "B_gemms": (make_gemms_only(enc), gemm_gflop_per_tile()),
             "C_padded256": (make_padded(enc), gflop_per_tile())}
    n = args.batch * args.k
    for name in names:
        step, gflop = steps[name]
        before = launch_counts()
        t = serial_time(tile_chain(step, args.batch, args.hw, args.k, dev), 1, runs=args.runs)
        tflops = gflop * n / t / 1e3 if dev.type == "cuda" else None  # no device rate from a CPU run
        emit({"arm": name, f"{name}_tiles_per_s": n / t, f"{name[0]}_tflops": tflops,
              "pct_peak": 100 * tflops / PEAK_BF16 if tflops is not None else None}, dev, before)
    return 0


if __name__ == "__main__":
    sys.exit(main())
