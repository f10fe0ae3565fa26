"""Shared harness of the ViT-L decomposition probes.

Counterpart of ``experiments/vit_probe_common.py``. Every ViT probe measures
the same way: a full ViT forward with one piece swapped out, run as a chain
of ``k`` serially dependent forwards (each input is the last one plus
bf16(sum(out) * 1e-12), so no forward can start before the last ends) on
tiles drawn on the card from a seeded ``torch.Generator``, ended by one
scalar read; the best of a few runs after a warm-up. Only the per-block math
differs per probe: it is the encoder's own block (``_block``) with the
attention core, the LayerNorm or the GELU form swapped.
"""

from __future__ import annotations

import argparse
import functools
import json
from typing import Callable

import torch

from toad_tpu_torch.experiments import device_name, time_chain
from toad_tpu_torch.models.vit_encoder import ViTConfig, ViTEncoder, _block, _layer_norm
from toad_tpu_torch.ops import cuda_mha
from toad_tpu_torch.ops.vit_attention import plain_mha


def serial_time(fn, *args, runs: int = 3) -> float:
    """Best-of-``runs`` wall time of ``float(fn(*args))`` after one warm-up
    call. The scalar read waits for the card; callers pass a chained fn whose
    result depends on every step."""
    return time_chain(lambda _i: float(fn(*args)), runs)


def tile_chain(step: Callable[[torch.Tensor], torch.Tensor], n_tiles: int, hw: int, k: int,
               device: torch.device) -> Callable[[int], torch.Tensor]:
    """fn(seed) -> f32 scalar on ``device``: bf16 tiles [n_tiles, hw, hw, 3]
    drawn on the device (uniform in [0, 1), as the JAX harness draws them),
    then ``k`` forwards ``out = step(t)``, each input ``t + bf16(out.sum() *
    1e-12)`` of the last, summing ``out.sum()``."""

    @torch.inference_mode()
    def fn(seed: int) -> torch.Tensor:
        g = torch.Generator(device=device).manual_seed(seed)
        t = torch.rand(n_tiles, hw, hw, 3, generator=g, device=device).to(torch.bfloat16)
        acc = torch.zeros((), dtype=torch.float32, device=device)
        for _ in range(k):
            s = step(t).sum()
            t = t + (s * 1e-12).to(torch.bfloat16)
            acc = acc + s
        return acc

    return fn


def make_vit_fwd(cfg: ViTConfig, enc: ViTEncoder, block_fn, final_norm=None):
    """Full ViT forward with a pluggable per-block function: fwd(tiles [B, H,
    W, 3] in 0..255) -> cls features [B, width] f32.

    ``block_fn(tokens, blk, bw, dt) -> tokens`` carries the variant under test
    (``blk`` the encoder's block module, ``bw`` its weights in ``dt``);
    everything around it is the encoder's own dataflow (``preprocess``, the
    patch embedding with the cls and position tokens, the final norm on the
    cls token, or ``final_norm(x, ln, eps)`` in its place). The compute dtype
    is ``cfg``'s, the weights ``enc``'s."""
    dt = getattr(torch, cfg.compute_dtype)
    norm_final = _layer_norm if final_norm is None else final_norm

    @torch.inference_mode()
    def fwd(tiles: torch.Tensor) -> torch.Tensor:
        w = enc._weights(dt)
        tokens = enc._embed_tokens(enc.preprocess(tiles), w, dt)
        for blk, bw in zip(enc.blocks, w["blocks"]):
            tokens = block_fn(tokens, blk, bw, dt)
        return norm_final(tokens[:, 0, :], enc.norm, cfg.ln_eps).float()

    return fwd


def make_block(cfg: ViTConfig, attn: Callable[[torch.Tensor], torch.Tensor], tanh_gelu: bool,
               layer_norm=_layer_norm):
    """block_fn for :func:`make_vit_fwd`: the encoder's block with the
    attention core ``attn`` (qkv [B, N, 3*width] -> context [B, N, width]),
    the GELU form and the LayerNorm ``layer_norm(x, ln, eps)``."""
    return lambda x, blk, bw, dt: _block(x, bw, (blk.norm1, blk.norm2), cfg, dt, attn, tanh_gelu, layer_norm)


def heads(fn, cfg: ViTConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """``fn(qkv, heads, head_dim)`` as an attention core of ``cfg``."""
    return functools.partial(fn, heads=cfg.heads, head_dim=cfg.head_dim)


def einsum_attention(cfg: ViTConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """The JAX block's einsum attention (``_block(attn_fused=False)``): the
    scores a product of qkv's dtype with f32 results, softmax in f32 of the
    scaled scores, p rounded to qkv's dtype, p @ v a product of that dtype
    (f32 sums rounded once). On a CUDA bf16 tensor both products run on the
    tensor cores (``torch.bmm``, the scores with ``out_dtype=float32``), as
    the JAX einsums run bf16 products; otherwise ``plain_mha`` computes the
    same values with f32 products of the widened operands."""
    h, d = cfg.heads, cfg.head_dim

    def attn(qkv: torch.Tensor) -> torch.Tensor:
        if qkv.device.type != "cuda" or qkv.dtype != torch.bfloat16:
            return plain_mha(qkv, h, d)
        b, n, _ = qkv.shape
        q, k, v = (t.reshape(b * h, n, d) for t in qkv.view(b, n, 3, h, d).permute(2, 0, 3, 1, 4))
        s = torch.bmm(q, k.transpose(1, 2), out_dtype=torch.float32)
        p = torch.softmax(s * d ** -0.5, dim=-1).to(qkv.dtype)
        return torch.bmm(p, v).view(b, h, n, d).transpose(1, 2).reshape(b, n, h * d)

    return attn


def identity_attention(cfg: ViTConfig) -> Callable[[torch.Tensor], torch.Tensor]:
    """Attention replaced by the v columns (the last width columns of qkv):
    the same dataflow and width, no attention math."""
    return lambda qkv: qkv[..., 2 * cfg.width:]


def seeded_encoder(cfg: ViTConfig, device: torch.device, seed: int = 0) -> ViTEncoder:
    """The probes' weights: the encoder's own init from a seeded generator
    (the JAX probes' ``enc.init(PRNGKey(0))``), on ``device``."""
    return ViTEncoder(cfg, torch.Generator().manual_seed(seed)).to(device)


def bf16_value(v: float) -> float:
    """``v`` rounded to bf16, as JAX rounds a Python scalar that meets a bf16
    array (PyTorch computes with the f32 value and rounds the result)."""
    return float(torch.tensor(v, dtype=torch.bfloat16))


def probe_parser(doc: str, batch: int, hw: int, k: int, runs: int) -> argparse.ArgumentParser:
    """The flags every ViT probe takes, defaulting to the JAX probe's
    constants (B, HW, K and its runs)."""
    ap = argparse.ArgumentParser(description=doc, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, default=batch, help="tiles per forward (the JAX probe's B)")
    ap.add_argument("--hw", type=int, default=hw, help="tile side in pixels (HW)")
    ap.add_argument("--k", type=int, default=k, help="serially dependent forwards per timed run (K)")
    ap.add_argument("--runs", type=int, default=runs, help="timed runs, the best kept")
    ap.add_argument("--arms", default=None, help="comma-separated arms to run (default: all, in the JAX order)")
    ap.add_argument("--device", default="cuda", help="cuda (the default), or cpu for the plain versions")
    return ap


def select_arms(spec: str | None, known: list[str]) -> list[str]:
    """The arms named in ``spec`` (comma-separated; all when None), in the
    order given; an unknown one ends the run before the first line."""
    arms = known if spec is None else spec.split(",")
    unknown = [a for a in arms if a not in known]
    if unknown:
        raise SystemExit(f"unknown arm(s) {unknown}: this probe has {known}")
    return arms


def emit(line: dict, dev: torch.device, before: tuple[int, int]) -> None:
    """Print one arm's JSON line with the device's name and the attention
    kernels' launches since ``before`` (K3, P7)."""
    line = {**line, "device": device_name(dev), "k3_launches": cuda_mha.LAUNCHES - before[0],
            "p7_launches": cuda_mha.NEW_LAUNCHES - before[1]}
    print(json.dumps(line), flush=True)


def launch_counts() -> tuple[int, int]:
    return cuda_mha.LAUNCHES, cuda_mha.NEW_LAUNCHES

