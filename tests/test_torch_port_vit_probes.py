"""The ViT-L decomposition probes of the PyTorch port against the JAX probes.

Each JAX probe (``experiments/vit_*.py``) is loaded by file path with its
module-level ``C`` set to a narrow ViT (width 256, 4 heads of 64, depth 2,
32-px tiles of 16-px patches: 5 tokens) and its K3 calls bound to
``interpret=True``; P7's body ``_mha_kernel_new`` runs in a ``pallas_call``
with the probe's own BlockSpecs in interpret mode. The port's modules get the
same narrow ``C`` and the same weights (carried with
``interop.vit_params_from_jax``; biases, LayerNorms and LayerScale moved off
their trivial init so that every block shows in the features). No arm runs
at ViT-L's size here.

Tolerances:
- P7 and K3, bf16: those of K3's test (tests/test_torch_port_vit.py,
  TOL_BF16: one bf16 ulp and change), and at most P7_SHARE of the elements
  differing (the same rounding points; K3's against P7's plain version
  differ in about half); f32: 1e-5 (summation order).
- A probe arm's features, bf16: the encoder's tolerance TOL_ENC_BF16 (the two
  frameworks round GELU and the bias adds at different places); f32 1e-4.
- The int8 chains: the integer GEMMs and the ``>> 8`` cut are exact; the
  dequantized chain differs where XLA's and PyTorch's tanh differ in an f32
  ulp and tip one rounding of the next quantization (TOL_INT8_CHAIN).
"""

import dataclasses
import functools
import importlib
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from toad_tpu.models import vit_encoder as jax_vit
from toad_tpu.ops import vit_attention as jax_attention
from toad_tpu_torch.experiments import vit_probe_common as common
from toad_tpu_torch.models import vit_encoder as port_vit
from toad_tpu_torch.models.interop import vit_params_from_jax
from toad_tpu_torch.ops import _build, cuda_mha
from toad_tpu_torch.ops.vit_attention import fused_mha, fused_mha_new, plain_mha, plain_mha_new

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(patch_size=16, width=256, depth=2, heads=4, pretrain_img_size=32)
HEADS, HEAD_DIM = 4, 64
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
P7_SHARE = 2e-3
TOL_ENC_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_ENC_BF16 = dict(rtol=3e-2, atol=3e-2)
TOL_INT8_CHAIN = dict(rtol=1e-3, atol=1e-4)
PROBES = ["vit_softmax_probe", "vit_attn_probe", "vit_ceiling2_probe", "vit_elementwise_probe", "vit_profile",
          "vit_int8_probe"]


def _load(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_probes():
    """The JAX probes at the narrow size, K3 in interpret mode."""
    mods = {name: _load(name) for name in PROBES}
    for name, mod in mods.items():
        if hasattr(mod, "C"):
            mod.C = jax_vit.ViTConfig(**SMALL, attention=mod.C.attention)
        if hasattr(mod, "fused_mha"):
            mod.fused_mha = functools.partial(jax_attention.fused_mha, interpret=True)
    return mods


@pytest.fixture
def port_probes(monkeypatch):
    """The port's probe modules with the same narrow ``C``."""
    mods = {name: importlib.import_module(f"toad_tpu_torch.experiments.{name}") for name in PROBES}
    for mod in mods.values():
        if hasattr(mod, "C"):
            monkeypatch.setattr(mod, "C", port_vit.ViTConfig(**SMALL, attention=mod.C.attention))
    return mods


def _p7_interpret(qkv, heads, head_dim, body):
    """``fused_mha_new``'s pallas_call (the probe's BlockSpecs and block_b)
    in interpret mode."""
    b, n, three_d = qkv.shape
    d = heads * head_dim
    block_b = max(1, min(4, b, int(26e6 // (15 * n * d * qkv.dtype.itemsize))))
    kernel = functools.partial(body, heads=heads, head_dim=head_dim, scale=float(head_dim) ** -0.5)
    return pl.pallas_call(
        kernel,
        grid=(pl.cdiv(b, block_b),),
        in_specs=[pl.BlockSpec((block_b, n, three_d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((block_b, n, d), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, n, d), qkv.dtype),
        interpret=True,
    )(qkv)


def _qkv(n, seed, b=3):
    return np.random.default_rng(seed).standard_normal((b, n, 3 * HEADS * HEAD_DIM)).astype(np.float32)


# -- P7 --------------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_tokens", [197, 65, 17])
def test_plain_mha_new_matches_the_probe_body_in_interpret_mode(jax_probes, dtype, n_tokens):
    """N = 197, 65 and 17: ragged last 64-row query blocks of the kernel."""
    qkv = _qkv(n_tokens, n_tokens)
    want = np.asarray(_p7_interpret(jnp.asarray(qkv, jnp.dtype(dtype)), HEADS, HEAD_DIM,
                                    jax_probes["vit_softmax_probe"]._mha_kernel_new), np.float32)
    got = plain_mha_new(torch.from_numpy(qkv).to(getattr(torch, dtype)), HEADS, HEAD_DIM)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, n_tokens, HEADS * HEAD_DIM)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, **(TOL_F32 if dtype == "float32" else TOL_BF16))
    if dtype == "bfloat16":  # the same rounding points: nearly every element equal
        assert (got != want).mean() <= P7_SHARE


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_mha_new_differs_from_plain_mha_by_rounding_only(dtype):
    """The same function as K3's plain version; in bf16 p is rounded before
    the normalisation instead of after, which moves about half the values by
    an ulp: exactly what separates the two kernels on the card."""
    qkv = torch.from_numpy(_qkv(197, 3)).to(getattr(torch, dtype))
    new, old = plain_mha_new(qkv, HEADS, HEAD_DIM).float(), plain_mha(qkv, HEADS, HEAD_DIM).float()
    torch.testing.assert_close(new, old, **(TOL_F32 if dtype == "float32" else TOL_BF16))
    if dtype == "bfloat16":
        assert (new != old).float().mean().item() > 10 * P7_SHARE


def test_plain_mha_new_rounding_points():
    """c = Dh^-1/2 * log2(e) from float64, rounded once to f32; q * c rounded
    to bf16; exp2 of f32 scores; the f32 sum of the unrounded p; p rounded
    to bf16 for p @ v; a true division at the end."""
    qkv = torch.from_numpy(_qkv(40, 5, b=1)[..., : 3 * 64]).bfloat16()
    q, k, v = qkv.float().reshape(1, 40, 3, 1, 64).unbind(2)
    c = torch.tensor(64 ** -0.5 * 1.4426950408889634, dtype=torch.float32)
    qs = (q * c).bfloat16().float()
    s = torch.einsum("bnhd,bmhd->bhnm", qs, k)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o = torch.einsum("bhnm,bmhd->bhnd", p.bfloat16().float(), v) / p.sum(-1, keepdim=True)
    assert torch.equal(plain_mha_new(qkv, 1, 64), o.permute(0, 2, 1, 3).reshape(1, 40, 64).bfloat16())
    assert cuda_mha.new_softmax_factor(64) == 64 ** -0.5 * 1.4426950408889634


def test_only_the_device_chooses_between_p7_and_its_plain_version():
    qkv = torch.from_numpy(_qkv(9, 0, b=2))
    assert torch.equal(fused_mha_new(qkv, HEADS, HEAD_DIM), plain_mha_new(qkv, HEADS, HEAD_DIM))
    with pytest.raises(ValueError, match="no attention path"):
        fused_mha_new(qkv.to("meta"), HEADS, HEAD_DIM)
    with pytest.raises(ValueError, match=r"qkv last dim 100 != 3\*heads\*head_dim"):
        fused_mha_new(torch.zeros(1, 8, 100), 2, 8)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        cuda_mha.mha(qkv, HEADS, HEAD_DIM, variant="new")
    with pytest.raises(ValueError, match="unknown attention kernel variant"):
        cuda_mha.mha(qkv, HEADS, HEAD_DIM, variant="p8")
    assert cuda_mha.LAUNCHES == 0 and cuda_mha.NEW_LAUNCHES == 0 and not _build.is_loaded()


def test_fused_mha_variant_picks_the_plain_version_and_refuses_unknown_names():
    qkv = torch.from_numpy(_qkv(10, 0, b=2))
    assert torch.equal(fused_mha(qkv, HEADS, HEAD_DIM, variant="new"), plain_mha_new(qkv, HEADS, HEAD_DIM))
    assert torch.equal(fused_mha(qkv, HEADS, HEAD_DIM, variant="k3"), plain_mha(qkv, HEADS, HEAD_DIM))
    with pytest.raises(ValueError, match="unknown attention variant 'p8'"):
        fused_mha(qkv, HEADS, HEAD_DIM, variant="p8")
    assert cuda_mha.LAUNCHES == 0 and cuda_mha.NEW_LAUNCHES == 0 and not _build.is_loaded()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_einsum_attention_is_plain_mha_off_the_card(dtype):
    """The probes' einsum arm computes plain_mha's values; on a CPU tensor it
    is plain_mha (its tensor-core products run on the card only)."""
    qkv = torch.from_numpy(_qkv(11, 0, b=2)).to(getattr(torch, dtype))
    cfg = port_vit.ViTConfig(**SMALL)
    assert torch.equal(common.einsum_attention(cfg)(qkv), plain_mha(qkv, HEADS, HEAD_DIM))


# -- the encoder's block, and the harness ------------------------------------------------


def _jax_params(cfg, seed=0):
    """JAX init, then every bias (but the patch embedding's, which the JAX
    probe vit_profile's padded arm leaves out), LayerNorm and LayerScale
    leaf moved off its trivial value."""
    params = jax.tree.map(np.asarray, jax_vit.ViTEncoder(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def jiggle(tree, path=()):
        if isinstance(tree, dict):
            return {k: jiggle(v, path + (k,)) for k, v in tree.items()}
        if isinstance(tree, list):
            return [jiggle(v, path) for v in tree]
        if path == ("patch_embed", "b"):
            return tree
        return tree + rng.standard_normal(tree.shape).astype(np.float32) * 0.05

    params = jiggle(params)
    for blk in params["blocks"]:
        blk["ls1"], blk["ls2"] = blk["ls1"] + 0.5, blk["ls2"] + 0.5
    return params


@pytest.fixture(scope="module")
def weights():
    """(JAX params, tiles [2, 32, 32, 3] in 0..255 f32) of the narrow ViT."""
    params = _jax_params(jax_vit.ViTConfig(**SMALL))
    tiles = np.random.default_rng(1).uniform(0, 255, (2, 32, 32, 3)).astype(np.float32)
    return params, tiles


def _port_encoder(params, **kw):
    return port_vit.encoder_from_state_dict(vit_params_from_jax(params), port_vit.ViTConfig(**{**SMALL, **kw}))


def _check(got, want, dtype="bfloat16"):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == np.asarray(want).shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **(TOL_ENC_BF16 if dtype == "bfloat16" else TOL_ENC_F32))


@pytest.mark.parametrize("compute_dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("tile", [32, 48])
def test_block_and_harness_equal_the_encoder_bit_for_bit(weights, compute_dtype, tile):
    """``ViTEncoder.apply`` (its loop now a call of ``_block``) equals the
    block written out as the encoder's loop body was, and ``make_vit_fwd``
    with the production block equals ``embed``, bit for bit."""
    params, _ = weights
    enc = _port_encoder(params, compute_dtype=compute_dtype)
    c, dt = enc.config, getattr(torch, compute_dtype)
    tiles = torch.from_numpy(np.random.default_rng(2).uniform(0, 255, (2, tile, tile, 3)).astype(np.float32))
    got = enc.embed(tiles)

    w = enc._weights(dt)
    tokens = enc._embed_tokens(enc.preprocess(tiles), w, dt)
    for blk, bw in zip(enc.blocks, w["blocks"]):  # the pre-refactor loop body of apply
        h = torch.nn.functional.layer_norm(tokens.float(), (c.width,), blk.norm1.weight, blk.norm1.bias, c.ln_eps).to(dt)
        o = fused_mha(h @ bw["qkv"][0].t() + bw["qkv"][1], c.heads, c.head_dim)
        tokens = tokens + (o @ bw["proj"][0].t() + bw["proj"][1]) * bw["ls1"]
        h = torch.nn.functional.layer_norm(tokens.float(), (c.width,), blk.norm2.weight, blk.norm2.bias, c.ln_eps).to(dt)
        h = torch.nn.functional.gelu(h @ bw["fc1"][0].t() + bw["fc1"][1],
                                     approximate="tanh" if compute_dtype == "bfloat16" else "none")
        tokens = tokens + (h @ bw["fc2"][0].t() + bw["fc2"][1]) * bw["ls2"]
    want = torch.nn.functional.layer_norm(tokens[:, 0, :].float(), (c.width,), enc.norm.weight, enc.norm.bias, c.ln_eps)
    assert torch.equal(got, want)

    fwd = common.make_vit_fwd(c, enc, common.make_block(c, common.heads(fused_mha, c), port_vit._resolve_gelu(c)))
    assert torch.equal(fwd(tiles), got)


def test_tile_chain_is_k_dependent_forwards():
    """tile_chain's total against the loop written out on the same tiles."""
    fn = common.tile_chain(lambda t: (t.float() * 3.0).mean(dim=(1, 2)), 2, 8, 3, torch.device("cpu"))
    t = torch.rand(2, 8, 8, 3, generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    acc = torch.zeros(())
    for _ in range(3):
        s = (t.float() * 3.0).mean(dim=(1, 2)).sum()
        t, acc = t + (s * 1e-12).to(torch.bfloat16), acc + s
    assert torch.equal(fn(5), acc)
    assert common.serial_time(fn, 5, runs=2) > 0


# -- every arm of the six probes against the JAX probe's arm -------------------------------


def _jax_fwd(mod, params, block, final_norm=None, cfg=None):
    """The JAX probe's make_vit_fwd over its narrow C."""
    common_jax = sys.modules["experiments.vit_probe_common"]
    cfg = mod.C if cfg is None else cfg
    return lambda tiles: np.asarray(common_jax.make_vit_fwd(cfg, jax_vit.ViTEncoder(cfg), block, final_norm)(params, tiles))


@pytest.mark.parametrize("arm", ["old", "new", "truth"])
def test_vit_softmax_arms(jax_probes, port_probes, weights, arm):
    jm, pm = jax_probes["vit_softmax_probe"], port_probes["vit_softmax_probe"]
    params, tiles = weights
    c = pm.C
    enc = _port_encoder(params)
    if arm == "truth":  # the f32 encoder with the einsum attention (the JAX probe's attention="xla")
        cfg32 = jax_vit.ViTConfig(**{**jm.C.__dict__, "compute_dtype": "float32", "attention": "xla"})
        want = np.asarray(jax_vit.ViTEncoder(cfg32).embed(params, jnp.asarray(tiles)))
        c32 = dataclasses.replace(c, compute_dtype="float32")
        got = common.make_vit_fwd(c32, enc, common.make_block(c32, common.heads(plain_mha, c), tanh_gelu=False))(
            torch.from_numpy(tiles))
        return _check(got, want, "float32")
    if arm == "new":
        jattn = lambda qkv: _p7_interpret(qkv, jm.C.heads, jm.C.head_dim, jm._mha_kernel_new)  # noqa: E731
        pattn = common.heads(fused_mha_new, c)
    else:
        jattn = functools.partial(jax_attention.fused_mha, heads=jm.C.heads, head_dim=jm.C.head_dim, interpret=True)
        pattn = common.heads(fused_mha, c)
    want = _jax_fwd(jm, params, jm.make_block(jattn))(jnp.asarray(tiles, jnp.bfloat16))
    got = common.make_vit_fwd(c, enc, common.make_block(c, pattn, tanh_gelu=True))(torch.from_numpy(tiles).bfloat16())
    _check(got, want)


@pytest.mark.parametrize("arm", ["A_full", "E_identity", "F_dpa", "G_bf16_scores"])
def test_vit_attn_arms(jax_probes, port_probes, weights, arm):
    jm, pm = jax_probes["vit_attn_probe"], port_probes["vit_attn_probe"]
    params, tiles = weights
    jimpl = {"A_full": jm.attn_reference, "E_identity": jm.attn_identity, "F_dpa": jm.attn_dpa,
             "G_bf16_scores": jm.attn_bf16_scores}[arm]
    want = _jax_fwd(jm, params, jm.make_block(jimpl))(jnp.asarray(tiles))
    got = common.make_vit_fwd(pm.C, _port_encoder(params), common.make_block(pm.C, pm.arms()[arm], tanh_gelu=False))(
        torch.from_numpy(tiles))
    _check(got, want)


@pytest.mark.parametrize("arm", ["A_full_fused", "B_identity_attn", "C_fused_no_ln", "D_identity_no_ln"])
def test_vit_ceiling2_arms(jax_probes, port_probes, weights, arm):
    jm, pm = jax_probes["vit_ceiling2_probe"], port_probes["vit_ceiling2_probe"]
    params, tiles = weights
    jimpl = jm.attn_fused if arm in ("A_full_fused", "C_fused_no_ln") else jm.attn_identity
    want = _jax_fwd(jm, params, jm.make_block(jimpl, ln=arm in ("A_full_fused", "B_identity_attn")))(jnp.asarray(tiles))
    attn, ln = pm.arms()[arm]
    got = common.make_vit_fwd(pm.C, _port_encoder(params), common.make_block(pm.C, attn, tanh_gelu=True, layer_norm=ln))(
        torch.from_numpy(tiles))
    _check(got, want)


@pytest.mark.parametrize("arm", ["A_prod", "D1_bf16_ln", "D2_tanh_gelu", "D3_both"])
def test_vit_elementwise_arms(jax_probes, port_probes, weights, arm):
    jm, pm = jax_probes["vit_elementwise_probe"], port_probes["vit_elementwise_probe"]
    params, tiles = weights
    want = np.asarray(jm.make_fwd(*pm.ARMS[arm])(params, jnp.asarray(tiles)))
    got = pm.make_fwd(_port_encoder(params, attention="fused"), *pm.ARMS[arm])(torch.from_numpy(tiles))
    _check(got, want)


def test_bf16_layer_norm_matches_the_probe(jax_probes, port_probes):
    """The bf16 LayerNorm alone (D1): means summed in f32 and rounded once,
    every step rounded to bf16, eps rounded to bf16."""
    x = np.random.default_rng(4).standard_normal((6, 256)).astype(np.float32) * 3 + 1
    scale = np.random.default_rng(5).standard_normal(256).astype(np.float32)
    bias = np.random.default_rng(6).standard_normal(256).astype(np.float32)
    want = np.asarray(jax_probes["vit_elementwise_probe"].make_ln(True)(
        jnp.asarray(x), {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}), np.float32)
    ln = torch.nn.LayerNorm(256).requires_grad_(False)
    with torch.no_grad():
        ln.weight.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
    got = port_probes["vit_elementwise_probe"].bf16_layer_norm(torch.from_numpy(x), ln, 1e-6)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=8e-3, atol=8e-3)  # one bf16 ulp
    assert (got.float().numpy() != want).mean() < 0.02


def _jax_gemms_only(jm, params, tiles):
    """vit_profile's B arm, as its main() writes it."""
    dt = jnp.bfloat16
    h = jnp.zeros((tiles.shape[0] * 197, jm.C.width), dt) + tiles.reshape(-1)[0].astype(dt)
    for blk in params["blocks"]:
        qkv = h @ jnp.asarray(blk["qkv"]["w"]).astype(dt)
        h = qkv[:, : jm.C.width] @ jnp.asarray(blk["proj"]["w"]).astype(dt)
        m = h @ jnp.asarray(blk["fc1"]["w"]).astype(dt)
        h = m @ jnp.asarray(blk["fc2"]["w"]).astype(dt)
    return np.asarray(h.astype(jnp.float32))


def _jax_padded(jm, params, tiles):
    """vit_profile's C arm, as its main() writes it (the patch embedding
    without its bias, zero here)."""
    c, enc = jm.C, jax_vit.ViTEncoder(jm.C)
    dt = jnp.dtype(c.compute_dtype)
    b, s = tiles.shape[0], c.patch_size
    x = enc.preprocess(tiles)
    toks = jax.lax.conv_general_dilated(
        x.astype(dt), jnp.asarray(params["patch_embed"]["w"]).astype(dt), (s, s), "VALID",
        dimension_numbers=("NHWC", "HWIO", "NHWC"), preferred_element_type=dt).reshape(b, -1, c.width)
    cls = jnp.broadcast_to(jnp.asarray(params["cls_token"]).astype(dt), (b, 1, c.width))
    toks = jnp.concatenate([cls, toks], 1) + jnp.asarray(params["pos_embed"]).astype(dt)
    n_tok = toks.shape[1]
    toks = jnp.pad(toks, ((0, 0), (0, -(-n_tok // 64) * 64 - n_tok), (0, 0)))
    for blk in params["blocks"]:
        toks = jax_vit._block(toks, blk, c, dt)
    return np.asarray(jax_vit._layer_norm(toks[:, 0, :], params["norm"], c.ln_eps).astype(jnp.float32))


@pytest.mark.parametrize("arm", ["A_full", "B_gemms", "C_padded256"])
def test_vit_profile_arms(jax_probes, port_probes, weights, arm):
    jm, pm = jax_probes["vit_profile"], port_probes["vit_profile"]
    params, tiles = weights
    enc = _port_encoder(params)
    if arm == "A_full":
        want = np.asarray(jax_vit.ViTEncoder(jm.C).embed(params, jnp.asarray(tiles)))
        got = enc.embed(torch.from_numpy(tiles))
    elif arm == "B_gemms":
        t = jnp.asarray(tiles, jnp.bfloat16)
        want = _jax_gemms_only(jm, params, t)
        with torch.inference_mode():
            got = pm.make_gemms_only(enc)(torch.from_numpy(np.array(t.astype(jnp.float32))).bfloat16())
        assert got.shape == (2 * 197, 256)
    else:
        want = _jax_padded(jm, params, jnp.asarray(tiles))
        with torch.inference_mode():
            got = pm.make_padded(enc)(torch.from_numpy(tiles))
    _check(got, want)


def test_vit_profile_flop_counts_equal_the_jax_probe(jax_probes, port_probes, monkeypatch):
    jm, pm = jax_probes["vit_profile"], port_probes["vit_profile"]
    full = jax_vit.ViTConfig()
    monkeypatch.setattr(jm, "C", full)
    monkeypatch.setattr(pm, "C", port_vit.ViTConfig())
    assert pm.gflop_per_tile() == jm.gflop_per_tile() and pm.gflop_per_tile(256) == jm.gflop_per_tile(256)
    assert pm.gemm_gflop_per_tile() == 2 * full.depth * 197 * (4 * full.width ** 2 + 8 * full.width ** 2) / 1e9


# -- vit_int8 ----------------------------------------------------------------------------


INT8_M = 40


@pytest.fixture(scope="module")
def int8_weights():
    """The four weights (f32 numpy, normal * 0.02) handed to both packages."""
    rng = np.random.default_rng(7)
    return [(rng.standard_normal(shape) * 0.02).astype(np.float32) for shape in (
        (1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))]


def test_quant_rows_matches_the_probe(jax_probes, port_probes):
    """Round half to even and the clip before the cast: rows with exact
    halves and a zero row."""
    x = np.random.default_rng(8).standard_normal((5, 64)).astype(np.float32)
    x[1] = 0.0
    x[2, :3] = [127.0, 0.5, -0.5]  # scale 1: 0.5 -> 0, -0.5 -> 0
    x[3, :3] = [254.0, 3.0, -5.0]  # scale 2: 1.5 -> 2, -2.5 -> -2
    wq, ws = jax_probes["vit_int8_probe"].quant_rows(jnp.asarray(x))
    q, s = port_probes["vit_int8_probe"].quant_rows(torch.from_numpy(x))
    assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(wq))
    assert np.array_equal(s.numpy(), np.asarray(ws)[:, 0])
    assert q[2, :3].tolist() == [127, 0, 0] and q[3, :3].tolist() == [127, 2, -2]


def test_int32_to_int8_after_the_shift_wraps_in_both_packages():
    y = np.array([[2 ** 16, -(2 ** 16), 300 * 256, -300 * 256, 127 * 256 + 255, -1]], np.int32)
    want = np.asarray((jnp.asarray(y) >> 8).astype(jnp.int8))
    got = (torch.from_numpy(y) >> 8).to(torch.int8).numpy()
    assert np.array_equal(got, want) and want.tolist() == [[0, 0, 44, -44, 127, -1]]


def _jax_int8_chains(i8, ws, k_chain):
    """vit_int8's three chain bodies, as its main() writes them."""
    ws_bf16 = [jnp.asarray(w).astype(jnp.bfloat16) for w in ws]
    wqs, wss = [], []
    for w in ws:
        amax = jnp.max(jnp.abs(w), axis=0, keepdims=True)
        s = jnp.maximum(amax, 1e-8) / 127.0
        wqs.append(jnp.clip(jnp.round(w / s), -127, 127).astype(jnp.int8))
        wss.append(s)

    def bf16(x):
        def body(_, x):
            h = x
            for w in ws_bf16:
                h = jax.lax.dot_general(h[:, : w.shape[0]], w, (((1,), (0,)), ((), ())),
                                        preferred_element_type=jnp.bfloat16)
                h = jnp.tanh(h) * 0.1
            return h[:, :1024] + x * 1e-6
        return jax.lax.fori_loop(0, k_chain, body, x)

    def int8(x):
        def body(_, x):
            h = x
            for wq, ws_ in zip(wqs, wss):
                hq, hs = i8.quant_rows(h[:, : wq.shape[0]])
                y = jax.lax.dot_general(hq, wq, (((1,), (0,)), ((), ())), preferred_element_type=jnp.int32)
                h = jnp.tanh(y.astype(jnp.float32) * hs * ws_) * 0.1
            return h[:, :1024] + x * 1e-6
        return jax.lax.fori_loop(0, k_chain, body, x)

    def raw(x):
        def body(i, x):
            h = x
            for wq in wqs:
                y = jax.lax.dot_general(h[:, : wq.shape[0]], wq, (((1,), (0,)), ((), ())),
                                        preferred_element_type=jnp.int32)
                h = (y >> 8).astype(jnp.int8)
            return h[:, :1024] + (x * 0).at[0, 0].add(i % 2).astype(jnp.int8)
        return jax.lax.fori_loop(0, k_chain, body, x)

    return {"A_bf16": bf16, "B_int8_full": int8, "C_int8_raw": raw}, wqs, wss


@pytest.mark.parametrize("arm", ["A_bf16", "B_int8_full", "C_int8_raw"])
def test_vit_int8_chains(jax_probes, port_probes, int8_weights, arm):
    i8, pm = jax_probes["vit_int8_probe"], port_probes["vit_int8_probe"]
    chains, wqs, wss = _jax_int8_chains(i8, int8_weights, 2)
    g = torch.Generator().manual_seed(0)
    ws = [torch.from_numpy(w) for w in int8_weights]
    pwqs, pwss = zip(*(pm._quantize(w, 0, pm.AMAX_FLOOR) for w in ws))
    assert all(np.array_equal(a.numpy(), np.asarray(b)) for a, b in zip(pwqs, wqs))
    assert all(np.array_equal(a.numpy(), np.asarray(b)[0]) for a, b in zip(pwss, wss))
    if arm == "C_int8_raw":
        x = torch.randint(-127, 128, (INT8_M, 1024), generator=g, dtype=torch.int32).to(torch.int8)
        want = np.asarray(chains[arm](jnp.asarray(x.numpy())))
        got = pm.chain_int8_raw(list(pwqs), x, 2)
        assert got.dtype == torch.int8 and np.array_equal(got.numpy(), want)
        return
    x = torch.randn(INT8_M, 1024, generator=g)
    if arm == "A_bf16":
        xb = x.bfloat16()
        want = np.asarray(chains[arm](jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)).astype(jnp.float32))
        got = pm.chain_bf16([w.bfloat16() for w in ws], xb, 2)
        np.testing.assert_allclose(got.float().numpy(), want, **TOL_BF16)
    else:
        want = np.asarray(chains[arm](jnp.asarray(x.numpy())))
        got = pm.chain_int8(list(pwqs), list(pwss), x, 2)
        np.testing.assert_allclose(got.numpy(), want, **TOL_INT8_CHAIN)


# -- the entry points --------------------------------------------------------------------


ARM_NAMES = {
    "vit_softmax_probe": ["rep0", "deviation"],
    "vit_attn_probe": ["A_full", "E_identity", "F_dpa", "G_bf16_scores"],
    "vit_ceiling2_probe": ["A_full_fused", "B_identity_attn", "C_fused_no_ln", "D_identity_no_ln"],
    "vit_elementwise_probe": ["A_prod", "D1_bf16_ln", "D2_tanh_gelu", "D3_both"],
    "vit_profile": ["A_full", "B_gemms", "C_padded256"],
    "vit_int8_probe": ["A_bf16", "B_int8_full", "C_int8_raw"],
}


@pytest.mark.parametrize("name", PROBES)
def test_probe_entry_points_run_on_the_cpu_when_asked(port_probes, name, capsys):
    """Each entry point at the narrow size on the CPU (plain versions): one
    JSON line per arm under the JAX probe's names, no device rate claimed,
    no kernel launched or built."""
    flags = (["--m", "32", "--k_chain", "2"] if name == "vit_int8_probe"
             else ["--batch", "2", "--hw", "32", "--k", "2"] + (["--reps", "1"] if name == "vit_softmax_probe" else []))
    assert port_probes[name].main(["--device", "cpu", "--runs", "1", *flags]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [line["arm"] for line in lines] == ARM_NAMES[name]
    for line in lines:
        assert line["device"] == "cpu" and line["k3_launches"] == 0 and line["p7_launches"] == 0
        assert all(v is None for k, v in line.items() if "tflops" in k or k == "pct_peak")
        if name == "vit_softmax_probe" and line["arm"] == "rep0":
            assert line["old_tiles_per_s"] > 0 and line["new_tiles_per_s"] > 0 and line["ratio"] > 0
        elif name == "vit_softmax_probe":
            assert line["feature_scale"] > 0 and 0 < line["old_kernel"] < 0.1 and line["new_vs_old"] < 0.1
        elif name == "vit_int8_probe":
            assert line["ms"] > 0
        else:
            assert line[f"{line['arm']}_tiles_per_s"] > 0
    if name == "vit_elementwise_probe":
        assert lines[0]["rel_dev"] == 0.0 and all(0 <= line["rel_dev"] < 0.1 for line in lines)
    assert cuda_mha.LAUNCHES == 0 and cuda_mha.NEW_LAUNCHES == 0 and not _build.is_loaded()


@pytest.mark.parametrize("name", PROBES)
def test_probe_entry_points_refuse_unknown_arms_and_a_machine_without_a_card(port_probes, name):
    with pytest.raises(SystemExit, match="unknown arm"):
        port_probes[name].main(["--device", "cpu", "--arms", "Z_nosuch"])
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="CUDA"):
            port_probes[name].main([])  # refused before any weight is drawn


def test_probe_child_process_exits_non_zero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, "-m", "toad_tpu_torch.experiments.vit_softmax_probe", "--k", "1"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "CUDA" in out.stderr and not out.stdout.strip()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_p7_kernel_matches_plain_on_card(cuda_device):
    """P7 against plain_mha_new at ViT-L's head geometry, ragged last query
    blocks, both dtypes; K3 against the same plain version differs in far
    more elements; refused shapes raise."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for dtype, tol in ((torch.float32, dict(rtol=5e-5, atol=5e-5)), (torch.bfloat16, dict(rtol=1e-2, atol=2e-3))):
        for b, n in ((3, 197), (2, 65), (2, 272 if dtype == torch.bfloat16 else 257)):
            qkv = torch.randn(b, n, 3 * 16 * 64, device=cuda_device, generator=g).to(dtype)
            before = cuda_mha.NEW_LAUNCHES
            out, want = fused_mha_new(qkv, 16, 64), plain_mha_new(qkv, 16, 64)
            torch.cuda.synchronize()
            assert cuda_mha.NEW_LAUNCHES == before + 1
            torch.testing.assert_close(out.float(), want.float(), **tol)
            if dtype == torch.bfloat16:
                share = (out != want).float().mean().item()
                assert share <= 0.02 < 0.2 <= (fused_mha(qkv, 16, 64) != want).float().mean().item()
    with pytest.raises(ValueError, match="head_dim 32 not supported"):
        fused_mha_new(torch.zeros(1, 8, 3 * 2 * 32, device=cuda_device), 2, 32)
    with pytest.raises(ValueError, match="at most 272"):
        fused_mha_new(torch.zeros(1, 300, 3 * 64, device=cuda_device, dtype=torch.bfloat16), 1, 64)


@pytest.mark.cuda
def test_einsum_attention_on_card_matches_plain_mha(cuda_device):
    """The probes' einsum arm on the card (bf16 products with f32 scores)
    against plain_mha (f32 products of the widened operands): summation
    order only, so K3's bf16 tolerance."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    cfg = port_vit.ViTConfig()
    for b, n in ((3, 197), (2, 256)):
        qkv = torch.randn(b, n, 3 * 16 * 64, device=cuda_device, generator=g).to(torch.bfloat16)
        got = common.einsum_attention(cfg)(qkv)
        torch.testing.assert_close(got.float(), plain_mha(qkv, 16, 64).float(), rtol=1e-2, atol=2e-3)
