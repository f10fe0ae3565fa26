"""The port's ViT encoder and its attention core against the JAX package.

The same inputs and weights, made from a numpy seed, go through the JAX
function (the Pallas attention kernel in interpret mode, as the JAX package's
own CPU tests run it) and its PyTorch counterpart, which on the CPU runs the
kernel's plain version. Small sizes: width 128, depth 2, two heads."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.models import vit_encoder as jax_vit
from toad_tpu.ops import vit_attention as jax_attention
from toad_tpu_torch.models import vit_encoder as port_vit
from toad_tpu_torch.models.interop import vit_params_from_jax
from toad_tpu_torch.ops import _build, cuda_mha
from toad_tpu_torch.ops.vit_attention import fused_mha, fused_mha_new, plain_mha, plain_mha_new

TINY = dict(patch_size=8, width=128, depth=2, heads=2, pretrain_img_size=32)
# f32: both sides compute in full f32, summation order apart.
TOL_F32 = dict(rtol=1e-5, atol=1e-5)
# bf16 attention: the JAX tests' own bound (tests/test_vit.py), one bf16 ulp and change
TOL_BF16 = dict(rtol=2e-2, atol=2e-2)
# the encoder: f32 sums over width-128 rows through two blocks; bf16 rounds
# every activation, and the two frameworks round GELU and the bias adds at
# different places
TOL_ENC_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_ENC_BF16 = dict(rtol=3e-2, atol=3e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


def _to_torch(x: np.ndarray, dtype: str) -> torch.Tensor:
    return torch.from_numpy(x).to(getattr(torch, dtype))


# -- (a) the attention core ---------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n_tokens", [33, 197])
@pytest.mark.parametrize("head_dim", [16, 64])
def test_fused_mha_matches_jax_kernel_and_reference(dtype, n_tokens, head_dim):
    heads = 2
    rng = np.random.default_rng(n_tokens + head_dim)
    qkv = rng.standard_normal((3, n_tokens, 3 * heads * head_dim)).astype(np.float32)
    jq = jnp.asarray(qkv, jnp.dtype(dtype))
    kernel = np.asarray(jax_attention.fused_mha(jq, heads, head_dim, block_b=2, interpret=True), np.float32)
    reference = np.asarray(jax_attention.mha_reference(jq, heads, head_dim), np.float32)
    got = fused_mha(_to_torch(qkv, dtype), heads, head_dim)
    assert got.dtype == getattr(torch, dtype) and got.shape == (3, n_tokens, heads * head_dim)
    tol = TOL_F32 if dtype == "float32" else TOL_BF16
    np.testing.assert_allclose(got.float().numpy(), kernel, **tol)
    np.testing.assert_allclose(got.float().numpy(), reference, **tol)


def test_fused_mha_rejects_bad_width_in_the_jax_words():
    with pytest.raises(ValueError, match=r"qkv last dim 100 != 3\*heads\*head_dim 48"):
        fused_mha(torch.zeros(1, 8, 100), heads=2, head_dim=8)
    with pytest.raises(ValueError, match=r"3\*heads\*head_dim"):
        jax_attention.fused_mha(jnp.zeros((1, 8, 100)), heads=2, head_dim=8, interpret=True)


def test_only_the_device_chooses_between_kernel_and_plain_version():
    qkv = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 9, 3 * 2 * 64)).astype(np.float32))
    # a CPU tensor: the plain version, bit for bit
    assert torch.equal(fused_mha(qkv, 2, 64), plain_mha(qkv, 2, 64))
    with pytest.raises(ValueError, match="no attention path"):
        fused_mha(qkv.to("meta"), 2, 64)
    # the kernel's wrapper never gives way to the plain version
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        cuda_mha.mha(qkv, 2, 64)
    assert cuda_mha.LAUNCHES == 0 and not _build.is_loaded()


def test_plain_mha_rounding_points():
    """p is rounded to the input dtype before p @ v, and the context is
    accumulated in f32: unlike an all-bf16 product."""
    rng = np.random.default_rng(5)
    qkv = torch.from_numpy(rng.standard_normal((1, 40, 3 * 64)).astype(np.float32)).bfloat16()
    q, k, v = qkv.float().reshape(1, 40, 3, 1, 64).unbind(2)
    s = torch.einsum("bnhd,bmhd->bhnm", q, k) * 64**-0.5
    p = torch.softmax(s, -1).bfloat16().float()
    want = torch.einsum("bhnm,bmhd->bnhd", p, v).reshape(1, 40, 64).bfloat16()
    assert torch.equal(plain_mha(qkv, 1, 64), want)


@pytest.mark.cuda
def test_attention_kernel_matches_plain_on_card(cuda_device):
    """Runs only on a CUDA machine: K3 against plain_mha at ViT-L's head
    geometry, a ragged last query block, both dtypes, then at ragged shapes
    (and P7 against plain_mha_new at two of them); refused shapes raise."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    tols = {torch.float32: dict(rtol=5e-5, atol=5e-5), torch.bfloat16: dict(rtol=1e-2, atol=2e-3)}
    for dtype, tol in tols.items():
        for b, n in ((3, 197), (2, 257)):
            qkv = torch.randn(b, n, 3 * 16 * 64, device=cuda_device, generator=g).to(dtype)
            before = cuda_mha.LAUNCHES
            out = fused_mha(qkv, 16, 64)
            torch.cuda.synchronize()
            assert cuda_mha.LAUNCHES == before + 1
            torch.testing.assert_close(out.float(), plain_mha(qkv, 16, 64).float(), **tol)
        # ragged shapes, one launch each: one-row last query tiles, both instances (N <= 208 and
        # N > 208), unit counts B x H that are no multiple of the persistent grid
        for n in (1, 15, 16, 17, 63, 64, 65, 193, 197, 208, 209, 257, 272):
            for b in (1, 3):
                for heads in (1, 16):
                    qkv = torch.randn(b, n, 3 * heads * 64, device=cuda_device, generator=g).to(dtype)
                    torch.testing.assert_close(fused_mha(qkv, heads, 64).float(), plain_mha(qkv, heads, 64).float(),
                                               **tol)
        # P7 at two of them: at most one ulp, and in bf16 in at most 2 % of the elements
        for n in (17, 257):
            qkv = torch.randn(3, n, 3 * 16 * 64, device=cuda_device, generator=g).to(dtype)
            got, want = fused_mha_new(qkv, 16, 64), plain_mha_new(qkv, 16, 64)
            torch.testing.assert_close(got.float(), want.float(), **tol)
            if dtype == torch.bfloat16:
                assert (got != want).float().mean().item() <= 0.02
    with pytest.raises(ValueError, match="head_dim 32 not supported"):
        fused_mha(torch.zeros(1, 8, 3 * 2 * 32, device=cuda_device), 2, 32)
    with pytest.raises(ValueError, match="at most 272"):
        fused_mha(torch.zeros(1, 300, 3 * 64, device=cuda_device, dtype=torch.bfloat16), 1, 64)


# -- (b) the encoder ----------------------------------------------------------


def _jax_params(cfg: jax_vit.ViTConfig, seed: int = 0):
    """JAX init, then every bias, LayerNorm and LayerScale leaf moved off its
    trivial value so that each of them shows in the features."""
    params = jax.tree.map(np.asarray, jax_vit.ViTEncoder(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)

    def jiggle(tree):
        if isinstance(tree, dict):
            return {k: jiggle(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [jiggle(v) for v in tree]
        return tree + rng.standard_normal(tree.shape).astype(np.float32) * 0.05

    params = jiggle(params)
    for blk in params["blocks"]:
        if "ls1" in blk:
            blk["ls1"], blk["ls2"] = blk["ls1"] + 0.5, blk["ls2"] + 0.5
    return params


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layerscale", [True, False])
@pytest.mark.parametrize("tile", [32, 48], ids=["pretrain_size", "resized_grid"])
def test_encoder_matches_jax_encoder(compute_dtype, layerscale, tile):
    kw = dict(TINY, layerscale=layerscale, compute_dtype=compute_dtype)
    jax_cfg = jax_vit.ViTConfig(**kw, attention="fused")  # the Pallas kernel, in interpret mode off the TPU
    params = _jax_params(jax_cfg)
    tiles = np.random.default_rng(1).integers(0, 256, (3, tile, tile, 3), dtype=np.uint8)
    want = np.asarray(jax_vit.ViTEncoder(jax_cfg).embed(params, jnp.asarray(tiles)))
    enc = port_vit.encoder_from_state_dict(vit_params_from_jax(params), port_vit.ViTConfig(**kw))
    got = enc.embed(torch.from_numpy(tiles))
    assert got.dtype == torch.float32 and got.shape == (3, 128)
    np.testing.assert_allclose(got.numpy(), want, **(TOL_ENC_F32 if compute_dtype == "float32" else TOL_ENC_BF16))
    # preprocess alone, and apply on its result, are the same two steps
    pre = enc.preprocess(torch.from_numpy(tiles))
    np.testing.assert_allclose(pre.numpy(), np.asarray(jax_vit.ViTEncoder(jax_cfg).preprocess(jnp.asarray(tiles))),
                               rtol=1e-6, atol=1e-6)
    assert torch.equal(enc.apply(pre), got)


def test_config_has_the_jax_fields_and_defaults():
    want = {(f.name, f.type, f.default) for f in dataclasses.fields(jax_vit.ViTConfig)}
    assert {(f.name, f.type, f.default) for f in dataclasses.fields(port_vit.ViTConfig)} == want
    assert (port_vit.ViTConfig().out_dim, port_vit.ViTConfig().head_dim) == (1024, 64)


def test_attention_switch_has_no_way_to_the_plain_version():
    """auto and fused are both fused_mha; the JAX package's einsum branch
    ('xla') is refused, so no config puts another attention on the path."""
    for value in ("auto", "fused"):
        port_vit.ViTEncoder(port_vit.ViTConfig(**TINY, attention=value), init=False)
    with pytest.raises(ValueError, match=r"auto\|fused"):
        port_vit.ViTEncoder(port_vit.ViTConfig(**TINY, attention="xla"), init=False)
    with pytest.raises(ValueError, match=r"auto\|exact\|tanh"):
        port_vit.ViTEncoder(port_vit.ViTConfig(**TINY, gelu="banana"), init=False)


def test_gelu_resolution_matches_jax():
    for kw in (dict(compute_dtype="bfloat16"), dict(compute_dtype="float32"),
               dict(gelu="tanh", compute_dtype="float32"), dict(gelu="exact", compute_dtype="bfloat16")):
        assert port_vit._resolve_gelu(port_vit.ViTConfig(**kw)) == bool(jax_vit._resolve_gelu(jax_vit.ViTConfig(**kw)))


def test_tile_not_divisible_by_patch_raises():
    enc = port_vit.ViTEncoder(port_vit.ViTConfig(**TINY))
    with pytest.raises(ValueError, match="not divisible by patch size 8"):
        enc.embed(torch.zeros(1, 36, 32, 3, dtype=torch.uint8))


def test_weights_are_cast_once_and_again_when_one_changes():
    enc = port_vit.ViTEncoder(port_vit.ViTConfig(**TINY))
    tiles = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    first = enc.embed(tiles)
    cast = enc._weights(torch.bfloat16)
    assert cast["blocks"][0]["qkv"][0].dtype == torch.bfloat16
    assert enc._weights(torch.bfloat16) is cast  # no second cast
    assert torch.equal(enc.embed(tiles), first)
    with torch.no_grad():
        enc.blocks[0].attn.qkv.weight.mul_(2.0)
    assert enc._weights(torch.bfloat16) is not cast
    assert not torch.equal(enc.embed(tiles), first)
    # f32 compute on f32 parameters copies nothing
    assert enc._weights(torch.float32)["blocks"][0]["qkv"][0].data_ptr() == enc.blocks[0].attn.qkv.weight.data_ptr()


def test_random_init_takes_an_explicit_generator():
    cfg = port_vit.ViTConfig(**TINY)
    a = port_vit.ViTEncoder(cfg, torch.Generator().manual_seed(7)).state_dict()
    b = port_vit.ViTEncoder(cfg, torch.Generator().manual_seed(7)).state_dict()
    c = port_vit.ViTEncoder(cfg, torch.Generator().manual_seed(8)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["blocks.0.attn.qkv.weight"], c["blocks.0.attn.qkv.weight"])
    w = a["blocks.1.mlp.fc1.weight"]
    assert w.abs().max() <= 0.04 and 0.015 < w.std() < 0.02  # N(0, 0.02) cut at two sigma
    assert torch.all(a["blocks.0.ls1.gamma"] == 1e-5) and torch.all(a["norm.weight"] == 1)
    assert not a["cls_token"].any() and not a["blocks.0.attn.qkv.bias"].any()
    # the same leaves as the JAX init, under timm's names
    jax_params = jax.tree.map(np.asarray, jax_vit.ViTEncoder(jax_vit.ViTConfig(**TINY)).init(jax.random.PRNGKey(0)))
    carried = vit_params_from_jax(jax_params)
    assert {k: tuple(v.shape) for k, v in carried.items()} == {k: tuple(v.shape) for k, v in a.items()}


def test_full_size_parameter_count():
    enc = port_vit.ViTEncoder(port_vit.ViTConfig(), init=False)  # ViT-L/16, parameters unset
    assert 300_000_000 < enc.param_count() < 310_000_000
    assert enc.pos_embed.shape == (1, 197, 1024)


# -- (c) the position-embedding resize ----------------------------------------


@pytest.mark.parametrize("grid", [(16, 16), (10, 12), (14, 14)], ids=["256px", "shrunk", "unchanged"])
def test_pos_embed_resize_matches_jax_image_resize(grid):
    jax_cfg, cfg = jax_vit.ViTConfig(width=64), port_vit.ViTConfig(width=64)  # 14 x 14 stored grid
    pos = np.random.default_rng(3).standard_normal((1, 197, 64)).astype(np.float32)
    want = np.asarray(jax_vit._resize_pos_embed(jnp.asarray(pos), jax_cfg, *grid))
    got = port_vit.resize_pos_embed(torch.from_numpy(pos), cfg, *grid).numpy()
    assert got.shape == (1, 1 + grid[0] * grid[1], 64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if grid != (14, 14):
        # F.interpolate's bicubic is another kernel (a = -0.75, clamped edges): it would not pass
        g = torch.from_numpy(pos[:, 1:]).reshape(1, 14, 14, 64).permute(0, 3, 1, 2)
        other = torch.nn.functional.interpolate(g, size=grid, mode="bicubic", align_corners=False)
        assert np.abs(other.permute(0, 2, 3, 1).reshape(1, -1, 64).numpy() - want[:, 1:]).max() > 1e-3


# -- (d) timm weight files ----------------------------------------------------


def _timm_state_dict(old_names: bool = False):
    cfg = port_vit.ViTConfig(**{**TINY, "heads": 2})
    sd = port_vit.ViTEncoder(cfg, torch.Generator().manual_seed(11)).state_dict()
    rng = torch.Generator().manual_seed(12)
    sd = {k: (v + 0.05 * torch.randn(v.shape, generator=rng)) for k, v in sd.items()}
    if old_names:
        sd = {k.replace("ls1.gamma", "gamma_1").replace("ls2.gamma", "gamma_2"): v for k, v in sd.items()}
    sd["head.weight"] = torch.zeros(5, 128)  # a classifier head, to be ignored
    return sd


@pytest.mark.parametrize("wrapper,prefix,old_names", [
    (None, "", False), ("model", "module.", False), ("state_dict", "model.", True), ("teacher", "", False),
])
def test_load_timm_weights_read_by_both_packages(tmp_path, wrapper, prefix, old_names):
    sd = {prefix + k: v for k, v in _timm_state_dict(old_names).items()}
    path = tmp_path / "vit.bin"
    torch.save({wrapper: sd} if wrapper else sd, path)
    jax_params, jax_cfg = jax_vit.load_timm_weights(path)
    port_sd, cfg = port_vit.load_timm_weights(path)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_cfg)
    assert (cfg.width, cfg.depth, cfg.heads, cfg.patch_size, cfg.pretrain_img_size, cfg.layerscale) == (128, 2, 2, 8, 32, True)
    assert "head.weight" not in port_sd
    tiles = np.random.default_rng(4).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    f32 = dict(compute_dtype="float32")
    want = np.asarray(jax_vit.ViTEncoder(dataclasses.replace(jax_cfg, **f32)).embed(jax_params, jnp.asarray(tiles)))
    enc = port_vit.encoder_from_state_dict(port_sd, dataclasses.replace(cfg, **f32))
    np.testing.assert_allclose(enc.embed(torch.from_numpy(tiles)).numpy(), want, **TOL_ENC_F32)


def test_timm_state_dict_loads_into_the_module_directly():
    sd = _timm_state_dict()
    sd.pop("head.weight")
    enc = port_vit.ViTEncoder(port_vit.ViTConfig(**TINY), init=False)
    enc.load_state_dict(sd)  # strict: timm's names are the module's
    assert torch.equal(enc.blocks[1].mlp.fc2.weight, sd["blocks.1.mlp.fc2.weight"])


def test_head_count_inference_and_its_error():
    sd = _timm_state_dict()
    _, cfg = port_vit.params_from_timm_state_dict(sd, heads=4)
    assert cfg.heads == 4
    bad = dict(sd)
    bad["cls_token"] = torch.zeros(1, 1, 96)
    with pytest.raises(ValueError, match="cannot infer head count for width 96 .* pass heads= explicitly"):
        port_vit.params_from_timm_state_dict(bad)
    given = port_vit.ViTConfig(**TINY, gelu="exact")
    assert port_vit.params_from_timm_state_dict(sd, config=given)[1] is given


def test_load_timm_weights_rejects_a_non_dict(tmp_path):
    torch.save(torch.zeros(3), tmp_path / "t.bin")
    with pytest.raises(ValueError, match="expected a state_dict"):
        port_vit.load_timm_weights(tmp_path / "t.bin")
