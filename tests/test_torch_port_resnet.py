"""The port's ResNet-50 encoder and its fused stage against the JAX package.

The same weights (the JAX init, every leaf moved off its trivial value by a
numpy seed) and tiles go through the JAX encoder and its PyTorch counterpart
at a small width (stem 8, so stages of 32/64/128 channels), with the
space-to-depth stem on and off, BN folded and unfolded. The fused stage's
plain version is held against the probe ``experiments/pallas_stage_fusion.py``
(imported by file path, its Pallas kernel in interpret mode); on the CPU
``fused_stage`` is that plain version, and the kernel (KS) runs only on a
card (the ``cuda`` test)."""

import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.config import EncoderConfig as JaxEncoderConfig
from toad_tpu.models import resnet_encoder as jax_resnet
from toad_tpu_torch.config import EncoderConfig
from toad_tpu_torch.models import resnet_encoder as port_resnet
from toad_tpu_torch.models.interop import resnet_params_from_jax
from toad_tpu_torch.ops import _build
from toad_tpu_torch.ops import fused_stage as fs
from toad_tpu_torch.pipeline.featurize import TileEmbedder

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(stem_width=8)
# f32: both compute in full f32; summation order apart, relative to the largest |feature|
TOL_F32 = 1e-4
# bf16: the same rounding points (each conv rounded to bf16, its bias or BN
# added in bf16); measured equal here. This allows a few bf16 ulps of the
# largest feature for a conv that sums in another order.
TOL_BF16 = 2e-2
# the stage: f32 within 1e-5 of the largest |output| (the probe agrees with
# XLA's blocks to 7e-6); bf16 the same rounding points (f32 accumulation,
# h1 and h2 rounded), measured equal here, a bf16 ulp allowed
TOL_STAGE_F32 = 1e-5
TOL_STAGE_BF16 = 1e-2


def _rel(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)).max() / np.abs(want).max())


def _jiggled(params, seed: int = 0):
    """Every leaf moved off its trivial value (BN variances kept positive)."""
    rng = np.random.default_rng(seed)

    def walk(tree, key=""):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        a = np.asarray(tree, np.float32)
        if key == "var":
            return a + rng.random(a.shape).astype(np.float32)
        return a + rng.standard_normal(a.shape).astype(np.float32) * 0.05

    return walk(params)


@pytest.fixture(scope="module")
def jax_params():
    cfg = JaxEncoderConfig(**SMALL)
    return _jiggled(jax.tree.map(np.asarray, jax_resnet.ResNetEncoder(cfg).init(jax.random.PRNGKey(0))))


@pytest.fixture(scope="module")
def tiles():
    return np.random.default_rng(1).integers(0, 256, (3, 32, 32, 3), dtype=np.uint8)


# -- the encoder --------------------------------------------------------------


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stem_s2d", [True, False])
@pytest.mark.parametrize("folded", [False, True])
def test_encoder_matches_jax_encoder(jax_params, tiles, compute_dtype, stem_s2d, folded):
    """apply (unfolded params) and apply_folded (folded) against the JAX
    functions of the same name, on the same normalized tiles."""
    jcfg = JaxEncoderConfig(**SMALL, compute_dtype=compute_dtype, stem_s2d=stem_s2d)
    x = np.asarray(jax_resnet.ResNetEncoder(jcfg).preprocess(jnp.asarray(tiles)))
    params = jax_resnet.fold_bn(jax_params, jcfg) if folded else jax_params
    if folded:
        want = np.asarray(jax_resnet.apply_folded(jcfg, params, jnp.asarray(x)))
    else:
        want = np.asarray(jax_resnet.ResNetEncoder(jcfg).apply(params, jnp.asarray(x)))
    cfg = EncoderConfig(**SMALL, compute_dtype=compute_dtype, stem_s2d=stem_s2d)
    enc = port_resnet.encoder_from_state_dict(resnet_params_from_jax(params), cfg)
    assert enc.folded == folded
    got = (enc.apply_folded if folded else enc.apply)(torch.from_numpy(x.copy()))
    assert got.dtype == torch.float32 and got.shape == (3, cfg.out_dim) == want.shape
    assert _rel(got.numpy(), want) <= (TOL_F32 if compute_dtype == "float32" else TOL_BF16)


@pytest.mark.parametrize("fold_bn", [True, False])
def test_tile_embedder_matches_make_embedder(jax_params, tiles, fold_bn):
    """uint8 tiles -> features: the JAX make_embedder against the port's
    TileEmbedder, which folds BN once at construction when the config asks."""
    jcfg = JaxEncoderConfig(**SMALL, compute_dtype="float32", fold_bn=fold_bn)
    fp, embed_fn = jax_resnet.make_embedder(jcfg, jax_params)
    want = np.asarray(embed_fn(fp, jnp.asarray(tiles)))
    cfg = EncoderConfig(**SMALL, compute_dtype="float32", fold_bn=fold_bn)
    embedder = TileEmbedder(port_resnet.encoder_from_state_dict(resnet_params_from_jax(jax_params), cfg), batch_size=2)
    assert embedder.encoder.folded == fold_bn
    got = embedder.embed_all(tiles)  # two batches, the last one padded
    assert got.shape == (3, 128) and _rel(got, want) <= TOL_F32


def test_fold_bn_exact_and_idempotent(jax_params):
    cfg = EncoderConfig(**SMALL)
    jax_folded = jax_resnet.fold_bn(jax_params, JaxEncoderConfig(**SMALL))
    enc = port_resnet.encoder_from_state_dict(resnet_params_from_jax(jax_params), cfg)
    assert enc.fold_bn() is enc and enc.folded
    got = enc.state_dict()
    want = resnet_params_from_jax(jax_folded)
    assert list(got) == list(want) == port_resnet.state_dict_keys(cfg, folded=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k  # the same f32 operations as the JAX package's numpy fold
    again = {k: v.clone() for k, v in enc.fold_bn().state_dict().items()}
    assert all(torch.equal(again[k], want[k]) for k in want)
    refolded = port_resnet.encoder_from_state_dict(want, cfg).fold_bn()  # a folded state_dict folds to itself
    assert all(torch.equal(refolded.state_dict()[k], want[k]) for k in want)
    jax_again = resnet_params_from_jax(jax_resnet.fold_bn(jax_folded, JaxEncoderConfig(**SMALL)))  # JAX's is too
    assert all(torch.equal(jax_again[k], want[k]) for k in want)


def test_state_dict_keys_are_torchvision_names():
    keys = port_resnet.state_dict_keys(EncoderConfig())
    assert keys[:5] == ["conv1.weight", "bn1.weight", "bn1.bias", "bn1.running_mean", "bn1.running_var"]
    assert "layer1.0.downsample.0.weight" in keys and "layer1.0.downsample.1.running_var" in keys
    assert "layer3.5.conv3.weight" in keys and not any(k.startswith(("layer4", "fc")) for k in keys)
    assert "layer1.1.downsample.0.weight" not in keys
    folded = port_resnet.state_dict_keys(EncoderConfig(), folded=True)
    assert "conv1.bias" in folded and not any(".bn" in k or k.startswith("bn") for k in folded)


def test_param_count_at_full_width_equals_jax():
    """The JAX pytree's leaves, BN running statistics included: 8,573,888
    unfolded, 8,528,000 folded (the conv weights and one bias per BN)."""
    cfg = JaxEncoderConfig()
    shapes = jax.eval_shape(jax_resnet.ResNetEncoder(cfg).init, jax.random.PRNGKey(0))
    count = sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(shapes))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    folded = sum(int(np.prod(np.shape(leaf))) for leaf in jax.tree.leaves(jax_resnet.fold_bn(zeros, cfg)))
    enc = port_resnet.ResNetEncoder(EncoderConfig())
    assert enc.param_count() == count == 8_573_888
    assert enc.fold_bn().param_count() == folded == 8_528_000


def test_stem_s2d_weights_and_space_to_depth_match_jax():
    rng = np.random.default_rng(3)
    w = rng.standard_normal((7, 7, 3, 8)).astype(np.float32)  # HWIO
    want = np.asarray(jax_resnet._stem_s2d_weights(jnp.asarray(w)))  # [4, 4, 12, 8]
    got = port_resnet.stem_s2d_weights(torch.from_numpy(w.transpose(3, 2, 0, 1).copy()))  # OIHW in
    np.testing.assert_array_equal(got.permute(2, 3, 1, 0).numpy(), want)
    x = rng.standard_normal((2, 6, 8, 3)).astype(np.float32)
    np.testing.assert_array_equal(port_resnet.space_to_depth2(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_resnet._space_to_depth2(jnp.asarray(x))))
    with pytest.raises(ValueError, match="7x7"):
        port_resnet.stem_s2d_weights(torch.zeros(8, 3, 5, 5))


def test_odd_tiles_take_the_plain_stem(jax_params):
    """s2d needs even sides; a 33-px tile takes the 7x7/2 conv, as in JAX."""
    tiles = np.random.default_rng(4).integers(0, 256, (1, 33, 33, 3), dtype=np.uint8)
    jcfg = JaxEncoderConfig(**SMALL, compute_dtype="float32")
    fp, embed_fn = jax_resnet.make_embedder(jcfg, jax_params)
    enc = port_resnet.encoder_from_state_dict(resnet_params_from_jax(jax_params),
                                              EncoderConfig(**SMALL, compute_dtype="float32")).fold_bn()
    assert _rel(enc.embed(torch.from_numpy(tiles)).numpy(), np.asarray(embed_fn(fp, jnp.asarray(tiles)))) <= TOL_F32


def test_weights_are_cast_once_and_again_when_one_changes():
    enc = port_resnet.ResNetEncoder(EncoderConfig(**SMALL), torch.Generator().manual_seed(0))
    first = enc._weights(torch.bfloat16)
    assert enc._weights(torch.bfloat16) is first
    with torch.no_grad():
        enc.layer1[0].conv1.weight.mul_(2.0)
    assert enc._weights(torch.bfloat16) is not first
    enc.fold_bn()
    assert ("bias", id(enc.conv1)) in enc._weights(torch.bfloat16)


def test_random_init_takes_an_explicit_generator():
    a = port_resnet.ResNetEncoder(EncoderConfig(**SMALL), torch.Generator().manual_seed(5))
    b = port_resnet.ResNetEncoder(EncoderConfig(**SMALL), torch.Generator().manual_seed(5))
    torch.manual_seed(123)  # the global generator plays no part
    c = port_resnet.ResNetEncoder(EncoderConfig(**SMALL), torch.Generator().manual_seed(6))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["layer1.0.conv1.weight"], sc["layer1.0.conv1.weight"])
    w = sa["layer2.0.conv2.weight"]  # Kaiming fan-out: std sqrt(2 / (3 * 3 * 16))
    assert abs(float(w.std()) - (2.0 / (9 * 16)) ** 0.5) < 0.02
    assert torch.equal(sa["bn1.running_var"], torch.ones(8))


@pytest.mark.parametrize("wrapped", [False, True])
@pytest.mark.parametrize("prefix", ["", "module."])
def test_load_torchvision_weights_read_by_both_packages(tmp_path, wrapped, prefix):
    """One synthetic torchvision-layout .pth: torchvision's key names, the
    layer4/fc keys and num_batches_tracked a real file has (never read)."""
    g = torch.Generator().manual_seed(7)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in port_resnet.ResNetEncoder(
        EncoderConfig(), init=False).state_dict().items()}
    extra = {"fc.weight": torch.zeros(10, 4), "fc.bias": torch.zeros(10), "layer4.0.conv1.weight": torch.zeros(4, 4, 1, 1),
             "bn1.num_batches_tracked": torch.tensor(3)}
    blob = {f"{prefix}{k}": v for k, v in {**sd, **extra}.items()}
    path = tmp_path / "resnet50.pth"
    torch.save({"state_dict": blob, "epoch": 90} if wrapped else blob, path)
    got = port_resnet.load_torchvision_weights(path)
    assert list(got) == list(sd) and all(torch.equal(got[k], sd[k]) for k in sd)
    want = resnet_params_from_jax(jax_resnet.load_torchvision_weights(path))
    assert list(want) == list(sd) and all(torch.equal(want[k], sd[k]) for k in sd)
    torch.save([1, 2], tmp_path / "list.pth")
    with pytest.raises(ValueError, match="expected a state_dict"):
        port_resnet.load_torchvision_weights(tmp_path / "list.pth")


def test_apply_folded_refuses_unfolded_weights():
    enc = port_resnet.ResNetEncoder(EncoderConfig(**SMALL))
    with pytest.raises(ValueError, match="fold_bn"):
        enc.apply_folded(torch.zeros(1, 32, 32, 3))
    with pytest.raises(ValueError, match="BN-folded"):
        fs.stage_weights(enc.layer1, torch.float32)


# -- the fused stage ----------------------------------------------------------


def _probe():
    spec = importlib.util.spec_from_file_location("pallas_stage_fusion", REPO / "experiments" / "pallas_stage_fusion.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def folded(jax_params):
    """(JAX folded params, the port's folded encoder holding them)."""
    fp = jax.tree.map(np.asarray, jax_resnet.fold_bn(jax_params, JaxEncoderConfig(**SMALL)))
    return fp, port_resnet.encoder_from_state_dict(resnet_params_from_jax(fp), EncoderConfig(**SMALL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layer,stride,cin,side", [("layer1", 1, 8, 8), ("layer2", 2, 32, 8)])
def test_plain_stage_matches_the_probe(folded, dtype, layer, stride, cin, side):
    """layer1-like (stride 1, downsample then identity blocks) and
    layer2-like (stride 2 on the first block) against the probe's Pallas
    kernel in interpret mode."""
    fp, enc = folded
    x = np.random.default_rng(side + cin).standard_normal((2, side, side, cin)).astype(np.float32)
    want = np.asarray(_probe().fused_stage(fp[layer], jnp.asarray(x), first_stride=stride,
                                           compute_dtype=jnp.dtype(dtype), interpret=True), np.float32)
    got = fs.plain_stage(getattr(enc, layer), torch.from_numpy(x), stride, getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    assert _rel(got.float().numpy(), want) <= (TOL_STAGE_F32 if dtype == "float32" else TOL_STAGE_BF16)


def test_fused_stage_on_a_cpu_tensor_is_plain_stage(folded):
    _, enc = folded
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 8, 8, 32)).astype(np.float32))
    for dt in (torch.float32, torch.bfloat16):
        assert torch.equal(fs.fused_stage(enc.layer2, x, first_stride=2, compute_dtype=dt),
                           fs.plain_stage(enc.layer2, x, 2, dt))
    with pytest.raises(ValueError, match="no stage path"):
        fs.fused_stage(enc.layer2, x.to("meta"), first_stride=2)
    # the kernel's wrapper never gives way to the plain version
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        fs.stage_block(fs.stage_weights(enc.layer2, torch.float32)[0], x, 2)
    assert fs.LAUNCHES == 0 and not _build.is_loaded()


def test_stage_weights_layout_and_cache(folded):
    _, enc = folded
    ops = fs.stage_weights(enc.layer2, torch.bfloat16)
    assert fs.stage_weights(enc.layer2, torch.bfloat16) is ops
    blk = enc.layer2[0]
    w2 = blk.conv2.weight  # [out, in, 3, 3]: tap (dy, dx) of ops.w2 is w2[:, :, dy, dx].T
    assert torch.equal(ops[0].w2[5], w2[:, :, 1, 2].t().bfloat16()) and ops[0].b1.dtype == torch.float32
    assert tuple(ops[0].wd.shape) == (32, 64) and ops[1].wd is None
    with torch.no_grad():
        blk.conv1.weight.add_(1.0)
    assert fs.stage_weights(enc.layer2, torch.bfloat16) is not ops
    with torch.no_grad():
        blk.conv1.weight.sub_(1.0)


@pytest.mark.parametrize("case", ["width", "identity_stride", "odd_map", "channels"])
def test_check_block_refuses_what_the_kernel_does_not_take(case):
    bf = torch.bfloat16

    def ops(cin, width, ds):
        return fs.BlockOperands(torch.zeros(cin, width, dtype=bf), torch.zeros(width), torch.zeros(9, width, width, dtype=bf),
                                torch.zeros(width), torch.zeros(width, 4 * width, dtype=bf), torch.zeros(4 * width),
                                torch.zeros(cin, 4 * width, dtype=bf) if ds else None, torch.zeros(4 * width) if ds else None)

    o, shape, stride, match = {
        "width": (ops(256, 96, True), (1, 8, 8, 256), 1, "no kernel instance"),
        "identity_stride": (ops(256, 64, False), (1, 8, 8, 256), 2, "identity skip"),
        "odd_map": (ops(256, 128, True), (1, 7, 7, 256), 2, "multiples of the stride"),
        "channels": (ops(256, 64, True), (1, 8, 8, 128), 1, "must be"),
    }[case]
    with pytest.raises(ValueError, match=match):
        fs.check_block(o, torch.zeros(shape, dtype=bf), stride)
    fs.check_block(ops(256, 64, False), torch.zeros(1, 8, 8, 256, dtype=bf), 1)  # a layer1 block: taken


def test_block_work_counts_each_conv_at_its_resolution():
    bf = torch.bfloat16
    o = fs.BlockOperands(torch.zeros(256, 128, dtype=bf), torch.zeros(128), torch.zeros(9, 128, 128, dtype=bf),
                         torch.zeros(128), torch.zeros(128, 512, dtype=bf), torch.zeros(512),
                         torch.zeros(256, 512, dtype=bf), torch.zeros(512))
    flops, moved = fs.block_work(o, (64, 64, 64, 256), 2)
    p_in, p_out = 64 * 64 * 64, 64 * 32 * 32
    assert flops == 2 * (p_in * 256 * 128 + p_out * (9 * 128 * 128 + 128 * 512 + 256 * 512))
    assert moved == 2 * (p_in * 256 + p_out * 512) + sum(t.numel() * t.element_size() for t in o)


@pytest.mark.cuda
def test_stage_kernel_matches_plain_on_card():
    """Runs only on a CUDA machine: KS against plain_stage at full width on a
    ragged map (14: edge tiles masked), both dtypes, one launch a block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    enc = port_resnet.ResNetEncoder(EncoderConfig(), torch.Generator().manual_seed(0)).fold_bn().cuda()
    g = torch.Generator(device="cuda").manual_seed(0)
    for dt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        x = torch.relu(torch.randn(2, 56, 56, 64, device="cuda", generator=g)).to(dt)
        for stage, stride in enc.stages():
            before = fs.LAUNCHES
            got = fs.fused_stage(stage, x, first_stride=stride, compute_dtype=dt)
            torch.cuda.synchronize()
            assert fs.LAUNCHES == before + len(stage)
            want = fs.plain_stage(stage, x, stride, dt)
            assert float((got.float() - want.float()).abs().max()) <= tol * float(want.float().abs().max())
            x = want


def test_interop_keys_match_the_port_state_dict(jax_params):
    cfg = EncoderConfig(**SMALL)
    assert list(resnet_params_from_jax(jax_params)) == port_resnet.state_dict_keys(cfg)
    folded = jax_resnet.fold_bn(jax_params, JaxEncoderConfig(**SMALL))
    assert list(resnet_params_from_jax(folded)) == port_resnet.state_dict_keys(cfg, folded=True)
    assert json.dumps(sorted(set(k.split(".")[0] for k in resnet_params_from_jax(folded)))) == \
        '["conv1", "layer1", "layer2", "layer3"]'
