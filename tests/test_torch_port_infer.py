"""Slide inference of the PyTorch port against the JAX package, on the CPU.

The same seeded numpy bags and the same weights (carried across with
``models/interop.py``) go through ``toad_tpu.pipeline.infer`` (its XLA path)
and ``toad_tpu_torch.pipeline.infer`` (the plain versions of the pooling
kernels, which the port runs on a CPU tensor).

Tolerances:
- f32: probabilities 1e-5, raw attention 1e-4 of its largest |score| (both
  sides are f32 with another summation order); predictions and the top-k
  order equal;
- bf16: probabilities 1e-4, as tests/test_torch_port_model.py holds bf16
  logits (bf16 rounding of the activations, ~1e-5 observed here); raw
  attention 1e-2 of its largest |score|: the score head sums activations
  that each may sit one bf16 ulp (2^-8 relative) apart, 4.7e-3 observed;
- int8: the tolerances of tests/test_torch_port_int8.py: probabilities 2e-3,
  logits and raw attention 1e-2 (the integer GEMMs agree; a dequantized
  value may round its last bit differently and move one requantized step,
  and the port's plain int8 pool rounds gated values to bf16 where XLA
  keeps f32);
- within the port: the bf16 wire bit for bit the f32 wire; a bag in two
  buckets, and a single-member ensemble against its model, 2e-5 (the JAX
  package's own padding test).
"""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from toad_tpu.config import EncoderConfig as JaxEncoderConfig
from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.models import resnet_encoder as jax_resnet
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.pipeline import featurize as jax_featurize
from toad_tpu.pipeline import infer as jax_infer
from toad_tpu_torch.config import DEFAULT_BUCKETS, EncoderConfig, ModelConfig
from toad_tpu_torch.data.bags import save_int8_bag
from toad_tpu_torch.evaluate.calibration import apply_temperature
from toad_tpu_torch.models.interop import params_from_jax, reference_state_dict, resnet_params_from_jax
from toad_tpu_torch.models.resnet_encoder import encoder_from_state_dict
from toad_tpu_torch.ops import cuda_pool, cuda_pool_int8
from toad_tpu_torch.ops.quantize import quantize_rows_np
from toad_tpu_torch.pipeline import infer
from toad_tpu_torch.pipeline.featurize import TileEmbedder, write_bag

D, N_CLS = 64, 5
BUCKETS = (64, 128, 256)
TOL = {"float32": dict(prob=1e-5, attn=1e-4), "bfloat16": dict(prob=1e-4, attn=1e-2)}
TOL_INT8 = dict(prob=2e-3, attn=1e-2)


def _jax_params(seed=0, in_dim=D):
    """JAX ToadMIL params with seeded non-zero biases, as numpy."""
    cfg = JaxModelConfig(in_dim=in_dim, n_classes=N_CLS)
    params = jax.tree.map(np.asarray, JaxToadMIL(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for lin in (*params["trunk"].values(), *params["attn"].values(), params["cls_head"], params["site_head"]):
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    return params


def _cfgs(compute_dtype="float32", in_dim=D):
    return (ModelConfig(in_dim=in_dim, n_classes=N_CLS, compute_dtype=compute_dtype),
            JaxModelConfig(in_dim=in_dim, n_classes=N_CLS, compute_dtype=compute_dtype))


def _both(params, compute_dtype="float32", **kw):
    """(port SlideInference on the CPU, JAX SlideInference) over the same weights."""
    cfg, jcfg = _cfgs(compute_dtype)
    return (infer.SlideInference(params_from_jax(params), cfg, bucket_sizes=BUCKETS, device="cpu", **kw),
            jax_infer.SlideInference(params, jcfg, bucket_sizes=BUCKETS, **kw))


def _bag(n, seed=1, dim=D):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(np.float32)


def _assert_agree(got, want, tol):
    np.testing.assert_allclose(got.y_prob, want.y_prob, atol=tol["prob"], rtol=0)
    np.testing.assert_allclose(got.site_prob, want.site_prob, atol=tol["prob"], rtol=0)
    assert (got.y_hat, got.site_hat) == (want.y_hat, want.site_hat)
    assert [i for i, _ in got.topk] == [i for i, _ in want.topk]
    for key in ("attention", "site_attention"):
        a, b = getattr(got, key), np.asarray(getattr(want, key))
        assert a.shape == b.shape
        assert np.abs(a - b).max() <= tol["attn"] * np.abs(b).max(), key


@pytest.fixture(scope="module")
def params():
    return _jax_params(0)


@pytest.mark.parametrize("n", [40, 150, 300], ids=["bucket64", "bucket256", "truncated"])
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_slide_inference_matches_jax(params, compute_dtype, n):
    port, ref = _both(params, compute_dtype)
    feats = _bag(n)
    got, want = port.predict(feats, 1), ref.predict(feats, 1)
    assert got.attention.shape == (min(n, BUCKETS[-1]),)
    assert got.y_prob.dtype == np.float32 and abs(float(got.y_prob.sum()) - 1.0) < 1e-5
    _assert_agree(got, want, TOL[compute_dtype])


@pytest.mark.parametrize("n", [40, 150, 300], ids=["bucket64", "bucket256", "truncated"])
def test_int8_slide_inference_matches_jax(params, n):
    port, ref = _both(params, int8=True)
    feats = _bag(n, seed=2)
    _assert_agree(port.predict(feats, 0), ref.predict(feats, 0), TOL_INT8)
    xq, sx = quantize_rows_np(feats)  # pre-quantized rows: the same integers in both packages
    got, want = port.predict_quantized(xq, sx, 0), ref.predict_quantized(xq, sx, 0)
    _assert_agree(got, want, TOL_INT8)
    np.testing.assert_array_equal(got.attention, port.predict(feats, 0).attention)  # the host quantizer is the same


def test_predict_quantized_needs_int8(params):
    port, _ = _both(params)
    xq, sx = quantize_rows_np(_bag(10))
    with pytest.raises(ValueError, match="int8=True"):
        port.predict_quantized(xq, sx, 0)


def test_bf16_wire_is_bit_equal_to_the_f32_wire(params):
    """A bf16 model's bag crosses as bf16, cast on the host: the same bits as
    an f32 bag cast by the model."""
    port, _ = _both(params, "bfloat16")
    feats = _bag(40, seed=5)
    got = port.predict(feats, 1)
    bag, bag_mask = infer._pad_bag(feats, 64)
    with torch.inference_mode():
        out = port.model(torch.from_numpy(bag)[None], torch.from_numpy(bag_mask)[None],
                         torch.tensor([1], dtype=torch.int32), need_attention=True)
    want = port._finish(out.logits, out.site_logits, out.attention, 40)
    np.testing.assert_array_equal(got.y_prob, want.y_prob)
    np.testing.assert_array_equal(got.attention, want.attention)


def test_prediction_does_not_depend_on_the_bucket(params):
    cfg, jcfg = _cfgs()
    feats = _bag(40, seed=3)
    small = infer.SlideInference(params_from_jax(params), cfg, bucket_sizes=(64,), device="cpu").predict(feats, 0)
    big = infer.SlideInference(params_from_jax(params), cfg, bucket_sizes=(512,), device="cpu").predict(feats, 0)
    np.testing.assert_allclose(small.y_prob, big.y_prob, atol=2e-5)
    np.testing.assert_allclose(small.attention, big.attention, atol=2e-5)
    _assert_agree(big, jax_infer.SlideInference(params, jcfg, bucket_sizes=(512,)).predict(feats, 0), TOL["float32"])


def test_head_truncation_keeps_coords_in_step(params, tmp_path):
    """A bag past the largest bucket is cut to its head; its sidecar coords
    are cut with it, as the JAX package cuts them."""
    port, ref = _both(params)
    feats = _bag(300, seed=4)
    coords = np.arange(600, dtype=np.int64).reshape(300, 2)
    np.save(tmp_path / "s.npy", feats)
    np.save(tmp_path / "s.coords.npy", coords)
    got, got_coords = infer.infer_feature_bag(port, tmp_path / "s.npy", 1)
    want, want_coords = jax_infer.infer_feature_bag(ref, tmp_path / "s.npy", 1)
    assert got.attention.shape == (256,) and got_coords.shape == (256, 2)
    np.testing.assert_array_equal(got_coords, want_coords)
    np.testing.assert_allclose(got.y_prob, port.predict(feats[:256], 1).y_prob, atol=1e-6)
    _assert_agree(got, want, TOL["float32"])


def test_temperature_scales_only_the_class_probabilities(params):
    feats = _bag(40, seed=6)
    cfg, jcfg = _cfgs()
    p1 = infer.SlideInference(params_from_jax(params), cfg, bucket_sizes=(64,), device="cpu").predict(feats, 1)
    port4 = infer.SlideInference(params_from_jax(params), cfg, bucket_sizes=(64,), temperature=4.0, device="cpu")
    p4 = port4.predict(feats, 1)
    np.testing.assert_allclose(p4.y_prob, apply_temperature(p1.y_prob[None], 4.0)[0], atol=1e-6)
    assert p4.y_hat == p1.y_hat and [i for i, _ in p4.topk] == [i for i, _ in p1.topk]
    np.testing.assert_array_equal(p4.site_prob, p1.site_prob)
    np.testing.assert_array_equal(p4.attention, p1.attention)
    assert p4.y_prob.max() < p1.y_prob.max()
    _assert_agree(p4, jax_infer.SlideInference(params, jcfg, bucket_sizes=(64,), temperature=4.0).predict(feats, 1),
                  TOL["float32"])
    for bad in (0.0, -1.0):
        with pytest.raises(ValueError, match="temperature"):
            infer.SlideInference(params_from_jax(params), cfg, temperature=bad, device="cpu")


def test_the_card_is_the_default_device(params):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    cfg, _ = _cfgs()
    with pytest.raises(RuntimeError, match="--device cpu"):
        infer.SlideInference(params_from_jax(params), cfg)


def test_cpu_inference_launches_no_kernel(params):
    """On a CPU tensor the wrappers take their plain versions and count nothing."""
    before = (cuda_pool.LAUNCHES, cuda_pool.SCORED_LAUNCHES, cuda_pool_int8.LAUNCHES, cuda_pool_int8.SCORED_LAUNCHES)
    for kw in ({}, {"int8": True}):
        _both(params, **kw)[0].predict(_bag(40), 0)
    assert (cuda_pool.LAUNCHES, cuda_pool.SCORED_LAUNCHES, cuda_pool_int8.LAUNCHES,
            cuda_pool_int8.SCORED_LAUNCHES) == before


# -- ensembles --------------------------------------------------------------------


def test_single_member_ensemble_equals_its_model(params):
    cfg, _ = _cfgs()
    feats = _bag(150, seed=7)
    single = infer.SlideInference(params_from_jax(params), cfg, bucket_sizes=BUCKETS, device="cpu").predict(feats, 0)
    ens = infer.EnsembleInference([params_from_jax(params)], cfg, bucket_sizes=BUCKETS, device="cpu")
    got = ens.predict(feats, 0)
    assert len(ens.members) == 1 and ens.buckets == BUCKETS and not ens.int8
    np.testing.assert_allclose(got.y_prob, single.y_prob, atol=2e-5)
    np.testing.assert_allclose(got.site_prob, single.site_prob, atol=2e-5)
    assert got.topk[0][0] == single.y_hat
    w = np.exp(single.attention.astype(np.float64) - single.attention.max())
    np.testing.assert_allclose(got.attention, w / w.sum(), atol=2e-5)


@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_ensemble_mean_matches_jax(int8):
    members = [_jax_params(s) for s in (0, 1, 2)]
    cfg, jcfg = _cfgs()
    port = infer.EnsembleInference([params_from_jax(p) for p in members], cfg, bucket_sizes=BUCKETS, int8=int8,
                                   temperature=1.5, device="cpu")
    ref = jax_infer.EnsembleInference(members, jcfg, bucket_sizes=BUCKETS, int8=int8, temperature=1.5)
    feats = _bag(150, seed=8)
    got, want = port.predict(feats, 1), ref.predict(feats, 1)
    tol = TOL_INT8 if int8 else TOL["float32"]
    np.testing.assert_allclose(got.y_prob, want.y_prob, atol=tol["prob"], rtol=0)
    np.testing.assert_allclose(got.site_prob, want.site_prob, atol=tol["prob"], rtol=0)
    assert got.attention.dtype == np.float64 and abs(got.attention.sum() - 1.0) < 1e-9
    # softmaxed weights in [0, 1]: the raw scores' tolerance relative to the largest weight
    for key in ("attention", "site_attention"):
        a, b = getattr(got, key), np.asarray(getattr(want, key))
        assert np.abs(a - b).max() <= tol["attn"] * b.max(), key
    assert got.y_hat == want.y_hat


def _save_ckpt(path: Path, jax_params):
    torch.save(reference_state_dict(params_from_jax(jax_params), dropout=False), path)


def test_from_spec_reads_a_directory_with_a_comma_and_a_list(tmp_path):
    cfg, _ = _cfgs()
    d = tmp_path / "run,with,commas"
    d.mkdir()
    for fold in (0, 1):
        _save_ckpt(d / f"s_{fold}_checkpoint.pt", _jax_params(fold))
    ens = infer.EnsembleInference.from_spec(d, cfg, bucket_sizes=BUCKETS, device="cpu")
    assert len(ens.members) == 2
    plain = tmp_path / "plain"
    plain.mkdir()
    for fold in (0, 1):
        _save_ckpt(plain / f"s_{fold}_checkpoint.pt", _jax_params(fold))
    listed = infer.EnsembleInference.from_spec(f"{plain / 's_1_checkpoint.pt'}, {plain / 's_0_checkpoint.pt'}", cfg,
                                               bucket_sizes=BUCKETS, device="cpu")
    feats = _bag(40)
    np.testing.assert_allclose(listed.predict(feats, 0).y_prob, ens.predict(feats, 0).y_prob, atol=1e-6)
    with pytest.raises(FileNotFoundError, match="no s_<k>_checkpoint"):
        infer.EnsembleInference.from_spec(tmp_path, cfg, device="cpu")


def test_find_fold_checkpoints_order_and_the_pt_rule(tmp_path):
    """Sorted by fold, one member a fold. Where a fold has an Orbax directory
    and a .pt, the port takes the .pt (it cannot read Orbax) and the JAX
    package the directory: the one deliberate difference."""
    for name in ("s_10_checkpoint.pt", "s_2_checkpoint.pt", "s_0_checkpoint.pt", "s_3_checkpoint_old.pt", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    (tmp_path / "s_2_checkpoint").mkdir()  # fold 2 in both forms
    (tmp_path / "s_5_checkpoint").mkdir()  # fold 5 only as a directory
    got = infer.find_fold_checkpoints(tmp_path)
    want = jax_infer.find_fold_checkpoints(tmp_path)
    assert [f for f, _ in got] == [f for f, _ in want] == [0, 2, 5, 10]
    names = {f: p.name for f, p in got}
    assert names == {0: "s_0_checkpoint.pt", 2: "s_2_checkpoint.pt", 5: "s_5_checkpoint", 10: "s_10_checkpoint.pt"}
    assert {f: p.name for f, p in want}[2] == "s_2_checkpoint"
    # a fold with only a directory raises the loader's message, which names the conversion
    cfg, _ = _cfgs()
    with pytest.raises(ValueError, match="python -m toad_tpu export"):
        infer.EnsembleInference.from_checkpoints([got[2][1]], cfg, device="cpu")


# -- bags and patch files -------------------------------------------------------


@pytest.mark.parametrize("fmt", ["npz", "npy_sidecar", "int8_store"])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_infer_feature_bag_matches_jax(params, tmp_path, fmt, int8):
    port, ref = _both(params, int8=int8)
    feats = _bag(120, seed=9)
    coords = np.stack([np.arange(120) % 12, np.arange(120) // 12], axis=1).astype(np.int64) * 256
    if fmt == "npz":
        path = tmp_path / "s.npz"
        write_bag(path, feats, coords)
    elif fmt == "npy_sidecar":
        path = tmp_path / "s.npy"
        np.save(path, feats)
        np.save(tmp_path / "s.coords.npy", coords)
    else:
        path = tmp_path / "s.npz"
        save_int8_bag(path, feats, coords)
    got, got_coords = infer.infer_feature_bag(port, path, 0)
    want, want_coords = jax_infer.infer_feature_bag(ref, path, 0)
    np.testing.assert_array_equal(got_coords, coords)
    np.testing.assert_array_equal(want_coords, coords)
    _assert_agree(got, want, TOL_INT8 if int8 else TOL["float32"])


SMALL_ENC = dict(blocks=(1, 1, 1), stem_width=8, compute_dtype="float32")  # features of 128


def test_infer_patch_file_matches_jax_and_the_bag_path(tmp_path):
    """A patch file through a small ResNet, then the MIL head: against the
    JAX chain, and against the port's own prediction from the bag its
    featurizer writes (tests/test_pipeline.py's 2e-5)."""
    jenc = JaxEncoderConfig(**SMALL_ENC)
    enc_params = jax.tree.map(np.asarray, jax_resnet.ResNetEncoder(jenc).init(jax.random.PRNGKey(0)))
    in_dim = EncoderConfig(**SMALL_ENC).out_dim
    mil = _jax_params(3, in_dim=in_dim)
    rng = np.random.default_rng(10)
    imgs = rng.integers(0, 256, (50, 32, 32, 3), dtype=np.uint8)
    coords = np.stack([np.arange(50) % 8, np.arange(50) // 8], axis=1).astype(np.int64) * 256
    src = tmp_path / "slide.npz"  # the port's patch file where h5py is absent; the JAX package reads .h5 only
    np.savez(src, imgs=imgs, coords=coords)
    import h5py

    with h5py.File(tmp_path / "slide.h5", "w") as f:
        f.create_dataset("imgs", data=imgs)
        f.create_dataset("coords", data=coords)

    cfg, jcfg = _cfgs(in_dim=in_dim)
    port = infer.SlideInference(params_from_jax(mil), cfg, bucket_sizes=BUCKETS, device="cpu")
    embedder = TileEmbedder(encoder_from_state_dict(resnet_params_from_jax(enc_params), EncoderConfig(**SMALL_ENC)),
                            batch_size=16)
    got, got_coords = infer.infer_patch_file(embedder, port, src, 1)
    assert got.attention.shape == (50,)
    np.testing.assert_array_equal(got_coords, coords)

    ref = jax_infer.SlideInference(mil, jcfg, bucket_sizes=BUCKETS)
    jemb = jax_featurize.TileEmbedder(enc_params, jenc, batch_size=16)
    want, want_coords = jax_infer.infer_patch_file(jemb, ref, tmp_path / "slide.h5", 1)
    np.testing.assert_array_equal(want_coords, coords)
    _assert_agree(got, want, dict(prob=1e-5, attn=1e-3))  # f32 features within 1e-4 of their scale

    bag = tmp_path / "slide_feats.npz"
    write_bag(bag, embedder.embed_all(imgs), coords)
    from_bag, bag_coords = infer.infer_feature_bag(port, bag, 1)
    np.testing.assert_allclose(from_bag.y_prob, got.y_prob, atol=2e-5)
    np.testing.assert_array_equal(bag_coords, coords)


def test_top_labels_names_the_ranked_classes(params):
    port, ref = _both(params)
    feats = _bag(40)
    inv = {i: f"class{i}" for i in range(N_CLS - 1)}  # the last index has no name
    got, want = port.predict(feats, 0), ref.predict(feats, 0)
    assert [n for n, _ in got.top_labels(inv, k=N_CLS)] == [n for n, _ in want.top_labels(inv, k=N_CLS)]
    assert [n for n, _ in got.top_labels(None)] == [str(i) for i, _ in got.topk[:3]]


# -- the kernels' plans at one bag ----------------------------------------------------


@pytest.mark.parametrize("rows_per_tile", [cuda_pool.plan(torch.bfloat16, 512, 384).rows,
                                           cuda_pool.plan(torch.float32, 512, 384).rows, cuda_pool_int8.ROWS],
                         ids=["k1_bf16", "k1_f32", "k2"])
def test_whole_wave_plan_at_one_bag_covers_every_rung_in_the_fewest_tile_times(rows_per_tile):
    """Slide inference sends B = 1 at every rung of the bucket ladder: each
    plan must cover the bag's row tiles once, without an empty run, in the
    fewest tile-times one CTA an SM allows."""
    for n_sms in (132, 114):
        for n in DEFAULT_BUCKETS + (3000, 257):
            per, splits = cuda_pool.wave_split_plan(1, n, rows_per_tile, n_sms)
            tiles = -(-n // rows_per_tile)
            assert per * (splits - 1) < tiles <= per * splits, (n, per, splits)
            assert -(-splits // n_sms) * per == -(-tiles // n_sms), (n, per, splits)
