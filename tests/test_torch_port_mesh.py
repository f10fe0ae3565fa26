"""The ('data', 'bag') mesh of the port (``parallel/mesh.py``,
``parallel/sharding.py``, the mesh path of ``parallel/bag_shard.py`` and
``ToadMIL.forward_sharded``) against the JAX package's mesh on its 8 virtual
CPU devices (``tests/conftest.py``).

The port's mesh repeats the CPU device: ``make_mesh(..., devices=[cpu] *
8)``, the shape the JAX tests give their 8 devices. Weights cross with
``models/interop.py``; inputs are numpy from a seed, at the JAX tests' small
widths (in_dim 32, trunk 512, attention 256, B=8 x 256 rows).

Tolerances: the JAX tests' own (``tests/test_sharding.py``): logits within
rtol 1e-4, atol 1e-5; one SGD step's loss within rtol 1e-5 and its
parameters within rtol 1e-4, atol 1e-5. Mesh against no mesh in the port,
the same inputs and dropout masks: summation order only, so the same
tolerances; the int8 forward's pooled values carry one more rounding
(see its test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.config import OptimConfig as JaxOptimConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.ops.fused_pool import fused_trunk_attention_pool as jax_pool
from toad_tpu.parallel import make_mesh as jax_make_mesh
from toad_tpu.parallel import mesh_shape_for as jax_mesh_shape_for
from toad_tpu.parallel import replicate as jax_replicate
from toad_tpu.parallel import shard_batch as jax_shard_batch
from toad_tpu.train.loop import make_train_step as jax_make_train_step
from toad_tpu.train.optim import make_optimizer as jax_make_optimizer
from toad_tpu_torch.config import ModelConfig, OptimConfig
from toad_tpu_torch.models.interop import params_from_jax
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops import cuda_pool
from toad_tpu_torch.ops.fused_pool import plain_pool
from toad_tpu_torch.parallel import mesh as port_mesh
from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool, combine_partial_pool
from toad_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, mesh_shape_for
from toad_tpu_torch.parallel.sharding import BATCH_AXES, ShardedBatch, replicate, shard_batch
from toad_tpu_torch.train.loop import make_train_step, unpack_metrics
from toad_tpu_torch.train.optim import make_optimizer

CPU = torch.device("cpu")
TOL_LOGITS = dict(rtol=1e-4, atol=1e-5)
TOL_PARAMS = dict(rtol=1e-4, atol=1e-5)
TOL_INT8_LOGITS = dict(rtol=2e-3, atol=2e-3)
SHAPES = [(8, 1), (4, 2), (2, 4), (1, 8)]



@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads a test process: the suite runs in several worker
    processes at once, and two folds train at once here."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

def _cfg(**kw):
    return ModelConfig(in_dim=32, n_classes=5, size_arg="small", **kw)


def _jax(cfg):
    return JaxModelConfig(**dataclasses.asdict(cfg))


def _batch(b=8, n=256, d=32, seed=0):
    """The JAX tests' batch (tests/test_sharding.py::_batch)."""
    rng = np.random.RandomState(seed)
    return {
        "features": rng.randn(b, n, d).astype(np.float32),
        "patch_mask": (rng.rand(b, n) < 0.9).astype(np.float32),
        "bag_mask": np.ones(b, np.float32),
        "label": rng.randint(0, 5, b).astype(np.int32),
        "site": rng.randint(0, 2, b).astype(np.int32),
        "sex": rng.randint(0, 2, b).astype(np.int32),
    }


def _port_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["label"], out["site"] = out["label"].long(), out["site"].long()
    return out


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JaxToadMIL(_jax(_cfg())).init(jax.random.PRNGKey(0)))


def _port_model(cfg, params):
    m = ToadMIL(cfg)
    m.load_state_dict(params_from_jax(params))
    return m


# -- mesh_shape_for, make_mesh, shard_batch --


@pytest.mark.parametrize("n,data,bag", [
    (8, None, None), (8, 4, None), (8, None, 2), (8, 2, 4), (8, 3, None), (8, None, 3), (8, 2, 2), (1, 2, None),
    (1, None, None), (4, 4, 1), (6, None, 4), (2, 1, 2),
])
def test_mesh_shape_for_matches_jax(n, data, bag):
    try:
        want = jax_mesh_shape_for(n, data, bag)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            mesh_shape_for(n, data, bag)
        assert str(got.value) == str(e)
        return
    assert mesh_shape_for(n, data, bag) == want


@pytest.mark.parametrize("shape", SHAPES)
def test_make_mesh_lays_out_the_grid_as_jax_does(shape):
    ours = make_mesh(*shape, devices=[CPU] * 8)
    theirs = jax_make_mesh(*shape)
    assert ours.shape == dict(theirs.shape) and ours.size == theirs.devices.size == 8
    assert len(ours.grid) == shape[0] and all(len(row) == shape[1] for row in ours.grid)
    assert ours.primary == CPU and ours.devices == [CPU]


def test_make_mesh_takes_the_visible_cards_and_refuses_past_them(monkeypatch):
    """With devices=None the mesh is over the visible cards; a shape that
    needs more is refused with mesh_shape_for's text, as the JAX make_mesh
    refuses one past jax.devices()."""
    monkeypatch.setattr(port_mesh, "visible_devices", lambda: [torch.device("cuda", 0)])
    with pytest.raises(ValueError, match=r"^1 devices not divisible by data_shards=2$"):
        make_mesh(data_shards=2)
    with pytest.raises(ValueError, match=r"^data_shards\*bag_shards = 4 != n_devices = 1$"):
        make_mesh(2, 2)
    one = make_mesh()
    assert one.shape == {"data": 1, "bag": 1} and one.primary == torch.device("cuda", 0)
    monkeypatch.setattr(port_mesh, "visible_devices", lambda: [])
    with pytest.raises(RuntimeError, match="no CUDA device is visible"):
        make_mesh(data_shards=2)
    with pytest.raises(ValueError, match="rectangular"):
        DeviceMesh([[CPU, CPU], [CPU]])


@pytest.mark.parametrize("b,n,shape", [(6, 256, (4, 2)), (8, 250, (2, 4)), (8, 256, (8, 1)), (3, 256, (1, 8)),
                                       (8, 100, (1, 8)), (5, 10, (2, 4))])
def test_shard_batch_refuses_what_jax_refuses_with_its_text(b, n, shape):
    batch = _batch(b=b, n=n)
    try:
        jax_shard_batch(batch, jax_make_mesh(*shape))
        jax_err = None
    except ValueError as e:
        jax_err = str(e)
    mesh = make_mesh(*shape, devices=[CPU] * 8)
    if jax_err is None:
        sb = shard_batch(batch, mesh)
        assert isinstance(sb, ShardedBatch) and len(sb.cells) == shape[0]
        return
    with pytest.raises(ValueError) as got:
        shard_batch(batch, mesh)
    assert str(got.value) == jax_err


def test_shard_batch_cuts_each_key_over_its_axes():
    batch = _batch()
    mesh = make_mesh(2, 4, devices=[CPU] * 8)
    sb = shard_batch(batch, mesh)
    assert set(sb) == {"patch_mask", "bag_mask", "label", "site", "sex"}  # whole, on the first device
    np.testing.assert_array_equal(sb["patch_mask"].numpy(), batch["patch_mask"])
    for d in range(2):
        for j in range(4):
            cell = sb.cells[d][j]
            assert set(cell) == set(batch)
            np.testing.assert_array_equal(cell["features"].numpy(), batch["features"][d * 4:(d + 1) * 4, j * 64:(j + 1) * 64])
            np.testing.assert_array_equal(cell["patch_mask"].numpy(), batch["patch_mask"][d * 4:(d + 1) * 4, j * 64:(j + 1) * 64])
            np.testing.assert_array_equal(cell["label"].numpy(), batch["label"][d * 4:(d + 1) * 4])
    assert BATCH_AXES["features"] == ("data", "bag", None) and BATCH_AXES["label"] == ("data",)
    swapped = sb.replace(label=sb["label"] * 0)
    assert swapped.cells is sb.cells and int(swapped["label"].abs().sum()) == 0


def test_replicate_copies_the_weights_once_a_distinct_device(jax_params):
    model = _port_model(_cfg(), jax_params)
    reps = replicate(make_mesh(2, 4, devices=[CPU] * 8), model)
    assert list(reps) == [CPU] and reps[CPU] is model


def test_a_copy_made_in_an_eval_pass_keeps_version_counters(jax_params):
    """A mesh's other devices get their copy of the weights during the first
    eval pass, inside inference mode; the copy must still be made of
    ordinary tensors, whose version counters the operand caches read (an
    inference tensor raises on ``_version``)."""
    from toad_tpu_torch.config import EncoderConfig
    from toad_tpu_torch.models.resnet_encoder import ResNetEncoder
    from toad_tpu_torch.parallel.sharding import copy_to
    from toad_tpu_torch.pipeline.featurize import _encoder_copy

    model = _port_model(_cfg(), jax_params).eval()
    with torch.inference_mode():
        rep = copy_to(model, CPU)
        assert rep is not model and not rep.trunk.fc1.weight.is_inference()
        rep.kernel_operands(torch.float32)
        rep.int8_operands()
        for k, v in rep.state_dict().items():
            assert torch.equal(v, model.state_dict()[k]), k
        enc = _encoder_copy(ResNetEncoder(EncoderConfig(), torch.Generator().manual_seed(0)), CPU)
        assert not next(enc.parameters()).is_inference()
        enc._weights(torch.bfloat16)


# -- the eval forward over a mesh --


@pytest.mark.parametrize("shape", SHAPES)
def test_eval_forward_sharded_matches_the_jax_sharded_forward(shape, jax_params):
    """tests/test_sharding.py::test_forward_sharded_matches_single, both
    packages: the JAX forward under GSPMD on 8 CPU devices, the port's over
    a grid of the CPU device, the same weights and batch."""
    cfg = _cfg()
    batch = _batch()
    jmesh = jax_make_mesh(*shape)
    sb_j = jax_shard_batch(batch, jmesh)
    model_j = JaxToadMIL(_jax(cfg))
    want = jax.jit(lambda p, f, m, s: model_j.apply(p, f, m, s).logits)(
        jax_replicate(jmesh, jax_params), sb_j["features"], sb_j["patch_mask"], sb_j["sex"])
    model = _port_model(cfg, jax_params).eval()
    sb = shard_batch(_port_batch(batch), make_mesh(*shape, devices=[CPU] * 8))
    with torch.inference_mode():
        got = model.forward_sharded(sb, need_attention=False)
        full = model.forward_sharded(sb)  # scored: each cell's scores gathered in order
        plain = model(*(torch.from_numpy(batch[k]) for k in ("features", "patch_mask", "sex")))
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(want), **TOL_LOGITS)
    np.testing.assert_allclose(full.logits.numpy(), np.asarray(want), **TOL_LOGITS)
    np.testing.assert_allclose(full.attention.numpy(), plain.attention.numpy(), **TOL_LOGITS)
    assert got.attention is None and got.logits.device == CPU


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (8, 1)])
def test_int8_forward_sharded_matches_the_unsharded_int8_forward(shape, jax_params):
    """The int8 forward (serve --int8 under a mesh): each cell's int8 pool in
    scored mode, its partial statistics from the scores, the combine; against
    the unsharded forward_int8 on the same rows. The raw scores agree to
    summation order. The pooled values do not: the int8 pool rounds its
    softmax weights to bf16 against its bag's largest score, here each
    shard's, which moves the logits by a few bf16 ulps of e averaged over the
    bag (5.6e-5 here): within K2's own budget against plain_int8_pool on the
    card (chip_smoke.py's TOL_INT8_LOGITS)."""
    from toad_tpu_torch.ops.quantize import quantize_rows

    model = _port_model(_cfg(), jax_params).eval()
    pb = _port_batch(_batch())
    xq, sx = quantize_rows(pb["features"])
    with torch.inference_mode():
        want = model.forward_int8(xq, sx, pb["patch_mask"], pb["sex"])
        sb = shard_batch({**pb, "features": xq, "scales": sx}, make_mesh(*shape, devices=[CPU] * 8))
        got = model.forward_sharded(sb, int8=True)
    np.testing.assert_allclose(got.logits.numpy(), want.logits.numpy(), **TOL_INT8_LOGITS)
    np.testing.assert_allclose(got.attention.numpy(), want.attention.numpy(), **TOL_LOGITS)


# -- one SGD step over a mesh --


def _jax_step(cfg, params, batch, shape):
    model = JaxToadMIL(_jax(cfg))
    tx = jax_make_optimizer(JaxOptimConfig(name="sgd", lr=1e-3))
    mesh = jax_make_mesh(*shape)
    step = jax_make_train_step(model, tx, 0.75, 0.25)
    p, _, m = step(jax_replicate(mesh, jax.tree.map(jnp.copy, params)), jax_replicate(mesh, tx.init(params)),
                   jax.random.PRNGKey(7), jax_shard_batch(batch, mesh))
    return float(m["loss"]), jax.tree.map(np.asarray, p)


def _port_step(cfg, params, batch, mesh=None, seed=7):
    model = _port_model(cfg, params).train()
    step = make_train_step(model, make_optimizer(OptimConfig(name="sgd", lr=1e-3), model.parameters()), 0.75, 0.25)
    pb = _port_batch(batch)
    metrics = unpack_metrics(step(shard_batch(pb, mesh) if mesh is not None else pb,
                                  torch.Generator().manual_seed(seed)))
    return metrics, {k: v.detach().clone() for k, v in model.state_dict().items()}


def test_sgd_step_on_a_2x4_mesh_matches_the_jax_step(jax_params):
    """tests/test_sharding.py::test_train_step_sharded_matches_single: SGD
    (an Adam first step is lr * sign(grad), which a ~1e-9 gradient flips),
    the (2, 4) mesh in both packages, dropout off."""
    cfg = _cfg()
    batch = _batch()
    want_loss, want = _jax_step(cfg, jax_params, batch, (2, 4))
    got, state = _port_step(cfg, jax_params, batch, make_mesh(2, 4, devices=[CPU] * 8))
    np.testing.assert_allclose(got["loss"], want_loss, rtol=1e-5)
    for k, v in params_from_jax(want).items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), **TOL_PARAMS, err_msg=k)
    assert got["n_bags"] == 8.0 and len(got["y_hat"]) == 8


@pytest.mark.parametrize("shape", [(2, 4), (1, 8), (4, 1)])
def test_sgd_step_with_dropout_on_a_mesh_matches_the_unsharded_step(shape, jax_params):
    """Dropout on: the mesh step draws the four masks at the whole batch's
    shapes from the one generator, in the unsharded forward's order, so the
    (d, b) step equals the (1, 1) step under the same seed."""
    cfg = _cfg(dropout=True)
    batch = _batch()
    ref, ref_state = _port_step(cfg, jax_params, batch)
    got, state = _port_step(cfg, jax_params, batch, make_mesh(*shape, devices=[CPU] * shape[0] * shape[1]))
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    for k, v in ref_state.items():
        np.testing.assert_allclose(state[k].numpy(), v.numpy(), **TOL_PARAMS, err_msg=k)
    other, _ = _port_step(cfg, jax_params, batch, make_mesh(*shape, devices=[CPU] * shape[0] * shape[1]), seed=8)
    assert other["loss"] != got["loss"]  # the masks come from the generator


def test_forward_sharded_wants_the_model_on_the_first_device(jax_params):
    model = _port_model(_cfg(), jax_params)
    mesh = DeviceMesh([[torch.device("meta")]])
    sb = ShardedBatch(mesh, [[{}]], {"patch_mask": torch.zeros(1, 1), "sex": torch.zeros(1)})
    with pytest.raises(ValueError, match="first device"):
        model.forward_sharded(sb)


# -- the combine across devices (tests/test_bag_shard.py) --


@pytest.fixture(scope="module")
def pool_setup(jax_params):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 512, 32).astype(np.float32)
    mask = (rng.rand(2, 512) < 0.8).astype(np.float32)
    params = _port_model(_cfg(), jax_params).pool_params()
    params = {g: {k: {n: t.detach() for n, t in lin.items()} for k, lin in grp.items()} for g, grp in params.items()}
    return params_from_jax(jax_params), params, x, mask


def _jax_pool(jax_params, x, mask):
    m, _ = jax_pool(jax_params, jnp.asarray(x), jnp.asarray(mask), impl="xla")
    return np.asarray(m)


def test_fully_masked_shard_is_exact(pool_setup, jax_params):
    """tests/test_bag_shard.py::test_fully_masked_shard_is_exact: the 4th of
    4 shards pure padding contributes nothing."""
    _, params, x, mask = pool_setup
    mask = mask.copy()
    mask[:, 384:] = 0.0
    want = _jax_pool(jax_params, x, mask)
    got = bag_sharded_pool(params, torch.from_numpy(x), torch.from_numpy(mask), mesh=make_mesh(1, 4, devices=[CPU] * 4),
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_combine_is_shard_count_invariant(pool_setup):
    _, params, x, mask = pool_setup
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    p2 = bag_sharded_pool(params, x, mask, mesh=make_mesh(1, 2, devices=[CPU] * 2), compute_dtype=torch.float32)
    p8 = bag_sharded_pool(params, x, mask, mesh=make_mesh(1, 8, devices=[CPU] * 8), compute_dtype=torch.float32)
    np.testing.assert_allclose(p2.numpy(), p8.numpy(), rtol=1e-5, atol=1e-6)
    one = bag_sharded_pool(params, x, mask, 8, compute_dtype=torch.float32)  # the one-device path, in 8 pieces
    np.testing.assert_allclose(p8.numpy(), one.numpy(), rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError, match="exactly one of"):
        bag_sharded_pool(params, x, mask, 2, mesh=make_mesh(1, 2, devices=[CPU] * 2))


def test_combine_takes_per_shard_partials_and_copies_them_to_the_target(pool_setup):
    """Partials given shard by shard (each where its shard ran) are copied to
    the given device and stacked there first; the result is the stacked
    combine's, and the whole bag's pool."""
    from toad_tpu_torch.ops.fused_pool import plain_pool_partial

    _, params, x, mask = pool_setup
    x, mask = torch.from_numpy(x), torch.from_numpy(mask)
    parts = [plain_pool_partial(params, x[:, s:s + 128], mask[:, s:s + 128], torch.float32) for s in range(0, 512, 128)]
    listed = combine_partial_pool([a for a, _ in parts], [t for _, t in parts], CPU)
    stacked = combine_partial_pool(torch.stack([a for a, _ in parts]), torch.stack([t for _, t in parts]))
    np.testing.assert_array_equal(listed.numpy(), stacked.numpy())
    want, _ = plain_pool(params, x, mask, torch.float32, with_scores=False)
    np.testing.assert_allclose(listed.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)
    assert cuda_pool.PARTIAL_LAUNCHES == cuda_pool.COMBINE_LAUNCHES == 0  # the CPU runs the plain versions


# -- the checked step, evaluate_split, serving and featurization over a mesh --


def test_checked_step_on_a_mesh_equals_the_production_step(jax_params):
    """debug_checks under a mesh: the checked step reads each cell's
    features and the whole batch's labels, and steps as the production step."""
    from toad_tpu_torch.utils.debug import CheckError, make_checked_step

    cfg = _cfg()
    batch = _batch()
    mesh = make_mesh(2, 2, devices=[CPU] * 4)
    ref, ref_state = _port_step(cfg, jax_params, batch, mesh)
    model = _port_model(cfg, jax_params).train()
    step = make_checked_step(model, make_optimizer(OptimConfig(name="sgd", lr=1e-3), model.parameters()), 0.75, 0.25)
    got = unpack_metrics(step(shard_batch(_port_batch(batch), mesh), torch.Generator().manual_seed(7)))
    assert got["loss"] == ref["loss"]
    for k, v in model.state_dict().items():
        assert torch.equal(v, ref_state[k]), k
    bad = _port_batch(batch)
    bad["features"][5, 200, 3] = float("nan")  # in cell (1, 1)
    with pytest.raises(CheckError, match="non-finite feature values"):
        step(shard_batch(bad, mesh), None)


def test_evaluate_split_over_a_mesh_matches_one_device(tmp_path, jax_params):
    """evaluate_split(mesh=) places every batch over the mesh; its per-slide
    table equals the one-device pass within the logits' tolerance."""
    from toad_tpu_torch.data import synthetic
    from toad_tpu_torch.data.wsi_dataset import WSIBagDataset
    from toad_tpu_torch.evaluate.engine import evaluate_split

    manifest = synthetic.write_dummy_csv(tmp_path / "m.csv", n_patients=10, max_slides_per_patient=1, seed=3)
    task = synthetic.dummy_task(str(tmp_path / "m.csv"))
    synthetic.write_dummy_bags(tmp_path / "bags", manifest, task, n_patches_range=(20, 250), dim=32, fmt="npy", seed=3)
    split = WSIBagDataset(task, data_dir=str(tmp_path / "bags")).subset(range(10))
    cfg = ModelConfig(in_dim=32, n_classes=18, size_arg="small")
    params = JaxToadMIL(_jax(cfg)).init(jax.random.PRNGKey(1))
    model = _port_model(cfg, jax.tree.map(np.asarray, params))
    kw = dict(batch_size=4, bucket_sizes=(128, 256), native="off")
    one = evaluate_split(model, split, device="cpu", **kw)
    meshed = evaluate_split(model, split, mesh=make_mesh(2, 2, devices=[CPU] * 4), **kw)
    assert list(meshed.df["slide_id"]) == list(one.df["slide_id"])
    np.testing.assert_allclose(meshed.probs(), one.probs(), **TOL_LOGITS)
    with pytest.raises(ValueError, match="cannot combine with mesh"):
        evaluate_split(model, split, device="cpu", mesh=make_mesh(1, 2, devices=[CPU] * 2), **kw)


@pytest.mark.parametrize("shape,int8", [((1, 2), False), ((2, 2), False), ((2, 2), True)])
def test_serve_over_a_mesh_answers_as_one_device(shape, int8, jax_params):
    """serve --bag_shards 2 (and a 2 x 2 mesh, in int8 too): the batcher over
    the mesh answers every request as the one-device batcher does, with and
    without attention; a batch is padded to a multiple of the data axis."""
    from toad_tpu_torch.serve.batcher import DynamicBatcher, ServeConfig

    cfg = ModelConfig(in_dim=32, n_classes=5, size_arg="small")
    sd = _port_model(cfg, jax_params).state_dict()
    serve_cfg = ServeConfig(bucket_sizes=(128, 256), max_wait_ms=50.0, int8=int8)
    rng = np.random.default_rng(5)
    bags = [rng.standard_normal((n, 32)).astype(np.float32) for n in (40, 130, 256, 77, 300)]
    answers = {}
    for name, mesh in (("one", None), ("mesh", make_mesh(*shape, devices=[CPU] * (shape[0] * shape[1])))):
        with DynamicBatcher(sd, cfg, serve_cfg, device="cpu", mesh=mesh) as batcher:
            futs = [batcher.submit(b, i % 2, attention=i % 2 == 0) for i, b in enumerate(bags)]
            answers[name] = [f.result(timeout=60) for f in futs]
            if mesh is not None:
                assert batcher._padded_batch(3) % shape[0] == 0 and batcher._padded_batch(1) == shape[0]
    tol = TOL_INT8_LOGITS if int8 else TOL_LOGITS
    for a, b in zip(answers["mesh"], answers["one"]):
        np.testing.assert_allclose(a.y_prob, b.y_prob, **tol)
        np.testing.assert_allclose(a.site_prob, b.site_prob, **tol)
        assert a.attention.shape == b.attention.shape
        np.testing.assert_allclose(a.attention, b.attention, **TOL_LOGITS)
    with pytest.raises(ValueError, match=r"bucket sizes \[99\] not divisible by bag axis 2"):
        DynamicBatcher(sd, cfg, ServeConfig(bucket_sizes=(99, 256)), device="cpu",
                       mesh=make_mesh(1, 2, devices=[CPU] * 2))


def test_serve_cli_builds_its_mesh_as_the_jax_cli_does(monkeypatch):
    """One flag given: the other axis is inferred; a single cell is no mesh;
    on the CPU the CPU device repeats; on the card a shape past the visible
    cards is refused with mesh_shape_for's text, a ladder against the bag
    axis with the JAX CLI's."""
    from toad_tpu_torch.cli import serve as serve_cli
    from toad_tpu_torch.cli.common import mesh_from_args, resolve_buckets

    assert mesh_from_args(None, 2, CPU).shape == {"data": 1, "bag": 2}
    assert mesh_from_args(4, None, CPU).shape == {"data": 4, "bag": 1}
    assert mesh_from_args(2, 2, CPU).devices == [CPU]
    with pytest.raises(SystemExit, match="--buckets \\[384\\] must be positive multiples of 256"):
        resolve_buckets("256,384", bag_shards=2)
    assert resolve_buckets("512,256", bag_shards=2) == (256, 512)
    assert resolve_buckets("100", bag_shards=1) == (100,)  # no bag axis: the kernel masks ragged tiles
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_mesh, "visible_devices", lambda: [torch.device("cuda", 0)])
    with pytest.raises(SystemExit, match="1 devices not divisible by bag_shards=2"):
        serve_cli.main(["--ckpt", "c.pt", "--bag_shards", "2"])
    with pytest.raises(SystemExit, match="--data_shards must be >= 1, got 0"):
        serve_cli.main(["--ckpt", "c.pt", "--data_shards", "0"])


def test_train_and_featurize_cli_refuse_a_mesh_past_the_visible_cards(monkeypatch, tmp_path):
    from toad_tpu_torch.cli import featurize as featurize_cli
    from toad_tpu_torch.cli import train as train_cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(port_mesh, "visible_devices", lambda: [torch.device("cuda", 0)])
    # train gives both axes (each defaults to 1), so the JAX mesh_shape_for text is the product's
    with pytest.raises(SystemExit, match=r"data_shards\*bag_shards = 2 != n_devices = 1"):
        train_cli.main(["--task", "t", "--exp_code", "e", "--data_shards", "2", "--data_root_dir", str(tmp_path)])
    with pytest.raises(SystemExit, match=r"data_shards\*bag_shards = 4 != n_devices = 1"):
        train_cli.main(["--task", "t", "--exp_code", "e", "--data_shards", "2", "--bag_shards", "2"])
    with pytest.raises(SystemExit, match="--data_shards 2 > available devices 1"):
        featurize_cli.main(["--feat_dir", str(tmp_path / "f"), "--patch_dir", str(tmp_path), "--data_shards", "2"])
    assert not (tmp_path / "f").exists()


def test_tile_embedder_data_mesh_refuses_a_batch_it_cannot_cut():
    from toad_tpu_torch.config import EncoderConfig
    from toad_tpu_torch.models.resnet_encoder import ResNetEncoder
    from toad_tpu_torch.pipeline.featurize import TileEmbedder

    enc = ResNetEncoder(EncoderConfig(compute_dtype="float32", fold_bn=False), torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="batch_size 3 not divisible by mesh axis data=2"):
        TileEmbedder(enc, batch_size=3, devices=[CPU] * 2)
    emb = TileEmbedder(enc, batch_size=4, devices=[CPU] * 2)
    assert emb.devices == [CPU] * 2 and emb._encoders[CPU] is enc
