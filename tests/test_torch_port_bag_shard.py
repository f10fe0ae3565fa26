"""The port's partial pool and bag-sharded pooling against the JAX package.

``plain_pool_partial`` (the CPU path, and what the CUDA kernel's partial
mode is held against on the card) against ``xla_pool_partial`` and against
``pallas_pool_partial(interpret=True)`` on the first 2 task columns (the
TPU layout pads the task axis to 8 with filler that must not be read);
``bag_sharded_pool`` on the CPU against the JAX ``bag_sharded_pool(impl=
"xla")`` on the virtual 8-device CPU mesh and against the whole-bag pool,
with partly and fully masked shards.

Tolerances: f32 1e-5 (summation order only; the unnormalised acc relative to
its own scale); bf16 2e-2 (XLA and torch evaluate bf16 elementwise ops with
different internal precision, so single values move by a bf16 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from toad_tpu.config import ModelConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.ops.fused_pool import fused_trunk_attention_pool as jax_pool
from toad_tpu.ops.pallas_pool import pallas_pool_partial, xla_pool_partial
from toad_tpu.parallel.bag_shard import bag_sharded_pool as jax_bag_sharded_pool
from toad_tpu_torch.ops import _build, cuda_pool
from toad_tpu_torch.config import ModelConfig as PortModelConfig
from toad_tpu_torch.models.interop import params_from_jax
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops.fused_pool import fused_pool_partial, kernel_pools, plain_pool, plain_pool_partial
from toad_tpu_torch.ops.pooling import NEG_INF
from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool, combine_partial_pool, plain_combine_partial_pool
from toad_tpu_torch.parallel.mesh import make_mesh

D, B, N = 64, 2, 512


@pytest.fixture(scope="module")
def setup():
    p = jax.tree.map(np.asarray, JaxToadMIL(ModelConfig(in_dim=D, n_classes=5)).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    for lin in (*p["trunk"].values(), *p["attn"].values()):  # nonzero biases: the bias paths are compared too
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    mask = (rng.random((B, N)) < 0.8).astype(np.float32)
    return p, x, mask


def _t(p):
    return jax.tree.map(lambda v: torch.tensor(np.asarray(v)), p)


def _masks(mask):
    partly = mask.copy()
    partly[:, 384:] = 0.0  # the last of 4 shards (the last 2 of 8) is pure padding
    partly[1, :128] = 0.0  # and bag 1's first shard
    dead = mask.copy()
    dead[0] = 0.0  # one bag without a live row
    return {"dense": mask, "masked_shards": partly, "masked_bag": dead}


@pytest.mark.parametrize("case", ["dense", "masked_shards", "masked_bag"])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_pool_partial_matches_xla_partial(setup, case, dtype, tol):
    p, x, mask = setup
    mask = _masks(mask)[case][:, :256]
    x = x[:, :256]
    acc, stats = plain_pool_partial(_t(p), torch.from_numpy(x), torch.from_numpy(mask), getattr(torch, dtype))
    acc_j, stats_j = xla_pool_partial(p, jnp.asarray(x), jnp.asarray(mask), compute_dtype=jnp.dtype(dtype))
    assert acc.shape == (B, 2, 512) and stats.shape == (B, 2, 2) and acc.dtype == stats.dtype == torch.float32
    np.testing.assert_allclose(stats[:, 0].numpy(), np.asarray(stats_j)[:, 0, :2], atol=tol, rtol=tol)
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(stats_j)[:, 1, :2], rtol=max(tol, 1e-5))
    scale = float(np.abs(np.asarray(acc_j)[:, :2]).max()) or 1.0
    np.testing.assert_allclose(acc.numpy() / scale, np.asarray(acc_j)[:, :2] / scale, atol=tol)
    dead = mask.sum(1) == 0
    if dead.any():  # exactly what the combine tests against
        assert (stats[dead, 0] == NEG_INF).all() and (stats[dead, 1] == 0).all() and (acc[dead] == 0).all()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_plain_pool_partial_matches_pallas_partial_in_interpret_mode(setup, dtype, tol):
    p, x, mask = setup
    x, mask = x[:, :256], mask[:, :256]
    acc, stats = plain_pool_partial(_t(p), torch.from_numpy(x), torch.from_numpy(mask), getattr(torch, dtype))
    acc_k, stats_k = pallas_pool_partial(p, jnp.asarray(x), jnp.asarray(mask), compute_dtype=jnp.dtype(dtype), interpret=True)
    np.testing.assert_allclose(stats[:, 0].numpy(), np.asarray(stats_k)[:, 0, :2], atol=tol, rtol=tol)
    np.testing.assert_allclose(stats[:, 1].numpy(), np.asarray(stats_k)[:, 1, :2], rtol=max(tol, 1e-4))
    scale = float(np.abs(np.asarray(acc_k)[:, :2]).max())
    np.testing.assert_allclose(acc.numpy() / scale, np.asarray(acc_k)[:, :2] / scale, atol=max(tol, 1e-5))


@pytest.mark.parametrize("case", ["dense", "masked_shards", "masked_bag"])
@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_bag_sharded_pool_matches_jax_mesh_and_whole_bag(setup, case, n_shards):
    p, x, mask = setup
    mask = _masks(mask)[case]
    got = bag_sharded_pool(_t(p), torch.from_numpy(x), torch.from_numpy(mask), n_shards, compute_dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("bag",))
    want = jax_bag_sharded_pool(p, jnp.asarray(x), jnp.asarray(mask), mesh, impl="xla", compute_dtype=jnp.float32)
    whole, _ = plain_pool(_t(p), torch.from_numpy(x), torch.from_numpy(mask), torch.float32, with_scores=False)
    whole_j, _ = jax_pool(p, jnp.asarray(x), jnp.asarray(mask), impl="xla")
    assert got.shape == (B, 2, 512) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(whole_j), rtol=1e-5, atol=1e-5)
    dead = mask.sum(1) == 0
    assert (got[dead] == 0).all()


def test_bag_sharded_pool_bf16_matches_jax(setup):
    p, x, mask = setup
    got = bag_sharded_pool(_t(p), torch.from_numpy(x), torch.from_numpy(mask), 4)  # bf16 is the default, as in JAX
    mesh = Mesh(np.array(jax.devices()[:4]), ("bag",))
    want = jax_bag_sharded_pool(p, jnp.asarray(x), jnp.asarray(mask), mesh, impl="xla")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-2, atol=2e-2)


def test_combine_is_the_jax_arithmetic():
    """Hand-made partials, masked shards among them: the 1e-12 floor and the
    zero scale of a masked shard, against a direct evaluation."""
    rng = np.random.default_rng(0)
    s, b, h = 5, 3, 32
    acc = torch.from_numpy(rng.standard_normal((s, b, 2, h)).astype(np.float32))
    mx = torch.from_numpy(rng.standard_normal((s, b, 2)).astype(np.float32) * 3)
    den = torch.from_numpy(rng.random((s, b, 2)).astype(np.float32) + 1)
    mx[1], den[1], acc[1] = NEG_INF, 0.0, 0.0  # a masked shard
    mx[:, 2], den[:, 2], acc[:, 2] = NEG_INF, 0.0, 0.0  # a bag masked in every shard
    stats = torch.stack([mx, den], dim=2)
    got = combine_partial_pool(acc, stats)
    assert got is not None and torch.equal(got, plain_combine_partial_pool(acc, stats))
    live = [i for i in range(s) if i != 1]
    gmax = mx[live].amax(0)
    w = torch.exp(mx[live] - gmax)
    want = (acc[live] * w[..., None]).sum(0) / (den[live] * w).sum(0)[..., None]
    np.testing.assert_allclose(got[:2].numpy(), want[:2].numpy(), rtol=1e-5, atol=1e-6)
    assert (got[2] == 0).all() and torch.isfinite(got).all()


def test_shapes_that_do_not_divide_and_other_refusals(setup):
    p, x, mask = setup
    tp, tx, tm = _t(p), torch.from_numpy(x), torch.from_numpy(mask)
    with pytest.raises(ValueError, match="must divide"):
        bag_sharded_pool(tp, tx, tm, 3)
    with pytest.raises(ValueError, match="must divide"):
        bag_sharded_pool(tp, tx, tm, 0)
    # CPU tensors never reach the kernel's wrappers, and those refuse them
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_pool.pool_partial(cuda_pool.pack_params(tp, torch.float32), tx, tm)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_pool.combine_shards(torch.zeros(2, 1, 2, 32), torch.zeros(2, 1, 2, 2))
    with pytest.raises(ValueError, match="packed kernel operands need CUDA"):
        bag_sharded_pool(cuda_pool.pack_params(tp, torch.float32), tx, tm, 2)
    assert not _build.is_loaded()  # nothing above built or launched a kernel
    # one shard is the whole bag; out= is filled in place
    one = bag_sharded_pool(tp, tx, tm, 1, compute_dtype=torch.float32)
    np.testing.assert_allclose(one.numpy(), plain_pool(tp, tx, tm, torch.float32, False)[0].numpy(), rtol=1e-5, atol=1e-6)
    out = (torch.empty(B, 2, 512), torch.empty(B, 2, 2))
    acc, stats = fused_pool_partial(tp, tx, tm, out=out)
    assert acc is out[0] and stats is out[1]
    torch.testing.assert_close(acc, plain_pool_partial(tp, tx, tm, torch.float32)[0])


def test_ungated_params_pool_on_the_cpu_and_are_refused_by_the_kernel_packing(setup):
    p, x, mask = setup
    ungated = {"trunk": p["trunk"], "attn": {k: v for k, v in p["attn"].items() if k != "b"}}
    got = bag_sharded_pool(_t(ungated), torch.from_numpy(x), torch.from_numpy(mask), 4, compute_dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("bag",))
    want = jax_bag_sharded_pool(ungated, jnp.asarray(x), jnp.asarray(mask), mesh, compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="un-gated"):  # kernel_pools keeps every caller from it
        cuda_pool.pack_params(_t(ungated), torch.bfloat16)


def _ungated(p):
    return {"trunk": p["trunk"], "attn": {k: v for k, v in p["attn"].items() if k != "b"}}


def _port_model(p, gate):
    model = ToadMIL(PortModelConfig(in_dim=D, n_classes=5, gate=gate))
    full = jax.tree.map(np.asarray, JaxToadMIL(ModelConfig(in_dim=D, n_classes=5, gate=gate)).init(jax.random.PRNGKey(1)))
    full["trunk"], full["attn"] = p["trunk"], p["attn"]
    model.load_state_dict(params_from_jax(full))
    return model.eval(), full


def test_kernel_route_sends_ungated_params_to_the_plain_version(setup, monkeypatch):
    """The one routing predicate: gated params reach the kernel's packing
    where a pool runs on the card, un-gated ones never do (the plain version
    pools them there, as the JAX package's XLA path); on the CPU neither
    packs. The packing itself runs on CPU weights, so this needs no card."""
    p, _, _ = setup
    assert kernel_pools(_t(p)) and not kernel_pools(_t(_ungated(p)))
    packed = []
    real_pack = cuda_pool.pack_linears
    monkeypatch.setattr(cuda_pool, "pack_linears", lambda lins, dt: packed.append(dt) or real_pack(lins, dt))
    cuda = torch.device("cuda")
    gated, _ = _port_model(p, gate=True)
    with torch.no_grad():
        ops = gated._operands_on(cuda, torch.bfloat16)
        assert isinstance(ops, cuda_pool.PoolOperands) and packed == [torch.bfloat16]
        assert gated._operands_on(torch.device("cpu"), torch.bfloat16) is None and len(packed) == 1
        ungated, _ = _port_model(_ungated(p), gate=False)
        assert ungated._operands_on(cuda, torch.float32) is None and len(packed) == 1
    assert not _build.is_loaded()


@pytest.fixture(scope="module")
def ungated_jax(setup):
    """The JAX package's un-gated bag_sharded_pool (4 virtual devices) and
    ToadMIL(gate=False) forward on the setup's bags, and the port's model."""
    p, x, mask = setup
    pooled = jax_bag_sharded_pool(_ungated(p), jnp.asarray(x), jnp.asarray(mask),
                                  Mesh(np.array(jax.devices()[:4]), ("bag",)), compute_dtype=jnp.float32)
    model, full = _port_model(_ungated(p), gate=False)
    out = JaxToadMIL(ModelConfig(in_dim=D, n_classes=5, gate=False)).apply(
        full, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(np.array([0, 1])))
    return np.asarray(pooled), out, model


@pytest.mark.parametrize("form", ["n_shards", "mesh"])
def test_ungated_model_and_bag_sharded_pool_match_jax(setup, ungated_jax, form):
    """An un-gated model pools through the routing's plain path: the eval
    forward (one piece, and on a (1, 4) mesh through the partial pool and the
    combine) against the JAX ToadMIL(gate=False), and bag_sharded_pool in 4
    shards (on one device, or a mesh of the CPU repeated) against the JAX
    bag_sharded_pool on 4 virtual devices; f32, the gated tests' 1e-5."""
    p, x, mask = setup
    want, ref, model = ungated_jax
    tx, tm, sex = torch.from_numpy(x), torch.from_numpy(mask), torch.tensor([0, 1])
    mesh = make_mesh(1, 4, devices=[torch.device("cpu")] * 4)
    got = bag_sharded_pool(_t(_ungated(p)), tx, tm, **({"n_shards": 4} if form == "n_shards" else {"mesh": mesh}),
                           compute_dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with torch.no_grad():
        if form == "n_shards":
            out = model(tx, tm, sex)
        else:
            from toad_tpu_torch.parallel.sharding import shard_batch

            batch = {"features": tx, "patch_mask": tm, "sex": sex, "bag_mask": torch.ones(B),
                     "label": torch.zeros(B, dtype=torch.long), "site": torch.zeros(B, dtype=torch.long)}
            out = model.forward_sharded(shard_batch(batch, mesh))
    np.testing.assert_allclose(out.logits.numpy(), np.asarray(ref.logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.features.numpy(), np.asarray(ref.features), rtol=1e-5, atol=1e-5)
    assert not _build.is_loaded()


@pytest.mark.cuda
def test_partial_kernel_and_combine_on_the_card(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU mode")
    g = torch.Generator().manual_seed(0)
    from toad_tpu_torch.config import ModelConfig as PortModelConfig
    from toad_tpu_torch.models.toad_mil import ToadMIL

    model = ToadMIL(PortModelConfig(in_dim=1024, n_classes=18), generator=g).cuda()
    x = torch.randn(2, 4096, 1024, generator=g).cuda()
    mask = (torch.rand(2, 4096, generator=g) < 0.8).float().cuda()
    mask[1, 2048:] = 0
    with torch.inference_mode():
        ops = model.kernel_operands(torch.float32)
        before = cuda_pool.PARTIAL_LAUNCHES, cuda_pool.COMBINE_LAUNCHES, cuda_pool.SHARDED_LAUNCHES
        got = bag_sharded_pool(ops, x, mask, 4)  # one launch: the shards' merge ends it, no combine of its own
        assert (cuda_pool.PARTIAL_LAUNCHES - before[0], cuda_pool.COMBINE_LAUNCHES - before[1],
                cuda_pool.SHARDED_LAUNCHES - before[2]) == (0, 0, 1)
        want, _ = plain_pool(model.pool_params(), x, mask, torch.float32, False)
        acc, stats = cuda_pool.pool_partial(ops, x[:, 2048:3072], mask[:, 2048:3072])
    torch.testing.assert_close(got, want, rtol=2e-3, atol=2e-3)
    assert stats[1, 0].eq(NEG_INF).all() and stats[1, 1].eq(0).all() and acc[1].eq(0).all()
