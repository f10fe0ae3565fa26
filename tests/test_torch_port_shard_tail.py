"""The one-launch bag-sharded pool's plan and arithmetic, and shards read in
place, against the JAX package (no card needed).

On a card ``bag_sharded_pool(n_shards=S)`` is one launch of the pooling
kernel (``ops/cuda_pool.pool_sharded``): each shard's row tiles are cut
into runs by ``shard_split_plan``, every run yields shard-local flash
statistics, and the end of the launch merges every run of a bag at once.
Here that arithmetic is rebuilt from the plain versions: each run pooled
with ``plain_pool_partial``, all the runs of a bag merged by
``plain_combine_partial_pool``, against the JAX ``bag_sharded_pool(impl=
"xla")`` on the virtual CPU mesh and against ``plain_pool`` on the whole
bag, with fully masked shards and a fully masked bag. The plan is checked
under hypothesis: every tile in one run, no run across a shard, the fewest
tile-times. Shards sliced out of a B > 1 batch go through
``bag_sharded_pool`` and ``fused_pool_partial`` as views, equal to their
copies and to JAX; ``rows_in_place`` (what the kernel's launcher reads in
place) keeps such a view and copies what the kernel cannot read; the merge's
ticket buffer is made zeroed once and grown, never filled per launch.

Tolerances: f32 1e-5 (summation order only), bf16 2e-2 (XLA and torch
evaluate bf16 elementwise ops with different internal precision), as
``test_torch_port_bag_shard.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import Mesh

from toad_tpu.config import ModelConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.parallel.bag_shard import bag_sharded_pool as jax_bag_sharded_pool
from toad_tpu_torch.ops import _build, cuda_pool
from toad_tpu_torch.ops.fused_pool import fused_pool_partial, plain_pool, plain_pool_partial
from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool, plain_combine_partial_pool

D, B, N = 64, 3, 512
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _tiles(rows: int, per_tile: int) -> int:
    return -(-rows // per_tile)


def _cost(ctas: int, per: int, n_sms: int) -> int:
    """Tile-times of a grid of one-CTA-an-SM blocks of up to ``per`` tiles."""
    return -(-ctas // n_sms) * per


def _runs(n_shards: int, shard_rows: int, rows_per_tile: int, per: int, splits: int) -> list[tuple[int, int, int]]:
    """(shard, first row, end row) of each run of the one-launch grid, as
    ``csrc/pool.cu`` walks it: block x runs tiles split * per .. of shard
    x // splits, bounded by the shard's end."""
    runs = []
    for s in range(n_shards):
        for k in range(splits):
            lo, hi = k * per * rows_per_tile, min((k + 1) * per * rows_per_tile, shard_rows)
            runs.append((s, s * shard_rows + lo, s * shard_rows + hi))
    return runs


@settings(max_examples=150, deadline=None)
@given(b=st.integers(1, 64), s=st.integers(1, 8), rows=st.integers(1, 70_000), n_sms=st.sampled_from([8, 114, 132]),
       per_tile=st.sampled_from([64, 128]))
def test_shard_split_plan_runs_stay_in_their_shard_and_take_the_fewest_tile_times(b, s, rows, n_sms, per_tile):
    per, splits = cuda_pool.shard_split_plan(b, s, rows, per_tile, n_sms)
    t_s = _tiles(rows, per_tile)
    assert per * splits >= t_s > per * (splits - 1)  # every tile of a shard in a run, no empty run
    covered = np.zeros(s * rows, dtype=np.int64)
    for shard, lo, hi in _runs(s, rows, per_tile, per, splits):
        assert shard * rows <= lo < hi <= (shard + 1) * rows  # no run crosses a shard
        covered[lo:hi] += 1
    assert (covered == 1).all()
    cost = _cost(b * s * splits, per, n_sms)
    assert cost == -(-b * s * t_s // n_sms)  # the fair share of all the batch's tiles: the fewest possible
    if rows % per_tile == 0:  # the same as one launch on the unsharded bags
        per_u, splits_u = cuda_pool.wave_split_plan(b, s * rows, per_tile, n_sms)
        assert cost == _cost(b * splits_u, per_u, n_sms)


def test_shard_split_plan_at_163840_rows_in_4_shards():
    """One bag of 163,840 rows (1,280 tiles of 128) in 4 shards on 132 SMs:
    one launch runs 128 CTAs of 10 tiles, 10 tile-times, as K1 on the whole
    bag; one launch a shard (107 CTAs of 3 tiles each) took 4 x 3 = 12."""
    assert cuda_pool.shard_split_plan(1, 4, 40_960, 128, 132) == (10, 32)
    assert cuda_pool.wave_split_plan(1, 163_840, 128, 132) == (10, 128)
    per, splits = cuda_pool.wave_split_plan(1, 40_960, 128, 132)
    assert (per, splits) == (3, 107) and 4 * _cost(splits, per, 132) == 12
    assert _cost(4 * 32, 10, 132) == 10
    per8, splits8 = cuda_pool.shard_split_plan(1, 8, 20_480, 128, 132)  # 8 shards: 10 against 8 x 2 = 16
    assert _cost(8 * splits8, per8, 132) == 10
    per, splits = cuda_pool.wave_split_plan(1, 20_480, 128, 132)
    assert 8 * _cost(splits, per, 132) == 16


@pytest.fixture(scope="module")
def setup():
    p = jax.tree.map(np.asarray, JaxToadMIL(ModelConfig(in_dim=D, n_classes=5)).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    for lin in (*p["trunk"].values(), *p["attn"].values()):  # nonzero biases: the bias paths are compared too
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    x = rng.standard_normal((B, N, D)).astype(np.float32)
    mask = (rng.random((B, N)) < 0.8).astype(np.float32)
    return p, x, mask


def _t(p):
    return jax.tree.map(lambda v: torch.tensor(np.asarray(v)), p)


def _masks(mask):
    """Bag 0 dense; bag 1 without live rows in its first 128 and its last
    128 (the first and last of 4 shards; of 8, the first 2 and last 2);
    bag 2 without a live row."""
    mask = mask.copy()
    mask[1, :128] = mask[1, 384:] = 0.0
    mask[2] = 0.0
    return mask


def _merged_runs(params, x, mask, n_shards, dtype, n_sms, rows_per_tile=16):
    """The one-launch pool's arithmetic in plain versions: every run of
    shard_split_plan's grid pooled alone, then all runs of a bag merged
    (tiles of 16 rows and 16 SMs, so that the small bags make several runs a
    shard)."""
    shard = x.shape[1] // n_shards
    per, splits = cuda_pool.shard_split_plan(x.shape[0], n_shards, shard, rows_per_tile, n_sms)
    parts = [plain_pool_partial(params, x[:, lo:hi], mask[:, lo:hi], dtype)
             for _, lo, hi in _runs(n_shards, shard, rows_per_tile, per, splits)]
    return plain_combine_partial_pool(torch.stack([a for a, _ in parts]), torch.stack([t for _, t in parts])), len(parts)


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merging_every_run_at_once_matches_jax_and_the_whole_bag(setup, n_shards, dtype):
    p, x, mask = setup
    mask = _masks(mask)
    tdt, tol = getattr(torch, dtype), TOL[dtype]
    got, n_runs = _merged_runs(_t(p), torch.from_numpy(x), torch.from_numpy(mask), n_shards, tdt, n_sms=16)
    assert n_runs > n_shards  # several runs a shard: the merge takes all of them in one pass
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("bag",))
    want = jax_bag_sharded_pool(p, jnp.asarray(x), jnp.asarray(mask), mesh, impl="xla", compute_dtype=jnp.dtype(dtype))
    whole, _ = plain_pool(_t(p), torch.from_numpy(x), torch.from_numpy(mask), tdt, with_scores=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=tol, atol=tol)
    assert (got[2] == 0).all() and torch.isfinite(got).all()


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_bag_sharded_pool_on_a_slice_of_a_batch_matches_its_copy(setup, n_shards):
    """A B > 1 batch's rows 128..384 as a view and as its contiguous copy."""
    p, x, mask = setup
    tx, tm = torch.from_numpy(x), torch.from_numpy(_masks(mask))
    xs, ms = tx[:, 128:384], tm[:, 128:384]
    assert not xs.is_contiguous()
    got = bag_sharded_pool(_t(p), xs, ms, n_shards, compute_dtype=torch.float32)
    copy = bag_sharded_pool(_t(p), xs.contiguous(), ms.contiguous(), n_shards, compute_dtype=torch.float32)
    torch.testing.assert_close(got, copy, rtol=1e-6, atol=1e-7)


def test_bag_sharded_pool_on_a_slice_of_a_batch_matches_jax(setup):
    """The same rows pooled by the JAX package on 4 virtual devices."""
    p, x, mask = setup
    mask = _masks(mask)
    got = bag_sharded_pool(_t(p), torch.from_numpy(x)[:, 128:384], torch.from_numpy(mask)[:, 128:384], 4,
                           compute_dtype=torch.float32)
    mesh = Mesh(np.array(jax.devices()[:4]), ("bag",))
    want = jax_bag_sharded_pool(p, jnp.asarray(x[:, 128:384]), jnp.asarray(mask[:, 128:384]), mesh, impl="xla",
                                compute_dtype=jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_fused_pool_partial_on_a_slice_of_a_batch_matches_its_copy(setup):
    p, x, mask = setup
    tx, tm = torch.from_numpy(x), torch.from_numpy(mask)
    xs, ms = tx[:, 256:], tm[:, 256:]
    got = fused_pool_partial(_t(p), xs, ms, compute_dtype=torch.float32)
    copy = fused_pool_partial(_t(p), xs.contiguous(), ms.contiguous(), compute_dtype=torch.float32)
    for a, b in zip(got, copy):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    whole = plain_pool_partial(_t(p), tx, tm, torch.float32)
    assert got[0].shape == whole[0].shape and got[1].shape == whole[1].shape


def test_rows_in_place_keeps_a_shard_view_and_copies_the_rest():
    x = torch.randn(3, 40, 32)
    mask = torch.ones(3, 40)
    shard = x[:, 8:24]
    assert cuda_pool.rows_in_place(shard, torch.float32).data_ptr() == shard.data_ptr()
    assert cuda_pool.bag_stride(shard) == 40 * 32
    m = mask[:, 8:24]
    assert cuda_pool.rows_in_place(m, torch.float32).data_ptr() == m.data_ptr() and cuda_pool.bag_stride(m) == 40
    one = x[:1, 8:24]
    assert cuda_pool.rows_in_place(one, torch.float32) is one and cuda_pool.bag_stride(one) == 0
    t = x.transpose(1, 2)[:, :, :16]  # rows not contiguous: copied
    got = cuda_pool.rows_in_place(t, torch.float32)
    assert got.is_contiguous() and torch.equal(got, t)
    cast = cuda_pool.rows_in_place(shard, torch.bfloat16)  # a cast makes a new tensor of the slice only
    assert cast.dtype == torch.bfloat16 and cast.shape == shard.shape and cast.is_contiguous()
    cols = x[:, :, :16]  # part of each row: not the kernel's rows
    assert cuda_pool.rows_in_place(cols, torch.float32).is_contiguous()


def test_ticket_buffer_is_zeroed_once_reused_and_grown(monkeypatch):
    made = []
    real_zeros = torch.zeros
    monkeypatch.setattr(cuda_pool.torch, "zeros", lambda *a, **k: made.append(a) or real_zeros(*a, **k))
    monkeypatch.setattr(cuda_pool, "_tickets", {})
    cpu = torch.device("cpu")
    first = cuda_pool.tickets(cpu, 7, 3)
    assert first.dtype == torch.int32 and first.numel() >= 3 and not first.any()
    assert cuda_pool.tickets(cpu, 7, 3) is first and len(made) == 1  # reused: no fill a launch
    other = cuda_pool.tickets(cpu, 8, 3)  # another stream has its own counters
    assert other is not first and len(made) == 2
    grown = cuda_pool.tickets(cpu, 7, first.numel() + 1)
    assert grown.numel() > first.numel() and not grown.any() and len(made) == 3
    assert cuda_pool.tickets(cpu, 7, 2) is grown


def test_the_one_launch_pool_refuses_cpu_tensors_without_building(setup):
    p, x, mask = setup
    ops = cuda_pool.pack_params(_t(p), torch.float32)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        cuda_pool.pool_sharded(ops, torch.from_numpy(x), torch.from_numpy(mask), 4)
    assert not _build.is_loaded()
