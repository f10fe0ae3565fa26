"""The pooling kernel's one-launch forms on the card: K1, K1p and the
bag-sharded pool each one launch that ends in its own merge
(``csrc/pool.cu``, ``pool_tail`` in ``csrc/pool_common.cuh``), the merge's
ticket counters left at zero, the same bits from two launches, K1p on a
shard sliced out of a batch read in place with its copy's bits, and a mesh
eval forward at (1, 2) on one card repeated as two K1p launches and one
combine. Every test needs a CUDA GPU and skips elsewhere; this file imports
no JAX, so that it runs on the card's machine as it is. The plain versions
are the CPU path's (``plain_pool``, ``plain_pool_partial``,
``plain_combine_partial_pool``).

Tolerances, relative to the largest |M|: the one-launch sharded pool
against the per-shard launches and the combine kernel, f32 1e-5 (the same
shard-local statistics merged in another grouping, whose runs of tiles
differ: summation order only) and bf16 2e-3 (e is rounded to bf16, 2^-9
relative, against the running max of other runs); against ``plain_pool``
on the card: f32 (3xTF32 products) 2e-3, bf16 2e-2 (as phase 3 of the chip
smoke).
"""

import pytest
import torch

from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops import cuda_pool
from toad_tpu_torch.ops.fused_pool import plain_pool, plain_pool_partial
from toad_tpu_torch.parallel.bag_shard import bag_sharded_pool, plain_combine_partial_pool

DTYPES = [torch.float32, torch.bfloat16]
TOL_PLAIN = {torch.float32: 2e-3, torch.bfloat16: 2e-2}
TOL_REGROUPED = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU mode")
    g = torch.Generator().manual_seed(0)
    model = ToadMIL(ModelConfig(in_dim=1024, n_classes=18), generator=g).cuda().eval()
    x = torch.randn(3, 8192, 1024, generator=g).cuda()
    mask = (torch.rand(3, 8192, generator=g) < 0.85).float().cuda()
    mask[1, 4096:] = 0.0  # bag 1's last two of four shards are padding
    mask[2] = 0.0  # bag 2 has no live row
    return model, x, mask


def _launched(fn):
    """(fn's result, the library's kernel launches during it)."""
    before = cuda_pool.library_launches()
    out = fn()
    torch.cuda.synchronize()
    return out, cuda_pool.library_launches() - before


def _tickets_clear(dev):
    torch.cuda.synchronize()
    buf = cuda_pool.tickets(dev, torch.cuda.current_stream(dev).cuda_stream, 1)
    return int(buf.abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_each_call_is_one_launch_and_leaves_the_tickets_at_zero(card, dtype):
    model, x, mask = card
    with torch.inference_mode():
        ops = model.kernel_operands(dtype)
        calls = {
            "K1": lambda: cuda_pool.pool(ops, x, mask, False),
            "K1 scored": lambda: cuda_pool.pool(ops, x, mask, True),
            "K1p": lambda: cuda_pool.pool_partial(ops, x[:, 2048:6144], mask[:, 2048:6144]),
            "sharded": lambda: cuda_pool.pool_sharded(ops, x, mask, 4),
            "bag_sharded_pool": lambda: bag_sharded_pool(ops, x, mask, 8),
        }
        for name, fn in calls.items():
            fn()  # the first call makes the ticket buffer (its one fill)
            _, n = _launched(fn)
            assert n == 1, f"{name}: {n} launches"
            assert _tickets_clear(x.device), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_two_launches_give_the_same_bits(card, dtype):
    model, x, mask = card
    with torch.inference_mode():
        ops = model.kernel_operands(dtype)
        for fn in (lambda: cuda_pool.pool(ops, x, mask, True), lambda: cuda_pool.pool_partial(ops, x, mask),
                   lambda: (cuda_pool.pool_sharded(ops, x, mask, 4),)):
            first, second = fn(), fn()
            for a, b in zip(first, second):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_shard_read_in_place_has_its_copys_bits(card, dtype):
    model, x, mask = card
    xs, ms = x.to(dtype)[:, 2048:6144], mask[:, 2048:6144]
    assert not xs.is_contiguous()
    assert cuda_pool.rows_in_place(xs, dtype).data_ptr() == xs.data_ptr()  # no copy of the shard
    with torch.inference_mode():
        ops = model.kernel_operands(dtype)
        view = cuda_pool.pool_partial(ops, xs, ms)
        copy = cuda_pool.pool_partial(ops, xs.contiguous(), ms.contiguous())
        assert all(torch.equal(a, b) for a, b in zip(view, copy))
        m_view, s_view = cuda_pool.pool(ops, xs, ms, True)
        m_copy, s_copy = cuda_pool.pool(ops, xs.contiguous(), ms.contiguous(), True)
        assert torch.equal(m_view, m_copy) and torch.equal(s_view, s_copy)
        acc_p, st_p = plain_pool_partial(model.pool_params(), xs, ms, dtype)
    live = ms.sum(1) > 0
    scale = float(acc_p[live].abs().max())
    torch.testing.assert_close(view[0][live] / scale, acc_p[live] / scale, rtol=0, atol=TOL_PLAIN[dtype])
    assert (view[1][~live, 0] <= -1e29).all() and (view[1][~live, 1] == 0).all() and (view[0][~live] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_one_launch_sharded_pool_against_the_shards_and_plain(card, dtype, n_shards):
    model, x, mask = card
    with torch.inference_mode():
        ops = model.kernel_operands(dtype)
        got = cuda_pool.pool_sharded(ops, x, mask, n_shards)
        per = x.shape[1] // n_shards
        parts = [cuda_pool.pool_partial(ops, x[:, s * per:(s + 1) * per], mask[:, s * per:(s + 1) * per])
                 for s in range(n_shards)]
        acc, stats = torch.stack([a for a, _ in parts]), torch.stack([t for _, t in parts])
        two_step = cuda_pool.combine_shards(acc, stats)
        plain, _ = plain_pool(model.pool_params(), x, mask, dtype, False)
    scale = float(two_step.abs().max())
    torch.testing.assert_close(got / scale, two_step / scale, rtol=0, atol=TOL_REGROUPED[dtype])
    torch.testing.assert_close(two_step, plain_combine_partial_pool(acc, stats), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(got, plain, rtol=TOL_PLAIN[dtype], atol=TOL_PLAIN[dtype])
    assert (got[2] == 0).all()


@pytest.mark.cuda
def test_mesh_eval_forward_on_one_card_is_k1p_per_cell_and_one_combine(card):
    from toad_tpu_torch.parallel.mesh import make_mesh
    from toad_tpu_torch.parallel.sharding import shard_batch

    model, x, mask = card
    b_ = x.shape[0]
    batch = {"features": x, "patch_mask": mask, "sex": torch.zeros(b_, dtype=torch.int32, device=x.device),
             "bag_mask": torch.ones(b_, device=x.device), "label": torch.zeros(b_, dtype=torch.long, device=x.device),
             "site": torch.zeros(b_, dtype=torch.long, device=x.device)}
    placed = shard_batch(batch, make_mesh(1, 2, devices=[x.device] * 2))
    with torch.inference_mode():
        want = model(x, mask, batch["sex"], need_attention=False)
        before = cuda_pool.PARTIAL_LAUNCHES, cuda_pool.COMBINE_LAUNCHES
        got, n = _launched(lambda: model.forward_sharded(placed, need_attention=False))
    assert (cuda_pool.PARTIAL_LAUNCHES - before[0], cuda_pool.COMBINE_LAUNCHES - before[1]) == (2, 1) and n == 3
    torch.testing.assert_close(got.y_prob, want.y_prob, rtol=1e-5, atol=1e-5)
