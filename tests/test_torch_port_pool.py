"""Pooling parity of the PyTorch port against the JAX package.

The port's plain pool (the CPU path, and the reference its CUDA kernel is
checked against on the card) is held against JAX's XLA path and against the
Pallas kernel in interpret mode, as tests/test_pallas.py runs it. Inputs are
made with numpy from a seed; weights cross with params_from_jax-style
conversion of the same JAX pytree.

Tolerances: f32 torch-CPU vs XLA-CPU differ only in summation order, ~1e-6
at these widths (observed), so 1e-4. bf16: both round activations to bf16,
but XLA and torch evaluate bf16 elementwise ops (bias add, tanh, sigmoid)
with different internal precision, so single values move by a bf16 ulp:
2e-2 on O(1) scores, 5e-3 on pooled means.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.config import ModelConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.ops import pooling as jax_pooling
from toad_tpu.ops.fused_pool import fused_trunk_attention_pool as jax_pool
from toad_tpu.ops.pallas_pool import pallas_trunk_attention_pool
from toad_tpu_torch.config import ModelConfig as PortModelConfig
from toad_tpu_torch.models.interop import params_from_jax
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.ops import _build, cuda_pool, pooling
from toad_tpu_torch.ops.fused_pool import fused_trunk_attention_pool, plain_pool

D = 128
TOL_F32 = dict(rtol=1e-4, atol=1e-4)
TOL_BF16_M = dict(rtol=5e-3, atol=5e-3)
TOL_BF16_S = dict(rtol=2e-2, atol=2e-2)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def params():
    p = JaxToadMIL(ModelConfig(in_dim=D, n_classes=6)).init(jax.random.PRNGKey(0))
    p = jax.tree.map(np.asarray, p)
    # nonzero biases so that the bias paths are compared too
    rng = np.random.default_rng(7)
    for lin in (*p["trunk"].values(), *p["attn"].values()):
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    return p


def _torch_params(p):
    return jax.tree.map(lambda v: torch.tensor(np.asarray(v)), p)


def _data(b, n, live=0.8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, D)).astype(np.float32)
    mask = (rng.random((b, n)) < live).astype(np.float32)
    return x, mask


def _cases():
    x, mask = _data(2, 1024)  # two f32 tiles of the Pallas kernel
    yield "multi_tile", x, mask
    x, mask = _data(1, 1024, seed=1)
    mask[:, 513:] = 0.0  # a bag at bucket/2+1: the second tile is padding
    yield "padding_tile", x, mask
    x, mask = _data(3, 512, seed=2)
    mask[1] = 0.0  # a fully-masked bag between live ones
    yield "fully_masked_bag", x, mask


CASES = list(_cases())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_pool_matches_xla(params, case, dtype):
    _, x, mask = case
    m_ref, a_ref, s_ref = jax_pool(
        params, jnp.asarray(x), jnp.asarray(mask), compute_dtype=jnp.dtype(dtype), return_scores=True
    )
    m, s = fused_trunk_attention_pool(
        _torch_params(params), torch.from_numpy(x), torch.from_numpy(mask),
        compute_dtype=getattr(torch, dtype), with_scores=True,
    )
    a = pooling.masked_softmax(s, torch.from_numpy(mask)[:, None, :])
    tol_m, tol_s = (TOL_F32, TOL_F32) if dtype == "float32" else (TOL_BF16_M, TOL_BF16_S)
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref, np.float32), **tol_m)
    # the port's raw scores are task-major [B, T, N]; JAX returns [B, N, T]
    np.testing.assert_allclose(s.transpose(1, 2).numpy(), np.asarray(s_ref, np.float32), **tol_s)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref, np.float32), **tol_s)
    dead = mask.sum(1) == 0
    assert np.all(m.numpy()[dead] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scored", [True, False], ids=["scored", "classification"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_plain_pool_matches_pallas_interpret(params, case, scored, dtype):
    """The plain version against the TPU kernel itself (interpret mode),
    in both of the kernel's modes."""
    _, x, mask = case
    out_ref = pallas_trunk_attention_pool(
        params, jnp.asarray(x), jnp.asarray(mask), compute_dtype=jnp.dtype(dtype),
        return_scores=scored, with_attention=scored, interpret=True,
    )
    m, s = plain_pool(
        _torch_params(params), torch.from_numpy(x), torch.from_numpy(mask), getattr(torch, dtype), with_scores=scored
    )
    tol_m, tol_s = (TOL_F32, TOL_F32) if dtype == "float32" else (TOL_BF16_M, TOL_BF16_S)
    np.testing.assert_allclose(m.numpy(), np.asarray(out_ref[0]), **tol_m)
    if scored:
        # the kernel's scores come back [B, N, T]; the port's raw scores [B, T, N]
        np.testing.assert_allclose(s.transpose(1, 2).numpy(), np.asarray(out_ref[2]), **tol_s)
    else:
        assert s is None and out_ref[1] is None


def test_classification_mode_returns_no_scores(params):
    x, mask = _data(2, 256)
    m, s = fused_trunk_attention_pool(_torch_params(params), torch.from_numpy(x), torch.from_numpy(mask))
    m_full, s_full = fused_trunk_attention_pool(_torch_params(params), torch.from_numpy(x), torch.from_numpy(mask),
                                                with_scores=True)
    assert s is None and s_full.shape == (2, 2, 256)
    torch.testing.assert_close(m, m_full, rtol=0, atol=0)


def test_masked_softmax_matches_jax():
    rng = np.random.default_rng(3)
    s = (rng.standard_normal((4, 2, 50)) * 5).astype(np.float32)
    mask = (rng.random((4, 1, 50)) < 0.5).astype(np.float32)
    mask[2] = 0.0
    ref = np.asarray(jax_pooling.masked_softmax(jnp.asarray(s), jnp.asarray(mask)))
    got = pooling.masked_softmax(torch.from_numpy(s), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert np.all(got[2] == 0.0)
    assert pooling.NEG_INF == jax_pooling.NEG_INF


def test_ungated_plain_pool_matches_xla():
    p = jax.tree.map(np.asarray, JaxToadMIL(ModelConfig(in_dim=D, gate=False)).init(jax.random.PRNGKey(1)))
    x, mask = _data(2, 300, seed=4)
    m_ref, a_ref = jax_pool(p, jnp.asarray(x), jnp.asarray(mask))
    m, s = fused_trunk_attention_pool(_torch_params(p), torch.from_numpy(x), torch.from_numpy(mask), with_scores=True)
    a = pooling.masked_softmax(s, torch.from_numpy(mask)[:, None, :])
    np.testing.assert_allclose(m.numpy(), np.asarray(m_ref), **TOL_F32)
    np.testing.assert_allclose(a.numpy(), np.asarray(a_ref), **TOL_F32)


def test_packed_gate_layout_unpermutes(params):
    """The kernel's [Wa|Wb]^T interleave: group g holds u rows g*32.. then the
    v rows of the same j, and every row appears once."""
    tp = _torch_params(params)
    w1t, b1, w2t, b2, wabt, bab, wc, bc = cuda_pool.pack_params(tp, torch.float32)
    a_dim = params["attn"]["a"]["w"].shape[1]
    g = cuda_pool.GATE_GROUP
    assert wabt.shape == (2 * a_dim, params["attn"]["a"]["w"].shape[0])
    for grp in range(a_dim // g):
        rows = wabt[2 * g * grp : 2 * g * (grp + 1)]
        cols = slice(grp * g, (grp + 1) * g)
        np.testing.assert_array_equal(rows[:g].numpy(), params["attn"]["a"]["w"][:, cols].T)
        np.testing.assert_array_equal(rows[g:].numpy(), params["attn"]["b"]["w"][:, cols].T)
        np.testing.assert_array_equal(bab[2 * g * grp : 2 * g * grp + g].numpy(), params["attn"]["a"]["b"][cols])
        np.testing.assert_array_equal(bab[2 * g * grp + g : 2 * g * (grp + 1)].numpy(), params["attn"]["b"]["b"][cols])
    np.testing.assert_array_equal(w1t.numpy(), params["trunk"]["fc1"]["w"].T)
    np.testing.assert_array_equal(wc.numpy(), params["attn"]["c"]["w"])
    assert w1t.is_contiguous() and wabt.is_contiguous() and wc.is_contiguous() and bab.dtype == torch.float32
    bf = cuda_pool.pack_params(tp, torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in bf[0::2]) and all(t.dtype == torch.float32 for t in bf[1::2])


def test_model_packs_kernel_operands_once(params):
    """ToadMIL packs the kernel's weights once per compute dtype, straight
    from its nn.Linear layout, and re-packs after an in-place weight change."""
    model = ToadMIL(PortModelConfig(in_dim=D, n_classes=6))
    model.load_state_dict(params_from_jax(params))
    with torch.no_grad():
        ops = model.kernel_operands(torch.float32)
        assert model.kernel_operands(torch.float32) is ops
        want = cuda_pool.pack_params(_torch_params(params), torch.float32)
        for got, ref in zip(ops, want):
            torch.testing.assert_close(got, ref, rtol=0, atol=0)
        assert model.kernel_operands(torch.bfloat16).w1.dtype == torch.bfloat16
        old = model.kernel_operands(torch.bfloat16)
        model.trunk.fc2.weight.add_(1.0)
        fresh = model.kernel_operands(torch.bfloat16)
        assert fresh is not old
        torch.testing.assert_close(fresh.w2, model.trunk.fc2.weight.bfloat16(), rtol=0, atol=0)
        assert model.kernel_operands(torch.float32) is not ops
    with pytest.raises(RuntimeError, match="forward-only"):
        model.kernel_operands(torch.float32)
    ungated = ToadMIL(PortModelConfig(in_dim=D, gate=False))
    with torch.no_grad(), pytest.raises(NotImplementedError, match="kernel_pools routes un-gated params"):
        ungated.kernel_operands(torch.float32)


@pytest.mark.parametrize("b,n", [(1, 8192), (3, 8192), (32, 8192), (1, 65536), (2, 100)])
def test_split_plan_covers_every_tile(b, n):
    rows, sms = 64, 132
    per, splits = cuda_pool.split_plan(b, n, rows, sms)
    n_tiles = -(-n // rows)
    assert per * splits >= n_tiles > per * (splits - 1)  # every tile once, no empty split
    if n_tiles >= 4:
        assert b * splits >= min(n_tiles * b, 2 * sms)  # a single bag still spreads over the card


def test_kernel_wrapper_refuses_cpu_tensors_without_building(params):
    x, mask = _data(1, 64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        cuda_pool.pool(cuda_pool.pack_params(_torch_params(params), torch.float32), torch.from_numpy(x),
                       torch.from_numpy(mask), True)
    assert not _build.is_loaded()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("scored", [True, False], ids=["scored", "classification"])
@pytest.mark.parametrize("b,n", [(3, 1000), (1, 127), (1, 128), (1, 129)])
def test_kernel_matches_plain_on_card(params, dtype, scored, b, n, cuda_device):
    """Runs only on a CUDA machine: the kernel against its plain version in
    both modes, on a batch with a fully masked bag and on single bags ragged
    at the bf16 instance's 128-row tile; in classification mode also K1p (the
    partial mode) against plain_pool_partial."""
    from toad_tpu_torch.ops.fused_pool import plain_pool_partial

    x, mask = _data(b, n, seed=5)
    if b > 1:
        mask[1] = 0.0
    tp = jax.tree.map(lambda v: v.to(cuda_device), _torch_params(params))
    xt, mt = torch.from_numpy(x).to(cuda_device), torch.from_numpy(mask).to(cuda_device)
    dt = getattr(torch, dtype)
    ops = cuda_pool.pack_params(tp, dt)
    with torch.inference_mode():
        mk, sk = cuda_pool.pool(ops, xt, mt, scored)
        mp, sp = plain_pool(tp, xt, mt, dt, scored)
        acc_k, st_k = cuda_pool.pool_partial(ops, xt, mt)
        acc_p, st_p = plain_pool_partial(tp, xt, mt, dt)
    tol = dict(rtol=2e-3, atol=2e-3) if dtype == "float32" else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(mk, mp, **tol)
    if scored:
        torch.testing.assert_close(sk, sp, **tol)
    else:
        assert sk is None
        live = mt.sum(1) > 0
        torch.testing.assert_close(st_k[live, 0], st_p[live, 0], **tol)  # the max, a score
        torch.testing.assert_close(acc_k[live] / st_k[live, 1, :, None], acc_p[live] / st_p[live, 1, :, None], **tol)
        assert bool((acc_k[~live] == 0).all()) and bool((st_k[~live, 1] == 0).all())
