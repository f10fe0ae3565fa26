"""The pooling kernel's f32 instance on the card (``csrc/pool.cu``,
``pool_kernel_f32``): its three GEMMs are wgmma m64n64k8 in 3xTF32, with
the weights' slices in the 32-byte swizzle, A in registers and each
warpgroup's sums in wgmma's accumulator layout.

Structured weights first: one-hot rows of W1, W2, Wa and Wb on inputs with
few significant bits, so that h1, h2, u and v are columns of x moved about,
exact in 3xTF32. A wrong swizzle, descriptor or accumulator mapping then
shows as a permuted h, M or score (errors of the inputs' own size), not as
a small error. Then seeded weights at both trunk widths: K1 in both modes,
K1p (partial mode) and the one-launch sharded pool against the pool in
float64, each within ``F64_ERR_RATIO`` of the plain f32 version's error
(cuBLAS in f32, TF32 off), as the chip smoke's phase 3 holds K1.

Every test needs a CUDA GPU and skips elsewhere; this file imports no JAX.
"""

import numpy as np
import pytest
import torch

from toad_tpu_torch.ops import cuda_pool
from toad_tpu_torch.ops.fused_pool import plain_pool, plain_pool_partial
from toad_tpu_torch.ops.pooling import masked_softmax

D = 1024
WIDTHS = [(512, 384), (256, 128)]  # (H, A): 3 and 1 gate passes
F64_ERR_RATIO = 2.0
TOL_STRUCTURED = 1e-5  # tanh, sigmoid and the score sums in another order, relative to the largest output


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _params(ws: dict, dev) -> dict:
    """{name: (w [in, out], b [out])} numpy -> the pool's params (JAX layout) on dev."""
    def lin(name):
        w, b = ws[name]
        return {"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)}

    return {"trunk": {k: lin(k) for k in ("fc1", "fc2")}, "attn": {k: lin(k) for k in ("a", "b", "c")}}


def _one_hot(rng, n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] with one 1 a column, in a random row: output j is input perm[j]."""
    w = np.zeros((n_in, n_out), np.float32)
    w[rng.choice(n_in, n_out, replace=n_out > n_in), np.arange(n_out)] = 1.0
    return w


def _seeded(rng, h_dim: int, a_dim: int) -> dict:
    def lin(n_in, n_out):
        return ((rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype(np.float32),
                (0.1 * rng.standard_normal(n_out)).astype(np.float32))

    return {"fc1": lin(D, h_dim), "fc2": lin(h_dim, h_dim), "a": lin(h_dim, a_dim), "b": lin(h_dim, a_dim),
            "c": lin(a_dim, 2)}


def _pool_f64(params: dict, x: torch.Tensor, mask: torch.Tensor):
    """The pool in float64 throughout: (M [B, 2, H], scores [B, 2, N])."""
    p = {k: {n: {m: t.double() for m, t in lin.items()} for n, lin in part.items()} for k, part in params.items()}
    h = torch.relu(x.double() @ p["trunk"]["fc1"]["w"] + p["trunk"]["fc1"]["b"])
    h = torch.relu(h @ p["trunk"]["fc2"]["w"] + p["trunk"]["fc2"]["b"])
    a = p["attn"]
    gated = torch.tanh(h @ a["a"]["w"] + a["a"]["b"]) * torch.sigmoid(h @ a["b"]["w"] + a["b"]["b"])
    scores = (gated @ a["c"]["w"] + a["c"]["b"]).transpose(1, 2)
    return torch.bmm(masked_softmax(scores, mask[:, None, :], dim=-1), h), scores


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.double() - want.double()).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim,a_dim", WIDTHS)
def test_one_hot_weights_move_columns_exactly(dev, h_dim, a_dim):
    rng = np.random.default_rng(26)
    ws = {"fc1": (_one_hot(rng, D, h_dim), np.zeros(h_dim, np.float32)),
          "fc2": (_one_hot(rng, h_dim, h_dim), np.zeros(h_dim, np.float32)),
          "a": (_one_hot(rng, h_dim, a_dim), (rng.integers(-32, 32, a_dim) / 64).astype(np.float32)),
          "b": (_one_hot(rng, h_dim, a_dim), (rng.integers(-32, 32, a_dim) / 64).astype(np.float32)),
          "c": (rng.standard_normal((a_dim, 2)).astype(np.float32), np.array([0.25, -0.5], np.float32))}
    params = _params(ws, dev)
    ops = cuda_pool.pack_params(params, torch.float32)
    b_, n = 2, 300  # a last tile of 44 rows
    # positive multiples of 1/64 below 2: 7 significant bits, so big + small is x and ReLU keeps every value
    x = torch.from_numpy(rng.integers(1, 128, (b_, n, D)).astype(np.float32) / 64).to(dev)
    mask = torch.from_numpy((rng.random((b_, n)) < 0.9).astype(np.float32)).to(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        mk, sk = cuda_pool.pool(ops, x, mask, True)
        mp, sp = plain_pool(params, x, mask, torch.float32, True)
    torch.cuda.synchronize()
    # h2 = x[:, perm]: M's columns are columns of x, each score a function of two of them
    assert _err(sk, sp) <= TOL_STRUCTURED * sp.abs().max().item(), "scores: the gate pass's columns moved"
    assert _err(mk, mp) <= TOL_STRUCTURED * mp.abs().max().item(), "M: the trunk's columns moved"


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim,a_dim", WIDTHS)
def test_seeded_calls_are_as_accurate_as_plain_f32(dev, h_dim, a_dim):
    rng = np.random.default_rng(h_dim)
    params = _params(_seeded(rng, h_dim, a_dim), dev)
    ops = cuda_pool.pack_params(params, torch.float32)
    b_, n, shards = 3, 4096, 4
    x = torch.from_numpy(rng.standard_normal((b_, n, D)).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b_, n)) < 0.9).astype(np.float32)).to(dev)
    mask[1, 1000:] = 0.0  # a ragged bag: its last shards are padding
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.inference_mode():
        m64, s64 = _pool_f64(params, x, mask)
        got, plain = {}, {}
        for scored in (True, False):
            mk, sk = cuda_pool.pool(ops, x, mask, scored)
            mp, sp = plain_pool(params, x, mask, torch.float32, scored)
            got[f"K1 {scored} M"], plain[f"K1 {scored} M"] = _err(mk, m64), _err(mp, m64)
            if scored:
                got["K1 scores"], plain["K1 scores"] = _err(sk, s64), _err(sp, s64)
        half = slice(n // 2, n)  # K1p on a shard read in place
        (acc, st), (pacc, pst) = (f(x[:, half], mask[:, half]) for f in (
            lambda x_, m_: cuda_pool.pool_partial(ops, x_, m_),
            lambda x_, m_: plain_pool_partial(params, x_, m_, torch.float32)))
        m64h, _ = _pool_f64(params, x[:, half], mask[:, half])
        live = mask[:, half].sum(1) > 0
        got["K1p M"] = _err((acc / st[:, 1, :, None])[live], m64h[live])
        plain["K1p M"] = _err((pacc / pst[:, 1, :, None])[live], m64h[live])
        got["sharded M"], plain["sharded M"] = _err(cuda_pool.pool_sharded(ops, x, mask, shards), m64), plain["K1 True M"]
    torch.cuda.synchronize()
    for key, e in got.items():
        assert e <= F64_ERR_RATIO * plain[key], f"{key}: {e:.3e} against float64, the plain f32 version's {plain[key]:.3e}"
