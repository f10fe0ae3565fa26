"""The pooling kernel's bf16 instance on the card (``csrc/pool.cu``,
``pool_kernel_bf16``): its three GEMMs are wgmma m64n256k16 with both
operands in shared memory in the 64-byte swizzle (B the weights' slices, A
the x slice or h1 and h2 as 32-deep panels), and each warpgroup's sums in
wgmma's accumulator layout: a row pair over all 256 columns of a pass a
thread.

Structured weights first: one-hot rows of W1, W2, Wa and Wb on inputs exact
in bf16 (multiples of 1/64 below 2, each column of x with its own offset),
so that h1, h2, u and v are columns of x moved about, exact in bf16, and M's
columns tell the columns of h2 apart. They are held against the pool in
float64 at the kernel's rounding points (h1, h2 and gated rounded to bf16).
A wrong swizzle, descriptor, A fragment or accumulator mapping then shows as
a permuted h, M or score (errors of the inputs' own size), not as a small
error. Then seeded weights at both trunk widths: K1 in both modes, K1p
(partial mode) on a shard read in place and the one-launch sharded pool
against the plain bf16 version within the chip smoke's bf16 tolerances, and
against the pool in float64, each within ``F64_ERR_RATIO`` of the plain bf16
version's own error.

Every test needs a CUDA GPU and skips elsewhere; this file imports no JAX.
"""

import numpy as np
import pytest
import torch

from toad_tpu_torch.ops import cuda_pool
from toad_tpu_torch.ops.fused_pool import plain_pool, plain_pool_partial
from toad_tpu_torch.ops.pooling import masked_softmax

D = 1024
WIDTHS = [(512, 384), (256, 128)]  # (H, A): 3 gate passes and 1
F64_ERR_RATIO = 2.0
# chip_smoke.py's bf16 tolerances, kernel against the plain bf16 version
TOL_BF16_M = dict(atol=1e-2, rtol=1e-2)
TOL_BF16_S = dict(atol=4e-2, rtol=4e-2)
# Structured weights against float64 at the kernel's rounding points,
# relative to the largest output: the scores differ where tanhf or expf in f32
# tips one bf16 rounding of gated (one ulp of a term, ~3e-3 of a score of ~8)
# and by the order of their f32 sums; M by the kernel's e rounded to bf16
# against its running max (at most 2^-9 of the largest h2, ~1.2e-3 of M).
TOL_STRUCTURED_S = 1e-3
TOL_STRUCTURED_M = 4e-3


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


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).double()


def _pool_at_kernel_points(params: dict, x: torch.Tensor, mask: torch.Tensor):
    """The pool in float64 with the bf16 kernel's operands and rounding
    points: weights and x in bf16, f32 biases, h1, h2 and gated = tanh(u)
    sigmoid(v) rounded to bf16, the scores, softmax and M unrounded: (M [B,
    2, H], scores [B, 2, N])."""
    trunk, attn = params["trunk"], params["attn"]

    def lin(p, v):
        return v @ _bf16(p["w"]) + p["b"].double()

    h = _bf16(torch.relu(lin(trunk["fc1"], _bf16(x))))
    h = _bf16(torch.relu(lin(trunk["fc2"], h)))
    gated = _bf16(torch.tanh(lin(attn["a"], h)) * torch.sigmoid(lin(attn["b"], h)))
    scores = lin(attn["c"], gated).transpose(1, 2)
    return torch.bmm(masked_softmax(scores, mask[:, None, :], dim=-1), h), scores


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


def _assert_close(what: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> None:
    excess = (got.double() - want.double()).abs() - tol["atol"] - tol["rtol"] * want.double().abs()
    assert excess.max().item() <= 0, f"{what}: max abs err {_err(got, want):.3e} over {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim,a_dim", WIDTHS)
def test_one_hot_weights_move_columns_exactly(dev, h_dim, a_dim):
    rng = np.random.default_rng(27)
    ws = {"fc1": (_one_hot(rng, D, h_dim), np.zeros(h_dim, np.float32)),
          "fc2": (_one_hot(rng, h_dim, h_dim), np.zeros(h_dim, np.float32)),
          "a": (_one_hot(rng, h_dim, a_dim), (rng.integers(-32, 32, a_dim) / 64).astype(np.float32)),
          "b": (_one_hot(rng, h_dim, a_dim), (rng.integers(-32, 32, a_dim) / 64).astype(np.float32)),
          "c": ((0.25 * rng.standard_normal((a_dim, 2))).astype(np.float32), np.array([0.25, -0.5], np.float32))}
    params = _params(ws, dev)
    ops = cuda_pool.pack_params(params, torch.bfloat16)
    b_, n = 2, 300  # a last tile of 44 rows
    # multiples of 1/64 in [1/64, 2): 7 significant bits, exact in bf16, and ReLU keeps every value; each
    # column's own offset gives M's columns means 0.26-1.74 apart, so a moved column shows
    offset = rng.integers(1, 96, D)
    x = torch.from_numpy(((offset + rng.integers(0, 32, (b_, n, D))) / 64).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b_, n)) < 0.9).astype(np.float32)).to(dev)
    with torch.inference_mode():
        mk, sk = cuda_pool.pool(ops, x, mask, True)
        m_ref, s_ref = _pool_at_kernel_points(params, x, mask)
    torch.cuda.synchronize()
    # h2 = x[:, perm]: M's columns are columns of x, each score a function of two of them and of Wc
    assert _err(sk, s_ref) <= TOL_STRUCTURED_S * s_ref.abs().max().item(), "scores: the gate pass's rows or columns moved"
    assert _err(mk, m_ref) <= TOL_STRUCTURED_M * m_ref.abs().max().item(), "M: the trunk's columns moved"


@pytest.mark.cuda
@pytest.mark.parametrize("h_dim,a_dim", WIDTHS)
def test_seeded_calls_are_as_accurate_as_plain_bf16(dev, h_dim, a_dim):
    rng = np.random.default_rng(h_dim + 27)
    params = _params(_seeded(rng, h_dim, a_dim), dev)
    ops = cuda_pool.pack_params(params, torch.bfloat16)
    b_, n, shards = 3, 4096, 4
    x = torch.from_numpy(rng.standard_normal((b_, n, D)).astype(np.float32)).to(dev)
    mask = torch.from_numpy((rng.random((b_, n)) < 0.9).astype(np.float32)).to(dev)
    mask[1, 1000:] = 0.0  # a ragged bag: its last shards are padding
    xb = x.to(torch.bfloat16)
    with torch.inference_mode():
        m64, s64 = _pool_f64(params, x, mask)
        got, plain = {}, {}
        for scored in (True, False):
            mk, sk = cuda_pool.pool(ops, xb, mask, scored)
            mp, sp = plain_pool(params, xb, mask, torch.bfloat16, scored)
            _assert_close(f"K1 scored={scored} M", mk, mp, TOL_BF16_M)
            got[f"K1 {scored} M"], plain[f"K1 {scored} M"] = _err(mk, m64), _err(mp, m64)
            if scored:
                _assert_close("K1 scores", sk, sp, TOL_BF16_S)
                got["K1 scores"], plain["K1 scores"] = _err(sk, s64), _err(sp, s64)
        half = slice(n // 2, n)  # K1p on a shard read in place
        (acc, st), (pacc, pst) = (f(xb[:, half], mask[:, half]) for f in (
            lambda x_, m_: cuda_pool.pool_partial(ops, x_, m_),
            lambda x_, m_: plain_pool_partial(params, x_, m_, torch.bfloat16)))
        m64h, _ = _pool_f64(params, x[:, half], mask[:, half])
        live = mask[:, half].sum(1) > 0
        km, pm = (acc / st[:, 1, :, None])[live], (pacc / pst[:, 1, :, None])[live]
        _assert_close("K1p acc / denom", km, pm, TOL_BF16_M)
        _assert_close("K1p max", st[:, 0][live], pst[:, 0][live], TOL_BF16_S)
        got["K1p M"], plain["K1p M"] = _err(km, m64h[live]), _err(pm, m64h[live])
        ms = cuda_pool.pool_sharded(ops, xb, mask, shards)
        _assert_close("sharded M", ms, plain_pool(params, xb, mask, torch.bfloat16, False)[0], TOL_BF16_M)
        got["sharded M"], plain["sharded M"] = _err(ms, m64), plain["K1 True M"]
    torch.cuda.synchronize()
    for key, e in got.items():
        assert e <= F64_ERR_RATIO * plain[key], f"{key}: {e:.3e} against float64, the plain bf16 version's {plain[key]:.3e}"
