"""The int8 pooling kernel K2 on the card (``csrc/pool_int8.cu``,
``pool_int8_kernel``): its three GEMMs are int8 wgmma with both operands in
shared memory (the trunk's m64n256k32 a warpgroup over the weights' 64-byte
rows in the 64-byte swizzle, A the x slice or h1q's panels; the gate's
m64n128k32 over 128-byte rows in the 128-byte swizzle, A h2q's panels), each
warpgroup's int32 sums in wgmma's accumulator layout, and each call ends in
its own merge (``pool_tail``).

Structured weights first: one-hot int8 weights (127 in one row a column,
scale 1) on int8 inputs, so that h1, h2, u and v are columns of x moved
about, scaled and requantized. Each bag has one live row, so that M is that
row's h2 rounded to bf16 (e = 1, no sum to round), and each task's Wc picks
one gate column j, so that its scores are gated_j + bc for every row (one
product of 1, no sum to round): M and the scores then equal
``plain_int8_pool``'s bit for bit, and a wrong descriptor, swizzle or
accumulator mapping shows as a moved column or row, not as a small error.
Then seeded weights at both attention widths the smoke runs, both modes,
against ``plain_int8_pool`` within the chip smoke's int8 tolerances.

Every test needs a CUDA GPU and skips elsewhere; this file imports no JAX.
"""

import numpy as np
import pytest
import torch

from toad_tpu_torch.ops import cuda_pool_int8
from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_pool_params, quantize_rows

D, H = 1024, 512
A_DIMS = [384, 128]  # 3 gate passes and 1
# chip_smoke.py's int8 tolerances, kernel against plain_int8_pool
TOL_INT8_S = dict(atol=1e-3, rtol=1e-3)
TOL_INT8_M = dict(atol=2e-3, rtol=2e-3)
# gate columns whose scores the one-hot Wc checks, in pairs (task 0, task 1): every pass, both
# warpgroups, both groups of 32 of a warpgroup, every n-tile, quad lane and pair half between them
GATE_COLS = {384: [(0, 383), (45, 218), (77, 289), (127, 200)], 128: [(0, 127), (45, 100), (77, 9), (64, 31)]}


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _one_hot(rng, n_in: int, n_out: int) -> np.ndarray:
    """int8 [n_in, n_out] with 127 once a column, in a random row: output j is input perm[j]."""
    w = np.zeros((n_in, n_out), np.int8)
    w[rng.choice(n_in, n_out, replace=n_out > n_in), np.arange(n_out)] = 127
    return w


def _assert_close(what: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> None:
    err = (got.double() - want.double()).abs()
    excess = err - tol["atol"] - tol["rtol"] * want.double().abs()
    assert excess.max().item() <= 0, f"{what}: max abs err {err.max().item():.3e} over {tol}"


@pytest.mark.cuda
@pytest.mark.parametrize("a_dim", A_DIMS)
def test_one_hot_weights_give_plain_int8_pools_bits(dev, a_dim):
    rng = np.random.default_rng(28 + a_dim)

    def t(a, dtype=None):
        return torch.from_numpy(np.asarray(a)).to(dev, dtype)

    base = {
        "w1q": t(_one_hot(rng, D, H)), "sw1": t(np.ones(H, np.float32)), "b1": t(np.zeros(H, np.float32)),
        "w2q": t(_one_hot(rng, H, H)), "sw2": t(np.ones(H, np.float32)), "b2": t(np.zeros(H, np.float32)),
        # u, v = 127 h2q 2^-20 sh2 + bab: of order 1, where tanh and sigmoid tell values apart
        "wabq": t(_one_hot(rng, H, 2 * a_dim)), "swab": t(np.full(2 * a_dim, 2.0 ** -20, np.float32)),
        "bab": t((rng.integers(-32, 32, 2 * a_dim) / 64).astype(np.float32)),
        "bc": t(np.array([0.25, -0.5], np.float32)),
    }
    b_, n = 8, 300  # 5 row tiles, the last of 44 rows
    xq = t(rng.integers(-40, 128, (b_, n, D)).astype(np.int8))
    sx = torch.full((b_, n), 2.0 ** -7, device=dev)
    live = [0, 63, 64, 127, 130, 200, 255, 299]  # one row a bag: first and last of tiles, the last row
    mask = torch.zeros(b_, n, device=dev)
    mask[torch.arange(b_), torch.tensor(live)] = 1.0
    for j0, j1 in GATE_COLS[a_dim]:
        wc = np.zeros((a_dim, 2), np.float32)
        wc[j0, 0] = wc[j1, 1] = 1.0
        qparams = dict(base, wc=t(wc))
        ops = cuda_pool_int8.pack_qparams(qparams)
        with torch.inference_mode():
            for scored in (True, False):
                mk, sk = cuda_pool_int8.pool_int8(ops, xq, sx, mask, scored)
                mp, sp = plain_int8_pool(qparams, xq, sx, mask, scored)
                torch.cuda.synchronize()
                moved = (mk != mp).any(-1)  # [B, 2]: a bag's M, i.e. its live row's h2, off plain's
                assert not moved.any(), (
                    f"j=({j0}, {j1}) scored={scored}: M differs at bags {moved.nonzero().tolist()} "
                    f"(max abs err {(mk - mp).abs().max().item():.3e})")
                if scored:
                    off = (sk != sp).nonzero()
                    assert off.numel() == 0, (
                        f"j=({j0}, {j1}): the scores differ at {off[:8].tolist()} (of {len(off)}; max abs err "
                        f"{(sk - sp).abs().max().item():.3e})")
                    assert sk[:, 0].std().item() > 0 and sk[:, 1].std().item() > 0  # gated_j varies by row


@pytest.mark.cuda
@pytest.mark.parametrize("a_dim", A_DIMS)
def test_seeded_weights_within_the_smokes_tolerances(dev, a_dim):
    rng = np.random.default_rng(a_dim)

    def lin(n_in, n_out):
        return {"w": torch.from_numpy((rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)).to(dev),
                "b": torch.from_numpy((0.1 * rng.standard_normal(n_out)).astype(np.float32)).to(dev)}

    params = {"trunk": {"fc1": lin(D, H), "fc2": lin(H, H)},
              "attn": {"a": lin(H, a_dim), "b": lin(H, a_dim), "c": lin(a_dim, 2)}}
    qparams = quantize_pool_params(params)
    ops = cuda_pool_int8.pack_qparams(qparams)
    b_, n = 3, 4096
    xq, sx = quantize_rows(torch.from_numpy(rng.standard_normal((b_, n, D)).astype(np.float32)).to(dev))
    mask = torch.from_numpy((rng.random((b_, n)) < 0.9).astype(np.float32)).to(dev)
    mask[1, 1000:] = 0.0  # a ragged bag: its later tiles are padding
    with torch.inference_mode():
        for scored in (True, False):
            mk, sk = cuda_pool_int8.pool_int8(ops, xq, sx, mask, scored)
            mp, sp = plain_int8_pool(qparams, xq, sx, mask, scored)
            torch.cuda.synchronize()
            _assert_close(f"A={a_dim} scored={scored} M", mk, mp, TOL_INT8_M)
            if scored:
                _assert_close(f"A={a_dim} scores", sk, sp, TOL_INT8_S)
            else:
                assert sk is None
