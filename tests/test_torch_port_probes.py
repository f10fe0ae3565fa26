"""The pooling-kernel probes of the PyTorch port against the JAX probes.

Each JAX probe (``experiments/mfu_probe.py``, ``experiments/int8_probe.py``)
is loaded by file path and its kernel body runs in a ``pallas_call`` with the
probe's own BlockSpecs in interpret mode, at the probes' full width (D=1024,
H=512, A=384, T_PAD=8), B=2 (B=4 for the pair) x 256 rows in row tiles of
128: one bag with a ragged mask and one whose tail of 156 rows is masked
(its second tile fully). The port's plain versions get the same numpy inputs.

Tolerances, relative to the largest |output| of the case:
- bf16 variants (P1, P2, P5): 5e-3, K1's TOL_BF16_M
  (tests/test_torch_port_pool.py): the same rounding points, but XLA and
  torch evaluate tanh, sigmoid and exp with different internal precision and
  sum in another order, which can tip a bf16 rounding of h1, h2, gated or e;
  the online softmax rounds e against a running max, the plain version
  against the bag's max.
- int8 variants (P3, P4): 5e-3, K2's TOL_M_REL
  (tests/test_torch_port_int8.py): the integer GEMMs agree except where a
  dequantized value rounds differently in its last bit and moves one
  requantized value by one step, plus the bf16 differences above.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from toad_tpu_torch.ops import _build, cuda_pool, probe_pool, probe_pool_int8
from toad_tpu_torch.ops.fused_pool import plain_pool
from toad_tpu_torch.ops.quantize import plain_int8_pool, quantize_rows

REPO = Path(__file__).resolve().parent.parent
B, N, TILE = 2, 256, 128
D, H, A, T_PAD = 1024, 512, 384, 8
TOL_BF16_M = 5e-3
TOL_M_REL = 5e-3


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def mfu():
    return _load("mfu_probe")


@pytest.fixture(scope="module")
def i8():
    return _load("int8_probe")


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(b=B, n=N, seed=0):
    """x [B, N, D] f32 (rounded to bf16 by both sides), mask [B, N]: bag 0
    ragged, bag 1 live on its first 100 rows only (its last tile fully
    masked); further bags ragged."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, D)).astype(np.float32)
    mask = (rng.random((b, n)) < 0.8).astype(np.float32)
    mask[1] = 0.0
    mask[1, :100] = 1.0
    return x, mask


def _biases(seed=3):
    """Small nonzero biases, so that the bias paths are compared too."""
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(n) * 0.05).astype(np.float32)
            for k, n in (("b1", H), ("b2", H), ("bab", 2 * A), ("bc", T_PAD))}


@pytest.fixture(scope="module")
def bf16_params():
    """The probe's weights with the biases of _biases: (torch tuple, jax tuple)."""
    w1, _, w2, _, wab, _, wc, _ = probe_pool.probe_weights(0)
    bs = _biases()
    tp = (w1, torch.from_numpy(bs["b1"]), w2, torch.from_numpy(bs["b2"]), wab, torch.from_numpy(bs["bab"]), wc,
          torch.from_numpy(bs["bc"]))
    jp = tuple(jnp.asarray(t.float().numpy(), jnp.bfloat16 if t.dtype == torch.bfloat16 else jnp.float32) for t in tp)
    return tp, jp


def _to_jax(t: torch.Tensor):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


def _pallas(body, inputs, n_params, out_block, scratch, b_blocks, in_blocks, n=N, tile=TILE):
    """pallas_call of a probe body with the probe's BlockSpecs, interpret mode."""
    return pl.pallas_call(
        body,
        grid=(b_blocks, n // tile),
        in_specs=[*(pl.BlockSpec(shape, idx, memory_space=pltpu.VMEM) for shape, idx in in_blocks),
                  *[pl.BlockSpec(memory_space=pltpu.VMEM) for _ in range(n_params)]],
        out_specs=[pl.BlockSpec(out_block, lambda bi, ni: (bi, 0, 0), memory_space=pltpu.VMEM)],
        out_shape=[jax.ShapeDtypeStruct((out_block[0] * b_blocks, T_PAD, H), jnp.float32)],
        scratch_shapes=scratch,
        interpret=True,
    )(*inputs)[0]


def _x_specs(bags, tile=TILE):
    return [((bags, tile, D), lambda bi, ni: (bi, ni, 0)), ((bags, 1, tile), lambda bi, ni: (bi, 0, ni))]


def _single_scratch():
    return [pltpu.VMEM((T_PAD, H), jnp.float32), pltpu.VMEM((2, T_PAD), jnp.float32)]


def _jax_bf16(body, jp, x, mask, pair=False, tile=TILE):
    bags = 2 if pair else 1
    scratch = ([pltpu.VMEM((2, T_PAD, H), jnp.float32), pltpu.VMEM((2, 2, T_PAD), jnp.float32)] if pair
               else _single_scratch())
    xj = jnp.asarray(x, jnp.float32).astype(jnp.bfloat16)
    return np.asarray(_pallas(body, (xj, jnp.asarray(mask)[:, None, :], *jp), 8, (bags, T_PAD, H), scratch,
                              x.shape[0] // bags, _x_specs(bags, tile), n=x.shape[1], tile=tile))


# -- P1, P2, P5: the bf16 ladder ---------------------------------------------------------


@pytest.mark.parametrize("variant", ["full", "fusedab", "exp2", "nogate", "nosoftmax", "trunkonly", "b2", "bf16"])
def test_plain_probe_pool_matches_the_probe_in_interpret_mode(mfu, i8, bf16_params, variant):
    tp, jp = bf16_params
    b = 4 if variant == "b2" else B
    x, mask = _inputs(b)
    if variant == "b2":
        body, pair = mfu.make_kernel_b2(), True
    elif variant == "bf16":
        body, pair = i8.make_kernel_bf16(), False
    else:
        body, pair = mfu.make_kernel(variant), False
    want = _jax_bf16(body, jp, x, mask, pair)
    got = probe_pool.plain_probe_pool(tp, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask), variant, TILE)
    assert tuple(got.shape) == (b, T_PAD, H) and got.dtype == torch.float32
    assert _rel(got.numpy(), want) <= TOL_BF16_M


def test_plain_trunkonly_at_n_ending_mid_tile_matches_the_probe(mfu, bf16_params):
    """N = 192 at the probe's tile of 64: three TPU grid steps, one and a half
    of the kernel's 128-row tiles (its rows past N are excluded by their
    index). The plain version sums the 192 rows of every bag, padding and
    masked rows included, over the probe's 3 tiles."""
    tp, jp = bf16_params
    x, mask = _inputs(B, 192)
    want = _jax_bf16(mfu.make_kernel("trunkonly"), jp, x, mask, tile=64)
    got = probe_pool.plain_probe_pool(tp, torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask), "trunkonly", 64)
    assert _rel(got.numpy(), want) <= TOL_BF16_M


def test_probe_full_rows_equal_k1_plain(bf16_params):
    """Rows 0-1 of ``full`` are K1's pooled M on the same weights (its two
    task columns of Wc and bc)."""
    (w1, b1, w2, b2, wab, bab, wc, bc), _ = bf16_params
    x, mask = _inputs()
    xt, mt = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask)
    params = {"trunk": {"fc1": {"w": w1, "b": b1}, "fc2": {"w": w2, "b": b2}},
              "attn": {"a": {"w": wab[:, :A], "b": bab[:A]}, "b": {"w": wab[:, A:], "b": bab[A:]},
                       "c": {"w": wc[:, :2], "b": bc[:2]}}}
    k1, _ = plain_pool(params, xt, mt, torch.bfloat16, with_scores=False)
    got = probe_pool.plain_probe_pool(bf16_params[0], xt, mt, "full", TILE)
    assert _rel(got[:, :2].numpy(), k1.numpy()) <= TOL_BF16_M


def test_probe_weights_equal_the_jax_probes(mfu, i8, monkeypatch):
    """The port draws the JAX probes' main() arrays bit for bit: captured
    from the JAX mains themselves, their timed runners stubbed out."""
    seen = {}

    def capture(name):
        def run(params, *a, **k):
            seen.setdefault(name, params)
            return jnp.float32(0)
        return run

    monkeypatch.setattr(sys, "argv", ["mfu_probe", "--variants", "full", "--runs", "1"])
    monkeypatch.setattr(mfu, "run_chain", capture("mfu"))
    mfu.main()
    monkeypatch.setattr(sys, "argv", ["int8_probe", "--variants", "bf16,int8_chain,int8_h_only", "--runs", "1"])
    monkeypatch.setattr(i8, "run_bf16", capture("bf16"))
    monkeypatch.setattr(i8, "run_int8", capture("int8"))
    monkeypatch.setattr(i8, "run_int8_inquant", capture("h_only"))
    i8.main()

    def same(jax_arrays, port):
        assert len(jax_arrays) == len(port)
        for j, t in zip(jax_arrays, port):
            j = np.asarray(j)
            want = j.view(np.uint16) if j.dtype.name == "bfloat16" else j
            got = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
            assert got.dtype == want.dtype and np.array_equal(got, want)

    same(seen["mfu"], probe_pool.probe_weights(0))
    same(seen["bf16"], probe_pool_int8.probe_bf16_weights(0))
    same(seen["int8"], probe_pool_int8.probe_qparams(0))
    same(seen["h_only"], probe_pool_int8.probe_qparams(0, h_only=True))


# -- P3, P4: the int8 chain -----------------------------------------------------------------


def _int8_params(h_only=False, b1_shift=0.0):
    qp = list(probe_pool_int8.probe_qparams(0, h_only=h_only))
    bs = _biases(5)
    qp[2] = torch.from_numpy(bs["b1"])
    qp[2][: H // 2] += b1_shift  # half of h1's columns past 127
    qp[5], qp[8], qp[10] = (torch.from_numpy(bs[k]) for k in ("b2", "bab", "bc"))
    return tuple(qp)


def _jax_int8(body, qp, inputs, n_in):
    scratch = _single_scratch()
    in_blocks = [((1, TILE, D), lambda bi, ni: (bi, ni, 0))] + [((1, 1, TILE), lambda bi, ni: (bi, 0, ni))] * (n_in - 1)
    return np.asarray(_pallas(body, (*inputs, *(_to_jax(t) for t in qp)), 11, (1, T_PAD, H), scratch, B, in_blocks))


@pytest.mark.parametrize("variant,b1_shift", [("int8_chain", 0.0), ("int8_gemms", 0.0), ("int8_gemms", 150.0)])
def test_plain_probe_int8_matches_the_probe_in_interpret_mode(i8, variant, b1_shift):
    """Pre-quantized rows. The shifted b1 pushes h1 past 127, so that
    ``int8_gemms``'s cast saturates (the probe's own weights never get there)."""
    qp = _int8_params(b1_shift=b1_shift)
    x, mask = _inputs()
    xq, sx = quantize_rows(torch.from_numpy(x))
    if b1_shift:
        h1 = probe_pool_int8._dequant(probe_pool_int8._int_gemm(xq, qp[0]), sx, qp[1], qp[2])
        assert float(h1.max()) > 127.0 > float(h1[..., H // 2:].max())  # the cast wraps unless it saturates
    requant = variant == "int8_chain"
    want = _jax_int8(i8.make_kernel_int8(requant), qp,
                     (jnp.asarray(xq.numpy()), jnp.asarray(sx.numpy())[:, None, :], jnp.asarray(mask)[:, None, :]), 3)
    got = probe_pool_int8.plain_probe_pool_int8(qp, xq, sx, torch.from_numpy(mask), variant)
    assert _rel(got.numpy(), want) <= TOL_M_REL


@pytest.mark.parametrize("variant", ["int8_inquant", "int8_inquant_bf16", "int8_h_only"])
def test_plain_probe_int8_inquant_matches_the_probe_in_interpret_mode(i8, variant):
    h_only = variant == "int8_h_only"
    qp = _int8_params(h_only=h_only)
    x, mask = _inputs()
    body = i8.make_kernel_int8_inquant(quant_bf16=variant != "int8_inquant", h_only=h_only)
    want = _jax_int8(body, qp, (jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(mask)[:, None, :]), 2)
    got = probe_pool_int8.plain_probe_pool_int8(qp, torch.from_numpy(x).to(torch.bfloat16), None,
                                                torch.from_numpy(mask), variant)
    assert _rel(got.numpy(), want) <= TOL_M_REL


def test_cast_int8_saturates_as_xla_does():
    y = torch.tensor([[300.7, -200.2, 1e10, 127.9, -0.7, -128.5]])
    want = np.asarray(jnp.asarray(y.numpy()).astype(jnp.int8))
    assert np.array_equal(probe_pool_int8._cast_int8(y)[0].numpy(), want)
    assert want.tolist() == [[127, -128, 127, 127, 0, -128]]


def test_requant_rows_bf16_matches_the_probe(i8):
    rng = np.random.default_rng(11)
    y = (rng.standard_normal((64, 512)) * rng.uniform(0.01, 30, (64, 1))).astype(np.float32)
    y[3] = 0.0
    q, s = probe_pool_int8._requant_rows_bf16(torch.from_numpy(y))
    qj, sj = i8._requant_rows_bf16(jnp.asarray(y))
    assert np.array_equal(q.numpy(), np.asarray(qj)) and np.array_equal(s.numpy(), np.asarray(sj))


def test_probe_int8_chain_rows_equal_k2_plain():
    """Rows 0-1 of ``int8_chain`` are K2's plain M on the same quantized weights."""
    qp = _int8_params()
    w1q, sw1, b1, w2q, sw2, b2, wabq, swab, bab, wc, bc = qp
    qparams = {"w1q": w1q, "sw1": sw1, "b1": b1, "w2q": w2q, "sw2": sw2, "b2": b2, "wabq": wabq, "swab": swab,
               "bab": bab, "wc": wc[:, :2].float(), "bc": bc[:2]}
    x, mask = _inputs()
    xq, sx = quantize_rows(torch.from_numpy(x))
    k2, _ = plain_int8_pool(qparams, xq, sx, torch.from_numpy(mask), with_scores=False)
    got = probe_pool_int8.plain_probe_int8(qp, xq, sx, torch.from_numpy(mask), requant=True)
    assert _rel(got[:, :2].numpy(), k2.numpy()) <= TOL_M_REL


# -- the chain, the entry points, refusals --------------------------------------------------


def test_port_chain_gives_the_jax_run_chain_total(mfu):
    """k=2 serially dependent calls, each input bumped by the last output:
    the port's chain on the CPU against JAX's run_chain in interpret mode,
    on the x that run_chain draws from its key (the same jax.random.normal
    call, made here)."""
    from toad_tpu_torch.experiments import mfu_probe as port_mfu

    params = probe_pool.probe_weights(0)
    jp = tuple(_to_jax(t) for t in params)
    key = jax.random.PRNGKey(7)
    mfu.INTERPRET = True
    try:
        want = float(mfu.run_chain(jp, key, "full", B, N, TILE, 2))
    finally:
        mfu.INTERPRET = False
    x = torch.from_numpy(np.asarray(jax.random.normal(key, (B, N, D), jnp.float32).astype(jnp.bfloat16)).astype(np.float32))
    got = port_mfu.run_chain(port_mfu.make_pool("full", params, TILE), x.to(torch.bfloat16), torch.ones(B, N), 2)
    assert abs(got - want) <= TOL_BF16_M * abs(want)


@pytest.mark.parametrize("module,variants", [
    ("mfu_probe", "full,fusedab,exp2,nogate,nosoftmax,trunkonly,eager,b2"),
    ("int8_probe", "bf16,int8_chain,int8_inquant,int8_gemms,int8_inquant_bf16,int8_h_only"),
])
def test_probe_entry_points_run_on_the_cpu_when_asked(module, variants, capsys):
    """The entry points' control flow at a small size on the CPU (plain
    versions): one JSON line per variant, no device metric claimed."""
    import json

    mod = importlib.import_module(f"toad_tpu_torch.experiments.{module}")
    mod.main(["--device", "cpu", "--batch", "2", "--n", "128", "--tile", "64", "--k", "2", "--runs", "1",
              "--variants", variants])
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [line["variant"] for line in lines] == variants.split(",")
    for line in lines:
        assert line["device"] == "cpu" and line["pct_peak"] is None and line["ms_per_call"] > 0
        assert line.get("tflops_counted", line.get("tops_counted")) is None
    assert probe_pool.LAUNCHES == 0 and probe_pool_int8.LAUNCHES == 0 and not _build.is_loaded()


def test_probe_entry_points_refuse_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    for module in ("mfu_probe", "int8_probe", "longbag_probe"):
        out = subprocess.run([sys.executable, "-m", f"toad_tpu_torch.experiments.{module}", "--k", "1"], cwd=REPO,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "CUDA" in out.stderr and not out.stdout.strip()


def test_unknown_variants_raise():
    with pytest.raises(ValueError, match="unknown probe variant"):
        probe_pool.instance("nosuch")
    x, mask = torch.zeros(2, 128, D, dtype=torch.bfloat16), torch.ones(2, 128)
    with pytest.raises(ValueError, match="unknown int8 probe variant"):
        probe_pool_int8.plain_probe_pool_int8(probe_pool_int8.probe_qparams(0), x, None, mask, "int8_nosuch")


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """Shapes and types are checked first, then the device: a CPU tensor
    never reaches the plain version through a kernel wrapper."""
    ops = probe_pool.pack_probe_params(probe_pool.probe_weights(0))
    x, mask = torch.zeros(2, 256, D, dtype=torch.bfloat16), torch.ones(2, 256)
    with pytest.raises(ValueError, match="odd"):
        probe_pool.probe_pool(ops, torch.zeros(3, 256, D, dtype=torch.bfloat16), torch.ones(3, 256), "b2", 128)
    with pytest.raises(ValueError, match="multiple of the probe's tile"):
        probe_pool.probe_pool(ops, x, mask, "full", 96)
    with pytest.raises(ValueError, match="half the kernel's 128-row tile"):
        probe_pool.probe_pool(ops, x[:, :96], mask[:, :96], "full", 32)
    with pytest.raises(TypeError, match="bf16 x"):
        probe_pool.probe_pool(ops, x.float(), mask, "full", 128)
    with pytest.raises(ValueError, match="unknown probe variant"):
        probe_pool.probe_pool(ops, x, mask, "nosuch", 128)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        probe_pool.probe_pool(ops, x, mask, "full", 128)
    qops = probe_pool_int8.pack_probe_qparams(probe_pool_int8.probe_qparams(0))
    xq, sx = torch.zeros(2, 256, D, dtype=torch.int8), torch.ones(2, 256)
    with pytest.raises(ValueError, match="unknown int8 probe variant"):
        probe_pool_int8.probe_pool_int8(qops, xq, sx, mask, "int8_nosuch")
    with pytest.raises(TypeError, match="takes bf16 x"):
        probe_pool_int8.probe_pool_int8(qops, xq, None, mask, "int8_inquant")
    with pytest.raises(ValueError, match="row scales"):
        probe_pool_int8.probe_pool_int8(qops, xq, None, mask, "int8_chain")
    with pytest.raises(TypeError, match="h_only"):
        probe_pool_int8.probe_pool_int8(qops, x, None, mask, "int8_h_only")
    with pytest.raises(ValueError, match="64-row tile"):
        probe_pool_int8.probe_pool_int8(qops, xq[:, :96], sx[:, :96], mask[:, :96], "int8_chain")
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        probe_pool_int8.probe_pool_int8(qops, xq, sx, mask, "int8_chain")
    assert probe_pool.LAUNCHES == 0 and probe_pool_int8.LAUNCHES == 0 and not _build.is_loaded()


def test_probe_kernel_takes_n_ending_mid_tile():
    """N = 192 at a probe tile of 64 passes every shape check of the probe
    kernel's wrapper (only the device stops it here), for the single-bag
    instances (one and a half 128-row tiles) and the pair (three tiles of 64
    + 64 rows); N = 96 stays refused."""
    ops = probe_pool.pack_probe_params(probe_pool.probe_weights(0))
    x, mask = torch.zeros(2, 192, D, dtype=torch.bfloat16), torch.ones(2, 192)
    for variant in probe_pool.KERNEL_VARIANTS:
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            probe_pool.probe_pool(ops, x, mask, variant, 64)
    with pytest.raises(ValueError, match="multiple of 64"):
        probe_pool.probe_pool(ops, x[:, :96], mask[:, :96], "full", 96)
    assert probe_pool.LAUNCHES == 0 and not _build.is_loaded()


@pytest.mark.parametrize("a_dim", [128, 256, 384])
def test_probe_plan(a_dim):
    """The probe kernel's plan (``csrc/pool_probe.cu``'s ``probe_layout``):
    K1 bf16's 128-row tile and threads, 64 + 64 rows for the pair, and the
    3-slot ring of the mma.sync pass K1 bf16 ran before its wgmma GEMMs; its
    shared memory is that pass's layout (h1/h2 rows of H + 8 bf16, ring and
    x slots of 40-element rows, the x ring as large as GEMM2's stash half)
    with two bag slots' statistics in place of K1's acc [2][H] and
    statistics (the 8-task sums live in device memory), under the card's
    limit at every A; Wc goes to the kernel transposed."""
    k1 = cuda_pool.plan(torch.bfloat16, H, a_dim)
    rows128_pass = 2 * 128 * (H + 8) + 2 * 3 * 256 * 40 + 4 * 32 * 256
    for pair in (False, True):
        p = probe_pool.plan(pair, H, a_dim)
        assert (p.rows, p.rows_per_bag, p.threads, p.slots) == (k1.rows, 64 if pair else 128, k1.threads, 3)
        assert p.smem == rows128_pass + 4 * 2 * 3 * T_PAD == 227_520 <= cuda_pool.MAX_SMEM
    params = probe_pool.probe_weights(0)
    ops = probe_pool.pack_probe_params(params)
    assert tuple(ops.wc.shape) == (T_PAD, A) and torch.equal(ops.wc, params[6].t())
    for h_dim, bad_a in ((256, 128), (H, 64), (H, 640)):
        with pytest.raises(ValueError, match="not supported"):
            probe_pool.plan(False, h_dim, bad_a)


@pytest.mark.parametrize("b,n,pair,want", [
    (32, 8192, False, (16, 4)),  # the probes' shape: 128 CTAs of 16 tiles, one wave
    (32, 8192, True, (16, 8)),  # 16 pairs: 128 CTAs of 16 tiles of 64 + 64 rows
    (4, 4096, False, (1, 32)),
    (4, 4096, True, (1, 64)),
    (2, 4160, False, (1, 33)),  # the last tile half past N
    (2, 4160, True, (1, 65)),
    (1, 131072, False, (8, 128)),
])
def test_probe_split_is_whole_waves(b, n, pair, want):
    """The probe's grid runs in whole waves of one CTA an SM (132 on an H100),
    the fewest tile-times first, then the fewest splits."""
    per, splits = probe_pool.split(b, n, pair, 132)
    assert (per, splits) == want
    tiles = -(-n // (64 if pair else 128))
    assert per * (splits - 1) < tiles <= per * splits
    waves = -(-(b // (2 if pair else 1)) * splits // 132)
    assert waves * per == min(-(-(b // (2 if pair else 1)) * s // 132) * -(-tiles // s) for s in range(1, tiles + 1))


def test_rows_per_split_plan():
    """K1 at 2,048-row splits (the long-bag probe's tiling): a 131,072-row
    bag in 64 splits of 32 bf16 tiles (64 f32 tiles); other sizes refused."""
    assert cuda_pool.fixed_split_plan(131072, 64, 2048) == (32, 64)
    assert cuda_pool.fixed_split_plan(131072, 32, 2048) == (64, 64)
    assert cuda_pool.fixed_split_plan(5000, 64, 2048) == (32, 3)  # a shorter last split
    for bad in (2000, 0):
        with pytest.raises(ValueError, match="multiple of the kernel's 64-row tile"):
            cuda_pool.fixed_split_plan(131072, 64, bad)


def test_ops_counts():
    full = 2 * (D * H + H * H + 2 * H * A + A * T_PAD + T_PAD * H)
    assert probe_pool.ops_per_row("full") == probe_pool.ops_per_row("b2") == full
    assert probe_pool.ops_per_row("trunkonly") == 2 * (D * H + H * H + T_PAD * H)
    i = probe_pool_int8.ops_per_row("int8_chain")
    assert i["int8"] + i["bf16"] == full and i["int8"] == 2 * (D * H + H * H + 2 * H * A)
    h = probe_pool_int8.ops_per_row("int8_h_only")
    assert h["bf16"] == i["bf16"] + 2 * D * H and h["int8"] + h["bf16"] == full


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_probe_kernels_match_plain_on_card(cuda_device, bf16_params):
    """Every instance of both probe kernels against its plain version on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tp, _ = bf16_params
    x, mask = _inputs(4)
    xt, mt = torch.from_numpy(x).to(cuda_device).to(torch.bfloat16), torch.from_numpy(mask).to(cuda_device)
    params = tuple(t.to(cuda_device) for t in tp)
    ops = probe_pool.pack_probe_params(params)
    for variant in probe_pool.KERNEL_VARIANTS:
        got = probe_pool.probe_pool(ops, xt, mt, variant, TILE)
        want = probe_pool.plain_probe_pool(params, xt, mt, variant, TILE)
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL_BF16_M
    for variant in probe_pool_int8.VARIANTS:
        qp = tuple(t.to(cuda_device) for t in _int8_params(h_only=variant == "int8_h_only"))
        qops = probe_pool_int8.pack_probe_qparams(qp)
        xin, sx = quantize_rows(xt.float()) if variant in probe_pool_int8.PREQUANTIZED else (xt, None)
        got = probe_pool_int8.probe_pool_int8(qops, xin, sx, mt, variant)
        want = probe_pool_int8.plain_probe_pool_int8(qp, xin, sx, mt, variant)
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) <= TOL_M_REL


def test_longbag_probe_runs_on_the_cpu_when_asked(capsys):
    """The long-bag probe's three arms at a small size on the CPU (plain
    versions): one JSON line per arm, no rate claimed, no kernel launched."""
    import json

    from toad_tpu_torch.experiments import longbag_probe

    assert longbag_probe.main(["--device", "cpu", "--n", "256", "--k", "1"]) == 0
    lines = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    assert [line["arm"] for line in lines] == ["full_bump", "element_bump", "split_2048"]
    for line in lines:
        assert line["device"] == "cpu" and line["tflops_counted"] is None and line["k1_launches"] == 0
    assert lines[-1]["rows_per_split"] == 2048 and lines[-1]["pooled_rows_summed"] == 2
    assert cuda_pool.LAUNCHES == 0 and not _build.is_loaded()
