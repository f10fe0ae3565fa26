"""The port's ceiling probes (``matmul_ceiling``, ``encoder_batch_ab``,
``encoder_stages``) on the CPU, against the JAX probes of the same names
(each loaded by file path from ``experiments/``).

- ``matmul_ceiling`` times the JAX probe's 8 shapes (its list read from its
  source: the list is local to its ``main``).
- ``encoder_stages`` counts the JAX ``stage_fns``' FLOPs a tile, stage by
  stage; its stages (the stem with its max pool, layer1-3), composed with the
  pool, are ``apply_folded`` exactly; each stage matches the JAX stage on the
  same input, the JAX encoder's folded weights carried across by
  ``resnet_params_from_jax``, at B=1 and 64 px and a narrow width (stem 8),
  within ``test_torch_port_resnet.py``'s bf16 tolerance (2e-2 of the largest
  |output|; the port's stem is the space-to-depth form where the config has
  it, the JAX probe's the plain 7x7 conv: the same arithmetic, rounded at
  other points).
- Each probe's ``main`` runs at a toy size and prints the JAX probe's keys
  or lines; with no card, asked for the card, it exits with
  ``resolve_device``'s message.
"""

import ast
import importlib
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.config import EncoderConfig as JaxEncoderConfig
from toad_tpu.models import resnet_encoder as jax_resnet
from toad_tpu_torch.config import EncoderConfig
from toad_tpu_torch.experiments import encoder_batch_ab, encoder_stages, matmul_ceiling
from toad_tpu_torch.models.interop import resnet_params_from_jax
from toad_tpu_torch.models.resnet_encoder import ResNetEncoder, encoder_from_state_dict

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(stem_width=8)
TOL_BF16 = 2e-2  # test_torch_port_resnet.py: bf16, relative to the largest |output|


def _load_jax_probe(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


# -- matmul_ceiling --------------------------------------------------------------


def test_matmul_ceiling_times_the_jax_probe_s_shapes():
    tree = ast.parse((REPO / "experiments" / "matmul_ceiling.py").read_text())
    assign = next(n for n in ast.walk(tree) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "shapes")
    assert matmul_ceiling.SHAPES == ast.literal_eval(assign.value)


def test_matmul_ceiling_prints_the_jax_probe_s_keys(capsys, monkeypatch):
    monkeypatch.setattr(matmul_ceiling, "SHAPES", [s for s in matmul_ceiling.SHAPES if s[0] in ("trunk2_t1024", "gate_t1024")])
    assert matmul_ceiling.main(["--k", "2", "--runs", "1", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [ln["shape"] for ln in lines] == ["trunk2_t1024", "gate_t1024"]
    assert [ln["mkn"] for ln in lines] == [[1024, 512, 512], [1024, 512, 768]]
    for ln in lines:
        assert list(ln) == ["shape", "mkn", "tflops", "pct_peak", "us_per_call"] and ln["us_per_call"] > 0


def test_matmul_ceiling_chain_is_the_sum_of_dependent_products():
    """The chain on the CPU against the same chain in float64 numpy: each
    input the last plus bf16(sum * 1e-12), every output's sum accumulated."""
    g = torch.Generator().manual_seed(0)
    w = (torch.randn(32, 16, generator=g) * 0.02).to(torch.bfloat16)
    got = matmul_ceiling.make_chain(w, 8, 3)(5)
    x = torch.randn(8, 32, generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    acc = 0.0
    for _ in range(3):
        s = (x.double() @ w.double()).sum()
        x = x + (s.float() * 1e-12).to(torch.bfloat16)
        acc += float(s)
    assert got == pytest.approx(acc, rel=1e-5)


# -- encoder_stages --------------------------------------------------------------


def test_encoder_stages_counts_the_jax_probe_s_flops():
    jax_probe = _load_jax_probe("encoder_stages")
    stub = {f"layer{s + 1}": None for s in range(3)}  # stage_fns reads only the stages' names while counting
    want = [(name, fl) for name, _, _, fl in jax_probe.stage_fns(JaxEncoderConfig(), stub)]
    assert encoder_stages.stage_flops(EncoderConfig()) == want
    enc = ResNetEncoder(EncoderConfig(), init=False)
    assert [(n, fl) for n, _, _, _, fl in encoder_stages.stage_fns(enc)] == want
    assert [shape for _, _, shape, _, _ in encoder_stages.stage_fns(enc)] == [
        (256, 256, 3), (64, 64, 64), (256, 64, 64), (512, 32, 32)]  # the JAX in_shapes, NHWC -> NCHW for the layers


def test_encoder_stages_compose_to_apply_folded_exactly():
    enc = ResNetEncoder(EncoderConfig(), generator=torch.Generator().manual_seed(0)).fold_bn().eval()
    x = torch.randn(1, 64, 64, 3, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16)
    y = x
    with torch.inference_mode():
        for _, fn, _, _, _ in encoder_stages.stage_fns(enc, hw=64):
            y = fn(y)
        pooled = y.float().mean(dim=(2, 3))
        assert torch.equal(pooled, enc.apply_folded(x))


@pytest.fixture(scope="module")
def folded_pair():
    """The JAX encoder's folded params (every leaf moved off its init) at a
    narrow width, and the port's encoder on the same weights."""
    jcfg = JaxEncoderConfig(**SMALL)
    rng = np.random.default_rng(0)

    def jiggle(tree, key=""):
        if isinstance(tree, dict):
            return {k: jiggle(v, k) for k, v in tree.items()}
        if isinstance(tree, list):
            return [jiggle(v) for v in tree]
        a = np.asarray(tree, np.float32)
        return a + (rng.random(a.shape) if key == "var" else rng.standard_normal(a.shape) * 0.05).astype(np.float32)

    params = jax_resnet.fold_bn(jiggle(jax.tree.map(np.asarray, jax_resnet.ResNetEncoder(jcfg).init(jax.random.PRNGKey(0)))),
                                jcfg)
    enc = encoder_from_state_dict(resnet_params_from_jax(params), EncoderConfig(**SMALL))
    assert enc.folded
    return jcfg, params, enc


def test_encoder_stages_match_the_jax_stages(folded_pair):
    jcfg, params, enc = folded_pair
    jax_fns = _load_jax_probe("encoder_stages").stage_fns(jcfg, params)
    port_fns = encoder_stages.stage_fns(enc, hw=64)
    assert [f[0] for f in jax_fns] == [f[0] for f in port_fns] == ["stem+pool", "layer1", "layer2", "layer3"]
    x = np.random.default_rng(2).standard_normal((1, 64, 64, 3)).astype(np.float32)
    x_nhwc = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))  # the stage's bf16 input, both sides
    for (name, jax_fn, _, _), (_, port_fn, shape, channels_last, _) in zip(jax_fns, port_fns):
        want = np.asarray(jax_fn(jnp.asarray(x_nhwc).astype(jnp.bfloat16)).astype(jnp.float32))
        t = torch.from_numpy(np.array(x_nhwc)).to(torch.bfloat16)
        if channels_last:
            t = t.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        assert tuple(t.shape[1:]) == shape
        with torch.inference_mode():
            got = port_fn(t).float().permute(0, 2, 3, 1).numpy()
        assert got.shape == want.shape, name
        assert _rel(got, want) <= TOL_BF16, name
        x_nhwc = want  # the next stage's input: this stage's JAX output


def test_encoder_stages_prints_the_jax_probe_s_keys(capsys, monkeypatch):
    monkeypatch.setattr(encoder_stages, "HW", 64)
    assert encoder_stages.main(["--batch", "1", "--k", "1", "--device", "cpu"]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert [ln["stage"] for ln in lines] == ["stem+pool", "layer1", "layer2", "layer3", "full",
                                             "conv_ceiling_3x3_256ch_4px", "conv_ceiling_3x3_128ch_16px"]
    for ln in lines[:4]:
        assert list(ln) == ["stage", "tflops", "ms_per_batch", "gflop_per_img"] and ln["ms_per_batch"] > 0
    assert list(lines[4]) == ["stage", "tflops", "ms_per_batch", "patches_per_sec"] and lines[4]["patches_per_sec"] > 0
    assert all(list(ln) == ["stage", "tflops"] for ln in lines[5:])


# -- encoder_batch_ab ------------------------------------------------------------


def test_encoder_batch_ab_prints_the_jax_probe_s_lines(capsys, monkeypatch):
    for name, value in (("HW", 32), ("TOTAL", 4), ("BATCHES", (2, 4)), ("REPS", 2)):
        monkeypatch.setattr(encoder_batch_ab, name, value)
    assert encoder_batch_ab.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:2] == ["compiled B=2", "compiled B=4"]
    for rep, line in enumerate(lines[2:]):
        head, *arms = line.split("  ")
        assert head.startswith(f"rep{rep}: B=2: ") and [a.split(":")[0] for a in arms] == ["B=4"]
        assert line.count(" p/s") == 2
    assert len(lines) == 4


def test_encoder_batch_ab_chain_adds_the_running_sum():
    """One chain of total / B forwards: each input the first tiles plus
    bf16(1e-12 x the features' sum so far), the JAX loop's carry."""
    cfg = EncoderConfig(**SMALL)
    enc = ResNetEncoder(cfg, generator=torch.Generator().manual_seed(0)).fold_bn().eval()
    got = float(encoder_batch_ab.make_fn(enc, 2, 32, 4)(3))
    tiles = torch.rand(2, 32, 32, 3, generator=torch.Generator().manual_seed(3)).to(torch.bfloat16)
    t, acc = tiles, torch.zeros(())
    for _ in range(2):
        feats = enc.apply_folded(t)
        t = t + (acc * 1e-12).to(torch.bfloat16)
        acc = acc + feats.sum()
    assert got == float(acc)


@pytest.mark.parametrize("name", ["matmul_ceiling", "encoder_batch_ab", "encoder_stages"])
def test_probe_without_a_card_exits_with_resolve_device_s_message(name):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    probe = importlib.import_module(f"toad_tpu_torch.experiments.{name}")
    with pytest.raises(SystemExit, match=r"torch.cuda.is_available\(\) is False.*--device cpu"):
        probe.main([])
