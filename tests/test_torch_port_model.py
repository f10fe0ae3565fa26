"""ToadMIL parity of the PyTorch port against the JAX package, and weight
interop (reference state_dict layouts, JAX params, checkpoints).

Weights cross with params_from_jax; inputs are numpy from a seed.
Tolerances: f32 torch-CPU vs XLA-CPU differ in summation order only (~1e-6
observed at these widths); 1e-4 keeps a margin. bf16 logits move by bf16
rounding of the activations (~1e-4 observed): 2e-3.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.models.torch_interop import export_torch_checkpoint, toad_state_dict_from_params
from toad_tpu_torch.config import ModelConfig
from toad_tpu_torch.models.interop import params_from_jax, reference_state_dict, state_dict_from_reference
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.train.checkpoint import load_params_any

D = 96
TOL = dict(rtol=1e-4, atol=1e-4)


def _jax(cfg):
    """The JAX package's ModelConfig with the port config's fields."""
    return JaxModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree.map(np.asarray, JaxToadMIL(_jax(ModelConfig(in_dim=D, n_classes=5))).init(jax.random.PRNGKey(3)))


def _port(cfg, params):
    m = ToadMIL(cfg)
    m.load_state_dict(params_from_jax(params))
    return m.eval()


def _batch(b=3, n=200, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, n, D)).astype(np.float32)
    mask = np.ones((b, n), np.float32)
    mask[0, 150:] = 0.0
    mask[2, 17:] = 0.0
    sex = np.array([0, 1, 1][:b])
    return x, mask, sex


def _both(cfg, params, x, mask, sex, **kw):
    ref = JaxToadMIL(_jax(cfg)).apply(params, jnp.asarray(x), jnp.asarray(mask), jnp.asarray(sex), **kw)
    with torch.no_grad():
        got = _port(cfg, params)(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(sex), **kw)
    return ref, got


@pytest.mark.parametrize("field", ["logits", "y_prob", "site_logits", "site_prob", "features", "attention"])
def test_forward_matches_jax(jax_params, field):
    cfg = ModelConfig(in_dim=D, n_classes=5)
    x, mask, sex = _batch()
    ref, got = _both(cfg, jax_params, x, mask, sex)
    r, g = np.asarray(getattr(ref, field)), getattr(got, field).numpy()
    assert r.shape == g.shape
    if field == "attention":  # A_raw: -inf exactly at padding, raw scores elsewhere
        assert np.array_equal(np.isneginf(g), mask[:, None, :].repeat(2, 1) == 0)
        live = np.isfinite(r)
        np.testing.assert_allclose(g[live], r[live], **TOL)
    else:
        np.testing.assert_allclose(g, r, **TOL)
    np.testing.assert_array_equal(got.y_hat.numpy(), np.asarray(ref.y_hat))
    np.testing.assert_array_equal(got.site_hat.numpy(), np.asarray(ref.site_hat))


def test_bf16_compute_matches_jax(jax_params):
    cfg = ModelConfig(in_dim=D, n_classes=5, compute_dtype="bfloat16")
    x, mask, sex = _batch(seed=1)
    ref, got = _both(cfg, jax_params, x, mask, sex)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got.y_prob.numpy(), np.asarray(ref.y_prob), rtol=2e-3, atol=2e-3)


def test_ungated_forward_matches_jax():
    cfg = ModelConfig(in_dim=D, n_classes=4, gate=False)
    params = jax.tree.map(np.asarray, JaxToadMIL(_jax(cfg)).init(jax.random.PRNGKey(5)))
    x, mask, sex = _batch(seed=2)
    ref, got = _both(cfg, params, x, mask, sex)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), **TOL)


def test_classification_only_and_attention_only(jax_params):
    cfg = ModelConfig(in_dim=D, n_classes=5)
    x, mask, sex = _batch(seed=4)
    ref, got = _both(cfg, jax_params, x, mask, sex, need_attention=False)
    assert got.attention is None
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), **TOL)
    ref_a, got_a = _both(cfg, jax_params, x, mask, sex, attention_only=True)
    assert got_a.shape == (3, 200)
    live = np.isfinite(np.asarray(ref_a))
    np.testing.assert_allclose(got_a.numpy()[live], np.asarray(ref_a)[live], **TOL)


def test_padding_invariance(jax_params):
    """Extra padding changes nothing: a bag alone at its length equals the
    same bag inside a longer padded batch."""
    cfg = ModelConfig(in_dim=D, n_classes=5)
    model = _port(cfg, jax_params)
    x, mask, sex = _batch(seed=6)
    with torch.no_grad():
        full = model(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(sex))
        for i in range(3):
            n = int(mask[i].sum())
            one = model(torch.from_numpy(x[i : i + 1, :n]), torch.ones(1, n), torch.from_numpy(sex[i : i + 1]))
            torch.testing.assert_close(one.logits[0], full.logits[i], rtol=1e-5, atol=1e-5)
            torch.testing.assert_close(one.attention[0], full.attention[i, :, :n], rtol=1e-5, atol=1e-5)


def test_fully_masked_bag_stays_finite(jax_params):
    cfg = ModelConfig(in_dim=D, n_classes=5)
    x, mask, sex = _batch(seed=7)
    mask[1] = 0.0
    ref, got = _both(cfg, jax_params, x, mask, sex)
    assert torch.isfinite(got.logits).all()
    assert torch.all(got.features[1, :, :-1] == 0)
    np.testing.assert_allclose(got.logits.numpy(), np.asarray(ref.logits), **TOL)


@pytest.mark.parametrize("dropout", [True, False], ids=["attention_net_3_6", "attention_net_2_4"])
@pytest.mark.parametrize("wrapped", [False, True], ids=["plain", "dataparallel"])
def test_reference_state_dict_round_trip(jax_params, dropout, wrapped):
    sd = toad_state_dict_from_params(jax_params, dropout=dropout)
    if wrapped:  # nn.DataParallel leaves module. segments
        sd = {k.replace("attention_net.", "attention_net.module.", 1): v for k, v in sd.items()}
    ref_sd = {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}
    got = state_dict_from_reference(ref_sd, ModelConfig(in_dim=D, n_classes=5))
    want = params_from_jax(jax_params)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0)
    model = ToadMIL(ModelConfig(in_dim=D, n_classes=5))
    model.load_state_dict(got)  # strict: every key of the module is covered
    back = reference_state_dict(model.state_dict(), dropout=dropout)
    for k, v in toad_state_dict_from_params(jax_params, dropout=dropout).items():
        np.testing.assert_array_equal(back[k].numpy(), v)


def test_checkpoint_written_by_jax_export_loads(jax_params, tmp_path):
    path = tmp_path / "s_0_checkpoint.pt"
    export_torch_checkpoint(path, jax_params)
    got = load_params_any(path, ModelConfig(in_dim=D, n_classes=5))
    for k, v in params_from_jax(jax_params).items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0)
    # bare name without the .pt suffix, as reference scripts pass it
    assert load_params_any(tmp_path / "s_0_checkpoint").keys() == got.keys()


def test_checkpoint_errors(jax_params, tmp_path):
    with pytest.raises(ValueError, match="toad_tpu export"):
        load_params_any(tmp_path)  # an Orbax checkpoint is a directory
    with pytest.raises(FileNotFoundError):
        load_params_any(tmp_path / "missing.pt")
    path = tmp_path / "s_1_checkpoint.pt"
    export_torch_checkpoint(path, jax_params)
    with pytest.raises(ValueError, match="classes"):
        load_params_any(path, ModelConfig(in_dim=D, n_classes=7))
    with pytest.raises(KeyError, match="TOAD"):
        state_dict_from_reference({"fc.weight": torch.zeros(2, 2)})


def test_xavier_init_from_explicit_generator():
    cfg = ModelConfig(in_dim=1024, n_classes=18)
    a = ToadMIL(cfg, generator=torch.Generator().manual_seed(11))
    b = ToadMIL(cfg, generator=torch.Generator().manual_seed(11))
    state = torch.get_rng_state()
    c = ToadMIL(cfg, generator=torch.Generator().manual_seed(12))
    assert torch.equal(torch.get_rng_state(), state)  # the global generator is untouched
    for k, v in a.state_dict().items():
        assert torch.equal(v, b.state_dict()[k])
    assert not torch.equal(a.trunk.fc1.weight, c.trunk.fc1.weight)
    w = a.trunk.fc1.weight
    assert abs(w.std().item() - (2.0 / (1024 + 512)) ** 0.5) < 2e-3
    assert all(torch.all(m.bias == 0) for m in a.modules() if isinstance(m, torch.nn.Linear))
