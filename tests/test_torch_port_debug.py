"""The port's numerical sanitizers (utils/debug.py) against the JAX package's, on the CPU.

The same numpy batches and the same weights (carried across with
``models/interop.py``) go through JAX's checkified step and the port's
checked step. A clean step must give JAX's parameters and loss within the
tolerance ``test_torch_port_train.py`` holds a train step to (f32: 1e-5),
and the port's production step's exactly; a NaN feature and an out-of-range
label, site or sex must raise with JAX's message, before the update: the
parameters and the optimizer's state stay byte-equal. ``enable_debug_nans``
names the module whose output first holds a NaN, and turning it off removes
its hooks. The training CLI's ``--debug_checks`` and ``--debug_nans`` train.
"""

import dataclasses
import functools
import io
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu.config import ModelConfig as JaxModelConfig
from toad_tpu.config import OptimConfig as JaxOptimConfig
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.train.optim import make_optimizer as jax_make_optimizer
from toad_tpu.utils import debug as jax_debug
from toad_tpu_torch.config import ModelConfig, OptimConfig
from toad_tpu_torch.models.interop import params_from_jax, params_to_jax_layout
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.train.loop import make_train_step, unpack_metrics
from toad_tpu_torch.train.optim import make_optimizer
from toad_tpu_torch.utils import debug

REPO = Path(__file__).resolve().parent.parent
DIM, N, B, C = 32, 16, 4, 5


@pytest.fixture(scope="module")
def jax_params():
    params = jax.tree.map(np.asarray, JaxToadMIL(JaxModelConfig(in_dim=DIM, n_classes=C)).init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    for lin in (*params["trunk"].values(), *params["attn"].values(), params["cls_head"], params["site_head"]):
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    return params


def _batch(seed, **bad):
    rng = np.random.default_rng(seed)
    batch = {
        "features": rng.standard_normal((B, N, DIM)).astype(np.float32),
        "patch_mask": np.ones((B, N), np.float32),
        "bag_mask": np.ones((B,), np.float32),
        "label": rng.integers(0, C, B).astype(np.int32),
        "site": rng.integers(0, 2, B).astype(np.int32),
        "sex": rng.integers(0, 2, B).astype(np.int32),
    }
    for key, (index, value) in bad.items():
        batch[key][index] = value
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(v.copy()) for k, v in batch.items()}
    out["label"], out["site"] = out["label"].long(), out["site"].long()
    return out


def _port(jax_params, opt="adam"):
    model = ToadMIL(ModelConfig(in_dim=DIM, n_classes=C))
    model.load_state_dict(params_from_jax(jax_params))
    return model, make_optimizer(OptimConfig(name=opt, lr=1e-4 if opt == "adam" else 1e-2), model.parameters())


@functools.cache
def _jax_step(opt="adam"):
    """(optax transform, JAX's checkified step), compiled once per optimizer."""
    tx = jax_make_optimizer(JaxOptimConfig(name=opt, lr=1e-4 if opt == "adam" else 1e-2))
    return tx, jax_debug.make_checked_step(JaxToadMIL(JaxModelConfig(in_dim=DIM, n_classes=C)), tx, 0.75, 0.25)


def _state_bytes(model, optimizer) -> bytes:
    buf = io.BytesIO()
    torch.save({"model": model.state_dict(), "optimizer": optimizer.state_dict()}, buf)
    return buf.getvalue()


# -- the checked step -------------------------------------------------------------


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_clean_step_matches_jax_and_the_production_step(jax_params, opt):
    tx, jax_chk = _jax_step(opt)
    p_j = jax.tree.map(jnp.asarray, jax_params)
    s_j = tx.init(p_j)
    checked, opt_c = _port(jax_params, opt)
    prod, opt_p = _port(jax_params, opt)
    chk_step = debug.make_checked_step(checked, opt_c, 0.75, 0.25)
    prod_step = make_train_step(prod, opt_p, 0.75, 0.25)
    for i in range(3):
        batch = _batch(i)
        p_j, s_j, m_j = jax_chk(p_j, s_j, jax.random.PRNGKey(i), {k: jnp.asarray(v) for k, v in batch.items()})
        got = chk_step(_torch_batch(batch), None)
        assert torch.equal(got, prod_step(_torch_batch(batch), None))  # the production step, exactly
        m = unpack_metrics(got)
        assert abs(m["loss"] - float(m_j["loss"])) < 1e-5
        np.testing.assert_array_equal(m["y_hat"], np.asarray(m_j["y_hat"]))
    for k, v in prod.state_dict().items():
        assert torch.equal(v, checked.state_dict()[k]), k
    for a, b in zip(jax.tree.leaves(params_to_jax_layout(checked)), jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


BAD_INPUTS = {
    "nan_feature": dict(features=((0, 0, 0), np.nan)),
    "label": dict(label=(2, C + 7)),
    "site": dict(site=(1, -1)),
    "sex": dict(sex=(0, 4)),
}


@pytest.mark.parametrize("case", list(BAD_INPUTS))
def test_bad_inputs_raise_with_the_jax_message(jax_params, case):
    tx, jax_chk = _jax_step()
    batch = _batch(5, **BAD_INPUTS[case])
    p_j = jax.tree.map(jnp.asarray, jax_params)
    with pytest.raises(Exception) as theirs:
        jax_chk(p_j, tx.init(p_j), jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batch.items()})
    model, optimizer = _port(jax_params)
    with pytest.raises(debug.CheckError) as ours:
        debug.make_checked_step(model, optimizer, 0.75, 0.25)(_torch_batch(batch), None)
    assert isinstance(ours.value, RuntimeError)
    assert str(theirs.value).startswith(str(ours.value)), (str(theirs.value), str(ours.value))
    assert str(theirs.value) == f"{ours.value} (`check` failed)"


def test_masked_out_bags_may_carry_garbage_labels(jax_params):
    """Padding rows (bag_mask 0) are exempt from the range checks, in both
    packages; the step is the production step's."""
    batch = _batch(4, bag_mask=(3, 0.0), label=(3, 99), site=(3, 7), sex=(3, 9))
    tx, jax_chk = _jax_step()
    p_j = jax.tree.map(jnp.asarray, jax_params)
    p_j, _, _ = jax_chk(p_j, tx.init(p_j), jax.random.PRNGKey(1), {k: jnp.asarray(v) for k, v in batch.items()})
    model, optimizer = _port(jax_params)
    prod, opt_p = _port(jax_params)
    got = debug.make_checked_step(model, optimizer, 0.75, 0.25)(_torch_batch(batch), None)  # no raise
    assert torch.equal(got, make_train_step(prod, opt_p, 0.75, 0.25)(_torch_batch(batch), None))
    for a, b in zip(jax.tree.leaves(params_to_jax_layout(model)), jax.tree.leaves(jax.tree.map(np.asarray, p_j))):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


REFUSED_SAYS = {"non-finite loss": "loss is non-finite: nan", "non-finite gradient": "non-finite gradient of attn.c.weight"}


def _refused_batch(case, model):
    if case in BAD_INPUTS:
        return _torch_batch(_batch(6, **BAD_INPUTS[case]))
    batch = _batch(8)
    if case == "non-finite loss":
        batch["features"][:] = np.finfo(np.float32).max  # finite, but the trunk's products overflow
    else:
        model.attn["c"].weight.register_hook(lambda g: g * float("nan"))
    return _torch_batch(batch)


@pytest.mark.parametrize("case", [*BAD_INPUTS, *REFUSED_SAYS])
def test_a_refused_step_leaves_parameters_and_optimizer_state_byte_equal(jax_params, case):
    model, optimizer = _port(jax_params)
    step = debug.make_checked_step(model, optimizer, 0.75, 0.25)
    step(_torch_batch(_batch(7)), None)  # Adam's moments exist
    before = _state_bytes(model, optimizer)
    bad = _refused_batch(case, model)
    with pytest.raises(debug.CheckError) as e:
        step(bad, None)
    if case in REFUSED_SAYS:
        assert str(e.value) == REFUSED_SAYS[case]
    assert _state_bytes(model, optimizer) == before


def test_a_non_finite_parameter_after_the_update_says_the_step_was_applied(jax_params):
    model, _ = _port(jax_params)
    optimizer = torch.optim.SGD(model.parameters(), lr=float("inf"))
    with pytest.raises(debug.CheckError, match=r"non-finite parameter \S+ after the update \(the step was applied\)"):
        debug.make_checked_step(model, optimizer, 0.75, 0.25)(_torch_batch(_batch(9)), None)


# -- enable_debug_nans ----------------------------------------------------------------


def _hook_count():
    from torch.nn.modules import module

    return len(module._global_forward_hooks), len(module._global_forward_pre_hooks)


def test_enable_debug_nans_names_the_module_and_false_removes_it(jax_params):
    hooks = _hook_count()
    net = torch.nn.Sequential(torch.nn.Linear(4, 8), torch.nn.ReLU(), torch.nn.Linear(8, 3))
    with torch.no_grad():
        net[2].weight[1, 2] = float("nan")
    poisoned = {**jax_params, "attn": {**jax_params["attn"], "a": {**jax_params["attn"]["a"]}}}
    poisoned["attn"]["a"]["w"] = jax_params["attn"]["a"]["w"].copy()
    poisoned["attn"]["a"]["w"][0, 0] = np.nan
    model, _ = _port(poisoned)
    model.eval()
    batch = _batch(10)
    x, mask, sex = (torch.from_numpy(batch[k]) for k in ("features", "patch_mask", "sex"))
    try:
        debug.enable_debug_nans()
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        with pytest.raises(FloatingPointError, match=r"NaN in the output of module Sequential\.2 \(Linear\)"):
            net(torch.ones(2, 4))
        net[0](torch.ones(2, 4))  # a clean module passes, and the stack of an aborted call was emptied
        with torch.inference_mode(), pytest.raises(FloatingPointError, match=r"module ToadMIL \(ToadMIL\)"):
            model(x, mask, sex, need_attention=False)  # the eval forward (K1's plain version here)
        w = torch.zeros(3, requires_grad=True)
        with pytest.raises(RuntimeError, match="returned nan values"):
            (w.sqrt() * 0).sum().backward()  # autograd's anomaly mode names the backward function
    finally:
        debug.enable_debug_nans(False)
    assert _hook_count() == hooks and not torch.is_anomaly_enabled()
    with torch.inference_mode():
        assert torch.isnan(model(x, mask, sex, need_attention=False).logits).all()  # no hook, no raise

    # the JAX package's jax_debug_nans traps the same planted NaN in the same forward
    jmodel = JaxToadMIL(JaxModelConfig(in_dim=DIM, n_classes=C))
    try:
        jax_debug.enable_debug_nans()
        with pytest.raises(FloatingPointError):
            jax.block_until_ready(jmodel.apply(jax.tree.map(jnp.asarray, poisoned), jnp.asarray(batch["features"]),
                                               jnp.asarray(batch["patch_mask"]), jnp.asarray(batch["sex"])))
    finally:
        jax_debug.enable_debug_nans(False)


# -- the trainer and the CLI ----------------------------------------------------------


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A tiny cohort with one split file, made by the port's own CLIs."""
    from toad_tpu_torch.cli import create_splits, make_dummy

    root = tmp_path_factory.mktemp("debug_cohort")
    cwd = os.getcwd()
    os.chdir(root)
    try:
        make_dummy.main(["--out_dir", ".", "--n_patients", "40", "--max_slides_per_patient", "2", "--dim", str(DIM),
                         "--min_patches", "20", "--max_patches", "200"])
        create_splits.main(["--task", "tasks/dummy_mtl_concat.json", "--k", "1", "--val_frac", "0.25",
                            "--test_frac", "0.25"])
    finally:
        os.chdir(cwd)
    return root


def _train_args(exp_code, *extra):
    return ["--task", "tasks/dummy_mtl_concat.json", "--data_root_dir", "bags", "--exp_code", exp_code, "--k", "1",
            "--max_epochs", "1", "--batch_size", "4", "--encoding_size", str(DIM), "--buckets", "256", "--lr", "1e-3",
            "--device", "cpu", *extra]


def test_fold_trainer_with_debug_checks(cohort, tmp_path):
    """cfg.debug_checks swaps in the checked step; a clean epoch trains to
    the production step's weights, bit for bit."""
    from toad_tpu_torch.config import DataConfig, TrainConfig
    from toad_tpu_torch.data.wsi_dataset import WSIBagDataset
    from toad_tpu_torch.registry import load_task
    from toad_tpu_torch.train.loop import FoldTrainer

    ds = WSIBagDataset(load_task(str(cohort / "tasks" / "dummy_mtl_concat.json")),
                       csv_path=str(cohort / "dataset_csv" / "dummy_dataset.csv"), data_dir=str(cohort / "bags"))
    splits = ds.return_splits_from_csv(cohort / "splits" / "dummy_mtl_concat_100" / "splits_0.csv")
    results = {}
    for checks in (True, False):
        cfg = TrainConfig(max_epochs=1, debug_checks=checks, model=ModelConfig(in_dim=DIM, n_classes=18),
                          data=DataConfig(batch_size=4, bucket_sizes=(64, 128, 256)))
        trainer = FoldTrainer(cfg, fold=0, results_dir=tmp_path / str(checks), device="cpu")
        assert trainer.train_step.__qualname__.startswith("make_checked_step" if checks else "make_train_step")
        results[checks] = trainer.train(*splits, log_fn=lambda s: None)
    assert np.isfinite(results[True]["cls_test_auc"])
    for k, v in results[False]["params"].items():
        assert torch.equal(v, results[True]["params"][k]), k


def test_cli_debug_checks_writes_the_same_summary(cohort, monkeypatch):
    from toad_tpu_torch.cli import train as cli_train

    monkeypatch.chdir(cohort)
    cli_train.main(_train_args("plain"))
    cli_train.main(_train_args("checked", "--debug_checks"))
    plain = (cohort / "results" / "plain_s1" / "summary.csv").read_text()
    assert plain == (cohort / "results" / "checked_s1" / "summary.csv").read_text()
    assert "'debug_checks': True" in (cohort / "results" / "checked_s1" / "experiment_checked.txt").read_text()


def test_cli_debug_nans_trains_a_clean_epoch(cohort):
    """--debug_nans is global to the process (anomaly mode, a hook on every
    module), so it runs in a child process."""
    run = subprocess.run([sys.executable, "-m", "toad_tpu_torch", "train", *_train_args("nans", "--debug_nans")],
                         cwd=cohort, capture_output=True, text=True, timeout=600,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert run.returncode == 0, run.stderr[-3000:]
    assert "epoch 0: train cls_loss" in run.stdout and (cohort / "results" / "nans_s1" / "summary.csv").exists()


def test_checked_step_config_field_matches_the_jax_default():
    from toad_tpu import config as jax_config
    from toad_tpu_torch import config

    port, ref = config.TrainConfig(), jax_config.TrainConfig()
    assert (port.debug_checks, port.profile_dir, port.rss_restart_gb) == (ref.debug_checks, ref.profile_dir,
                                                                            ref.rss_restart_gb)
    assert dataclasses.asdict(port)["debug_checks"] is False
