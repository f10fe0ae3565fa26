"""Fold training of the PyTorch port against the JAX package, on the CPU.

The same numpy inputs and the same weights (carried across with
``models/interop.py``) go through both packages: the eval pass, the loss and
every gradient at step 0, five optimizer steps, a 3-epoch ``FoldTrainer`` run
and the CLI. Initial weights and dropout masks cannot be equal (JAX's PRNG),
so equivalence runs copy the weights and keep dropout off; the dropout path
is tested for its rate, scale, sites and reproducibility.

Tolerances: f32 1e-5 on losses, gradients and parameters after five steps
(both sides are f32 with another summation order; gradients relative to the
largest entry of each), 1e-4 on a 3-epoch run's per-epoch val loss (the
differences of about 30 Adam steps add up), probabilities 1e-5, AUCs 1e-6;
bf16 compute 2e-2 on the loss (XLA and torch round bf16 elementwise ops
differently) and 1e-1 of a gradient's largest entry on its entries.
"""

import dataclasses
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toad_tpu import config as jax_config
from toad_tpu.data import batching as jax_batching
from toad_tpu.data.wsi_dataset import WSIBagDataset as JaxDataset
from toad_tpu.evaluate import runner as jax_runner
from toad_tpu.models.toad_mil import ToadMIL as JaxToadMIL
from toad_tpu.models.torch_interop import import_torch_checkpoint
from toad_tpu.train import loop as jax_loop
from toad_tpu.train.optim import make_optimizer as jax_make_optimizer
from toad_tpu_torch import config
from toad_tpu_torch.data import batching, synthetic
from toad_tpu_torch.data.splits import generate_splits
from toad_tpu_torch.data.wsi_dataset import WSIBagDataset
from toad_tpu_torch.evaluate import metrics
from toad_tpu_torch.evaluate.runner import batch_to_dict, make_eval_step, patient_results_from_pass, run_eval_pass
from toad_tpu_torch.models.interop import optimizer_state_from_jax, params_from_jax, params_to_jax_layout
from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.train import checkpoint
from toad_tpu_torch.train.loop import (
    EarlyStopping,
    FoldTrainer,
    make_loss_fn,
    make_train_step,
    resolve_device,
    train_fold,
    unpack_metrics,
)
from toad_tpu_torch.train.optim import make_optimizer
from toad_tpu_torch.utils.logging import NullWriter, make_writer
from toad_tpu_torch.utils.rng import seed_everything

REPO = Path(__file__).resolve().parent.parent
D, N_CLS = 32, 18
BUCKETS = (64, 128, 256)


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_train")
    csv_path = root / "dummy.csv"
    manifest = synthetic.write_dummy_csv(csv_path, n_patients=36, max_slides_per_patient=1, seed=2)
    task = synthetic.dummy_task(str(csv_path))
    synthetic.write_dummy_bags(root / "bags", manifest, task, n_patches_range=(20, 250), dim=D, fmt="npy", seed=2)
    ds = WSIBagDataset(task, data_dir=str(root / "bags"))
    jds = JaxDataset(jax_config.TaskConfig(**dataclasses.asdict(task)), data_dir=str(root / "bags"))
    spec = next(generate_splits(ds.slide_cls_ids, [0] * N_CLS, [0] * N_CLS, ds.n_slides, n_splits=1, seed=1))
    ids = np.sort(spec.train)
    parts = (ids[:20], ids[20:28], ids[28:])
    return {"root": root, "task": task, "ds": ds, "jds": jds,
            "splits": tuple(ds.subset(p) for p in parts), "jax_splits": tuple(jds.subset(p) for p in parts)}


def _jax_params(compute_dtype="float32", seed=0, gate=True):
    cfg = jax_config.ModelConfig(in_dim=D, n_classes=N_CLS, compute_dtype=compute_dtype, gate=gate)
    params = jax.tree.map(np.asarray, JaxToadMIL(cfg).init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for lin in (*params["trunk"].values(), *params["attn"].values(), params["cls_head"], params["site_head"]):
        lin["b"] = (rng.standard_normal(lin["b"].shape) * 0.05).astype(np.float32)
    return cfg, params


def _port_model(params, compute_dtype="float32", dropout=False):
    model = ToadMIL(config.ModelConfig(in_dim=D, n_classes=N_CLS, compute_dtype=compute_dtype, dropout=dropout))
    model.load_state_dict(params_from_jax(params))
    return model


def _numpy_batch(seed=0, b=4, n=96, padding_bag=True):
    rng = np.random.default_rng(seed)
    batch = {
        "features": rng.standard_normal((b, n, D)).astype(np.float32),
        "patch_mask": (rng.random((b, n)) < 0.8).astype(np.float32),
        "bag_mask": np.ones((b,), np.float32),
        "label": rng.integers(0, N_CLS, (b,)).astype(np.int32),
        "site": rng.integers(0, 2, (b,)).astype(np.int32),
        "sex": rng.integers(0, 2, (b,)).astype(np.int32),
    }
    if padding_bag:  # as _assemble pads a short batch: all-zero features and masks, label 0
        batch["features"][-1] = 0.0
        batch["patch_mask"][-1] = 0.0
        batch["bag_mask"][-1] = 0.0
        batch["label"][-1] = batch["site"][-1] = batch["sex"][-1] = 0
    return batch


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["label"], out["site"] = out["label"].long(), out["site"].long()
    return out


def _assert_tree_close(port_model, jax_params, tol, what):
    ours = params_to_jax_layout(port_model)
    flat_o, tree_o = jax.tree.flatten(ours)
    flat_j, tree_j = jax.tree.flatten(jax.tree.map(np.asarray, jax_params))
    assert tree_o == tree_j
    for a, b in zip(flat_o, flat_j):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=what)


# -- step equivalence ----------------------------------------------------------


@pytest.mark.parametrize("compute_dtype,tol,grad_tol", [("float32", 1e-5, 1e-5), ("bfloat16", 2e-2, 1e-1)])
def test_loss_and_every_gradient_at_step_0(compute_dtype, tol, grad_tol):
    cfg, params = _jax_params(compute_dtype)
    batch = _numpy_batch()
    jax_loss_fn = jax_loop.make_loss_fn(JaxToadMIL(cfg), 0.75, 0.25)
    (loss_j, aux_j), grads_j = jax.value_and_grad(jax_loss_fn, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    model = _port_model(params, compute_dtype)
    loss, aux = make_loss_fn(model, 0.75, 0.25)(_torch_batch(batch), None)
    loss.backward()
    assert abs(float(loss.detach()) - float(loss_j)) < tol
    assert abs(float(aux["cls_loss"].detach()) - float(aux_j["cls_loss"])) < tol
    np.testing.assert_array_equal(aux["y_hat"].numpy()[:-1], np.asarray(aux_j["y_hat"])[:-1])
    grads = {k: p.grad for k, p in model.named_parameters()}
    want = params_from_jax(jax.tree.map(np.asarray, grads_j))
    assert set(grads) == set(want)
    # each gradient relative to its largest entry; attn.c.bias has no gradient but rounding noise (a softmax
    # does not feel a shift of its scores), so a gradient's scale is floored at 1e-3 of the largest of all.
    # bf16: the backward rounds every intermediate to bf16 in torch and only fusion results in XLA, so single
    # entries of a gradient move by several bf16 ulps of the largest: 1e-1 of it
    floor = 1e-3 * max(float(w.abs().max()) for w in want.values())
    for name, g in grads.items():
        assert torch.isfinite(g).all(), name
        scale = max(float(want[name].abs().max()), floor)
        np.testing.assert_allclose(g.numpy() / scale, want[name].numpy() / scale, atol=grad_tol, err_msg=name)


def test_batch_of_padding_bags_only_has_finite_zero_loss_and_gradients():
    _, params = _jax_params()
    batch = _numpy_batch()
    for k in ("features", "patch_mask", "bag_mask"):
        batch[k][:] = 0.0
    batch["label"][:] = 99  # an out-of-range label on a padding bag must not poison the CE
    model = _port_model(params)
    tb = _torch_batch(batch)
    tb["label"] = torch.where(tb["bag_mask"] > 0, tb["label"], 99)
    loss, _ = make_loss_fn(model, 0.75, 0.25)(tb, None)
    loss.backward()
    assert float(loss.detach()) == 0.0
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_parameters_after_five_optimizer_steps(opt):
    cfg, params = _jax_params()
    # Adam at the default learning rate: its first steps are lr * sign(g), so a gradient entry near 0 turns
    # rounding noise into a difference of the order of lr
    ocfg = jax_config.OptimConfig(name=opt, lr=1e-4 if opt == "adam" else 1e-2, weight_decay=1e-3)
    tx = jax_make_optimizer(ocfg)
    jax_step = jax_loop.make_train_step(JaxToadMIL(cfg), tx, 0.75, 0.25)
    model = _port_model(params)
    optimizer = make_optimizer(config.OptimConfig(**dataclasses.asdict(ocfg)), model.parameters())
    step = make_train_step(model, optimizer, 0.75, 0.25)
    p_j, s_j = jax.tree.map(jnp.asarray, params), tx.init(jax.tree.map(jnp.asarray, params))
    for i in range(5):
        batch = _numpy_batch(seed=i, padding_bag=i % 2 == 0)
        p_j, s_j, m_j = jax_step(p_j, s_j, jax.random.PRNGKey(i), {k: jnp.asarray(v) for k, v in batch.items()})
        m = unpack_metrics(step(_torch_batch(batch), None))
        for name in ("loss", "cls_loss_sum", "site_loss_sum", "n_bags", "cls_correct", "site_correct"):
            assert abs(m[name] - float(m_j[name])) < 1e-4, (i, name)
        np.testing.assert_array_equal(m["y_hat"][:3], np.asarray(m_j["y_hat"])[:3])
    _assert_tree_close(model, p_j, 1e-5, f"after five {opt} steps")


@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_optimizer_state_crosses_from_jax(opt):
    """Two steps in JAX, its parameters and optimizer state carried into the
    port, three more steps in both: the parameters stay equal."""
    cfg, params = _jax_params(seed=1)
    ocfg = jax_config.OptimConfig(name=opt, lr=1e-4 if opt == "adam" else 1e-2, weight_decay=1e-3)
    tx = jax_make_optimizer(ocfg)
    jax_step = jax_loop.make_train_step(JaxToadMIL(cfg), tx, 0.75, 0.25)
    p_j = jax.tree.map(jnp.asarray, params)
    s_j = tx.init(p_j)
    batches = [_numpy_batch(seed=10 + i) for i in range(5)]
    for i in range(2):
        p_j, s_j, _ = jax_step(p_j, s_j, jax.random.PRNGKey(i), {k: jnp.asarray(v) for k, v in batches[i].items()})
    model = _port_model(jax.tree.map(np.asarray, p_j))
    optimizer = make_optimizer(config.OptimConfig(**dataclasses.asdict(ocfg)), model.parameters())
    sd = optimizer.state_dict()
    sd["state"] = optimizer_state_from_jax(jax.tree.map(np.asarray, s_j), model)
    optimizer.load_state_dict(sd)
    step = make_train_step(model, optimizer, 0.75, 0.25)
    for i in range(2, 5):
        p_j, s_j, _ = jax_step(p_j, s_j, jax.random.PRNGKey(i), {k: jnp.asarray(v) for k, v in batches[i].items()})
        step(_torch_batch(batches[i]), None)
    _assert_tree_close(model, p_j, 1e-5, f"{opt} state carried across")
    with pytest.raises(ValueError, match="neither"):
        optimizer_state_from_jax((), model)


def test_params_to_jax_layout_round_trips():
    for gate in (True, False):
        _, params = _jax_params(gate=gate)
        model = ToadMIL(config.ModelConfig(in_dim=D, n_classes=N_CLS, gate=gate))
        model.load_state_dict(params_from_jax(params))
        _assert_tree_close(model, params, 0.0, "round trip")


# -- the model's training forward ----------------------------------------------


def test_dropout_rate_scale_sites_and_reproducibility():
    _, params = _jax_params()
    model = _port_model(params, dropout=True)
    x, mask = torch.randn(2, 400, D, generator=torch.Generator().manual_seed(0)), torch.ones(2, 400)
    seen = {}
    from toad_tpu_torch.models import toad_mil

    real = toad_mil._trunk_scores

    def spy(p, x_, dt, drop=None):
        def recording(site, v):
            out = drop(site, v)
            seen[site] = (v.detach(), out.detach())
            return out

        return real(p, x_, dt, drop=recording)

    toad_mil._trunk_scores = spy
    try:
        g = torch.Generator().manual_seed(5)
        state = g.get_state()
        out1 = model(x, mask, torch.zeros(2), train=True, generator=g)
        g.set_state(state)
        out2 = model(x, mask, torch.zeros(2), train=True, generator=g)
        out3 = model(x, mask, torch.zeros(2), train=True, generator=g)
    finally:
        toad_mil._trunk_scores = real
    assert sorted(seen) == [0, 1, 2, 3]  # after each trunk ReLU, after tanh, after sigmoid
    for site, (before, after) in seen.items():
        kept = after != 0
        live = before != 0
        rate = 1.0 - float((kept & live).sum()) / float(live.sum())
        assert abs(rate - 0.25) < 0.02, (site, rate)
        torch.testing.assert_close(after[kept], before[kept] / 0.75)
    assert torch.equal(out1.logits, out2.logits)  # the same generator state draws the same masks
    assert not torch.equal(out1.logits, out3.logits)
    with pytest.raises(ValueError, match="generator"):
        model(x, mask, torch.zeros(2), train=True)
    with torch.no_grad():  # eval forward: no dropout
        assert torch.equal(model(x, mask, torch.zeros(2)).logits, model(x, mask, torch.zeros(2)).logits)


def test_train_forward_without_dropout_equals_the_eval_forward():
    _, params = _jax_params()
    model = _port_model(params)
    batch = _torch_batch(_numpy_batch())
    out_t = model(batch["features"], batch["patch_mask"], batch["sex"], train=True)
    with torch.no_grad():
        out_e = model(batch["features"], batch["patch_mask"], batch["sex"])
    torch.testing.assert_close(out_t.logits, out_e.logits)
    torch.testing.assert_close(out_t.attention, out_e.attention)
    assert out_t.logits.requires_grad and model(batch["features"], batch["patch_mask"], batch["sex"], train=True,
                                                need_attention=False).attention is None


def test_kernel_operands_refuse_gradients_and_follow_in_place_updates():
    """The kernel path is forward-only, and its packed weights are re-packed
    after an optimizer step and after load_state_dict (a stale pack would
    validate old weights). Packing is plain tensor code, so this runs here;
    bf16 operands are copies of the weights (f32 ones may share their storage)."""
    cfg = config.ModelConfig(in_dim=64, n_classes=4)
    model = ToadMIL(cfg)
    with pytest.raises(RuntimeError, match="forward-only"):
        model.kernel_operands(torch.bfloat16)
    with torch.no_grad():
        first = model.kernel_operands(torch.bfloat16)
        assert model.kernel_operands(torch.bfloat16) is first  # cached while nothing moves
    opt = make_optimizer(config.OptimConfig(lr=0.1), model.parameters())
    batch = _torch_batch(_numpy_batch())
    batch["features"] = torch.randn(4, 96, 64)
    batch["label"] = batch["label"] % 4
    make_train_step(model, opt, 0.75, 0.25)(batch, None)
    with torch.no_grad():
        second = model.kernel_operands(torch.bfloat16)
        assert second is not first and not torch.equal(second.w1, first.w1)
        assert torch.equal(second.w1, model.trunk.fc1.weight.detach().bfloat16())
        model.load_state_dict(ToadMIL(cfg, generator=torch.Generator().manual_seed(9)).state_dict())
        third = model.kernel_operands(torch.bfloat16)
        assert third is not second
        assert torch.equal(third.w2, model.trunk.fc2.weight.detach().bfloat16())


# -- eval pass, metrics, early stopping ------------------------------------------


def test_run_eval_pass_matches_jax(env):
    cfg, params = _jax_params()
    kw = dict(batch_size=4, bucket_sizes=BUCKETS, mode="sequential")
    res = run_eval_pass(make_eval_step(_port_model(params).eval()), batching.BagBatcher(env["splits"][0], **kw), N_CLS, "cpu")
    want = jax_runner.run_eval_pass(jax_runner.make_eval_step(JaxToadMIL(cfg)), params,
                                    jax_batching.BagBatcher(env["jax_splits"][0], native="off", **kw), N_CLS)
    for key in ("y_prob", "site_prob"):
        np.testing.assert_allclose(res[key], want[key], atol=1e-5)
    for key in ("y_hat", "site_hat", "label", "site", "sex", "indices"):
        np.testing.assert_array_equal(res[key], want[key])
    for key in ("cls_loss", "site_loss", "cls_error", "site_error"):
        assert abs(res[key] - want[key]) < 1e-5, key
    for key in ("cls_auc", "site_auc"):
        assert abs(res[key] - want[key]) < 1e-6, key
    np.testing.assert_allclose(res["cls_aucs"], want["cls_aucs"], atol=1e-6)
    assert res["n"] == want["n"] == 20 and res["n_batches"] >= 5
    ids = [env["splits"][0].slide_ids[int(i)] for i in res["indices"]]
    ours, theirs = patient_results_from_pass(res, ids), jax_runner.patient_results_from_pass(want, ids)
    assert list(ours) == list(theirs) and ours[ids[0]]["cls_label"] == theirs[ids[0]]["cls_label"]
    # the int8 step over the int8 wire: the same pass within the quantization budget of tests/test_int8.py
    res8 = run_eval_pass(make_eval_step(_port_model(params).eval(), int8=True),
                         batching.BagBatcher(env["splits"][0], transfer_dtype="int8", **kw), N_CLS, "cpu")
    np.testing.assert_allclose(res8["y_prob"], res["y_prob"], atol=0.02)
    np.testing.assert_array_equal(res8["indices"], res["indices"])


def test_metrics_are_the_jax_package_s(env):
    from toad_tpu.evaluate import metrics as jax_metrics

    rng = np.random.default_rng(0)
    labels = rng.integers(0, 5, 200)
    probs = rng.random((200, 5))
    probs /= probs.sum(1, keepdims=True)
    assert metrics.binary_auc(labels == 1, probs[:, 1]) == jax_metrics.binary_auc(labels == 1, probs[:, 1])
    np.testing.assert_array_equal(metrics.ovr_aucs(labels, probs, 6), jax_metrics.ovr_aucs(labels, probs, 6))
    assert metrics.macro_ovr_auc(labels, probs, 5) == jax_metrics.macro_ovr_auc(labels, probs, 5)
    assert metrics.micro_ovr_auc(labels, probs, 5) == jax_metrics.micro_ovr_auc(labels, probs, 5)
    assert metrics.topk_accuracy(probs, labels) == jax_metrics.topk_accuracy(probs, labels)
    assert metrics.error_rate(probs.argmax(1), labels) == jax_metrics.error_rate(probs.argmax(1), labels)
    a, b = metrics.AccuracyLogger(5), jax_metrics.AccuracyLogger(5)
    a.log_batch(probs.argmax(1), labels)
    b.log_batch(probs.argmax(1), labels)
    assert [a.get_summary(c) for c in range(5)] == [b.get_summary(c) for c in range(5)]


def test_early_stopping_decisions_on_a_fixed_sequence():
    losses = [1.0, 0.9, 0.95, 0.9, 0.91, 0.92, 0.93, 0.5, 0.6, 0.7, 0.8]
    ours, theirs = EarlyStopping(patience=3, stop_epoch=4), jax_loop.EarlyStopping(patience=3, stop_epoch=4)
    decisions = []
    for epoch, loss in enumerate(losses):
        assert ours(epoch, loss) == theirs(epoch, loss)
        assert (ours.counter, ours.best, ours.early_stop) == (theirs.counter, theirs.best, theirs.early_stop)
        decisions.append(ours.early_stop)
    assert decisions.index(True) == 6  # three non-improvements after epoch 3, and past stop_epoch
    clone = EarlyStopping(patience=3, stop_epoch=4)
    clone.load_state_dict(ours.state_dict())
    assert (clone.counter, clone.best, clone.early_stop) == (ours.counter, ours.best, ours.early_stop)
    fresh = EarlyStopping()
    fresh.load_state_dict(EarlyStopping().state_dict())
    assert fresh.best is None


# -- the trainer ------------------------------------------------------------------


class RecordingWriter(NullWriter):
    def __init__(self):
        self.scalars = {}

    def add_scalar(self, tag, value, step):
        self.scalars.setdefault(tag, {})[step] = float(value)


def _train_cfg(module, **kw):
    base = dict(
        max_epochs=3, seed=1,
        model=module.ModelConfig(in_dim=D, n_classes=N_CLS),
        optim=module.OptimConfig(lr=1e-4),
        data=module.DataConfig(batch_size=4, bucket_sizes=BUCKETS),
    )
    base.update(kw)
    return module.TrainConfig(**base)


def test_three_epoch_trainer_matches_jax(env, tmp_path):
    _, params = _jax_params(seed=4)
    jw, pw = RecordingWriter(), RecordingWriter()
    jt = jax_loop.FoldTrainer(_train_cfg(jax_config, early_stopping=True, min_stop_epoch=0, patience=5), fold=0,
                              results_dir=tmp_path / "jax", writer=jw)
    jt.model.init = lambda key: jax.tree.map(jnp.asarray, params)  # the same initial weights on both sides
    want = jt.train(*env["jax_splits"], log_fn=lambda s: None)
    logs = []
    pt = FoldTrainer(_train_cfg(config, early_stopping=True, min_stop_epoch=0, patience=5), fold=0,
                     results_dir=tmp_path / "port", writer=pw, device="cpu")
    pt.model.load_state_dict(params_from_jax(params))
    got = pt.train(*env["splits"], log_fn=logs.append)

    assert set(pw.scalars) == set(jw.scalars)  # the TensorBoard tag schema
    for tag in ("val/cls_loss", "val/site_loss", "train/cls_loss"):
        assert sorted(pw.scalars[tag]) == [0, 1, 2]
        for epoch in range(3):
            assert abs(pw.scalars[tag][epoch] - jw.scalars[tag][epoch]) < 1e-4, (tag, epoch)
    for key in ("cls_test_auc", "cls_val_auc", "cls_test_acc", "cls_val_acc", "site_test_auc", "site_val_auc",
                "site_test_acc", "site_val_acc"):
        assert abs(got[key] - want[key]) < 1e-4, key
    assert list(got["results"]) == list(want["results"])
    np.testing.assert_allclose(got["test"]["y_prob"], want["test"]["y_prob"], atol=1e-4)
    assert (tmp_path / "port" / "splits_0.csv").read_bytes() == (tmp_path / "jax" / "splits_0.csv").read_bytes()
    # log lines: slides/s with the data-wait share, every epoch; kernel launches (none on the CPU)
    assert sum("slides/s (data wait" in line for line in logs) == 3
    assert got["eval_batches"] > 0 and got["pool_kernel_launches"] == 0
    assert any(f"eval batches {got['eval_batches']}, pooling kernel launches 0" in line for line in logs)

    # the best checkpoint is a reference-layout file that both packages read
    ckpt = tmp_path / "port" / "s_0_checkpoint.pt"
    assert ckpt == pt.ckpt_path and ckpt.exists()
    back = checkpoint.load_params_any(ckpt, pt.cfg.model)
    for k, v in pt.model.state_dict().items():
        assert torch.equal(back[k], v)
    from_jax_reader = import_torch_checkpoint(ckpt, jt.cfg.model)
    _assert_tree_close(pt.model, from_jax_reader, 0.0, "the JAX package reads the port's checkpoint")


def _dropout_cfg(**kw):
    return _train_cfg(config, max_epochs=4, resume=True, early_stopping=True, min_stop_epoch=0, patience=10,
                      model=config.ModelConfig(in_dim=D, n_classes=N_CLS, dropout=True), **kw)


class Boom(Exception):
    pass


def test_resume_after_an_interruption_equals_the_uninterrupted_run(env, tmp_path):
    straight = FoldTrainer(_dropout_cfg(), 0, tmp_path / "a", device="cpu").train(*env["splits"], log_fn=lambda s: None)

    def crashing(line):
        if "epoch 2: train" in line:
            raise Boom()

    crashed = FoldTrainer(_dropout_cfg(), 0, tmp_path / "b", device="cpu")
    with pytest.raises(Boom):
        crashed.train(*env["splits"], log_fn=crashing)
    assert crashed.resume_path.exists() and crashed.resume_path.name == "s_0_resume.pt"
    snap = checkpoint.restore_checkpoint(crashed.resume_path)
    assert snap["epoch"] == 1 and set(snap) == {"model", "optimizer", "generator", "epoch", "best_saved", "stopper"}

    logs = []
    resumed_trainer = FoldTrainer(_dropout_cfg(), 0, tmp_path / "b", device="cpu")
    resumed = resumed_trainer.train(*env["splits"], log_fn=logs.append)
    assert any("resumed from epoch 1" in line for line in logs)
    assert not resumed_trainer.resume_path.exists()  # removed once the fold is complete
    for k, v in straight["params"].items():
        assert torch.equal(v, resumed["params"][k]), k  # bit for bit: weights, Adam state, dropout stream, batch order
    assert resumed["cls_test_auc"] == straight["cls_test_auc"]
    np.testing.assert_array_equal(resumed["test"]["y_prob"], straight["test"]["y_prob"])


def test_a_failed_save_keeps_the_previous_snapshot(tmp_path, monkeypatch):
    path = tmp_path / "s_0_resume.pt"
    checkpoint.save_checkpoint(path, {"epoch": 1, "w": torch.arange(4.0)})
    real = torch.save

    def failing(obj, f, *a, **k):
        real({"partial": True}, f)  # something reaches the disk before the failure
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", failing)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_checkpoint(path, {"epoch": 2, "w": torch.zeros(4)})
    monkeypatch.setattr(torch, "save", real)
    state = checkpoint.restore_checkpoint(checkpoint.recover_checkpoint(path))
    assert state["epoch"] == 1 and torch.equal(state["w"], torch.arange(4.0))
    assert [p.name for p in tmp_path.iterdir()] == ["s_0_resume.pt"]  # no temp file left behind
    assert checkpoint.recover_checkpoint(tmp_path / "none.pt") is None
    assert checkpoint.checkpoint_name(3) == "s_3_checkpoint.pt"
    # a temp file left by a killed save is purged by the next one
    (tmp_path / ".tmp_s_0_resume.pt.deadbeef").write_bytes(b"x")
    checkpoint.save_checkpoint(path, {"epoch": 3})
    assert [p.name for p in tmp_path.iterdir()] == ["s_0_resume.pt"]


def test_trainer_options_and_device_resolution(env, tmp_path):
    cfg = _train_cfg(config, max_epochs=1, optim=config.OptimConfig(name="sgd", lr=1e-2),
                     model=config.ModelConfig(in_dim=D, n_classes=N_CLS, compute_dtype="bfloat16"),
                     data=config.DataConfig(batch_size=2, bucket_sizes=BUCKETS, weighted_sample=True, patient_bags=True))
    out = train_fold(cfg, 1, env["splits"], tmp_path, log_fn=lambda s: None, device="cpu")
    assert (tmp_path / "s_1_checkpoint.pt").exists() and np.isfinite(out["val"]["cls_loss"])
    assert all(v.dtype == torch.float32 for v in out["params"].values())  # bf16 compute keeps f32 parameters
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            FoldTrainer(cfg, 0, tmp_path)  # the card is the default; there is none here
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="device must be"):
        resolve_device("meta")
    g = seed_everything(3)
    assert isinstance(g, torch.Generator) and g.initial_seed() == 3
    assert isinstance(make_writer(None), NullWriter) and isinstance(make_writer("x", enabled=False), NullWriter)


# -- the CLI ------------------------------------------------------------------------


def _cli(*args, cwd):
    return subprocess.run([sys.executable, "-m", "toad_tpu_torch", *args], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env={**__import__("os").environ, "PYTHONPATH": str(REPO)})


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """make-dummy -> create-splits -> train through the dispatcher, on the CPU."""
    root = tmp_path_factory.mktemp("port_cli")
    made = _cli("make-dummy", "--out_dir", ".", "--n_patients", "40", "--max_slides_per_patient", "2", "--dim", str(D),
                "--min_patches", "20", "--max_patches", "200", cwd=root)
    assert made.returncode == 0, made.stderr
    split = _cli("create-splits", "--task", "tasks/dummy_mtl_concat.json", "--k", "2", "--val_frac", "0.34",
                 "--test_frac", "0.34", cwd=root)
    assert split.returncode == 0, split.stderr
    common = ["train", "--task", "tasks/dummy_mtl_concat.json", "--data_root_dir", "bags", "--exp_code", "demo", "--k", "2",
              "--max_epochs", "2", "--batch_size", "4", "--encoding_size", str(D), "--buckets", "auto", "--lr", "1e-3"]
    trained = _cli(*common, "--early_stopping", "--resume", "--device", "cpu", cwd=root)
    assert trained.returncode == 0, trained.stderr[-3000:]
    return root, common, trained


def test_cli_writes_the_jax_cli_s_artefacts(cli_run):
    root, _, trained = cli_run
    out = root / "results" / "demo_s1"
    names = {p.name for p in out.iterdir()}
    assert {"experiment_demo.txt", "summary.csv", "splits_0.csv", "splits_1.csv", "s_0_checkpoint.pt", "s_1_checkpoint.pt",
            "split_0_results.pkl", "split_1_results.pkl", "fold_0_summary.json", "fold_1_summary.json"} <= names
    assert not any(n.endswith("_resume.pt") for n in names)
    assert "auto bucket ladder" in trained.stdout and "finished! wrote" in trained.stdout
    header = (out / "summary.csv").read_text().splitlines()[0]
    assert header == ",folds,cls_test_auc,cls_val_auc,cls_test_acc,cls_val_acc,site_test_auc,site_val_auc,site_test_acc,site_val_acc"
    with open(out / "split_0_results.pkl", "rb") as f:
        results = pickle.load(f)
    first = next(iter(results.values()))
    assert set(first) == {"slide_id", "cls_prob", "cls_label", "site_prob", "site_label"} and first["cls_prob"].shape == (1, N_CLS)
    assert "'num_splits': 2" in (out / "experiment_demo.txt").read_text()
    sdir = root / "splits" / "dummy_mtl_concat_100"
    assert {p.name for p in sdir.iterdir()} == {f"splits_{i}{k}.csv" for i in (0, 1) for k in ("", "_bool", "_descriptor")}


def test_cli_layout_matches_the_jax_cli(cli_run, tmp_path, monkeypatch):
    """The JAX CLI on the port's dataset and split files: the same file
    names, the same summary.csv header, the same splits snapshot."""
    from toad_tpu.cli import create_splits as jax_create_splits
    from toad_tpu.cli import train as jax_train

    root, _, _ = cli_run
    monkeypatch.chdir(root)
    jax_create_splits.main(["--task", "tasks/dummy_mtl_concat.json", "--k", "2", "--val_frac", "0.34", "--test_frac", "0.34",
                            "--split_root", str(tmp_path / "splits")])
    for f in sorted((root / "splits" / "dummy_mtl_concat_100").iterdir()):
        assert f.read_bytes() == (tmp_path / "splits" / "dummy_mtl_concat_100" / f.name).read_bytes(), f.name
    jax_train.main(["--task", "tasks/dummy_mtl_concat.json", "--data_root_dir", "bags", "--exp_code", "demo", "--k", "2",
                    "--k_end", "1", "--max_epochs", "1", "--batch_size", "4", "--encoding_size", str(D), "--buckets", "128,256",
                    "--results_dir", str(tmp_path / "results"), "--resume"])
    jout, pout = tmp_path / "results" / "demo_s1", root / "results" / "demo_s1"
    assert (jout / "summary_partial_0_1.csv").read_text().splitlines()[0] == (pout / "summary.csv").read_text().splitlines()[0]
    assert (jout / "splits_0.csv").read_bytes() == (pout / "splits_0.csv").read_bytes()
    port_names = {p.name for p in pout.iterdir() if "_0" in p.name or p.name.startswith("experiment")}
    jax_names = {p.name for p in jout.iterdir() if not p.name.startswith("summary")}
    assert {n.replace("s_0_checkpoint.pt", "s_0_checkpoint") for n in port_names} == jax_names
    import json

    assert set(json.loads((jout / "fold_0_summary.json").read_text())) == set(json.loads((pout / "fold_0_summary.json").read_text()))


def test_cli_resume_skips_finished_folds(cli_run):
    root, common, _ = cli_run
    again = _cli(*common, "--resume", "--device", "cpu", cwd=root)
    assert again.returncode == 0, again.stderr[-2000:]
    assert again.stdout.count("already complete") == 2 and "epoch 0" not in again.stdout


@pytest.mark.parametrize("flags,says", [
    (["--data_shards", "2"], "queue 1.7"), (["--bag_shards", "4"], "queue 1.7"), (["--fold_devices", "2"], "queue 1.7"),
    (["--profile", "p"], "queue 1.6"), (["--debug_checks"], "queue 1.6"), (["--debug_nans"], "queue 1.6"),
    (["--rss_restart_gb", "4", "--resume"], "queue 1.6"),
])
def test_cli_refuses_unported_flags_by_name(flags, says):
    from toad_tpu_torch.cli import train as cli_train

    base = ["--task", "t", "--exp_code", "e"]
    args = cli_train.make_parser().parse_args([*base, *flags])
    # every flag of the JAX CLI is ported: the refusal by name is gone with the last of them
    assert not hasattr(cli_train, "refuse_unported")
    if says == "queue 1.7":  # multi-GPU is ported: the mesh and fold-device flags are now taken, not refused
        dest = flags[0][2:]
        off = cli_train.make_parser().parse_args(base)
        assert getattr(args, dest) == int(flags[1]) and getattr(off, dest) == 1
        cfg = cli_train.config_from_args(args, n_classes=18)
        assert (cfg.data_shards, cfg.bag_shards) == (args.data_shards, args.bag_shards)
        return
    assert says == "queue 1.6"  # the ops tooling is ported: its flags are taken, not refused
    dest = flags[0][2:]
    off = cli_train.make_parser().parse_args(base)
    assert getattr(args, dest) not in (None, False) and getattr(off, dest) in (None, False)
    cfg = cli_train.config_from_args(args, n_classes=18)
    assert (cfg.profile_dir, cfg.debug_checks, cfg.rss_restart_gb) == (args.profile, args.debug_checks, args.rss_restart_gb)


def test_cli_native_io_on_trains_on_npy_bags_and_logs_the_native_feed(cli_run):
    """--native_io on reads the .npy bags with the native loader, --native_io
    off with numpy: each pass logs its feed, and both train to the same
    summary.csv (the two feeds give the same bytes)."""
    root, common, _ = cli_run
    summaries = {}
    for mode, feed in (("on", "native"), ("off", "numpy")):
        run = _cli(*common, "--exp_code", f"feed_{mode}", "--max_epochs", "1", "--k_end", "1", "--native_io", mode,
                   "--device", "cpu", cwd=root)
        assert run.returncode == 0, run.stderr[-3000:]
        lines = run.stdout.splitlines()
        epoch = [ln for ln in lines if "slides/s (data wait" in ln]
        val = [ln for ln in lines if ": val cls_loss" in ln]
        final = [ln for ln in lines if "FINAL val" in ln]
        assert len(epoch) == len(val) == len(final) == 1
        assert epoch[0].endswith(f"feed {feed}") and val[0].endswith(f"| feed {feed}")
        assert final[0].endswith(f"| feed val {feed}, test {feed}")
        summaries[mode] = [f.read_text() for f in sorted((root / "results" / f"feed_{mode}_s1").glob("summary*.csv"))]
    assert len(summaries["on"]) == 1
    assert summaries["on"] == summaries["off"]


@pytest.fixture(scope="module")
def one_fold_summary(cli_run):
    """summary.csv of one fold, one epoch, trained without the XLA-only flags."""
    root, common, _ = cli_run
    run = _cli(*common, "--exp_code", "xla_plain", "--max_epochs", "1", "--k_end", "1", "--device", "cpu", cwd=root)
    assert run.returncode == 0, run.stderr[-3000:]
    assert "has no effect here" not in run.stderr
    return (root / "results" / "xla_plain_s1" / "summary_partial_0_1.csv").read_text()


@pytest.mark.parametrize("flags", [["--pallas"], ["--compile_cache", "cache"]], ids=["pallas", "compile_cache"])
def test_cli_takes_the_jax_cli_s_xla_only_flags_with_one_note(cli_run, one_fold_summary, flags):
    """--pallas and --compile_cache configure XLA in the JAX CLI: here each is
    taken, with one note on stderr, and trains to the same summary.csv."""
    root, common, _ = cli_run
    code = "xla_" + flags[0][2:]
    run = _cli(*common, "--exp_code", code, "--max_epochs", "1", "--k_end", "1", "--device", "cpu", *flags, cwd=root)
    assert run.returncode == 0, run.stderr[-3000:]
    assert run.stderr.count(f"{flags[0]} has no effect here") == 1 and run.stderr.count("has no effect here") == 1
    assert (root / "results" / f"{code}_s1" / "summary_partial_0_1.csv").read_text() == one_fold_summary
    assert not (root / "cache").exists()


def test_cli_needs_the_card_unless_the_cpu_is_asked_for(cli_run):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    root, common, _ = cli_run
    run = _cli(*common, cwd=root)
    assert run.returncode != 0 and "pass --device cpu" in run.stderr
    assert _cli("train", "--help", cwd=root).returncode == 0
