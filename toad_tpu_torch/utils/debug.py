"""Numerical sanitizers: a checked train step and NaN trapping.

PyTorch counterpart of :mod:`toad_tpu.utils.debug`. The reference can only
surface an out-of-range label as a device-side assert or a silently wrong
loss (its CE calls, ``utils/core_utils_mtl_concat.py:213-214``, never
validate the label range); NaN/Inf blowups surface nowhere. Two tools, both
opt-in (no cost when off):

- :func:`enable_debug_nans`: global NaN trapping. Autograd's anomaly mode
  with ``check_nan`` names the backward function that made a NaN, and a
  global module forward hook names the first module whose output holds one.
- :func:`make_checked_step`: a drop-in replacement for
  :func:`toad_tpu_torch.train.loop.make_train_step` that checks, over the
  real bags, that labels, site and sex are in range, that the features,
  the loss and every gradient are finite, and that the parameters are
  finite after the update. It raises :class:`CheckError` with the failing
  check's text (the JAX check's own text where there is one) instead of
  training on garbage.

Enabled from the training CLI via ``--debug_checks`` / ``--debug_nans``.
"""

from __future__ import annotations

import math
import threading

import torch

from toad_tpu_torch.models.toad_mil import ToadMIL
from toad_tpu_torch.parallel.sharding import ShardedBatch
from toad_tpu_torch.train.loop import make_loss_fn, pack_step_metrics


class CheckError(RuntimeError):
    """A check of :func:`make_checked_step` failed."""


class _NanTrap:
    """The forward hook of :func:`enable_debug_nans` and the stack of modules
    being called on each thread (so that the error names a module by its
    path from the outermost module called)."""

    def __init__(self):
        self._local = threading.local()
        self._handles = ()

    def _stack(self) -> list:
        if not hasattr(self._local, "stack"):
            self._local.stack = []
        return self._local.stack

    def enable(self) -> None:
        if self._handles:
            return
        from torch.nn.modules.module import register_module_forward_hook, register_module_forward_pre_hook

        self._handles = (
            register_module_forward_pre_hook(lambda module, args: self._stack().append(module)),
            register_module_forward_hook(self._after, always_call=True),
        )

    def disable(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = ()
        self._local = threading.local()

    def _name(self) -> str:
        stack = self._stack()
        parts = [type(stack[0]).__name__]
        for parent, child in zip(stack, stack[1:]):
            name = next((n for n, m in parent.named_modules() if m is child and n), None)
            parts.append(name if name is not None else type(child).__name__)
        return ".".join(parts)

    def _after(self, module, args, output):
        stack = self._stack()
        try:
            if stack and stack[-1] is module and any(bool(torch.isnan(t).any()) for t in _float_tensors(output)):
                raise FloatingPointError(f"NaN in the output of module {self._name()} ({type(module).__name__})")
        finally:
            if stack and stack[-1] is module:
                stack.pop()


def _float_tensors(out):
    if isinstance(out, torch.Tensor):
        if out.is_floating_point():
            yield out
    elif isinstance(out, (tuple, list)):
        for o in out:
            yield from _float_tensors(o)
    elif isinstance(out, dict):
        for o in out.values():
            yield from _float_tensors(o)


_TRAP = _NanTrap()


def enable_debug_nans(enable: bool = True) -> None:
    """Trap NaNs everywhere (slow: a device sync per module call, and
    autograd's anomaly mode). Global, as ``jax_debug_nans`` is; ``False``
    removes both."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
    if enable:
        _TRAP.enable()
    else:
        _TRAP.disable()


def _features_finite(batch) -> torch.Tensor:
    """Whether every feature value of the batch is finite, on the device the
    loss runs on (a mesh's first device: each cell checks its own slice)."""
    if isinstance(batch, ShardedBatch):
        primary = batch.mesh.primary
        return torch.stack([torch.isfinite(c["features"]).all().to(primary) for row in batch.cells for c in row]).all()
    return torch.isfinite(batch["features"]).all()


def make_checked_step(model: ToadMIL, optimizer: torch.optim.Optimizer, cls_w: float, site_w: float):
    """Checked analog of ``make_train_step``. Same call signature and return
    value; raises :class:`CheckError` instead of proceeding.

    The step updates its state in place, so every check on the inputs, the
    loss and the gradients runs before ``optimizer.step()``: a refused step
    leaves the parameters and the optimizer's state as they were. Those
    checks come to the host in one device-to-host copy; the parameters'
    finiteness after the update in a second. This is a debugging mode, not
    the production step.
    """
    loss_fn = make_loss_fn(model, cls_w, site_w)
    n_classes = model.config.n_classes
    n_site = model.config.n_site_classes
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]

    def step(batch: dict[str, torch.Tensor], generator: torch.Generator | None) -> torch.Tensor:
        label, site, sex = batch["label"], batch["site"], batch["sex"]
        padding = ~(batch["bag_mask"] > 0)
        with torch.no_grad():
            inputs_ok = torch.stack([
                (padding | ((label >= 0) & (label < n_classes))).all(),
                (padding | ((site >= 0) & (site < n_site))).all(),
                (padding | (sex == 0) | (sex == 1)).all(),
                _features_finite(batch),
            ])
            ranges = torch.stack([t.double() for t in (label.min(), label.max(), site.min(), site.max(), sex.min(), sex.max())])
        # the loss sees the labels clamped into range: a class index out of range is a device-side assert
        # in CUDA's cross entropy, which would end the process before the check could name it; where the
        # checks pass, the clamped labels are the batch's own
        clamped = {"label": label.clamp(0, n_classes - 1), "site": site.clamp(0, n_site - 1)}
        safe = batch.replace(**clamped) if isinstance(batch, ShardedBatch) else {**batch, **clamped}
        optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(safe, generator)
        loss.backward()
        with torch.no_grad():
            grads_ok = torch.stack([torch.isfinite(p.grad).all() if p.grad is not None else torch.ones((), dtype=torch.bool,
                                    device=p.device) for _, p in named])
            host = torch.cat([inputs_ok.double(), ranges, loss.detach().double()[None], grads_ok.double()]).cpu()
        ok, (lo_l, hi_l, lo_s, hi_s, lo_x, hi_x), loss_v = host[:4], host[4:10].long().tolist(), float(host[10])
        if not ok[0]:
            raise CheckError(f"origin label out of range [0, {n_classes}): min {lo_l}, max {hi_l}")
        if not ok[1]:
            raise CheckError(f"site label out of range [0, {n_site}): min {lo_s}, max {hi_s}")
        if not ok[2]:
            raise CheckError(f"sex must be 0/1: min {lo_x}, max {hi_x}")
        if not ok[3]:
            raise CheckError("non-finite feature values in batch")
        if not math.isfinite(loss_v):
            raise CheckError(f"loss is non-finite: {loss_v}")
        bad = [n for (n, _), g_ok in zip(named, host[11:]) if not g_ok]
        if bad:
            raise CheckError(f"non-finite gradient of {bad[0]}" + (f" (and {len(bad) - 1} more)" if len(bad) > 1 else ""))
        optimizer.step()
        with torch.no_grad():
            params_ok = torch.stack([torch.isfinite(p).all() for _, p in named]).cpu()
        bad = [n for (n, _), p_ok in zip(named, params_ok) if not p_ok]
        if bad:
            raise CheckError(f"non-finite parameter {bad[0]} after the update (the step was applied)")
        return pack_step_metrics(loss, aux, batch)

    return step
