"""Probability calibration: top-label ECE and temperature scaling.

Counterpart of :mod:`toad_tpu.evaluate.calibration`, numpy only. TOAD's
clinical use ranks a differential by predicted probability (top-3 / top-5
assisted diagnosis), so the probabilities, not just the argmax, must be
trustworthy:

- :func:`top_label_ece`: expected calibration error over equal-width
  confidence bins (the standard reliability-diagram summary).
- :func:`fit_temperature`: single-parameter temperature scaling (Guo et al.
  2017) fitted on a held-out split by NLL. It works from probabilities:
  ``softmax(logits / T) == softmax(log softmax(logits) / T)``, so the saved
  ``p_*`` columns are enough and no logits need exporting.
- :func:`apply_temperature`: calibrated probabilities for any T.
- the ``ensemble`` variants: one temperature for a mean-of-members ensemble,
  fitted with the transform the deployed ensemble applies.

Temperature scaling never changes the argmax (a monotone transform per row),
so accuracy and top-k do not move; only confidence (and so ECE and NLL) does.
The search and its constants are the JAX package's, so both fit the same
temperature from the same probabilities.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

_EPS = 1e-12
# temperature search bounds: shared by the fits' defaults and the bound-hit
# warning of the reports, so that they cannot drift apart
T_SEARCH_LO = 0.05
T_SEARCH_HI = 20.0


def top_label_ece(probs: np.ndarray, labels: np.ndarray, n_bins: int = 15) -> float:
    """Expected calibration error of the top-label confidence.

    ECE = sum_b (|B_b|/N) * |acc(B_b) - conf(B_b)| over ``n_bins``
    equal-width confidence bins on (0, 1].
    """
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    conf = probs.max(axis=1)
    correct = (probs.argmax(axis=1) == labels).astype(np.float64)
    # bin (0,1] right-inclusive: confidence 1.0 lands in the last bin
    idx = np.minimum((conf * n_bins).astype(np.int64), n_bins - 1)
    ece = 0.0
    n = len(labels)
    for b in range(n_bins):
        in_bin = idx == b
        m = int(in_bin.sum())
        if m == 0:
            continue
        ece += (m / n) * abs(correct[in_bin].mean() - conf[in_bin].mean())
    return float(ece)


def nll(probs: np.ndarray, labels: np.ndarray) -> float:
    """Mean negative log-likelihood of the true class."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    p_true = probs[np.arange(len(labels)), labels]
    return float(-np.log(np.clip(p_true, _EPS, None)).mean())


def apply_temperature(probs: np.ndarray, temperature: float) -> np.ndarray:
    """softmax(log p / T): equivalent to softmax(logits / T) for the logits
    that produced ``probs`` (shift invariance of softmax)."""
    logp = np.log(np.clip(np.asarray(probs, np.float64), _EPS, None)) / float(temperature)
    logp -= logp.max(axis=1, keepdims=True)
    e = np.exp(logp)
    return e / e.sum(axis=1, keepdims=True)


def _golden_section_temperature(f: Callable[[float], float], lo: float, hi: float, tol: float) -> float:
    """The T in [lo, hi] minimizing ``f(log T)``, by golden-section search on
    log T (the NLL is smooth and unimodal in T for softmax families)."""
    a, b = float(np.log(lo)), float(np.log(hi))
    inv_phi = (np.sqrt(5.0) - 1.0) / 2.0
    c, d = b - inv_phi * (b - a), a + inv_phi * (b - a)
    fc, fd = f(c), f(d)
    while (b - a) > tol:
        if fc < fd:
            b, d, fd = d, c, fc
            c = b - inv_phi * (b - a)
            fc = f(c)
        else:
            a, c, fc = c, d, fd
            d = a + inv_phi * (b - a)
            fd = f(d)
    return float(np.exp((a + b) / 2.0))


def fit_temperature(
    probs: np.ndarray,
    labels: np.ndarray,
    lo: float = T_SEARCH_LO,
    hi: float = T_SEARCH_HI,
    tol: float = 1e-4,
) -> float:
    """Temperature minimizing the held-out NLL."""
    probs = np.asarray(probs, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    return _golden_section_temperature(
        lambda log_t: nll(apply_temperature(probs, float(np.exp(log_t))), labels), lo, hi, tol
    )


def _bound_warning(t: float, what: str, which: str) -> dict:
    """A near-chance model pushes T to the search bound (maximum entropy is
    NLL-optimal at chance accuracy): flagged, not silently clipped."""
    if t >= T_SEARCH_HI * 0.99 or t <= T_SEARCH_LO * 1.01:
        return {"warning": f"fitted {what} {t:.3f} hit the search bound; the {which} "
                           f"probabilities carry little usable confidence signal"}
    return {}


def calibration_report(
    val_probs: np.ndarray,
    val_labels: np.ndarray,
    eval_probs: np.ndarray,
    eval_labels: np.ndarray,
    n_bins: int = 15,
) -> dict:
    """Fit T on the val split, report ECE and NLL before and after on both splits."""
    t = fit_temperature(val_probs, val_labels)
    cal = apply_temperature(eval_probs, t)
    return _bound_warning(t, "temperature", "val") | {
        "temperature": t,
        "val_ece_before": top_label_ece(val_probs, val_labels, n_bins),
        "val_ece_after": top_label_ece(apply_temperature(val_probs, t), val_labels, n_bins),
        "ece_before": top_label_ece(eval_probs, eval_labels, n_bins),
        "ece_after": top_label_ece(cal, eval_labels, n_bins),
        "nll_before": nll(eval_probs, eval_labels),
        "nll_after": nll(cal, eval_labels),
    }


def apply_ensemble_temperature(member_probs: np.ndarray, temperature: float) -> np.ndarray:
    """Mean-of-members probabilities at temperature T, applied the way a
    deployed ensemble applies it: the temperature-scaled softmax per member,
    then the arithmetic mean. This is not the same as tempering the averaged
    probabilities (a mixture of softmaxes is not a softmax), so a fit must
    use this transform.

    ``member_probs``: [K, N, C] per-member probabilities (the fold CSVs'
    ``p_*`` columns)."""
    member_probs = np.asarray(member_probs, np.float64)
    if member_probs.ndim != 3:
        raise ValueError(f"member_probs must be [K, N, C], got {member_probs.shape}")
    return np.mean([apply_temperature(p, temperature) for p in member_probs], axis=0)


def fit_ensemble_temperature(
    member_probs: np.ndarray,
    labels: np.ndarray,
    lo: float = T_SEARCH_LO,
    hi: float = T_SEARCH_HI,
    tol: float = 1e-4,
) -> float:
    """One temperature for the whole ensemble, minimizing the held-out NLL of
    ``apply_ensemble_temperature(member_probs, T)``: the single scalar an
    ensemble deployment consumes. The same search as :func:`fit_temperature`
    (the mixture's NLL stays smooth and unimodal in T in practice)."""
    member_probs = np.asarray(member_probs, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    return _golden_section_temperature(
        lambda log_t: nll(apply_ensemble_temperature(member_probs, float(np.exp(log_t))), labels), lo, hi, tol
    )


def ensemble_calibration_report(
    member_probs: np.ndarray,
    labels: np.ndarray,
    fit_mask: np.ndarray,
    n_bins: int = 15,
) -> dict:
    """Fit one ensemble temperature on the ``fit_mask`` rows (the union of
    the folds' val slides), report ECE and NLL before and after on the full
    eval set and on the fit subset. Ensembling changes calibration (averaging
    softmaxes is typically under-confident relative to its members), so the
    per-fold temperatures do not transfer: this is the ensemble's own T."""
    member_probs = np.asarray(member_probs, np.float64)
    labels = np.asarray(labels).astype(np.int64)
    fit_mask = np.asarray(fit_mask, bool)
    if not fit_mask.any():
        raise ValueError("ensemble calibration fit_mask selects no slides")
    t = fit_ensemble_temperature(member_probs[:, fit_mask], labels[fit_mask])
    raw = apply_ensemble_temperature(member_probs, 1.0)
    cal = apply_ensemble_temperature(member_probs, t)
    report: dict = {"n_fit_slides": int(fit_mask.sum()), "n_members": int(member_probs.shape[0])}
    return report | _bound_warning(t, "ensemble temperature", "fit") | {
        "temperature": t,
        "fit_ece_before": top_label_ece(raw[fit_mask], labels[fit_mask], n_bins),
        "fit_ece_after": top_label_ece(cal[fit_mask], labels[fit_mask], n_bins),
        "ece_before": top_label_ece(raw, labels, n_bins),
        "ece_after": top_label_ece(cal, labels, n_bins),
        "nll_before": nll(raw, labels),
        "nll_after": nll(cal, labels),
    }
