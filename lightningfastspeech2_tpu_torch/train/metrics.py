"""Evaluation metrics: Jensen-Shannon divergence, MAE, MCD, soft-DTW.

Counterpart of ``lightningfastspeech2_tpu/train/metrics.py`` (reference
epoch-end eval, ``fastspeech2.py:1017-1163``), with the same metric names
(``eval/jensenshannon_*``, ``eval/mae_*``, ``eval/softdtw_mel*``,
``eval/mcd_mel``). The JAX package estimates the densities with
scikit-learn's ``KernelDensity``; here the same Gaussian kernel density is
the log of the mean of the kernels (``scipy.special.logsumexp``), so no
scikit-learn is needed. Everything runs on the host in numpy; the mel
soft-DTW goes through ``native/softdtw.cpp``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
from scipy.spatial.distance import jensenshannon
from scipy.special import logsumexp

from lightningfastspeech2_tpu_torch.native import softdtw_cpu


def kde_log_density(samples: np.ndarray, grid: np.ndarray, bandwidth: float) -> np.ndarray:
    """log of the Gaussian kernel density of 1-D ``samples`` at ``grid``:
    ``KernelDensity(bandwidth).fit(samples).score_samples(grid)``."""
    samples = np.asarray(samples, np.float64).reshape(-1)
    grid = np.asarray(grid, np.float64).reshape(-1)
    z = (grid[:, None] - samples[None, :]) / bandwidth
    log_norm = -0.5 * np.log(2.0 * np.pi) - np.log(bandwidth)
    return logsumexp(-0.5 * z * z, axis=1) + log_norm - np.log(len(samples))


def kde_jensen_shannon(pred: np.ndarray, truth: np.ndarray,
                       bandwidth: float = 0.1, n_points: int = 500,
                       seed: int = 0) -> float:
    """JS divergence between KDE density estimates of two samples on a
    200-point grid over their joint range (fastspeech2.py:1024-1045), each
    sample subsampled to ``n_points`` with ``default_rng(seed)``."""
    pred = np.asarray(pred, np.float64).reshape(-1)
    truth = np.asarray(truth, np.float64).reshape(-1)
    if len(pred) == 0 or len(truth) == 0:
        return float("nan")
    rng = np.random.default_rng(seed)
    if len(pred) > n_points:
        pred = pred[rng.choice(len(pred), n_points, replace=False)]
    if len(truth) > n_points:
        truth = truth[rng.choice(len(truth), n_points, replace=False)]
    grid = np.linspace(min(pred.min(), truth.min()), max(pred.max(), truth.max()), 200)
    p = np.exp(kde_log_density(pred, grid, bandwidth))
    q = np.exp(kde_log_density(truth, grid, bandwidth))
    return float(jensenshannon(p, q))


def masked_mae(pred: np.ndarray, truth: np.ndarray,
               mask: Optional[np.ndarray] = None) -> float:
    pred = np.asarray(pred, np.float64)
    truth = np.asarray(truth, np.float64)
    err = np.abs(pred - truth)
    if mask is not None:
        mask = np.broadcast_to(np.asarray(mask, bool), err.shape[:mask.ndim])
        while mask.ndim < err.ndim:
            mask = mask[..., None]
        mask = np.broadcast_to(mask, err.shape)
        if mask.sum() == 0:
            return float("nan")
        return float(err[mask].mean())
    return float(err.mean())


def mel_cepstral_distortion(pred_mel: np.ndarray, true_mel: np.ndarray,
                            n_coeffs: int = 13) -> float:
    """Cepstral distance (dB) between frame-aligned log10-mel spectrograms
    (T, n_mels): Kubichek's formula on DCT-II cepstra c1..c{n_coeffs} of the
    ln-mel spectrum, CD = mean_t (10 / ln 10) sqrt(2 sum_k dc_k^2). From the
    80-band log-mel on the teacher-forced grid, without DTW: a relative
    trend, not comparable to literature MCD."""
    n_mels = pred_mel.shape[-1]
    k = np.arange(1, n_coeffs + 1)[:, None]
    n = np.arange(n_mels)[None, :]
    basis = np.sqrt(2.0 / n_mels) * np.cos(np.pi * (n + 0.5) * k / n_mels)
    ln10 = np.log(10.0)
    dc = (pred_mel - true_mel) * ln10 @ basis.T
    return float(np.mean((10.0 / ln10) * np.sqrt(2.0 * np.sum(dc ** 2, axis=-1))))


def eval_metrics(results: Dict[str, List[np.ndarray]], variances) -> Dict[str, float]:
    """Aggregate eval metrics from accumulated per-batch arrays: ``{var}_pred``
    (inference), ``{var}_pred_tf`` (teacher-forced, on the target's grid),
    ``{var}_true``, ``duration_pred`` / ``duration_true`` (flat arrays), and
    ``mel_pred`` / ``mel_true`` (lists of (T, 80) mels)."""
    out: Dict[str, float] = {}
    for var in list(variances) + ["duration"]:
        pk, tk = f"{var}_pred", f"{var}_true"
        if not results.get(pk):
            continue
        pred = np.concatenate([np.ravel(a) for a in results[pk]])
        true = np.concatenate([np.ravel(a) for a in results[tk]])
        out[f"eval/jensenshannon_{var}"] = kde_jensen_shannon(pred, true)
        # MAE on the teacher-forced predictions where there are any: they
        # share the target's frame grid (fastspeech2.py:1024-1056)
        if results.get(f"{var}_pred_tf"):
            pred_m = np.concatenate([np.ravel(a) for a in results[f"{var}_pred_tf"]])
        else:
            pred_m = pred
        n = min(len(pred_m), len(true))
        out[f"eval/mae_{var}"] = masked_mae(pred_m[:n], true[:n])
    if results.get("mel_pred"):
        js, dtw1, dtw3, mae, mcd = [], [], [], [], []
        for p, t in zip(results["mel_pred"], results["mel_true"]):
            n = min(len(p), len(t))
            if n == 0:
                continue
            js.append(kde_jensen_shannon(p[:n].ravel(), t[:n].ravel()))
            dtw1.append(softdtw_cpu(p[:n], t[:n], gamma=1.0, normalize=True))
            dtw3.append(softdtw_cpu(p[:n], t[:n], gamma=0.001, normalize=True))
            mae.append(np.abs(p[:n] - t[:n]).mean())
            mcd.append(mel_cepstral_distortion(p[:n], t[:n]))
        if js:
            out["eval/jensenshannon_mel"] = float(np.nanmean(js))
            out["eval/softdtw_mel"] = float(np.mean(dtw1))
            out["eval/softdtw_mel_fine"] = float(np.mean(dtw3))
            out["eval/mae_mel"] = float(np.mean(mae))
            out["eval/mcd_mel"] = float(np.mean(mcd))
    return out


class VarianceEarlyStopping:
    """Per-variance early stopping and freezing (reference
    ``fastspeech2.py:141-147,1057-1115``): track a metric (mae | js) per
    variance; when it has not improved for ``patience`` evals, freeze that
    encoder (the train step's ``frozen``) and queue its best snapshot in
    ``pending_restore`` for the trainer to write back."""

    def __init__(self, variances, mode: str = "mae", patience: int = 4):
        if mode not in ("mae", "js", "none"):
            raise ValueError(f"variance early stopping mode {mode!r}: mae, js or none")
        self.mode = mode
        self.patience = patience
        self.best: Dict[str, float] = {v: float("inf") for v in variances}
        self.best_params: Dict[str, object] = {}
        self.stale: Dict[str, int] = {v: 0 for v in variances}
        self.frozen: List[str] = []
        self.pending_restore: Dict[str, object] = {}

    def update(self, metrics: Dict[str, float], params_per_variance) -> List[str]:
        """``params_per_variance``: {var: encoder snapshot}. Returns the
        (possibly grown) frozen list."""
        if self.mode == "none":
            return self.frozen
        key = "mae" if self.mode == "mae" else "jensenshannon"
        for var in list(self.best):
            if var in self.frozen:
                continue
            value = metrics.get(f"eval/{key}_{var}")
            if value is None or not np.isfinite(value):
                continue
            if value < self.best[var]:
                self.best[var] = value
                self.best_params[var] = params_per_variance.get(var)
                self.stale[var] = 0
            else:
                self.stale[var] += 1
                if self.stale[var] >= self.patience:
                    self.frozen.append(var)
                    if self.best_params.get(var) is not None:
                        self.pending_restore[var] = self.best_params[var]
        return self.frozen

    def pop_restores(self) -> Dict[str, object]:
        out, self.pending_restore = self.pending_restore, {}
        return out
