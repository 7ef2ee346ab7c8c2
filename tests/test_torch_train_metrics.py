"""The port's eval metrics (train/metrics.py, native/softdtw.cpp) against the
JAX package's on the same seeded arrays: the KDE Jensen-Shannon divergence
(scikit-learn's KernelDensity there, a logsumexp of Gaussian kernels here),
MCD, masked MAE, the native soft-DTW value and gradient, ``eval_metrics``
key for key, and ``VarianceEarlyStopping`` over a sequence of evals.

Tolerances: the float64 soft-DTW recursions are the same C++ source, so
equal; the KDE density is the same sum in another order (rtol 1e-9 on the
JS value); the rest is the same numpy arithmetic (equal)."""

import numpy as np
import pytest

from lightningfastspeech2_tpu.native import softdtw_cpu as j_softdtw_cpu
from lightningfastspeech2_tpu.native import softdtw_grad_cpu as j_softdtw_grad_cpu
from lightningfastspeech2_tpu.train import metrics as jm
from lightningfastspeech2_tpu_torch.native import softdtw_cpu, softdtw_grad_cpu
from lightningfastspeech2_tpu_torch.train import metrics as tm


def _arrays(seed, n=700):
    g = np.random.default_rng(seed)
    return g.standard_normal(n) * 0.7 + 0.2, g.standard_normal(n - 123) * 0.5


@pytest.mark.parametrize("seed", [0, 1])
def test_kde_jensen_shannon_matches_jax(seed):
    pred, truth = _arrays(seed)
    for a, b in ((pred, truth), (pred[:50], truth[:80]), (pred[:3], truth)):
        np.testing.assert_allclose(tm.kde_jensen_shannon(a, b), jm.kde_jensen_shannon(a, b),
                                   rtol=1e-9, atol=1e-12)
    assert np.isnan(tm.kde_jensen_shannon(pred[:0], truth))


def test_kde_log_density_is_sklearns():
    from sklearn.neighbors import KernelDensity

    g = np.random.default_rng(3)
    x, grid = g.standard_normal(200), np.linspace(-3, 3, 50)
    ref = KernelDensity(bandwidth=0.1).fit(x[:, None]).score_samples(grid[:, None])
    np.testing.assert_allclose(tm.kde_log_density(x, grid, 0.1), ref, rtol=1e-10)


def test_mcd_mae_and_soft_dtw_match_jax():
    g = np.random.default_rng(5)
    p, t = g.standard_normal((37, 80)), g.standard_normal((41, 80))
    assert tm.mel_cepstral_distortion(p, t[:37]) == jm.mel_cepstral_distortion(p, t[:37])
    mask = g.random(37) > 0.3
    assert tm.masked_mae(p, t[:37], mask) == jm.masked_mae(p, t[:37], mask)
    assert tm.masked_mae(p, t[:37]) == jm.masked_mae(p, t[:37])
    assert np.isnan(tm.masked_mae(p, t[:37], np.zeros(37, bool)))
    for gamma, norm in ((1.0, True), (0.001, True), (0.1, False)):
        assert softdtw_cpu(p, t, gamma, norm) == j_softdtw_cpu(p, t, gamma, norm)
    v, e = softdtw_grad_cpu(p[:9], t[:12], 0.5)
    jv, je = j_softdtw_grad_cpu(p[:9], t[:12], 0.5)
    assert v == jv
    np.testing.assert_array_equal(e, je)


def _results(seed):
    g = np.random.default_rng(seed)
    out = {}
    for var in ("pitch", "energy", "duration"):
        out[f"{var}_pred"] = [g.standard_normal(n) for n in (300, 410)]
        out[f"{var}_true"] = [g.standard_normal(n) for n in (300, 400)]
    out["energy_pred_tf"] = [g.standard_normal(n) for n in (300, 400)]
    out["mel_pred"] = [g.standard_normal((t, 80)) * 0.5 - 4 for t in (40, 33, 0)]
    out["mel_true"] = [g.standard_normal((t, 80)) * 0.5 - 4 for t in (40, 35, 0)]
    return out


def test_eval_metrics_match_jax():
    res = _results(7)
    got = tm.eval_metrics(res, ("pitch", "energy", "snr"))
    ref = jm.eval_metrics(res, ("pitch", "energy", "snr"))
    assert set(got) == set(ref) and "eval/softdtw_mel_fine" in got and "eval/mae_snr" not in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-9, err_msg=k)


def test_variance_early_stopping_sequence_matches_jax():
    names = ("pitch", "energy")
    seq = [{"eval/mae_pitch": 1.0, "eval/mae_energy": 2.0},
           {"eval/mae_pitch": 0.8, "eval/mae_energy": 2.5},
           {"eval/mae_pitch": 0.9, "eval/mae_energy": float("nan")},
           {"eval/mae_pitch": 0.95, "eval/mae_energy": 2.6},
           {"eval/mae_pitch": 0.7, "eval/mae_energy": 2.7}]
    for mode in ("mae", "js", "none"):
        a, b = tm.VarianceEarlyStopping(names, mode, 2), jm.VarianceEarlyStopping(names, mode, 2)
        for i, m in enumerate(seq):
            if mode == "js":
                m = {k.replace("mae", "jensenshannon"): v for k, v in m.items()}
            snaps = {v: f"{v}@{i}" for v in names}
            assert a.update(m, snaps) == b.update(m, snaps)
            assert a.pop_restores() == b.pop_restores()
            assert a.stale == b.stale and a.best == b.best
    assert a.frozen == [] and tm.VarianceEarlyStopping(names, "mae", 2).update(seq[0], {}) == []
    with pytest.raises(ValueError):
        tm.VarianceEarlyStopping(names, "mse")
