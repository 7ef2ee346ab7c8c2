"""The port's mixture fitting (utils/log_gmm.py, EM and k-means in numpy)
against the JAX package's scikit-learn fits on seeded data.

``fit_gaussian_mixture`` repeats scikit-learn's arithmetic step for step
(k-means++ draws from the same RandomState, Lloyd, EM) so on these
well-separated sets the labels agree and weights, means and covariances
are held within 1e-9 (relative, floor 1e-12), the BIC within 1e-9: k = 1
(closed form), k > 1 with as many components as clusters and more (the
empty-cluster relocation). ``fit_speaker_gmms`` picks the same BIC count,
``fit_dvector_gmms`` clamps the same way, both pickles load through
``load_gmms`` and sample draw for draw as the JAX package's LogGMMs."""

import pickle
import warnings

import numpy as np
import pytest
from sklearn.mixture import GaussianMixture as SkGaussianMixture

from lightningfastspeech2_tpu.utils.log_gmm import fit_dvector_gmms as j_fit_dvector
from lightningfastspeech2_tpu.utils.log_gmm import fit_speaker_gmms as j_fit_speaker
from lightningfastspeech2_tpu_torch.utils import log_gmm as tg

TOL = dict(rtol=1e-9, atol=1e-12)


def _close(a, b):
    for name in ("weights_", "means_", "covariances_"):
        np.testing.assert_allclose(getattr(a, name), getattr(b, name), **TOL, err_msg=name)


def _clusters(seed, k, d, n=(20, 50), spread=6.0):
    g = np.random.default_rng(seed)
    centers = g.standard_normal((k, d)) * spread
    return np.concatenate([c + g.standard_normal((int(g.integers(*n)), d)) for c in centers])


@pytest.mark.parametrize("clusters,k,d", [(1, 1, 3), (3, 3, 2), (2, 4, 4), (4, 5, 1)])
def test_gaussian_mixture_fit_matches_sklearn(clusters, k, d):
    X = _clusters(clusters * 10 + k, clusters, d)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = SkGaussianMixture(n_components=k, reg_covar=1e-3, random_state=7).fit(X)
    got = tg.fit_gaussian_mixture(X, k, reg_covar=1e-3, random_state=7)
    _close(got, ref)
    assert got.n_iter_ == ref.n_iter_ and got.converged_ == ref.converged_
    np.testing.assert_allclose(got.bic(X), ref.bic(X), rtol=1e-9)
    np.testing.assert_allclose(got.score(X), ref.score(X), rtol=1e-9)


def test_gaussian_mixture_k1_is_the_sample_moments():
    X = _clusters(2, 1, 3)
    got = tg.fit_gaussian_mixture(X, 1, reg_covar=1e-3, random_state=0)
    np.testing.assert_allclose(got.means_[0], X.mean(axis=0), rtol=1e-12)
    np.testing.assert_allclose(got.covariances_[0],
                               np.cov(X.T, bias=True) + 1e-3 * np.eye(3), rtol=1e-10)
    assert got.weights_.tolist() == [1.0]


def test_fit_raises_as_sklearn():
    with pytest.raises(ValueError):
        tg.fit_gaussian_mixture(np.ones((1, 2)), 1)
    with pytest.raises(ValueError):
        tg.fit_gaussian_mixture(np.random.default_rng(0).standard_normal((3, 2)), 4)


def _priors(seed, n_speakers=3, n=120):
    g = np.random.default_rng(seed)
    out = {}
    for s in range(n_speakers):
        c = g.integers(0, 1 + s, n)     # speaker s has s + 1 modes
        out[f"spk{s}"] = {
            "pitch": np.exp(np.array([4.5, 5.0, 5.5])[c] + 0.03 * g.standard_normal(n)),
            "energy": np.array([0.3, 1.0, 2.0])[c] + 0.05 * np.abs(g.standard_normal(n)),
            "duration": g.uniform(1.0, 3.0, n)}
    return out


def test_fit_speaker_gmms_match_jax():
    priors = _priors(0)
    names = ("pitch", "energy", "duration")
    ref = j_fit_speaker(priors, names)
    got = tg.fit_speaker_gmms(priors, names)
    assert set(got) == set(ref)
    counts = []
    for spk in ref:
        assert got[spk].gmm.means_.shape == ref[spk].gmm.means_.shape
        counts.append(len(got[spk].gmm.weights_))
        _close(got[spk].gmm, ref[spk].gmm)
        np.testing.assert_array_equal(got[spk].max_vals, ref[spk].max_vals)
        assert got[spk].logs == ref[spk].logs
        X = np.stack([priors[spk][p] for p in names], axis=1)
        np.testing.assert_allclose(got[spk].bic(X), ref[spk].bic(X), rtol=1e-9)
    assert max(counts) > 1 and min(counts) == 1
    # the pickle the port writes loads and samples draw for draw as JAX's
    loaded = tg.load_gmms(pickle.dumps(got))
    for spk in ref:
        a, _ = loaded[spk].sample(4, random_state=3)
        b, _ = ref[spk].sample(4, random_state=3)
        np.testing.assert_allclose(a, b, rtol=1e-9)


def test_fit_dvector_gmms_match_jax():
    g = np.random.default_rng(4)
    dvecs = [("a", g.standard_normal((14, 6))), ("b", g.standard_normal((4, 6)))]
    ref = dict(j_fit_dvector(dvecs))
    got = tg.fit_dvector_gmms(dvecs)
    for spk in ref:
        assert len(got[spk].gmm.weights_) == len(ref[spk].gmm.weights_)
        _close(got[spk].gmm, ref[spk].gmm)
    assert len(got["b"].gmm.weights_) == 4   # clamped to the utterance count
