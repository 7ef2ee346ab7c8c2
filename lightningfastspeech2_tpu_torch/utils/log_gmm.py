"""Log-space Gaussian mixtures over utterance priors and d-vectors: fitting
and sampling.

Counterpart of ``lightningfastspeech2_tpu/utils/log_gmm.py``. The JAX
package fits its mixtures with scikit-learn and pickles them
(``prior_gmms.pkl``, ``dvector_gmms.pkl``); this module fits, reads those
pickles and samples without scikit-learn.

Fitting (``fit_speaker_gmms``, ``fit_dvector_gmms``) is scikit-learn's
``GaussianMixture(n_components=k, reg_covar=r, random_state=seed).fit(X)``
as it runs by default, written in numpy: full covariances, ``tol=1e-3``,
``max_iter=100``, ``n_init=1``, responsibilities first set from the labels
of one ``KMeans(n_clusters=k, n_init=1)`` (k-means++ seeding with
``2 + int(log k)`` local trials on the centred data, then Lloyd's
iterations to ``tol=1e-4`` of the mean variance), both drawing from one
``RandomState(seed)`` in the same order. Sampling is ``GaussianMixture.sample``
draw for draw: ``check_random_state(random_state)``, one ``multinomial`` for
the component counts, then one ``multivariate_normal`` per component,
stacked. Only ``covariance_type="full"``, the one LogGMM builds, is
supported.

``load_gmms`` restores the pickled ``LogGMM`` and ``GaussianMixture``
objects (either package's) as the plain classes below and refuses any other
global than numpy's array reconstructors.
"""

from __future__ import annotations

import io
import numbers
import pickle
from pathlib import Path
from typing import Dict, Iterable, Optional, Sequence, Tuple, Union

import numpy as np
from scipy.linalg import cholesky, solve_triangular
from scipy.special import logsumexp


def check_random_state(seed) -> np.random.RandomState:
    """scikit-learn's ``check_random_state`` for what a loaded mixture can
    hold: None -> numpy's global RandomState, an int -> a new
    RandomState(seed)."""
    if seed is None:
        return np.random.mtrand._rand
    if isinstance(seed, numbers.Integral):
        return np.random.RandomState(seed)
    raise ValueError(f"{seed!r} cannot be used to seed a numpy.random.RandomState instance")


class GaussianMixture:
    """The fitted state of a scikit-learn ``GaussianMixture`` (``weights_``,
    ``means_``, ``covariances_``, ``covariance_type``, ``random_state``),
    restored from its pickled ``__dict__``, with its ``sample``."""

    def __init__(self, weights, means, covariances, random_state=None):
        self.weights_ = np.asarray(weights, np.float64)
        self.means_ = np.asarray(means, np.float64)
        self.covariances_ = np.asarray(covariances, np.float64)
        self.random_state = random_state
        self.covariance_type = "full"

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)

    def sample(self, n_samples: int = 1):
        if n_samples < 1:
            raise ValueError(f"invalid n_samples {n_samples}: at least one sample is needed")
        if self.covariance_type != "full":
            raise NotImplementedError(
                f"covariance_type {self.covariance_type!r}: only 'full' (what LogGMM "
                "fits) is supported")
        rng = check_random_state(self.random_state)
        n_samples_comp = rng.multinomial(n_samples, self.weights_)
        X = np.vstack([
            rng.multivariate_normal(mean, cov, int(n))
            for mean, cov, n in zip(self.means_, self.covariances_, n_samples_comp)])
        y = np.concatenate([np.full(n, j, dtype=int) for j, n in enumerate(n_samples_comp)])
        return X, y

    def score_samples(self, X) -> np.ndarray:
        """Log-likelihood of each row of ``X`` under the mixture."""
        return logsumexp(_weighted_log_prob(np.asarray(X, np.float64), self.weights_,
                                            self.means_, _precisions_chol(self.covariances_)),
                         axis=1)

    def score(self, X) -> float:
        return float(np.mean(self.score_samples(X)))

    def bic(self, X) -> float:
        """-2 n score + (free parameters) log n, as scikit-learn's ``bic``."""
        X = np.asarray(X, np.float64)
        k, d = self.means_.shape
        n_params = int(k * d * (d + 1) / 2.0 + d * k + k - 1)
        return float(-2 * self.score(X) * X.shape[0] + n_params * np.log(X.shape[0]))


class LogGMM:
    """A GaussianMixture over max-scaled features (+eps), ``logs`` dims
    log-transformed; samples are mapped back through exp / scale."""

    def __init__(self, gmm: GaussianMixture, max_vals, logs: Sequence[int] = (),
                 eps: float = 1e-10):
        self.gmm = gmm
        self.max_vals = np.asarray(max_vals, np.float64)
        self.logs = list(logs)
        self.eps = eps

    def __setstate__(self, state: dict) -> None:
        self.__dict__.update(state)

    def transform(self, X) -> np.ndarray:
        """Features into the mixture's space: max-scaled (+eps), ``logs``
        dims log-transformed."""
        X = np.array(X, dtype=np.float64, copy=True) / self.max_vals + self.eps
        for i in self.logs:
            X[:, i] = np.log(X[:, i])
        return X

    def bic(self, X) -> float:
        return self.gmm.bic(self.transform(X))

    def sample(self, n_samples: int = 1, random_state: Optional[int] = None):
        if random_state is not None:
            self.gmm.random_state = random_state
            np.random.seed(random_state)
        X, comp = self.gmm.sample(n_samples)
        X = np.array(X)
        for i in range(X.shape[1]):
            if i in self.logs:
                X[:, i] = (np.exp(X[:, i]) - self.eps) * self.max_vals[i]
            else:
                X[:, i] = (X[:, i] - self.eps) * self.max_vals[i]
        return X, comp


def _numpy_globals() -> Dict[tuple, object]:
    """The reconstructors numpy's pickles of arrays, dtypes and scalars
    name, under both of numpy's module paths (``numpy.core`` before 2.0,
    ``numpy._core`` since), taken from numpy's own reductions."""
    recon = np.zeros(1).__reduce__()[0]           # multiarray._reconstruct
    scalar = np.float64(0).__reduce__()[0]        # multiarray.scalar
    frombuffer = np.zeros(1).__reduce_ex__(5)[0]  # numeric._frombuffer (protocol 5)
    out = {("numpy", "ndarray"): np.ndarray, ("numpy", "dtype"): np.dtype}
    for core in ("numpy.core", "numpy._core"):
        out[(f"{core}.multiarray", "_reconstruct")] = recon
        out[(f"{core}.multiarray", "scalar")] = scalar
        out[(f"{core}.numeric", "_frombuffer")] = frombuffer
    return out


_CLASSES = {
    ("lightningfastspeech2_tpu.utils.log_gmm", "LogGMM"): LogGMM,
    ("lightningfastspeech2_tpu_torch.utils.log_gmm", "LogGMM"): LogGMM,
    ("lightningfastspeech2_tpu_torch.utils.log_gmm", "GaussianMixture"): GaussianMixture,
    ("sklearn.mixture._gaussian_mixture", "GaussianMixture"): GaussianMixture,
}


class _GMMUnpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        cls = _CLASSES.get((module, name)) or _numpy_globals().get((module, name))
        if cls is None:
            raise pickle.UnpicklingError(
                f"refusing to load global {module}.{name} from a GMM pickle")
        return cls


def load_gmms(path: Union[str, Path, bytes]) -> Dict[str, LogGMM]:
    """``{speaker: LogGMM}`` from a pickle that the JAX trainer wrote (or
    one of this module's LogGMMs); ``path`` may also be the pickle's
    bytes."""
    data = path if isinstance(path, bytes) else Path(path).read_bytes()
    return _GMMUnpickler(io.BytesIO(data)).load()


def make_log_gmm(weights, means, covariances, max_vals, logs: Sequence[int] = (),
                 eps: float = 1e-10, random_state: Optional[int] = 0) -> LogGMM:
    """A LogGMM from its parameters in the transformed space (weights (k,),
    means (k, d), full covariances (k, d, d)); for mixtures that were not
    fitted here, as on a machine without scikit-learn."""
    return LogGMM(GaussianMixture(weights, means, covariances, random_state),
                  max_vals, logs, eps)



# ---------------------------------------------------------------------------
# fitting: scikit-learn's GaussianMixture(...).fit(X) defaults, in numpy
# ---------------------------------------------------------------------------

_ILL_DEFINED = ("Fitting the mixture model failed because some components have ill-defined "
                "empirical covariance (for instance caused by singleton or collapsed samples). "
                "Try to decrease the number of components, increase reg_covar, or scale the "
                "input data.")


def _sq_distances(A: np.ndarray, X: np.ndarray, x_sq: np.ndarray) -> np.ndarray:
    """(len(A), len(X)) squared Euclidean distances as scikit-learn's
    ``_euclidean_distances`` forms them: -2 A X^T + |a|^2 + |x|^2, clipped at 0."""
    d = -2 * (A @ X.T)
    d += np.einsum("ij,ij->i", A, A)[:, None]
    d += x_sq[None, :]
    np.maximum(d, 0, out=d)
    return d


def _kmeans_plusplus(X: np.ndarray, k: int, rs: np.random.RandomState) -> np.ndarray:
    """k-means++ seeding (``sklearn.cluster._kmeans._kmeans_plusplus`` with
    unit sample weights): the first centre drawn from ``rs.choice``, each
    next one the best of ``2 + int(log k)`` candidates drawn by potential."""
    n = X.shape[0]
    x_sq = np.einsum("ij,ij->i", X, X)
    w = np.ones(n)
    n_local_trials = 2 + int(np.log(k))
    centers = np.empty((k, X.shape[1]))
    centers[0] = X[rs.choice(n, p=w / w.sum())]
    closest = _sq_distances(centers[:1], X, x_sq)
    pot = closest @ w
    for c in range(1, k):
        rand_vals = rs.uniform(size=n_local_trials) * pot
        cand = np.searchsorted(np.cumsum(w * closest), rand_vals)
        np.clip(cand, None, closest.size - 1, out=cand)
        dist = _sq_distances(X[cand], X, x_sq)
        np.minimum(closest, dist, out=dist)
        cand_pot = dist @ w.reshape(-1, 1)
        best = int(np.argmin(cand_pot))
        pot = cand_pot[best]
        closest = dist[best]
        centers[c] = X[cand[best]]
    return centers


def _assign(X: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """Nearest centre of each row by |c|^2 - 2 x.c (Lloyd's E-step)."""
    d = np.einsum("ij,ij->i", centers, centers)[None, :] - 2 * (X @ centers.T)
    return np.argmin(d, axis=1)


def kmeans_labels(X: np.ndarray, k: int, rs: np.random.RandomState,
                  max_iter: int = 300, tol: float = 1e-4) -> np.ndarray:
    """Labels of ``KMeans(n_clusters=k, n_init=1, random_state=rs).fit(X)``:
    k-means++ on the centred data, then Lloyd's iterations until the labels
    repeat or the centres move less than ``tol`` times the mean variance
    (empty clusters take the points farthest from their centres)."""
    X = np.asarray(X, np.float64)
    tol = float(np.mean(np.var(X, axis=0)) * tol)
    X = X - X.mean(axis=0)
    centers = _kmeans_plusplus(X, k, rs)
    labels_old = np.full(X.shape[0], -1)
    strict = False
    for _ in range(max_iter):
        labels = _assign(X, centers)
        sums = np.zeros_like(centers)
        np.add.at(sums, labels, X)
        weight = np.bincount(labels, minlength=k).astype(np.float64)
        empty = np.where(weight == 0)[0]
        if len(empty):
            dist = ((X - centers[labels]) ** 2).sum(axis=1)
            if dist.max() > 0:
                far = np.argpartition(dist, -len(empty))[:-len(empty) - 1:-1]
                for new_id, idx in zip(empty, far):
                    old_id = labels[idx]
                    sums[old_id] -= X[idx]
                    sums[new_id] = X[idx]
                    weight[new_id] = 1.0
                    weight[old_id] -= 1.0
        new = sums.copy()
        nz = weight > 0
        new[nz] *= (1.0 / weight[nz])[:, None]
        shift = ((new - centers) ** 2).sum()
        centers = new
        if np.array_equal(labels, labels_old):
            strict = True
            break
        if shift <= tol:
            break
        labels_old = labels
    if not strict:
        labels = _assign(X, centers)
    return labels


def _precisions_chol(covariances: np.ndarray) -> np.ndarray:
    """Cholesky factors of the precisions, from each covariance's lower
    Cholesky factor; ValueError where a covariance is not positive definite."""
    out = np.empty_like(covariances)
    eye = np.eye(covariances.shape[1])
    for k, cov in enumerate(covariances):
        try:
            chol = cholesky(cov, lower=True)
        except np.linalg.LinAlgError:
            raise ValueError(_ILL_DEFINED) from None
        out[k] = solve_triangular(chol, eye, lower=True).T
    return out


def _weighted_log_prob(X, weights, means, prec_chol) -> np.ndarray:
    """log N(x | mu_k, Sigma_k) + log w_k, (n, k)."""
    n, d = X.shape
    log_det = np.log(prec_chol.reshape(len(means), -1)[:, :: d + 1]).sum(axis=1)
    sq = np.empty((n, len(means)))
    for k, (mu, pc) in enumerate(zip(means, prec_chol)):
        y = X @ pc - mu @ pc
        sq[:, k] = np.sum(np.square(y), axis=1)
    return -0.5 * (d * np.log(2 * np.pi) + sq) + log_det + np.log(weights)


def _gaussian_params(X, resp, reg_covar) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    nk = resp.sum(axis=0) + 10 * np.finfo(resp.dtype).eps
    means = (resp.T @ X) / nk[:, None]
    covs = np.empty((len(nk), X.shape[1], X.shape[1]))
    for k in range(len(nk)):
        diff = X - means[k]
        covs[k] = ((resp[:, k] * diff.T) @ diff) / nk[k]
        covs[k].flat[:: X.shape[1] + 1] += reg_covar
    return nk, means, covs


def fit_gaussian_mixture(X, n_components: int, reg_covar: float = 1e-6,
                         random_state: Optional[int] = None, tol: float = 1e-3,
                         max_iter: int = 100) -> GaussianMixture:
    """``GaussianMixture(n_components, reg_covar=reg_covar,
    random_state=random_state).fit(X)``: k-means responsibilities, then EM
    until the mean log-likelihood moves less than ``tol``. Raises
    ValueError for fewer than 2 rows, fewer rows than components, or an
    ill-defined covariance, as scikit-learn does."""
    X = np.asarray(X, np.float64)
    n = X.shape[0]
    if n < 2:
        raise ValueError(f"Found array with {n} sample(s) while a minimum of 2 is required "
                         "by GaussianMixture.")
    if n < n_components:
        raise ValueError("Expected n_samples >= n_components but got "
                         f"n_components = {n_components}, n_samples = {n}")
    rs = check_random_state(random_state)
    resp = np.zeros((n, n_components))
    resp[np.arange(n), kmeans_labels(X, n_components, rs)] = 1
    weights, means, covs = _gaussian_params(X, resp, reg_covar)
    weights = weights / n
    prec = _precisions_chol(covs)
    lower_bound, converged, n_iter = -np.inf, False, 0
    for n_iter in range(1, max_iter + 1):
        prev = lower_bound
        wlp = _weighted_log_prob(X, weights, means, prec)
        log_norm = logsumexp(wlp, axis=1)
        with np.errstate(under="ignore"):
            log_resp = wlp - log_norm[:, None]
        weights, means, covs = _gaussian_params(X, np.exp(log_resp), reg_covar)
        weights = weights / weights.sum()
        prec = _precisions_chol(covs)
        lower_bound = float(np.mean(log_norm))
        if abs(lower_bound - prev) < tol:
            converged = True
            break
    gmm = GaussianMixture(weights, means, covs, random_state)
    gmm.converged_, gmm.n_iter_ = converged, n_iter
    return gmm


def fit_log_gmm(X, n_components: int = 1, logs: Sequence[int] = (), eps: float = 1e-10,
                reg_covar: float = 1e-3, random_state: Optional[int] = None) -> LogGMM:
    """The JAX package's ``LogGMM(n_components, logs, eps, reg_covar,
    random_state).fit(X)``: the maxima taken from ``X``, the mixture fitted
    in the transformed space."""
    X = np.asarray(X, np.float64)
    out = LogGMM(None, np.max(X, axis=0), logs, eps)
    out.gmm = fit_gaussian_mixture(out.transform(X), n_components, reg_covar, random_state)
    return out


def fit_speaker_gmms(speaker2priors: Dict[str, Dict[str, np.ndarray]], priors: Sequence[str],
                     max_components: int = 5, min_samples_per_component: int = 20,
                     reg_covar: float = 1e-3, logs: Sequence[int] = (0, 1, 2, 3),
                     seed: int = 0) -> Dict[str, LogGMM]:
    """Per-speaker mixtures over the utterance priors, the component count
    1..max chosen by BIC with at least ``min_samples_per_component`` rows a
    component (fastspeech2.py:501-528); a count whose fit fails is skipped."""
    out: Dict[str, LogGMM] = {}
    for speaker, d in speaker2priors.items():
        X = np.stack([d[p] for p in priors], axis=1)
        max_k = max(1, min(max_components, len(X) // max(min_samples_per_component, 1)))
        logs_k = [i for i in logs if i < X.shape[1]]
        best, best_bic = None, np.inf
        for k in range(1, max_k + 1):
            try:
                gmm = fit_log_gmm(X, k, logs_k, reg_covar=reg_covar, random_state=seed)
            except ValueError:
                continue
            bic = gmm.bic(X)
            if bic < best_bic:
                best, best_bic = gmm, bic
        if best is None:
            best = fit_log_gmm(X, 1, logs_k, reg_covar=reg_covar, random_state=seed)
        out[speaker] = best
    return out


def fit_dvector_gmms(speaker_dvectors: Iterable, n_components: int = 10,
                     reg_covar: float = 1e-6, seed: int = 0) -> Dict[str, LogGMM]:
    """Per-speaker mixtures over utterance d-vectors for novel-voice sampling
    (reference ``_fit_speaker_dvector_gmms``, fastspeech2.py:492-499), no
    log dims. ``speaker_dvectors``: ``(speaker, (n_utts, dim) array)`` pairs,
    as ``TTSDataset.get_speaker_dvectors`` yields them; the component count
    is clamped to the utterance count, as in the JAX package."""
    out: Dict[str, LogGMM] = {}
    for speaker, X in speaker_dvectors:
        X = np.asarray(X, dtype=np.float64)
        k = max(1, min(n_components, len(X)))
        out[speaker] = fit_log_gmm(X, k, reg_covar=reg_covar, random_state=seed)
    return out
