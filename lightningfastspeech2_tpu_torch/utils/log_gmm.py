"""Log-space Gaussian mixtures over utterance priors and d-vectors: sampling.

Counterpart of ``lightningfastspeech2_tpu/utils/log_gmm.py``. The JAX
package fits its mixtures with scikit-learn and pickles them
(``prior_gmms.pkl``, ``dvector_gmms.pkl``); this module reads those pickles
and samples from them without scikit-learn, draw for draw as
``GaussianMixture.sample`` does: ``check_random_state(random_state)``, one
``multinomial`` for the component counts, then one ``multivariate_normal``
per component, stacked. Only ``covariance_type="full"``, the one LogGMM
builds, is supported.

``load_gmms`` restores the pickled ``LogGMM`` and ``GaussianMixture``
objects as the plain classes below and refuses any other global than
numpy's array reconstructors. Fitting (``fit_speaker_gmms``,
``fit_dvector_gmms``) is not ported yet.
"""

from __future__ import annotations

import io
import numbers
import pickle
from pathlib import Path
from typing import Dict, Optional, Sequence, Union

import numpy as np


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

