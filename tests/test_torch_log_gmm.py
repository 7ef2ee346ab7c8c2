"""The port's GMM sampling against scikit-learn's through the JAX package:
mixtures fitted by JAX ``fit_speaker_gmms`` / ``fit_dvector_gmms`` and
pickled, read by the port's ``load_gmms`` with scikit-learn made
unimportable, sample bit for bit alike; any other global is refused."""

import os
import pickle
import sys

import numpy as np
import pytest

from lightningfastspeech2_tpu.utils.log_gmm import fit_dvector_gmms, fit_speaker_gmms
from lightningfastspeech2_tpu_torch.utils import log_gmm as tg


@pytest.fixture(scope="module")
def fitted():
    g = np.random.default_rng(0)
    priors = {
        # two clusters: the BIC picks k > 1
        "two": {"pitch": np.concatenate([g.uniform(100, 120, 60), g.uniform(180, 210, 60)]),
                "energy": np.concatenate([g.uniform(0.2, 0.4, 60), g.uniform(0.6, 0.9, 60)])},
        "one": {"pitch": g.uniform(100, 200, 25), "energy": g.uniform(0.1, 1.0, 25)},
    }
    speaker = fit_speaker_gmms(priors, ("pitch", "energy"))
    assert speaker["two"].gmm.n_components > 1
    dvec = fit_dvector_gmms([("a", g.standard_normal((30, 8))),
                             ("b", g.standard_normal((4, 8)))])
    return speaker, dvec


def _load_without_sklearn(monkeypatch, data):
    for name in [m for m in sys.modules if m == "sklearn" or m.startswith("sklearn.")]:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import sklearn.mixture  # noqa: F401
    return tg.load_gmms(data)


@pytest.mark.parametrize("protocol", [4, 5])  # pickle.dump's default, and 5
def test_samples_bit_identical(fitted, monkeypatch, tmp_path, protocol):
    speaker, dvec = fitted
    blobs = {name: pickle.dumps(g, protocol=protocol) for name, g in
             (("prior", speaker), ("dvector", dvec))}
    (tmp_path / "prior_gmms.pkl").write_bytes(blobs["prior"])
    ported = {"prior": _load_without_sklearn(monkeypatch, tmp_path / "prior_gmms.pkl"),
              "dvector": _load_without_sklearn(monkeypatch, blobs["dvector"])}
    monkeypatch.undo()
    for name, ref in (("prior", speaker), ("dvector", dvec)):
        assert set(ported[name]) == set(ref)
        for spk in ref:
            # fresh copies of the JAX side: sampling mutates random_state
            j, t = pickle.loads(blobs[name])[spk], ported[name][spk]
            for n, seed in ((1, None), (5, 7), (3, 2 ** 31 - 1)):
                a = j.sample(n, random_state=seed)
                b = t.sample(n, random_state=seed)
                np.testing.assert_array_equal(a[0], b[0])
                np.testing.assert_array_equal(a[1], b[1])
                # then without a seed: the stored random_state
                np.testing.assert_array_equal(j.sample()[0], t.sample()[0])


def test_sample_sets_the_global_seed(fitted):
    speaker, _ = fitted
    t = tg.load_gmms(pickle.dumps(speaker))["two"]
    t.sample(random_state=11)
    assert t.gmm.random_state == 11
    after = np.random.random()
    np.random.seed(11)
    assert after == np.random.random()


class _Evil:
    def __reduce__(self):
        return (os.system, ("true",))


@pytest.mark.parametrize("payload", [
    {"spk": _Evil()},
    {"spk": np.random.RandomState(0)},
], ids=["os.system", "RandomState"])
def test_other_globals_refused(payload):
    with pytest.raises(pickle.UnpicklingError, match="refusing"):
        tg.load_gmms(pickle.dumps(payload))


def test_only_full_covariances():
    m = tg.make_log_gmm([1.0], [[0.0, 0.0]], [np.eye(2)], [1.0, 1.0])
    m.gmm.covariance_type = "diag"
    with pytest.raises(NotImplementedError, match="full"):
        m.sample()


def test_port_gmms_roundtrip(tmp_path):
    m = tg.make_log_gmm([0.3, 0.7], [[0.1, -1.0], [0.5, -2.0]],
                        [np.eye(2) * 0.01, np.eye(2) * 0.02], [200.0, 1.0], logs=[1])
    (tmp_path / "g.pkl").write_bytes(pickle.dumps({"s": m}))
    back = tg.load_gmms(tmp_path / "g.pkl")["s"]
    np.testing.assert_array_equal(back.sample(4, random_state=3)[0],
                                  m.sample(4, random_state=3)[0])
    x = m.sample(200, random_state=0)[0]
    assert np.all(x[:, 1] > 0)           # the log dim maps back through exp
