"""The port's SRMR (audio/srmr.py) and the dataset's ``srmr`` variance
against the JAX package's, on the CPU.

The gammatone filterbank and the ERB centres are numpy in both, equal bit
for bit. SRMR is a ratio of band energies computed through three FFTs in
f32; the two FFT libraries round differently, which moves the ratio most
where the high modulation bands are near their 1e-8 floor, so the signals
here are voiced (harmonics of a gliding f0 under a syllable-rate envelope)
and the per-window and per-frame values agree within rtol 2e-5 (observed
1.2e-6). An odd and an even length take both Hilbert masks. The
dataset's ``srmr`` variance (z-normalized by each package's own stats) agrees
within atol 1e-3 after de-normalization, over every item of a small corpus."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lightningfastspeech2_tpu.audio import srmr as jsr
from lightningfastspeech2_tpu.data import dataset as jds
from lightningfastspeech2_tpu_torch.audio import srmr as tsr
from lightningfastspeech2_tpu_torch.data import dataset as tds
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
from tests.torch_port_helpers import torch_threads

RTOL = 2e-5
SR = 22050
SRMR_DS = dict(variances=("energy", "srmr"), variance_levels=("frame", "frame"),
               variance_transforms=("none", "none"), augment_duration=0.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_srmr():
    """JAX's ``srmr_per_window`` jitted for the module (``frame_srmr`` and
    the JAX dataset look it up at each call): one compile a length instead
    of one per primitive."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsr, "srmr_per_window",
                   jax.jit(jsr.srmr_per_window, static_argnums=(1, 2, 3)))
        yield


def voiced(n, seed):
    """Harmonics of an f0 gliding 110-160 Hz under a 4 Hz envelope."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 110 + 50 * (0.5 + 0.5 * np.sin(2 * np.pi * 0.7 * t))
    phase = 2 * np.pi * np.cumsum(f0) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 20))
    env = 0.55 + 0.45 * np.sin(2 * np.pi * 4.0 * t)
    return (x * env + 0.01 * g.standard_normal(n)).astype(np.float32)


def test_filterbank_is_the_same():
    np.testing.assert_array_equal(tsr.erb_space(125.0, 8000.0, 23),
                                  jsr.erb_space(125.0, 8000.0, 23))
    for sr in (22050, 16000):
        np.testing.assert_array_equal(tsr.gammatone_fir(sr), jsr.gammatone_fir(sr))


@pytest.mark.parametrize("n", [33075, 44100])
def test_srmr_per_window_matches_jax(n):
    wav = voiced(n, n)
    ref = np.asarray(jsr.srmr_per_window(jnp.asarray(wav), SR))
    got = tsr.srmr_per_window(wav, SR, device="cpu").numpy()
    assert got.shape == ref.shape and len(ref) > 10 and (ref > 0).all()
    np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("n,n_frames", [(33075, 130), (4000, 16)])
def test_frame_srmr_matches_jax(n, n_frames):
    """Many windows interpolated, and one window (a short clip) repeated."""
    wav = voiced(n, 3)
    ref = jsr.frame_srmr(wav, n_frames, SR)
    got = tsr.frame_srmr(wav, n_frames, SR, device="cpu")
    assert got.dtype == ref.dtype and got.shape == (n_frames,)
    np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_dataset_srmr_variance_matches_jax(tmp_path):
    corpus = make_corpus(tmp_path / "c", n_speakers=1, n_utts=2, seed=4)
    jd = jds.TTSDataset(corpus, jds.DataConfig(**SRMR_DS))
    td = tds.TTSDataset(corpus, tds.DataConfig(**SRMR_DS), device="cpu")
    for stats in (jd.stats, td.stats):
        assert stats["srmr"]["std"] > 0
    for i in range(len(td)):
        a, b = td[i], jd[i]
        sa = a["variances_srmr"] * td.stats["srmr"]["std"] + td.stats["srmr"]["mean"]
        sb = b["variances_srmr"] * jd.stats["srmr"]["std"] + jd.stats["srmr"]["mean"]
        assert a["variances_srmr"].dtype == np.float32 and sa.shape == sb.shape
        np.testing.assert_allclose(sa, sb, rtol=0, atol=1e-3)
