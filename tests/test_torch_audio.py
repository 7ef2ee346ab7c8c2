"""The port's audio front-end (``lightningfastspeech2_tpu_torch/audio``)
against the JAX package's, on the CPU, on seeded inputs: the utterances of a
``make_corpus`` corpus (2 speakers x 3) and a noisy 150 Hz tone, each padded
to the dataset's wav bucket (hop x 256 samples) as both datasets pad it.

Tolerances, each from where the two implementations round differently:
- mel: ``torch.stft`` against ``jnp.fft.rfft`` in f32. Linear magnitudes
  agree within 2e-6 of the utterance's peak; log10 values within 1e-4 where
  the magnitude is within 60 dB of the peak (below that, log10 of a tiny
  magnitude turns its absolute rounding into a large relative one).
- energy and SNR: prefix sums in f32 round at eps32 times the running sum,
  in a different order on each side (XLA's cumsum against torch's). Energy:
  |e_a^2 - e_b^2| <= 16 eps32 * sum(x^2) / win (``audio/features.py
  energy_rounding_bound``). SNR: the statistic v3 within 16 eps32 *
  sum|ln|x|| / win, which the g-table turns into dB at 1 / (g[i+1] - g[i])
  (``audio/snr.py snr_rounding_bound``, per frame here); NaN masks equal.
- pitch: YIN's decisions are discontinuous. Frames within ``YIN_MARGIN`` of a
  decision (``audio/pitch.py near_decision``) are excluded and counted; on
  every other frame the voicing is identical and F0 agrees within rtol 1e-5.
- the numpy copies (filterbanks, CWT ``decompose_np``, NaN interpolation,
  phone averaging, duration augmentation): bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.audio import cwt as jcwt
from lightningfastspeech2_tpu.audio import features as jfeat
from lightningfastspeech2_tpu.audio import mel as jmel
from lightningfastspeech2_tpu.audio import pitch as jpitch
from lightningfastspeech2_tpu.audio import snr as jsnr
from lightningfastspeech2_tpu_torch.audio import cwt as tcwt
from lightningfastspeech2_tpu_torch.audio import features as tfeat
from lightningfastspeech2_tpu_torch.audio import mel as tmel
from lightningfastspeech2_tpu_torch.audio import pitch as tpitch
from lightningfastspeech2_tpu_torch.audio import snr as tsnr
from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus

EPS32 = float(np.finfo(np.float32).eps)
HOP, WIN, SR = 256, 1024, 22050
BUCKET = HOP * 256
# ten times the largest d' difference measured between XLA's and torch's
# f32 FFTs on these inputs and on a make_rich_corpus corpus (9.8e-5)
YIN_MARGIN = 1e-3

_JAX = {
    "mel": jax.jit(jmel.mel_spectrogram),
    "energy": jax.jit(jfeat.frame_energy),
    "snr": jax.jit(jsnr.windowed_wada),
    "pitch": jax.jit(jpitch.track),
}
_TORCH = {
    "mel": tmel.mel_spectrogram,
    "energy": tfeat.frame_energy,
    "snr": tsnr.windowed_wada,
    "pitch": tpitch.track,
}


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    """(wav, padded bucket) pairs: the corpus utterances and the tone."""
    root = make_corpus(tmp_path_factory.mktemp("audio_corpus"), n_speakers=2, n_utts=3,
                       seed=0)
    out = [wav_io.read(p)[0] for p in sorted(root.rglob("*.wav"))]
    g = np.random.default_rng(0)
    t = np.arange(int(2.5 * SR)) / SR
    out.append((0.5 * np.sin(2 * np.pi * 150 * t)
                + 0.05 * g.standard_normal(t.size)).astype(np.float32))
    padded = []
    for w in out:
        assert len(w) <= BUCKET
        p = np.zeros(BUCKET, np.float32)
        p[: len(w)] = w
        padded.append((w, p))
    return padded


@pytest.fixture(scope="module")
def features(wavs):
    """Every feature of every wav from both packages, cut to 1 + n // hop
    frames as the datasets cut them."""
    out = {k: [] for k in _JAX}
    for w, p in wavs:
        n = 1 + len(w) // HOP
        for k in _JAX:
            a = _TORCH[k](torch.from_numpy(p)).numpy()[:n]
            b = np.asarray(_JAX[k](jnp.asarray(p)))[:n]
            out[k].append((a, b))
    return out


def test_mel_matches_jax(wavs, features):
    for (a, b), (w, _) in zip(features["mel"], wavs):
        assert a.shape == b.shape == (1 + len(w) // HOP, 80)
        lin_a, lin_b = 10.0 ** a.astype(np.float64), 10.0 ** b.astype(np.float64)
        peak = lin_b.max()
        assert np.abs(lin_a - lin_b).max() <= 2e-6 * peak
        loud = lin_b >= 1e-3 * peak
        assert loud.mean() > 0.25
        np.testing.assert_allclose(a[loud], b[loud], rtol=0, atol=1e-4)


def test_energy_matches_jax(wavs, features):
    for (a, b), (w, _) in zip(features["energy"], wavs):
        assert a.shape == b.shape and b.max() > 0.1
        bound = tfeat.energy_rounding_bound(w, WIN)
        err = np.abs(a.astype(np.float64) ** 2 - b.astype(np.float64) ** 2)
        assert err.max() <= bound, (err.max(), bound)


def test_snr_matches_jax(wavs, features):
    finite = total = 0
    for (a, b), (w, _) in zip(features["snr"], wavs):
        assert a.shape == b.shape
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        ok = ~np.isnan(b)
        finite, total = finite + ok.sum(), total + len(b)
        # each frame against the bound at its own value
        tol = np.asarray([tsnr.snr_rounding_bound(w, [v], WIN) for v in b[ok]])
        assert (np.abs(a[ok] - b[ok]) <= tol).all(), np.abs(a[ok] - b[ok]).max()
    # the clean synthetic speech is above 100 dB (NaN) in most frames
    assert finite > 0.2 * total


def test_pitch_matches_jax_off_its_decisions(wavs, features):
    excluded, total = 0, 0
    for (a, b), (w, p) in zip(features["pitch"], wavs):
        n = len(a)
        near = tpitch.near_decision(tpitch.frame_windows(torch.from_numpy(p)), SR,
                                    YIN_MARGIN).numpy()[:n]
        keep = ~near
        excluded += int(near.sum())
        total += n
        np.testing.assert_array_equal(a[keep] > 0, b[keep] > 0)
        voiced = keep & (b > 0)
        assert voiced.sum() > 0.3 * n
        np.testing.assert_allclose(a[voiced], b[voiced], rtol=1e-5)
    # the margin excludes 17 of 994 frames on these inputs
    print(f"pitch: {excluded} of {total} frames within {YIN_MARGIN} of a YIN decision")
    assert excluded < 0.05 * total


def test_pitch_internals_match_jax(wavs):
    """The tone's d' from both FFTs, within the margin the decisions are
    judged at, and the windows equal to the JAX package's framing."""
    _, p = wavs[-1]
    frames = tpitch.frame_windows(torch.from_numpy(p))
    tau_max = tpitch.lag_range(SR)[1]
    pad_left, span = WIN // 2, WIN + tau_max
    ref = jmel.overlapping_frames(jnp.pad(jnp.asarray(p), (pad_left, span)), 1 + BUCKET // HOP,
                                  HOP, span)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(ref))
    dp = tpitch._cmnd(tpitch._difference_function(frames, tau_max)).numpy()
    dpj = np.asarray(jax.jit(lambda f: jpitch._cmnd(jpitch._difference_function(f, tau_max)))(
        jnp.asarray(frames.numpy())))
    assert np.abs(dp - dpj).max() < YIN_MARGIN / 10


def test_frame_counts_when_hop_divides_the_length():
    """Energy and SNR give ceil(n / hop) frames, mel and pitch 1 + n // hop:
    one more when hop divides n, which is why the dataset extracts at a
    padded bucket and cuts every feature to 1 + n // hop."""
    w = torch.from_numpy(np.random.default_rng(1).uniform(-0.5, 0.5, 8 * HOP).astype(np.float32))
    assert tmel.mel_spectrogram(w).shape[0] == tpitch.track(w).shape[0] == 9
    assert tfeat.frame_energy(w).shape[0] == tsnr.windowed_wada(w).shape[0] == 8


def test_filterbanks_bit_for_bit():
    for fn in ("mel_filterbank", "mel_filterbank_htk"):
        for args in ((22050, 1024, 80, 0.0, 8000.0), (16000, 512, 40, 20.0, 7600.0)):
            np.testing.assert_array_equal(getattr(tmel, fn)(*args), getattr(jmel, fn)(*args))
    # two cosines (torch's and XLA's): within one f32 ulp of 1
    np.testing.assert_allclose(tmel.hann_window(WIN).numpy(), np.asarray(jmel.hann_window(WIN)),
                               rtol=0, atol=EPS32)


def test_snr_statistic_and_lookup_match_jax():
    g = np.random.default_rng(2)
    table = jsnr.g_table().astype(np.float32)
    v3 = np.concatenate([g.uniform(table[0] - 0.1, table[-1] + 0.1, 300), table[:3],
                         table[-3:], [table[0] - 1e-3, table[-1] + 1e-3]]).astype(np.float32)
    np.testing.assert_allclose(tsnr.snr_from_statistic(torch.from_numpy(v3)).numpy(),
                               np.asarray(jsnr.snr_from_statistic(jnp.asarray(v3))),
                               rtol=0, atol=1e-4)
    x = np.abs(g.standard_normal(4000)).astype(np.float32)
    x[:100] = 0.0
    valid = np.arange(4000) < 3000
    np.testing.assert_allclose(
        tsnr.wada_statistic(torch.from_numpy(x), torch.from_numpy(valid)).item(),
        float(jsnr.wada_statistic(jnp.asarray(x), jnp.asarray(valid))), rtol=1e-5)
    np.testing.assert_array_equal(tsnr.g_table(), jsnr.g_table())


def test_decompose_np_bit_for_bit(features):
    for a, _ in features["pitch"][:3]:
        sig = tfeat.interpolate_nans(np.where(a > 0, a, np.nan))
        for s in (sig, np.where(np.arange(len(sig)) % 7 == 0, 0.0, sig), sig[:5]):
            ours, ref = tcwt.decompose_np(s), jcwt.decompose_np(s)
            assert set(ours) == set(ref)
            for k in ref:
                np.testing.assert_array_equal(ours[k], ref[k])
    for w, c in ((tcwt.ricker(31, 2.3), jcwt.ricker(31, 2.3)),
                 (tcwt.scale_constants(), jcwt.scale_constants())):
        np.testing.assert_array_equal(w, c)
    assert tcwt.scale_widths() == jcwt.scale_widths()


@pytest.mark.parametrize("fraction", [0.1, 0.3, 1.0])
def test_augment_durations_bit_for_bit(fraction):
    """The same seed draws the same durations (both take a numpy Generator)."""
    g = np.random.default_rng(3)
    for seed in range(4):
        d = g.integers(0, 12, size=int(g.integers(3, 40))).astype(np.int64)
        a = tfeat.augment_durations(d, np.random.default_rng(seed), fraction)
        b = jfeat.augment_durations(d, np.random.default_rng(seed), fraction)
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype and a.sum() == d.sum()


def test_numpy_helpers_bit_for_bit():
    g = np.random.default_rng(4)
    x = g.standard_normal(200)
    x[g.random(200) < 0.3] = np.nan
    x[:4] = np.nan
    x[-3:] = np.nan
    np.testing.assert_array_equal(tfeat.interpolate_nans(x), jfeat.interpolate_nans(x))
    d = g.integers(0, 6, 30)
    v = g.standard_normal(int(d.sum()))
    np.testing.assert_array_equal(tfeat.phone_average(v, d), jfeat.phone_average(v, d))
    np.testing.assert_array_equal(tfeat.expand_by_duration(d % 2 == 0, d),
                                  jfeat.expand_by_duration(d % 2 == 0, d))
    np.testing.assert_array_equal(tfeat.znormalize(v, 0.3, 2.0), jfeat.znormalize(v, 0.3, 2.0))
    np.testing.assert_array_equal(tfeat.denormalize(v, 0.3, 2.0), jfeat.denormalize(v, 0.3, 2.0))
