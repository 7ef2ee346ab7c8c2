"""The port's on-device features (``train/on_device_features.py`` and the
helpers it adds to ``audio/``) against the JAX package's functions on the
same numpy inputs, on the CPU, each JAX function jitted.

Tolerances:
- ``interpolate_nans_t`` atol 1e-6 (the same f32 weights; NaN where JAX
  gives NaN), ``phone_average_t`` atol 1e-6 (f32 sums in another order
  than ``segment_sum``'s);
- ``decompose`` / ``decompose_padded``: the log signal, mean and std atol
  1e-6, the spectrogram atol 1e-5 (an FFT convolution against XLA's direct
  one, both f32);
- ``frame_srmr_padded`` rtol 1e-5 (the same FFTs on the same CPU library
  family, f32);
- ``extract_batch_features`` on a ``make_corpus`` batch: the mel as
  ``test_torch_dataset.py`` holds it (linear magnitudes within 2e-6 of the
  item's peak, log10 values atol 1e-4 within 30 dB of it), energy and SNR atol 1e-4 after normalization, pitch
  (CWT) signal rtol 1e-4 and spectrogram atol 1e-4, where the two F0 tracks
  agree on every frame (within rtol 1e-5; the corpus's two frames within
  ``YIN_MARGIN`` of a YIN decision take the same lag on both, checked here);
- a 2-step raw-mode ``fit`` against the port's host-feature run on the same
  utterances: the pitch (CWT), energy and duration losses rtol 1e-4; the mel
  loss 2e-3 (the host pads an item's mel past its own frames with 0, the
  padded batch's STFT gives the silence floor there), the SNR loss 0.1 (the
  host truncates an item's last windows at its length, the padded batch's
  run into the zeros; 0.025 and 0.043 measured), the total and the gradient
  norm 2e-3. ``tests/test_on_device_features.py`` holds the JAX package's
  two paths to a median of 0.05 for the same reasons.
"""

import jax
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.audio import cwt as jcwt
from lightningfastspeech2_tpu.audio import features as jfeat
from lightningfastspeech2_tpu.audio import pitch as jpitch
from lightningfastspeech2_tpu.audio import srmr as jsrmr
from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.models.variance_adaptor import VarianceStats as JStats
from lightningfastspeech2_tpu.train.on_device_features import (
    extract_batch_features as j_extract,
)
from lightningfastspeech2_tpu_torch.audio import cwt as tcwt
from lightningfastspeech2_tpu_torch.audio import features as tfeat
from lightningfastspeech2_tpu_torch.audio import pitch as tpitch
from lightningfastspeech2_tpu_torch.audio import snr as tsnr
from lightningfastspeech2_tpu_torch.audio import srmr as tsrmr
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.data import dataset as tds
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
from lightningfastspeech2_tpu_torch.models.variance_adaptor import VarianceStats as TStats
from lightningfastspeech2_tpu_torch.train.loop import fit
from lightningfastspeech2_tpu_torch.train.on_device_features import augment_batch_with_features
from tests.torch_port_helpers import torch_threads, train_config

SR = 22050
YIN_MARGIN = 1e-3
T = 256


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_interpolate_nans_matches_jax():
    g = np.random.default_rng(0)
    x = g.standard_normal((4, T)).astype(np.float32)
    x[0, :7] = np.nan          # a leading run
    x[0, 100:140] = np.nan     # an inner run
    x[0, -5:] = np.nan         # a trailing run
    x[1] = np.nan              # all NaN
    x[3, g.random(T) < 0.5] = np.nan
    want = np.asarray(jax.jit(jax.vmap(jfeat.interpolate_nans_jnp))(x))
    got = tfeat.interpolate_nans_t(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[1]).all() and not np.isnan(got[[0, 2, 3]]).any()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got[2], x[2])   # nothing to fill


def test_phone_average_matches_jax():
    g = np.random.default_rng(1)
    P = 32
    d = g.integers(0, 15, (2, P)).astype(np.int32)
    d[0, [0, 5, 6]] = 0            # zero durations, two in a row
    d[0, 20:] = 0                  # padding
    d[1, -1] = 200                 # a total past T: its frames beyond T drop
    v = g.standard_normal((2, T)).astype(np.float32) * 50 + 200
    want = np.asarray(jax.jit(jax.vmap(lambda s, dd: jfeat.phone_average_jnp(s, dd, P)))(v, d))
    got = tfeat.phone_average_t(torch.from_numpy(v), torch.from_numpy(d), P).numpy()
    assert (got[d == 0] == np.float32(1e-7)).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("lengths", [(90, 256), (256, 256)])
def test_decompose_matches_jax(lengths):
    """``decompose_padded`` at lengths below T (90: below 10 x width from
    the fifth scale up, so those kernels truncate at the length) and at T,
    and ``decompose`` (the unpadded twin) on the full rows."""
    g = np.random.default_rng(2)
    sig = (np.abs(g.standard_normal((2, T))) * 100 + 80).astype(np.float32)
    sig[0, 3] = 0.0                       # a zero becomes 1e-7 before the log
    L = np.asarray(lengths, np.int32)
    sig[np.arange(T)[None] >= L[:, None]] = 0.0
    want = jax.jit(jax.vmap(jcwt.decompose_padded))(sig, L)
    got = tcwt.decompose_padded(torch.from_numpy(sig), torch.from_numpy(L))
    for key, atol in (("signal", 1e-6), ("mean", 1e-6), ("std", 1e-6), ("spectrogram", 1e-5)):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0, atol=atol,
                                   err_msg=key)
    spec = got["spectrogram"].numpy()
    assert (spec[0, L[0]:] == 0).all() and np.abs(spec[0, : L[0]]).max() > 0.01
    if lengths[0] == T:
        want = jax.jit(jax.vmap(jcwt.decompose))(sig)
        got = tcwt.decompose(torch.from_numpy(sig))
        for key, atol in (("signal", 1e-6), ("mean", 1e-6), ("std", 1e-6),
                          ("spectrogram", 1e-5)):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=0,
                                       atol=atol, err_msg=key)


@pytest.mark.parametrize("seconds", [0.2, 1.5])
def test_frame_srmr_padded_matches_jax(seconds):
    """One window (0.2 s: shorter than the 256 ms window, so constant) and
    several, in a buffer of 1.5 s; the frames past each item's count follow
    the JAX function too."""
    g = np.random.default_rng(3)
    n_max = int(1.5 * SR)
    t = np.arange(n_max) / SR
    wav = (0.3 * np.sin(2 * np.pi * 5 * t)[None] * g.standard_normal((2, n_max))
           ).astype(np.float32)
    length = np.asarray([int(seconds * SR), n_max // 2], np.int32)
    wav[np.arange(n_max)[None] >= length[:, None]] = 0.0
    n_frames = (length // 256).astype(np.int32)
    mf = int(n_max // 256)
    want = np.asarray(jax.jit(jax.vmap(
        lambda w, l, n: jsrmr.frame_srmr_padded(w, l, n, mf)))(wav, length, n_frames))
    got = tsrmr.frame_srmr_padded(torch.from_numpy(wav), torch.from_numpy(length),
                                  torch.from_numpy(n_frames), mf).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    if seconds < 0.256:
        assert (got[0] == got[0, 0]).all()
    else:
        assert np.ptp(got[0, : n_frames[0]]) > 0


@pytest.fixture(scope="module")
def raw_setup(tmp_path_factory):
    """A make_corpus corpus (1 speaker x 3 utterances), the port's raw-mode
    dataset on it (stats from full extraction) and one collated raw batch
    of its two shortest items, with one silence phone marked."""
    corpus = make_corpus(tmp_path_factory.mktemp("odf_corpus"), n_speakers=1, n_utts=3, seed=5)
    dcfg = tds.DataConfig(variances=("pitch", "energy", "snr"),
                          variance_levels=("frame",) * 3,
                          variance_transforms=("cwt", "none", "none"), augment_duration=0.0,
                          stat_entries=3, raw_mode=True, max_phones=32, max_frames=T)
    ds = tds.TTSDataset(corpus, dcfg, device="cpu")
    order = np.argsort([int(e.durations.sum()) for e in ds.entries])
    items = [ds.__getitem__(int(i), augment=False) for i in order[:2]]
    batch = ds.collate(items)
    batch["silence_phone"][0, 1] = True
    return ds, batch


def _close_mel(a, b):
    """log10 mels of one item: linear magnitudes within 2e-6 of its peak,
    and log values within 1e-4 within 30 dB of it (``test_torch_dataset.py``'s
    criterion: the two FFTs round apart in quiet bins)."""
    lin_a, lin_b = 10.0 ** a.astype(np.float64), 10.0 ** b.astype(np.float64)
    peak = lin_b.max()
    assert np.abs(lin_a - lin_b).max() <= 2e-6 * peak
    loud = lin_b >= 1e-3 * peak
    np.testing.assert_allclose(a[loud], b[loud], rtol=0, atol=1e-4)


def _configs(level, transform):
    out = []
    for C in (JC, TC):
        var = C.VarianceConfig(variances=("pitch", "energy", "snr"), levels=(level, "frame", "frame"),
                               transforms=(transform, "none", "none"),
                               losses=("mse",) * 3, nlayers=(2,) * 3)
        out.append(C.Config(model=C.ModelConfig(variance=var, max_phones=32, max_frames=T)))
    return out


@pytest.mark.parametrize("level", ["frame", "phone"])
def test_extract_batch_features_matches_jax(raw_setup, level):
    """The flagship's variance set (frame-level pitch with CWT, energy,
    SNR), and phone-level CWT pitch with ``phones_lengths``, on one raw
    batch: ``augment_batch_with_features`` (int16 wav dequantized) against
    the JAX function on the same dequantized wav."""
    ds, batch = raw_setup
    jcfg, tcfg = _configs(level, "cwt")
    stats = {v: ds.stats[v] for v in ("pitch", "energy", "snr")}
    jstats = tuple((v, JStats(**s)) for v, s in stats.items())
    tstats = tuple((v, TStats(**s)) for v, s in stats.items())
    wav = batch["wav"]
    assert wav.dtype == np.float32 or wav.dtype == np.int16
    mf = min(wav.shape[1] // 256, T)
    wav_f = wav.astype(np.float32) / 32768.0 if wav.dtype == np.int16 else wav
    want = jax.jit(lambda w, d, s, p: j_extract(w, d, s, jcfg, jstats, mf, p))(
        wav_f, batch["duration"], batch["silence_phone"], batch["phones_lengths"])
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()
          if isinstance(v, np.ndarray)}
    got = augment_batch_with_features(tb, tcfg, tstats)
    assert got["wav"].dtype == torch.float32
    assert set(want) <= set(got)
    # YIN's decisions: off the frames within YIN_MARGIN of one the two F0
    # tracks agree; the two such frames of these items take the same lag on
    # both, which the targets' comparison below needs (a flip moves the
    # whole utterance's CWT normalization)
    frames = tpitch.frame_windows(torch.from_numpy(wav_f), SR)
    near = tpitch.near_decision(frames, SR, YIN_MARGIN).numpy()
    f0_t = tpitch.track(torch.from_numpy(wav_f), SR).numpy()
    f0_j = np.asarray(jax.jit(jax.vmap(jpitch.track))(wav_f))
    np.testing.assert_allclose(f0_t[~near], f0_j[~near], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(f0_t[near], f0_j[near], rtol=1e-5, atol=1e-6)
    assert near.sum() == 2
    for a, b in zip(got["mel"].numpy(), np.asarray(want["mel"])):
        _close_mel(a, b)
    # energy and SNR de-normalized, within the rounding bounds of their f32
    # prefix sums (``audio/features.py energy_rounding_bound``,
    # ``audio/snr.py snr_rounding_bound``), per item
    for b_, w_ in enumerate(wav_f):
        st = stats["energy"]
        ea, eb = (np.asarray(x)[b_] * st["std"] + st["mean"]
                  for x in (got["variances_energy"], want["variances_energy"]))
        bound = tfeat.energy_error_bound(ea, eb, tfeat.energy_rounding_bound(w_))
        assert (np.abs(ea - eb) <= bound + 1e-5 * st["std"]).all()
        st = stats["snr"]
        sa, sb = (np.asarray(x)[b_] * st["std"] + st["mean"]
                  for x in (got["variances_snr"], want["variances_snr"]))
        assert np.abs(sa - sb).max() <= tsnr.snr_rounding_bound(w_, sb) + 1e-5 * st["std"]
    tol = {"variances_pitch_spectrogram": 1e-4, "variances_pitch_mean": 1e-5,
           "variances_pitch_std": 1e-5}
    for key, w in want.items():
        if key in ("mel", "variances_energy", "variances_snr"):
            continue
        g_ = got[key].numpy()
        w = np.asarray(w)
        assert g_.shape == w.shape, key
        if key == "variances_pitch_signal":
            np.testing.assert_allclose(g_, w, rtol=1e-4, atol=1e-6, err_msg=key)
        else:
            np.testing.assert_allclose(g_, w, rtol=0, atol=tol[key], err_msg=key)
    if level == "phone":
        assert got["variances_pitch_signal"].shape[1] == batch["phones"].shape[1]


def test_raw_mode_fit_matches_host_features(tmp_path):
    """Two steps of ``fit`` in raw mode (features in the step) against two
    on the host pipeline's features for the same utterances, batch order
    and weights."""
    corpus = make_corpus(tmp_path / "c", n_speakers=1, n_utts=4, seed=7)
    cfg = train_config(TC)
    runs = {}
    for raw in (False, True):
        c = TC.replace(cfg, **{"train.on_device_features": raw})
        v = c.model.variance
        dcfg = tds.DataConfig(variances=v.variances, variance_levels=v.levels,
                              variance_transforms=v.transforms, augment_duration=0.0,
                              raw_mode=raw, wav_dtype="float32",
                              max_phones=c.model.max_phones, max_frames=c.model.max_frames)
        ds = tds.TTSDataset(corpus, dcfg, device="cpu")
        runs[raw] = fit(c, ds, max_steps=2, device="cpu").history
    rtol = {"mel": 2e-3, "snr": 0.1, "total": 2e-3, "grad_norm": 2e-3}
    for host, raw in zip(runs[False], runs[True]):
        for key in host:
            if key in ("steps_per_s", "lr"):
                continue
            assert np.isfinite(raw[key])
            np.testing.assert_allclose(raw[key], host[key], rtol=rtol.get(key, 1e-4), atol=1e-6,
                                       err_msg=key)
