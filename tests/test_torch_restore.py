"""The port's restoration chain, denoiser, augmentations and wav IO against
the JAX package's on seeded signals: each restoration stage and the whole
``AudioRestorer`` within 1e-4 of the signal's peak, the augmentations
within 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.data import wav as jwav
from lightningfastspeech2_tpu.synthesis import augment as jaug
from lightningfastspeech2_tpu.synthesis import denoiser as jdn
from lightningfastspeech2_tpu.synthesis import restore as jr
from lightningfastspeech2_tpu_torch.data import wav as twav
from lightningfastspeech2_tpu_torch.synthesis import augment as taug
from lightningfastspeech2_tpu_torch.synthesis import denoiser as tdn
from lightningfastspeech2_tpu_torch.synthesis import generator as tgen
from lightningfastspeech2_tpu_torch.synthesis import restore as tr

SR = 22050


def _signal(n, seed=0, noise=0.05):
    """Two partials with a slow vibrato and white noise."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.7 * np.sin(2 * np.pi * (220 * t + 3 * np.sin(2 * np.pi * 2 * t)))
         + 0.25 * np.sin(2 * np.pi * 1330 * t) + noise * g.standard_normal(n))
    return x.astype(np.float32)


def _close(out, ref, rel=1e-4):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=rel * np.abs(ref).max())


def test_builtin_denoiser_is_the_jax_one():
    assert tdn.BUILTIN_PATH.read_bytes() == jdn.BUILTIN_PATH.read_bytes()


def test_declip():
    x = np.clip(_signal(8192), -0.6, 0.6)
    assert (np.abs(x) >= 0.6).sum() > 500
    ref = jax.jit(jr.declip)(jnp.asarray(x))
    out = tr.declip(torch.as_tensor(x))
    _close(out.numpy(), ref)
    assert np.abs(out.numpy()).max() > 0.65      # the flat tops re-arched


@pytest.mark.parametrize("n, length", [(8192, 6000), (8192, 8192)])
def test_spectral_denoise(n, length):
    x = _signal(n, seed=1, noise=0.1)
    ref = jax.jit(jr.spectral_denoise)(jnp.asarray(x), jnp.int32(length))
    out = tr.spectral_denoise(torch.as_tensor(x), length)
    _close(out.numpy(), ref)


@pytest.mark.parametrize("n", [4096, 4097])
def test_upsample_2x(n):
    x = _signal(n, seed=2)
    _close(tr.upsample_2x(torch.as_tensor(x)).numpy(), jr.upsample_2x(jnp.asarray(x)))


def test_band_replicate():
    x = _signal(8192, seed=3)
    _close(tr.band_replicate(torch.as_tensor(x)).numpy(), jax.jit(jr.band_replicate)(jnp.asarray(x)))


def test_neural_denoise():
    x = _signal(8192, seed=4, noise=0.2)
    params, net = jdn.load(), tdn.load(device="cpu")
    ref = jax.jit(lambda a, n: jr.neural_denoise(a, params, length=n))(jnp.asarray(x),
                                                                       jnp.int32(6000))
    out = tr.neural_denoise(torch.as_tensor(x), net, length=6000)
    _close(out.numpy(), ref)
    # without the valid length, as the JAX function allows
    ref = jax.jit(lambda a: jr.neural_denoise(a, params))(jnp.asarray(x))
    _close(tr.neural_denoise(torch.as_tensor(x), net).numpy(), ref)


@pytest.mark.parametrize("denoiser, sr", [("auto", SR), ("spectral", 16000)])
def test_audio_restorer(denoiser, sr):
    wav = _signal(9000, seed=5, noise=0.08)
    ref = jr.AudioRestorer(denoiser=denoiser)(wav, sr)
    restorer = tr.AudioRestorer(denoiser=denoiser, device="cpu")
    assert (restorer.net is not None) == (denoiser == "auto")
    out = restorer(wav, sr)
    assert out.dtype == np.float32
    _close(out, ref)
    n_in = int(round(len(wav) * SR / sr))
    assert len(out) == 2 * n_in and restorer.output_sampling_rate == 44100


def test_augmentations():
    wav = _signal(11025, seed=6)
    kw = dict(pitch_shift_min_semitones=-2.0, pitch_shift_max_semitones=2.0,
              gaussian_snr_min_snr_db=10.0, gaussian_snr_max_snr_db=20.0,
              pitch_shift_p=1.0, gaussian_snr_p=1.0, room_p=1.0)
    for flags in (dict(pitch_shift=True), dict(gaussian_snr=True), dict(room=True),
                  dict(pitch_shift=True, gaussian_snr=True, room=True)):
        ref = jaug.from_args(seed=3, **flags, **kw)(wav, SR)
        out = taug.from_args(seed=3, **flags, **kw)(wav, SR)
        assert out.dtype == ref.dtype and out.shape == wav.shape
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert taug.from_args() is None


def test_chain_and_wav_io(tmp_path):
    """Restore then augment, the rate threaded through; the port's int16
    write reads back through the JAX package's reader."""
    chain = tgen.PostProcessChain(tr.AudioRestorer(denoiser="spectral", device="cpu"),
                                  taug.from_args(gaussian_snr=True, seed=0, gaussian_snr_p=1.0))
    assert chain.output_sampling_rate == 44100
    out = chain(_signal(4000, seed=7), SR)
    assert len(out) == 8000
    twav.write(tmp_path / "a.wav", out * 0.5, 44100)
    back, sr = jwav.read(tmp_path / "a.wav")
    assert sr == 44100
    # int16: x * 32767 truncated, read back / 32768
    np.testing.assert_allclose(back, np.clip(out * 0.5, -1, 1), atol=2.0 / 32767)
    jwav.write(tmp_path / "b.wav", out * 0.5, 44100)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    x, sr = twav.read(tmp_path / "b.wav")
    np.testing.assert_array_equal(x, back)
    np.testing.assert_array_equal(twav.resample(x, 44100, 16000), jwav.resample(x, 44100, 16000))
