"""The port's native DIO / StoneMask pitch (native/__init__.py
``dio_pitch``, its own copy of pitch.cpp) against the JAX package's on
tests/test_native_pitch.py's signals: equal bit for bit, refined or not."""

import numpy as np
import pytest

from lightningfastspeech2_tpu.native import dio_pitch as jax_dio_pitch
from lightningfastspeech2_tpu_torch.native import dio_pitch
from tests.test_native_pitch import harmonic


def _signals():
    g = np.random.default_rng(0)
    return {"110": harmonic(22050, 110.0), "220": harmonic(22050, 220.0),
            "330": harmonic(22050, 330.0), "237": harmonic(22050, 237.0),
            "vibrato": harmonic(22050, 200.0, vibrato_hz=4.0, vibrato_cents=100.0),
            "noise": g.standard_normal(22050)}


@pytest.mark.parametrize("name", sorted(_signals()))
@pytest.mark.parametrize("refine", [True, False])
def test_dio_pitch_equals_the_jax_packages(name, refine):
    wav = _signals()[name]
    ours = dio_pitch(wav, 22050, refine=refine)
    theirs = jax_dio_pitch(wav, 22050, refine=refine)
    assert ours.dtype == theirs.dtype == np.float64
    assert np.array_equal(ours, theirs)
    if name != "noise":
        assert (ours > 0).mean() > 0.7


def test_dio_pitch_frame_grid():
    wav = harmonic(22050, 180.0, dur=0.5)
    assert dio_pitch(wav, 22050).shape == (int(len(wav) / 256) + 1,)
    assert dio_pitch(wav, 22050, frame_period_ms=5.0).shape == (
        int(len(wav) / 22050 * 1000.0 / 5.0) + 1,)
