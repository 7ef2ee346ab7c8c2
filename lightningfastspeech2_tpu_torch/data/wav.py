"""The port's own copy of ``lightningfastspeech2_tpu/data/wav.py``, its
``dequantize`` on tensors.

WAV file IO + resampling (host side).

The reference loads audio with torchaudio/sox (C++); neither exists here,
so: scipy.io.wavfile for IO (supports int16/int32/float formats) and
polyphase resampling via scipy.signal.resample_poly (the same algorithm
class torchaudio.transforms.Resample uses).
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import Tuple, Union

import numpy as np
from scipy.io import wavfile


def read(path: Union[str, Path]) -> Tuple[np.ndarray, int]:
    """Returns (float32 mono waveform in [-1, 1], sampling_rate)."""
    sr, data = wavfile.read(str(path))
    if data.dtype == np.int16:
        wav = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        wav = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        wav = (data.astype(np.float32) - 128.0) / 128.0
    else:
        wav = data.astype(np.float32)
    if wav.ndim == 2:
        wav = wav.mean(axis=1)
    return wav, int(sr)


def write(path: Union[str, Path], wav: np.ndarray, sr: int) -> None:
    """Writes int16 PCM (the reference's vocoder output convention:
    float * 32768 -> int16, hifigan/__init__.py:40)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    clipped = np.clip(np.asarray(wav, dtype=np.float32), -1.0, 1.0)
    wavfile.write(str(path), sr, (clipped * 32767.0).astype(np.int16))


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    if orig_sr == target_sr:
        return wav
    # imported here: scipy.signal takes seconds to import, and a spawn
    # worker reading wavs at the target rate never needs it
    from scipy.signal import resample_poly

    g = math.gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g).astype(np.float32)


def dequantize(wav):
    """The inverse of the int16 transfer encoding (``DataConfig.wav_dtype``):
    an integer waveform becomes float32 in [-1, 1); a float one passes
    through. Works on tensors and numpy arrays."""
    import torch

    if torch.is_tensor(wav):
        if not wav.is_floating_point():
            return wav.float() / 32768.0
        return wav
    if np.issubdtype(np.asarray(wav).dtype, np.integer):
        return np.asarray(wav).astype(np.float32) / 32768.0
    return wav
