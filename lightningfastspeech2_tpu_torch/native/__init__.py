"""Native (C++) soft-DTW and DIO pitch on the CPU.

Counterpart of ``lightningfastspeech2_tpu/native`` (``softdtw_cpu``,
``softdtw_grad_cpu``, ``pitch_lib``, ``dio_pitch``): ``softdtw.cpp`` and
``pitch.cpp`` beside this file (copies of the JAX package's sources) are
compiled with g++ at first use into ``lightningfastspeech2_tpu_torch/_build/``
(git-ignored; the library is named after a hash of the source and flags, so
an edited source is rebuilt) and bound with ctypes on their plain C
functions. The same source and flags as the JAX package's build give the
same bits. The training loss on the card is ``ops/soft_dtw.py``; soft-DTW
here is the metric's exact float64 recursion over whole utterances.
``dio_pitch`` is the offline DIO + StoneMask F0 tracker (the reference's
pyworld path); the dataset's pitch is ``audio/pitch.py``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_DIR = _DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_softdtw_lib: Optional[ctypes.CDLL] = None
_pitch_lib: Optional[ctypes.CDLL] = None


def _build(name: str) -> Path:
    """``lib<name>-<hash>.so`` in the build directory, compiled if absent.
    The compiler writes a file of its own, renamed into place, so processes
    building at once never load a half-written library."""
    src = _DIR / f"{name}.cpp"
    digest = hashlib.sha1(src.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:12]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{lib.name}.{os.getpid()}.{threading.get_ident()}"
    try:
        subprocess.run(["g++", *GXX_FLAGS, str(src), "-o", str(tmp)], check=True,
                       capture_output=True)
        os.replace(tmp, lib)
    finally:
        tmp.unlink(missing_ok=True)
    return lib


def softdtw_lib() -> ctypes.CDLL:
    global _softdtw_lib
    with _lock:
        if _softdtw_lib is None:
            lib = ctypes.CDLL(str(_build("softdtw")))
            dp = ctypes.POINTER(ctypes.c_double)
            lib.softdtw_forward.restype = ctypes.c_double
            lib.softdtw_forward.argtypes = [dp, ctypes.c_int, ctypes.c_int, ctypes.c_double, dp]
            lib.softdtw_backward.restype = None
            lib.softdtw_backward.argtypes = [dp, dp, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_double, dp]
            _softdtw_lib = lib
    return _softdtw_lib


def pitch_lib() -> ctypes.CDLL:
    global _pitch_lib
    with _lock:
        if _pitch_lib is None:
            lib = ctypes.CDLL(str(_build("pitch")))
            dp, i, d = ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_double
            lib.dio_f0.restype = ctypes.c_int
            lib.dio_f0.argtypes = [dp, i, d, d, d, d, dp]
            lib.stonemask_refine.restype = None
            lib.stonemask_refine.argtypes = [dp, i, d, d, dp, i, dp]
            _pitch_lib = lib
    return _pitch_lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def dio_pitch(wav: np.ndarray, sampling_rate: int, frame_period_ms: Optional[float] = None,
              hop_length: int = 256, f0_floor: float = 71.0, f0_ceil: float = 800.0,
              refine: bool = True) -> np.ndarray:
    """DIO F0 track, refined by StoneMask unless ``refine`` is false: (n_frames,)
    float64 in Hz, 0 where unvoiced. The frame period defaults to the mel
    hop (hop_length / sampling_rate s)."""
    lib = pitch_lib()
    wav = np.ascontiguousarray(wav, dtype=np.float64)
    if frame_period_ms is None:
        frame_period_ms = hop_length / sampling_rate * 1000.0
    n_frames = int(len(wav) / sampling_rate * 1000.0 / frame_period_ms) + 1
    f0 = np.empty(n_frames, dtype=np.float64)
    got = lib.dio_f0(_ptr(wav), len(wav), sampling_rate, frame_period_ms, f0_floor, f0_ceil,
                     _ptr(f0))
    if got != n_frames:
        raise RuntimeError(f"dio_f0 wrote {got} frames, expected {n_frames}")
    if refine:
        refined = np.empty_like(f0)
        lib.stonemask_refine(_ptr(wav), len(wav), sampling_rate, frame_period_ms, _ptr(f0),
                             n_frames, _ptr(refined))
        f0 = refined
    return f0


def _sq_dist(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """(N, M) squared Euclidean distances, C-contiguous float64."""
    return np.ascontiguousarray(((x[:, None, :] - y[None, :, :]) ** 2).sum(-1), np.float64)


def softdtw_cpu(x: np.ndarray, y: np.ndarray, gamma: float = 1.0,
                normalize: bool = False) -> float:
    """Soft-DTW between (N, D) and (M, D) float sequences on the CPU;
    ``normalize`` subtracts half of each sequence's value against itself."""
    lib = softdtw_lib()

    def value(a, b):
        D = _sq_dist(a, b)
        return lib.softdtw_forward(_ptr(D), D.shape[0], D.shape[1], ctypes.c_double(gamma), None)

    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    v = value(x, y)
    if normalize:
        v -= 0.5 * (value(x, x) + value(y, y))
    return float(v)


def softdtw_grad_cpu(x: np.ndarray, y: np.ndarray, gamma: float = 1.0):
    """Returns (value, dValue/dD) for the pairwise distance matrix D."""
    lib = softdtw_lib()
    D = _sq_dist(np.asarray(x, np.float64), np.asarray(y, np.float64))
    n, m = D.shape
    R = np.empty((n + 2, m + 2), dtype=np.float64)
    value = lib.softdtw_forward(_ptr(D), n, m, ctypes.c_double(gamma), _ptr(R))
    E = np.empty((n, m), dtype=np.float64)
    lib.softdtw_backward(_ptr(D), _ptr(R), n, m, ctypes.c_double(gamma), _ptr(E))
    return float(value), E
