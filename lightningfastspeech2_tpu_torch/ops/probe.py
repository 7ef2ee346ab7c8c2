"""The launch probe: ``y = 2 * x`` on an (8, 128) f32 tile.

Counterpart of ``kernel_gate._probe`` in the JAX package, which probed
whether Pallas kernels launch on the backend and switched them off when
not. Here nothing is switched off: the probe runs first so that a broken
build, load or launch fails before anything else does.
"""

from __future__ import annotations

import ctypes

import torch

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream

_c_fn = None


def probe_plain(x: torch.Tensor) -> torch.Tensor:
    return x * 2.0


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = build.load("probe")
        fn = lib.lfs2_probe
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _c_fn = (lib, fn)
    return _c_fn


def probe(x: torch.Tensor) -> torch.Tensor:
    """``2 * x`` for an f32 tensor: the plain version on the CPU, the CUDA
    kernel on the card."""
    if x.is_cpu:
        return probe_plain(x)
    stream = kernel_stream(x)
    if x.dtype != torch.float32:
        raise ValueError(f"probe takes float32, got {x.dtype}")
    y = torch.empty_like(x)
    lib, fn = _fn()
    rc = fn(x.data_ptr(), y.data_ptr(), x.numel(), stream)
    build.check(lib, rc, "probe")
    probe.launches += 1
    return y


probe.launches = 0
