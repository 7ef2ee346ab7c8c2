"""Tracing, profiling and numerics debugging.

Counterpart of ``lightningfastspeech2_tpu/utils/debug.py``:

- ``profile_trace``: ``torch.profiler`` over the CPU and, where there is
  one, the card, writing a Chrome trace (Perfetto and ``chrome://tracing``
  read it; TensorBoard's profiler plugin does too);
- ``annotate``: a named span in that trace (``record_function``), and an
  NVTX range on a machine with CUDA;
- ``enable_nan_debugging``: autograd's anomaly detection, which names the
  forward op whose backward made a NaN;
- ``nan_guard``: NaN / Inf checks on a function's tensor outputs, behind
  the JAX package's ``LFS2_DEBUG_NANS`` switch, so the hot path pays
  nothing by default. The switch only adds checks: every kernel runs as
  without it;
- ``kernel_dump_to``: the counterpart of ``xla_dump_to``. The port compiles
  no XLA graph; what it compiles are its CUDA kernels, so this writes each
  kernel library's SASS (``cuobjdump``) and PTX under a directory.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
from pathlib import Path
from typing import Any, Callable, Dict, Sequence

import torch

NAN_SWITCH = "LFS2_DEBUG_NANS"
TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(log_dir="lfs2_trace"):
    """Profile everything inside the context: ``with profile_trace(d) as
    prof: step(...)``. On exit the card is synchronised and the Chrome
    trace is written to ``<log_dir>/trace.json``; ``prof`` is the
    ``torch.profiler.profile`` (for ``key_averages()``)."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    path = Path(log_dir) / TRACE_FILE
    path.parent.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(str(path))


class annotate(contextlib.ContextDecorator):
    """A named span in the profiler's trace and, with CUDA, an NVTX range;
    a context manager or a decorator."""

    def __init__(self, name: str):
        self.name = name

    def _recreate_cm(self):
        return annotate(self.name)   # a decorated function may nest in itself

    def __enter__(self):
        self._span = torch.profiler.record_function(self.name)
        self._span.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc):
        if self._nvtx:
            torch.cuda.nvtx.range_pop()
        self._span.__exit__(*exc)
        return False


def enable_nan_debugging(enable: bool = True) -> None:
    torch.autograd.set_detect_anomaly(enable)


def _check_finite(out: Any, where: str) -> None:
    if isinstance(out, torch.Tensor):
        if out.is_floating_point() or out.is_complex():
            bad = ~torch.isfinite(out)
            if bool(bad.any()):
                nan = int(torch.isnan(out).sum())
                raise FloatingPointError(f"{where}: {nan} NaN and {int(bad.sum()) - nan} "
                                         f"Inf of {out.numel()} values")
    elif isinstance(out, dict):
        for k, v in out.items():
            _check_finite(v, f"{where}[{k!r}]")
    elif isinstance(out, (list, tuple)):
        for i, v in enumerate(out):
            _check_finite(v, f"{where}[{i}]")


def nan_guard(fn: Callable, enabled: bool | None = None) -> Callable:
    """``fn`` with every floating tensor of its output (nested in tuples,
    lists and dicts) checked for NaN and Inf, raising ``FloatingPointError``
    naming the output. On where ``LFS2_DEBUG_NANS=1`` unless ``enabled``
    says; off, ``fn`` itself is returned."""
    if enabled is None:
        enabled = os.environ.get(NAN_SWITCH, "0") == "1"
    if not enabled:
        return fn
    name = getattr(fn, "__name__", repr(fn))

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        _check_finite(out, f"{name} output")
        return out

    return wrapper


def kernel_dump_to(path, names: Sequence[str] | None = None,
                   ptx: bool = True) -> Dict[str, Dict[str, Path]]:
    """Each kernel library's SASS (``cuobjdump -sass`` of the built
    library) as ``<path>/<name>.sass`` and, with ``ptx``, its PTX (the
    source through ``nvcc -ptx`` with the library's flags and macros) as
    ``<name>.ptx``; every source of ``kernels/build.py`` unless ``names``.
    Builds what is missing first. Raises where the toolkit has no
    ``cuobjdump``."""
    from lightningfastspeech2_tpu_torch.kernels import build

    nvcc = Path(build.find_nvcc())
    cuobjdump = nvcc.parent / "cuobjdump"
    if not cuobjdump.exists():
        raise RuntimeError(f"no cuobjdump beside {nvcc}: the CUDA toolkit's binary "
                           "utilities are needed to dump SASS")
    names = tuple(names or build.SOURCES)
    for name in names:
        build.load(name)
    out_dir = Path(path)
    out_dir.mkdir(parents=True, exist_ok=True)
    defines = [f for f in build._flags() if f.startswith("-D")]
    jobs, written = {}, {}
    for name in names:
        written[name] = {"sass": out_dir / f"{name}.sass"}
        jobs[(name, "sass")] = subprocess.Popen(
            [str(cuobjdump), "-sass", str(build.library_path(name))],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        if ptx:
            written[name]["ptx"] = out_dir / f"{name}.ptx"
            jobs[(name, "ptx")] = subprocess.Popen(
                [str(nvcc), "-ptx", "-arch=sm_90a", "-std=c++17", "-O3", *defines,
                 "-I", str(build.CSRC_DIR), "-o", str(written[name]["ptx"]),
                 str(build.CSRC_DIR / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    for (name, kind), proc in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{kind} of {name} failed:\n{text.decode(errors='replace')}")
        if kind == "sass":
            written[name]["sass"].write_bytes(text)
    return written
