"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` becomes its own shared library with a plain C
interface, compiled for ``sm_90a`` (``-gencode arch=compute_90a,code=sm_90a``)
at first use, all sources in parallel. Libraries are named after a hash of
their sources and flags, so an edited source is rebuilt and an unchanged
one is reused. The build directory, ``lightningfastspeech2_tpu_torch/_build``,
is listed in ``.gitignore``.

Nothing here runs at import time: the CPU tests import every module, and
this machine may have no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("probe", "ffn_ln", "ffn_ln_train_bwd", "ffn_wide", "flash_attention",
           "flash_attention_sm90", "flash_attention_wide", "resblock", "soft_dtw",
           "length_regulator", "lvc_stack")
# the dtype codes of csrc/common.cuh's DType, as the launchers take them
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# extra preprocessor macros, space-separated in LFS2_KERNEL_DEFINES (read at
# build time and part of each library's name): for measurements that build
# a variant, e.g. LFS2_FFN_NO_WGRAD_ATOMICS (csrc/ffn_sm90.cuh)
DEFINES_ENV = "LFS2_KERNEL_DEFINES"


def _flags():
    return NVCC_FLAGS + tuple(f"-D{d}" for d in os.environ.get(DEFINES_ENV, "").split())

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# filled by build_all(): per source, the seconds nvcc took (0.0 when the
# library was already built) and the ptxas report (registers, spills,
# shared memory per kernel)
build_report: Dict[str, Dict[str, object]] = {}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from csrc/ at "
        "first use on a machine with the CUDA toolkit"
    )


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(_flags()).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build_all() -> Dict[str, Dict[str, object]]:
    """Compile every missing library, one nvcc per source, all started
    together. Raises with nvcc's output when a build fails."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = {}
        for name in SOURCES:
            out = library_path(name)
            if out.exists():
                build_report.setdefault(name, {"seconds": 0.0, "ptxas": ""})
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *_flags(), "-I", str(CSRC_DIR), "-o", str(tmp),
                   str(CSRC_DIR / f"{name}.cu")]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending[name] = (proc, tmp, out, time.perf_counter())
        failures = []
        for name, (proc, tmp, out, t0) in pending.items():
            log, _ = proc.communicate()
            seconds = time.perf_counter() - t0
            if proc.returncode != 0:
                failures.append(f"--- nvcc {name}.cu (rc {proc.returncode})\n{log}")
                continue
            os.replace(tmp, out)
            build_report[name] = {"seconds": seconds, "ptxas": log}
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
        return dict(build_report)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib: Optional[ctypes.CDLL] = _libs.get(name)
    if lib is not None:
        return lib
    if not library_path(name).exists():
        build_all()
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            lib.lfs2_error_string.argtypes = [ctypes.c_int]
            lib.lfs2_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.lfs2_error_string(code).decode()
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code} ({msg})")
