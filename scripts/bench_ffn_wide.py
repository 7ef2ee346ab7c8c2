#!/usr/bin/env python3
"""Time the serving FFN half at C = 384-640 (``ops/ffn.py ffn_ln`` on the
wide route) on one Hopper card, in both dtypes.

    python3 scripts/bench_ffn_wide.py [--tree DIR] [--label NAME] [--phases]

Prints the card's name and power limit (nvidia-smi), then one JSON line per
shape and dtype: the call's CUDA-event ms (a run of calls between two
events, warmed up, L2 warm), its device ms and kernels a call from
``torch.profiler`` (``chip_smoke.device_kernels``), the largest distance
from ``ffn_ln_plain`` on the same inputs, the plain version's event ms, the
bound (bytes at 3.35 TB/s or operations at bf16's 989 TFLOP/s, f32 as split
TF32 at 165) and the library's launch record (grid, shared memory, rows
and, where the tree records them, the cluster, the clusters the card holds
at once and the LN2 pass).

Shapes: ``chip_smoke.WIDE_FFN_SHAPES`` (lightspeech_true76m's request and
batch buckets at k = 5, 17, 25, an encoder launch at a sentence's phones,
and C = 384, 512 at the batch), F = 4 C, weights from a seeded FFT block.

``--phases`` builds with ``LFS2_FFN_PHASE_CLOCKS`` (``csrc/ffn_sm90.cuh``)
and adds, per shape, the cycles ``ffn_wide_kernel``'s first two warps (one
of each warpgroup) spent in each phase of a chunk, summed over the blocks
of row tile 0 of item 0 (one a split) and divided by their chunks; its
times are of that build.

``--tree DIR`` imports the port from DIR instead of this checkout: an
unpacked checkout, e.g. a parent commit made with ``git archive <commit>
lightningfastspeech2_tpu_torch | tar -x -C DIR``. Two trees are then timed
in turns in one chip call: parent, change, change, parent. Only
``csrc/ffn_ln.cu`` is built.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
from chip_smoke import (PEAK_F32_ACCURATE, WIDE_FFN_SHAPES, bound_ms,  # noqa: E402
                        cuda_ms, device_kernels, tensor_bytes)

PROFILED_CALLS = 20
# ffn_wide_kernel's FFN_PHASE slots
PHASES = ("prologue", "wait W1", "up", "up epilogue", "wait staging", "wait W2f", "down",
          "store")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def phase_cycles(lib, fn, nch: int) -> list:
    """One call of ``fn`` with the phase clocks zeroed before: per
    warpgroup, the cycles a chunk of each phase over the blocks of row
    tile 0 of item 0 (every split's, ``nch`` chunks together)."""
    buf = (ctypes.c_longlong * 32)()
    lib.lfs2_ffn_ln_phase_clocks(buf)
    fn()
    torch.cuda.synchronize()
    lib.lfs2_ffn_ln_phase_clocks(buf)
    return [{n: buf[16 * wg + i] / nch for i, n in enumerate(PHASES)} for wg in range(2)]


def case(dev, label, B, T, C, k, dtype, phases=False) -> None:
    from lightningfastspeech2_tpu_torch.kernels import build
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import init_weights
    from lightningfastspeech2_tpu_torch.models.layers import FFTBlock
    from lightningfastspeech2_tpu_torch.ops import ffn

    F = 4 * C
    g = torch.Generator().manual_seed(16)
    block = FFTBlock(C, 2, k, F, dtype)
    init_weights(block, g)
    with torch.no_grad():
        for n in (block.norm1, block.norm2):
            n.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
            n.bias.copy_(0.1 * torch.randn(C, generator=g))
    block.to(dev)
    w = block.ffn_weights
    z = torch.randn(B, T, C, generator=g).to(dev, dtype)
    with torch.no_grad():
        out, ref = ffn.ffn_ln(z, w), ffn.ffn_ln_plain(z, w)
        torch.cuda.synchronize()
        row = {"phase": "ffn_wide", "label": label, "at": f"({B}, {T}, {C}) {str(dtype)[6:]}",
               "k": k, "max_abs_err": (out.float() - ref.float()).abs().max().item()}
        # the library's launch record as it stands (an older tree records
        # fewer fields: its first five are grid, shared memory and rows)
        record = (ctypes.c_int * 12)()
        build.load("ffn_ln").lfs2_ffn_ln_last_launch(record)
        row["launch_record"] = list(record)
        row["ms"] = cuda_ms(lambda: ffn.ffn_ln(z, w), min_total_ms=300.0, max_iters=300)
        prof = device_kernels(lambda: ffn.ffn_ln(z, w), PROFILED_CALLS)
        row.update(device_ms=prof["device_ms"], kernels=prof["kernels"], by_name=prof["by_name"])
        row["plain_ms"] = cuda_ms(lambda: ffn.ffn_ln_plain(z, w))
        if phases:
            row["cycles_a_chunk"] = phase_cycles(build.load("ffn_ln"), lambda: ffn.ffn_ln(z, w),
                                                 F // 32)
    flops = B * T * (2 * k * C + 4 * C * F)
    nbytes = 2 * tensor_bytes(z) + tensor_bytes(w.wd, w.w1, w.b1, w.w2f, w.lnp)
    f32 = dtype == torch.float32
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype,
                                                PEAK_F32_ACCURATE if f32 else None)
    emit(row)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--phases", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_ffn_wide: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if a.phases:
        os.environ["LFS2_KERNEL_DEFINES"] = "LFS2_FFN_PHASE_CLOCKS"
    root = Path(a.tree).resolve() if a.tree else HERE
    sys.path.insert(0, str(root))
    import lightningfastspeech2_tpu_torch as pkg
    from lightningfastspeech2_tpu_torch.kernels import build

    build.SOURCES = ("ffn_ln",)  # the one library timed here
    build.build_all()
    emit({"phase": "device", "label": a.label, "package": str(Path(pkg.__file__).parent),
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "build_s": {n: r["seconds"] for n, r in build.build_report.items()}})
    dev = torch.device("cuda", 0)
    for B, T, C, k in WIDE_FFN_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            case(dev, a.label, B, T, C, k, dtype, a.phases)
    return 0


if __name__ == "__main__":
    sys.exit(main())
