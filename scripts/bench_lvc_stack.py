#!/usr/bin/env python3
"""Time ``lvc_stack`` (FastDiff's LVC chain of one upsample stage) on the card.

    python3 scripts/bench_lvc_stack.py [--tree DIR] [--label NAME] [--channels C]
        [--defines MACRO ...] [--phases] [--sweep] [--mma-rate] [--no-call]

First the card's name and power limit (nvidia-smi), then one JSON line per
shape: stages 1, 2 and 3 (hop 8, 64, 256) of a 512-frame bucket at B=1 in
bf16 and f32, the Padé gate at stage 3, and stage 3 at B=8 (the served
batch at bucket 512), each with its time (CUDA events, warmed up, L2 warm),
the launch as planned and as the library recorded it where the tree has
``lvc_plan``, and its bound at the H100's published peaks. Then one
512-frame FastDiff vocoder call (the flagship's FastDiff at the reference
widths, N=4) per dtype under torch.profiler: device ms and ``lvc_stack``
ms.

``--tree DIR`` imports the port from DIR (an unpacked checkout, e.g. the
parent commit) instead of this checkout, so two trees can be timed in turns
in one run on one card. ``--channels C`` times the chain at C inner
channels (default 32, FastDiff's reference width; a tree whose kernel takes
other widths takes C up to 128, padded past its built ones as its wrapper
pads them, and one with the wide route any C past 128: ``--channels 256``
times that route, its conv and LVC launches together, the vocoder call's
``lvc_stack_ms`` summing both). The inputs are drawn on the card.
``--defines`` adds preprocessor macros to every
kernel build (``LFS2_KERNEL_DEFINES``, part of the libraries' names);
``--phases`` adds ``LFS2_LVC_PHASE_CLOCKS`` and prints, per shape, the
cycles of each phase of one block, per warp (the tensor-core route only).
``--sweep`` times, per B=1 shape, every tensor-core launch that fits a
block (tile, frames staged a round, n8 tiles a chunk), calling the library
directly, each checked against the plain version: the data behind
``lvc_plan``'s choice. ``--mma-rate`` builds and runs a small CUDA program
(``MMA_RATE_CU``) that measures the card's ``mma.sync`` rates, m16n8k8 TF32
and m16n8k16 bf16: split TF32 forms an f32-accurate product from three
TF32 ones, so the TF32 rate over three is the f32 route's ceiling.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
# f32-accurate products: three TF32 products each on the tensor cores
PEAK_F32_ACCURATE = max(67e12, 495e12 / 3)
FRAMES = 512
C, LAYERS = 32, 4
PHASES = ("loads", "wait copies", "reorder kernels", "conv", "wait conv", "lvc products",
          "lvc epilogue", "output")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, min_total_ms: float = 200.0, max_iters: int = 50) -> float:
    """Mean time of ``fn``: CUDA events around a run of calls after a
    warm-up, enough calls to fill ``min_total_ms``."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    torch.cuda.synchronize()
    iters = int(min(max_iters, max(3, min_total_ms / max(a.elapsed_time(b), 1e-3))))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def inputs(B, hop, dtype, dev, seed):
    """chip_smoke.py _lvc_case's draws at B items of a FRAMES-frame bucket,
    on the card (the frame kernels at B = 8 and C = 256 are 3.2G values)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    L = FRAMES * hop

    def draw(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    x = draw(B, L, C).to(dtype)
    ad = draw(B, L, C).to(dtype)
    k = (0.2 * draw(B, FRAMES, LAYERS, C, 2 * C, 3)).to(dtype)
    b = (0.1 * draw(B, FRAMES, LAYERS, 2 * C)).to(dtype)
    cw = (0.1 * draw(LAYERS, 3, C, C)).to(dtype)
    cb = 0.1 * draw(LAYERS, C)
    return (x, ad, k, b, cw, cb, hop)


def _width() -> tuple:
    """``lvc_plan``'s width argument: none at C = 32, so that trees from
    before the kernel took other widths are timed too."""
    return () if C == 32 else (C,)


def bound(args, dtype):
    """(bytes ms, operations ms): each input read once and the output
    written once; the conv (3C x C) and LVC (3C x 2C) products per row and
    layer at the dtype's peak (split TF32 for f32)."""
    x = args[0]
    B, L, _ = x.shape
    nbytes = sum(t.numel() * t.element_size() for t in args[:6]) + x.numel() * x.element_size()
    flops = B * L * LAYERS * 2 * (3 * C * C + 3 * C * 2 * C)
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32_ACCURATE
    return nbytes / PEAK_BYTES_PER_S * 1e3, flops / peak * 1e3


CASES = (  # (hop, dtype, B, fast gate)
    (256, torch.bfloat16, 1, False), (64, torch.bfloat16, 1, False),
    (8, torch.bfloat16, 1, False), (256, torch.float32, 1, False),
    (64, torch.float32, 1, False), (8, torch.float32, 1, False),
    (256, torch.bfloat16, 1, True), (256, torch.bfloat16, 8, False),
)


def shapes(dev, label) -> None:
    from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc as lvc

    for hop, dtype, B, fast in CASES:
        args = inputs(B, hop, dtype, dev, seed=hop + B)
        ms = cuda_ms(lambda: lvc.lvc_stack(*args, fast_gating=fast))
        row = {"phase": "lvc_stack", "label": label,
               "channels": C,
               "at": f"x ({B}, {FRAMES * hop}, {C}) {str(dtype)[6:]}, hop {hop}, "
                     f"{'Padé' if fast else 'exact'} gate",
               "stage": {8: 1, 64: 2, 256: 3}[hop], "ms": ms}
        row["bytes_ms"], row["ops_ms"] = bound(args, dtype)
        if hasattr(lvc, "lvc_plan"):
            row["plan"] = lvc.lvc_plan(B, FRAMES * hop, hop, LAYERS, dtype, *_width()).record
            row["launch"] = lvc.last_launch()
        emit(row)


def phase_clocks(dev) -> None:
    """Per shape, the cycles of each phase of the middle block of item 0,
    per warp, from a build with LFS2_LVC_PHASE_CLOCKS."""
    import ctypes

    from lightningfastspeech2_tpu_torch.kernels import build
    from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc as lvc

    lib = build.load("lvc_stack")
    fn = lib.lfs2_lvc_stack_phase_clocks
    fn.argtypes = [ctypes.c_void_p]
    buf = (ctypes.c_longlong * 128)()
    for hop, dtype, B, fast in CASES:
        args = inputs(B, hop, dtype, dev, seed=hop + B)
        lvc.lvc_stack(*args, fast_gating=fast)
        torch.cuda.synchronize()
        build.check(lib, fn(buf), "lvc_stack_phase_clocks")
        per_warp = [list(buf[8 * w:8 * w + 8]) for w in range(16)]
        emit({"phase": "lvc_phase_cycles", "stage": {8: 1, 64: 2, 256: 3}[hop],
              "dtype": str(dtype)[6:], "B": B, "fast": fast,
              "launch": lvc.last_launch(),
              "max_over_warps": dict(zip(PHASES, [max(w[i] for w in per_warp) for i in range(8)])),
              "per_warp": per_warp})


def sweep(dev) -> None:
    """Every tensor-core launch of each B=1 shape that the library takes,
    timed; the plan's own launch marked."""
    from lightningfastspeech2_tpu_torch.kernels import build
    from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc as lvc

    fn = lvc._fn()[1]   # the fused chain's launcher
    widths = hasattr(lvc, "KERNEL_CHANNELS")   # the library takes C (and route 2)
    for hop, dtype, B, fast in CASES:
        if B != 1 or fast:
            continue
        args = inputs(B, hop, dtype, dev, seed=hop + B)
        x, ad, k, b, cw, cb, _ = args
        b = b.float()
        ref = lvc.lvc_stack_plain(*args).float()
        plan = lvc.lvc_plan(B, FRAMES * hop, hop, LAYERS, dtype, *_width())
        if widths and plan.channels != C or plan.route == "wide":
            continue   # the sweep calls the fused chain at a width it is built at
        direct = widths and lvc.mma_direct(dtype, C)
        out = torch.empty_like(x)
        rows = []
        for tile in (512, 256, 192, 128, 96, 64, 32):
            for rf in ((0,) if direct else range(1, 9)):
                for nt in (4, 2, 1):
                    def launch():
                        shape = (B, FRAMES * hop, C) if widths else (B, FRAMES * hop)
                        return fn(x.data_ptr(), ad.data_ptr(), k.data_ptr(), b.data_ptr(),
                                  cw.data_ptr(), cb.data_ptr(), out.data_ptr(), *shape,
                                  hop, LAYERS, tile, 0, build.DTYPE_CODES[dtype],
                                  2 if direct else 1, rf, nt,
                                  torch.cuda.current_stream().cuda_stream)

                    if launch() != 0:  # the library refuses what does not fit
                        continue
                    torch.cuda.synchronize()
                    err = (out.float() - ref).abs().max().item()
                    rows.append({"tile": tile, "round_frames": rf, "nt": nt,
                                 "ms": cuda_ms(launch, min_total_ms=50.0), "max_abs_err": err,
                                 "plan": (tile, rf, nt) == (plan.tile, plan.round_frames,
                                                            plan.nt)})
        rows.sort(key=lambda r: r["ms"])
        emit({"phase": "lvc_sweep", "stage": {8: 1, 64: 2, 256: 3}[hop],
              "dtype": str(dtype)[6:], "plan": plan.record, "fastest": rows[:8],
              "plan_rank": next(i for i, r in enumerate(rows) if r["plan"]),
              "launches_timed": len(rows)})


# each warp issues 8 independent products an iteration, two blocks an SM
MMA_RATE_CU = r"""
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

template <bool TF32>
__global__ void products(float* out, int iters) {
  float acc[8][4] = {};
  const uint32_t a[4] = {threadIdx.x, threadIdx.x * 3u, threadIdx.x * 5u, threadIdx.x * 7u};
  const uint32_t b[2] = {threadIdx.x * 11u, threadIdx.x * 13u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (TF32)
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
            "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
            : "+f"(acc[j][0]), "+f"(acc[j][1]), "+f"(acc[j][2]), "+f"(acc[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
    }
  }
  float s = 0.0f;
  for (int j = 0; j < 8; ++j) s += acc[j][0] + acc[j][1] + acc[j][2] + acc[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;  // keeps the products live
}

int main() {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int threads = 512, blocks = 2 * sms, iters = 4096;
  float* out = nullptr;
  cudaMalloc(&out, sizeof(float) * blocks * threads);
  for (const bool tf32 : {true, false}) {
    auto kernel = tf32 ? products<true> : products<false>;
    cudaEvent_t e0, e1;
    cudaEventCreate(&e0);
    cudaEventCreate(&e1);
    kernel<<<blocks, threads>>>(out, 16);  // warm-up
    cudaEventRecord(e0);
    kernel<<<blocks, threads>>>(out, iters);
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms = 0.0f;
    cudaEventElapsedTime(&ms, e0, e1);
    const double mmas = double(blocks) * threads / 32 * iters * 8;
    const double flop = mmas * 2.0 * 16 * 8 * (tf32 ? 8 : 16);
    printf("{\"mma\": \"%s\", \"ms\": %.4f, \"tflops\": %.1f, \"mma_per_sm_per_us\": %.1f}\n",
           tf32 ? "m16n8k8 tf32" : "m16n8k16 bf16", ms, flop / ms / 1e9, mmas / sms / (ms * 1e3));
  }
  const cudaError_t err = cudaGetLastError();
  cudaFree(out);
  return err == cudaSuccess ? 0 : 1;
}
"""


def mma_rate() -> None:
    """``MMA_RATE_CU`` built with nvcc for sm_90a and run: one JSON line
    per product shape."""
    from lightningfastspeech2_tpu_torch.kernels import build

    with tempfile.TemporaryDirectory() as d:
        src, exe = Path(d) / "mma_rate.cu", Path(d) / "mma_rate"
        src.write_text(MMA_RATE_CU)
        subprocess.run([build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-o", str(exe), str(src)], check=True, timeout=600)
        out = subprocess.run([str(exe)], capture_output=True, text=True, check=True,
                             timeout=120).stdout
    for line in out.splitlines():
        emit({"phase": "mma_sync_rate", **json.loads(line)})


def vocoder_calls(dev, label) -> None:
    """One 512-frame FastDiff vocoder call per dtype (FastDiff at C inner
    channels): warmed up, then once under torch.profiler; device ms and
    lvc_stack ms (kernels by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship, replace
    from lightningfastspeech2_tpu_torch.synthesis.generator import FastDiffSynthesiser

    cfg = lightspeech_flagship()
    model_cfg = replace(cfg.model, fastdiff_vocoder=True,
                        **({"fastdiff_inner_channels": C} if C != 32 else {}))
    mel = (np.random.default_rng(5).standard_normal((FRAMES, model_cfg.audio.n_mels)) - 4.0
           ).astype(np.float32)
    for precision in (16, 32):
        synth = FastDiffSynthesiser(model_cfg, vocoder_precision=precision, device=dev, seed=1)
        synth(mel)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            synth(mel)
            torch.cuda.synchronize()
        events = prof.key_averages()
        host = {e.key for e in events if e.device_type == DeviceType.CPU}
        dev_us = lvc_us = 0.0
        lvc_n = 0
        for e in events:
            if e.device_type != DeviceType.CUDA or e.key in host or e.self_device_time_total <= 0:
                continue
            dev_us += e.self_device_time_total
            if re.search(r"\b(lvc_mma_kernel|lvc_stack_kernel|lvc_wide_kernel)\b|wide::ConvRows",
                         e.key):
                lvc_us += e.self_device_time_total
                lvc_n += e.count
        emit({"phase": "fastdiff_vocoder_call", "label": label, "frames": FRAMES,
              "dtype": "bfloat16" if precision == 16 else "float32",
              "device_ms": dev_us / 1e3, "lvc_stack_ms": lvc_us / 1e3,
              "lvc_stack_launches": lvc_n})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--channels", type=int, default=32)
    ap.add_argument("--defines", nargs="*", default=[])
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--mma-rate", action="store_true")
    ap.add_argument("--no-call", action="store_true")
    a = ap.parse_args()
    global C
    C = a.channels
    defines = list(a.defines) + (["LFS2_LVC_PHASE_CLOCKS"] if a.phases else [])
    if defines:
        os.environ["LFS2_KERNEL_DEFINES"] = " ".join(defines)
    if not torch.cuda.is_available():
        print("bench_lvc_stack: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    root = Path(a.tree).resolve() if a.tree else Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import lightningfastspeech2_tpu_torch as pkg

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "label": a.label, "package": str(Path(pkg.__file__).parent),
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi, "defines": defines,
          "channels": C})
    dev = torch.device("cuda", 0)
    if a.phases:
        phase_clocks(dev)
        return 0
    if a.sweep:
        sweep(dev)
        return 0
    if a.mma_rate:
        mma_rate()
        return 0
    shapes(dev, a.label)
    if not a.no_call:
        vocoder_calls(dev, a.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
