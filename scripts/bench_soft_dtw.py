#!/usr/bin/env python3
"""Time the soft-DTW kernels (``csrc/soft_dtw.cu``) on the card.

    python3 scripts/bench_soft_dtw.py [--tree DIR] [--label NAME] [--sweep | --floor | --latency]

First the card's name and power limit (nvidia-smi), then one JSON line per
shape: the forward and backward kernels' times (CUDA events, warmed up, L2
warm), the value and dD against the plain recurrence's autograd
(``soft_dtw_from_dist_plain``), and the byte bound of each kernel: the
function's own bytes at the H100's 3.35 TB/s, the same for every tree (the
forward D in and one float a cell out, the backward that float in and dD
out), with the bytes the tree's residual moves beyond them beside it. The shapes: the mel loss's lattices at the flagship's
training step (64 x 256 x 256 from 80 mel channels, gamma 0.1), the f32
reference step's (8 x 256 x 256), and the card test's.

``--tree DIR`` imports the port from DIR (an unpacked checkout, e.g. the
parent commit) instead of this checkout, so two trees can be timed in
turns in one run on one card; a tree without ``soft_dtw_plan`` is timed
through its own API (the R lattice as the residual). ``--sweep`` times, at
each shape, the launch of every rows-a-thread the library is built for
(``FWD_STEPS``, ``BWD_STEPS``), each held against the plain kernel
contract: the data behind ``soft_dtw_plan``.
``--floor`` builds with ``LFS2_SOFT_DTW_NO_MEMORY`` (every global load and
store of the chain taken out) and times one lattice and 64 at 256 x 256:
the chain's own floor. ``--latency`` builds and runs a small CUDA program
(``LATENCY_CU``) that times dependent chains of the operations on the
forward's chain, in cycles, and the clock.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

PEAK_BYTES_PER_S = 3.35e12
# (label, L, N, M, gamma, mel-like D)
SHAPES = (
    ("mel loss, flagship step", 64, 256, 256, 0.1, True),
    ("mel loss, f32 reference step", 8, 256, 256, 0.1, True),
    ("card test", 4, 256, 256, 1.0, False),
    ("card test", 4, 256, 256, 0.1, False),
    ("card test", 3, 31, 57, 0.1, False),
    ("card test", 2, 1100, 1100, 0.1, False),
    ("card test", 5, 8, 300, 0.1, False),
    ("card test", 2, 4096, 64, 0.1, False),
)


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


def graph_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, replayed ``replays`` times between CUDA events (no host time
    between the kernels)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (calls * replays)


def lattices(L, N, M, mel, dev, seed):
    """D (L, N, M): squared distances of a small prediction against unit
    targets over 80 channels (R reaches ~1e4, as in the mel loss), or
    uniform in [0, 2) as in the card test."""
    g = torch.Generator().manual_seed(seed)
    if mel:
        from lightningfastspeech2_tpu_torch.ops.soft_dtw import pairwise_sqdist

        pred = (0.5 * torch.randn(L, N, 80, generator=g)).to(dev, torch.bfloat16)
        truth = torch.randn(L, M, 80, generator=g).to(dev)
        return pairwise_sqdist(pred, truth).contiguous()
    return (torch.rand(L, N, M, generator=g) * 2.0).to(dev)


def kernel_calls(sd, D, gamma, up):
    """(forward call, backward call) through the tree's own API."""
    N = D.shape[1]
    _, res = sd.soft_dtw_fwd(D, gamma)
    if "N" in inspect.signature(sd.soft_dtw_bwd).parameters:
        return (lambda: sd.soft_dtw_fwd(D, gamma)), (lambda: sd.soft_dtw_bwd(res, up, N)), res
    return (lambda: sd.soft_dtw_fwd(D, gamma)), (lambda: sd.soft_dtw_bwd(res, up, gamma)), res


def shapes(dev, label) -> None:
    from lightningfastspeech2_tpu_torch.ops import soft_dtw as sd

    for n, (what, L, N, M, gamma, mel) in enumerate(SHAPES):
        D = lattices(L, N, M, mel, dev, seed=n)
        up = torch.linspace(0.5, 1.5, L, device=dev)
        at = f"{what}: ({L}, {N}, {M}) gamma {gamma}"
        try:
            fwd, bwd, res = kernel_calls(sd, D, gamma, up)
        except RuntimeError as err:   # a tree whose kernels refuse the shape
            emit({"phase": "soft_dtw", "label": label, "at": at, "error": str(err)})
            continue
        Dk = D.clone().requires_grad_(True)
        val = sd.soft_dtw_from_dist(Dk, gamma)
        (grad,) = torch.autograd.grad(val, Dk, up)
        Dp = D.clone().requires_grad_(True)
        ref = sd.soft_dtw_from_dist_plain(Dp, gamma)
        (ref_grad,) = torch.autograd.grad(ref, Dp, up)
        cells = D.numel()
        res_bytes = res.numel() * 4
        # the function's bytes: each input read once, each output written
        # once, with one float a cell (R) between the two kernels
        bound_ms = (8 * cells + 4 * L) / PEAK_BYTES_PER_S * 1e3
        row = {"phase": "soft_dtw", "label": label, "at": at,
               "fwd_ms": graph_ms(fwd), "bwd_ms": graph_ms(bwd),
               "fwd_call_ms": cuda_ms(fwd), "bwd_call_ms": cuda_ms(bwd),
               "value_rel_err": ((val - ref).abs() / ref.abs()).max().item(),
               "dD_err_of_largest": ((grad - ref_grad).abs().max()
                                     / ref_grad.abs().max()).item(),
               "fwd_bound_ms": bound_ms, "bwd_bound_ms": bound_ms,
               "residual_bytes": res_bytes,
               "residual_extra_bytes_a_cell": (res_bytes - 4 * cells) / cells,
               "serial_diagonals": N + M - 1}
        if hasattr(sd, "soft_dtw_plan"):
            plan = sd.soft_dtw_plan(L, N, M)
            row["plan"] = {"fwd": plan.fwd.record, "bwd": plan.bwd.record}
            row["launch"] = sd.last_launch()
        emit(row)


def sweep(dev) -> None:
    """At each shape, the launch of every rows-a-thread K the library is
    built for (its chunk lengths ``FWD_STEPS[K]``, ``BWD_STEPS[K]``), timed
    and held against the plain kernel contract; the plan's own launch
    marked."""
    from lightningfastspeech2_tpu_torch.ops import soft_dtw as sd

    _, ffn, bfn = sd._fns()
    for n, (what, L, N, M, gamma, mel) in enumerate(SHAPES):
        D = lattices(L, N, M, mel, dev, seed=n)
        up = torch.linspace(0.5, 1.5, L, device=dev)
        plan = sd.soft_dtw_plan(L, N, M)
        ref_v, ref_Ws = sd._skewed_weights(D, gamma)
        ref_dD = sd.soft_dtw_bwd_plain(sd._skewed_to_bands(ref_Ws, N, M, 1), up, N)
        c, gl = sd._softmin_constants(gamma)
        value = torch.empty(L, device=dev)
        dD = torch.empty(L, N, M, device=dev)
        rows = {"fwd": [], "bwd": []}
        for K in sd.FWD_STEPS:
            warps = sd._warps(N, K)
            W = torch.empty(sd.residual_bands(L, N, M, K), device=dev)
            ref_W = sd._skewed_to_bands(ref_Ws, N, M, K)
            on = sd._band_cells(N, M, K, dev)[2][:, :, None, :].expand(-1, -1, 3, -1)
            for part, P in (("fwd", sd.FWD_STEPS[K]), ("bwd", sd.BWD_STEPS[K])):
                if part == "fwd":
                    smem = sd.fwd_smem_bytes(warps, K, P)

                    def launch():
                        return ffn(D.data_ptr(), W.data_ptr(), value.data_ptr(), L, N, M, c, gl,
                                   K, warps, P, smem, torch.cuda.current_stream().cuda_stream)
                else:
                    smem = sd.bwd_smem_bytes(warps, K, P)

                    def launch():
                        return bfn(ref_W.data_ptr(), up.data_ptr(), dD.data_ptr(), L, N, M, K,
                                   warps, P, smem, torch.cuda.current_stream().cuda_stream)

                if launch() != 0:  # more threads than a block holds
                    continue
                torch.cuda.synchronize()
                if part == "fwd":
                    err = max(((value - ref_v).abs() / ref_v.abs()).max().item(),
                              (W - ref_W).abs()[:, on].max().item())
                else:
                    err = ((dD - ref_dD).abs().max() / ref_dD.abs().max()).item()
                rec = {"rows_per_thread": K, "threads": 32 * warps, "steps": P,
                       "smem_bytes": smem, "blocks": L}
                rows[part].append({**rec, "ms": graph_ms(launch), "err": err,
                                   "plan": rec == getattr(plan, part).record})
        for part in ("fwd", "bwd"):
            timed = sorted(rows[part], key=lambda r: r["ms"])
            emit({"phase": f"soft_dtw_sweep_{part}", "at": f"{what}: ({L}, {N}, {M}) gamma {gamma}",
                  "plan": getattr(plan, part).record, "timed": timed,
                  "plan_rank": next((i for i, r in enumerate(timed) if r["plan"]), None)})


def floor(dev) -> None:
    """The no-memory build at 256 x 256 (gamma 0.1), one lattice and 64."""
    from lightningfastspeech2_tpu_torch.ops import soft_dtw as sd

    for L in (1, 64):
        D = lattices(L, 256, 256, True, dev, seed=0)
        up = torch.ones(L, device=dev)
        fwd, bwd, _ = kernel_calls(sd, D, 0.1, up)
        emit({"phase": "soft_dtw_floor", "defines": os.environ.get("LFS2_KERNEL_DEFINES"),
              "at": f"({L}, 256, 256) gamma 0.1", "fwd_ms": graph_ms(fwd), "bwd_ms": graph_ms(bwd),
              "serial_diagonals": 511, "launch": sd.last_launch()})


# One warp times dependent chains of the operations on the forward's chain,
# and the clock against the global timer; one JSON line.
LATENCY_CU = r"""
#include <cstdio>
#include <cuda_runtime.h>
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float lg2(float x) {
  float y;
  asm volatile("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__global__ void probe(float* out, long long* cyc, int n) {
  float x = threadIdx.x * 1e-3f;
  long long c0 = clock64();
  const unsigned long long g0 = gtime();
  while (clock64() - c0 < 20000000) {}
  long long c1 = clock64();
  const unsigned long long g1 = gtime();
  cyc[0] = c1 - c0;
  cyc[1] = g1 - g0;
  c0 = clock64();
  for (int i = 0; i < n; ++i) x = ex2(x * -0.5f);
  cyc[2] = clock64() - c0;
  c0 = clock64();
  for (int i = 0; i < n; ++i) x = lg2(x + 2.0f);
  cyc[3] = clock64() - c0;
  c0 = clock64();
  for (int i = 0; i < n; ++i) x = __shfl_up_sync(0xffffffffu, x, 1) + 1.0f;
  cyc[4] = clock64() - c0;
  c0 = clock64();
  for (int i = 0; i < n; ++i) x = x * 0.999f + 1.0f;
  cyc[5] = clock64() - c0;
  c0 = clock64();
  for (int i = 0; i < n; ++i) x = fminf(x, 3.0f - x);
  cyc[6] = clock64() - c0;
  out[threadIdx.x] = x;
}
int main() {
  float* out;
  long long* cyc;
  cudaMalloc(&out, 128);
  cudaMallocManaged(&cyc, 64);
  const int n = 4096;
  for (int rep = 0; rep < 2; ++rep) {
    probe<<<1, 32>>>(out, cyc, n);
    cudaDeviceSynchronize();
  }
  printf("{\"clock_ghz\": %.4f, \"ex2_fmul\": %.2f, \"lg2_fadd\": %.2f, \"shfl_fadd\": %.2f, "
         "\"ffma\": %.2f, \"fmin_fadd\": %.2f}\n", (double)cyc[0] / cyc[1],
         (double)cyc[2] / n, (double)cyc[3] / n, (double)cyc[4] / n, (double)cyc[5] / n,
         (double)cyc[6] / n);
  return 0;
}
"""


def latency() -> None:
    """``LATENCY_CU`` built with nvcc for sm_90a and run: cycles a step of
    each dependent chain (an ex2 and its argument's product, an lg2 and an
    add, a shuffle and an add, an FMA, a min and an add)."""
    from lightningfastspeech2_tpu_torch.kernels import build

    with tempfile.TemporaryDirectory() as d:
        src, exe = Path(d) / "latency.cu", Path(d) / "latency"
        src.write_text(LATENCY_CU)
        subprocess.run([build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                        "-o", str(exe), str(src)], check=True, timeout=600)
        out = subprocess.run([str(exe)], capture_output=True, text=True, check=True,
                             timeout=120).stdout
    emit({"phase": "latency_cycles", **json.loads(out)})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--floor", action="store_true")
    ap.add_argument("--latency", action="store_true")
    a = ap.parse_args()
    if a.floor:
        os.environ["LFS2_KERNEL_DEFINES"] = "LFS2_SOFT_DTW_NO_MEMORY"
    if not torch.cuda.is_available():
        print("bench_soft_dtw: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    root = Path(a.tree).resolve() if a.tree else Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    import lightningfastspeech2_tpu_torch as pkg
    from lightningfastspeech2_tpu_torch.kernels import build

    build.SOURCES = ("soft_dtw",)  # the one library timed here

    torch.backends.cuda.matmul.allow_tf32 = False
    emit({"phase": "device", "label": a.label, "package": str(Path(pkg.__file__).parent),
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    dev = torch.device("cuda", 0)
    if a.latency:
        latency()
    elif a.floor:
        floor(dev)
    elif a.sweep:
        sweep(dev)
    else:
        shapes(dev, a.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
