#!/usr/bin/env python3
"""Time the length regulator's kernels (``csrc/length_regulator.cu``) on the card.

    python3 scripts/bench_length_regulator.py [--tree DIR] [--label NAME] [--sweep]

First the card's name and power limit (nvidia-smi) and the device time of
the smallest launch, a fill of one element (the floor under a small
grid's time), then one JSON line per shape, with ``LFS2_PALLAS_LR``
irrelevant (``regulate_kernel`` is called directly):

- ``fwd`` / ``bwd``: the regulator's own kernel, its CUDA-event ms (a run of
  wrapper calls between two events, warmed up, L2 warm: the host's pace
  where the host is slower than the card) and its device ms a launch from
  ``torch.profiler`` ``key_averages()`` (the mean of the records: the
  profiler now and then drops one, see ``chip_smoke.device_kernels``);
- ``fwd_call`` / ``fwd_call_no_grad`` / ``bwd_call``: the whole
  ``regulate_kernel`` call, mask included, with x needing its gradient (as
  in training) and under ``torch.no_grad`` (as in serving), and its
  backward through autograd: event ms, device ms, host µs a call
  (``HOST_CALLS`` calls on the host clock, one synchronise), and the
  device kernels one call launches, by name, from the profiler;
- ``gather`` / ``gather_bwd``: the same for ``torch.gather`` on a
  precomputed frame -> phone index and for its backward;
- the byte bound of each direction at the H100's 3.35 TB/s: the bytes this
  run's data needs, each read or written once (forward: the durations, the
  x rows that own a frame below T, frames, mask, ends; backward: g's frames
  below each item's total, ends, dx), and ``*_whole_ms`` with x and g
  counted whole;
- the forward bit for bit against ``regulate_plain``, the mask equal, and
  the gradient's largest distance in bf16 ulps from the f32 gather's
  gradient rounded once.

The shapes: the flagship's training step, (8, 256, 256) -> 2048 frames in
bf16 and f32; a one-sentence request bucket, (1, 64, 256) -> 512; the
``lightspeech_true76m`` width, (8, 256, 640) -> 2048; long items, (2, 1024,
256) -> 8192. Durations are int64, as the model rounds them: 1 to 13 frames,
a zero every fifth phone, and item 0 at 10 frames a phone (above T) where
there is more than one item.

``--tree DIR`` imports the port from DIR (an unpacked checkout, e.g. the
parent commit) instead of this checkout, so two trees can be timed in turns
in one chip call; a tree whose ``regulate_fwd`` takes the running sums
(``ends``) is timed through that API. ``--sweep`` times the forward kernel
at every frames-a-block and the backward kernel at every warps-a-phone the
library takes, at each shape (this tree only).
"""

from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
from chip_smoke import device_kernels  # noqa: E402  (this checkout's, whichever tree is timed)

PEAK_BYTES_PER_S = 3.35e12
HOST_CALLS = 2000
PROFILED_CALLS = 50
# (label, B, P, H, T, dtype)
SHAPES = (
    ("flagship training step", 8, 256, 256, 2048, torch.bfloat16),
    ("flagship training step, f32", 8, 256, 256, 2048, torch.float32),
    ("one-sentence request bucket", 1, 64, 256, 512, torch.bfloat16),
    ("lightspeech_true76m width", 8, 256, 640, 2048, torch.bfloat16),
    ("long items", 2, 1024, 256, 8192, torch.bfloat16),
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, min_total_ms: float = 200.0, max_iters: int = 200) -> float:
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


def host_us(fn, n: int = HOST_CALLS) -> float:
    """Host-clock µs a call of ``fn`` over ``n`` calls, one synchronise."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def regulator_kernel(prof: dict) -> dict:
    """The regulator's own kernel in a ``device_kernels`` record."""
    mine = {k: v for k, v in prof["by_name"].items() if "regulate" in k}
    return {"name": sorted(mine), "device_ms": sum(v["ms"] * v["a_call"] for v in mine.values()),
            "a_call": sum(v["a_call"] for v in mine.values())}


def bounds(x, d, ends, T) -> dict:
    """Each direction's byte bound at 3.35 TB/s: the bytes this run's data
    needs, each read or written once (forward: the durations, the x rows
    that own a frame below T, frames, mask, ends; backward: g's frames below
    each item's total, ends, dx), and the same with x and g counted whole."""
    B, P, H = x.shape
    row_bytes = H * x.element_size()
    starts = torch.cat([torch.zeros_like(ends[:, :1]), ends[:, :-1]], 1)
    x_rows = int(((ends > starts) & (starts < T)).sum())
    g_rows = int(ends[:, -1].clamp(max=T).sum())
    small = d.numel() * d.element_size() + B * T + 2 * B * P * 4
    fwd = small - B * P * 4 + B * T * row_bytes
    bwd = B * P * 4 + B * P * row_bytes
    ms = 1e3 / PEAK_BYTES_PER_S
    return {"fwd_bound_ms": (fwd + x_rows * row_bytes) * ms,
            "bwd_bound_ms": (bwd + g_rows * row_bytes) * ms,
            "fwd_bound_whole_ms": (fwd + B * P * row_bytes) * ms,
            "bwd_bound_whole_ms": (bwd + B * T * row_bytes) * ms}


def durations(B, P, T, g):
    d = torch.randint(1, 14, (B, P), generator=g)
    d[:, ::5] = 0
    if B > 1:
        d[0] = 10                       # one item above T
    return d


def shapes(dev, label) -> None:
    from lightningfastspeech2_tpu_torch.ops import length_regulator as lr

    takes_durations = "durations" in inspect.signature(lr.regulate_fwd).parameters
    for n, (what, B, P, H, T, dtype) in enumerate(SHAPES):
        g = torch.Generator().manual_seed(100 + n)
        x = torch.randn(B, P, H, generator=g).to(dev, dtype)
        d = durations(B, P, T, g).to(dev)
        dout = torch.randn(B, T, H, generator=g).to(dev, dtype)
        ends = torch.cumsum(d.clamp(min=0).to(torch.int32), -1, dtype=torch.int32)
        at = f"x ({B}, {P}, {H}) {str(dtype)[6:]} -> {T} frames"

        # correctness of the whole call and its backward
        xk = x.clone().requires_grad_(True)
        frames, mask = lr.regulate_kernel(xk, d, T)
        (grad,) = torch.autograd.grad(frames, xk, dout, retain_graph=True)
        ref, ref_mask = lr.regulate_plain(x, d, T)
        xf = x.float().requires_grad_(True)
        (want,) = torch.autograd.grad(lr.regulate_plain(xf, d, T)[0], xf, dout.float())
        want = want.to(dtype).float()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
        grad_ulps = ((grad.float() - want).abs() / ulp).max().item()
        again = torch.autograd.grad(frames, xk, dout, retain_graph=True)[0]

        if takes_durations:
            def fwd():
                return lr.regulate_fwd(x, d, T)
        else:
            def fwd():
                return lr.regulate_fwd(x, ends, T)

        def bwd():
            return lr.regulate_bwd(dout, ends)

        def call():             # as in training: x needs its gradient
            return lr.regulate_kernel(xk, d, T)

        def call_no_grad():     # as in serving
            with torch.no_grad():
                return lr.regulate_kernel(x, d, T)

        def call_bwd():
            return torch.autograd.grad(frames, xk, dout, retain_graph=True)

        # the gather as one PyTorch call on the precomputed frame -> phone index
        t = torch.arange(T, device=dev)
        idx = torch.searchsorted(ends.long(), t.expand(B, T).contiguous(), right=True)
        idx = idx.clamp(max=P - 1)[:, :, None].expand(-1, -1, H)
        xg = x.clone().requires_grad_(True)
        gathered = torch.gather(xg, 1, idx)

        def gather():
            return torch.gather(x, 1, idx)

        def gather_bwd():
            return torch.autograd.grad(gathered, xg, dout, retain_graph=True)

        row = {"phase": "regulate", "label": label, "at": at,
               "bit_exact": torch.equal(frames, ref) and torch.equal(mask, ref_mask),
               "grad_max_bf16_ulps": grad_ulps, "bwd_repeats": torch.equal(grad, again)}
        row.update(bounds(x, d, ends, T))
        for name, fn in (("fwd", fwd), ("bwd", bwd)):
            prof = device_kernels(fn, PROFILED_CALLS)
            row[name] = {"event_ms": cuda_ms(fn), **regulator_kernel(prof),
                         "launch_kernels": prof["kernels"]}
        for name, fn in (("fwd_call", call), ("fwd_call_no_grad", call_no_grad),
                         ("bwd_call", call_bwd),
                         ("gather", gather), ("gather_bwd", gather_bwd)):
            prof = device_kernels(fn, PROFILED_CALLS)
            row[name] = {"event_ms": cuda_ms(fn), "device_ms": prof["device_ms"],
                         "host_us": host_us(fn), "kernels": prof["kernels"],
                         "by_name": prof["by_name"]}
        emit(row)


def sweep(dev) -> None:
    """At each shape, the forward kernel at every frames-a-block the library
    takes, each launch held bit for bit against ``regulate_fwd_plain``, and
    the backward kernel at every warps-a-phone, against
    ``regulate_bwd_plain``: the plans are replaced for the timed calls."""
    from lightningfastspeech2_tpu_torch.ops import length_regulator as lr

    fwd_plan, bwd_plan = lr.fwd_frames_per_block, lr.bwd_warps_per_phone
    for n, (what, B, P, H, T, dtype) in enumerate(SHAPES):
        g = torch.Generator().manual_seed(100 + n)
        x = torch.randn(B, P, H, generator=g).to(dev, dtype)
        d = durations(B, P, T, g).to(dev)
        dout = torch.randn(B, T, H, generator=g).to(dev, dtype)
        ref = lr.regulate_fwd_plain(x, d, T)
        ref_dx = lr.regulate_bwd_plain(dout, ref[2]).float()
        fwd, bwd = [], []
        try:
            for F in lr.FRAMES_PER_BLOCK:
                lr.fwd_frames_per_block = lambda B, T, F=F: F
                out = lr.regulate_fwd(x, d, T)
                torch.cuda.synchronize()
                ok = all(torch.equal(a, b) for a, b in zip(out, ref))
                prof = device_kernels(lambda: lr.regulate_fwd(x, d, T), PROFILED_CALLS)
                fwd.append({"frames_per_block": F, "blocks": B * -(-T // F),
                            "device_ms": regulator_kernel(prof)["device_ms"], "exact": ok})
            for S in lr.BWD_SPLITS:
                lr.bwd_warps_per_phone = lambda B, P, H, e, S=S: S
                err = (lr.regulate_bwd(dout, ref[2]).float() - ref_dx).abs().max().item()
                prof = device_kernels(lambda: lr.regulate_bwd(dout, ref[2]), PROFILED_CALLS)
                bwd.append({"warps_per_phone": S,
                            "device_ms": regulator_kernel(prof)["device_ms"],
                            "max_abs_err_vs_plain": err})
        finally:
            lr.fwd_frames_per_block, lr.bwd_warps_per_phone = fwd_plan, bwd_plan
        emit({"phase": "regulate_sweep", "at": f"x ({B}, {P}, {H}) {str(dtype)[6:]} -> {T}",
              "fwd_plan": fwd_plan(B, T), "fwd": fwd,
              "bwd_plan": bwd_plan(B, P, H, x.element_size()), "bwd": bwd})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_length_regulator: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    root = Path(a.tree).resolve() if a.tree else HERE
    sys.path.insert(0, str(root))
    import lightningfastspeech2_tpu_torch as pkg
    from lightningfastspeech2_tpu_torch.kernels import build

    build.SOURCES = ("length_regulator",)  # the one library timed here
    dev = torch.device("cuda", 0)
    one = torch.zeros(1, device=dev)
    emit({"phase": "device", "label": a.label, "package": str(Path(pkg.__file__).parent),
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "fill_one_element_device_ms": device_kernels(one.zero_, PROFILED_CALLS)["device_ms"]})
    if a.sweep:
        sweep(dev)
    else:
        shapes(dev, a.label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
