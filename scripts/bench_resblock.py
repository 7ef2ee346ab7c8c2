#!/usr/bin/env python3
"""Time HiFi-GAN's resblock kernels (``resblock``, ``resblock_trio``) on the card.

    python3 scripts/bench_resblock.py [--tree DIR] [--label NAME] [--sweep]
        [--no-call] [--dtype float32|bfloat16|both]

First the card's name and power limit (nvidia-smi), then one JSON line per
launch of a 512-frame HiFi-GAN V1 call at B=1: stage 0's three resblocks
(C=256, k = 3, 7, 11) and the trios of stages 1-3 (C = 128, 64, 32), in f32
and bf16, each with its time (CUDA events, warmed up, L2 warm), the plain
version's time (f32: the chain as f32 cuDNN convs with TF32 off), the
launch as planned and as the library recorded it, its largest error
against the plain version and its bounds at the H100's published peaks
(bytes; operations at the dtype's rate, f32 both as split-TF32 products,
165 TFLOP/s, and on the CUDA cores, 67). Then one 512-frame vocoder call
per dtype under torch.profiler: device ms, resblock ms and launches.

``--tree DIR`` imports the port from DIR (an unpacked checkout, e.g. the
parent commit) instead of this checkout, so two trees can be timed in turns
in one run on one card. ``--sweep`` times, per f32 shape, the launches that
fit at a range of tiles (with x in shared memory and in L2, or at C = 256
a cluster of 4 blocks a tile), each checked against the plain version:
the data behind ``tile_plan``'s f32 model.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32_CUDA_CORES = 67e12
# f32-accurate products: three TF32 products each on the tensor cores
PEAK_F32_ACCURATE = max(PEAK_F32_CUDA_CORES, 495e12 / 3)
FRAMES = 512


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


def launches(dtype, dev):
    """chip_smoke.py _resblock_cases' weights (unit-gain convs, seed 0) and
    per launch of a FRAMES-frame call: (stage, weights, x)."""
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator, HifiGanConfig

    g = torch.Generator().manual_seed(0)
    cfg = HifiGanConfig()
    # serving weights: the kernels refuse parameters that need a gradient
    gen = Generator(cfg, dtype).requires_grad_(False)
    with torch.no_grad():
        for m in gen.resblocks.modules():
            if isinstance(m, torch.nn.Conv1d):
                m.weight.normal_(0.0, (m.in_channels * m.kernel_size[0]) ** -0.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    gen.prepare()
    gen.to(dev)
    out, L = [], FRAMES
    for stage, weights in enumerate(gen.stage_weights):
        L *= cfg.upsample_rates[stage]
        C = cfg.upsample_initial_channel // 2 ** (stage + 1)
        x = torch.randn(1, L, C, generator=g).to(dev, dtype)
        out += [(stage, w, x) for w in weights]
    return out


def work(w, x):
    """(flops, bytes): the chain's products, 2 k C^2 per row and conv, and
    x read and the output written once, the f32 or bf16 weights once."""
    B, L, C = x.shape
    flops = B * L * sum(2 * k * C * C * 2 * len(ds) for k, ds in zip(w.kernel_sizes, w.dilations))
    n_w = sum(k * C * C * 2 * len(ds) for k, ds in zip(w.kernel_sizes, w.dilations))
    nbytes = 2 * x.numel() * x.element_size() + n_w * x.element_size() + w.bias.numel() * 4
    return flops, nbytes


def shapes(dev, label, dtypes) -> None:
    from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as rb

    for dtype in dtypes:
        for stage, w, x in launches(dtype, dev):
            trio = w.n_res > 1
            kern, plain = ((rb.resblock_trio, rb.resblock_trio_plain) if trio
                           else (rb.resblock, rb.resblock_plain))
            out = kern(x, w)
            torch.cuda.synchronize()
            launched = rb.last_launch()
            ref = plain(x, w)
            flops, nbytes = work(w, x)
            row = {"phase": "resblock", "label": label, "name": kern.__name__, "stage": stage,
                   "dtype": str(dtype)[6:],
                   "at": f"x {tuple(x.shape)} {str(dtype)[6:]}, k={list(w.kernel_sizes)}",
                   "ms": cuda_ms(lambda: kern(x, w)), "plain_ms": cuda_ms(lambda: plain(x, w)),
                   "max_abs_err": (out.float() - ref.float()).abs().max().item(),
                   "max_abs_ref": ref.float().abs().max().item(),
                   "plan": str(rb.tile_plan(w, 1, x.shape[1])), "launch": launched,
                   "bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3}
            if dtype == torch.float32:
                row["ops_ms_split_tf32"] = flops / PEAK_F32_ACCURATE * 1e3
                row["ops_ms_cuda_cores"] = flops / PEAK_F32_CUDA_CORES * 1e3
            else:
                row["ops_ms"] = flops / PEAK_BF16 * 1e3
            emit(row)


SWEEP_TILES = (16, 32, 48, 64, 96, 128, 176, 224, 256, 352, 512, 768, 1008)


def sweep(dev) -> None:
    """Per f32 shape, the launches that fit at SWEEP_TILES (one block a
    tile with x in shared memory or in L2; at C = 256 a cluster of 4 blocks
    a tile), timed and checked against the plain version; fastest first,
    the plan's rank."""
    from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as rb

    for stage, w, x in launches(torch.float32, dev):
        L = x.shape[1]
        plan = rb.tile_plan(w, 1, L)
        ref = (rb.resblock_trio_plain if w.n_res > 1 else rb.resblock_plain)(x, w)
        top = ref.abs().max().item()
        split = rb._f32_split(w.channels)
        rows = []
        for tile in SWEEP_TILES:
            if tile > 16 * -(-L // 16):
                break
            for route, xs, smem in rb._f32_options(w.shape, tile):
                p = rb.TilePlan(route, tile, split * -(-L // tile), smem, xs,
                                rb.halo_share(w, tile))
                out = rb._launch(x, w, "sweep", plan=p)
                torch.cuda.synchronize()
                rows.append({"route": route, "tile": tile, "blocks": p.blocks,
                             "ms": cuda_ms(lambda: rb._launch(x, w, "sweep", plan=p),
                                           min_total_ms=30.0, max_iters=20),
                             "rel_err": (out - ref).abs().max().item() / top,
                             "model_us": rb._f32_us(w.shape, tile),
                             "plan": (route, tile) == (plan.route, plan.tile)})
        rows.sort(key=lambda r: r["ms"])
        emit({"phase": "resblock_sweep", "stage": stage, "k": list(w.kernel_sizes),
              "plan": str(plan), "fastest": rows[:8],
              "plan_rank": next((i for i, r in enumerate(rows) if r["plan"]), None),
              "max_rel_err": max(r["rel_err"] for r in rows), "all": rows})


def vocoder_calls(dev, label, dtypes) -> None:
    """One FRAMES-frame HiFi-GAN V1 call per dtype (seeded weights, as the
    synthesiser makes them), warmed up, then once under torch.profiler:
    device ms, resblock ms and launches (kernels by name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig, Synthesiser

    mel = (np.random.default_rng(5).standard_normal((FRAMES, 80)) - 4.0).astype(np.float32)
    for dtype in dtypes:
        synth = Synthesiser(HifiGanConfig(), dtype=dtype, device=dev, seed=1)
        synth(mel)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            synth(mel)
            torch.cuda.synchronize()
        events = prof.key_averages()
        host = {e.key for e in events if e.device_type == DeviceType.CPU}
        dev_us = rb_us = 0.0
        rb_n = 0
        for e in events:
            if e.device_type != DeviceType.CUDA or e.key in host or e.self_device_time_total <= 0:
                continue
            dev_us += e.self_device_time_total
            if re.search(r"\b(wg_resblock_kernel|mma_resblock_kernel|f32_resblock_kernel|"
                         r"resblock_kernel)\b", e.key):
                rb_us += e.self_device_time_total
                rb_n += e.count
        emit({"phase": "hifigan_vocoder_call", "label": label, "frames": FRAMES,
              "dtype": str(dtype)[6:], "device_ms": dev_us / 1e3, "resblock_ms": rb_us / 1e3,
              "resblock_launches": rb_n})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--no-call", action="store_true")
    ap.add_argument("--dtype", default="both", choices=("float32", "bfloat16", "both"))
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_resblock: no CUDA device", file=sys.stderr)
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
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi})
    dev = torch.device("cuda", 0)
    if a.sweep:
        sweep(dev)
        return 0
    dtypes = {"float32": (torch.float32,), "bfloat16": (torch.bfloat16,),
              "both": (torch.float32, torch.bfloat16)}[a.dtype]
    shapes(dev, a.label, dtypes)
    if not a.no_call:
        vocoder_calls(dev, a.label, dtypes)
    return 0


if __name__ == "__main__":
    sys.exit(main())
