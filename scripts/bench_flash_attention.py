#!/usr/bin/env python3
"""Time the flash-attention kernels on the card, forward and backward.

    python3 scripts/bench_flash_attention.py [--tree DIR] [--label NAME] [--wide]

Prints the card's name and power limit (nvidia-smi), then one JSON line per
shape and direction. Each line holds the kernel's CUDA-event ms (a run of
wrapper calls between two events, warmed up, L2 warm) and its device ms
from ``torch.profiler`` (``chip_smoke.device_kernels``: the device kernels
of one call and their mean time). It also holds the largest distance from
``flash_attention_plain`` on the same inputs, each gradient's distance
relative to its largest element.

The shapes are the head-dim-128 shapes that the training paths launch.
bf16 runs at the decoder's training shape, (8, 2, 2048, 128) with dropout
0.1, through ``csrc/flash_attention_sm90.cu``. f32 runs at the f32 card
step's shape, (2, 2, 1024, 128) without dropout, through
``csrc/flash_attention.cu``. ``--wide`` adds head dims 256 and 512,
(2, 2, 2048, 256) and (1, 1, 1024, 512), in both dtypes. A tree whose
kernels do not take a shape reports it as not taken.

``--tree DIR`` imports the port from DIR instead of this checkout. DIR is an
unpacked checkout, e.g. a parent commit made with ``git archive <commit>
lightningfastspeech2_tpu_torch | tar -x -C DIR``. Two trees can then be
timed in turns in one chip call: parent, change, change, parent. Only the
flash libraries are built.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
from chip_smoke import cuda_ms, device_kernels  # noqa: E402  (this checkout's, whichever tree is timed)

PROFILED_CALLS = 20
# (B, H, T, d, dtype, dropout rate)
SHAPES = ((8, 2, 2048, 128, torch.bfloat16, 0.1), (2, 2, 1024, 128, torch.float32, 0.0))
WIDE_SHAPES = tuple((B, H, T, d, dt, 0.1) for B, H, T, d in ((2, 2, 2048, 256), (1, 1, 1024, 512))
                    for dt in (torch.bfloat16, torch.float32))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def case(dev, label, B, H, T, d, dtype, rate) -> None:
    from lightningfastspeech2_tpu_torch.ops import attention as att

    g = torch.Generator().manual_seed(16)
    q, k, v, do = (torch.randn(B, H, T, d, generator=g).to(dev, dtype) for _ in range(4))
    lengths = torch.tensor([T - 97 * i for i in range(B)], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    m32 = mask.to(torch.int32)
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    at = f"q/k/v ({B}, {H}, {T}, {d}) {str(dtype)[6:]}, ragged key mask, rate={rate}"
    try:
        route = att.kernel_route(q, k, v)
    except ValueError as e:
        emit({"phase": "flash", "label": label, "at": at, "taken": False, "why": str(e)})
        return
    o, lse, o32 = att.flash_attention_fwd(q, k, v, m32, seed, rate)
    dq, dk, dv = att.flash_attention_bwd(do, q, k, v, m32, seed, o32, lse, rate)
    pq = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref = att.flash_attention_plain(*pq, mask, rate, seed)
    ref_grads = torch.autograd.grad(ref, pq, do.float())
    err = {n: ((a.float() - b).abs().max() / b.abs().max()).item()
           for n, a, b in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), (ref, *ref_grads))}

    def fwd():
        return att.flash_attention_fwd(q, k, v, m32, seed, rate)

    def bwd():
        return att.flash_attention_bwd(do, q, k, v, m32, seed, o32, lse, rate)

    for part, fn in (("fwd", fwd), ("bwd", bwd)):
        prof = device_kernels(fn, PROFILED_CALLS)
        emit({"phase": "flash", "label": label, "at": at, "taken": True, "route": route,
              "part": part, "event_ms": cuda_ms(fn, min_total_ms=500.0, max_iters=200),
              "device_ms": prof["device_ms"], "kernels": prof["kernels"],
              "by_name": prof["by_name"], "rel_err_vs_plain": err})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--wide", action="store_true")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_attention: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    root = Path(a.tree).resolve() if a.tree else HERE
    sys.path.insert(0, str(root))
    import lightningfastspeech2_tpu_torch as pkg
    from lightningfastspeech2_tpu_torch.kernels import build

    build.SOURCES = tuple(n for n in ("flash_attention", "flash_attention_sm90",
                                      "flash_attention_wide")
                          if (build.CSRC_DIR / f"{n}.cu").exists())
    build.build_all()
    emit({"phase": "device", "label": a.label, "package": str(Path(pkg.__file__).parent),
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "build_s": {n: r["seconds"] for n, r in build.build_report.items()}})
    dev = torch.device("cuda", 0)
    for shape in SHAPES + (WIDE_SHAPES if a.wide else ()):
        case(dev, a.label, *shape)
    return 0


if __name__ == "__main__":
    sys.exit(main())
