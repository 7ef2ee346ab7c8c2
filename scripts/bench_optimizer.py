#!/usr/bin/env python3
"""Time one optimizer step over lightspeech_true76m's parameters on the card.

    python3 scripts/bench_optimizer.py [--tree DIR] [--label NAME]

Prints the card's name and power limit (nvidia-smi), then one JSON line per
optimizer. The optimizers are ``AdamWBf16Mu`` (the train step's optimizer
with ``TrainConfig.bf16_moments``) and ``torch.optim.AdamW`` (the default
one) beside it. The parameters are those of ``lightspeech_true76m``'s model,
f32, with seeded random gradients. Each line holds the host-clock ms of one
``step()`` (the median of 20, one synchronise each), its device kernels a
call and their device ms (``chip_smoke.device_kernels``), and the launches
a call counts on the host (``cudaLaunchKernel`` calls in the profiler's
trace).

``--tree DIR`` imports the port from DIR (an unpacked checkout, e.g. an
earlier commit made with ``git archive <commit> lightningfastspeech2_tpu_torch
| tar -x -C DIR``) instead of this checkout, so that two versions can be
timed in turns in one chip call. No kernel library is built.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(HERE))
from chip_smoke import device_kernels  # noqa: E402  (this checkout's, whichever tree is timed)

HOST_CALLS = 20


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def host_launches(fn) -> int:
    """``cudaLaunchKernel`` calls (and the other launch APIs) of one call of
    ``fn``, from the profiler's host trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.count for e in prof.key_averages()
               if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                            "cuLaunchKernelEx"))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_optimizer: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    root = Path(a.tree).resolve() if a.tree else HERE
    sys.path.insert(0, str(root))
    import lightningfastspeech2_tpu_torch as pkg
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_true76m
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.optim import AdamWBf16Mu

    cfg = lightspeech_true76m()
    model = build_fastspeech2(cfg.model, dtype=torch.bfloat16, seed=0)
    params = [p for p in model.parameters() if p.requires_grad]
    g = torch.Generator(device=params[0].device).manual_seed(0)
    for p in params:
        p.grad = torch.randn(p.shape, generator=g, device=p.device, dtype=p.dtype) * 1e-3
    t = cfg.train
    emit({"phase": "device", "label": a.label, "package": str(Path(pkg.__file__).parent),
          "name": torch.cuda.get_device_name(0), "nvidia_smi": smi,
          "parameters": len(params), "elements": sum(p.numel() for p in params),
          "param_dtypes": sorted({str(p.dtype) for p in params})})
    kw = dict(lr=1e-4, betas=tuple(t.betas), eps=t.eps, weight_decay=t.weight_decay)
    for name, opt in (("AdamWBf16Mu", AdamWBf16Mu(params, **kw)),
                      ("torch.optim.AdamW", torch.optim.AdamW(params, **kw))):
        opt.step()
        torch.cuda.synchronize()
        runs = []
        for _ in range(HOST_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            opt.step()
            torch.cuda.synchronize()
            runs.append((time.perf_counter() - t0) * 1e3)
        prof = device_kernels(opt.step, 5)
        emit({"phase": "optimizer", "label": a.label, "optimizer": name,
              "host_ms": statistics.median(runs), "host_ms_runs": runs,
              "device_ms": prof["device_ms"], "kernels": prof["kernels"],
              "by_name": prof["by_name"], "host_launches": host_launches(opt.step)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
