#!/usr/bin/env python3
"""Time the port's FFN-half kernels on one Hopper card at the training
step's shapes, and split one profiled training step by kernel family.

    python3 scripts/bench_ffn_train.py [--tree DIR] [--label NAME] [--no-step] [--f32]
        [--defines MACRO ...] [--phases]

``--tree`` imports ``lightningfastspeech2_tpu_torch`` from another checkout
(for example an unpacked parent commit), so that two versions can be timed
in turns within one run on one card. Prints one JSON line per shape and one
for the step; the card's name and power limit first.

Shapes: the flagship's eight FFN blocks of one training step (encoder
B=8, P=256, k = 5, 25, 13, 9; decoder B=8, T=2048, k = 17, 21, 9, 13;
C=256, F=1024, dropout rate 0.1) through ``ffn_ln_train_fwd`` and
``ffn_ln_train_bwd`` in bf16 (and in f32 with ``--f32``), and the serving
``ffn_ln`` at the served batch's decoder shape (8, 512, 256), k=17, bf16.
Times are CUDA-event means after a warm-up, L2 warm.

``--defines`` builds the kernels with extra macros (``LFS2_KERNEL_DEFINES``,
kernels/build.py): ``LFS2_FFN_NO_WGRAD_ATOMICS`` drops the backward's
weight-gradient reductions (wrong gradients, for timing their share);
``--phases`` (which adds ``LFS2_FFN_PHASE_CLOCKS``) prints, for the decoder
k=17 and encoder k=25 shapes, the cycles block (0, 0)'s two warpgroups
spent in each phase of the bf16 forward, the backward's chain and its dup
pass.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

ENC_K, DEC_K = (5, 25, 13, 9), (17, 21, 9, 13)
B, P, T, C, F, RATE = 8, 256, 2048, 256, 1024, 0.1
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
# kernel-name patterns of both designs, by the wrapper whose launch they
# belong to (bf16 ffn_ln_kernel<CP, false> is the forward, <CP, true> the
# backward's chain)
FAMILIES = {
    "ffn_ln_train": (r"\bffn_ln_kernel<\d+, false>", r"\bffn_ln_f32_kernel<float, \d+, true>",
                     r"\bffn_ln_kernel<__nv_bfloat16, \d+, true>"),
    "ffn_ln_train_bwd": (r"\bffn_ln_kernel<\d+, true>", r"\bffn_dup_kernel\b", r"\bffn_dt1_kernel\b",
                         r"\bffn_bwd_kernel\b"),
    "flash_attention": (r"\bfwd_sm90_kernel\b", r"\bfwd_kernel\b"),
    "flash_attention_bwd": (r"\bdq_sm90_kernel\b", r"\bdkv_sm90_kernel\b", r"\bdq_kernel\b",
                            r"\bdkv_kernel\b"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, min_total_ms: float = 200.0, max_iters: int = 50) -> float:
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


def bound_ms(flops: float, nbytes: float, dtype) -> float:
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS[dtype]) * 1e3


def block(ffn_layers, k, dtype, g, dev):
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import init_weights

    blk = ffn_layers.FFTBlock(C, 2, k, F, dtype)
    init_weights(blk, g)
    with torch.no_grad():
        for n in (blk.norm1, blk.norm2):
            n.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
            n.bias.copy_(0.1 * torch.randn(C, generator=g))
    return blk.to(dev)


def launches(ffn) -> dict:
    """The library's record of the latest call's launches, where the
    version has one."""
    fn = getattr(ffn, "last_launches", None)
    return fn() if fn else None


def shapes(dev, dtypes) -> None:
    from lightningfastspeech2_tpu_torch.models import layers
    from lightningfastspeech2_tpu_torch.ops import ffn

    g = torch.Generator().manual_seed(1)
    nbytes = lambda *ts: sum(t.numel() * t.element_size() for t in ts)
    for dtype in dtypes:
        for rows, ks in ((P, ENC_K), (T, DEC_K)):
            for k in ks:
                blk = block(layers, k, dtype, g, dev)
                p = [t.detach().clone() for t in ffn.ffn_train_params(*blk._ffn_modules())]
                z = torch.randn(B, rows, C, generator=g).to(dev, dtype)
                dout = torch.randn(B, rows, C, generator=g).to(dev, dtype)
                seed = torch.tensor([4242], dtype=torch.int32, device=dev)
                wb = nbytes(*p)
                # the kernels alone where the version takes the call's
                # prepared weight layouts (the parent built them per launch)
                kw = {}
                if "layouts" in ffn.ffn_ln_train_fwd.__code__.co_varnames:
                    kw = {"layouts": ffn._kernel_layouts(p, dtype)}
                row = {"at": f"z ({B}, {rows}, {C}) {str(dtype)[6:]}, F={F}, k={k}, rate={RATE}",
                       "fwd_ms": cuda_ms(lambda: ffn.ffn_ln_train_fwd(z, p, seed, RATE, **kw))}
                row["fwd_launches"] = launches(ffn)
                row["bwd_ms"] = cuda_ms(lambda: ffn.ffn_ln_train_bwd(dout, z, p, seed, RATE, **kw))
                row["bwd_launches"] = launches(ffn)
                if kw:
                    row["layouts_ms"] = cuda_ms(lambda: ffn._kernel_layouts(p, dtype))
                row["fwd_bound_ms"] = bound_ms(B * rows * (2 * k * C + 4 * C * F),
                                               2 * nbytes(z) + wb, dtype)
                row["bwd_bound_ms"] = bound_ms(B * rows * (6 * k * C + 12 * C * F),
                                               3 * nbytes(z) + 2 * wb, dtype)
                emit({"phase": "ffn_train_shape", **row})
    blk = block(layers, 17, torch.bfloat16, g, dev)
    w = blk.ffn_weights
    z = torch.randn(B, 512, C, generator=g).to(dev, torch.bfloat16)
    with torch.no_grad():
        row = {"at": f"z ({B}, 512, {C}) bf16, F={F}, k=17",
               "ms": cuda_ms(lambda: ffn.ffn_ln(z, w))}
    row["launch"] = launches(ffn)
    row["bound_ms"] = bound_ms(B * 512 * (2 * 17 * C + 4 * C * F),
                               2 * nbytes(z) + nbytes(w.wd, w.w1, w.b1, w.w2f, w.lnp),
                               torch.bfloat16)
    emit({"phase": "ffn_serve_shape", **row})


def step_split(dev) -> None:
    """The flagship in bf16 at B=8, P=256, T=2048 (l1 mel loss, config
    dropout rates): two warm-up steps, then one under torch.profiler,
    split by kernel family."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from chip_smoke import train_batch, train_config
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    cfg = train_config()
    batch = train_batch(cfg)
    model = build_fastspeech2(cfg.model, dtype=torch.bfloat16, seed=0)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=model.device).manual_seed(5)
    for _ in range(2):
        state, _ = step(state, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key for e in events if e.device_type == DeviceType.CPU}
    out = {f: 0.0 for f in FAMILIES}
    counts = {f: 0 for f in FAMILIES}
    total = 0.0
    ffn_rows = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.key in host or e.self_device_time_total <= 0:
            continue
        total += e.self_device_time_total
        if "ffn" in e.key:
            ffn_rows.append((e.key[:120], e.self_device_time_total / 1e3, e.count))
        for fam, pats in FAMILIES.items():
            if any(re.search(x, e.key) for x in pats):
                out[fam] += e.self_device_time_total
                counts[fam] += e.count
    emit({"phase": "train_step_split", "device_ms": total / 1e3,
          **{f"{f}_ms": v / 1e3 for f, v in out.items()},
          **{f"{f}_kernels": v for f, v in counts.items()}, "ffn_kernels": ffn_rows})


FWD_PHASES = ("prologue", "wait W1", "up", "up epilogue", "wait W2", "ff", "ff to rows",
              "LN2 rows")
DUP_PHASES = ("prologue", "wait W1", "up", "wait other dW", "up epilogue", "wait W2", "dup_d",
              "dup epilogue", "dacc", "wait staging", "dW products", "dW reductions",
              "dacc store")


def phases(dev) -> None:
    """Cycles of each phase of block (0, 0), per warpgroup, from a build with
    LFS2_FFN_PHASE_CLOCKS."""
    import ctypes

    from lightningfastspeech2_tpu_torch.kernels import build
    from lightningfastspeech2_tpu_torch.models import layers
    from lightningfastspeech2_tpu_torch.ops import ffn

    def clocks(lib, fn_name, labels):
        buf = (ctypes.c_longlong * 32)()
        fn = getattr(lib, fn_name)
        fn.argtypes = [ctypes.c_void_p]
        build.check(lib, fn(buf), fn_name)
        return {name: [buf[i], buf[16 + i]] for i, name in enumerate(labels)}

    g = torch.Generator().manual_seed(1)
    for rows, k in ((T, 17), (P, 25)):
        blk = block(layers, k, torch.bfloat16, g, dev)
        p = [t.detach().clone() for t in ffn.ffn_train_params(*blk._ffn_modules())]
        z = torch.randn(B, rows, C, generator=g).to(dev, torch.bfloat16)
        dout = torch.randn(B, rows, C, generator=g).to(dev, torch.bfloat16)
        seed = torch.tensor([4242], dtype=torch.int32, device=dev)
        w = ffn._kernel_layouts(p, torch.bfloat16)
        lf, lb = build.load("ffn_ln"), build.load("ffn_ln_train_bwd")
        ffn.ffn_ln_train_bwd(dout, z, p, seed, RATE, layouts=w)  # warm; then clear the clocks
        torch.cuda.synchronize()
        clocks(lf, "lfs2_ffn_ln_phase_clocks", FWD_PHASES)
        clocks(lb, "lfs2_ffn_dup_phase_clocks", DUP_PHASES)
        ffn.ffn_ln_train_fwd(z, p, seed, RATE, layouts=w)
        torch.cuda.synchronize()
        fwd = clocks(lf, "lfs2_ffn_ln_phase_clocks", FWD_PHASES)
        ffn.ffn_ln_train_bwd(dout, z, p, seed, RATE, layouts=w)
        torch.cuda.synchronize()
        emit({"phase": "ffn_phase_cycles", "at": f"z ({B}, {rows}, {C}) bf16, k={k}",
              "forward": fwd, "chain": clocks(lf, "lfs2_ffn_ln_phase_clocks", FWD_PHASES),
              "dup": clocks(lb, "lfs2_ffn_dup_phase_clocks", DUP_PHASES)})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None)
    ap.add_argument("--label", default="")
    ap.add_argument("--no-step", action="store_true")
    ap.add_argument("--f32", action="store_true")
    ap.add_argument("--defines", nargs="*", default=[])
    ap.add_argument("--phases", action="store_true")
    a = ap.parse_args()
    defines = list(a.defines) + (["LFS2_FFN_PHASE_CLOCKS"] if a.phases else [])
    if defines:
        import os
        os.environ["LFS2_KERNEL_DEFINES"] = " ".join(defines)
    if not torch.cuda.is_available():
        print("bench_ffn_train: no CUDA device", file=sys.stderr)
        return 1
    if a.tree:
        sys.path.insert(0, str(Path(a.tree).resolve()))
    else:
        sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    import lightningfastspeech2_tpu_torch as pkg

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    emit({"phase": "device", "label": a.label, "package": str(Path(pkg.__file__).parent),
          "nvidia_smi": smi, "defines": defines})
    dev = torch.device("cuda", 0)
    if a.phases:
        phases(dev)
        return 0
    dtypes = (torch.bfloat16, torch.float32) if a.f32 else (torch.bfloat16,)
    shapes(dev, dtypes)
    if not a.no_step:
        step_split(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
