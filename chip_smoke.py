#!/usr/bin/env python3
"""Start lightningfastspeech2_tpu_torch on one Hopper card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card (name and power limit from nvidia-smi, capability (9, 0)
   asserted). f32 convolutions and products run in full f32: TF32 is off
   for cuDNN and cuBLAS, so f32 comparisons measure the kernels alone.
2. build: nvcc builds every kernel in csrc/ for sm_90a, all in parallel;
   the bf16 FFN kernels' SASS must hold HGMMA and ptxas must report no
   spill and no serialised wgmma for them.
3. probe: the launch probe against ``2 * x``, its time beside
   ``torch.mul``'s, and the host µs per launch of the launch path before
   ``kernels/launch.py`` and of today's, in turns, with a launch's pieces.
4. kernels: each kernel against its plain PyTorch version on the card at the
   serving path's shapes, with its time (CUDA events, warmed up, L2 warm),
   the plain version's time, and its bound at the H100's published peaks.
   The resblock rows (HiFi-GAN V1 at a 512-frame mel, B=1, bf16 and f32)
   add the launch as the library recorded it (tile, blocks_per_launch,
   shared memory, each held against the tile plan), the route and halo
   share, achieved TFLOP/s, ``x_bound`` (time over bound) and, for bf16,
   ``cudnn_bf16_chain_ms``: the same chain as bf16 ``F.conv1d`` calls, a
   chain of library calls, not one (so no ``library_ms``).
5. serving (the main path): the flagship LightSpeech (bf16) and HiFi-GAN V1
   (bf16) built from seeded generators serve sentences through
   ``SpeechGenerator.generate_from_text`` and one batch of 8 through
   ``generate_samples`` at frame bucket 512. The duration head's bias is
   taken first, on the CPU. Then every launch counter is set to 0, the
   models are built, the requests served, and the counters read: each must
   equal what the path launches, and none may be 0. Then the batch again,
   five times on the host clock (median and spread), and one 512-frame
   vocoder call on the host clock and one under the profiler: device ms
   and the resblock kernels' share and launches.
6. reference: an f32 request on the card against the same request through
   the plain path on the CPU.
7. train kernels: ``ffn_ln_train`` (forward and backward) at every FFN
   block's shape of the training step, each held against the plain
   version's output and gradients, each launch's grid and shared memory as
   the library recorded them held against ``ops/ffn.py ffn_plan`` (phase 4
   does the same for the serving ``ffn_ln``); ``flash_attention`` (forward
   and backward) against the plain
   version, with ``F.scaled_dot_product_attention`` (same mask and
   dropout_p) timed as the library yardstick: bf16 at the decoder's shape
   (the wgmma kernels of ``csrc/flash_attention_sm90.cu``), f32 at phase
   9's shape (the split-TF32 mma.sync kernels of
   ``csrc/flash_attention.cu``), each with its build seconds and the
   launches by route it made.
8. training (this slice's main path): the flagship in bf16 with f32
   parameters takes 1 warm-up and 5 timed optimizer steps on B=8, P=256,
   T=2048 teacher-forced batches at the config dropout rates. Every loss
   must be finite, every parameter must get a finite non-zero gradient,
   and the launch counters, set to 0 just before, must equal 8 / 8 / 4 / 4
   per step, every flash launch through the wgmma kernels. One more step
   runs under torch.profiler for the time split, with flash attention's
   share of the kernel time.
9. train reference: one f32 step on the card against the same step on the
   CPU's plain path (flagship widths, B=2, T=1024, dropout rates 0,
   warm-up 1 so the first update is visible), its flash launches through
   the split-TF32 kernels of ``csrc/flash_attention.cu``.
10. soft-DTW kernels: ``soft_dtw`` (forward and backward) at the mel loss's
    lattices (8 items x 8 chunks of 256 frames, D from 80 mel channels,
    gamma 0.1) against the plain recurrence's value and autograd gradient;
    the length regulator's expand and segment-sum at the flagship's
    (8, 256, 256) bf16 -> 2048 frames against the gather (forward bit for
    bit), with the gather timed as the library yardstick.
11. soft-DTW training (this slice's main path): phase 8's step with
    ``mel_loss="soft_dtw"`` and ``LFS2_PALLAS_LR=1`` set in the process, 1
    warm-up and 3 timed steps; the launch counters, set to 0 just before,
    must equal the per-step counts derived from the config (now also
    ``soft_dtw``, ``soft_dtw_bwd``, ``regulate``, ``regulate_bwd``), and one
    profiled step gives the soft-DTW kernels' share.
12. soft-DTW train reference: phase 9 with the soft-DTW mel loss and the
    regulator flag set, card against CPU.
13. step comparison: phases 8 and 11's trainers take one more step each,
    interleaved, ``STEP_PAIRS`` times (outside the counted runs); the
    median of each and of their per-pair difference.

14. FastDiff kernels: ``lvc_stack`` (the LVC chain of one upsample stage)
    against its plain version at a 512-frame bucket, B=1: stages 2 and 3 in
    bf16 and f32, one Padé-gate case, and the stage-1 shape.
15. FastDiff serving (this slice's main path): the flagship with its
    residual mel head and the FastDiff vocoder (reference widths, N=4), both
    bf16 from seeded generators, serve phase 5's sentences and batch after
    the same duration bias; the counters, set to 0 just before, must show
    ``lvc_stack`` at 2 per ε pass (stages 2 and 3) and no resblock launch.
    Then one request with ``LFS2_FUSED_STAGE1=1`` (3 per pass), and one
    profiled vocoder call's split.
16. FastDiff reference: an f32 FastDiff request on the card against the
    same request on the CPU's plain path, with the same noise drawn once on
    the CPU.

Phases 5 and 8 run without the flags and expect 0 launches of the kernels
of phases 10-12 and 14.

Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before the result is printed. Without a CUDA device, or without the
repository beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Published H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12,   # tensor cores
              torch.float32: 67e12}     # f32 without the tensor cores
PEAK_TF32_FLOPS = 495e12                # tensor cores, TF32
# f32-accurate products: the faster of the CUDA cores and split TF32 on the
# tensor cores (three TF32 products for each f32 one, 165 TFLOP/s)
PEAK_F32_ACCURATE = max(PEAK_FLOPS[torch.float32], PEAK_TF32_FLOPS / 3)
SAMPLING_RATE = 22050

SENTENCES = (
    "Hello world.",
    "The quick brown fox jumps over the lazy dog.",
    "A journey of a thousand miles begins with a single step, and so does "
    "this short test of the serving path.",
    "Speech synthesis turns written text into sound: the acoustic model "
    "predicts a mel spectrogram from the phones, and the vocoder turns that "
    "spectrogram into a waveform, one sample at a time, on the card.",
)
BATCH_TEXTS = SENTENCES + (
    "Seven silly swans swam silently seaward.",
    "Numbers and letters mix in this sentence.",
    "Please call Stella and ask her to bring these things with her.",
    "Rain in the valley, snow on the hills, and wind over everything.",
)
# mean rounded duration the untrained duration head is biased towards
FRAMES_PER_PHONE = 7.0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, min_total_ms: float = 200.0, max_iters: int = 50) -> float:
    """Mean time of ``fn`` on the card: CUDA events around a run of calls
    after a warm-up call, enough calls to fill ``min_total_ms``."""
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


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype, peak: float = None):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate (the type's unless ``peak`` is given),
    whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / (peak or PEAK_FLOPS[dtype]) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err_and_tol(out: torch.Tensor, ref: torch.Tensor, f32_tol: float):
    """max |out - ref| and its tolerance: ``f32_tol`` in f32 (summation
    order only); in bf16 four units in the last place at the largest
    |ref|, since a one-ulp flip at a rounding point can carry through the
    residual chain."""
    err = (out.float() - ref.float()).abs().max().item()
    if out.dtype == torch.float32:
        return err, f32_tol
    top = ref.float().abs().max().item()
    return err, 4.0 * 2.0 ** (math.floor(math.log2(max(top, 1e-30))) - 7)


def tensor_bytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ----------------------------------------------------------------- phases
def device_phase() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    cap = torch.cuda.get_device_capability(0)
    info = {"phase": "device", "nvidia_smi": smi,
            "name": torch.cuda.get_device_name(0), "capability": list(cap),
            "count": torch.cuda.device_count(), "torch": torch.__version__,
            "cuda": torch.version.cuda, "allow_tf32": False}
    emit(info)
    if tuple(cap) != (9, 0):
        raise RuntimeError(f"the port's kernels need capability (9, 0), got {cap}")
    return info


def build_phase() -> None:
    from lightningfastspeech2_tpu_torch.kernels import build

    t0 = time.perf_counter()
    report = build.build_all()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "per_source_seconds": {k: v["seconds"] for k, v in report.items()}})
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "ptxas.txt").write_text(
        "\n".join(f"=== {k}\n{v['ptxas']}" for k, v in report.items()))
    ffn_sass_phase(report)


# the FFN sources' tensor-core kernels, by their mangled names
FFN_WGMMA = re.compile(r"(ffn_ln_kernel|ffn_dup_kernel)ILi(\d+)E(?:Lb([01])E)?")


def ffn_sass_phase(report) -> dict:
    """The bf16 FFN kernels as compiled: HGMMA (wgmma) and HMMA counts in
    cuobjdump's SASS of the built libraries, and ptxas's spill bytes and
    serialised-wgmma warnings (C7512). Fails unless every one has HGMMA and
    none spills or serialises."""
    from lightningfastspeech2_tpu_torch.kernels import build

    def key(m):
        return f"{m.group(1)}<{m.group(2)}" + (f", {m.group(3)}>" if m.group(3) else ">")

    tool = Path(build.find_nvcc()).parent / "cuobjdump"
    rows = {}
    for name in ("ffn_ln", "ffn_ln_train_bwd"):
        sass = subprocess.run([str(tool), "-sass", str(build.library_path(name))],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        for block in re.split(r"\n\s+Function : ", sass)[1:]:
            m = FFN_WGMMA.search(block.split("\n", 1)[0])
            if m:
                rows[key(m)] = {"hgmma": len(re.findall(r"\bHGMMA", block)),
                                "hmma": len(re.findall(r"\bHMMA", block)),
                                "spill_bytes": 0, "serialised_wgmma": False}
        current = None
        for line in report[name]["ptxas"].splitlines():
            m = FFN_WGMMA.search(line)
            if "Compiling entry function" in line:
                current = key(m) if m else None
            elif "C7512" in line and m:
                rows[key(m)]["serialised_wgmma"] = True
            elif current and "spill stores" in line:
                rows[current]["spill_bytes"] += int(re.search(r"(\d+) bytes spill stores", line).group(1))
    emit({"phase": "ffn_sass", "kernels": rows})
    bad = {k: r for k, r in rows.items()
           if r["hgmma"] == 0 or r["spill_bytes"] or r["serialised_wgmma"]}
    if len(rows) != 9 or bad:
        raise RuntimeError(f"ffn tensor-core kernels: {len(rows)} found, off {bad}")
    return rows


HOST_LAUNCHES = 10_000


def host_us(fn, n: int = HOST_LAUNCHES) -> float:
    """Host-clock µs per call of ``fn`` over ``n`` calls with no
    synchronise between them, then one."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / n * 1e6


def _old_probe_path():
    """The probe's launch path as every wrapper ran it before
    ``kernels/launch.py``: a set of devices, ``get_device_capability`` on
    every launch, a contiguity pass, and a ``torch.cuda.Stream`` object for
    the stream handle; the same library and kernel."""
    from lightningfastspeech2_tpu_torch.kernels import build
    from lightningfastspeech2_tpu_torch.ops import probe as probe_mod

    lib, fn = probe_mod._fn()

    def old_probe(x):
        devs = {x.device}
        if len(devs) != 1:
            raise ValueError(f"kernel inputs span devices {devs}")
        dev = next(iter(devs))
        if dev.type != "cuda":
            raise RuntimeError(f"kernel launch needs a CUDA tensor, got {dev}")
        cap = torch.cuda.get_device_capability(dev)
        if tuple(cap) != (9, 0):
            raise RuntimeError(f"capability {cap}")
        if not x.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if x.dtype != torch.float32:
            raise ValueError(f"probe takes float32, got {x.dtype}")
        y = torch.empty_like(x)
        rc = fn(x.data_ptr(), y.data_ptr(), x.numel(),
                torch.cuda.current_stream(x.device).cuda_stream)
        build.check(lib, rc, "probe")
        return y

    return old_probe, lib, fn


def probe_phase(dev) -> dict:
    from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream
    from lightningfastspeech2_tpu_torch.ops.probe import probe, probe_plain

    x = torch.randn(8, 128, device=dev)
    err = (probe(x) - probe_plain(x)).abs().max().item()
    old_probe, lib, fn = _old_probe_path()
    old_err = (old_probe(x) - probe_plain(x)).abs().max().item()
    torch.cuda.synchronize()
    # the old launch path and the new one in turns (old, new, new, old,
    # twice), HOST_LAUNCHES launches each, on the host clock; then where a
    # launch's host time goes, each piece alone
    turns = {"old_path": [], "new_path": []}
    for which in ("old_path", "new_path", "new_path", "old_path") * 2:
        call = old_probe if which == "old_path" else probe
        turns[which].append(host_us(lambda: call(x)))
    y = torch.empty_like(x)
    stream = kernel_stream(x)
    host = {k: statistics.median(v) for k, v in turns.items()}
    host.update({
        "torch_mul": host_us(lambda: torch.mul(x, 2.0)),
        "kernel_stream": host_us(lambda: kernel_stream(x)),
        "empty_like": host_us(lambda: torch.empty_like(x)),
        "ctypes_launch": host_us(lambda: fn(x.data_ptr(), y.data_ptr(), x.numel(), stream)),
        "old_capability_check": host_us(lambda: torch.cuda.get_device_capability(x.device)),
        "old_current_stream": host_us(lambda: torch.cuda.current_stream(x.device).cuda_stream)})
    row = {"name": "probe", "route": "cuda",
           "source": "lightningfastspeech2_tpu_torch/csrc/probe.cu",
           "replaces": "lightningfastspeech2_tpu/ops/kernel_gate.py:79",
           "at": "(8, 128) f32", "max_abs_err": max(err, old_err), "tol": 0.0,
           "ms": cuda_ms(lambda: probe(x)), "plain_ms": cuda_ms(lambda: probe_plain(x)),
           "library_ms": cuda_ms(lambda: torch.mul(x, 2.0)),
           "old_path_ms": cuda_ms(lambda: old_probe(x)),
           "host_us_per_launch": host, "host_us_turns": turns,
           "host_launches": HOST_LAUNCHES}
    row["vs_library"] = row["ms"] / row["library_ms"]
    row["bound_ms"], row["bound_by"] = bound_ms(x.numel(), 2 * tensor_bytes(x), torch.float32)
    emit({"phase": "probe", **row})
    if err != 0.0 or old_err != 0.0:
        raise RuntimeError(f"probe: max |err| {err} (old path {old_err})")
    return row


def _ffn_case(dev, B, T, k, dtype, g) -> dict:
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import init_weights
    from lightningfastspeech2_tpu_torch.models.layers import FFTBlock
    from lightningfastspeech2_tpu_torch.ops import ffn as ffn_mod
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln, ffn_ln_plain

    C, F = 256, 1024
    block = FFTBlock(C, 2, k, F, dtype)
    init_weights(block, g)
    with torch.no_grad():  # non-trivial LayerNorm parameters
        for n in (block.norm1, block.norm2):
            n.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
            n.bias.copy_(0.1 * torch.randn(C, generator=g))
    block.to(dev)
    w = block.ffn_weights
    z = torch.randn(B, T, C, generator=g).to(dev, dtype)
    out, ref = ffn_ln(z, w), ffn_ln_plain(z, w)
    torch.cuda.synchronize()
    err, tol = max_err_and_tol(out, ref, 2e-4)
    flops = B * T * (2 * k * C + 4 * C * F)
    nbytes = 2 * tensor_bytes(z) + tensor_bytes(w.wd, w.w1, w.b1, w.w2f, w.lnp)
    row = {"at": f"z ({B}, {T}, {C}) {str(dtype)[6:]}, F={F}, k={k}",
           "max_abs_err": err, "tol": tol,
           "ms": cuda_ms(lambda: ffn_ln(z, w)), "plain_ms": cuda_ms(lambda: ffn_ln_plain(z, w))}
    row["launch"] = ffn_launches(ffn_mod, C, F, k, B, T, dtype, "serve")
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
    emit({"phase": "kernel", "name": "ffn_ln", **row})
    if not err <= tol:
        raise RuntimeError(f"ffn_ln at {row['at']}: max |err| {err} > {tol}")
    return row


def resblock_chain_bf16(x: torch.Tensor, blocks) -> torch.Tensor:
    """The resblock chain as bf16 ``F.conv1d`` calls (cuDNN) on (B, C, L),
    ``blocks`` the resblocks' pairs with bf16 weights: a chain of library
    calls, timed beside the kernel as a yardstick; no single PyTorch call
    computes a ResBlock1."""
    import torch.nn.functional as F

    h = x.transpose(1, 2)
    out = None
    for pairs in blocks:
        y = h
        for w1, b1, d, w2, b2 in pairs:
            t = F.leaky_relu(y, 0.1)
            t = F.conv1d(t, w1, b1, padding=d * (w1.shape[-1] - 1) // 2, dilation=d)
            t = F.conv1d(F.leaky_relu(t, 0.1), w2, b2, padding=(w2.shape[-1] - 1) // 2)
            y = y + t
        out = y if out is None else out + y
    out = out / float(len(blocks)) if len(blocks) > 1 else out
    return out.transpose(1, 2)


def _resblock_cases(dev, t_mel, g, dtype=torch.bfloat16) -> list:
    """Stage 0 (three resblock launches) and stages 1-3 (one trio launch
    each) of HiFi-GAN V1 in ``dtype`` for a mel of ``t_mel`` frames, with
    the tile plan of each launch; bf16 also times the same chain through
    bf16 cuDNN convs."""
    from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as rb
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator, HifiGanConfig

    cfg = HifiGanConfig()
    gen = Generator(cfg, dtype)
    with torch.no_grad():  # unit-gain convs, so every stage carries signal
        for m in gen.resblocks.modules():
            if isinstance(m, torch.nn.Conv1d):
                m.weight.normal_(0.0, (m.in_channels * m.kernel_size[0]) ** -0.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    gen.prepare()
    gen.to(dev)
    rows, L = [], t_mel
    name = str(dtype)[6:]
    for stage, weights in enumerate(gen.stage_weights):
        L *= cfg.upsample_rates[stage]
        C = cfg.upsample_initial_channel // 2 ** (stage + 1)
        x = torch.randn(1, L, C, generator=g).to(dev, dtype)
        for w in weights:
            trio = w.n_res > 1
            kern, plain = ((rb.resblock_trio, rb.resblock_trio_plain) if trio
                           else (rb.resblock, rb.resblock_plain))
            out = kern(x, w)
            launched = rb.last_launch()   # as the library gave it to the card
            ref = plain(x, w)
            torch.cuda.synchronize()
            err, tol = max_err_and_tol(out, ref, 1e-4)
            flops = L * sum(2 * k * C * C * 2 * len(ds)
                            for k, ds in zip(w.kernel_sizes, w.dilations))
            nbytes = 2 * tensor_bytes(x) + tensor_bytes(w.taps, w.bias)
            plan = rb.tile_plan(w, 1, L)
            if launched != {"blocks": plan.blocks, "tile": plan.tile,
                            "smem_bytes": plan.smem_bytes}:
                raise RuntimeError(f"{kern.__name__} at L={L}: launched {launched}, "
                                   f"planned {plan}")
            row = {"name": kern.__name__, "stage": stage,
                   "at": f"x (1, {L}, {C}) {name}, k={list(w.kernel_sizes)}, Tmel={t_mel}",
                   "route": plan.route, "max_abs_err": err, "tol": tol,
                   "ms": cuda_ms(lambda: kern(x, w)), "plain_ms": cuda_ms(lambda: plain(x, w)),
                   "tile": launched["tile"], "blocks_per_launch": launched["blocks"],
                   "smem_bytes": launched["smem_bytes"],
                   "halo_recompute_share": plan.halo_share}
            if dtype == torch.bfloat16:
                blocks = [[(w1.to(dtype), b1.to(dtype), d, w2.to(dtype), b2.to(dtype))
                           for w1, b1, d, w2, b2 in pairs] for pairs in w.pairs]
                chain = resblock_chain_bf16(x, blocks)
                row["cudnn_bf16_chain_ms"] = cuda_ms(lambda: resblock_chain_bf16(x, blocks))
                row["cudnn_bf16_chain_max_abs_err"] = (chain.float() - ref.float()).abs().max().item()
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
            row["tflops"] = flops / row["ms"] / 1e9
            row["x_bound"] = row["ms"] / row["bound_ms"]
            emit({"phase": "kernel", **row})
            if not err <= tol:
                raise RuntimeError(f"{row['name']} at {row['at']}: max |err| {err} > {tol}")
            rows.append(row)
    return rows


def kernels_phase(dev) -> dict:
    g = torch.Generator().manual_seed(0)
    # the served batch's decoder shape first (bucket 512), then the
    # 2048-frame decoder in both types and the encoder's widest kernel
    ffn = [_ffn_case(dev, 8, 512, 17, torch.bfloat16, g),
           _ffn_case(dev, 8, 2048, 17, torch.float32, g),
           _ffn_case(dev, 8, 2048, 17, torch.bfloat16, g),
           _ffn_case(dev, 8, 256, 25, torch.bfloat16, g)]
    rbs = _resblock_cases(dev, 512, g)
    # the f32 route (CUDA cores) at the same shapes: phase 6's request takes it
    rbs_f32 = _resblock_cases(dev, 512, g, torch.float32)
    return {"ffn_ln": ffn, "resblock": [r for r in rbs if r["name"] == "resblock"],
            "resblock_trio": [r for r in rbs if r["name"] == "resblock_trio"],
            "resblock_f32": rbs_f32}


def _calibrate_durations(model, gen, texts) -> float:
    """Bias the untrained duration head so rounded durations average about
    FRAMES_PER_PHONE (an untrained head gives ~1 frame per phone); returns
    the bias."""
    from lightningfastspeech2_tpu_torch.core.bucketing import pad_to

    ids = [gen.text_to_ids(t) for t in texts]
    P = gen.bucketer.phone_bucket(max(len(i) for i in ids))
    phones = torch.as_tensor(np.stack([pad_to(i, P) for i in ids]), device=model.device)
    speakers = torch.as_tensor(np.stack([gen.speaker2dvector["spk0"]] * len(ids)),
                               device=model.device)
    head = model.variance_adaptor.duration_predictor.linear
    with torch.no_grad():
        head.bias.zero_()
        out = model({"phones": phones, "speaker": speakers}, inference=True,
                    duration_only=True)
        pred = out["duration_prediction"].float()[out["phone_mask"]]
        bias = math.log(FRAMES_PER_PHONE + 1.0) - math.log(pred.exp().mean().item())
        head.bias.fill_(bias)
    return bias


def _make_generator(cfg, dtype, dev, dvecs, texts, bias, fastdiff=False, noise_source=None):
    """The served generator: the flagship and HiFi-GAN V1, or with
    ``fastdiff`` the flagship with its residual head and the FastDiff
    vocoder (its noise from ``noise_source`` where given)."""
    from lightningfastspeech2_tpu_torch.data.vocab import Vocab
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.synthesis.g2p import BUILTIN_LEXICON, EnglishG2P
    from lightningfastspeech2_tpu_torch.synthesis.generator import (
        FastDiffSynthesiser,
        SpeechGenerator,
    )
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig, Synthesiser

    g2p = EnglishG2P(BUILTIN_LEXICON)  # the generate CLI's default lexicon
    vocab = Vocab(p for t in texts for p in g2p(t))
    model = build_fastspeech2(cfg.model, dtype=dtype, device=dev, seed=0,
                              use_fastdiff_head=fastdiff)
    if fastdiff:
        synth = FastDiffSynthesiser(cfg.model, vocoder_precision=16 if dtype == torch.bfloat16
                                    else 32, device=dev, seed=1, noise_source=noise_source)
    else:
        synth = Synthesiser(HifiGanConfig(), dtype=dtype, device=dev, seed=1)
    gen = SpeechGenerator(cfg, model, vocab, g2p, synthesiser=synth,
                          speaker2dvector=dvecs)
    if bias is None:
        bias = _calibrate_durations(model, gen, texts)
    else:
        with torch.no_grad():
            model.variance_adaptor.duration_predictor.linear.bias.fill_(bias)
    return gen, bias


def _serve_all(gen, cfg, dvecs, tag: str = "") -> dict:
    """A warm-up request, the sentences one by one through
    ``generate_from_text`` and one batch of 8 through ``generate_samples``
    at frame bucket 512; every waveform checked finite. Returns the
    requests, the batch's row and the frame bucket of every vocoder call."""
    from lightningfastspeech2_tpu_torch.core.bucketing import pad_to

    def serve(text, seed):
        t = time.perf_counter()
        wav = gen.generate_from_text(text, speaker="spk0", seed=seed)
        ms = (time.perf_counter() - t) * 1e3
        if not (wav.ndim == 1 and wav.size > 0 and np.isfinite(wav).all()):
            raise RuntimeError(f"bad waveform for {text!r}: {wav.shape}")
        n_ph = len(gen.text_to_ids(text))
        frames = wav.size // cfg.model.audio.hop_length
        return {"text_chars": len(text), "phones": n_ph,
                "phone_bucket": gen.bucketer.phone_bucket(n_ph), "frames": frames,
                "frame_bucket": gen.bucketer.frame_bucket(frames),
                "frames_per_phone": frames / n_ph, "ms": ms,
                "audio_s": wav.size / SAMPLING_RATE, "finite": True,
                "peak": float(np.abs(wav).max())}

    warm = serve("Warm up the card.", 0)
    emit({"phase": f"{tag}request", "cold": True, **warm})
    requests = []
    for i, text in enumerate(SENTENCES):
        r = serve(text, i)
        emit({"phase": f"{tag}request", **r})
        requests.append(r)
    if len({r["phones"] for r in requests}) != len(SENTENCES):
        raise RuntimeError("the sentences should differ in length")

    # one batch of 8 from the phones of all texts: the longest item needs
    # ~360 frames, which puts the batch in frame bucket 512 (256, 512]
    fpp = sum(r["frames"] for r in requests) / sum(r["phones"] for r in requests)
    n_max = max(8, int(360 / fpp))
    stream = np.concatenate([gen.text_to_ids(t) for t in BATCH_TEXTS])
    ids = [stream[5 * j: 5 * j + max(4, n_max - 4 * j)] for j in range(len(BATCH_TEXTS))]
    P = gen.bucketer.phone_bucket(max(len(i) for i in ids))
    batch = {"phones": np.stack([pad_to(i, P) for i in ids]),
             "speaker": np.stack([dvecs[f"spk{j % 4}"] for j in range(len(ids))])}
    t = time.perf_counter()
    wavs = gen.generate_samples(batch)
    ms = (time.perf_counter() - t) * 1e3
    frames = [w.size // cfg.model.audio.hop_length for w in wavs]
    bucket = gen.bucketer.frame_bucket(max(frames))
    finite = all(w.size > 0 and np.isfinite(w).all() for w in wavs)
    audio_s = sum(w.size for w in wavs) / SAMPLING_RATE
    row = {"phase": f"{tag}batch", "batch": len(wavs), "phone_bucket": P,
           "frame_bucket": bucket, "frames": frames, "ms": ms, "audio_s": audio_s,
           "finite": finite, "audio_s_per_s": audio_s / (ms / 1e3)}
    emit(row)
    if not finite or bucket != 512:
        raise RuntimeError(f"batch: finite={finite}, frame bucket {bucket} (want 512)")
    torch.cuda.synchronize()
    # every vocoder call (one per item) sees the mel at its request's bucket
    buckets = [warm["frame_bucket"]] + [r["frame_bucket"] for r in requests] + [bucket] * len(wavs)
    return {"requests": requests, "batch": row, "batch_inputs": batch,
            "vocoder_buckets": buckets, "n_calls": len(SENTENCES) + 2}


BATCH_RUNS = 5


def batch_repeats(gen, batch, first: dict) -> dict:
    """The served batch again, BATCH_RUNS times on the host clock, outside
    the counted run: its median and spread, since one host-clock reading
    moves by up to 2x between runs of the same code."""
    runs = []
    for _ in range(BATCH_RUNS):
        t = time.perf_counter()
        gen.generate_samples(batch)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    ms = statistics.median(runs)
    row = {"phase": "batch_repeats", "batch": first["batch"],
           "frame_bucket": first["frame_bucket"], "ms_median": ms, "ms_min": min(runs),
           "ms_max": max(runs), "ms_runs": runs, "first_ms": first["ms"],
           "audio_s_per_s_median": first["audio_s"] / (ms / 1e3)}
    emit(row)
    return row


def serving_phase(counters) -> dict:
    """The main path: build the flagship and V1 in bf16 on the card, serve
    the sentences one by one and one batch of 8 at frame bucket 512."""
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship

    cfg = lightspeech_flagship()
    rng = np.random.default_rng(0)
    dvecs = {}
    for i in range(4):
        v = rng.standard_normal(cfg.model.dvector_dim).astype(np.float32)
        dvecs[f"spk{i}"] = v / np.linalg.norm(v)
    # set-up, not the main path: the duration bias from the same seeded
    # weights through the plain path on the CPU, so it launches no kernel
    _, bias = _make_generator(cfg, torch.float32, "cpu", dvecs, BATCH_TEXTS, None)
    reset_counts(counters)
    t0 = time.perf_counter()
    gen, _ = _make_generator(cfg, torch.bfloat16, None, dvecs, BATCH_TEXTS, bias)
    emit({"phase": "serving_setup", "seconds": time.perf_counter() - t0,
          "duration_bias": bias,
          "note": "untrained duration head biased so rounded durations average "
                  f"about {FRAMES_PER_PHONE:g} frames per phone (bias taken on "
                  "the CPU before the launch counters were set to 0)"})
    run = _serve_all(gen, cfg, dvecs)
    launches = {c.__name__: c.launches for c in counters}
    # what the path must launch: the probe once, when the first entry point
    # resolves the card; per generate_samples call (the warm-up, each
    # sentence, the batch) the encoder's blocks in the duration pass and
    # the encoder's and decoder's in the full pass; per vocoder call (one
    # per item) one resblock or trio launch per prepared stack
    m, stacks = cfg.model, gen.synthesiser.model.stage_weights
    n_items = len(run["vocoder_buckets"])
    want = {c.__name__: 0 for c in counters}   # the training kernels: none here
    want.update({"probe": 1,
                 "ffn_ln": run["n_calls"] * (2 * m.encoder.layers + m.decoder.layers),
                 "resblock": n_items * sum(len(s) for s in stacks if len(s) > 1),
                 "resblock_trio": n_items * sum(1 for s in stacks if len(s) == 1)})
    emit({"phase": "launches", **launches, "expected": want})
    path = ("probe", "ffn_ln", "resblock", "resblock_trio")
    if launches != want or any(launches[k] == 0 for k in path):
        raise RuntimeError(f"serving-path launches {launches}, expected {want}")
    repeats = batch_repeats(gen, run["batch_inputs"], run["batch"])
    profile_row = hifigan_vocoder_profile(gen.synthesiser, cfg)
    return {"vocoder_profile": profile_row, "batch_repeats": repeats,
            "launches": launches, "bias": bias, "dvecs": dvecs, "cfg": cfg,
            "requests": run["requests"], "batch": run["batch"]}


HIFIGAN_PROFILE_FRAMES = 512
HIFIGAN_CALL_RUNS = 5


def hifigan_vocoder_profile(synth, cfg) -> dict:
    """One HiFi-GAN vocoder call on a 512-frame mel, outside the counted
    run: the host clock over HIFIGAN_CALL_RUNS calls, then one call under
    the profiler for device ms and the resblock kernels' share."""
    from torch.profiler import ProfilerActivity, profile

    mel = (np.random.default_rng(5).standard_normal(
        (HIFIGAN_PROFILE_FRAMES, cfg.model.audio.n_mels)) - 4.0).astype(np.float32)
    synth(mel)
    torch.cuda.synchronize()
    runs = []
    for _ in range(HIFIGAN_CALL_RUNS):
        t = time.perf_counter()
        synth(mel)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synth(mel)
        torch.cuda.synchronize()
    split = _step_split(prof, "hifigan_vocoder_profile.txt")
    row = {"phase": "hifigan_vocoder_profile", "frames": HIFIGAN_PROFILE_FRAMES,
           "call_ms": statistics.median(runs), "call_ms_runs": runs,
           "device_ms": split["device_ms"], "device_launches": split["device_launches"],
           "resblock_ms": split["resblock_ms"], "resblock_launches": split["resblock_launches"],
           "resblock_share": split["resblock_ms"] / max(split["device_ms"], 1e-9),
           "rest_device_ms": split["device_ms"] - split["resblock_ms"]}
    emit(row)
    if split["resblock_launches"] != 6:
        raise RuntimeError(f"profiled vocoder call: {split['resblock_launches']} resblock "
                           "kernel launches on the device, expected 6")
    return row


def reference_phase(served, fastdiff: bool = False) -> None:
    """One f32 request on the card (kernels) against the same request on
    the CPU (plain versions), same seeded weights and duration bias; with
    ``fastdiff``, the FastDiff server, its noise drawn on the CPU from one
    seed for each call and handed to both."""
    text = SENTENCES[1]
    cfg = served["fastdiff_cfg"] if fastdiff else served["cfg"]

    def cpu_noise(shape, N):
        g = torch.Generator().manual_seed(7)
        return torch.randn(tuple(shape), generator=g), torch.randn((N, *shape), generator=g)

    wavs, ms = {}, {}
    for dev in ("cuda", "cpu"):
        gen, _ = _make_generator(cfg, torch.float32, dev, served["dvecs"], BATCH_TEXTS,
                                 bias=served["bias"], fastdiff=fastdiff,
                                 noise_source=cpu_noise if fastdiff else None)
        t = time.perf_counter()
        wavs[dev] = gen.generate_from_text(text, speaker="spk1", seed=0)
        ms[dev] = (time.perf_counter() - t) * 1e3
    a, b = wavs["cuda"], wavs["cpu"]
    top = float(np.abs(b).max())
    err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    # f32 on both sides, TF32 off: summation order only, through two models
    # (and, for FastDiff, four ε passes of the reverse sampler)
    tol = 1e-3 * top + 1e-7
    name = "fastdiff_reference" if fastdiff else "reference"
    emit({"phase": name, "samples": [a.size, b.size], "max_abs_err": err,
          "tol": tol, "peak": top, "request_ms": ms})
    if not (a.shape == b.shape and err <= tol and top > 0):
        raise RuntimeError(f"{name} card vs CPU: shapes {a.shape} {b.shape}, "
                           f"max |err| {err} > {tol}")


# ---------------------------------------------------------- training slice
TRAIN_B, TRAIN_P, TRAIN_T = 8, 256, 2048   # bench.py's training workload
STEP_PAIRS = 8


def train_config(rates: bool = True, B_P_T=(TRAIN_B, TRAIN_P, TRAIN_T), mel_loss: str = "l1"):
    """The flagship cut to one frame bucket (max_phones P, max_frames T), its
    config dropout rates or (``rates=False``) every rate 0, and the mel
    loss (the flagship's l1, or soft_dtw)."""
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship, replace

    _, P, T = B_P_T
    cfg = lightspeech_flagship()
    cfg = replace(cfg, train=replace(cfg.train, mel_loss=mel_loss))
    m = replace(cfg.model, max_phones=P, max_frames=T)
    if not rates:
        m = replace(m, encoder=replace(m.encoder, dropout=0.0),
                    decoder=replace(m.decoder, dropout=0.0),
                    variance=replace(m.variance, dropouts=(0.0,) * len(m.variance.variances)),
                    duration=replace(m.duration, dropout=0.0))
    return replace(cfg, model=m)


def train_batch(cfg, B_P_T=(TRAIN_B, TRAIN_P, TRAIN_T)):
    """bench.py's batch: P - 16 valid phones whose teacher durations fill T."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import make_dummy_batch

    B, P, T = B_P_T
    return make_dummy_batch(cfg.model, batch_size=B, n_phones=P - 16, n_frames=T,
                            seed=0, fill_frames=True)


def cuda_ms_grad(out, inputs, grad, **kw) -> float:
    """Time of the backward alone: autograd.grad on a retained graph."""
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, grad, retain_graph=True), **kw)


def ffn_launches(ffn, C, F, k, B, T, dtype, mode) -> list:
    """The launches of the latest ``mode`` call (serve, train, bwd) as the
    libraries recorded them, held against ``ffn_plan``: raises when a
    grid, shared-memory size or row count differs."""
    rec = ffn.last_launches()
    got = ([rec["ffn_ln"]] if mode != "bwd" or dtype == torch.bfloat16 else []) + (
        rec["ffn_ln_train_bwd"] if mode == "bwd" else [])
    plan = ffn.ffn_plan(C, F, k, B, T, dtype, mode)
    want = [ffn.planned_launch(x) for x in plan]
    if got != want:
        raise RuntimeError(f"ffn {mode} launches {got}, planned {want}")
    return [{"kernel": x.kernel, "blocks": r["grid"][0] * r["grid"][1] * r["grid"][2],
             "smem_bytes": r["smem_bytes"], "rows": r["rows"]} for x, r in zip(plan, got)]


def _ffn_train_case(dev, B, T, k, g) -> dict:
    """ffn_ln_train forward and backward kernels at one of the step's FFN
    shapes (bf16, F 1024, rate 0.1): the output and every gradient against
    the plain version's autograd (and the gradients' distance from the
    staged plain backward, the kernels' own rounding points), the kernel
    times with the call's weight layouts prepared, each launch as the
    library recorded it."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import init_weights
    from lightningfastspeech2_tpu_torch.models.layers import FFTBlock
    from lightningfastspeech2_tpu_torch.ops import ffn

    C, F, rate, dtype = 256, 1024, 0.1, torch.bfloat16
    block = FFTBlock(C, 2, k, F, dtype)
    init_weights(block, g)
    with torch.no_grad():
        for n in (block.norm1, block.norm2):
            n.weight.copy_(1.0 + 0.1 * torch.randn(C, generator=g))
            n.bias.copy_(0.1 * torch.randn(C, generator=g))
    block.to(dev)
    p = [t.detach().clone().requires_grad_(True) for t in ffn.ffn_train_params(*block._ffn_modules())]
    z = torch.randn(B, T, C, generator=g).to(dev, dtype)
    dout = torch.randn(B, T, C, generator=g).to(dev, dtype)
    seed = torch.tensor([4242], dtype=torch.int32, device=dev)
    at = f"z ({B}, {T}, {C}) bf16, F={F}, k={k}, rate={rate}"
    w = ffn._kernel_layouts(p, dtype)
    row_f = {"name": "ffn_ln_train", "at": at,
             "ms": cuda_ms(lambda: ffn.ffn_ln_train_fwd(z, p, seed, rate, layouts=w))}
    row_f["launch"] = ffn_launches(ffn, C, F, k, B, T, dtype, "train")
    row_b = {"name": "ffn_ln_train_bwd", "at": at,
             "ms": cuda_ms(lambda: ffn.ffn_ln_train_bwd(dout, z, p, seed, rate, layouts=w))}
    row_b["launch"] = ffn_launches(ffn, C, F, k, B, T, dtype, "bwd")
    # what a training call adds to the kernels: the weight layouts it prepares
    row_f["layouts_ms"] = cuda_ms(lambda: ffn._kernel_layouts(p, dtype))
    wbytes = sum(tensor_bytes(t) for t in p)
    row_f["bound_ms"], row_f["bound_by"] = bound_ms(
        B * T * (2 * k * C + 4 * C * F), 2 * tensor_bytes(z) + wbytes, dtype)
    # the backward recomputes up and ff (4CF) and forms dup, dacc, dW1, dW2f (8CF)
    row_b["bound_ms"], row_b["bound_by"] = bound_ms(
        B * T * (6 * k * C + 12 * C * F), 3 * tensor_bytes(z) + 2 * wbytes, dtype)
    zk = z.clone().requires_grad_(True)
    out = ffn.ffn_ln_train(zk, p, seed, rate)
    grads = torch.autograd.grad(out, [zk, *p], dout)
    zp = z.clone().requires_grad_(True)
    ref = ffn.ffn_ln_train_plain(zp, p, seed, rate)
    ref_grads = torch.autograd.grad(ref, [zp, *p], dout, retain_graph=True)
    staged = ffn.ffn_ln_train_bwd_plain(dout, z, p, seed, rate)
    torch.cuda.synchronize()
    err, tol = max_err_and_tol(out, ref, 2e-4)
    row_f.update(max_abs_err=err, tol=tol,
                 plain_ms=cuda_ms(lambda: ffn.ffn_ln_train_plain(z, p, seed, rate)))
    # gradients against the plain version's autograd: the kernel rounds
    # dff and dup to bf16 before its products, the plain version keeps
    # them f32; each within 3 % of its largest element
    errs, staged_rel = {}, {}
    names = ("dz", "dwd", "dbd", "dw1", "db1", "dw2f", "db2f", "dg1", "dbe1", "dg2", "dbe2")
    for name, a, b, c in zip(names, grads, ref_grads, staged):
        errs[name] = ((a.float() - b.float()).abs().max().item(),
                      0.03 * b.float().abs().max().item())
        staged_rel[name] = ((a.float() - c.float()).abs().max()
                            / c.float().abs().max().clamp_min(1e-30)).item()
    row_b.update(max_abs_err=max(e for e, _ in errs.values()),
                 grad_errs=errs, tol="3 % of each gradient's largest element",
                 staged_plain_max_rel_err=staged_rel,
                 plain_ms=cuda_ms_grad(ref, [zp, *p], dout))
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    if not err <= tol:
        raise RuntimeError(f"ffn_ln_train at {at}: max |err| {err} > {tol}")
    bad = {n: e for n, e in errs.items() if not e[0] <= e[1]}
    if bad:
        raise RuntimeError(f"ffn_ln_train_bwd at {at}: gradients off {bad}")
    return {"fwd": row_f, "bwd": row_b}


def _flash_case(dev, g, dtype=torch.bfloat16, B=TRAIN_B, T=TRAIN_T, rate=0.1) -> dict:
    """flash_attention forward and backward against the plain version, with
    SDPA (same mask and dropout_p) timed as the library yardstick: bf16 at
    the decoder's shape (the wgmma kernels of flash_attention_sm90.cu), f32
    at phase 9's (the split-TF32 mma.sync kernels of flash_attention.cu)."""
    import torch.nn.functional as F
    from lightningfastspeech2_tpu_torch.kernels import build
    from lightningfastspeech2_tpu_torch.ops import attention as att

    H, d = 2, 128
    q, k, v, do = (torch.randn(B, H, T, d, generator=g).to(dev, dtype) for _ in range(4))
    lengths = torch.tensor([T - 97 * i for i in range(B)], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    mask_i32 = mask.to(torch.int32)
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    name = str(dtype)[6:]
    at = f"q/k/v ({B}, {H}, {T}, {d}) {name}, ragged key mask, rate={rate}"
    route = att.kernel_route(q, k, v)
    fns = (att.flash_attention, att.flash_attention_bwd)
    before = [dict(fn.by_route) for fn in fns]
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = att.flash_attention(*qkv, mask, rate, seed)
    grads = torch.autograd.grad(out, qkv, do)
    torch.cuda.synchronize()
    routed = [{r: fn.by_route[r] - n for r, n in b.items()} for fn, b in zip(fns, before)]
    pq = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = att.flash_attention_plain(*pq, mask, rate, seed)
    ref_grads = torch.autograd.grad(ref, pq, do, retain_graph=True)
    torch.cuda.synchronize()
    # bf16 in and out; the kernel rounds p against the running max, the
    # plain version the normalised p: 2 % of the largest element; f32:
    # summation order only, 1e-4 of the largest element
    frac = 0.02 if dtype == torch.bfloat16 else 1e-4
    errs = {n: ((a.float() - b.float()).abs().max().item(), frac * b.float().abs().max().item())
            for n, a, b in zip(("o", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads))}
    o, lse, o32 = att.flash_attention_fwd(q, k, v, mask_i32, seed, rate)
    suffix = "" if dtype == torch.bfloat16 else "_f32"
    common = {"at": at, "route": route, "build_s": build.build_report[route]["seconds"]}
    row_f = {"name": "flash_attention" + suffix, **common, "max_abs_err": errs["o"][0],
             "tol": errs["o"][1],
             "ms": cuda_ms(lambda: att.flash_attention_fwd(q, k, v, mask_i32, seed, rate)),
             "plain_ms": cuda_ms(lambda: att.flash_attention_plain(q, k, v, mask, rate, seed))}
    row_b = {"name": "flash_attention_bwd" + suffix, **common,
             "max_abs_err": max(errs[n][0] for n in ("dq", "dk", "dv")), "grad_errs": errs,
             "tol": f"{frac:g} of each gradient's largest element",
             "ms": cuda_ms(lambda: att.flash_attention_bwd(do, q, k, v, mask_i32, seed, o32, lse,
                                                           rate)),
             "plain_ms": cuda_ms_grad(ref, pq, do)}
    if rate > 0.0:
        # the same kernels without dropout: what the keep hash costs
        _, lse0, o320 = att.flash_attention_fwd(q, k, v, mask_i32, seed, 0.0)
        row_f["ms_rate0"] = cuda_ms(lambda: att.flash_attention_fwd(q, k, v, mask_i32, seed, 0.0))
        row_b["ms_rate0"] = cuda_ms(lambda: att.flash_attention_bwd(do, q, k, v, mask_i32, seed,
                                                                    o320, lse0, 0.0))
    # the library call: SDPA with the same boolean key mask and dropout_p
    am = mask[:, None, None, :]
    row_f["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=am, dropout_p=rate))
    sq = [t.clone().requires_grad_(True) for t in (q, k, v)]
    sout = F.scaled_dot_product_attention(*sq, attn_mask=am, dropout_p=rate)
    row_b["library_ms"] = cuda_ms_grad(sout, sq, do)

    def sdpa_fwd_bwd():
        xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
        torch.autograd.grad(F.scaled_dot_product_attention(*xs, attn_mask=am, dropout_p=rate),
                            xs, do)
    row_b["library_fwd_bwd_ms"] = cuda_ms(sdpa_fwd_bwd)
    # The function's work on this mask: a T x d by d x n product per (b, h)
    # over the n valid keys of each item (all T keys where there is none).
    # Forward: S and P.V; backward: the five products S, dP, dV, dQ, dK.
    # The kernels' split backward forms S and dP in both passes, seven
    # products: its own figure is split_bound_ms. f32 products are
    # f32-accurate ones (PEAK_F32_ACCURATE).
    nb = tensor_bytes(q, k, v)
    n_keys = mask.sum(1)
    unit = H * T * d * torch.where(n_keys > 0, n_keys, T).sum().item()
    bwd_bytes = 2 * nb + tensor_bytes(do, o, lse)
    peak = PEAK_F32_ACCURATE if dtype == torch.float32 else None
    for r, ops, nbytes in ((row_f, 4 * unit, nb + tensor_bytes(o, lse)),
                           (row_b, 10 * unit, bwd_bytes)):
        r["bound_ms"], r["bound_by"] = bound_ms(ops, nbytes, dtype, peak)
        r["vs_library"] = r["ms"] / r["library_ms"]
    row_b["split_bound_ms"] = bound_ms(14 * unit, bwd_bytes, dtype, peak)[0]
    if route == "flash_attention":
        # the grids the library gave its latest launches, all at this shape
        row_f["blocks_per_launch"] = flash_f32_blocks(0)
        row_b["blocks_per_launch"] = {"dq": flash_f32_blocks(1), "dkv": flash_f32_blocks(2)}
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    bad = {n: e for n, e in errs.items() if not e[0] <= e[1]}
    if bad:
        raise RuntimeError(f"flash_attention at {at}: off {bad}")
    want = [{r: int(r == route) for r in b} for b in before]
    if routed != want:
        raise RuntimeError(f"flash_attention at {at}: launches by route {routed}, expected {want}")
    return {"fwd": row_f, "bwd": row_b}


def flash_f32_blocks(which: int) -> int:
    """Blocks in the grid of the f32 flash library's latest launch of
    kernel ``which`` (0 the forward, 1 the dQ pass, 2 the dK/dV pass), as
    the library recorded it when the launch was accepted."""
    import ctypes
    from lightningfastspeech2_tpu_torch.kernels import build

    lib = build.load("flash_attention")
    fn = lib.lfs2_flash_attention_last_grid
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    grid = (ctypes.c_int * 3)()
    build.check(lib, fn(which, grid), "flash_attention grid query")
    return grid[0] * grid[1] * grid[2]


def train_kernels_phase(dev) -> dict:
    """The training kernels at the step's shapes: every FFN block of the
    flagship (encoder at P = 256, decoder at T = 2048) timed and held
    against the plain version; flash attention at the decoder's shape in
    bf16 and at phase 9's in f32."""
    g = torch.Generator().manual_seed(1)
    enc_k, dec_k = (5, 25, 13, 9), (17, 21, 9, 13)
    ffn = ([_ffn_train_case(dev, TRAIN_B, TRAIN_P, k, g) for k in enc_k]
           + [_ffn_train_case(dev, TRAIN_B, TRAIN_T, k, g) for k in dec_k])
    return {"ffn": ffn, "flash": _flash_case(dev, g),
            "flash_f32": _flash_case(dev, g, torch.float32, B=2, T=1024, rate=0.0)}


def _step_split(prof, out_name: str = "train_profile.txt") -> dict:
    """Device time of one traced step by kernel family (torch.profiler
    key_averages, kernel names matched as whole words); zeros when the
    profiler saw no device time."""
    # the bf16 FFN template ffn_ln_kernel<CP, kChain> is the forward with
    # kChain false and the backward's first launch with kChain true
    fam = {"ffn_ln_train": (r"ffn_ln_kernel<\d+, false>", r"ffn_ln_f32_kernel<float, \d+, true>"),
           "ffn_ln_train_bwd": (r"ffn_ln_kernel<\d+, true>", "ffn_dup_kernel", "ffn_dt1_kernel",
                                "ffn_bwd_kernel"),
           "flash_attention": ("fwd_sm90_kernel", "fwd_kernel"),
           "flash_attention_bwd": ("dq_sm90_kernel", "dkv_sm90_kernel", "dq_kernel", "dkv_kernel"),
           "soft_dtw": "soft_dtw_fwd_kernel", "soft_dtw_bwd": "soft_dtw_bwd_kernel",
           "regulate": "regulate_expand_kernel", "regulate_bwd": "regulate_segsum_kernel",
           "lvc_stack": "lvc_stack_kernel",
           "resblock": ("wg_resblock_kernel", "mma_resblock_kernel", "resblock_kernel")}
    out = {k: 0.0 for k in fam}
    counts = {k: 0 for k in fam}
    total = 0.0
    rows = []
    from torch.autograd import DeviceType

    events = prof.key_averages()
    host_names = {e.key for e in events if e.device_type == DeviceType.CPU}
    for e in events:
        # kernels only: a CPU op (e.g. the autograd Function) that launched
        # a kernel lists the same device time again, and a range the host
        # annotated (e.g. the optimizer's step) reappears on the device
        # spanning kernels already counted
        if e.device_type != DeviceType.CUDA or e.key in host_names:
            continue
        t = e.self_device_time_total
        if t <= 0:
            continue
        total += t
        rows.append((e.key, t, e.count))
        for k, pat in fam.items():
            pats = pat if isinstance(pat, tuple) else (pat,)
            if any(re.search(rf"\b{x}" + ("" if x.endswith(">") else r"\b"), e.key) for x in pats):
                out[k] += t
                counts[k] += e.count
    rows.sort(key=lambda r: -r[1])
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / out_name).write_text(
        "\n".join(f"{t / 1e3:10.3f} ms  x{c:<5d} {k}" for k, t, c in rows))
    return {"device_ms": total / 1e3, "device_launches": sum(c for _, _, c in rows),
            **{f"{k}_ms": v / 1e3 for k, v in out.items()},
            **{f"{k}_launches": v for k, v in counts.items()}}


def reset_counts(counters) -> None:
    """Every launch count to 0, and the flash kernels' counts by route."""
    for c in counters:
        c.launches = 0
        if hasattr(c, "by_route"):
            c.by_route = dict.fromkeys(c.by_route, 0)


def flash_routes(counters) -> dict:
    """The flash kernels' launches by library (csrc/<name>.cu)."""
    return {c.__name__: dict(c.by_route) for c in counters if hasattr(c, "by_route")}


def soft_dtw_launches_per_step(cfg) -> int:
    """``soft_dtw`` (and ``soft_dtw_bwd``) launches of one teacher-forced
    step, from the config: each soft-DTW loss folds its full chunks into one
    launch, and its tail chunk takes a launch of its own when it has at
    least 8 frames (shorter lattices take the plain recurrence)."""
    m, t = cfg.model, cfg.train
    lengths = [m.max_frames] if t.mel_loss == "soft_dtw" else []
    lengths += [m.max_frames if lvl == "frame" else m.max_phones
                for lvl, kind in zip(m.variance.levels, m.variance.losses) if kind == "soft_dtw"]
    c = t.soft_dtw_chunk_size
    return sum(int(n >= c and c >= 8) + int(n % c >= 8) for n in lengths)


def regulate_launches_per_step(cfg) -> int:
    """``regulate`` (and ``regulate_bwd``) launches of one teacher-forced step
    with the opt-in set: the regulator expands x, and also the phone-level
    variances' summed embedding when there is one
    (models/variance_adaptor.py); both are 3-D and the frame count is a
    multiple of 256."""
    assert cfg.model.max_frames % 256 == 0
    return 1 + int("phone" in cfg.model.variance.levels)


@contextlib.contextmanager
def env_opt_in(name: str):
    """``name=1`` in this process (``LFS2_PALLAS_LR``, ``LFS2_FUSED_STAGE1``),
    as a user who sets it."""
    old = os.environ.get(name)
    os.environ[name] = "1"
    try:
        yield
    finally:
        if old is None:
            del os.environ[name]
        else:
            os.environ[name] = old


def training_phase(counters, soft_dtw: bool = False) -> dict:
    """A main path of training: the flagship in bf16 (f32 parameters) takes
    1 warm-up and 5 timed optimizer steps on B=8, P=256, T=2048
    teacher-forced batches, config dropout rates, the l1 mel loss; with
    ``soft_dtw`` (this slice's path, run under ``env_opt_in("LFS2_PALLAS_LR")``), 1
    warm-up and 3 timed steps with the soft-DTW mel loss."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    cfg = train_config(mel_loss="soft_dtw" if soft_dtw else "l1")
    batch = train_batch(cfg)
    n_steps = 4 if soft_dtw else 6
    reset_counts(counters)
    t0 = time.perf_counter()
    model = build_fastspeech2(cfg.model, dtype=torch.bfloat16, seed=0)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=model.device).manual_seed(5)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    steps, metrics = [], []
    for i in range(n_steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    routes = flash_routes(counters)
    # every parameter's gradient of the last step: finite and not all zero
    # (a kernel detached from autograd would leave zeros)
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    L_enc, L_dec = cfg.model.encoder.layers, cfg.model.decoder.layers
    want = {c.__name__: 0 for c in counters}
    want.update(ffn_ln_train=n_steps * (L_enc + L_dec), ffn_ln_train_bwd=n_steps * (L_enc + L_dec),
                flash_attention=n_steps * L_dec, flash_attention_bwd=n_steps * L_dec)
    if soft_dtw:
        n_sdtw, n_lr = soft_dtw_launches_per_step(cfg), regulate_launches_per_step(cfg)
        want.update(soft_dtw=n_steps * n_sdtw, soft_dtw_bwd=n_steps * n_sdtw,
                    regulate=n_steps * n_lr, regulate_bwd=n_steps * n_lr)
    timed = steps[1:]
    name = "soft_dtw_training" if soft_dtw else "training"
    row = {"phase": name, "mel_loss": cfg.train.mel_loss,
           "LFS2_PALLAS_LR": os.environ.get("LFS2_PALLAS_LR"), "setup_s": setup_s,
           "steps": n_steps, "step_ms": steps,
           "timed_step_ms_mean": sum(timed) / len(timed),
           "frames_per_s": TRAIN_B * TRAIN_T / (sum(timed) / len(timed) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_losses": metrics[0], "last_losses": metrics[-1], "finite": finite,
           "params_without_grad": bad, "launches": launches, "expected": want,
           "flash_routes": routes}
    emit(row)
    if not finite or bad:
        raise RuntimeError(f"{name}: finite={finite}, params without gradient {bad[:8]}")
    if launches != want:
        raise RuntimeError(f"{name}-path launches {launches}, expected {want}")
    # the bf16 step's attention went through the wgmma kernels alone
    want_routes = {k: {"flash_attention_sm90": want[k], "flash_attention": 0} for k in routes}
    if routes != want_routes:
        raise RuntimeError(f"{name}: flash launches by route {routes}, expected {want_routes}")
    # one more step under the profiler (outside the counted run): where the
    # step's device time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    split = _step_split(prof, f"{name}_profile.txt")
    flash_ms = split["flash_attention_ms"] + split["flash_attention_bwd_ms"]
    emit({"phase": f"{name}_profile", **split, "flash_share_ms": flash_ms,
          "flash_share": flash_ms / split["device_ms"] if split["device_ms"] else None})

    def one_step() -> float:
        """One more step (outside the counted run), its host-clock ms."""
        nonlocal state
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    return {"row": row, "split": split, "one_step": one_step}


def train_reference_phase(soft_dtw: bool = False) -> dict:
    """One f32 optimizer step on the card (kernels) against the same step on
    the CPU (plain versions): flagship widths, B=2, T=1024 so the flash gate
    admits the decoder, every dropout rate 0 (the generators differ); with
    ``soft_dtw``, the soft-DTW mel loss (run under ``env_opt_in("LFS2_PALLAS_LR")``, so
    the card's regulator runs its kernels too)."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    from lightningfastspeech2_tpu_torch.core.config import replace

    shape = (2, 128, 1024)
    cfg = train_config(rates=False, B_P_T=shape, mel_loss="soft_dtw" if soft_dtw else "l1")
    # lr 1e-4 at the first update (the flagship's 4000-step warm-up would
    # make it 2.5e-8, below the f32 resolution of the parameters)
    cfg = replace(cfg, train=replace(cfg.train, warmup_steps=1))
    batch = train_batch(cfg, shape)
    from lightningfastspeech2_tpu_torch.ops.attention import flash_attention, flash_attention_bwd

    res = {}
    reset_counts((flash_attention, flash_attention_bwd))
    for dev in ("cuda", "cpu"):
        model = build_fastspeech2(cfg.model, dtype=torch.float32, device=dev, seed=0)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = create_train_state(model, cfg)
        state, m = make_train_step(model, cfg)(state, batch, torch.Generator(device=dev))
        res[dev] = {
            "losses": {k: float(v) for k, v in m.items()},
            "grad": {n: state.optimizer.state[p]["exp_avg"].cpu() / 0.1
                     for n, p in model.named_parameters()},
            "update": {n: (p.detach() - before[n]).cpu() for n, p in model.named_parameters()}}
    a, b = res["cuda"], res["cpu"]
    loss_err = max(abs(a["losses"][k] - v) / max(abs(v), 1e-6) for k, v in b["losses"].items())
    gmax = max(g.abs().max().item() for g in b["grad"].values())
    grad_err = max((a["grad"][n] - g).abs().max().item() for n, g in b["grad"].items())
    lr = max(u.abs().max().item() for u in b["update"].values())
    upd_err = 0.0
    for n, g in b["grad"].items():
        sure = g.abs() > 1e-2 * gmax
        if sure.any():
            upd_err = max(upd_err, (a["update"][n] - b["update"][n])[sure].abs().max().item())
    # f32 on both sides, TF32 off: losses to 1e-4 relative; gradients to
    # 1e-3 of the largest; the Adam update (about lr * sign(g) at the first
    # step) to 1 % of its size where |g| > 1 % of the largest gradient
    tol = {"loss_rel": 1e-4, "grad_abs": 1e-3 * gmax, "update_abs": 1e-2 * lr}
    name = "soft_dtw_train_reference" if soft_dtw else "train_reference"
    row = {"phase": name, "at": f"flagship f32, B=2, P=128, T=1024, rates 0, mel loss "
                               f"{cfg.train.mel_loss}",
           "loss_rel_err": loss_err, "grad_max_abs_err": grad_err, "grad_max": gmax,
           "update_max_abs_err": upd_err, "update_max": lr, "tol": tol,
           "losses_cuda": a["losses"], "losses_cpu": b["losses"],
           "flash_routes": flash_routes((flash_attention, flash_attention_bwd))}
    emit(row)
    # the f32 step's attention went through the split-TF32 kernels alone
    n_dec = cfg.model.decoder.layers
    want_routes = {k: {"flash_attention_sm90": 0, "flash_attention": n_dec}
                   for k in ("flash_attention", "flash_attention_bwd")}
    if row["flash_routes"] != want_routes:
        raise RuntimeError(f"{name}: flash launches by route {row['flash_routes']}, "
                           f"expected {want_routes}")
    if not (loss_err <= tol["loss_rel"] and grad_err <= tol["grad_abs"]
            and upd_err <= tol["update_abs"]):
        raise RuntimeError(f"train step card vs CPU: {row}")
    return row


# ------------------------------------------------------- soft-DTW slice
def _soft_dtw_case(dev, g) -> dict:
    """soft_dtw forward and backward at the mel loss's lattices: 8 items x 8
    chunks of 256 frames, D from 80 channels (a bf16 prediction against an
    f32 target, as in the step), gamma 0.1."""
    from lightningfastspeech2_tpu_torch.ops import soft_dtw as sd

    chunk, C, gamma = 256, 80, 0.1
    L = TRAIN_B * TRAIN_T // chunk
    pred = (0.5 * torch.randn(L, chunk, C, generator=g)).to(dev, torch.bfloat16)
    truth = torch.randn(L, chunk, C, generator=g).to(dev)
    D = sd.pairwise_sqdist(pred, truth).contiguous()
    up = torch.ones(L, device=dev)       # the loss sums the lattices' values
    Dk = D.clone().requires_grad_(True)
    val = sd.soft_dtw_from_dist(Dk, gamma)
    (grad,) = torch.autograd.grad(val, Dk, up)
    Dp = D.clone().requires_grad_(True)
    ref = sd.soft_dtw_from_dist_plain(Dp, gamma)
    (ref_grad,) = torch.autograd.grad(ref, Dp, up, retain_graph=True)
    torch.cuda.synchronize()
    # f32 on both sides with the same softmin: the value to 1e-5 relative,
    # dD (alignment weights in [0, 1]) to 1e-4 of its largest element
    v_err = ((val - ref).abs() / ref.abs()).max().item()
    g_err, g_tol = (grad - ref_grad).abs().max().item(), 1e-4 * ref_grad.abs().max().item()
    at = f"D ({L}, {chunk}, {chunk}) f32 from {C} channels, gamma {gamma}"
    _, R = sd.soft_dtw_fwd(D, gamma)
    cells = L * chunk * chunk
    # each input read once, each output written once: D and the R lattice
    # (the backward's input) forward, R and dD backward; f32 operations per
    # cell: the softmin's 3 exps, log, 2 mins and 9 other (forward), the
    # weights' 3 x 6 and the cell's own softmin again (backward)
    row_f = {"name": "soft_dtw", "at": at, "max_abs_err": (val - ref).abs().max().item(),
             "value_rel_err": v_err, "tol": "1e-5 relative",
             "serial_diagonals": 2 * chunk - 1,
             "ms": cuda_ms(lambda: sd.soft_dtw_fwd(D, gamma)),
             "plain_ms": cuda_ms(lambda: sd.soft_dtw_from_dist_plain(D, gamma), max_iters=5),
             "library_ms": None}
    row_b = {"name": "soft_dtw_bwd", "at": at, "max_abs_err": g_err, "tol": g_tol,
             "serial_diagonals": 2 * chunk - 1,
             "ms": cuda_ms(lambda: sd.soft_dtw_bwd(R, up, gamma)),
             "plain_ms": cuda_ms_grad(ref, Dp, up, max_iters=5), "library_ms": None}
    row_f["bound_ms"], row_f["bound_by"] = bound_ms(15 * cells, 2 * cells * 4 + L * 4,
                                                    torch.float32)
    row_b["bound_ms"], row_b["bound_by"] = bound_ms(33 * cells, 2 * cells * 4 + L * 4,
                                                    torch.float32)
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    if not (v_err <= 1e-5 and g_err <= g_tol):
        raise RuntimeError(f"soft_dtw at {at}: value rel err {v_err}, dD err {g_err} > {g_tol}")
    return {"fwd": row_f, "bwd": row_b}


def _regulate_case(dev, g) -> dict:
    """The regulator's expand and segment-sum at the flagship's shape: x
    (8, 256, 256) bf16 -> 2048 frames, ragged durations (a zero-duration
    phone every fifth, one item over T), against the gather."""
    from lightningfastspeech2_tpu_torch.ops import length_regulator as lr

    B, P, H, T, dtype = TRAIN_B, TRAIN_P, 256, TRAIN_T, torch.bfloat16
    x = torch.randn(B, P, H, generator=g).to(dev, dtype)
    d = torch.randint(1, 14, (B, P), generator=g)
    d[:, ::5] = 0
    d[0] = 10                              # 2560 frames: above T
    d = d.to(dev)
    dout = torch.randn(B, T, H, generator=g).to(dev, dtype)
    xk = x.clone().requires_grad_(True)
    frames, mask = lr.regulate_kernel(xk, d, T)
    (grad,) = torch.autograd.grad(frames, xk, dout)
    ref, ref_mask = lr.regulate_plain(x, d, T)
    # the segment-sum adds in f32 and rounds once: against the f32 gather's
    # gradient of the same inputs, rounded once, within one bf16 ulp
    xf = x.float().requires_grad_(True)
    (want,) = torch.autograd.grad(lr.regulate_plain(xf, d, T)[0], xf, dout.float())
    want = want.to(dtype).float()
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
    torch.cuda.synchronize()
    exact = torch.equal(frames, ref) and torch.equal(mask, ref_mask)
    g_err = (grad.float() - want).abs()
    at = f"x ({B}, {P}, {H}) bf16 -> {T} frames, ragged durations"
    ends = torch.cumsum(d.clamp(min=0).to(torch.int32), -1, dtype=torch.int32)
    # the gather as one PyTorch call on the precomputed frame -> phone index
    t = torch.arange(T, device=dev)
    idx = torch.searchsorted(ends.long(), t.expand(B, T).contiguous(), right=True).clamp(max=P - 1)
    idx = idx[:, :, None].expand(-1, -1, H)
    xg = x.clone().requires_grad_(True)
    gathered = torch.gather(xg, 1, idx)
    pp = x.clone().requires_grad_(True)
    plain_out = lr.regulate_plain(pp, d, T)[0]
    row_f = {"name": "regulate", "at": at, "max_abs_err": (frames.float() - ref.float()).abs().max().item(),
             "tol": 0.0, "bit_exact": exact,
             "ms": cuda_ms(lambda: lr.regulate_fwd(x, ends, T)),
             "plain_ms": cuda_ms(lambda: lr.regulate_plain(x, d, T)),
             "library_ms": cuda_ms(lambda: torch.gather(x, 1, idx)),
             "library": "torch.gather on the precomputed frame -> phone index"}
    row_b = {"name": "regulate_bwd", "at": at, "max_abs_err": g_err.max().item(),
             "tol": "one bf16 ulp of the f32 gather's gradient rounded once",
             "ms": cuda_ms(lambda: lr.regulate_bwd(dout, ends)),
             "plain_ms": cuda_ms_grad(plain_out, pp, dout),
             "library_ms": cuda_ms_grad(gathered, xg, dout),
             "library_fwd_bwd_ms": cuda_ms(lambda: torch.autograd.grad(
                 torch.gather(xg, 1, idx), xg, dout)),
             "library": "torch.gather's backward (a scatter-add)"}
    # host-clock µs per call with no synchronise between calls: the event
    # times above follow the host where it takes longer than the device
    row_f["host_us"] = host_us(lambda: lr.regulate_fwd(x, ends, T), 2000)
    row_f["library_host_us"] = host_us(lambda: torch.gather(x, 1, idx), 2000)
    row_b["host_us"] = host_us(lambda: lr.regulate_bwd(dout, ends), 2000)
    nb_x, nb_f = tensor_bytes(x), B * T * H * x.element_size()
    row_f["bound_ms"], row_f["bound_by"] = bound_ms(0, nb_x + nb_f + tensor_bytes(ends), dtype)
    row_b["bound_ms"], row_b["bound_by"] = bound_ms(B * T * H, nb_f + nb_x + tensor_bytes(ends),
                                                    dtype)
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    if not exact or not bool((g_err <= ulp).all()):
        raise RuntimeError(f"regulate at {at}: forward bit-exact {exact}, "
                           f"gradient off by {g_err.max().item()}")
    return {"fwd": row_f, "bwd": row_b}


def sdtw_kernels_phase(dev) -> dict:
    g = torch.Generator().manual_seed(2)
    return {"soft_dtw": _soft_dtw_case(dev, g), "regulate": _regulate_case(dev, g)}


# ------------------------------------------------------- FastDiff slice
FD_BUCKET = 512   # the served batch's frame bucket
FD_CALL_RUNS = 5  # timed vocoder calls: their median and spread


def _lvc_case(dev, g, hop, dtype, fast=False, nL=FD_BUCKET) -> dict:
    """lvc_stack at one upsample stage of a FD_BUCKET-frame bucket, B=1, 4
    layers, C=32, against the plain version; the biases in the working
    dtype, as the kernel predictor gives them."""
    from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc as lvc

    B, C, layers = 1, 32, 4
    L = nL * hop
    x = torch.randn(B, L, C, generator=g).to(dev, dtype)
    ad = torch.randn(B, L, C, generator=g).to(dev, dtype)
    k = (0.2 * torch.randn(B, nL, layers, C, 2 * C, 3, generator=g)).to(dev, dtype)
    b = (0.1 * torch.randn(B, nL, layers, 2 * C, generator=g)).to(dev, dtype)
    cw = (0.1 * torch.randn(layers, 3, C, C, generator=g)).to(dev, dtype)
    cb = (0.1 * torch.randn(layers, C, generator=g)).to(dev)
    args = (x, ad, k, b, cw, cb, hop)
    out = lvc.lvc_stack(*args, fast_gating=fast)
    ref = lvc.lvc_stack_plain(*args, fast_gating=fast)
    torch.cuda.synchronize()
    top = ref.float().abs().max().item()
    err = (out.float() - ref.float()).abs().max().item()
    held = {}
    if dtype == torch.float32:   # summation order only
        tol = 2e-4 * (1.0 + top)
        ok = err <= tol
    else:   # per value, in ulps of the chain's |x| there (lvc.bf16_chain_error)
        ulps, share = lvc.bf16_chain_error(out, ref, x, ad, layers)
        tol = f"{lvc.BF16_MAX_ULPS} ulps a value, {lvc.BF16_MAX_UNEQUAL} of values unequal"
        held = {"max_ulps": ulps, "unequal_share": share}
        ok = ulps <= lvc.BF16_MAX_ULPS and share <= lvc.BF16_MAX_UNEQUAL
    # per row and layer: the dilated conv (3C x C) and the LVC (3C x 2C)
    flops = B * L * layers * 2 * (3 * C * C + 3 * C * 2 * C)
    nbytes = 2 * tensor_bytes(x) + tensor_bytes(ad, k, b, cw, cb)
    row = {"name": "lvc_stack", "stage": {8: 1, 64: 2, 256: 3}.get(hop),
           "at": f"x ({B}, {L}, {C}) {str(dtype)[6:]}, hop {hop}, {nL} frames, {layers} layers, "
                 f"{'Padé' if fast else 'exact'} gate",
           "max_abs_err": err, "tol": tol, **held, "tile_rows": lvc.kernel_tile(B, L),
           "ms": cuda_ms(lambda: lvc.lvc_stack(*args, fast_gating=fast)),
           "plain_ms": cuda_ms(lambda: lvc.lvc_stack_plain(*args, fast_gating=fast)),
           "library_ms": None, "bytes": nbytes, "flops": flops}
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
    emit({"phase": "kernel", **row})
    if not ok:
        raise RuntimeError(f"lvc_stack at {row['at']}: max |err| {err} {held}, tolerance {tol}")
    return row


def fastdiff_kernels_phase(dev) -> list:
    """lvc_stack at stages 2 and 3 in bf16 and f32, the Padé gate at stage
    3, and the stage-1 shape (hop 8, the LFS2_FUSED_STAGE1 opt-in)."""
    g = torch.Generator().manual_seed(3)
    bf, f32 = torch.bfloat16, torch.float32
    return [_lvc_case(dev, g, 64, bf), _lvc_case(dev, g, 256, bf), _lvc_case(dev, g, 64, f32),
            _lvc_case(dev, g, 256, f32), _lvc_case(dev, g, 256, bf, fast=True),
            _lvc_case(dev, g, 8, bf)]


def fastdiff_serving_phase(counters, served) -> dict:
    """This slice's main path: the flagship with its residual head and the
    FastDiff vocoder (reference widths, N from the config), both bf16 from
    seeded generators, phase 5's dvectors and duration bias; then one
    request under LFS2_FUSED_STAGE1 and one profiled vocoder call."""
    from lightningfastspeech2_tpu_torch.core.config import replace
    from lightningfastspeech2_tpu_torch.ops.fastdiff_lvc import lvc_stack, routes_to_kernel

    cfg = served["cfg"]
    cfg = replace(cfg, model=replace(cfg.model, fastdiff_vocoder=True))
    dvecs = served["dvecs"]
    reset_counts(counters)
    t0 = time.perf_counter()
    gen, _ = _make_generator(cfg, torch.bfloat16, None, dvecs, BATCH_TEXTS, served["bias"],
                             fastdiff=True)
    synth = gen.synthesiser
    fd_cfg, N = synth.vocoder.cfg, synth.n_steps
    emit({"phase": "fastdiff_serving_setup", "seconds": time.perf_counter() - t0,
          "fastdiff": {"inner_channels": fd_cfg.inner_channels,
                       "upsample_ratios": list(fd_cfg.upsample_ratios),
                       "lvc_layers": fd_cfg.lvc_layers_each_block,
                       "kpnet_hidden": fd_cfg.kpnet_hidden_channels, "T": fd_cfg.T,
                       "N": N, "dtype": "bfloat16"}})
    run = _serve_all(gen, cfg, dvecs, tag="fastdiff_")
    launches = {c.__name__: c.launches for c in counters}
    # per generate_samples call the acoustic passes' ffn_ln launches, as in
    # phase 5; per vocoder call N ε passes, each one lvc_stack launch per
    # stage the routing rule sends to the kernel at that call's bucket
    hops, hop = [], 1
    for r in fd_cfg.upsample_ratios:
        hop *= r
        hops.append(hop)
    layers = fd_cfg.lvc_layers_each_block
    m = cfg.model
    want = {c.__name__: 0 for c in counters}
    want.update({"ffn_ln": run["n_calls"] * (2 * m.encoder.layers + m.decoder.layers),
                 "lvc_stack": sum(N * sum(routes_to_kernel(h, T, layers) for h in hops)
                                  for T in run["vocoder_buckets"])})
    n_voc = len(run["vocoder_buckets"])
    emit({"phase": "fastdiff_launches", **launches, "expected": want, "vocoder_calls": n_voc,
          "eps_passes": N * n_voc})
    if launches != want or want["lvc_stack"] != 2 * N * n_voc or launches["ffn_ln"] == 0:
        raise RuntimeError(f"FastDiff serving launches {launches}, expected {want} "
                           f"(2 per pass x {N} x {n_voc} calls)")
    # one request with the stage-1 opt-in (outside the counted run above)
    n = lvc_stack.launches
    with env_opt_in("LFS2_FUSED_STAGE1"):
        t = time.perf_counter()
        wav = gen.generate_from_text(SENTENCES[0], speaker="spk0", seed=0)
        opt_ms = (time.perf_counter() - t) * 1e3
    opt_launches = lvc_stack.launches - n
    emit({"phase": "fastdiff_stage1_opt_in", "lvc_stack": opt_launches, "expected": 3 * N,
          "ms": opt_ms, "finite": bool(np.isfinite(wav).all())})
    if opt_launches != 3 * N or not np.isfinite(wav).all():
        raise RuntimeError(f"LFS2_FUSED_STAGE1 request: {opt_launches} lvc_stack launches, "
                           f"expected {3 * N}")
    # vocoder calls on a FD_BUCKET-frame mel, timed FD_CALL_RUNS times, then one under the profiler
    mel = (np.random.default_rng(5).standard_normal((FD_BUCKET, m.audio.n_mels)) - 4.0
           ).astype(np.float32)
    synth(mel)
    torch.cuda.synchronize()
    call_runs = []
    for _ in range(FD_CALL_RUNS):
        t = time.perf_counter()
        synth(mel)
        torch.cuda.synchronize()
        call_runs.append((time.perf_counter() - t) * 1e3)
    call_ms = statistics.median(call_runs)
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        synth(mel)
        torch.cuda.synchronize()
    split = _step_split(prof, "fastdiff_vocoder_profile.txt")
    # the host side of the same call: PyTorch ops by their own CPU time
    from torch.autograd import DeviceType

    host = sorted((e for e in prof.key_averages() if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    (ROOT / "chiprun_out" / "fastdiff_vocoder_host_profile.txt").write_text(
        "\n".join(f"{e.self_cpu_time_total / 1e3:10.3f} ms  x{e.count:<6d} {e.key}"
                  for e in host[:60]))
    hifigan_ms = statistics.median(r["ms"] for r in served["requests"])
    fastdiff_ms = statistics.median(r["ms"] for r in run["requests"])
    emit({"phase": "fastdiff_vocoder_profile", "frames": FD_BUCKET, "N": N,
          "call_ms": call_ms, "call_ms_runs": call_runs, "device_ms": split["device_ms"],
          "device_launches": split["device_launches"],
          "lvc_stack_ms": split["lvc_stack_ms"],
          "rest_device_ms": split["device_ms"] - split["lvc_stack_ms"],
          "request_ms_median": {"fastdiff": fastdiff_ms, "hifigan_v1": hifigan_ms},
          "batch_audio_s_per_s": {"fastdiff": run["batch"]["audio_s_per_s"],
                                  "hifigan_v1": served["batch"]["audio_s_per_s"]}})
    return {"launches": launches, "cfg": cfg, "run": run, "split": split}


def _summary(name, source, replaces, rows, launches) -> dict:
    """One kernels-line entry; several shapes add up to the stage's work."""
    keys = ("ms", "plain_ms", "bound_ms")
    out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
           "launches": launches,
           "max_abs_err": max(r["max_abs_err"] for r in rows),
           **{k: sum(r[k] for r in rows) for k in keys},
           "bound_by": rows[-1]["bound_by"], "library_ms": None,
           "at": "; ".join(r["at"] for r in rows)}
    if len(rows) > 1:
        out["note"] = "ms, plain_ms and bound_ms add up the shapes listed in 'at'"
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a Hopper card",
              file=sys.stderr)
        return 1
    from lightningfastspeech2_tpu_torch.ops.attention import flash_attention, flash_attention_bwd
    from lightningfastspeech2_tpu_torch.ops.fastdiff_lvc import lvc_stack
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln, ffn_ln_train, ffn_ln_train_bwd
    from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import resblock, resblock_trio
    from lightningfastspeech2_tpu_torch.ops.length_regulator import regulate, regulate_bwd
    from lightningfastspeech2_tpu_torch.ops.probe import probe
    from lightningfastspeech2_tpu_torch.ops.soft_dtw import soft_dtw, soft_dtw_bwd

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    info = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    probe_row = probe_phase(dev)
    rows = kernels_phase(dev)
    counters = (probe, ffn_ln, resblock, resblock_trio, ffn_ln_train, ffn_ln_train_bwd,
                flash_attention, flash_attention_bwd, soft_dtw, soft_dtw_bwd, regulate,
                regulate_bwd, lvc_stack)
    for flag in ("LFS2_PALLAS_LR", "LFS2_FUSED_STAGE1"):
        if flag in os.environ:
            raise RuntimeError(f"run without {flag}: the script sets it for its own phases")
    served = serving_phase(counters)
    reference_phase(served)
    train_rows = train_kernels_phase(dev)
    trained = training_phase(counters)
    train_ref = train_reference_phase()
    sdtw_rows = sdtw_kernels_phase(dev)
    with env_opt_in("LFS2_PALLAS_LR"):
        sdtw_trained = training_phase(counters, soft_dtw=True)
        train_reference_phase(soft_dtw=True)
    # the two steps interleaved (l1, soft-DTW, l1, ...) so that a drift of
    # the host's speed during the run falls on both alike
    pairs = []
    for _ in range(STEP_PAIRS):
        l1_ms = trained["one_step"]()
        with env_opt_in("LFS2_PALLAS_LR"):
            pairs.append((l1_ms, sdtw_trained["one_step"]()))
    emit({"phase": "soft_dtw_step_vs_l1_step", "interleaved_pairs": STEP_PAIRS,
          "l1_step_ms": statistics.median(a for a, _ in pairs),
          "soft_dtw_step_ms": statistics.median(b for _, b in pairs),
          "difference_ms_median": statistics.median(b - a for a, b in pairs),
          "pairs_ms": pairs,
          "phase_means_ms": [trained["row"]["timed_step_ms_mean"],
                             sdtw_trained["row"]["timed_step_ms_mean"]],
          "profiled_soft_dtw_kernels_ms": sdtw_trained["split"]["soft_dtw_ms"]
          + sdtw_trained["split"]["soft_dtw_bwd_ms"],
          "profiled_regulate_kernels_ms": sdtw_trained["split"]["regulate_ms"]
          + sdtw_trained["split"]["regulate_bwd_ms"],
          "profiled_device_ms": sdtw_trained["split"]["device_ms"]})
    fd_rows = fastdiff_kernels_phase(dev)
    fd_served = fastdiff_serving_phase(counters, served)
    reference_phase({**served, "fastdiff_cfg": fd_served["cfg"]}, fastdiff=True)

    n = served["launches"]
    nt = trained["row"]["launches"]
    pkg = "lightningfastspeech2_tpu_torch/csrc"
    kernels = [
        {**{k: v for k, v in probe_row.items() if k != "tol"}, "launches": n["probe"]},
        # the served batch's decoder shape; the other shapes are on their
        # own lines above
        _summary("ffn_ln", f"{pkg}/ffn_ln.cu", "lightningfastspeech2_tpu/ops/pallas_ffn.py:77",
                 rows["ffn_ln"][:1], n["ffn_ln"]),
    ]
    # the bf16 route (the serving path's) summed over a 512-frame call's
    # launches, with the same chain through bf16 cuDNN convs and the f32
    # route's times beside
    for name, rep in (("resblock", "pallas_hifigan.py:103"),
                      ("resblock_trio", "pallas_hifigan.py:197")):
        rs = rows[name]
        kernels.append({
            **_summary(name, f"{pkg}/resblock.cu", f"lightningfastspeech2_tpu/ops/{rep}",
                       rs, n[name]),
            "blocks_per_launch": [r["blocks_per_launch"] for r in rs],
            "tile": [r["tile"] for r in rs],
            "cudnn_bf16_chain_ms": sum(r["cudnn_bf16_chain_ms"] for r in rs),
            "f32_route_ms": sum(r["ms"] for r in rows["resblock_f32"] if r["name"] == name)})
    # the training kernels at the first decoder block's shape (held against
    # the plain version there); the per-step sum over all eight FFN blocks
    # rides along
    dec = train_rows["ffn"][4]
    for part, src, rep in (("fwd", "ffn_ln.cu", "pallas_ffn.py:242"),
                           ("bwd", "ffn_ln_train_bwd.cu", "pallas_ffn.py:311")):
        r = dec[part]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": f"{pkg}/{src}",
            "replaces": f"lightningfastspeech2_tpu/ops/{rep}", "launches": nt[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "at": r["at"], "launch_record": r["launch"],
            **({"chain_source": f"{pkg}/ffn_ln.cu"} if part == "bwd" else {}),
            "per_step_ms_all_8_blocks": sum(c[part]["ms"] for c in train_rows["ffn"]),
            "per_step_bound_ms_all_8_blocks": sum(c[part]["bound_ms"] for c in train_rows["ffn"])})
    # flash attention: the bf16 wgmma kernels (the training path's), then the
    # f32 split-TF32 kernels at phase 9's shape with that phase's launches
    for key, launches in (("flash", nt), ("flash_f32", train_ref["flash_routes"])):
        for part, rep in (("fwd", "pallas_attention.py:100"), ("bwd", "pallas_attention.py:128")):
            r = train_rows[key][part]
            counter = "flash_attention" + ("_bwd" if part == "bwd" else "")
            n = (launches[counter] if key == "flash" else launches[counter][r["route"]])
            kernels.append({
                "name": r["name"], "route": "cuda", "source": f"{pkg}/{r['route']}.cu",
                "replaces": f"lightningfastspeech2_tpu/ops/{rep}", "launches": n,
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "at", "build_s")},
                **{k: r[k] for k in ("library_fwd_bwd_ms", "split_bound_ms", "ms_rate0",
                                     "vs_library", "blocks_per_launch") if k in r}})
    ns = sdtw_trained["row"]["launches"]
    for key, src, reps in (("soft_dtw", "soft_dtw.cu", ("pallas_soft_dtw.py:81", "pallas_soft_dtw.py:112")),
                           ("regulate", "length_regulator.cu",
                            ("pallas_length_regulator.py:30", "pallas_length_regulator.py:66"))):
        for part, rep in zip(("fwd", "bwd"), reps):
            r = sdtw_rows[key][part]
            kernels.append({
                "name": r["name"], "route": "cuda", "source": f"{pkg}/{src}",
                "replaces": f"lightningfastspeech2_tpu/ops/{rep}", "launches": ns[r["name"]],
                **{k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms", "at")},
                **{k: r[k] for k in ("serial_diagonals", "library_fwd_bwd_ms") if k in r}})
    # lvc_stack at stage 3 of the served bucket in bf16 (the stage-2 row
    # rides along)
    stage2, stage3 = fd_rows[0], fd_rows[1]
    kernels.append({
        **_summary("lvc_stack", f"{pkg}/lvc_stack.cu",
                   "lightningfastspeech2_tpu/ops/pallas_fastdiff.py:80", [stage3],
                   fd_served["launches"]["lvc_stack"]),
        "stage2": {k: stage2[k] for k in ("at", "ms", "plain_ms", "bound_ms", "bound_by",
                                          "max_abs_err")}})
    emit({"kernels": kernels})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
