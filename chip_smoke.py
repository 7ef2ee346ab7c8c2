#!/usr/bin/env python3
"""Start lightningfastspeech2_tpu_torch on one Hopper card and check it.

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device: the card (name and power limit from nvidia-smi, capability (9, 0)
   asserted). f32 convolutions and products run in full f32: TF32 is off
   for cuDNN and cuBLAS, so f32 comparisons measure the kernels alone.
2. build: nvcc builds every kernel in csrc/ for sm_90a, all in parallel.
3. probe: the launch probe against ``2 * x``.
4. kernels: each kernel against its plain PyTorch version on the card at the
   serving path's shapes, with its time (CUDA events, warmed up, L2 warm),
   the plain version's time, and its bound at the H100's published peaks.
5. serving (the main path): the flagship LightSpeech (bf16) and HiFi-GAN V1
   (bf16) built from seeded generators serve sentences through
   ``SpeechGenerator.generate_from_text`` and one batch of 8 through
   ``generate_samples`` at frame bucket 512. The duration head's bias is
   taken first, on the CPU. Then every launch counter is set to 0, the
   models are built, the requests served, and the counters read: each must
   equal what the path launches, and none may be 0.
6. reference: an f32 request on the card against the same request through
   the plain path on the CPU.

Then a ``kernels`` JSON line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero
before the result is printed. Without a CUDA device, or without the
repository beside this file, it exits non-zero at once.
"""

from __future__ import annotations

import json
import math
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


def bound_ms(flops: float, nbytes: float, dtype: torch.dtype):
    """The least time for the work: bytes over the memory rate or
    operations over the peak rate for the type, whichever is larger."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
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


def halo_share(w, tile: int) -> float:
    """Share of the resblock kernel's conv work spent on halo rows, which
    the neighbouring block computes too: each conv of the chain computes
    the tile plus the reach still needed by the convs after it."""
    extra = total = 0
    for k, reaches in zip(w.kernel_sizes, w.reaches):
        rem = sum(reaches)
        for q in reaches:
            rem -= q
            extra += 2 * rem * k
            total += (tile + 2 * rem) * k
    return extra / total


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


def probe_phase(dev) -> dict:
    from lightningfastspeech2_tpu_torch.ops.probe import probe, probe_plain

    x = torch.randn(8, 128, device=dev)
    err = (probe(x) - probe_plain(x)).abs().max().item()
    torch.cuda.synchronize()
    row = {"name": "probe", "route": "cuda",
           "source": "lightningfastspeech2_tpu_torch/csrc/probe.cu",
           "replaces": "lightningfastspeech2_tpu/ops/kernel_gate.py:79",
           "at": "(8, 128) f32", "max_abs_err": err, "tol": 0.0,
           "ms": cuda_ms(lambda: probe(x)), "plain_ms": cuda_ms(lambda: probe_plain(x)),
           "library_ms": cuda_ms(lambda: torch.mul(x, 2.0))}
    row["bound_ms"], row["bound_by"] = bound_ms(x.numel(), 2 * tensor_bytes(x), torch.float32)
    emit({"phase": "probe", **row})
    if err != 0.0:
        raise RuntimeError(f"probe: max |err| {err}")
    return row


def _ffn_case(dev, B, T, k, dtype, g) -> dict:
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import init_weights
    from lightningfastspeech2_tpu_torch.models.layers import FFTBlock
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
    row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
    emit({"phase": "kernel", "name": "ffn_ln", **row})
    if not err <= tol:
        raise RuntimeError(f"ffn_ln at {row['at']}: max |err| {err} > {tol}")
    return row


def _resblock_cases(dev, t_mel, g) -> list:
    """Stage 0 (three resblock launches) and stages 1-3 (one trio launch
    each) of HiFi-GAN V1 in bf16 for a mel of ``t_mel`` frames."""
    from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as rb
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator, HifiGanConfig

    cfg, dtype = HifiGanConfig(), torch.bfloat16
    gen = Generator(cfg, dtype)
    with torch.no_grad():  # unit-gain convs, so every stage carries signal
        for m in gen.resblocks.modules():
            if isinstance(m, torch.nn.Conv1d):
                m.weight.normal_(0.0, (m.in_channels * m.kernel_size[0]) ** -0.5, generator=g)
                m.bias.normal_(0.0, 0.1, generator=g)
    gen.prepare()
    gen.to(dev)
    rows, L = [], t_mel
    for stage, weights in enumerate(gen.stage_weights):
        L *= cfg.upsample_rates[stage]
        C = cfg.upsample_initial_channel // 2 ** (stage + 1)
        x = torch.randn(1, L, C, generator=g).to(dev, dtype)
        for w in weights:
            trio = w.n_res > 1
            kern, plain = ((rb.resblock_trio, rb.resblock_trio_plain) if trio
                           else (rb.resblock, rb.resblock_plain))
            out, ref = kern(x, w), plain(x, w)
            torch.cuda.synchronize()
            err, tol = max_err_and_tol(out, ref, 1e-4)
            flops = L * sum(2 * k * C * C * 2 * len(ds)
                            for k, ds in zip(w.kernel_sizes, w.dilations))
            nbytes = 2 * tensor_bytes(x) + tensor_bytes(w.taps, w.bias)
            row = {"name": kern.__name__, "stage": stage,
                   "at": f"x (1, {L}, {C}) bf16, k={list(w.kernel_sizes)}, Tmel={t_mel}",
                   "max_abs_err": err, "tol": tol,
                   "ms": cuda_ms(lambda: kern(x, w)), "plain_ms": cuda_ms(lambda: plain(x, w)),
                   "halo_recompute_share": halo_share(w, rb.kernel_tile(C, w.halo, dtype)[0])}
            row["bound_ms"], row["bound_by"] = bound_ms(flops, nbytes, dtype)
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
    return {"ffn_ln": ffn, "resblock": [r for r in rbs if r["name"] == "resblock"],
            "resblock_trio": [r for r in rbs if r["name"] == "resblock_trio"]}


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


def _make_generator(cfg, dtype, dev, dvecs, texts, bias):
    from lightningfastspeech2_tpu_torch.data.vocab import Vocab
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.synthesis.g2p import BUILTIN_LEXICON, EnglishG2P
    from lightningfastspeech2_tpu_torch.synthesis.generator import SpeechGenerator
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig, Synthesiser

    g2p = EnglishG2P(BUILTIN_LEXICON)  # the generate CLI's default lexicon
    vocab = Vocab(p for t in texts for p in g2p(t))
    model = build_fastspeech2(cfg.model, dtype=dtype, device=dev, seed=0)
    synth = Synthesiser(HifiGanConfig(), dtype=dtype, device=dev, seed=1)
    gen = SpeechGenerator(cfg, model, vocab, g2p, synthesiser=synth,
                          speaker2dvector=dvecs)
    if bias is None:
        bias = _calibrate_durations(model, gen, texts)
    else:
        with torch.no_grad():
            model.variance_adaptor.duration_predictor.linear.bias.fill_(bias)
    return gen, bias


def serving_phase(counters) -> dict:
    """The main path: build the flagship and V1 in bf16 on the card, serve
    the sentences one by one and one batch of 8 at frame bucket 512."""
    from lightningfastspeech2_tpu_torch.core.bucketing import pad_to
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
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    gen, _ = _make_generator(cfg, torch.bfloat16, None, dvecs, BATCH_TEXTS, bias)
    emit({"phase": "serving_setup", "seconds": time.perf_counter() - t0,
          "duration_bias": bias,
          "note": "untrained duration head biased so rounded durations average "
                  f"about {FRAMES_PER_PHONE:g} frames per phone (bias taken on "
                  "the CPU before the launch counters were set to 0)"})

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

    emit({"phase": "request", "cold": True, **serve("Warm up the card.", 0)})
    requests = []
    for i, text in enumerate(SENTENCES):
        r = serve(text, i)
        emit({"phase": "request", **r})
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
    emit({"phase": "batch", "batch": len(wavs), "phone_bucket": P, "frame_bucket": bucket,
          "frames": frames, "ms": ms, "audio_s": audio_s, "finite": finite,
          "audio_s_per_s": audio_s / (ms / 1e3)})
    if not finite or bucket != 512:
        raise RuntimeError(f"batch: finite={finite}, frame bucket {bucket} (want 512)")
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    # what the path must launch: the probe once, when the first entry point
    # resolves the card; per generate_samples call (the warm-up, each
    # sentence, the batch) the encoder's blocks in the duration pass and
    # the encoder's and decoder's in the full pass; per vocoder call (one
    # per item) one resblock or trio launch per prepared stack
    m, stacks = cfg.model, gen.synthesiser.model.stage_weights
    n_calls, n_items = len(SENTENCES) + 2, len(SENTENCES) + 1 + len(wavs)
    want = {"probe": 1,
            "ffn_ln": n_calls * (2 * m.encoder.layers + m.decoder.layers),
            "resblock": n_items * sum(len(s) for s in stacks if len(s) > 1),
            "resblock_trio": n_items * sum(1 for s in stacks if len(s) == 1)}
    emit({"phase": "launches", **launches, "expected": want})
    if launches != want or 0 in launches.values():
        raise RuntimeError(f"serving-path launches {launches}, expected {want}")
    return {"launches": launches, "bias": bias, "dvecs": dvecs, "cfg": cfg,
            "requests": requests}


def reference_phase(served) -> None:
    """One f32 request on the card (kernels) against the same request on
    the CPU (plain versions), same seeded weights and duration bias."""
    text = SENTENCES[1]
    wavs = {}
    for dev in ("cuda", "cpu"):
        gen, _ = _make_generator(served["cfg"], torch.float32, dev, served["dvecs"],
                                 BATCH_TEXTS, bias=served["bias"])
        wavs[dev] = gen.generate_from_text(text, speaker="spk1", seed=0)
    a, b = wavs["cuda"], wavs["cpu"]
    top = float(np.abs(b).max())
    err = float(np.abs(a - b).max()) if a.shape == b.shape else float("inf")
    # f32 on both sides, TF32 off: summation order only, through two models
    tol = 1e-3 * top + 1e-7
    emit({"phase": "reference", "samples": [a.size, b.size], "max_abs_err": err,
          "tol": tol, "peak": top})
    if not (a.shape == b.shape and err <= tol and top > 0):
        raise RuntimeError(f"card vs CPU: shapes {a.shape} {b.shape}, max |err| {err} > {tol}")


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
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln
    from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import resblock, resblock_trio
    from lightningfastspeech2_tpu_torch.ops.probe import probe

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    info = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    probe_row = probe_phase(dev)
    rows = kernels_phase(dev)
    counters = (probe, ffn_ln, resblock, resblock_trio)
    served = serving_phase(counters)
    reference_phase(served)

    n = served["launches"]
    pkg = "lightningfastspeech2_tpu_torch/csrc"
    kernels = [
        {**{k: v for k, v in probe_row.items() if k != "tol"}, "launches": n["probe"]},
        # the served batch's decoder shape; the other shapes are on their
        # own lines above
        _summary("ffn_ln", f"{pkg}/ffn_ln.cu", "lightningfastspeech2_tpu/ops/pallas_ffn.py:77",
                 rows["ffn_ln"][:1], n["ffn_ln"]),
        _summary("resblock", f"{pkg}/resblock.cu",
                 "lightningfastspeech2_tpu/ops/pallas_hifigan.py:103",
                 rows["resblock"], n["resblock"]),
        _summary("resblock_trio", f"{pkg}/resblock.cu",
                 "lightningfastspeech2_tpu/ops/pallas_hifigan.py:197",
                 rows["resblock_trio"], n["resblock_trio"]),
    ]
    emit({"kernels": kernels})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
