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
7. train kernels: ``ffn_ln_train`` (forward and backward) at every FFN
   block's shape of the training step, the widest encoder block and the
   first decoder block also held against the plain version's output and
   gradients; ``flash_attention`` (forward and backward) at the decoder's
   shape against the plain version, with ``F.scaled_dot_product_attention``
   (same mask and dropout_p) timed as the library yardstick.
8. training (this slice's main path): the flagship in bf16 with f32
   parameters takes 1 warm-up and 5 timed optimizer steps on B=8, P=256,
   T=2048 teacher-forced batches at the config dropout rates. Every loss
   must be finite, every parameter must get a finite non-zero gradient,
   and the launch counters, set to 0 just before, must equal 8 / 8 / 4 / 4
   per step. One more step runs under torch.profiler for the time split.
9. train reference: one f32 step on the card against the same step on the
   CPU's plain path (flagship widths, B=2, T=1024, dropout rates 0,
   warm-up 1 so the first update is visible).

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
    want = {c.__name__: 0 for c in counters}   # the training kernels: none here
    want.update({"probe": 1,
                 "ffn_ln": n_calls * (2 * m.encoder.layers + m.decoder.layers),
                 "resblock": n_items * sum(len(s) for s in stacks if len(s) > 1),
                 "resblock_trio": n_items * sum(1 for s in stacks if len(s) == 1)})
    emit({"phase": "launches", **launches, "expected": want})
    path = ("probe", "ffn_ln", "resblock", "resblock_trio")
    if launches != want or any(launches[k] == 0 for k in path):
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


# ---------------------------------------------------------- training slice
TRAIN_B, TRAIN_P, TRAIN_T = 8, 256, 2048   # bench.py's training workload


def train_config(rates: bool = True, B_P_T=(TRAIN_B, TRAIN_P, TRAIN_T)):
    """The flagship cut to one frame bucket (max_phones P, max_frames T), its
    config dropout rates or (``rates=False``) every rate 0."""
    from lightningfastspeech2_tpu_torch.core.config import lightspeech_flagship, replace

    _, P, T = B_P_T
    cfg = lightspeech_flagship()
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


def _ffn_train_case(dev, B, T, k, g, plain: bool) -> dict:
    """ffn_ln_train forward and backward kernels at one of the step's FFN
    shapes (bf16, F 1024, rate 0.1) against the plain version's autograd."""
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
    row_f = {"name": "ffn_ln_train", "at": at,
             "ms": cuda_ms(lambda: ffn.ffn_ln_train_fwd(z, p, seed, rate))}
    row_b = {"name": "ffn_ln_train_bwd", "at": at,
             "ms": cuda_ms(lambda: ffn.ffn_ln_train_bwd(dout, z, p, seed, rate))}
    wbytes = sum(tensor_bytes(t) for t in p)
    row_f["bound_ms"], row_f["bound_by"] = bound_ms(
        B * T * (2 * k * C + 4 * C * F), 2 * tensor_bytes(z) + wbytes, dtype)
    # the backward recomputes up and ff (4CF) and forms dup, dacc, dW1, dW2f (8CF)
    row_b["bound_ms"], row_b["bound_by"] = bound_ms(
        B * T * (6 * k * C + 12 * C * F), 3 * tensor_bytes(z) + 2 * wbytes, dtype)
    if plain:
        zk = z.clone().requires_grad_(True)
        out = ffn.ffn_ln_train(zk, p, seed, rate)
        grads = torch.autograd.grad(out, [zk, *p], dout)
        zp = z.clone().requires_grad_(True)
        ref = ffn.ffn_ln_train_plain(zp, p, seed, rate)
        ref_grads = torch.autograd.grad(ref, [zp, *p], dout, retain_graph=True)
        torch.cuda.synchronize()
        err, tol = max_err_and_tol(out, ref, 2e-4)
        row_f.update(max_abs_err=err, tol=tol,
                     plain_ms=cuda_ms(lambda: ffn.ffn_ln_train_plain(z, p, seed, rate)))
        # gradients against the plain version's autograd: the kernel rounds
        # dff and dup to bf16 before its products, the plain version keeps
        # them f32; each within 3 % of its largest element
        errs = {}
        for name, a, b in zip(("dz", "dwd", "dbd", "dw1", "db1", "dw2f", "db2f",
                               "dg1", "dbe1", "dg2", "dbe2"), grads, ref_grads):
            errs[name] = ((a.float() - b.float()).abs().max().item(),
                          0.03 * b.float().abs().max().item())
        row_b.update(max_abs_err=max(e for e, _ in errs.values()),
                     grad_errs=errs, tol="3 % of each gradient's largest element",
                     plain_ms=cuda_ms_grad(ref, [zp, *p], dout))
        for r in (row_f, row_b):
            emit({"phase": "kernel", **r})
        if not err <= tol:
            raise RuntimeError(f"ffn_ln_train at {at}: max |err| {err} > {tol}")
        bad = {n: e for n, e in errs.items() if not e[0] <= e[1]}
        if bad:
            raise RuntimeError(f"ffn_ln_train_bwd at {at}: gradients off {bad}")
    else:
        for r in (row_f, row_b):
            emit({"phase": "kernel_time", **r})
    return {"fwd": row_f, "bwd": row_b}


def _flash_case(dev, g) -> dict:
    """flash_attention forward and backward at the decoder's shape (bf16,
    rate 0.1) against the plain version, with SDPA as the library yardstick."""
    import torch.nn.functional as F
    from lightningfastspeech2_tpu_torch.ops import attention as att

    B, H, T, d, rate, dtype = TRAIN_B, 2, TRAIN_T, 128, 0.1, torch.bfloat16
    q, k, v, do = (torch.randn(B, H, T, d, generator=g).to(dev, dtype) for _ in range(4))
    lengths = torch.tensor([T - 97 * i for i in range(B)], device=dev)
    mask = torch.arange(T, device=dev)[None, :] < lengths[:, None]
    mask_i32 = mask.to(torch.int32)
    seed = torch.tensor([99], dtype=torch.int32, device=dev)
    at = f"q/k/v ({B}, {H}, {T}, {d}) bf16, ragged key mask, rate={rate}"
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = att.flash_attention(*qkv, mask, rate, seed)
    grads = torch.autograd.grad(out, qkv, do)
    pq = [t.clone().requires_grad_(True) for t in (q, k, v)]
    ref = att.flash_attention_plain(*pq, mask, rate, seed)
    ref_grads = torch.autograd.grad(ref, pq, do, retain_graph=True)
    torch.cuda.synchronize()
    # bf16 in and out; the kernel rounds p against the running max, the
    # plain version the normalised p: 2 % of the largest element
    errs = {n: ((a.float() - b.float()).abs().max().item(), 0.02 * b.float().abs().max().item())
            for n, a, b in zip(("o", "dq", "dk", "dv"), (out, *grads), (ref, *ref_grads))}
    o, lse = att.flash_attention_fwd(q, k, v, mask_i32, seed, rate)
    row_f = {"name": "flash_attention", "at": at, "max_abs_err": errs["o"][0], "tol": errs["o"][1],
             "ms": cuda_ms(lambda: att.flash_attention_fwd(q, k, v, mask_i32, seed, rate)),
             "plain_ms": cuda_ms(lambda: att.flash_attention_plain(q, k, v, mask, rate, seed))}
    row_b = {"name": "flash_attention_bwd", "at": at,
             "max_abs_err": max(errs[n][0] for n in ("dq", "dk", "dv")), "grad_errs": errs,
             "tol": "2 % of each gradient's largest element",
             "ms": cuda_ms(lambda: att.flash_attention_bwd(do, q, k, v, mask_i32, seed, o, lse, rate)),
             "plain_ms": cuda_ms_grad(ref, pq, do)}
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
    nb = tensor_bytes(q, k, v)
    row_f["bound_ms"], row_f["bound_by"] = bound_ms(4 * B * H * T * T * d,
                                                    nb + tensor_bytes(out), dtype)
    # recompute S, then dP, dV, dQ, dK: five T x T x d products
    row_b["bound_ms"], row_b["bound_by"] = bound_ms(10 * B * H * T * T * d,
                                                    2 * nb + 2 * tensor_bytes(out), dtype)
    for r in (row_f, row_b):
        emit({"phase": "kernel", **r})
    bad = {n: e for n, e in errs.items() if not e[0] <= e[1]}
    if bad:
        raise RuntimeError(f"flash_attention at {at}: off {bad}")
    return {"fwd": row_f, "bwd": row_b}


def train_kernels_phase(dev) -> dict:
    """The training kernels at the step's shapes: every FFN block of the
    flagship (encoder at P = 256, decoder at T = 2048) timed, the widest
    encoder and the first decoder kernel also held against the plain
    version; flash attention at the decoder's shape."""
    g = torch.Generator().manual_seed(1)
    enc_k, dec_k = (5, 25, 13, 9), (17, 21, 9, 13)
    ffn = ([_ffn_train_case(dev, TRAIN_B, TRAIN_P, k, g, plain=(k == 25)) for k in enc_k]
           + [_ffn_train_case(dev, TRAIN_B, TRAIN_T, k, g, plain=(k == 17)) for k in dec_k])
    return {"ffn": ffn, "flash": _flash_case(dev, g)}


def _step_split(prof) -> dict:
    """Device time of one traced train step by kernel family (torch.profiler
    key_averages); zeros when the profiler saw no device time."""
    fam = {"ffn_ln_train": "ffn_ln_kernel", "ffn_ln_train_bwd": "ffn_bwd_kernel",
           "flash_attention": "fwd_kernel", "flash_attention_bwd": ("dq_kernel", "dkv_kernel")}
    out = {k: 0.0 for k in fam}
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
            if any(x in e.key for x in pats):
                out[k] += t
    rows.sort(key=lambda r: -r[1])
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "train_profile.txt").write_text(
        "\n".join(f"{t / 1e3:10.3f} ms  x{c:<5d} {k}" for k, t, c in rows))
    return {"device_ms": total / 1e3, **{f"{k}_ms": v / 1e3 for k, v in out.items()}}


def training_phase(counters) -> dict:
    """This slice's main path: the flagship in bf16 (f32 parameters) takes
    1 warm-up and 5 timed optimizer steps on B=8, P=256, T=2048
    teacher-forced batches, config dropout rates."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    cfg = train_config()
    batch = train_batch(cfg)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    model = build_fastspeech2(cfg.model, dtype=torch.bfloat16, seed=0)
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg)
    gen = torch.Generator(device=model.device).manual_seed(5)
    setup_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    steps, metrics = [], []
    for i in range(6):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = step(state, batch, gen)
        torch.cuda.synchronize()
        steps.append((time.perf_counter() - t) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
    torch.cuda.synchronize()
    launches = {c.__name__: c.launches for c in counters}
    # every parameter's gradient of the last step: finite and not all zero
    # (a kernel detached from autograd would leave zeros)
    bad = [n for n, p in model.named_parameters()
           if p.grad is None or not torch.isfinite(p.grad).all() or not p.grad.any()]
    finite = all(math.isfinite(v) for m in metrics for v in m.values())
    n_steps = len(steps)
    L_enc, L_dec = cfg.model.encoder.layers, cfg.model.decoder.layers
    want = {c.__name__: 0 for c in counters}
    want.update(ffn_ln_train=n_steps * (L_enc + L_dec), ffn_ln_train_bwd=n_steps * (L_enc + L_dec),
                flash_attention=n_steps * L_dec, flash_attention_bwd=n_steps * L_dec)
    timed = steps[1:]
    row = {"phase": "training", "setup_s": setup_s, "steps": n_steps, "step_ms": steps,
           "timed_step_ms_mean": sum(timed) / len(timed),
           "frames_per_s": TRAIN_B * TRAIN_T / (sum(timed) / len(timed) / 1e3),
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "first_losses": metrics[0], "last_losses": metrics[-1], "finite": finite,
           "params_without_grad": bad, "launches": launches, "expected": want}
    emit(row)
    if not finite or bad:
        raise RuntimeError(f"training: finite={finite}, params without gradient {bad[:8]}")
    if launches != want:
        raise RuntimeError(f"training-path launches {launches}, expected {want}")
    # one more step under the profiler (outside the counted run): where the
    # step's device time goes
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = step(state, batch, gen)
        torch.cuda.synchronize()
    split = _step_split(prof)
    emit({"phase": "train_profile", **split})
    return {"row": row, "split": split}


def train_reference_phase() -> dict:
    """One f32 optimizer step on the card (kernels) against the same step on
    the CPU (plain versions): flagship widths, B=2, T=1024 so the flash gate
    admits the decoder, every dropout rate 0 (the generators differ)."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
    from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step

    from lightningfastspeech2_tpu_torch.core.config import replace

    shape = (2, 128, 1024)
    cfg = train_config(rates=False, B_P_T=shape)
    # lr 1e-4 at the first update (the flagship's 4000-step warm-up would
    # make it 2.5e-8, below the f32 resolution of the parameters)
    cfg = replace(cfg, train=replace(cfg.train, warmup_steps=1))
    batch = train_batch(cfg, shape)
    res = {}
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
    row = {"phase": "train_reference", "at": "flagship f32, B=2, P=128, T=1024, rates 0",
           "loss_rel_err": loss_err, "grad_max_abs_err": grad_err, "grad_max": gmax,
           "update_max_abs_err": upd_err, "update_max": lr, "tol": tol,
           "losses_cuda": a["losses"], "losses_cpu": b["losses"]}
    emit(row)
    if not (loss_err <= tol["loss_rel"] and grad_err <= tol["grad_abs"]
            and upd_err <= tol["update_abs"]):
        raise RuntimeError(f"train step card vs CPU: {row}")
    return row


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
    from lightningfastspeech2_tpu_torch.ops.ffn import ffn_ln, ffn_ln_train, ffn_ln_train_bwd
    from lightningfastspeech2_tpu_torch.ops.hifigan_resblock import resblock, resblock_trio
    from lightningfastspeech2_tpu_torch.ops.probe import probe

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    info = device_phase()
    dev = torch.device("cuda", 0)
    build_phase()
    probe_row = probe_phase(dev)
    rows = kernels_phase(dev)
    counters = (probe, ffn_ln, resblock, resblock_trio, ffn_ln_train, ffn_ln_train_bwd,
                flash_attention, flash_attention_bwd)
    served = serving_phase(counters)
    reference_phase(served)
    train_rows = train_kernels_phase(dev)
    trained = training_phase(counters)
    train_reference_phase()

    n = served["launches"]
    nt = trained["row"]["launches"]
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
            "at": r["at"], "per_step_ms_all_8_blocks": sum(c[part]["ms"] for c in train_rows["ffn"]),
            "per_step_bound_ms_all_8_blocks": sum(c[part]["bound_ms"] for c in train_rows["ffn"])})
    for part, rep in (("fwd", "pallas_attention.py:100"), ("bwd", "pallas_attention.py:128")):
        r = train_rows["flash"][part]
        kernels.append({
            "name": r["name"], "route": "cuda", "source": f"{pkg}/flash_attention.cu",
            "replaces": f"lightningfastspeech2_tpu/ops/{rep}", "launches": nt[r["name"]],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "at": r["at"], **({"library_fwd_bwd_ms": r["library_fwd_bwd_ms"]} if part == "bwd" else {})})
    emit({"kernels": kernels})
    print(info["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
