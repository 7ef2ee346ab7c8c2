"""The port's own copy of ``lightningfastspeech2_tpu/data/synthetic.py``.

Synthetic aligned corpus generator for tests and smoke training.

Produces LibriTTS-layout ``speaker/utt.wav`` + ``utt.TextGrid`` pairs whose
phones are vowel-like harmonic tones with distinct F0/formants, so duration,
pitch and energy are all learnable signals. The TextGrid alignment semantics
match what the reference's converter expects
(reference ``litfass/dataset/audio_utils.py:36-91``).
"""

from __future__ import annotations

from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.data.textgrid import Interval, TextGrid, Tier, dump

PHONE_BANK = {
    "AA1": (120.0, (700, 1200)),
    "IY0": (180.0, (300, 2300)),
    "UW1": (140.0, (350, 800)),
    "EH0": (200.0, (550, 1800)),
    "N": (110.0, (250, 1200)),
    "S": (0.0, (5000, 7000)),  # unvoiced noise
}


def synth_phone(label: str, dur_s: float, sr: int, rng: np.random.Generator):
    f0, formants = PHONE_BANK[label]
    n = int(dur_s * sr)
    t = np.arange(n) / sr
    if f0 > 0:
        sig = np.zeros(n)
        for k in range(1, 9):
            amp = sum(np.exp(-(((k * f0) - f) / 400.0) ** 2) for f in formants) + 0.1 / k
            sig += amp * np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi))
    else:
        sig = rng.standard_normal(n) * 0.3
    # fade edges to avoid clicks
    fade = min(n // 8, 256)
    env = np.ones(n)
    env[:fade] = np.linspace(0, 1, fade)
    env[-fade:] = np.linspace(1, 0, fade)
    return (sig * env).astype(np.float32)


# ---------------------------------------------------------------------------
# Rich corpus: multi-speaker, prosodically structured (convergence campaigns)
# ---------------------------------------------------------------------------

# (class, intrinsic_dur_s, intrinsic_gain, formants) — formants are speaker-
# scaled; vowels/nasals are harmonic, fricatives are shaped noise, stops are
# closure+burst. Labels are plain ARPABET so the vocab path (vocab.py) treats
# them exactly like MFA TextGrid output.
RICH_PHONE_BANK = {
    # vowels: (F1, F2) from the standard vowel space
    "AA1": ("vowel", 0.14, 1.00, (730, 1090)),
    "AE1": ("vowel", 0.13, 1.00, (660, 1720)),
    "AH0": ("vowel", 0.08, 0.85, (640, 1190)),
    "AO1": ("vowel", 0.14, 1.00, (570, 840)),
    "EH0": ("vowel", 0.10, 0.90, (530, 1840)),
    "ER0": ("vowel", 0.11, 0.90, (490, 1350)),
    "IH1": ("vowel", 0.10, 0.95, (390, 1990)),
    "IY0": ("vowel", 0.11, 0.95, (270, 2290)),
    "OW1": ("vowel", 0.14, 1.00, (490, 910)),
    "UW1": ("vowel", 0.12, 0.95, (300, 870)),
    # nasals: low F1, strong damping
    "M": ("nasal", 0.07, 0.55, (250, 1000)),
    "N": ("nasal", 0.07, 0.55, (250, 1400)),
    "NG": ("nasal", 0.08, 0.55, (250, 1100)),
    # liquids/glides: voiced, mid formants
    "L": ("vowel", 0.07, 0.70, (360, 1300)),
    "R": ("vowel", 0.07, 0.70, (420, 1300)),
    "W": ("vowel", 0.06, 0.65, (300, 700)),
    "Y": ("vowel", 0.06, 0.65, (280, 2200)),
    # fricatives: noise band (lo, hi)
    "S": ("fric", 0.10, 0.45, (4500, 8500)),
    "SH": ("fric", 0.10, 0.50, (2200, 6500)),
    "F": ("fric", 0.08, 0.35, (1500, 8000)),
    "Z": ("vfric", 0.08, 0.50, (4000, 8000)),
    "V": ("vfric", 0.06, 0.40, (1000, 5000)),
    "HH": ("fric", 0.05, 0.30, (500, 4000)),
    # stops: closure + burst centred at (lo, hi)
    "T": ("stop", 0.07, 0.60, (3000, 7000)),
    "K": ("stop", 0.08, 0.60, (1500, 4000)),
    "P": ("stop", 0.07, 0.55, (500, 2000)),
    "D": ("vstop", 0.06, 0.60, (2500, 6000)),
    "G": ("vstop", 0.07, 0.60, (1200, 3500)),
    "B": ("vstop", 0.06, 0.55, (400, 1800)),
}

_VOWELS = [p for p, v in RICH_PHONE_BANK.items() if v[0] == "vowel"][:10]
_CONS = [p for p, v in RICH_PHONE_BANK.items() if v[0] != "vowel"]


def _bandnoise(n: int, lo: float, hi: float, sr: int, rng) -> np.ndarray:
    """White noise shaped to a [lo, hi] band via rfft masking."""
    x = rng.standard_normal(n).astype(np.float32)
    X = np.fft.rfft(x)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    mask = ((f >= lo) & (f <= hi)).astype(np.float32)
    # soft edges to avoid ringing
    edge = np.exp(-(((f - np.clip(f, lo, hi)) / 300.0) ** 2))
    return np.fft.irfft(X * np.maximum(mask, 0.1 * edge), n=n).astype(np.float32)


def synth_rich_phone(
    label: str,
    dur_s: float,
    sr: int,
    rng: np.random.Generator,
    f0_start: float,
    f0_end: float,
    formant_scale: float,
    gain: float,
    breath: float,
) -> np.ndarray:
    """One phone with a linear F0 glide and speaker-scaled formants."""
    kind, _, intrinsic_gain, band = RICH_PHONE_BANK[label]
    n = max(int(dur_s * sr), 32)
    t = np.arange(n) / sr
    if kind in ("vowel", "nasal"):
        # harmonic source with linear f0 glide; formant-gain shaping
        f0 = np.linspace(f0_start, f0_end, n)
        phase = 2 * np.pi * np.cumsum(f0) / sr
        formants = [f * formant_scale for f in band]
        bw = 180.0 if kind == "vowel" else 90.0
        sig = np.zeros(n, np.float32)
        for k in range(1, 13):
            fk = k * (f0_start + f0_end) / 2
            if fk > sr / 2 - 200:
                break
            amp = sum(np.exp(-(((fk) - f) / (bw * 2.5)) ** 2) for f in formants)
            amp += 0.25 / k  # source roll-off floor
            sig += amp * np.sin(k * phase + rng.uniform(0, 2 * np.pi))
        sig += breath * 0.15 * _bandnoise(n, 1500, 6000, sr, rng)
    elif kind in ("fric", "vfric"):
        sig = _bandnoise(n, band[0], band[1], sr, rng)
        if kind == "vfric":  # voiced bar under the frication
            f0 = np.linspace(f0_start, f0_end, n)
            phase = 2 * np.pi * np.cumsum(f0) / sr
            sig = 0.7 * sig + 0.5 * np.sin(phase)
    else:  # stop / vstop: closure then a short burst
        n_clo = int(n * 0.6)
        burst = _bandnoise(n - n_clo, band[0], band[1], sr, rng)
        burst *= np.exp(-np.arange(n - n_clo) / (0.012 * sr))
        sig = np.concatenate([np.zeros(n_clo, np.float32), burst])
        if kind == "vstop":
            f0 = np.linspace(f0_start, f0_end, n)
            phase = 2 * np.pi * np.cumsum(f0) / sr
            sig += 0.25 * np.sin(phase) * (np.arange(n) < n_clo)
    rms = np.sqrt(np.mean(sig**2)) + 1e-9
    sig = sig / rms * intrinsic_gain * gain
    fade = min(n // 6, 160)
    if fade > 1:
        sig[:fade] *= np.linspace(0, 1, fade)
        sig[-fade:] *= np.linspace(1, 0, fade)
    return sig.astype(np.float32)


def make_rich_corpus(
    root: Path,
    n_speakers: int = 20,
    n_utts: int = 40,
    sr: int = 22050,
    seed: int = 0,
    min_words: int = 2,
    max_words: int = 7,
) -> Path:
    """Multi-speaker corpus with learnable prosodic structure.

    Speaker identity: base F0 (log-uniform 85–240 Hz), formant scale
    correlated with F0, speaking-rate multiplier, breathiness, loudness.
    Prosody: utterance-level F0 declination, phrase-final lengthening,
    one random focus word (F0 + energy bump), inter-word pauses.  Word
    structure: CV(C) syllables so the words tier is meaningful.  The
    result gives the duration/pitch/energy predictors and the speaker
    paths (d-vectors, GMMs, priors) real structure to learn — the
    richest corpus constructible offline (no real speech ships in this
    environment; reference trains on LibriTTS, README.md:10).
    """
    root = Path(root)
    master = np.random.default_rng(seed)
    for spk in range(n_speakers):
        srng = np.random.default_rng(master.integers(2**31))
        base_f0 = float(np.exp(srng.uniform(np.log(85.0), np.log(240.0))))
        # higher-pitched speakers have shorter vocal tracts
        formant_scale = float(
            np.clip(0.85 + 0.35 * (base_f0 - 85) / 155 + srng.normal(0, 0.04),
                    0.8, 1.3))
        rate = float(srng.uniform(0.85, 1.25))
        breath = float(srng.uniform(0.0, 0.8))
        loud = float(srng.uniform(0.7, 1.0))
        spk_dir = root / f"spk{spk:03d}"
        spk_dir.mkdir(parents=True, exist_ok=True)
        for u in range(n_utts):
            rng = np.random.default_rng(srng.integers(2**31))
            n_words = int(rng.integers(min_words, max_words + 1))
            focus = int(rng.integers(n_words))
            sil = float(rng.uniform(0.06, 0.15))
            wav_parts = [np.zeros(int(sil * sr), np.float32)]
            ph_intervals = [Interval(0.0, sil, "sil")]
            word_intervals = []
            t = sil
            # declination: F0 multiplier falls linearly across the utterance
            for w in range(n_words):
                # CV / CVC / CCV syllable, 1-2 syllables per word
                word_phones: List[str] = []
                for _ in range(int(rng.integers(1, 3))):
                    if rng.random() < 0.85:
                        word_phones.append(_CONS[int(rng.integers(len(_CONS)))])
                    word_phones.append(_VOWELS[int(rng.integers(len(_VOWELS)))])
                    if rng.random() < 0.35:
                        word_phones.append(_CONS[int(rng.integers(len(_CONS)))])
                w_start = t
                final_stretch = 1.35 if w == n_words - 1 else 1.0
                focus_gain = 1.25 if w == focus else 1.0
                for p in word_phones:
                    intrinsic = RICH_PHONE_BANK[p][1]
                    dur = intrinsic * rate * final_stretch * float(
                        rng.uniform(0.75, 1.35))
                    dur = max(dur, 0.03)
                    pos0 = t / 4.0  # ~position in a nominal 4 s utterance
                    decl0 = 1.12 - 0.3 * min(pos0, 1.0)
                    decl1 = 1.12 - 0.3 * min((t + dur) / 4.0, 1.0)
                    jitter = float(rng.uniform(0.97, 1.03))
                    seg = synth_rich_phone(
                        p, dur, sr, rng,
                        f0_start=base_f0 * decl0 * focus_gain * jitter,
                        f0_end=base_f0 * decl1 * focus_gain * jitter,
                        formant_scale=formant_scale,
                        gain=loud * focus_gain,
                        breath=breath,
                    )
                    wav_parts.append(seg)
                    real_dur = len(seg) / sr
                    ph_intervals.append(Interval(t, t + real_dur, p))
                    t += real_dur
                word_intervals.append(Interval(w_start, t, f"w{w}"))
                if w != n_words - 1 and rng.random() < 0.3:
                    pause = float(rng.uniform(0.05, 0.12))
                    wav_parts.append(np.zeros(int(pause * sr), np.float32))
                    ph_intervals.append(Interval(t, t + pause, "sp"))
                    t += pause
            end_sil = float(rng.uniform(0.06, 0.15))
            wav_parts.append(np.zeros(int(end_sil * sr), np.float32))
            ph_intervals.append(Interval(t, t + end_sil, ""))
            wav = np.concatenate(wav_parts)
            wav = 0.7 * wav / max(np.abs(wav).max(), 1e-9)
            tg = TextGrid(
                0.0, t + end_sil,
                (Tier("words", tuple(word_intervals)),
                 Tier("phones", tuple(ph_intervals))),
            )
            utt = f"spk{spk:03d}_utt{u:03d}"
            wav_io.write(spk_dir / f"{utt}.wav", wav, sr)
            (spk_dir / f"{utt}.TextGrid").write_text(dump(tg))
    return root


def make_corpus(
    root: Path,
    n_speakers: int = 2,
    n_utts: int = 4,
    sr: int = 22050,
    seed: int = 0,
    min_phones: int = 4,
    max_phones: int = 8,
) -> Path:
    root = Path(root)
    rng = np.random.default_rng(seed)
    labels = list(PHONE_BANK)
    for spk in range(n_speakers):
        spk_dir = root / f"spk{spk}"
        spk_dir.mkdir(parents=True, exist_ok=True)
        for u in range(n_utts):
            n_ph = int(rng.integers(min_phones, max_phones + 1))
            phones = [labels[int(rng.integers(len(labels)))] for _ in range(n_ph)]
            durs = rng.uniform(0.08, 0.25, n_ph)
            # leading/trailing silence the ingester must trim
            sil = 0.1
            wav_parts = [np.zeros(int(sil * sr), np.float32)]
            intervals = [Interval(0.0, sil, "sil")]
            t = sil
            for p, d in zip(phones, durs):
                wav_parts.append(synth_phone(p, d, sr, rng))
                intervals.append(Interval(t, t + d, p))
                t += d
            wav_parts.append(np.zeros(int(sil * sr), np.float32))
            intervals.append(Interval(t, t + sil, ""))
            wav = np.concatenate(wav_parts)
            wav = 0.7 * wav / max(np.abs(wav).max(), 1e-9)

            tg = TextGrid(
                0.0,
                t + sil,
                (
                    Tier("words", (Interval(0.0, t + sil, "synthetic"),)),
                    Tier("phones", tuple(intervals)),
                ),
            )
            utt = f"spk{spk}_utt{u}"
            wav_io.write(spk_dir / f"{utt}.wav", wav, sr)
            (spk_dir / f"{utt}.TextGrid").write_text(dump(tg))
    return root
