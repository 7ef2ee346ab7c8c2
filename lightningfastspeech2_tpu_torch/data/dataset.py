"""Online-prosody TTS dataset over forced-aligned corpora.

Counterpart of ``lightningfastspeech2_tpu/data/dataset.py`` (a re-design of
the reference's ``TTSDataset``, ``litfass/dataset/datasets.py:47-1041``):
the dataset is independent of the model, and batches are collated to
static bucket shapes.

Per-utterance pipeline (mirrors ``__getitem__``, ``datasets.py:355-474``):
 wav -> resample -> [start:end] slice -> peak normalize
     -> log-mel (T, 80)                        audio/mel.py
     -> durations (+ augmentation)             data/alignment.py
     -> silence masks (expanded + phone level)
     -> variances: pitch (NaN at silence, interpolated), energy,
        WADA SNR, SRMR                         audio/{pitch,features,snr,srmr}.py
     -> phone-level averaging / cwt / log / z-norm transforms
     -> utterance priors over non-silent frames

Feature extraction runs in PyTorch on the dataset's ``device`` (``cuda``
unless the caller passes ``"cpu"``), on the wav padded to a bucket of
``hop * 256`` samples as in the JAX package; the features come back to the
host as numpy, and everything after them is numpy, as there. The dataset
holds its device as a string and no tensor, so it pickles into spawn
workers; the filterbank, the window and the g-table are built on first use
in each process.

The feature cache (``cache_dir``) and the stats JSON share the JAX
package's names and keys: a cache the JAX trainer wrote serves here.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
import multiprocessing as mp
import os
import pickle
from concurrent.futures import ProcessPoolExecutor
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.audio import cwt as cwt_mod
from lightningfastspeech2_tpu_torch.audio import features, mel as mel_mod, pitch as pitch_mod
from lightningfastspeech2_tpu_torch.audio import snr as snr_mod
from lightningfastspeech2_tpu_torch.audio import srmr as srmr_mod
from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer, pad_batch, round_up
from lightningfastspeech2_tpu_torch.core.config import AudioConfig
from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.data.alignment import tier_to_alignment
from lightningfastspeech2_tpu_torch.data.textgrid import load as load_textgrid
from lightningfastspeech2_tpu_torch.data.vocab import Vocab, normalize_phone

@dataclass(frozen=True)
class DataConfig:
    """Dataset knobs (reference ``datasets.py:48-128`` defaults); the JAX
    package's fields, names and defaults (``cache_key`` hashes them)."""

    audio: AudioConfig = field(default_factory=AudioConfig)
    min_length: float = 0.5   # seconds (datasets.py:83)
    max_length: float = 32.0  # seconds (datasets.py:84)
    variances: Tuple[str, ...] = ("pitch", "energy", "snr")
    variance_levels: Tuple[str, ...] = ("frame", "frame", "frame")
    variance_transforms: Tuple[str, ...] = ("none", "none", "none")
    priors: Tuple[str, ...] = ()
    augment_duration: float = 0.1
    speaker_type: str = "dvector"
    min_samples_per_speaker: int = 0
    stat_entries: int = 10_000
    stat_batch: int = 4
    seed: int = 42
    source_phoneset: str = "arpabet"
    load_wav: bool = False
    # raw mode: skip all feature extraction; items carry only
    # phones/durations/wav/silence masks (the JAX train step computes the
    # features on the device)
    raw_mode: bool = False
    max_phones: int = 512
    max_frames: int = 2816
    # process-parallel corpus scan and stats (reference
    # process_map(_create_entry), datasets.py:133-140); 0 = serial
    scan_workers: int = 0
    # collated-mel dtype: "bfloat16" halves the dominant batch payload; the
    # mel then comes as a CPU torch.bfloat16 tensor (numpy has no bf16)
    mel_dtype: str = "float32"
    # waveform dtype when load_wav/raw_mode ships audio: "int16" quarters
    # the payload against float32
    wav_dtype: str = "float32"


@dataclass
class Entry:
    utt_id: str
    audio_path: Path
    phones: List[str]
    durations: np.ndarray
    start: float
    end: float
    speaker: str
    text: str = ""


def _scan_one(tg_path: Path, cfg: DataConfig, root: Path) -> Optional[Entry]:
    """Parse one TextGrid into an Entry, or None if filtered/unusable
    (reference ``_create_entry``, datasets.py:692-742)."""
    sr, hop = cfg.audio.sampling_rate, cfg.audio.hop_length
    wav_path = tg_path.with_suffix(".wav")
    if not wav_path.exists():
        return None
    try:
        tg = load_textgrid(tg_path)
        tier = tg.tier("phones")
    except (ValueError, KeyError):
        return None
    phones, durations, start, end = tier_to_alignment(tier, sr, hop)
    if not phones:
        return None
    length = end - start
    if length < cfg.min_length or length > cfg.max_length:
        return None
    phones = [normalize_phone(p, cfg.source_phoneset) for p in phones]
    if len(phones) > cfg.max_phones:
        return None
    rel = tg_path.relative_to(root)
    speaker = rel.parts[0] if len(rel.parts) > 1 else "speaker0"
    text = ""
    try:
        words = tg.tier("words")
        text = " ".join(iv.text for iv in words.intervals if iv.text)
    except KeyError:
        pass
    return Entry(
        utt_id=tg_path.stem,
        audio_path=wav_path,
        phones=phones,
        durations=np.asarray(durations, dtype=np.int64),
        start=start,
        end=end,
        speaker=speaker,
        text=text,
    )


def _stats_item_moments(
    item: Dict[str, Any], cfg: "DataConfig"
) -> Dict[str, Tuple[float, float, float, float, float]]:
    """Reduce one extracted item to per-key (count, sum, sumsq, min, max)
    over its finite values — the sufficient statistics for
    ``_create_stats``' min/max/mean/population-std."""
    out: Dict[str, Tuple[float, float, float, float, float]] = {}

    def add(key: str, vals) -> None:
        vals = np.asarray(vals, np.float64).ravel()
        vals = vals[np.isfinite(vals)]
        if vals.size:
            out[key] = (float(vals.size), float(vals.sum()),
                        float((vals * vals).sum()),
                        float(vals.min()), float(vals.max()))

    for i, var in enumerate(cfg.variances):
        if cfg.variance_transforms[i] == "cwt":
            with np.errstate(divide="ignore"):
                vals = np.log(item[f"variances_{var}_signal"])
        else:
            vals = item[f"variances_{var}"]
        add(var, vals)
    add("mel", item["mel"])
    add("duration", item["duration"])
    for var in cfg.priors:
        add(f"priors_{var}", [float(item[f"priors_{var}"])])
    return out


_STATS_DS = None


def _stats_worker_init(payload: bytes, device: str) -> None:
    global _STATS_DS
    _STATS_DS = pickle.loads(payload)
    _STATS_DS.device = device


def _stats_worker_item(idx: int):
    item = _STATS_DS.__getitem__(idx, augment=False)
    return _stats_item_moments(item, _STATS_DS.cfg)


class TTSDataset:
    """Map-style dataset over a corpus directory of paired
    ``<utt>.wav`` + ``<utt>.TextGrid`` files (speaker = first-level
    subdirectory, LibriTTS layout). Features are extracted on ``device``."""

    def __init__(
        self,
        root: Optional[Path] = None,
        cfg: DataConfig = DataConfig(),
        entries: Optional[List[Entry]] = None,
        vocab: Optional[Vocab] = None,
        stats: Optional[Dict[str, Dict[str, float]]] = None,
        speaker2dvector: Optional[Dict[str, np.ndarray]] = None,
        compute_stats: bool = True,
        cache_dir: Optional[Path] = None,
        device: DeviceLike = None,
    ):
        self.device = str(resolve_device(device))
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        if entries is None:
            assert root is not None
            entries = self.scan(Path(root), cfg)
        if cfg.min_samples_per_speaker > 0:
            counts: Dict[str, int] = {}
            for e in entries:
                counts[e.speaker] = counts.get(e.speaker, 0) + 1
            entries = [
                e for e in entries if counts[e.speaker] >= cfg.min_samples_per_speaker
            ]
        # fixed-seed shuffle (datasets.py:143)
        order = np.random.default_rng(cfg.seed).permutation(len(entries))
        self.entries = [entries[i] for i in order]

        self.vocab = vocab or Vocab(
            p for e in self.entries for p in e.phones
        )
        self.speakers = sorted({e.speaker for e in self.entries})
        self.speaker2id = {s: i for i, s in enumerate(self.speakers)}
        self.speaker2dvector = dict(speaker2dvector or {})
        if "dvector" in cfg.speaker_type:
            # materialize the full table (deterministic hash placeholders
            # for speakers without a d-vector)
            for s in self.speakers:
                if s not in self.speaker2dvector:
                    self.speaker2dvector[s] = _hash_dvector(s)
        self.speaker2priors: Dict[str, Dict[str, np.ndarray]] = {}
        # the per-utterance d-vector files' suffix: <utt>.npy until
        # create_dvectors names its pipeline's (data/dvector.py)
        self.dvector_suffix = ".npy"

        # per-utterance feature cache: stats write it, epochs read it
        self.feature_cache_dir = (
            Path(cache_dir) / "features" if cache_dir is not None else None
        )

        self.stats = stats
        if self.stats is None and compute_stats:
            self.compute_stats(cache_dir)

    def compute_stats(self, cache_dir: Optional[Path] = None) -> Dict[str, Dict[str, float]]:
        """The variance statistics (and the vocab) from the stats cache under
        ``cache_dir`` where it matches the corpus, else computed over the
        corpus (filling the feature cache) and written there."""
        if cache_dir is not None and self.load_cache(cache_dir):
            return self.stats
        self.stats = self._create_stats()
        if cache_dir is not None:
            self.save_cache(cache_dir)
        return self.stats

    # ------------------------------------------------------------ scanning
    @staticmethod
    def scan(root: Path, cfg: DataConfig) -> List[Entry]:
        """Parse every aligned (TextGrid, wav) pair under ``root`` into
        Entries. With ``cfg.scan_workers > 1`` the parse fans out over a
        spawn-based process pool with deterministic, path-sorted output
        order."""
        paths = sorted(root.rglob("*.TextGrid"))
        if cfg.scan_workers > 1 and len(paths) >= 4 * cfg.scan_workers:
            chunk = -(-len(paths) // (cfg.scan_workers * 4))
            with ProcessPoolExecutor(max_workers=cfg.scan_workers,
                                     mp_context=mp.get_context("spawn")) as pool:
                results = pool.map(
                    functools.partial(_scan_one, cfg=cfg, root=root),
                    paths, chunksize=chunk,
                )
                return [e for e in results if e is not None]
        return [e for p in paths if (e := _scan_one(p, cfg, root)) is not None]

    def __len__(self) -> int:
        return len(self.entries)

    # ------------------------------------------------------------- getitem
    def _load_audio(self, entry: Entry) -> np.ndarray:
        sr = self.cfg.audio.sampling_rate
        wav, in_sr = wav_io.read(entry.audio_path)
        wav = wav_io.resample(wav, in_sr, sr)
        start = int(sr * entry.start)
        end = int(sr * entry.end)
        wav = wav[start:end]
        peak = np.max(np.abs(wav)) if len(wav) else 1.0
        return (wav / max(peak, 1e-9)).astype(np.float32)

    def _extract(self, wav: np.ndarray) -> Dict[str, np.ndarray]:
        """The frame features of one wav, extracted on the dataset's device
        at the JAX package's wav bucket (a multiple of hop * 256 samples),
        every feature cut to 1 + len // hop frames (energy and SNR have
        ceil(bucket / hop) frames before the cut, mel and pitch one more)."""
        a = self.cfg.audio
        bucket = round_up(max(len(wav), a.hop_length), a.hop_length * 256)
        padded = np.zeros(bucket, dtype=np.float32)
        padded[: len(wav)] = wav
        x = torch.from_numpy(padded).to(self.device)
        hop, win = a.hop_length, a.win_length
        with torch.no_grad():
            out = {"mel": mel_mod.mel_spectrogram(x, a),
                   "energy": features.frame_energy(x, hop, win)}
            if "pitch" in self.cfg.variances:
                out["pitch"] = pitch_mod.track(x, a.sampling_rate, hop, win)
            if "snr" in self.cfg.variances:
                out["snr"] = snr_mod.windowed_wada(x, hop, win)
        n_frames = 1 + len(wav) // hop
        return {k: v[:n_frames].cpu().numpy() for k, v in out.items()}

    def _cached(self, name: str, entry: Entry, key_parts, compute):
        """Disk-cache one utterance's derived arrays (atomic writes, safe
        under concurrent loader/stats workers). Returns dict of arrays."""
        cdir = self.feature_cache_dir
        if cdir is None:
            return compute()
        key = hashlib.md5(
            json.dumps(list(key_parts), default=str).encode()
        ).hexdigest()[:16]
        path = cdir / f"{entry.utt_id}-{name}-{key}.npz"
        if path.exists():
            try:
                with np.load(path) as z:
                    return {k: z[k] for k in z.files}
            except Exception:
                pass  # torn/corrupt file: recompute and rewrite
        out = compute()
        cdir.mkdir(parents=True, exist_ok=True)
        tmp = cdir / f".{entry.utt_id}-{name}-{key}.{os.getpid()}.npz"
        np.savez(tmp, **out)
        os.replace(tmp, path)
        return out

    def _features(self, entry: Entry, wav: np.ndarray) -> Dict[str, np.ndarray]:
        a = self.cfg.audio
        return self._cached(
            "feats", entry,
            (entry.utt_id, len(wav), a.sampling_rate, a.n_fft, a.win_length,
             a.hop_length, a.n_mels, a.f_min, a.f_max,
             "pitch" in self.cfg.variances, "snr" in self.cfg.variances),
            lambda: self._extract(wav),
        )

    def _srmr(self, entry: Entry, wav: np.ndarray, dur_sum: int) -> np.ndarray:
        """The SRMR on the frame grid of ``dur_sum`` frames, computed on the
        dataset's device at the raw wav length, cached under the JAX
        package's key (the grid is augmentation-stable: the duration
        jitter keeps the total)."""
        sr = self.cfg.audio.sampling_rate
        return self._cached(
            "srmr", entry, (entry.utt_id, len(wav), int(dur_sum), sr),
            lambda: {"srmr": srmr_mod.frame_srmr(wav, dur_sum, sr, device=self.device)},
        )["srmr"]

    def _speaker(self, entry: Entry) -> np.ndarray:
        dvec = self.speaker2dvector.get(entry.speaker)
        return (dvec if dvec is not None else _hash_dvector(entry.speaker)).astype(np.float32)

    def __getitem__(self, idx: int, augment: bool = True) -> Dict[str, Any]:
        entry = self.entries[idx]
        cfg = self.cfg
        wav = self._load_audio(entry)

        if cfg.raw_mode:
            durations = entry.durations.copy()
            if augment and cfg.augment_duration > 0:
                durations = features.augment_durations(
                    durations, self.rng, cfg.augment_duration
                )
            phone_ids = np.asarray(self.vocab.encode(entry.phones), np.int64)
            silence_phone = np.asarray(
                [p.startswith("[") for p in entry.phones], dtype=bool
            )
            item: Dict[str, Any] = {
                "id": entry.utt_id,
                "phones": phone_ids,
                "duration": durations.astype(np.int64),
                "silence_phone": silence_phone,
                "wav": wav,
                "text": entry.text,
                "speaker_key": entry.speaker,
            }
            if cfg.speaker_type == "dvector":
                item["speaker"] = self._speaker(entry)
            elif cfg.speaker_type == "id":
                item["speaker"] = np.int64(self.speaker2id[entry.speaker])
            return item

        feats = self._features(entry, wav)

        durations = entry.durations.copy()
        if augment and cfg.augment_duration > 0:
            durations = features.augment_durations(
                durations, self.rng, cfg.augment_duration
            )
        dur_sum = int(durations.sum())

        phone_ids = np.asarray(self.vocab.encode(entry.phones), dtype=np.int64)
        unexpanded_silence = np.asarray(
            [p.startswith("[") for p in entry.phones], dtype=bool
        )
        silence_mask = features.expand_by_duration(unexpanded_silence, durations)

        mel = feats["mel"][:dur_sum]

        variances: Dict[str, Any] = {}
        for i, var in enumerate(cfg.variances):
            if var == "srmr":
                sig = self._srmr(entry, wav, dur_sum)
            else:
                sig = feats[var][:dur_sum].astype(np.float64).copy()
            sm = silence_mask[: len(sig)]
            if var == "pitch":
                sig[sig == 0] = np.nan
                sig[sm] = np.nan
                if np.isnan(sig).all():
                    sig[:] = 1e-7
                sig = features.interpolate_nans(sig)
            elif var == "snr":
                sig[sm] = np.nan
                if np.isnan(sig).all():
                    sig = np.zeros_like(sig)
                else:
                    sig = features.interpolate_nans(sig)
            if cfg.variance_levels[i] == "phone":
                sig = features.phone_average(sig, durations)
            transform = cfg.variance_transforms[i]
            if transform == "cwt":
                variances[var] = cwt_mod.decompose_np(sig)
            elif transform == "log":
                variances[var] = np.log(np.maximum(sig, 1e-10))
            elif self.stats is not None:
                st = self.stats[var]
                variances[var] = (sig - st["mean"]) / st["std"]
            else:
                variances[var] = sig

        priors: Dict[str, float] = {}
        for var in cfg.priors:
            if var == "duration":
                priors[var] = float(np.mean(durations[~unexpanded_silence]))
                continue
            i = cfg.variances.index(var)
            val = variances[var]
            if isinstance(val, dict):
                val = val["original_signal"]
            if self.stats is not None and var in self.stats:
                mean, std = self.stats[var]["mean"], self.stats[var]["std"]
            else:
                mean, std = 0.0, 1.0
            if cfg.variance_levels[i] == "phone":
                sel = val[~unexpanded_silence[: len(val)]]
            else:
                sel = val[~silence_mask[: len(val)]]
            if len(sel) == 0:
                sel = val
            priors[var] = float(np.mean(sel * std + mean))

        item = {
            "id": entry.utt_id,
            "phones": phone_ids,
            "duration": durations.astype(np.int64),
            "mel": mel.astype(np.float32),
            "silence_mask": silence_mask,
            "unexpanded_silence_mask": unexpanded_silence,
            "text": entry.text,
            "speaker_key": entry.speaker,
        }
        for var, val in variances.items():
            if isinstance(val, dict):
                item[f"variances_{var}_signal"] = np.exp(val["signal"]).astype(
                    np.float32
                )
                item[f"variances_{var}_spectrogram"] = val["spectrogram"].astype(
                    np.float32
                )
                item[f"variances_{var}_mean"] = np.float32(val["mean"])
                item[f"variances_{var}_std"] = np.float32(val["std"])
            else:
                item[f"variances_{var}"] = val.astype(np.float32)
        for var, val in priors.items():
            item[f"priors_{var}"] = np.float32(val)

        if cfg.speaker_type == "dvector":
            item["speaker"] = self._speaker(entry)
            # per-utterance d-vector for the diffusion speaker generator
            # (datasets.py:469: utterance_dvec from <utt>.npy)
            utt_path = entry.audio_path.with_suffix(self.dvector_suffix)
            if utt_path.exists():
                item["utterance_dvec"] = np.load(utt_path).astype(np.float32)
        elif cfg.speaker_type == "dvector_utterance":
            utt_path = entry.audio_path.with_suffix(self.dvector_suffix)
            if utt_path.exists():
                item["speaker"] = np.load(utt_path).astype(np.float32)
            else:
                item["speaker"] = _hash_dvector(entry.utt_id)
        elif cfg.speaker_type == "id":
            item["speaker"] = np.int64(self.speaker2id[entry.speaker])

        if cfg.load_wav:
            item["wav"] = wav
        return item

    # --------------------------------------------------------------- stats
    def _create_stats(self) -> Dict[str, Dict[str, float]]:
        """Streaming corpus statistics over the first ``stat_entries`` items
        (reference ``datasets.py:214-304,744-794``): each item reduces to
        per-key (count, sum, sumsq, min, max) moments, exact
        min/max/mean/population-std of the concatenated finite values. With
        ``cfg.scan_workers > 1`` items fan out over a spawn pool, each
        worker extracting on the dataset's device."""
        if self.cfg.raw_mode:
            # stats always need full extraction; temporarily leave raw mode
            full_cfg = dataclasses.replace(self.cfg, raw_mode=False)
            saved, self.cfg = self.cfg, full_cfg
            try:
                return self._create_stats()
            finally:
                self.cfg = saved
        n = min(len(self.entries), self.cfg.stat_entries)
        acc: Dict[str, Tuple[float, float, float, float, float]] = {}

        def merge(moments: Dict[str, Tuple]) -> None:
            for key, (cnt, s, ss, mn, mx) in moments.items():
                if key in acc:
                    N, S, SS, MN, MX = acc[key]
                    acc[key] = (N + cnt, S + s, SS + ss,
                                min(MN, mn), max(MX, mx))
                else:
                    acc[key] = (cnt, s, ss, mn, mx)

        if self.cfg.scan_workers > 1 and n >= 4 * self.cfg.scan_workers:
            with ProcessPoolExecutor(
                max_workers=self.cfg.scan_workers,
                mp_context=mp.get_context("spawn"),
                initializer=_stats_worker_init,
                initargs=(pickle.dumps(self), self.device),
            ) as pool:
                chunk = max(1, -(-n // (self.cfg.scan_workers * 8)))
                for moments in pool.map(_stats_worker_item, range(n),
                                        chunksize=chunk):
                    merge(moments)
        else:
            for idx in range(n):
                item = self.__getitem__(idx, augment=False)
                merge(_stats_item_moments(item, self.cfg))

        stats: Dict[str, Dict[str, float]] = {}
        for key, (cnt, s, ss, mn, mx) in acc.items():
            mean = s / cnt
            var = max(ss / cnt - mean * mean, 0.0)
            stats[key] = {
                "min": float(mn),
                "max": float(mx),
                "mean": float(mean),
                "std": float(max(np.sqrt(var), 1e-7)),
            }
        return stats

    def create_validation_dataset(self, root: Path) -> "TTSDataset":
        """Validation split sharing vocab + stats (datasets.py:315);
        ``min_samples_per_speaker`` is a train-split filter and does not
        apply."""
        entries = self.scan(Path(root), self.cfg)
        cfg = dataclasses.replace(self.cfg, min_samples_per_speaker=0)
        valid = TTSDataset(
            cfg=cfg, entries=entries, vocab=self.vocab, stats=self.stats,
            speaker2dvector=self.speaker2dvector, compute_stats=False,
            device=self.device,
        )
        valid.dvector_suffix = self.dvector_suffix
        return valid

    def create_dvectors(self, pipeline=None, cache: bool = True):
        """Embed every utterance with the d-vector net and build the speaker
        table (reference ``_create_dvectors``, datasets.py:652-690: 1 s per
        utterance -> ``<utt><tag>.npy``, speaker vector = mean over its
        utterances -> ``speaker<tag>.npy``; ``<tag>`` names the pipeline's
        weights, data/dvector.py). ``pipeline``: a ``DVectorPipeline``, by
        default the seeded one on the dataset's device. Returns the table."""
        from lightningfastspeech2_tpu_torch.data.dvector import DVectorPipeline

        if pipeline is None:
            pipeline = DVectorPipeline(sampling_rate=self.cfg.audio.sampling_rate,
                                       device=self.device)
        speaker_means = pipeline.process_entries(self.entries, cache=cache)
        self.speaker2dvector.update(speaker_means)
        if cache:
            self.dvector_suffix = pipeline.cache_tag + ".npy"
            for e in self.entries:
                spk_path = Path(e.audio_path).parent / f"speaker{self.dvector_suffix}"
                if e.speaker in speaker_means and not spk_path.exists():
                    np.save(spk_path, speaker_means[e.speaker])
        return self.speaker2dvector

    def get_speaker_dvectors(self):
        """Yield ``(speaker, (n_utts, dim) array)`` of per-utterance d-vectors
        from the files ``create_dvectors`` writes beside the audio
        (reference ``get_speaker_dvectors``, datasets.py:546-551); speakers
        with none are skipped."""
        per_speaker: Dict[str, List[np.ndarray]] = {}
        for e in self.entries:
            path = Path(e.audio_path).with_suffix(self.dvector_suffix)
            if path.exists():
                per_speaker.setdefault(e.speaker, []).append(np.load(path))
        for spk, vecs in per_speaker.items():
            yield spk, np.stack(vecs)

    def create_priors(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Per-speaker arrays of utterance priors
        (reference ``_create_priors``, datasets.py:476-544)."""
        per_speaker: Dict[str, Dict[str, List[float]]] = {}
        for idx in range(len(self.entries)):
            item = self.__getitem__(idx, augment=False)
            spk = item["speaker_key"]
            for var in self.cfg.priors:
                per_speaker.setdefault(spk, {}).setdefault(var, []).append(
                    float(item[f"priors_{var}"])
                )
        self.speaker2priors = {
            spk: {var: np.asarray(vals) for var, vals in d.items()}
            for spk, d in per_speaker.items()
        }
        return self.speaker2priors

    # --------------------------------------------------------------- cache
    def cache_key(self) -> str:
        """Fingerprint of (config, file list, mtimes) for the scan/stats
        cache, equal to the JAX package's for the same corpus and config.
        ``scan_workers`` is a machine-dependent performance knob and stays
        out of it, as does the device."""
        cfg_dict = dataclasses.asdict(self.cfg)
        cfg_dict.pop("scan_workers", None)
        h = hashlib.md5()
        h.update(json.dumps(cfg_dict, sort_keys=True,
                            default=str).encode())
        for e in sorted(self.entries, key=lambda e: e.utt_id):
            h.update(e.utt_id.encode())
            try:
                h.update(str(e.audio_path.stat().st_mtime_ns).encode())
            except OSError:
                pass
        return h.hexdigest()

    def save_cache(self, cache_dir) -> Path:
        path = Path(cache_dir)
        path.mkdir(parents=True, exist_ok=True)
        out = path / f"stats_{self.cache_key()}.json"
        out.write_text(json.dumps({
            "stats": self.stats,
            "phone2id": self.vocab.to_dict(),
        }))
        return out

    def load_cache(self, cache_dir) -> bool:
        """Restore stats/vocab if a matching cache exists; returns hit."""
        path = Path(cache_dir) / f"stats_{self.cache_key()}.json"
        if not path.exists():
            return False
        data = json.loads(path.read_text())
        self.stats = data["stats"]
        self.vocab = Vocab.from_dict(data["phone2id"])
        return True

    def shard_across_hosts(self, mesh=None) -> "TTSDataset":
        """Multi-process input sharding: each data rank keeps a strided
        slice of the (already seed-shuffled) entries; vocab and stats stay
        global so that every rank builds identical models. ``mesh``
        (parallel/mesh.py) gives the data axis: the ranks of one model group
        keep the same slice, as the model axis replicates. Without a mesh
        the world is the data axis; in one process (or a data axis of 1),
        ``self`` as it is."""
        from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib

        if mesh is None:
            n, i = mesh_lib.world_size(), mesh_lib.rank()
        else:
            n, i = mesh.data, mesh.data_rank
        if n == 1:
            return self
        self.entries = self.entries[i::n]
        return self

    # -------------------------------------------------------------- batching
    def sort_by_duration(self) -> None:
        """Length-sorted order for low-padding bucketed batching
        (datasets.py:884-886)."""
        self.entries.sort(key=lambda e: int(e.durations.sum()))

    def collate(self, items: Sequence[Dict[str, Any]],
                bucketer: Optional[Bucketer] = None) -> Dict[str, Any]:
        return collate(items, self.cfg, bucketer)


def _hash_dvector(speaker: str, dim: int = 256) -> np.ndarray:
    """Deterministic placeholder d-vector when no table is loaded."""
    seed = int(hashlib.md5(speaker.encode()).hexdigest()[:8], 16)
    return np.random.default_rng(seed).standard_normal(dim).astype(np.float32)


def collate(
    items: Sequence[Dict[str, Any]],
    cfg: DataConfig,
    bucketer: Optional[Bucketer] = None,
) -> Dict[str, Any]:
    """Static-shape collation (reference ``_collate_fn``
    ``datasets.py:852-882``, made uniform): pad phones/frames to the batch
    bucket, attach ``*_lengths``."""
    bucketer = bucketer or Bucketer(cfg.max_phones, cfg.max_frames)
    P = bucketer.phone_bucket(max(len(i["phones"]) for i in items))

    if cfg.raw_mode:
        T = bucketer.frame_bucket(max(int(i["duration"].sum()) for i in items))
        batch = {
            "phones": pad_batch([i["phones"] for i in items], P),
            "duration": pad_batch([i["duration"] for i in items], P),
            "silence_phone": pad_batch(
                [i["silence_phone"] for i in items], P
            ),
            "wav": pad_batch([i["wav"] for i in items],
                             T * cfg.audio.hop_length),
            "phones_lengths": np.asarray([len(i["phones"]) for i in items]),
        }
        if cfg.speaker_type != "none":
            batch["speaker"] = np.stack([i["speaker"] for i in items])
        return _shrink_transfer(batch, cfg)

    T = bucketer.frame_bucket(max(i["mel"].shape[0] for i in items))

    batch: Dict[str, Any] = {
        "phones": pad_batch([i["phones"] for i in items], P),
        "duration": pad_batch([i["duration"] for i in items], P),
        "mel": pad_batch([i["mel"] for i in items], T),
        "phones_lengths": np.asarray([len(i["phones"]) for i in items]),
        "mel_lengths": np.asarray([i["mel"].shape[0] for i in items]),
        # silence masks pad with 1 (datasets.py:866-870)
        "silence_mask": pad_batch(
            [i["silence_mask"] for i in items], T, value=1
        ),
    }
    for i_var, var in enumerate(cfg.variances):
        L = P if cfg.variance_levels[i_var] == "phone" else T
        if cfg.variance_transforms[i_var] == "cwt":
            batch[f"variances_{var}_signal"] = pad_batch(
                [i[f"variances_{var}_signal"] for i in items], L
            )
            batch[f"variances_{var}_spectrogram"] = pad_batch(
                [i[f"variances_{var}_spectrogram"] for i in items], L
            )
            batch[f"variances_{var}_mean"] = np.asarray(
                [i[f"variances_{var}_mean"] for i in items]
            )
            batch[f"variances_{var}_std"] = np.asarray(
                [i[f"variances_{var}_std"] for i in items]
            )
        else:
            batch[f"variances_{var}"] = pad_batch(
                [i[f"variances_{var}"] for i in items], L
            )
    for var in cfg.priors:
        batch[f"priors_{var}"] = np.asarray([i[f"priors_{var}"] for i in items])
    if cfg.speaker_type != "none":
        batch["speaker"] = np.stack([i["speaker"] for i in items])
        if all("utterance_dvec" in i for i in items):
            batch["utterance_dvec"] = np.stack(
                [i["utterance_dvec"] for i in items]
            )
    if cfg.load_wav and "wav" in items[0]:
        wav_len = T * cfg.audio.hop_length
        batch["wav"] = pad_batch([i["wav"] for i in items], wav_len)
    return _shrink_transfer(batch, cfg)


def batch_buckets(batch: Dict[str, Any], cfg: DataConfig) -> Tuple[int, int]:
    """A collated batch's phone and frame buckets."""
    if "mel" in batch:
        return int(batch["phones"].shape[1]), int(batch["mel"].shape[1])
    return int(batch["phones"].shape[1]), int(batch["wav"].shape[1]) // cfg.audio.hop_length


def pad_to_bucket(batch: Dict[str, Any], cfg: DataConfig, P: int, T: int) -> Dict[str, Any]:
    """A collated batch padded (never cut) to ``P`` phones and ``T`` frames,
    as ``collate`` pads: ``silence_mask`` with 1, every other array with 0,
    the wav to ``T`` hops. Per-item arrays (lengths, speakers, priors, CWT
    means) stay as they are."""
    p0, t0 = batch_buckets(batch, cfg)
    if (p0, t0) == (P, T):
        return batch
    phone_level = {"phones", "duration", "silence_phone"}
    frame_level = {"mel", "silence_mask"}
    for var, level in zip(cfg.variances, cfg.variance_levels):
        names = {f"variances_{var}", f"variances_{var}_signal", f"variances_{var}_spectrogram"}
        (phone_level if level == "phone" else frame_level).update(names)
    out = dict(batch)
    for key, value in batch.items():
        if key in phone_level:
            out[key] = _pad_axis1(value, P)
        elif key in frame_level:
            out[key] = _pad_axis1(value, T, 1 if key == "silence_mask" else 0)
        elif key == "wav":
            out[key] = _pad_axis1(value, T * cfg.audio.hop_length)
    return out


def _pad_axis1(x, length: int, value=0):
    """``x`` (numpy or a tensor) padded along axis 1 to ``length``."""
    if isinstance(x, torch.Tensor):
        fill = torch.full((x.shape[0], length - x.shape[1]) + tuple(x.shape[2:]), value,
                          dtype=x.dtype, device=x.device)
        return torch.cat([x, fill], dim=1)
    widths = [(0, 0)] * x.ndim
    widths[1] = (0, length - x.shape[1])
    return np.pad(x, widths, constant_values=value)


def _shrink_transfer(batch: Dict[str, np.ndarray],
                     cfg: DataConfig) -> Dict[str, Any]:
    """Fewer bytes per batch, as the JAX package ships them: int64 index
    arrays become int32 (the model's boundary takes either), and the mel
    drops to ``cfg.mel_dtype``: under "bfloat16" a CPU ``torch.bfloat16``
    tensor, rounded to nearest even as ``ml_dtypes`` rounds."""
    for k, v in batch.items():
        if v.dtype == np.int64:
            batch[k] = v.astype(np.int32)
    if cfg.mel_dtype != "float32" and "mel" in batch:
        batch["mel"] = torch.from_numpy(batch["mel"]).to(getattr(torch, cfg.mel_dtype))
    if cfg.wav_dtype == "int16" and "wav" in batch:
        batch["wav"] = np.clip(
            batch["wav"] * 32768.0, -32768, 32767
        ).astype(np.int16)
    return batch
