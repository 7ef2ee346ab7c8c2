"""Speaker d-vectors: the wav2mel front-end and the LSTM d-vector encoder.

Counterpart of ``lightningfastspeech2_tpu/data/dvector.py`` (reference
``litfass/third_party/dvectors/wav2mel.py``, ``datasets.py:652-690``): one
second of each utterance is resampled to 16 kHz, normalized to -3 dB, its
silences removed (numpy), turned into a 40-band HTK log-mel (25 ms
window, 10 ms hop, f_min 50, power 2; ``torch.fft`` on the pipeline's
device) and embedded by yistLin's AttentivePooledLSTMDvector: three LSTM
layers (40 -> 256), a Linear(256) with tanh, attentive pooling and an L2
norm. The LSTM is ``nn.LSTM``, a library call, as the JAX package computes
it outside any Pallas kernel.

Weights. ``DVector`` takes a yistLin state dict as it is (``lstm.*``,
``embedding.*``, ``attention.*``, the names the JAX package's
``convert_torch_state_dict`` reads); ``utils/convert.py from_jax_dvector``
turns a JAX parameter tree into one. Without weights the net is initialized
from a seeded ``torch.Generator``, not from the JAX package's flax init at
``PRNGKey(0)``, so the two packages' default embeddings differ. Each
pipeline names its ``<utt>.npy`` caches after a hash of its weights
(``<utt>.<hash>.npy``), so no cache written under other weights, such as
the JAX package's plain ``<utt>.npy``, is read as this pipeline's.
"""

from __future__ import annotations

import hashlib
import math
from pathlib import Path
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from lightningfastspeech2_tpu_torch.audio.mel import hann_window, mel_filterbank_htk
from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.data import wav as wav_io


# ---------------------------------------------------------------------------
# wav2mel front-end
# ---------------------------------------------------------------------------

def normalize_db(wav: np.ndarray, norm_db: float = -3.0) -> np.ndarray:
    """sox 'norm -3': scale so that the peak is 10^(norm_db / 20)."""
    peak = np.max(np.abs(wav))
    if peak == 0:
        return wav
    return wav * (10.0 ** (norm_db / 20.0) / peak)


def remove_silence(wav: np.ndarray, sample_rate: int, threshold_pct: float = 1.0,
                   min_duration: float = 0.1) -> np.ndarray:
    """Energy-gated silence removal after sox's 'silence 1 0.1 1% -1 0.1 1%':
    drop runs of 10 ms frames below ``threshold_pct`` of the peak that last
    ``min_duration`` or longer."""
    if len(wav) == 0:
        return wav
    threshold = (threshold_pct / 100.0) * max(np.max(np.abs(wav)), 1e-9)
    win = max(int(sample_rate * 0.01), 1)
    n_frames = len(wav) // win
    if n_frames == 0:
        return wav
    frames = wav[: n_frames * win].reshape(n_frames, win)
    loud = np.abs(frames).max(axis=1) >= threshold
    min_frames = max(int(min_duration / 0.01), 1)
    keep = loud.copy()
    i = 0
    while i < n_frames:   # keep quiet gaps shorter than min_duration
        if not loud[i]:
            j = i
            while j < n_frames and not loud[j]:
                j += 1
            if j - i < min_frames:
                keep[i:j] = True
            i = j
        else:
            i += 1
    out = frames[keep].reshape(-1)
    if keep[-1]:
        out = np.concatenate([out, wav[n_frames * win:]])
    return out if len(out) else wav


def wav2mel(wav: np.ndarray, sample_rate: int, target_rate: int = 16000,
            norm_db: float = -3.0, fft_window_ms: float = 25.0, fft_hop_ms: float = 10.0,
            f_min: float = 50.0, n_mels: int = 40, device: DeviceLike = "cpu") -> torch.Tensor:
    """(N,) wav -> (T, 40) f32 log-mel on ``device``, T = 1 + len // hop of
    the wav after silence removal (centred, zero-padded frames)."""
    wav = wav_io.resample(np.asarray(wav, np.float32), sample_rate, target_rate)
    wav = remove_silence(normalize_db(wav, norm_db), target_rate)
    n_fft = int(target_rate * fft_window_ms / 1000)
    hop = int(target_rate * fft_hop_ms / 1000)
    x = torch.as_tensor(np.asarray(wav, np.float32), device=device)
    padded = torch.nn.functional.pad(x, (n_fft // 2, n_fft // 2))
    frames = padded.unfold(0, n_fft, hop)[: 1 + x.shape[0] // hop]
    spec = torch.fft.rfft(frames * hann_window(n_fft, device=x.device), n=n_fft, dim=-1).abs() ** 2
    fb = torch.as_tensor(mel_filterbank_htk(target_rate, n_fft, n_mels, f_min, target_rate / 2),
                         device=x.device)
    return torch.log(torch.clamp(spec @ fb.T, min=1e-9))


# ---------------------------------------------------------------------------
# d-vector encoder
# ---------------------------------------------------------------------------

class DVector(nn.Module):
    """yistLin's AttentivePooledLSTMDvector: (B, T, 40) -> (B, 256), L2-normed."""

    def __init__(self, dim_input: int = 40, dim_cell: int = 256, dim_emb: int = 256,
                 num_layers: int = 3, generator: Optional[torch.Generator] = None):
        """Initialized as ``nn.LSTM`` and ``nn.Linear`` initialize (uniform in
        +-1/sqrt(fan_in)), from ``generator`` (seed 0 when None)."""
        super().__init__()
        self.lstm = nn.LSTM(dim_input, dim_cell, num_layers, batch_first=True)
        self.embedding = nn.Linear(dim_cell, dim_emb)
        self.attention = nn.Linear(dim_emb, 1)
        g = generator or torch.Generator().manual_seed(0)
        with torch.no_grad():
            for module, fan_in in ((self.lstm, dim_cell), (self.embedding, dim_cell),
                                   (self.attention, dim_emb)):
                bound = 1.0 / math.sqrt(fan_in)
                for p in module.parameters():
                    p.uniform_(-bound, bound, generator=g)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        if mel.dim() == 2:
            mel = mel[None]
        h, _ = self.lstm(mel)
        e = torch.tanh(self.embedding(h))
        attn = torch.softmax(self.attention(e), dim=1)
        emb = torch.sum(e * attn, dim=1)
        return emb / torch.linalg.vector_norm(emb, dim=-1, keepdim=True)


def weights_tag(state_dict: Mapping[str, torch.Tensor]) -> str:
    """``.<8 hex digits>``: a hash of the weights (the first 4 KiB of each
    tensor, in key order), the cache files' tag."""
    h = hashlib.sha1()
    for key in sorted(state_dict):
        h.update(key.encode())
        h.update(state_dict[key].detach().cpu().float().numpy().tobytes()[:4096])
    return "." + h.hexdigest()[:8]


# ---------------------------------------------------------------------------
# corpus pipeline
# ---------------------------------------------------------------------------

class DVectorPipeline:
    """Per-utterance d-vectors on ``device`` (cached as ``<utt><tag>.npy``
    beside the audio, datasets.py:652-677) and per-speaker means."""

    def __init__(self, state_dict: Optional[Mapping[str, torch.Tensor]] = None, seed: int = 0,
                 sampling_rate: int = 22050, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.model = DVector(generator=torch.Generator().manual_seed(seed))
        if state_dict is not None:
            self.model.load_state_dict({k: torch.as_tensor(np.array(v))
                                        for k, v in state_dict.items()})
        self.cache_tag = weights_tag(self.model.state_dict())
        self.model.to(self.device).eval()
        self.sampling_rate = sampling_rate

    @torch.no_grad()
    def embed_wav(self, wav: np.ndarray, sample_rate: int) -> np.ndarray:
        """(256,) f32 d-vector of one wav."""
        mel = wav2mel(wav, sample_rate, device=self.device)
        return self.model(mel)[0].float().cpu().numpy()

    def cache_path(self, audio_path) -> Path:
        return Path(audio_path).with_suffix(self.cache_tag + ".npy")

    def process_entries(self, entries, cache: bool = True) -> Dict[str, np.ndarray]:
        """Embed the first second of each utterance (datasets.py:667-668);
        returns speaker -> mean d-vector."""
        per_speaker: Dict[str, List[np.ndarray]] = {}
        for entry in entries:
            path = self.cache_path(entry.audio_path)
            if cache and path.exists():
                dvec = np.load(path)
            else:
                wav, sr = wav_io.read(entry.audio_path)
                start = int(sr * entry.start)
                wav = wav[start: start + sr]
                peak = np.max(np.abs(wav)) if len(wav) else 1.0
                dvec = self.embed_wav(wav / max(peak, 1e-9), sr)
                if cache:
                    np.save(path, dvec)
            per_speaker.setdefault(entry.speaker, []).append(dvec)
        return {spk: np.mean(vecs, axis=0) for spk, vecs in per_speaker.items()}
