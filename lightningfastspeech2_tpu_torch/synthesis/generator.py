"""End-to-end speech generation: text -> waveform.

Counterpart of ``lightningfastspeech2_tpu/synthesis/generator.py``: G2P ->
phone ids -> speaker (and prior) pick -> acoustic model -> vocoder (HiFi-GAN,
or FastDiff through ``FastDiffSynthesiser``) -> post-processing (restoration,
augmentations: ``PostProcessChain``) -> ``save_audio`` at the output rate. A
model with the FastDiff residual head vocodes mel + ``fastdiff_var``.

Serving runs two bucketing passes, as in the JAX package (where both are on
by default; here they are the only path):
- a duration-only pass (encoder + duration tower) picks the static frame
  bucket, then the full inference pass runs at that bucket; sampled
  durations, variances and speakers are drawn alike in both;
- the vocoder sees the mel at its bucket length, padded frames at the
  log-mel silence floor of the config's front end (``mel_pad_floor``: -6.0 =
  log10 of the default clip 1e-6, where the JAX package hard-codes -6.0),
  and the waveform is cut to valid frames x hop.
"""

from __future__ import annotations

import logging
from dataclasses import replace
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core import config as C
from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer, pad_to
from lightningfastspeech2_tpu_torch.core.device import DeviceLike
from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.data.vocab import Vocab
from lightningfastspeech2_tpu_torch.models.draws import ModuleStreams
from lightningfastspeech2_tpu_torch.models.joint import make_fastdiff_config
from lightningfastspeech2_tpu_torch.synthesis.g2p import G2P
from lightningfastspeech2_tpu_torch.vocoder.fastdiff import FastDiffVocoder

_log = logging.getLogger(__name__)

def mel_pad_floor(audio: C.AudioConfig) -> np.float32:
    """The log-mel value of a silent frame, where padded vocoder frames sit:
    the front end's clip ``clip_val`` through its log (log10 or ln)."""
    return np.float32(np.log10(audio.clip_val) if audio.log10 else np.log(audio.clip_val))


def _batch_tensor(v, dev: torch.device) -> torch.Tensor:
    """One batch entry on the model's device. Integer entries become int64:
    a collated corpus batch carries int32 phones and durations
    (``data/dataset.py _shrink_transfer``), a sentence's batch int64, and
    both serve alike."""
    t = torch.as_tensor(np.asarray(v), device=dev)
    if not t.is_floating_point() and t.dtype != torch.bool:
        t = t.to(torch.int64)
    return t


class SpeechGenerator:
    def __init__(
        self,
        cfg: C.Config,
        model,  # models.fastspeech2.FastSpeech2, on its device, eval mode
        vocab: Vocab,
        g2p: G2P,
        synthesiser: Optional[Callable[[np.ndarray], np.ndarray]] = None,
        speaker2dvector: Optional[Dict[str, np.ndarray]] = None,
        speaker2id: Optional[Dict[str, int]] = None,
        speaker2priors: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
        speaker_gmms: Optional[Dict[str, Any]] = None,
        dvector_gmms: Optional[Dict[str, Any]] = None,
        postprocess: Optional[Callable[[np.ndarray, int], np.ndarray]] = None,
    ):
        self.cfg = cfg
        self.model = model
        self.vocab = vocab
        self.g2p = g2p
        self.synthesiser = synthesiser
        self.speaker2dvector = speaker2dvector or {}
        self.speaker2id = speaker2id or {}
        self.speaker2priors = speaker2priors or {}
        self.speaker_gmms = speaker_gmms or {}
        self.dvector_gmms = dvector_gmms or {}
        self.postprocess = postprocess
        self.bucketer = Bucketer(cfg.model.max_phones, cfg.model.max_frames)

    @property
    def sampling_rate(self) -> int:
        return self.cfg.model.audio.sampling_rate

    @property
    def output_sampling_rate(self) -> int:
        return (getattr(self.postprocess, "output_sampling_rate", None)
                or self.sampling_rate)

    def set_postprocess(self, fn) -> None:
        """Install a post-processor after construction (the save rate
        follows it: a restorer outputs 44.1 kHz)."""
        self.postprocess = fn

    def save_audio(self, path, audio: np.ndarray) -> None:
        """int16 PCM at the output rate (``data/wav.py write``)."""
        wav_io.write(path, audio, self.output_sampling_rate)

    # ------------------------------------------------------------ text path
    def text_to_ids(self, text: str) -> np.ndarray:
        phones = self.g2p(text)
        ids = [self.vocab.phone2id[p] for p in phones if p in self.vocab.phone2id]
        if phones and not ids:
            _log.warning(
                "text_to_ids: none of %d G2P phones exist in the model "
                "vocabulary (%d entries); synthesis will be empty",
                len(phones), len(self.vocab.phone2id))
        return np.asarray(ids, dtype=np.int64)

    def _pick_speaker(self, speaker: Optional[str], rng: np.random.Generator,
                      sample_dvector: bool = False):
        mcfg = self.cfg.model
        if mcfg.speaker_type == "dvector":
            if speaker is None:
                names = list(self.speaker2dvector)
                if mcfg.priors and self.speaker2priors:
                    names = [n for n in names if n in self.speaker2priors] or names
                speaker = names[int(rng.integers(len(names)))]
            if sample_dvector and speaker in self.dvector_gmms:
                dvec = self.dvector_gmms[speaker].sample(
                    random_state=int(rng.integers(2 ** 31)))[0][0]
                return speaker, np.asarray(dvec, np.float32)
            return speaker, np.asarray(self.speaker2dvector[speaker], np.float32)
        if mcfg.speaker_type == "id":
            if speaker is None:
                speaker = list(self.speaker2id)[int(rng.integers(len(self.speaker2id)))]
            return speaker, np.int64(self.speaker2id[speaker])
        return None, None

    def _pick_priors(self, speaker_name: Optional[str], strategy: str,
                     overrides: Optional[Dict[str, float]],
                     rng: np.random.Generator) -> Dict[str, float]:
        priors = self.cfg.model.priors
        values: Dict[str, float] = {}
        if not priors:
            return values
        if strategy == "sample" and speaker_name in self.speaker2priors:
            history = self.speaker2priors[speaker_name]
            idx = int(rng.integers(len(history[priors[0]])))
            values = {p: float(history[p][idx]) for p in priors}
        elif strategy == "gmm" and speaker_name in self.speaker_gmms:
            sample = self.speaker_gmms[speaker_name].sample()[0][0]
            values = {p: float(sample[i]) for i, p in enumerate(priors)}
        else:
            values = {p: 0.0 for p in priors}
        for p, v in (overrides or {}).items():
            if v != -1:
                values[p] = v
        return values

    # ------------------------------------------------------------ synthesis
    def generate_from_text(self, text: str, speaker: Optional[str] = None,
                           seed: Optional[int] = None,
                           prior_strategy: str = "sample",
                           prior_values: Optional[Dict[str, float]] = None,
                           sample_dvector: bool = False) -> np.ndarray:
        rng = np.random.default_rng(seed)
        ids = self.text_to_ids(text)
        P = self.bucketer.phone_bucket(len(ids))
        batch: Dict[str, np.ndarray] = {"phones": pad_to(ids, P)[None, :]}
        speaker_name, spk = self._pick_speaker(speaker, rng, sample_dvector)
        if spk is not None:
            batch["speaker"] = np.asarray(spk)[None] if np.ndim(spk) else np.asarray([spk])
        for p, v in self._pick_priors(speaker_name, prior_strategy,
                                      prior_values, rng).items():
            batch[f"priors_{p}"] = np.asarray([v], np.float32)
        return self.generate_samples(batch)[0]

    @torch.no_grad()
    def infer(self, batch: Dict[str, np.ndarray]) -> Dict[str, Any]:
        """Both acoustic passes: the duration pass picks the frame bucket T,
        the full pass runs at T. Returns the full pass's outputs. A model's
        stochastic modules (the SDP, the diffusion adaptor and speaker
        generator) draw from per-module streams seeded 0, made anew for each
        pass, so the full pass re-draws the durations the duration pass drew
        (the JAX generator's two passes share their rng, PRNGKey(0))."""
        dev = self.model.device
        tb = {k: _batch_tensor(v, dev) for k, v in batch.items()}
        durs = self.model(tb, inference=True, duration_only=True, draws=ModuleStreams(0))
        need = int(durs["duration_rounded"].sum(-1).max())
        T = self.bucketer.frame_bucket(need)
        return self.model(tb, inference=True, max_frames=T, draws=ModuleStreams(0))

    def generate_samples(self, batch: Dict[str, np.ndarray]) -> List[np.ndarray]:
        result = self.infer(batch)
        mel = result["mel"]
        if "fastdiff_var" in result:
            # the residual head's x0.1 correction (reference
            # fastspeech2.py:733-736)
            mel = mel + result["fastdiff_var"]
        mels = mel.float().cpu().numpy()
        mask = result["frame_mask"].cpu().numpy()
        hop = self.cfg.model.audio.hop_length
        audios = []
        for i in range(len(mels)):
            if self.synthesiser is not None:
                mel_in = np.where(mask[i][:, None], mels[i], mel_pad_floor(self.cfg.model.audio))
                wav = np.asarray(self.synthesiser(mel_in), np.float32)
                if wav.ndim > 1:
                    wav = wav[0]
                wav = wav[: int(mask[i].sum()) * hop] / 32768.0
            else:  # no vocoder: the valid mel frames flattened as a stub signal
                wav = mels[i][mask[i]].reshape(-1)
            if self.postprocess is not None:
                wav = self.postprocess(wav, self.sampling_rate)
            audios.append(wav)
        return audios


class FastDiffSynthesiser:
    """The FastDiff vocoder as a synthesiser: mel (T, 80) as numpy ->
    waveform scaled by 32768 (the HiFi-GAN Synthesiser's int16 contract),
    float32 numpy (T * hop,). One item per call, ``fastdiff_inference_steps``
    reverse steps, bf16 for ``vocoder_precision`` 16, the Padé gate with
    ``fast_gating`` (generate's ``--vocoder_fast_gating``). Counterpart of the
    synthesiser ``lightningfastspeech2_tpu/cli/generate.py`` builds for
    ``--use_fastdiff``.

    The noise of each call is drawn from a generator seeded 0 on the
    vocoder's device, or comes from ``noise_source(shape, N)`` -> (x_T,
    noises) where given."""

    def __init__(self, model_cfg: C.ModelConfig,
                 state_dict: Optional[Dict[str, object]] = None,
                 vocoder_precision: int = 32, fast_gating: bool = False,
                 device: DeviceLike = None, seed: int = 0,
                 noise_source: Optional[Callable[[Sequence[int], int],
                                                 Tuple[Any, Any]]] = None):
        fd_cfg = make_fastdiff_config(model_cfg)
        if fast_gating:
            fd_cfg = replace(fd_cfg, fast_gating=True)
        dtype = torch.bfloat16 if vocoder_precision == 16 else torch.float32
        self.vocoder = FastDiffVocoder(fd_cfg, state_dict, dtype, device, seed)
        self.n_steps = model_cfg.fastdiff_inference_steps
        self.noise_source = noise_source

    def __call__(self, mel) -> np.ndarray:
        m = np.asarray(mel, np.float32)[None]
        noise = {}
        if self.noise_source is not None:
            shape = (1, m.shape[1] * self.vocoder.cfg.hop_length)
            noise = dict(zip(("x_T", "noises"), self.noise_source(shape, self.n_steps)))
        wav = self.vocoder.inference(m, N=self.n_steps, **noise)
        return (wav[0].float() * 32768.0).cpu().numpy()


class PostProcessChain:
    """Compose post-vocoder processors, threading the sample rate through
    rate-changing stages."""

    def __init__(self, *fns):
        self.fns = [f for f in fns if f is not None]
        rate = None
        for f in self.fns:
            rate = getattr(f, "output_sampling_rate", rate)
        self.output_sampling_rate = rate  # None -> rate unchanged

    def __call__(self, wav: np.ndarray, sr: int) -> np.ndarray:
        for f in self.fns:
            wav = f(wav, sr)
            sr = getattr(f, "output_sampling_rate", sr)
        return wav
