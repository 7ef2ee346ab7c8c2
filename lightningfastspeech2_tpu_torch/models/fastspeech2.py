"""FastSpeech2/LightSpeech acoustic model.

Counterpart of ``lightningfastspeech2_tpu/models/fastspeech2.py``:

    phones -> embedding -> +pos -> +speaker -> encoder (FFT blocks)
    -> +priors -> variance adaptor (durations, variances, length-regulate)
    -> +pos -> +speaker -> decoder (FFT blocks) -> linear -> mel (B, T, 80)

in teacher-forced, ``inference=True`` and ``duration_only=True`` modes.
The FastDiff branches (speaker generator, diffusion variances, residual
mel head) and every-layer re-injection are not ported yet.

Parameters are named like the reference torch state dict; parameters stay
f32 and ``dtype`` is the working dtype of the activations, fixed at
construction.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from lightningfastspeech2_tpu_torch.core.config import ModelConfig
from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device
from lightningfastspeech2_tpu_torch.models.layers import (
    FFTStack,
    LayerNorm,
    PositionalEncoding,
    SelfAttention,
    linear,
)
from lightningfastspeech2_tpu_torch.models.variance_adaptor import (
    PriorEmbedding,
    SpeakerEmbedding,
    StatsTree,
    VarianceAdaptor,
    default_stats,
    embed,
    stats_for,
)

Batch = Dict[str, torch.Tensor]


class FastSpeech2(nn.Module):
    def __init__(self, cfg: ModelConfig, stats: StatsTree = (),
                 prior_stats: StatsTree = (), dtype: torch.dtype = torch.float32,
                 device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        """Builds on the CPU, initializes from ``generator`` (seed 0 when
        None), then moves to ``device`` (``cuda`` unless ``"cpu"``)."""
        super().__init__()
        dev = resolve_device(device)
        if (cfg.fastdiff_variances or cfg.fastdiff_speakers
                or cfg.speaker_embedding_every_layer
                or cfg.prior_embedding_every_layer):
            raise NotImplementedError(
                "FastDiff branches and every-layer embeddings are not ported yet")
        self.cfg, self.dtype = cfg, dtype
        stats = stats or default_stats(cfg.variance.variances)
        self.phone_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden)
        # one module for both places, with the encoder's rate, as the JAX
        # package applies its one PositionalEncoding twice
        self.positional_encoding = PositionalEncoding(cfg.hidden, dropout=cfg.encoder.dropout)
        self.encoder = FFTStack(cfg.encoder, dtype)
        self.decoder = FFTStack(cfg.decoder, dtype)
        self.linear = nn.Linear(cfg.decoder.hidden, cfg.audio.n_mels)
        if cfg.speaker_type != "none":
            self.speaker_embedding = SpeakerEmbedding(
                cfg.hidden, cfg.speaker_type, cfg.n_speakers, cfg.dvector_dim, dtype)
        self.prior_embeddings = nn.ModuleDict({
            p: PriorEmbedding(cfg.hidden, cfg.prior_nbins,
                              stats_for(prior_stats, p), dtype)
            for p in cfg.priors
        })
        self.variance_adaptor = VarianceAdaptor(
            cfg.variance, cfg.duration, cfg.hidden, stats, cfg.variance.nbins, dtype)
        init_weights(self, generator)
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.linear.weight.device

    def forward(self, batch: Batch, inference: bool = False, tf: bool = True,
                oracles: Tuple[str, ...] = (),
                controls: Optional[Dict[str, float]] = None,
                duration_only: bool = False,
                max_frames: Optional[int] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        """``max_frames`` is the static frame bucket; by default the batch's
        mel length when present, else the config maximum. In training mode
        (``model.train()``) every dropout and kernel seed is drawn from
        ``generator``, which lives on the model's device."""
        cfg, dt = self.cfg, self.dtype
        phones = batch["phones"]
        phone_mask = phones != 0
        zero = torch.zeros((), dtype=dt, device=phones.device)

        x = embed(phones, self.phone_embedding, dt)
        x = torch.where(phone_mask[:, :, None], x, zero)
        x = self.positional_encoding(x, generator)

        speaker_module = getattr(self, "speaker_embedding", None)
        if speaker_module is not None:
            x = x + speaker_module(batch["speaker"], x.shape[1])
        x = self.encoder(x, phone_mask, generator=generator)
        for p, module in self.prior_embeddings.items():
            x = x + module(batch[f"priors_{p}"], x.shape[1])

        if max_frames is None:
            max_frames = (min(batch["mel"].shape[1], cfg.max_frames)
                          if "mel" in batch else cfg.max_frames)
        adaptor_out = self.variance_adaptor(
            x, phone_mask, max_frames, batch, inference=inference, tf=tf,
            oracles=oracles, controls=controls, duration_only=duration_only,
            generator=generator)
        if duration_only:
            return {
                "duration_prediction": adaptor_out["duration_prediction"],
                "duration_rounded": adaptor_out["duration_rounded"],
                "phone_mask": phone_mask,
            }

        y = adaptor_out["x"]
        frame_mask = adaptor_out["frame_mask"]
        y = self.positional_encoding(y, generator)
        if speaker_module is not None:
            y = y + speaker_module(batch["speaker"], y.shape[1])
        y = self.decoder(y, frame_mask, generator=generator)
        mel = linear(y, self.linear, dt)
        mel = torch.where(frame_mask[:, :, None], mel, zero)

        result: Dict[str, Any] = {
            "mel": mel,
            "duration_prediction": adaptor_out["duration_prediction"],
            "duration_rounded": adaptor_out["duration_rounded"],
            "phone_mask": phone_mask,
            "frame_mask": frame_mask,
        }
        for var in cfg.variance.variances:
            result[f"variances_{var}"] = adaptor_out[f"variances_{var}"]
        return result


@torch.no_grad()
def init_weights(model: nn.Module, generator: Optional[torch.Generator] = None) -> None:
    """Seeded initialization from an explicit ``torch.Generator``: uniform
    +-1/sqrt(fan_in) for conv and linear weights and biases (torch's
    default bounds), N(0, 1) for embeddings, ones/zeros for LayerNorm."""
    g = generator if generator is not None else torch.Generator().manual_seed(0)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv1d)):
            fan_in = m.weight[0].numel()
            bound = fan_in ** -0.5
            m.weight.copy_(torch.empty_like(m.weight).uniform_(-bound, bound, generator=g))
            if m.bias is not None:
                m.bias.copy_(torch.empty_like(m.bias).uniform_(-bound, bound, generator=g))
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g))
        elif isinstance(m, LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, SelfAttention):
            bound = m.in_proj_weight.shape[1] ** -0.5
            m.in_proj_weight.copy_(
                torch.empty_like(m.in_proj_weight).uniform_(-bound, bound, generator=g))
            m.in_proj_bias.zero_()


def build_fastspeech2(cfg: ModelConfig, dtype: torch.dtype = torch.float32,
                      device: DeviceLike = None, seed: int = 0,
                      state_dict: Optional[Dict[str, Union[torch.Tensor, Any]]] = None,
                      stats: StatsTree = (), prior_stats: StatsTree = ()) -> FastSpeech2:
    """A model at ``cfg`` with seeded weights, or with ``state_dict`` loaded
    (e.g. from ``utils.convert.from_jax_fastspeech2``), in eval mode."""
    model = FastSpeech2(cfg, stats, prior_stats, dtype, device,
                        torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return model.eval()


def make_dummy_batch(cfg: ModelConfig, batch_size: int = 2, n_phones: int = 32,
                     n_frames: Optional[int] = None, seed: int = 0,
                     fill_frames: bool = False) -> Dict[str, np.ndarray]:
    """Synthetic batch from a seed, as numpy arrays: the JAX package's
    ``make_dummy_batch`` draw for draw (same generator, same order), so
    both packages build identical batches.

    ``fill_frames`` sets the teacher durations the way ``bench.py`` does for
    its training workload: ``n_phones`` valid phones whose durations add up
    to exactly ``n_frames`` (or ``cfg.max_frames``), so every item fills the
    frame bucket."""
    g = np.random.default_rng(seed)
    P = n_phones
    T = n_frames or cfg.max_frames
    phones = np.zeros((batch_size, cfg.max_phones), dtype=np.int32)
    durations = np.zeros((batch_size, cfg.max_phones), dtype=np.int32)
    n_valid = P
    phones[:, :n_valid] = g.integers(1, min(cfg.vocab_size, 50), (batch_size, n_valid))
    per = max(1, min(T, cfg.max_frames) // max(n_valid, 1) - 1)
    durations[:, :n_valid] = per
    batch = {
        "phones": phones,
        "duration": durations,
        "mel": g.standard_normal((batch_size, cfg.max_frames, cfg.audio.n_mels)).astype(
            np.float32),
    }
    for i, var in enumerate(cfg.variance.variances):
        level = cfg.variance.levels[i]
        L = cfg.max_phones if level == "phone" else cfg.max_frames
        if cfg.variance.transforms[i] == "cwt":
            batch[f"variances_{var}_signal"] = np.abs(
                g.standard_normal((batch_size, L))).astype(np.float32) + 5.0
            batch[f"variances_{var}_spectrogram"] = g.standard_normal(
                (batch_size, L, 10)).astype(np.float32)
            batch[f"variances_{var}_mean"] = g.standard_normal(batch_size).astype(np.float32)
            batch[f"variances_{var}_std"] = np.abs(
                g.standard_normal(batch_size)).astype(np.float32)
        else:
            batch[f"variances_{var}"] = g.standard_normal((batch_size, L)).astype(np.float32)
    if cfg.speaker_type == "dvector":
        batch["speaker"] = g.standard_normal((batch_size, cfg.dvector_dim)).astype(np.float32)
    elif cfg.speaker_type == "id":
        batch["speaker"] = g.integers(0, cfg.n_speakers, batch_size).astype(np.int32)
    for prior in cfg.priors:
        batch[f"priors_{prior}"] = g.standard_normal(batch_size).astype(np.float32)
    if fill_frames:
        per, rem = divmod(T, n_valid)
        batch["duration"][:, :n_valid] = per
        batch["duration"][:, :rem] += 1
    return batch
