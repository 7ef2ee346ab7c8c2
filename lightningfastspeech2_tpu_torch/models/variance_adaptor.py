"""Variance adaptor: duration, pitch/energy/SNR/SRMR prediction and injection.

Counterpart of ``lightningfastspeech2_tpu/models/variance_adaptor.py``. The
duration is predicted by a conv stack, or with ``DurationConfig.stochastic``
by the flow-based ``models/sdp.py`` on the hidden states without their
gradient: its training pass returns the per-item NLL, its inference pass
log-durations drawn from the ``draws`` source, rounded by
``round_durations_stochastic``. In training mode each ``VarianceConvLayer`` ends in dropout
(rates from ``VarianceConfig.dropouts`` and ``DurationConfig.dropout``)
drawn from the forward's generator. Phone-level variance encoders add their embeddings before
length regulation, frame-level ones after. Parameter names follow the
reference torch state dict (``duration_predictor.layers.{i}.layers.0.
module.0`` ..., ``encoders.{var}.embedding``).

Three spots where bits matter:
- bucket boundaries are built like ``jnp.linspace`` in f32
  (``linspace_f32``): one ulp off flips an embedding index;
- the teacher-forced target is de-normalized with one rounding
  (``denormalize``), as XLA contracts ``x * std + mean`` into a fused
  multiply-add: a silent frame's energy comes back exactly at the stats
  minimum, the first boundary, where a second rounding flips its bin;
- ``VariancePredictor`` zeroes rows beyond the batch-wide extent
  (``any`` over the batch), not per item, as the reference does; under a
  batch split over data ranks the extent is the global batch's
  (``parallel/mesh.py batch_any``), as in the JAX package's global step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.audio import cwt as cwt_mod
from lightningfastspeech2_tpu_torch.core.config import DurationConfig, VarianceConfig
from lightningfastspeech2_tpu_torch.models.draws import Draws
from lightningfastspeech2_tpu_torch.models.layers import LayerNorm, linear
from lightningfastspeech2_tpu_torch.models.sdp import StochasticDurationPredictor
from lightningfastspeech2_tpu_torch.ops import length_regulator as lr
from lightningfastspeech2_tpu_torch.parallel.mesh import batch_any
from lightningfastspeech2_tpu_torch.ops.dropout import dropout
from lightningfastspeech2_tpu_torch.ops.depthwise import (
    depthwise_conv1d,
    grouped_conv1d,
    pointwise_conv1d,
)


@dataclass(frozen=True)
class VarianceStats:
    """Corpus statistics for one variance (reference stats.json entries)."""

    min: float = 0.0
    max: float = 1.0
    mean: float = 0.0
    std: float = 1.0


StatsTree = Tuple[Tuple[str, VarianceStats], ...]


def default_stats(variances: Tuple[str, ...]) -> StatsTree:
    return tuple((v, VarianceStats()) for v in variances)


def stats_for(stats: StatsTree, name: str) -> VarianceStats:
    for n, st in stats:
        if n == name:
            return st
    return VarianceStats()


def linspace_f32(lo: float, hi: float, num: int) -> np.ndarray:
    """``jnp.linspace(lo, hi, num)`` bit for bit as XLA computes it inside a
    jitted model, where ``lo`` and ``hi`` are constants: f32 endpoints,
    c = f32(1 / (num - 1)), ``start * (1 - i*c) + i * (stop*c)`` (XLA's
    rewrite of ``start * (1 - step) + stop * step``, no fused multiply-add),
    and the last point set to ``stop``."""
    start, stop = np.float32(lo), np.float32(hi)
    if num == 1:
        return np.asarray([start], np.float32)
    div = num - 1
    c = np.float32(1.0 / div)
    i = np.arange(div, dtype=np.float32)
    out = start * (np.float32(1.0) - i * c) + i * (stop * c)
    return np.concatenate([out, [stop]]).astype(np.float32)


def denormalize(x: torch.Tensor, stats: "VarianceStats") -> torch.Tensor:
    """``x * std + mean`` in f32 with one rounding (a fused multiply-add of
    f32 ``x``, ``std`` and ``mean``: the product is exact in f64)."""
    std, mean = float(np.float32(stats.std)), float(np.float32(stats.mean))
    return (x.double() * std + mean).float()


def bucketize(x: torch.Tensor, boundaries: torch.Tensor) -> torch.Tensor:
    """torch.bucketize with right=False, i.e. searchsorted side='left'."""
    return torch.bucketize(x.float(), boundaries, right=False)


def embed(idx: torch.Tensor, table: nn.Embedding, dtype: torch.dtype) -> torch.Tensor:
    return F.embedding(idx, table.weight.to(dtype))


class _Transpose(nn.Module):
    """Holder that gives the conv the reference's ``layers.0.module`` name."""

    def __init__(self, module: nn.Module):
        super().__init__()
        self.module = module


class VarianceConvLayer(nn.Module):
    """[conv (depthwise-separable or plain, SAME) -> ReLU -> LayerNorm ->
    dropout in training]."""

    def __init__(self, in_ch: int, filter_size: int, kernel_size: int,
                 depthwise: bool, dtype: torch.dtype, dropout: float = 0.5):
        super().__init__()
        self.depthwise, self.dtype, self.dropout = depthwise, dtype, dropout
        if depthwise:
            conv = nn.ModuleList([
                nn.Conv1d(in_ch, in_ch, kernel_size, groups=in_ch),
                nn.Conv1d(in_ch, filter_size, 1),
            ])
        else:
            conv = nn.Conv1d(in_ch, filter_size, kernel_size)
        self.layers = nn.ModuleList([_Transpose(conv), nn.ReLU(),
                                     LayerNorm(filter_size)])

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        conv = self.layers[0].module
        if self.depthwise:
            h = depthwise_conv1d(x.to(dt), conv[0].weight.to(dt), conv[0].bias.to(dt))
            h = pointwise_conv1d(h, conv[1].weight.to(dt), conv[1].bias.to(dt))
        else:
            h = grouped_conv1d(x.to(dt), conv.weight.to(dt), conv.bias.to(dt), 1)
        h = self.layers[2](torch.relu(h), dt)
        return dropout(h, self.dropout, generator) if self.training else h


class VariancePredictor(nn.Module):
    """N conv layers + a linear head to 1 (or 10 CWT scales), masked to 0."""

    def __init__(self, nlayers: int, hidden: int, filter_size: int,
                 kernel_size: int, depthwise: bool, cwt: bool,
                 dtype: torch.dtype, dropout: float = 0.5):
        super().__init__()
        self.cwt, self.dtype = cwt, dtype
        self.layers = nn.ModuleList([
            VarianceConvLayer(hidden if i == 0 else filter_size, filter_size,
                              kernel_size, depthwise, dtype, dropout)
            for i in range(nlayers)
        ])
        self.linear = nn.Linear(filter_size, 10 if cwt else 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """Returns (prediction, last conv output)."""
        extent = None
        if mask is not None:
            # zero rows past the batch-wide extent: the reference's tensors
            # end at the batch-max length, the static bucket goes further
            extent = batch_any(mask)[..., None]
        h = x
        for layer in self.layers:
            h = layer(h, generator)
            if extent is not None:
                h = torch.where(extent, h, torch.zeros((), dtype=h.dtype, device=h.device))
        out = linear(h, self.linear, self.dtype)
        if not self.cwt:
            out = out[..., 0]
        if mask is not None:
            m = mask if not self.cwt else mask[..., None]
            out = torch.where(m, out, torch.zeros((), dtype=out.dtype, device=out.device))
        return out, h


class VarianceEncoder(nn.Module):
    """Predict a variance, bucketize the target (teacher-forced) or the
    prediction into ``nbins`` embeddings. CWT mode predicts 10 scales plus
    the utterance mean/std and recomposes the signal at inference; its bins
    live in the log domain."""

    def __init__(self, nlayers: int, hidden: int, filter_size: int,
                 kernel_size: int, depthwise: bool, stats: VarianceStats,
                 nbins: int, cwt: bool, dtype: torch.dtype, dropout: float = 0.5):
        super().__init__()
        self.stats, self.cwt, self.dtype = stats, cwt, dtype
        lo, hi = stats.min, stats.max
        if cwt:
            lo, hi = np.log(max(lo, 1e-10)), np.log(max(hi, 1e-10))
        self.register_buffer("bins", torch.from_numpy(linspace_f32(lo, hi, nbins - 1)),
                             persistent=False)
        self.predictor = VariancePredictor(nlayers, hidden, filter_size,
                                           kernel_size, depthwise, cwt, dtype, dropout)
        self.embedding = nn.Embedding(nbins, hidden)
        if cwt:
            self.mean_std_linear = nn.Linear(filter_size, 2)

    def forward(self, x: torch.Tensor, tgt: Optional[torch.Tensor],
                mask: Optional[torch.Tensor], control: float = 1.0,
                generator: Optional[torch.Generator] = None):
        dt = self.dtype
        prediction, out_conv = self.predictor(x, mask, generator)
        if self.cwt:
            mean_std = linear(out_conv.mean(1), self.mean_std_linear, dt)
            mean, std = mean_std[:, 0], mean_std[:, 1]
        if tgt is not None:
            if self.cwt:
                tgt_vals = torch.log(torch.clamp(tgt, min=1e-10))
            else:
                tgt_vals = denormalize(tgt, self.stats)
            emb = embed(bucketize(tgt_vals, self.bins), self.embedding, dt)
        else:
            if self.cwt:
                spectrogram = prediction
                prediction = cwt_mod.recompose(prediction, mean, std)
                bucket_prediction = prediction
            else:
                bucket_prediction = prediction * self.stats.std + self.stats.mean
            prediction = prediction * control
            emb = embed(bucketize(bucket_prediction, self.bins), self.embedding, dt)
        if not self.cwt:
            return prediction, emb
        if tgt is not None:
            return {"spectrogram": prediction, "mean": mean, "std": std}, emb
        return ({"reconstructed_signal": torch.exp(prediction),
                 "spectrogram": spectrogram, "mean": mean, "std": std}, emb)


class SpeakerEmbedding(nn.Module):
    """Speaker conditioning (d-vector projection or id table) -> ReLU,
    broadcast over the sequence."""

    def __init__(self, hidden: int, speaker_type: str, n_speakers: int,
                 dvector_dim: int, dtype: torch.dtype):
        super().__init__()
        self.speaker_type, self.dtype = speaker_type, dtype
        if "dvector" in speaker_type:
            self.projection = nn.Linear(dvector_dim, hidden)
        elif speaker_type == "id":
            self.speaker_embedding = nn.Embedding(n_speakers, hidden)
        else:
            raise ValueError(f"SpeakerEmbedding with speaker_type={speaker_type!r}")

    def forward(self, speakers: torch.Tensor, seq_len: int) -> torch.Tensor:
        if "dvector" in self.speaker_type:
            out = linear(speakers, self.projection, self.dtype)
        else:
            out = embed(speakers, self.speaker_embedding, self.dtype)
        out = torch.relu(out)
        return out[:, None, :].expand(out.shape[0], seq_len, out.shape[-1])


class PriorEmbedding(nn.Module):
    """Bucketize a scalar utterance-level prior into an embedding broadcast
    over the sequence."""

    def __init__(self, hidden: int, nbins: int, stats: VarianceStats,
                 dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.register_buffer("bins", torch.from_numpy(
            linspace_f32(stats.min, stats.max, nbins - 1)), persistent=False)
        self.embedding = nn.Embedding(nbins, hidden)

    def forward(self, x: torch.Tensor, seq_len: int) -> torch.Tensor:
        emb = torch.relu(embed(bucketize(x, self.bins), self.embedding, self.dtype))
        return emb[:, None, :].expand(x.shape[0], seq_len, emb.shape[-1])


class VarianceAdaptor(nn.Module):
    """Duration prediction, phone-level variances, length regulation,
    frame-level variances."""

    def __init__(self, cfg: VarianceConfig, duration_cfg: DurationConfig,
                 hidden: int, stats: StatsTree, nbins: int, dtype: torch.dtype):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.stochastic = duration_cfg.stochastic
        if self.stochastic:
            self.duration_predictor = StochasticDurationPredictor(
                hidden, duration_cfg.filter_size, duration_cfg.kernel_size,
                duration_cfg.dropout, duration_cfg.nlayers, dtype)
        else:
            self.duration_predictor = VariancePredictor(
                duration_cfg.nlayers, hidden, duration_cfg.filter_size,
                duration_cfg.kernel_size, duration_cfg.depthwise, False, dtype,
                duration_cfg.dropout)
        self.encoders = nn.ModuleDict({
            var: VarianceEncoder(
                cfg.nlayers[i], hidden, cfg.filter_size, cfg.kernel_sizes[i],
                cfg.depthwise, stats_for(stats, var), nbins,
                cfg.transforms[i] == "cwt", dtype, cfg.dropouts[i])
            for i, var in enumerate(cfg.variances)
        })

    def _rounded(self, duration_pred, phone_mask):
        d = (lr.round_durations_stochastic(duration_pred) if self.stochastic
             else lr.round_durations_deterministic(duration_pred))
        d = torch.where(phone_mask, d, torch.zeros_like(d))
        return lr.rescue_zero_durations(d, phone_mask)

    def forward(self, x: torch.Tensor, phone_mask: torch.Tensor, max_frames: int,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                inference: bool = False, tf: bool = True,
                oracles: Tuple[str, ...] = (),
                controls: Optional[Dict[str, float]] = None,
                duration_only: bool = False,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Draws] = None) -> Dict[str, Any]:
        c = self.cfg
        controls = controls or {}
        result: Dict[str, Any] = {}
        if self.stochastic:
            # the flows see the hidden states without their gradient
            # (model.py:262-267)
            x_det = x.detach()
            if not inference:
                duration_pred = self.duration_predictor(
                    x_det, phone_mask, targets["duration"].to(self.dtype), draws=draws,
                    generator=generator)
            else:
                duration_pred = self.duration_predictor(x_det, phone_mask, reverse=True,
                                                        draws=draws, generator=generator)
                duration_pred = torch.where(phone_mask, duration_pred,
                                            torch.zeros_like(duration_pred))
        else:
            duration_pred, _ = self.duration_predictor(x, phone_mask, generator)

        if duration_only:
            # serving duration pass: the rounded durations pick the frame
            # bucket; nothing after this point changes them
            if not inference:
                raise ValueError("duration_only is an inference-serving path")
            return dict(duration_prediction=duration_pred,
                        duration_rounded=self._rounded(duration_pred, phone_mask))

        out_val = None
        for i, var in enumerate(c.variances):
            if c.levels[i] != "phone":
                continue
            pred, out = self._encode(i, var, x, targets, phone_mask, inference,
                                     tf, oracles, controls.get(var, 1.0), generator)
            result[f"variances_{var}"] = pred
            out_val = out if out_val is None else out_val + out
            x = x + out

        if not inference:
            duration_rounded = targets["duration"].to(torch.int64)
        else:
            duration_rounded = self._rounded(duration_pred, phone_mask)

        x, frame_mask = lr.regulate(x, duration_rounded, max_frames)
        if out_val is not None:
            out_val, _ = lr.regulate(out_val, duration_rounded, max_frames)

        for i, var in enumerate(c.variances):
            if c.levels[i] != "frame":
                continue
            pred, out = self._encode(i, var, x, targets, frame_mask, inference,
                                     tf, oracles, controls.get(var, 1.0), generator)
            result[f"variances_{var}"] = pred
            out_val = out if out_val is None else out_val + out
            x = x + out

        result.update(x=x, duration_prediction=duration_pred,
                      duration_rounded=duration_rounded, frame_mask=frame_mask,
                      out=out_val)
        return result

    def _encode(self, i, var, x, targets, mask, inference, tf, oracles, control,
                generator):
        is_cwt = self.cfg.transforms[i] == "cwt"
        tgt = None
        if (((not inference) and tf) or var in oracles) and targets is not None:
            tgt = targets.get(f"variances_{var}_signal" if is_cwt else f"variances_{var}")
        return self.encoders[var](x, tgt, mask, control, generator)
