"""Diffusion-based variance adaptor and speaker generator.

Counterpart of ``lightningfastspeech2_tpu/models/fastdiff_variances.py``
(reference ``litfass/fastspeech2/fastdiff_variances.py``):

- ``FastDiffVariancePredictor``: a conv stack conditioned on the hidden
  states, the noised target and a step embedding; training predicts the
  noise z at a random step, inference runs the N-step reverse sampler
  (``vocoder/diffusion.py reverse_sample``) over a frame-level signal.
- ``FastDiffVarianceAdaptor``: the duration through the same diffusion
  predictor on the normalized log-duration ``(log(d + 1 + U[0, 0.49]) -
  1.08) / 0.96`` (``fastdiff_variances.py:90-91``), then length regulation
  and per-variance diffusion predictors whose teacher (training) or sampled
  (inference) values are bucketized into embeddings.
- ``FastDiffSpeakerGenerator``: an MLP diffusion model (hidden 512)
  denoising utterance d-vectors conditioned on the speaker-mean d-vector
  (``fastdiff_variances.py:344-525``).

The losses pair each ``*_pred`` with its ``*_z`` noise target under MSE
(``train/losses.py``). Every random draw (steps, noise, the duration
dequantization) comes from a ``Draws`` source (``models/draws.py``) under the
module's name, in the JAX package's order: the adaptor's ``uniform``, then
per signal ``randint`` and ``normal``; the sampler's x_T, then one noise a
step.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from lightningfastspeech2_tpu_torch.core.config import DurationConfig, VarianceConfig
from lightningfastspeech2_tpu_torch.models.draws import Draws
from lightningfastspeech2_tpu_torch.models.layers import linear
from lightningfastspeech2_tpu_torch.models.variance_adaptor import (
    StatsTree,
    VarianceConvLayer,
    bucketize,
    denormalize,
    embed,
    linspace_f32,
    stats_for,
)
from lightningfastspeech2_tpu_torch.ops import length_regulator as lr
from lightningfastspeech2_tpu_torch.vocoder import diffusion
from lightningfastspeech2_tpu_torch.vocoder.fastdiff import swish

DUR_LOG_MEAN = 1.08
DUR_LOG_STD = 0.96


class _StepEmbedding(nn.Module):
    """Sinusoidal step embedding through two swish Linears (``fc_t1``,
    ``fc_t2``) and a projection (``linear_noise``) to ``out_dim``."""

    def __init__(self, out_dim: int, dim_in: int = 128, dim_mid: int = 512,
                 dim_out: int = 512):
        super().__init__()
        self.dim_in = dim_in
        self.fc_t1 = nn.Linear(dim_in, dim_mid)
        self.fc_t2 = nn.Linear(dim_mid, dim_out)
        self.linear_noise = nn.Linear(dim_out, out_dim)

    def step_embed(self, ts: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
        emb = diffusion.step_embedding(ts, self.dim_in)
        emb = swish(linear(emb, self.fc_t1, dt))
        emb = swish(linear(emb, self.fc_t2, dt))
        return linear(emb, self.linear_noise, dt)


class FastDiffVariancePredictor(_StepEmbedding):
    """ε-predictor over a frame- or phone-level scalar signal
    (fastdiff_variances.py:147-235): (signal (B, T), cond (B, T, H), steps
    (B,), mask) -> ε (B, T), 0 where the mask is False."""

    def __init__(self, nlayers: int, hidden: int, filter_size: int, kernel_size: int,
                 dropout: float, depthwise: bool, dtype: torch.dtype = torch.float32):
        super().__init__(hidden)
        self.dtype = dtype
        self.linear_in = nn.Linear(1, hidden)
        self.layers = nn.ModuleList([
            VarianceConvLayer(hidden if i == 0 else filter_size, filter_size, kernel_size,
                              depthwise, dtype, dropout)
            for i in range(nlayers)])
        self.linear = nn.Linear(filter_size, 1)

    def forward(self, signal, cond, ts, mask=None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        dt = self.dtype
        noise_embed = self.step_embed(ts, dt)
        h = linear(signal[..., None], self.linear_in, dt) + cond + noise_embed[:, None, :]
        for layer in self.layers:
            h = layer(h, generator)
        out = linear(h, self.linear, dt)[..., 0]
        if mask is not None:
            out = torch.where(mask, out, torch.zeros((), dtype=out.dtype, device=out.device))
        return out


class _DiffusionSignal:
    """The scalar-signal diffusion's schedule (T steps, betas 1e-6..0.01),
    its training noise and its N-step sampler."""

    def __init__(self, T: int = 1000, beta_0: float = 1e-6, beta_T: float = 0.01):
        self.hp = diffusion.compute_hyperparams(
            diffusion.linear_beta_schedule(beta_0, beta_T, T))
        self._alpha = torch.from_numpy(np.asarray(self.hp.alpha, np.float32))

    def noise(self, signal: torch.Tensor, draws: Draws, name: str):
        """(noisy, z, ts as f32): a step in [0, T) per item, then z."""
        B = signal.shape[0]
        ts = draws.randint(name, (B,), self.hp.T, signal.device)
        z = draws.normal(name, tuple(signal.shape), signal.device)
        noisy = diffusion.diffuse(signal, ts, z, self._alpha.to(signal.device))
        return noisy, z, ts.float()

    def sample(self, eps_fn, shape, steps: int, draws: Draws, name: str,
               device: torch.device) -> torch.Tensor:
        schedule = diffusion.make_inference_schedule(self.hp, steps)
        x_T = draws.normal(name, tuple(shape), device)
        noises = torch.stack([draws.normal(name, tuple(shape), device)
                              for _ in range(len(schedule.steps))])
        return diffusion.reverse_sample(eps_fn, tuple(shape), schedule, x_T=x_T,
                                        noises=noises, device=device)


class FastDiffVarianceAdaptor(nn.Module):
    """Frame-level adaptor with diffusion predictors
    (fastdiff_variances.py:8-144). In training each signal's result is its
    noise prediction with the noise ``*_z`` beside it; in inference the
    sampled signal (``*_z`` None)."""

    name = "variance_adaptor"   # its draws' stream

    def __init__(self, cfg: VarianceConfig, duration_cfg: DurationConfig, hidden: int,
                 stats: StatsTree, nbins: int = 256, inference_steps: int = 4,
                 T: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        if any(level != "frame" for level in cfg.levels):
            raise ValueError("the diffusion variance adaptor takes frame-level variances only")
        self.cfg, self.dtype = cfg, dtype
        self.inference_steps, self.T = inference_steps, T
        self.stats = {var: stats_for(stats, var) for var in cfg.variances}
        self.duration_predictor = FastDiffVariancePredictor(
            duration_cfg.nlayers, hidden, cfg.filter_size, duration_cfg.kernel_size,
            duration_cfg.dropout, cfg.depthwise, dtype)
        self.predictors = nn.ModuleDict({
            var: FastDiffVariancePredictor(cfg.nlayers[i], hidden, cfg.filter_size,
                                           cfg.kernel_sizes[i], cfg.dropouts[i],
                                           cfg.depthwise, dtype)
            for i, var in enumerate(cfg.variances)})
        self.embeddings = nn.ModuleDict({var: nn.Embedding(nbins, hidden)
                                         for var in cfg.variances})
        for var in cfg.variances:
            st = self.stats[var]
            self.register_buffer(f"bins_{var}",
                                 torch.from_numpy(linspace_f32(st.min, st.max, nbins - 1)),
                                 persistent=False)

    def forward(self, x: torch.Tensor, phone_mask: torch.Tensor, max_frames: int,
                targets: Optional[Dict[str, torch.Tensor]] = None,
                inference: bool = False, duration_only: bool = False,
                draws: Optional[Draws] = None,
                generator: Optional[torch.Generator] = None) -> Dict[str, Any]:
        dt, name = self.dtype, self.name
        result: Dict[str, Any] = {}
        diff = _DiffusionSignal(self.T)

        if not inference:
            dur = targets["duration"]
            u = draws.uniform(name, tuple(dur.shape), x.device) * 0.49
            dur_target = (torch.log(dur.float() + 1.0 + u) - DUR_LOG_MEAN) / DUR_LOG_STD
            noisy, z, ts = diff.noise(dur_target, draws, name)
            duration_pred = self.duration_predictor(noisy, x, ts, phone_mask, generator)
            result["duration_z"] = z
            duration_rounded = dur.to(torch.int64)
        else:
            raw = diff.sample(
                lambda sig, ts: self.duration_predictor(sig, x, ts, phone_mask),
                x.shape[:2], self.inference_steps, draws, name, x.device)
            duration_pred = raw
            rounded = torch.clamp(torch.round(torch.exp(raw * DUR_LOG_STD + DUR_LOG_MEAN) - 1.0),
                                  min=0.0).to(torch.int64)
            rounded = torch.where(phone_mask, rounded, torch.zeros_like(rounded))
            duration_rounded = lr.rescue_zero_durations(rounded, phone_mask)
            result["duration_z"] = None

        if duration_only:
            # the serving duration pass: nothing after this changes them
            if not inference:
                raise ValueError("duration_only is an inference-serving path")
            return dict(duration_prediction=duration_pred, duration_rounded=duration_rounded)

        x, frame_mask = lr.regulate(x, duration_rounded, max_frames)
        out_val = None
        for var in self.cfg.variances:
            predictor, st = self.predictors[var], self.stats[var]
            bins = getattr(self, f"bins_{var}")
            if not inference:
                tgt = targets[f"variances_{var}"][:, : x.shape[1]]
                noisy, z, ts = diff.noise(tgt, draws, name)
                result[f"variances_{var}"] = predictor(noisy, x, ts, frame_mask, generator)
                result[f"variances_{var}_z"] = z
                value = tgt
            else:
                value = diff.sample(lambda sig, ts: predictor(sig, x, ts, frame_mask),
                                    x.shape[:2], self.inference_steps, draws, name, x.device)
                result[f"variances_{var}"] = value
                result[f"variances_{var}_z"] = None
            emb = embed(bucketize(denormalize(value, st), bins), self.embeddings[var], dt)
            out_val = emb if out_val is None else out_val + emb
            x = x + emb

        result.update(x=x, duration_prediction=duration_pred,
                      duration_rounded=duration_rounded, frame_mask=frame_mask, out=out_val)
        return result


class FastDiffSpeakerPredictor(_StepEmbedding):
    """ε-predictor over d-vectors conditioned on the speaker mean
    (fastdiff_variances.py:390-480)."""

    def __init__(self, hidden_dim: int, c_dim: int, speaker_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(speaker_dim)
        self.dtype = dtype
        self.conditional_in = nn.Linear(c_dim, speaker_dim)
        self.mlp0 = nn.Linear(speaker_dim, hidden_dim)
        self.mlp1 = nn.Linear(hidden_dim, hidden_dim)
        self.linear_out = nn.Linear(hidden_dim, speaker_dim)

    def forward(self, x, c, ts) -> torch.Tensor:
        dt = self.dtype
        h = x + linear(c, self.conditional_in, dt) + self.step_embed(ts, dt)
        h = torch.relu(linear(h, self.mlp0, dt))
        h = torch.relu(linear(h, self.mlp1, dt))
        return linear(h, self.linear_out, dt)


class FastDiffSpeakerGenerator(nn.Module):
    """Utterance d-vectors from a speaker-mean d-vector by denoising
    (fastdiff_variances.py:344-388): training returns (ε prediction, z) for
    a noised ``utterance_dvec``; inference samples one from the mean."""

    name = "fastdiff_speaker_generator"   # its draws' stream

    def __init__(self, hidden_dim: int = 512, c_dim: int = 256, speaker_dim: int = 256,
                 inference_steps: int = 4, T: int = 1000, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.inference_steps, self.T = inference_steps, T
        self.predictor = FastDiffSpeakerPredictor(hidden_dim, c_dim, speaker_dim, dtype)

    def forward(self, speaker_mean, utterance_dvec=None, inference: bool = False,
                draws: Optional[Draws] = None):
        diff = _DiffusionSignal(self.T)
        if inference:
            return diff.sample(lambda x, ts: self.predictor(x, speaker_mean, ts),
                               speaker_mean.shape, self.inference_steps, draws, self.name,
                               speaker_mean.device)
        noisy, z, ts = diff.noise(utterance_dvec, draws, self.name)
        return self.predictor(noisy, speaker_mean, ts), z
