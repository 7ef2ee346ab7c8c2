"""DDPM machinery of the FastDiff vocoder.

Counterpart of ``lightningfastspeech2_tpu/vocoder/diffusion.py``: the
schedules, hyperparameters and the noise-scale -> step mapping are host
numpy, computed once (copied as they stand); the step embedding and the
reverse sampler are PyTorch.

The reverse sampler is a Python loop over the N steps. Its noise (x_T and
one draw per step) comes from an explicit ``torch.Generator``, or is handed
in as tensors, so that a comparison can feed both packages the same draws:
``jax.random`` and ``torch.Generator`` give different numbers from one seed.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device

# hardcoded inference noise schedules (FastDiff.py:158-174)
INFERENCE_SCHEDULES = {
    1000: np.linspace(0.000001, 0.01, 1000),
    200: np.linspace(0.0001, 0.02, 200),
    8: np.array([6.689325005027058e-07, 1.0033881153503899e-05,
                 0.00015496854030061513, 0.002387222135439515,
                 0.035597629845142365, 0.3681158423423767,
                 0.4735414385795593, 0.5]),
    6: np.array([1.7838445955931093e-06, 2.7984189728158526e-05,
                 0.00043231004383414984, 0.006634317338466644,
                 0.09357017278671265, 0.6000000238418579]),
    4: np.array([3.2176e-04, 2.5743e-03, 2.5376e-02, 7.0414e-01]),
    3: np.array([9.0000e-05, 9.0000e-03, 6.0000e-01]),
}


class DiffusionHyperparams(NamedTuple):
    T: int
    beta: np.ndarray
    alpha: np.ndarray  # cumulative sqrt(prod(1-beta))
    sigma: np.ndarray


def linear_beta_schedule(beta_0: float = 1e-6, beta_T: float = 0.01,
                         T: int = 1000) -> np.ndarray:
    return np.linspace(beta_0, beta_T, T)


def compute_hyperparams(beta: np.ndarray) -> DiffusionHyperparams:
    """util.py:276-301: alpha_t = sqrt(prod_{s<=t}(1-beta_s)),
    sigma_t^2 = beta_t * (1-alpha_{t-1}^2)/(1-alpha_t^2)."""
    beta = np.asarray(beta, np.float64)
    T = len(beta)
    alpha = 1.0 - beta
    sigma = beta.copy()
    for t in range(1, T):
        alpha[t] *= alpha[t - 1]
        sigma[t] *= (1 - alpha[t - 1]) / (1 - alpha[t])
    return DiffusionHyperparams(T, beta, np.sqrt(alpha), np.sqrt(sigma))


def map_noise_scale_to_time_step(alpha_infer: float, alpha: np.ndarray) -> float:
    """util.py:305-315: fractional timestep whose cumulative alpha matches."""
    if alpha_infer < alpha[-1]:
        return len(alpha) - 1
    if alpha_infer > alpha[0]:
        return 0
    for t in range(len(alpha) - 1):
        if alpha[t + 1] <= alpha_infer <= alpha[t]:
            return t + (alpha[t] - alpha_infer) / (alpha[t] - alpha[t + 1])
    return -1


class InferenceSchedule(NamedTuple):
    """Per-step constants for the reverse loop."""

    steps: np.ndarray        # fractional timesteps fed to the net
    alpha: np.ndarray        # alpha_infer
    beta: np.ndarray
    sigma: np.ndarray


def make_inference_schedule(
    hp: DiffusionHyperparams, N_or_schedule
) -> InferenceSchedule:
    """Derive the inference schedule host-side (util.py:158-199)."""
    if isinstance(N_or_schedule, int):
        beta_infer = np.asarray(INFERENCE_SCHEDULES[N_or_schedule], np.float64)
    else:
        beta_infer = np.asarray(N_or_schedule, np.float64)
    N = len(beta_infer)
    alpha_infer = 1 - beta_infer
    sigma_infer = beta_infer.copy()
    for n in range(1, N):
        alpha_infer[n] *= alpha_infer[n - 1]
        sigma_infer[n] *= (1 - alpha_infer[n - 1]) / (1 - alpha_infer[n])
    alpha_infer = np.sqrt(alpha_infer)
    sigma_infer = np.sqrt(sigma_infer)

    steps, keep = [], []
    for n in range(N):
        step = map_noise_scale_to_time_step(alpha_infer[n], hp.alpha)
        if step >= 0:
            steps.append(step)
            keep.append(n)
    keep = np.asarray(keep, int)
    return InferenceSchedule(
        steps=np.asarray(steps, np.float32),
        alpha=alpha_infer[keep].astype(np.float32),
        beta=beta_infer[keep].astype(np.float32),
        sigma=sigma_infer[keep].astype(np.float32),
    )


def step_embedding(ts: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal diffusion-step embedding of fractional steps, (B,) ->
    (B, dim) f32 (util.py:318-342: exponent log(10000)/(dim/2 - 1))."""
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=ts.device)
                     * (-math.log(10000.0) / (half - 1)))
    arg = ts.reshape(-1, 1).float() * freq[None, :]
    return torch.cat([torch.sin(arg), torch.cos(arg)], dim=1)


def diffuse(x0: torch.Tensor, ts: torch.Tensor, z: torch.Tensor,
            alpha: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): alpha[ts] * x0 + sqrt(1 - alpha[ts]^2) * z; ts (B,),
    broadcast over trailing dims."""
    a = alpha[ts].reshape((-1,) + (1,) * (x0.dim() - 1)).to(x0.dtype)
    return a * x0 + torch.sqrt(1.0 - a ** 2) * z


def reverse_sample(
    eps_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    shape: Tuple[int, ...],
    schedule: InferenceSchedule,
    generator: Optional[torch.Generator] = None,
    ddim: bool = False,
    x_T: Optional[torch.Tensor] = None,
    noises: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Reverse diffusion x_T -> x_0 (util.py:200-237), f32.

    ``eps_fn(x, ts)`` predicts epsilon; ts is (B,) of the fractional step.
    The noise is ``x_T`` (shape) and ``noises`` (N, *shape), step ``idx``
    of the loop taking ``noises[idx]`` (the last is unused), as the JAX
    sampler takes ``split(fold_in(rng, 1), N)[idx]``; either may be
    omitted, and is then drawn from ``generator`` (by default one seeded 0)
    on ``device`` (by default x_T's where it is a tensor, else ``cuda``
    unless the caller asks for the CPU), x_T first.
    """
    N = len(schedule.steps)
    if device is None and torch.is_tensor(x_T):
        device = x_T.device
    dev = resolve_device(device)
    if x_T is None or (noises is None and not ddim):
        g = generator if generator is not None else torch.Generator(dev).manual_seed(0)
        drawn_x = torch.randn(tuple(shape), generator=g, device=dev)
        drawn_noise = torch.randn((N, *shape), generator=g, device=dev)
        x_T = drawn_x if x_T is None else x_T
        noises = drawn_noise if noises is None else noises
    x = torch.as_tensor(x_T, dtype=torch.float32, device=dev)
    f32 = np.float32
    for idx in range(N):
        n = N - 1 - idx  # reverse order
        # the per-step constants in f32, as the JAX sampler forms them
        alpha, beta = f32(schedule.alpha[n]), f32(schedule.beta[n])
        ts = torch.full((shape[0],), float(schedule.steps[n]), device=dev)
        eps = eps_fn(x, ts).float()
        if ddim:
            with np.errstate(invalid="ignore"):   # sqrt(<0) is nan, as in JAX
                alpha_next = alpha / np.sqrt(f32(1) - beta)
                c1 = alpha_next / alpha
                c2 = -np.sqrt(f32(1) - alpha ** 2) * c1
                c3 = np.sqrt(f32(1) - alpha_next ** 2)
            x = float(c1) * x + float(c2 + c3) * eps
        else:
            x = x - float(beta / np.sqrt(f32(1) - alpha ** 2)) * eps
            x = x / float(np.sqrt(f32(1) - beta))
            if n > 0:
                noise = torch.as_tensor(noises[idx], dtype=torch.float32, device=dev)
                x = x + float(schedule.sigma[n]) * noise
    return x
