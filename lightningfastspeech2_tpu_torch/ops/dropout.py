"""Dropout drawn from an explicit ``torch.Generator``, and the int32 seeds
of the kernels' hashed dropouts.

Counterpart of flax's ``nn.Dropout`` as the JAX package uses it outside
its kernels (positional encoding, attention output, the encoder's
attention probabilities, the variance and duration conv layers): keep
with probability ``1 - rate``, kept values divided by ``1 - rate`` in the
input's dtype. ``F.dropout`` cannot take a generator, so the mask is drawn
here with ``torch.rand(..., generator=...)`` on the tensor's device. The
bits differ from JAX's (another generator); the statistics are the same.
"""

from __future__ import annotations

from typing import Optional

import torch


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """``x`` with each element kept with probability ``1 - rate`` (and
    scaled by ``1 / (1 - rate)``), else zeroed. ``rate == 0`` returns ``x``."""
    if rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout with rate > 0 needs a torch.Generator")
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def draw_seed(generator: Optional[torch.Generator], device: torch.device) -> torch.Tensor:
    """A (1,) int32 seed in [0, 2**31 - 1) on ``device``, as the JAX package
    draws ``randint(rng, (), 0, int32 max)`` for each hashed-dropout kernel
    call. It stays on the device: the kernels read it there, so drawing it
    never waits for the card."""
    if generator is None:
        raise ValueError("a hashed-dropout seed needs a torch.Generator")
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                         device=device, dtype=torch.int32)
