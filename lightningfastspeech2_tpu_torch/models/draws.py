"""Where the stochastic modules take their random draws from.

The JAX package draws them from flax's ``make_rng("sdp")``, one stream per
module path: the stochastic duration predictor's noise, the diffusion
predictors' steps and noise, the speaker generator's, and the joint model's
schedule and vocoder draws. That stream cannot be reproduced in PyTorch, so
each random module here takes its draws from a ``Draws`` object the caller
passes, by the module's name:

- ``ModuleStreams(seed)``: one ``torch.Generator`` per module name, seeded
  from ``seed`` and the name, drawing on the CPU and moving the values to
  the device. A request that makes one for each of its two serving passes
  draws the same values in both, and one module's draws never shift
  another's; the card and the CPU get the same values.
- ``HandedDraws(values)``: the values handed in, in the order asked for
  (how the tests feed the port the draws recorded from the JAX package).
"""

from __future__ import annotations

import zlib
from typing import Dict, Iterable, Sequence

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core.device import DeviceLike


class Draws:
    """``normal``, ``uniform`` (in [0, 1)) and ``randint`` (in [0, high))
    tensors of ``shape`` on ``device`` for the module ``name``."""

    def normal(self, name: str, shape: Sequence[int], device: DeviceLike) -> torch.Tensor:
        raise NotImplementedError

    def uniform(self, name: str, shape: Sequence[int], device: DeviceLike) -> torch.Tensor:
        raise NotImplementedError

    def randint(self, name: str, shape: Sequence[int], high: int,
                device: DeviceLike) -> torch.Tensor:
        raise NotImplementedError


class ModuleStreams(Draws):
    """One CPU generator per module name, seeded from (``seed``, name)."""

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._streams: Dict[str, torch.Generator] = {}

    def stream(self, name: str) -> torch.Generator:
        g = self._streams.get(name)
        if g is None:
            mixed = (self.seed * 0x9E3779B1 + zlib.crc32(name.encode())) % (1 << 63)
            g = self._streams[name] = torch.Generator().manual_seed(mixed)
        return g

    def normal(self, name, shape, device):
        return torch.randn(tuple(shape), generator=self.stream(name)).to(device)

    def uniform(self, name, shape, device):
        return torch.rand(tuple(shape), generator=self.stream(name)).to(device)

    def randint(self, name, shape, high, device):
        return torch.randint(0, int(high), tuple(shape), generator=self.stream(name)).to(device)


class HandedDraws(Draws):
    """The values handed in (arrays or tensors), taken in order whatever the
    module; each must have the shape asked for."""

    def __init__(self, values: Iterable):
        self.values = list(values)
        self.taken = 0

    def _next(self, shape, device, dtype) -> torch.Tensor:
        if self.taken >= len(self.values):
            raise IndexError(f"{self.taken + 1} draws asked for, {len(self.values)} handed in")
        v = torch.as_tensor(np.array(self.values[self.taken]))
        self.taken += 1
        if tuple(v.shape) != tuple(shape):
            raise ValueError(f"draw {self.taken}: handed {tuple(v.shape)}, asked {tuple(shape)}")
        return v.to(device=device, dtype=dtype)

    def normal(self, name, shape, device):
        return self._next(shape, device, torch.float32)

    def uniform(self, name, shape, device):
        return self._next(shape, device, torch.float32)

    def randint(self, name, shape, high, device):
        return self._next(shape, device, torch.int64)
