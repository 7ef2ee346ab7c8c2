"""Stochastic Weight Averaging.

Counterpart of ``lightningfastspeech2_tpu/train/swa.py`` (reference
``train.py:282-283``, Lightning's StochasticWeightAveraging callback): a
running average of the parameters from ``start_step`` on, every ``every``
steps, served and evaluated while training goes on with the live weights.

The average is kept as detached f32 copies on the parameters' device. They
never alias the live parameters, which the next optimizer step updates in
place.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class SWA:
    def __init__(self, start_step: int = 0, every: int = 1):
        self.start_step = start_step
        self.every = every
        self.n = 0
        self.avg: Optional[Dict[str, torch.Tensor]] = None

    @torch.no_grad()
    def update(self, step: int, params: Dict[str, torch.Tensor]) -> None:
        """``params``: name -> parameter (``dict(model.named_parameters())``)."""
        if step < self.start_step or (step - self.start_step) % self.every:
            return
        if self.avg is None:
            self.avg = {k: p.detach().clone() for k, p in params.items()}
            self.n = 1
            return
        self.n += 1
        w = 1.0 / self.n
        for k, p in params.items():
            a = self.avg[k]
            a.add_((p.detach() - a) * w)

    @property
    def params(self) -> Optional[Dict[str, torch.Tensor]]:
        return self.avg
