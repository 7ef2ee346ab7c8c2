"""Optimizer and learning-rate schedule.

Counterpart of ``lightningfastspeech2_tpu/train/optim.py`` (reference
``litfass/fastspeech2/noam.py``, ``fastspeech2.py:1166-1182``): AdamW with
betas (0.9, 0.98), eps 1e-8 and weight decay 0.01 on every parameter,
under a Noam warm-up schedule stepped per optimizer step, after global-norm
gradient clipping.

``torch.optim.AdamW`` computes optax's ``adamw`` update (eps outside the
square root, decay decoupled and scaled by the learning rate). The clip is
optax's ``clip_by_global_norm`` rule, ``g * c / max(|g|, c)``, not
``clip_grad_norm_``, which adds 1e-6 to the norm.
"""

from __future__ import annotations

from typing import Iterable, List

import torch

from lightningfastspeech2_tpu_torch.core.config import TrainConfig


def noam_lr(base_lr: float, warmup_steps: int, count: int) -> float:
    """lr = base_lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5) with
    s = max(count, 1), ``count`` the number of updates applied so far (the
    count optax's schedule sees)."""
    s = float(max(count, 1))
    return base_lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig) -> torch.optim.AdamW:
    if cfg.bf16_moments:
        raise NotImplementedError("bf16 Adam moments are not ported (not on the flagship)")
    return torch.optim.AdamW(list(params), lr=noam_lr(cfg.lr, cfg.warmup_steps, 0),
                             betas=tuple(cfg.betas), eps=cfg.eps,
                             weight_decay=cfg.weight_decay)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """Scale the gradients in place by ``max_norm / max(norm, max_norm)``."""
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
