"""Optimizer and learning-rate schedule.

Counterpart of ``lightningfastspeech2_tpu/train/optim.py`` (reference
``litfass/fastspeech2/noam.py``, ``fastspeech2.py:1166-1182``): AdamW with
betas (0.9, 0.98), eps 1e-8 and weight decay 0.01 on every parameter,
under a Noam warm-up schedule stepped per optimizer step, after global-norm
gradient clipping.

``torch.optim.AdamW`` computes optax's ``adamw`` update (eps outside the
square root, decay decoupled and scaled by the learning rate). With
``TrainConfig.bf16_moments`` the optimizer is ``AdamWBf16Mu``, optax's
``adamw(mu_dtype=bfloat16)``: the first moment stored in bf16. The clip is
optax's ``clip_by_global_norm`` rule, ``g * c / max(|g|, c)``, not
``clip_grad_norm_``, which adds 1e-6 to the norm.
"""

from __future__ import annotations

from typing import Dict, Iterable, List

import numpy as np
import torch

from lightningfastspeech2_tpu_torch.core.config import TrainConfig


def noam_lr(base_lr: float, warmup_steps: int, count: int) -> float:
    """lr = base_lr * warmup^0.5 * min(s^-0.5, s * warmup^-1.5) with
    s = max(count, 1), ``count`` the number of updates applied so far (the
    count optax's schedule sees)."""
    s = float(max(count, 1))
    return base_lr * warmup_steps ** 0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)


class AdamWBf16Mu(torch.optim.Optimizer):
    """AdamW with its first moment stored in bf16, as optax's
    ``adamw(mu_dtype=jnp.bfloat16)`` computes it: mu = (1 - b1) g + b1 mu_old
    in f32, the decay product taken in bf16 (optax's weak-typed ``b1 * mu``
    on the bf16 moment); nu in f32; the bias-corrected update and the
    decoupled weight decay in f32; mu stored rounded to bf16.

    Each step runs as ``torch._foreach_*`` calls over the parameters that
    share a step count (a few multi-tensor launches each on the card, not a
    launch per parameter), with the bias corrections formed on the host as
    f32 scalars."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, betas, eps: float,
                 weight_decay: float):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            by_step: Dict[int, List[torch.nn.Parameter]] = {}
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = 0
                    st["exp_avg"] = torch.zeros_like(p, dtype=torch.bfloat16)
                    st["exp_avg_sq"] = torch.zeros_like(p, dtype=torch.float32)
                st["step"] += 1
                by_step.setdefault(st["step"], []).append(p)
            for n, ps in by_step.items():
                # 1 - b^n in f32, as optax's bias correction
                bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(n))
                bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(n))
                self._update(ps, group, bc1, bc2)

    def _update(self, ps: List[torch.nn.Parameter], group: dict, bc1: float, bc2: float) -> None:
        b1, b2 = group["betas"]
        lr, eps, wd = group["lr"], group["eps"], group["weight_decay"]
        mus = [self.state[p]["exp_avg"] for p in ps]
        nus = [self.state[p]["exp_avg_sq"] for p in ps]
        g = [p.grad.float() for p in ps]
        # b1 mu_old in bf16 (b1 rounded to bf16, the product rounded once)
        decayed = torch._foreach_mul(mus, _bf16(b1))
        mu = [torch.empty_like(m, dtype=torch.float32) for m in mus]
        torch._foreach_copy_(mu, decayed)
        g1 = torch._foreach_mul(g, 1 - b1)
        torch._foreach_add_(mu, g1)
        torch._foreach_mul_(nus, b2)
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - b2)
        torch._foreach_add_(nus, g2)
        torch._foreach_copy_(mus, mu)
        # update = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p, scaled by -lr
        den = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, eps)
        torch._foreach_div_(mu, bc1)
        torch._foreach_div_(mu, den)
        decay = torch._foreach_mul([p.float() for p in ps], wd)
        torch._foreach_add_(mu, decay)
        torch._foreach_mul_(mu, -lr)
        torch._foreach_add_(ps, [u.to(p.dtype) for u, p in zip(mu, ps)])


def _bf16(x: float) -> float:
    """``x`` rounded to bf16, as a Python float."""
    return float(torch.tensor(x, dtype=torch.bfloat16))


def make_optimizer(params: Iterable[torch.nn.Parameter], cfg: TrainConfig,
                   zero_group=None) -> torch.optim.Optimizer:
    """AdamW (``AdamWBf16Mu`` with ``cfg.bf16_moments``); with a
    ``zero_group`` (a process group) torch's ``ZeroRedundancyOptimizer``
    around it, each rank of the group holding the moments of its share of
    the parameters (ZeRO-1)."""
    kwargs = dict(lr=noam_lr(cfg.lr, cfg.warmup_steps, 0), betas=tuple(cfg.betas),
                  eps=cfg.eps, weight_decay=cfg.weight_decay)
    cls = AdamWBf16Mu if cfg.bf16_moments else torch.optim.AdamW
    if zero_group is not None:
        from torch.distributed.optim import ZeroRedundancyOptimizer

        return ZeroRedundancyOptimizer(list(params), optimizer_class=cls,
                                       process_group=zero_group, **kwargs)
    return cls(list(params), **kwargs)


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every gradient, in f32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """Scale the gradients in place by ``max_norm / max(norm, max_norm)``."""
    scale = max_norm / torch.clamp(norm, min=max_norm)
    for g in grads:
        g.mul_(scale.to(g.dtype))
