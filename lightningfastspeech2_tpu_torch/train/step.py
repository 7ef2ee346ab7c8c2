"""Training and eval steps.

Counterpart of ``lightningfastspeech2_tpu/train/step.py``
(``create_train_state``, ``make_train_step``, ``make_eval_step``). There the
step is one jitted program; here it runs eagerly: the model in training
mode, teacher forced, every dropout and kernel seed drawn from an explicit
``torch.Generator`` on the model's device, then one AdamW update.

Parameters stay f32; the model's working dtype (flax's ``dtype``, e.g.
bf16) is fixed at construction, and no autocast is used.

A batch whose ``phones`` carry a leading micro-batch axis (A, B, P) means
gradient accumulation: gradients and losses are averaged over the A
micro-batches before the update, each micro-batch drawing its own dropout.

``frozen`` components (variance encoders by name, or ``"duration"`` for the
duration predictor) are left out of the total loss and get no update: their
gradients are dropped (``.grad = None``) before the norm, the clip and the
optimizer, so AdamW neither decays them nor moves their moments. The JAX
package zeroes their gradients and updates instead, which decays their
moments; the parameters agree either way.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Tuple

import torch

from lightningfastspeech2_tpu_torch.core.config import Config
from lightningfastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from lightningfastspeech2_tpu_torch.train.losses import compute_losses
from lightningfastspeech2_tpu_torch.train.optim import (
    clip_by_global_norm_,
    global_norm,
    make_optimizer,
    noam_lr,
)

Batch = Mapping[str, Any]


@dataclass
class TrainState:
    """The model (parameters), its optimizer (moments) and the number of
    updates applied. The step updates them in place and returns the state."""

    model: FastSpeech2
    optimizer: torch.optim.AdamW
    step: int = 0


def create_train_state(model: FastSpeech2, cfg: Config) -> TrainState:
    return TrainState(model, make_optimizer(model.parameters(), cfg.train), 0)


def to_device(batch: Batch, device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def is_frozen(name: str, frozen: Tuple[str, ...]) -> bool:
    """Whether parameter ``name`` belongs to a frozen component: the
    variance encoder of that name, or the duration predictor for
    ``"duration"`` (the JAX package's ``_zero_frozen_leaf``)."""
    return any(name.startswith(f"variance_adaptor.encoders.{c}.")
               or (c == "duration" and name.startswith("variance_adaptor.duration_predictor."))
               for c in frozen)


def make_train_step(model: FastSpeech2, cfg: Config) -> Callable:
    """Returns ``step(state, batch, generator, tf=True, frozen=()) ->
    (state, metrics)``. ``metrics`` holds every loss (0-dim tensors on the
    model's device) and ``grad_norm``, the global norm after the frozen
    gradients are dropped and before clipping."""

    def step(state: TrainState, batch: Batch, generator: torch.Generator,
             tf: bool = True, frozen: Tuple[str, ...] = ()):
        m = model  # the module whose parameters ``state`` was created for
        batch = to_device(batch, m.device)
        m.train()
        state.optimizer.zero_grad(set_to_none=True)
        if batch["phones"].dim() == 3:
            n = batch["phones"].shape[0]
            micro = [{k: v[i] for k, v in batch.items()} for i in range(n)]
        else:
            n, micro = 1, [batch]
        sums: Dict[str, torch.Tensor] = {}
        for mb in micro:
            losses = compute_losses(m(mb, tf=tf, generator=generator), mb, cfg, frozen)
            (losses["total"] / n).backward()
            for key, value in losses.items():
                v = value.detach() if torch.is_tensor(value) else torch.tensor(value)
                sums[key] = sums[key] + v if key in sums else v
        metrics = {k: v / n for k, v in sums.items()}

        params = []
        for name, p in m.named_parameters():
            if is_frozen(name, frozen):
                p.grad = None
                continue
            if p.grad is None:  # unused this step: a zero gradient, as in JAX
                p.grad = torch.zeros_like(p)
            params.append(p)
        grads = [p.grad for p in params]
        norm = global_norm(grads)
        metrics["grad_norm"] = norm
        clip_by_global_norm_(grads, cfg.train.grad_clip, norm)
        for group in state.optimizer.param_groups:
            group["lr"] = noam_lr(cfg.train.lr, cfg.train.warmup_steps, state.step)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def make_eval_step(model: FastSpeech2, cfg: Config) -> Callable:
    """Returns ``step(batch) -> (losses, out, out_inf)``: the teacher-forced
    loss pass and a free-running (inference) forward, both in eval mode and
    without gradients, through the serving kernels (reference
    ``validation_step``, ``fastspeech2.py:799-827``)."""

    @torch.no_grad()
    def step(batch: Batch):
        was_training = model.training
        model.eval()
        try:
            b = to_device(batch, model.device)
            out = model(b)
            losses = compute_losses(out, b, cfg)
            out_inf = model(b, inference=True)
        finally:
            model.train(was_training)
        return losses, out, out_inf

    return step
