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

With ``cfg.train.on_device_features`` a raw-wav batch (a ``wav`` and no
``mel``) gets its features in the step, once a micro-batch, before the
forward (``train/on_device_features.py``), as the JAX step does.

``frozen`` components (variance encoders by name, or ``"duration"`` for the
duration predictor) are left out of the total loss and get no update: their
gradients are dropped (``.grad = None``) before the norm, the clip and the
optimizer, so AdamW neither decays them nor moves their moments. The JAX
package zeroes their gradients and updates instead, which decays their
moments; the parameters agree either way.

With a ``mesh`` whose batch is split over data ranks (parallel/mesh.py),
each rank runs the step on its share of the global batch: the losses are
its share of the global batch's (train/losses.py), the gradients are summed
over the data ranks in one all-reduce of one flat buffer after the
micro-batch loop, and the norm, the clip and the update see the global
gradient, as the JAX package's pjit step over its ``data`` axis. With
``cfg.train.zero1`` the optimizer is torch's ``ZeroRedundancyOptimizer``
around the same AdamW: the moments are sharded over the data ranks
(ZeRO-1), each rank updates its parameters and broadcasts them.
``optimizer_state_dict`` gathers ZeRO-1's shares into a plain AdamW
``state_dict()`` for the checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.optim import ZeroRedundancyOptimizer

from lightningfastspeech2_tpu_torch.core.config import Config
from lightningfastspeech2_tpu_torch.models.draws import Draws
from lightningfastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from lightningfastspeech2_tpu_torch.parallel import mesh as mesh_lib
from lightningfastspeech2_tpu_torch.train.losses import compute_losses
from lightningfastspeech2_tpu_torch.train.on_device_features import maybe_on_device_features
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
    optimizer: torch.optim.Optimizer  # AdamW, or AdamWBf16Mu with bf16 moments
    step: int = 0


def create_train_state(model: FastSpeech2, cfg: Config, mesh=None) -> TrainState:
    """A fresh optimizer for ``model``: ZeRO-1 over the data ranks where
    ``cfg.train.zero1`` is set and the ``mesh`` splits the batch."""
    zero = cfg.train.zero1 and mesh is not None and mesh.sharded
    return TrainState(model, make_optimizer(model.parameters(), cfg.train,
                                            zero_group=mesh.data_group if zero else None), 0)


def optimizer_state_dict(optimizer: torch.optim.Optimizer) -> Optional[Dict[str, Any]]:
    """The optimizer's ``state_dict()`` in AdamW's layout. A ZeRO-1
    optimizer gathers every rank's share to its group's first rank (a
    collective that every rank of the group calls; the others get None):
    the state by global parameter index, on the host, and one param group,
    as a plain AdamW over the same parameters holds it and as ZeRO's own
    ``consolidate_state_dict`` gives it. That method builds each share's
    byte tensor element by element (3.8 s for 64 MB of moments on the CPU,
    4 s a checkpoint on the card); ``gather_object`` moves the same
    pickles at once."""
    if not isinstance(optimizer, ZeroRedundancyOptimizer):
        return optimizer.state_dict()
    import torch.distributed as dist

    index = {id(p): i for i, p in enumerate(p for g in optimizer.param_groups
                                            for p in g["params"])}
    local = optimizer.optim
    ids = [index[id(p)] for g in local.param_groups for p in g["params"]]
    share = {ids[k]: {n: v.cpu() if torch.is_tensor(v) else v for n, v in st.items()}
             for k, st in local.state_dict()["state"].items()}
    group = optimizer.process_group
    dst = dist.get_global_rank(group, 0)
    first = dist.get_rank() == dst
    shares = [None] * dist.get_world_size(group) if first else None
    dist.gather_object(share, shares, dst=dst, group=group)
    if not first:
        return None
    assert len(local.param_groups) == 1, "one param group, as make_optimizer builds"
    hyper = {k: v for k, v in local.param_groups[0].items() if k != "params"}
    state = {i: st for s in shares for i, st in s.items()}
    return {"state": dict(sorted(state.items())),
            "param_groups": [{**hyper, "params": list(range(len(index)))}]}


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


def make_train_step(model: FastSpeech2, cfg: Config, mesh=None) -> Callable:
    """Returns ``step(state, batch, generator, tf=True, frozen=(), draws=None,
    schedule_p=None) -> (state, metrics)``. ``metrics`` holds every loss
    (0-dim tensors on the model's device) and ``grad_norm``, the global norm
    after the frozen gradients are dropped and before clipping. ``draws``
    feeds the stochastic modules (``models/draws.py``; the model's default
    where None); ``schedule_p`` is the joint model's probability of
    conditioning the vocoder on the predicted mel. Under a ``mesh`` that
    splits the batch, ``batch`` is this rank's share and the metrics are
    the global batch's."""
    sharded = mesh is not None and mesh.sharded

    def step(state: TrainState, batch: Batch, generator: torch.Generator,
             tf: bool = True, frozen: Tuple[str, ...] = (), draws: Optional[Draws] = None,
             schedule_p: Optional[float] = None):
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
        kwargs = {} if schedule_p is None else {"schedule_p": schedule_p}
        for mb in micro:
            mb = maybe_on_device_features(m, cfg, mb)
            with mesh_lib.global_batch(mesh):
                out = m(mb, tf=tf, generator=generator, draws=draws, **kwargs)
            losses = compute_losses(out, mb, cfg, frozen, mesh=mesh)
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
        if sharded:
            _sum_over_ranks(mesh, grads, metrics)
        norm = global_norm(grads)
        metrics["grad_norm"] = norm
        clip_by_global_norm_(grads, cfg.train.grad_clip, norm)
        for group in state.optimizer.param_groups:
            group["lr"] = noam_lr(cfg.train.lr, cfg.train.warmup_steps, state.step)
        state.optimizer.step()
        state.step += 1
        return state, metrics

    return step


def _sum_over_ranks(mesh, grads, metrics: Dict[str, torch.Tensor]) -> None:
    """The gradients and the metrics summed over the data ranks, in place:
    one all-reduce of one flat f32 buffer (the gradients, then the
    metrics)."""
    keys, device = list(metrics), grads[0].device
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [torch.stack([torch.as_tensor(metrics[k], dtype=torch.float32, device=device)
                                     for k in keys])])
    mesh.sum(flat)
    offset = 0
    for g in grads:
        g.copy_(flat[offset: offset + g.numel()].view_as(g))
        offset += g.numel()
    for k, v in zip(keys, flat[offset:].unbind()):
        metrics[k] = v


def make_eval_step(model: FastSpeech2, cfg: Config, mesh=None) -> Callable:
    """Returns ``step(batch) -> (losses, out, out_inf, feat_batch)``: the
    teacher-forced loss pass and a free-running (inference) forward, both in
    eval mode and without gradients, through the serving kernels (reference
    ``validation_step``, ``fastspeech2.py:799-827``), and the batch on the
    model's device after on-device feature extraction (the input's tensors
    where it is off), where a raw-wav batch's ``mel`` and ``variances_*``
    targets are read. Under a ``mesh`` that splits the batch the losses are
    the global batch's (one all-reduce); the outputs are this rank's."""

    @torch.no_grad()
    def step(batch: Batch):
        was_training = model.training
        model.eval()
        try:
            b = maybe_on_device_features(model, cfg, to_device(batch, model.device))
            with mesh_lib.global_batch(mesh):
                out = model(b)
                out_inf = model(b, inference=True)
            losses = compute_losses(out, b, cfg, mesh=mesh)
            if mesh is not None and mesh.sharded:
                keys = list(losses)
                summed = mesh.sum(torch.stack([torch.as_tensor(losses[k], dtype=torch.float32,
                                                                device=model.device)
                                               for k in keys]))
                losses = dict(zip(keys, summed.unbind()))
        finally:
            model.train(was_training)
        return losses, out, out_inf, b

    return step
