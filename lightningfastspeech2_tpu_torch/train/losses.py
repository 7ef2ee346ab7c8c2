"""FastSpeech2 training losses.

Counterpart of ``lightningfastspeech2_tpu/train/losses.py`` (reference
``litfass/fastspeech2/loss.py``): masked means over valid positions (the
reference's ``masked_select(...).mean()``), per-variance losses (a CWT
variance gives the ``_cwt``, ``_mean`` and ``_std`` triplet), the mel loss,
the duration loss on ``log(d + 1)``, and ``total`` weighted as
``fastspeech2.py:461-473`` with frozen components left out.

The ``soft_dtw`` losses and the FastDiff branches are later slices of the
port and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from lightningfastspeech2_tpu_torch.core.config import Config


def masked_mean_loss(pred: torch.Tensor, truth: torch.Tensor, mask: torch.Tensor,
                     kind: str) -> torch.Tensor:
    """Mean elementwise loss over valid positions. ``mask`` broadcasts
    against the loss (trailing feature dims averaged in)."""
    if kind == "mse":
        elt = torch.square(pred - truth)
    elif kind == "l1":
        elt = torch.abs(pred - truth)
    elif kind == "soft_dtw":
        raise NotImplementedError(
            "the soft-DTW loss is a later slice of the port (ops/pallas_soft_dtw.py)")
    else:
        raise ValueError(f"unknown loss kind {kind}")
    while mask.dim() < elt.dim():
        mask = mask[..., None]
    mask = mask.expand(elt.shape)
    total = torch.where(mask, elt, torch.zeros((), dtype=elt.dtype, device=elt.device)).sum()
    return total / torch.clamp(mask.sum(), min=1)


def compute_losses(result: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: Config,
                   frozen_components: Tuple[str, ...] = ()) -> Dict[str, torch.Tensor]:
    """Per-component losses and the weighted ``total``."""
    mcfg, vcfg, tcfg = cfg.model, cfg.model.variance, cfg.train
    if mcfg.fastdiff_variances or mcfg.duration.stochastic:
        raise NotImplementedError(
            "FastDiff and stochastic-duration losses are later slices of the port")
    losses: Dict[str, torch.Tensor] = {}
    phone_mask, frame_mask = result["phone_mask"], result["frame_mask"]

    for i, var in enumerate(vcfg.variances):
        mask = phone_mask if vcfg.levels[i] == "phone" else frame_mask
        kind = vcfg.losses[i]
        if vcfg.transforms[i] == "cwt":
            out = result[f"variances_{var}"]
            losses[f"{var}_cwt"] = masked_mean_loss(
                out["spectrogram"], batch[f"variances_{var}_spectrogram"], mask, kind)
            losses[f"{var}_mean"] = torch.mean(
                torch.square(out["mean"] - batch[f"variances_{var}_mean"]))
            losses[f"{var}_std"] = torch.mean(
                torch.square(out["std"] - batch[f"variances_{var}_std"]))
        else:
            pred = result[f"variances_{var}"]
            truth = batch[f"variances_{var}"]
            if vcfg.levels[i] == "frame":
                truth = truth[:, : pred.shape[1]]
            losses[var] = masked_mean_loss(pred, truth, mask, kind)

    mel = result["mel"]
    losses["mel"] = masked_mean_loss(mel, batch["mel"][:, : mel.shape[1]], frame_mask,
                                     tcfg.mel_loss)
    log_d = torch.log(batch["duration"].float() + 1.0)
    losses["duration"] = masked_mean_loss(result["duration_prediction"], log_d, phone_mask,
                                          mcfg.duration.loss)

    weights: Dict[str, float] = {"mel": tcfg.mel_loss_weight,
                                 "duration": mcfg.duration.loss_weight}
    for i, var in enumerate(vcfg.variances):
        for key in (var, f"{var}_cwt", f"{var}_mean", f"{var}_std"):
            weights[key] = vcfg.loss_weights[i]
    total = 0.0
    for key, value in losses.items():
        if any(f in key for f in frozen_components):
            continue
        total = total + weights.get(key, 1.0) * value
    losses["total"] = total
    return losses
