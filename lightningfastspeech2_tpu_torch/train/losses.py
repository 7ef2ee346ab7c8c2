"""FastSpeech2 training losses.

Counterpart of ``lightningfastspeech2_tpu/train/losses.py`` (reference
``litfass/fastspeech2/loss.py``): masked means over valid positions (the
reference's ``masked_select(...).mean()``), per-variance losses (a CWT
variance gives the ``_cwt``, ``_mean`` and ``_std`` triplet), the mel loss,
the duration loss on ``log(d + 1)``, and ``total`` weighted as
``fastspeech2.py:461-473`` with frozen components left out.

A ``soft_dtw`` loss (the mel loss, a CWT variance's ``_cwt`` term or a
scalar variance) is ``soft_dtw_loss``: soft-DTW (``ops/soft_dtw.py``) summed
over items and over chunks of ``soft_dtw_chunk_size`` frames, like the
reference (loss.py:69-78). With ``fastdiff_variances`` each diffusion
variance and the duration are the MSE of the noise prediction against its
z; the stochastic duration predictor's loss is its NLL summed over items;
the joint vocoder adds ``fastdiff`` (ε-MSE over ``wav_mask``, weight 0.1)
and the speaker generator ``speakers`` (MSE, weight 1).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from lightningfastspeech2_tpu_torch.core.config import Config
from lightningfastspeech2_tpu_torch.ops.soft_dtw import soft_dtw_batch


def masked_sum(pred: torch.Tensor, truth: torch.Tensor, mask: torch.Tensor,
               kind: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The elementwise loss summed over valid positions, and their count
    (``mask`` broadcasts against the loss; trailing feature dims count)."""
    if kind == "mse":
        elt = torch.square(pred - truth)
    elif kind == "l1":
        elt = torch.abs(pred - truth)
    else:
        raise ValueError(f"unknown loss kind {kind}")
    while mask.dim() < elt.dim():
        mask = mask[..., None]
    mask = mask.expand(elt.shape)
    total = torch.where(mask, elt, torch.zeros((), dtype=elt.dtype, device=elt.device)).sum()
    return total, mask.sum()


def masked_mean_loss(pred: torch.Tensor, truth: torch.Tensor, mask: torch.Tensor,
                     kind: str) -> torch.Tensor:
    """Mean elementwise loss over valid positions. ``mask`` broadcasts
    against the loss (trailing feature dims averaged in)."""
    total, count = masked_sum(pred, truth, mask, kind)
    return total / torch.clamp(count, min=1)


def soft_dtw_loss(pred: torch.Tensor, truth: torch.Tensor, mask: torch.Tensor,
                  gamma: float, chunk: int) -> torch.Tensor:
    """Soft-DTW between ``pred`` and ``truth`` (B, T, C), zeroed where
    ``mask`` is False, summed over items and over chunks of ``chunk``
    frames (the last may be shorter). The full chunks of all items go to
    the kernel as one call, the tail as another."""
    while mask.dim() < pred.dim():
        mask = mask[..., None]
    pred = torch.where(mask, pred, torch.zeros((), dtype=pred.dtype, device=pred.device))
    truth = torch.where(mask, truth, torch.zeros((), dtype=truth.dtype, device=truth.device))
    B, T = pred.shape[:2]
    n_full = T // chunk
    total = 0.0
    if n_full:
        def fold(a):
            return a[:, : n_full * chunk].reshape(B * n_full, chunk, *a.shape[2:])

        total = torch.sum(soft_dtw_batch(fold(pred), fold(truth), gamma=gamma))
    if T > n_full * chunk:
        tail = slice(n_full * chunk, T)
        total = total + torch.sum(soft_dtw_batch(pred[:, tail], truth[:, tail], gamma=gamma))
    return total


class _Terms(dict):
    """The loss terms of one (micro-)batch before their reduction, in the
    order they were added: ``("masked", sum, count)`` for a mean over valid
    positions, ``("mean", elementwise)`` for a mean over every element (one
    or a few per item), ``("sum", value)`` for a sum over items."""

    def masked(self, key: str, pred, truth, mask, kind: str) -> None:
        self[key] = ("masked",) + masked_sum(pred, truth, mask, kind)

    def mean(self, key: str, elt: torch.Tensor) -> None:
        self[key] = ("mean", elt)

    def sum(self, key: str, value) -> None:
        self[key] = ("sum", value)

    def reduce(self, mesh=None) -> Dict[str, torch.Tensor]:
        """Each term as a loss. One process (or a ``mesh`` whose batch is
        not split): the masked and plain means of the batch. A split batch:
        this rank's sum over the global batch's count, every count summed
        over the data ranks in one all-reduce, so that the terms (and their
        gradients) summed over the ranks are the global batch's losses."""
        if mesh is None or not mesh.sharded:
            return {k: (t[1] / torch.clamp(t[2], min=1) if t[0] == "masked"
                        else torch.mean(t[1]) if t[0] == "mean" else t[1])
                    for k, t in self.items()}
        counted = [k for k, t in self.items() if t[0] != "sum"]
        device = next((self[k][1].device for k in counted), None)
        counts = {}
        if counted:
            local = torch.stack([self[k][2].to(torch.int64) if self[k][0] == "masked"
                                 else torch.tensor(self[k][1].numel(), device=device)
                                 for k in counted])
            counts = dict(zip(counted, mesh.sum(local).unbind()))
        return {k: (t[1] / torch.clamp(counts[k], min=1) if t[0] == "masked"
                    else t[1].sum() / counts[k] if t[0] == "mean" else t[1])
                for k, t in self.items()}


def compute_losses(result: Dict[str, Any], batch: Dict[str, torch.Tensor], cfg: Config,
                   frozen_components: Tuple[str, ...] = (), mesh=None) -> Dict[str, torch.Tensor]:
    """Per-component losses and the weighted ``total``. With a ``mesh``
    whose batch is split (parallel/mesh.py), this rank's share of the
    global batch's losses (``_Terms.reduce``): summed over the data ranks
    they are the JAX package's global-batch losses."""
    mcfg, vcfg, tcfg = cfg.model, cfg.model.variance, cfg.train
    terms = _Terms()
    phone_mask, frame_mask = result["phone_mask"], result["frame_mask"]

    if mcfg.fastdiff_variances:
        # each diffusion variance and the duration: MSE(noise prediction, z)
        # (reference loss.py:105-115,173-180)
        for var in vcfg.variances:
            terms.masked(var, result[f"variances_{var}"], result[f"variances_{var}_z"],
                         frame_mask, "mse")
        terms.masked("duration", result["duration_prediction"], result["duration_z"],
                     phone_mask, "mse")
        terms.masked("mel", result["mel"], batch["mel"][:, : result["mel"].shape[1]],
                     frame_mask, tcfg.mel_loss)
        _joint_losses(terms, result)
        weights = {"mel": tcfg.mel_loss_weight, "duration": mcfg.duration.loss_weight,
                   **JOINT_WEIGHTS}
        for i, var in enumerate(vcfg.variances):
            weights[var] = vcfg.loss_weights[i]
        return _total(terms.reduce(mesh), weights, frozen_components)

    for i, var in enumerate(vcfg.variances):
        mask = phone_mask if vcfg.levels[i] == "phone" else frame_mask
        kind = vcfg.losses[i]
        if vcfg.transforms[i] == "cwt":
            out = result[f"variances_{var}"]
            pred, truth = out["spectrogram"], batch[f"variances_{var}_spectrogram"]
            if kind == "soft_dtw":
                terms.sum(f"{var}_cwt", soft_dtw_loss(pred, truth, mask, tcfg.soft_dtw_gamma,
                                                      tcfg.soft_dtw_chunk_size))
            else:
                terms.masked(f"{var}_cwt", pred, truth, mask, kind)
            terms.mean(f"{var}_mean", torch.square(out["mean"] - batch[f"variances_{var}_mean"]))
            terms.mean(f"{var}_std", torch.square(out["std"] - batch[f"variances_{var}_std"]))
        else:
            pred = result[f"variances_{var}"]
            truth = batch[f"variances_{var}"]
            if vcfg.levels[i] == "frame":
                truth = truth[:, : pred.shape[1]]
            if kind == "soft_dtw":
                terms.sum(var, soft_dtw_loss(pred[..., None], truth[..., None], mask[..., None],
                                             tcfg.soft_dtw_gamma, tcfg.soft_dtw_chunk_size))
            else:
                terms.masked(var, pred, truth, mask, kind)

    mel = result["mel"]
    mel_truth = batch["mel"][:, : mel.shape[1]]
    if tcfg.mel_loss == "soft_dtw":
        terms.sum("mel", soft_dtw_loss(mel, mel_truth, frame_mask, tcfg.soft_dtw_gamma,
                                       tcfg.soft_dtw_chunk_size))
    else:
        terms.masked("mel", mel, mel_truth, frame_mask, tcfg.mel_loss)
    if mcfg.duration.stochastic:
        # the SDP's per-item NLL, summed over the batch (loss.py:189)
        terms.sum("duration", torch.sum(result["duration_prediction"]))
    else:
        log_d = torch.log(batch["duration"].float() + 1.0)
        terms.masked("duration", result["duration_prediction"], log_d, phone_mask,
                     mcfg.duration.loss)
    _joint_losses(terms, result)

    weights: Dict[str, float] = {"mel": tcfg.mel_loss_weight,
                                 "duration": mcfg.duration.loss_weight, **JOINT_WEIGHTS}
    for i, var in enumerate(vcfg.variances):
        for key in (var, f"{var}_cwt", f"{var}_mean", f"{var}_std"):
            weights[key] = vcfg.loss_weights[i]
    return _total(terms.reduce(mesh), weights, frozen_components)


# the joint vocoder's ε-MSE and the speaker generator's (fastspeech2.py:461-473)
JOINT_WEIGHTS = {"fastdiff": 1e-1, "speakers": 1.0}


def _joint_losses(terms: _Terms, result: Dict[str, Any]) -> None:
    """The joint vocoder's ε-MSE over ``wav_mask`` and the speaker
    generator's MSE, where the result has them."""
    if "fastdiff" in result:
        eps, z = result["fastdiff"]
        terms.masked("fastdiff", eps, z, result["wav_mask"], "mse")
    if result.get("speaker_z") is not None:
        terms.mean("speakers", torch.square(result["speaker_pred"] - result["speaker_z"]))


def _total(losses: Dict[str, torch.Tensor], weights: Dict[str, float],
           frozen_components: Tuple[str, ...]) -> Dict[str, torch.Tensor]:
    total = 0.0
    for key, value in losses.items():
        if any(f in key for f in frozen_components):
            continue
        total = total + weights.get(key, 1.0) * value
    losses["total"] = total
    return losses
