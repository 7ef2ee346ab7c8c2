"""Learned spectral-mask denoiser of the restoration chain: inference.

Counterpart of ``lightningfastspeech2_tpu/synthesis/denoiser.py``: a small
convolutional mask estimator over the normalized log-magnitude STFT,
applied to the magnitude with the noisy phase kept. Its weights ship as
``data/denoiser.npz`` (flax names ``['Conv_i']['kernel']`` of shape (5, 5,
in, out), HWIO over (frames, bins)), loaded here into ``Conv2d`` layers
(out, in, 5, 5) with flax's ``SAME`` padding (2 on each side). Training
(``train_denoiser``) is not ported yet.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device

BUILTIN_PATH = Path(__file__).resolve().parent.parent / "data" / "denoiser.npz"


class MaskNet(nn.Module):
    """(T, F) normalized log-magnitude -> (T, F) mask in [0, 1]: three
    5x5 conv + ReLU layers and a 5x5 conv + sigmoid."""

    def __init__(self, ch: int = 24):
        super().__init__()
        chans = (1, ch, ch, ch, 1)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 5, padding=2)
                                   for a, b in zip(chans[:-1], chans[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x[None, None]
        for conv in self.convs[:-1]:
            h = torch.relu(conv(h))
        return torch.sigmoid(self.convs[-1](h))[0, 0]


def _normalize(logmag: torch.Tensor) -> torch.Tensor:
    mu = logmag.mean()
    sd = logmag.std(unbiased=False) + 1e-5
    return (logmag - mu) / sd


def apply_mask_net(net: MaskNet, mag: torch.Tensor, floor: float = 0.03,
                   frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked magnitude; ``floor`` matches the DSP chain's spectral floor.
    ``frame_valid`` (T,) bool: the normalization statistics come from the
    valid frames only, and padded frames sit at the valid frames' minimum
    (a zero-padded bucket would otherwise drag the mean down and open the
    mask)."""
    logm = torch.log(mag + 1e-6)
    if frame_valid is None:
        x = _normalize(logm)
    else:
        w = frame_valid.to(logm.dtype)[:, None]
        n = torch.clamp(w.sum() * logm.shape[1], min=1.0)
        mu = (logm * w).sum() / n
        var = ((logm - mu).square() * w).sum() / n
        x = (logm - mu) / (torch.sqrt(var) + 1e-5)
        valid_min = torch.where(w > 0, x, torch.inf).min()
        x = torch.where(w > 0, x, valid_min)
    mask = net(x)
    return mag * torch.clamp(mask, min=floor)


def load(path=None, device: DeviceLike = None) -> Optional[MaskNet]:
    """The builtin weights (or ``path``) as a MaskNet on ``device`` (``cuda``
    unless ``"cpu"``), in eval mode; None when the file is absent."""
    path = Path(path) if path else BUILTIN_PATH
    if not path.exists():
        return None
    dev = resolve_device(device)
    with np.load(path) as z:
        flat = {tuple(re.findall(r"\['([^']+)'\]", k)): z[k] for k in z.files}
    n = 1 + max(int(layer.split("_")[1]) for layer, _ in flat)
    net = MaskNet(ch=flat[("Conv_0", "kernel")].shape[-1])
    if n != len(net.convs):
        raise ValueError(f"{path}: {n} conv layers, MaskNet has {len(net.convs)}")
    state = {}
    for i in range(n):
        state[f"convs.{i}.weight"] = torch.as_tensor(
            np.ascontiguousarray(np.transpose(flat[(f"Conv_{i}", "kernel")], (3, 2, 0, 1))))
        state[f"convs.{i}.bias"] = torch.as_tensor(flat[(f"Conv_{i}", "bias")])
    net.load_state_dict(state)
    return net.requires_grad_(False).to(dev).eval()
