"""Learned spectral-mask denoiser of the restoration chain: inference.

Counterpart of ``lightningfastspeech2_tpu/synthesis/denoiser.py``: a small
convolutional mask estimator over the normalized log-magnitude STFT,
applied to the magnitude with the noisy phase kept. Its weights ship as
``data/denoiser.npz`` (flax names ``['Conv_i']['kernel']`` of shape (5, 5,
in, out), HWIO over (frames, bins)), loaded here into ``Conv2d`` layers
(out, in, 5, 5) with flax's ``SAME`` padding (2 on each side); ``save``
writes that layout back, so either package loads what the other wrote.

``train_denoiser`` trains one as the JAX trainer does: the (clean,
degraded) STFT pairs drawn in numpy in the same order, the MaskNet steps on
the card unless asked for the CPU, Adam with optax's defaults.

Where the caller marks valid frames and none is valid, the JAX function's
padded frames take the valid frames' minimum, +inf, and its mask goes to
NaN; here every frame is then one level (0), and the output stays finite.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from lightningfastspeech2_tpu_torch.core.device import DeviceLike, resolve_device

BUILTIN_PATH = Path(__file__).resolve().parent.parent / "data" / "denoiser.npz"


class MaskNet(nn.Module):
    """(..., T, F) normalized log-magnitude -> (..., T, F) mask in [0, 1]:
    three 5x5 conv + ReLU layers and a 5x5 conv + sigmoid, each (T, F) on
    its own."""

    def __init__(self, ch: int = 24):
        super().__init__()
        chans = (1, ch, ch, ch, 1)
        self.convs = nn.ModuleList(nn.Conv2d(a, b, 5, padding=2)
                                   for a, b in zip(chans[:-1], chans[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.reshape((-1, 1) + x.shape[-2:])
        for conv in self.convs[:-1]:
            h = torch.relu(conv(h))
        return torch.sigmoid(self.convs[-1](h)).reshape(x.shape)


def _normalize(logmag: torch.Tensor) -> torch.Tensor:
    """z-normalization of each (T, F) of a (..., T, F) on its own."""
    mu = logmag.mean((-2, -1), keepdim=True)
    sd = logmag.std((-2, -1), unbiased=False, keepdim=True) + 1e-5
    return (logmag - mu) / sd


def apply_mask_net(net: MaskNet, mag: torch.Tensor, floor: float = 0.03,
                   frame_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Masked magnitude; ``floor`` matches the DSP chain's spectral floor.
    ``frame_valid`` (T,) bool: the normalization statistics come from the
    valid frames only, and padded frames sit at the valid frames' minimum
    (a zero-padded bucket would otherwise drag the mean down and open the
    mask); with no valid frame every frame sits at 0, where the JAX function
    puts +inf and returns NaN."""
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
        # no valid frame: valid_min is +inf, so every frame sits at 0 instead
        fill = torch.where((w > 0).any(), valid_min, torch.zeros_like(valid_min))
        x = torch.where(w > 0, x, fill)
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


def save(net: MaskNet, path) -> None:
    """The weights as the JAX package's npz: keys ``['Conv_i']['kernel']``
    (HWIO) and ``['Conv_i']['bias']``, the names ``jax.tree_util.keystr``
    gives the flax tree's paths."""
    arrays = {}
    for i, conv in enumerate(net.convs):
        w = conv.weight.detach().float().cpu().numpy()
        arrays[f"['Conv_{i}']['kernel']"] = np.ascontiguousarray(np.transpose(w, (2, 3, 1, 0)))
        arrays[f"['Conv_{i}']['bias']"] = conv.bias.detach().float().cpu().numpy()
    np.savez(path, **arrays)


def train_denoiser(clean_clips: Sequence[np.ndarray], steps: int = 3000, batch: int = 4,
                   frames: int = 256, lr: float = 1e-3, sr: int = 22050, n_fft: int = 1024,
                   hop: int = 256, seed: int = 0, verbose: bool = False,
                   device: DeviceLike = None, init: Optional[dict] = None,
                   losses: Optional[List[float]] = None) -> MaskNet:
    """Train MaskNet on (clean, degraded) STFT pairs, as the JAX package's
    ``train_denoiser``: each draw degrades a clip segment with white noise
    (70 %) or pink noise (20 %) at an SNR of U(0, 25) dB, or not at all
    (10 %), in numpy from ``np.random.default_rng(seed)`` in the JAX
    trainer's order (one draw before the weights, as its init sample); the
    loss is the magnitude-weighted L1 of the mask against the clipped ideal
    ratio mask plus 0.1 times the L1 of the masked magnitude. Adam as
    ``optax.adam(lr)``; the steps run on ``device`` (``cuda`` unless
    ``"cpu"``). The weights are flax's init (``utils/convert.py
    lecun_normal_``) from a ``torch.Generator`` seeded ``seed``, or
    ``init`` (a state dict). ``losses``, where given, gets every step's
    loss."""
    from lightningfastspeech2_tpu_torch.utils.convert import init_discriminator_weights

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    win = np.hanning(n_fft + 1)[:-1].astype(np.float32)

    def stft_mag(x):
        n = (len(x) - n_fft) // hop + 1
        idx = np.arange(n_fft)[None, :] + hop * np.arange(n)[:, None]
        return np.abs(np.fft.rfft(x[idx] * win, axis=-1)).astype(np.float32)

    def pink(n):
        w = rng.standard_normal(n + 1).astype(np.float32)
        f = np.fft.rfft(w)
        f /= np.maximum(np.sqrt(np.arange(len(f), dtype=np.float32)), 1.0)
        return np.fft.irfft(f, n=n + 1)[:n].astype(np.float32)

    seg_len = (frames - 1) * hop + n_fft

    def draw():
        clip = clean_clips[rng.integers(len(clean_clips))]
        if len(clip) <= seg_len:
            x = np.pad(clip, (0, seg_len - len(clip)))
        else:
            s = int(rng.integers(0, len(clip) - seg_len))
            x = clip[s: s + seg_len]
        u = rng.uniform()
        if u < 0.1:
            d = x
        else:
            noise = pink(len(x)) if u < 0.3 else rng.standard_normal(len(x)).astype(np.float32)
            snr = rng.uniform(0.0, 25.0)
            p_sig = np.mean(x ** 2) + 1e-12
            scale = np.sqrt(p_sig / (np.mean(noise ** 2) + 1e-12) / 10 ** (snr / 10))
            d = x + scale * noise
        return stft_mag(x), stft_mag(d)

    draw()   # the JAX trainer's init sample: its draws come first
    net = MaskNet()
    if init is None:
        init_discriminator_weights(net, torch.Generator().manual_seed(seed))
    else:
        net.load_state_dict({k: torch.as_tensor(np.array(v, np.float32))
                             for k, v in init.items()})
    net.to(dev).train()
    opt = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    step_losses = []
    for i in range(steps):
        pairs = [draw() for _ in range(batch)]
        clean = torch.as_tensor(np.stack([c for c, _ in pairs]), device=dev)
        noisy = torch.as_tensor(np.stack([d for _, d in pairs]), device=dev)
        mask = net(_normalize(torch.log(noisy + 1e-6)))
        target = torch.clamp(clean / (noisy + 1e-6), 0.0, 1.0)
        w = torch.log1p(noisy)
        l_mask = (w * (mask - target).abs()).sum() / w.sum()
        l_mag = (noisy * torch.clamp(mask, min=0.03) - clean).abs().mean()
        loss = l_mask + 0.1 * l_mag
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        step_losses.append(loss.detach())
        if verbose and (i % 200 == 0 or i == steps - 1):
            print(f"denoiser step {i}: loss {float(step_losses[-1]):.4f}", flush=True)
    if losses is not None and step_losses:
        losses.extend(torch.stack(step_losses).tolist())
    return net.requires_grad_(False).eval()
