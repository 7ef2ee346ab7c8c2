"""Device resolution and the kernel gate.

Counterpart of ``lightningfastspeech2_tpu/ops/kernel_gate.py``. There the
gate probed the backend and fell back to XLA paths; here there is no
fallback and no environment opt-out. A tensor on the CPU takes a kernel's
plain PyTorch version; a CUDA tensor launches the kernel, which needs a
Hopper card (compute capability 9.0, the ``sm_90a`` build target), or the
call raises.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

KERNEL_CAPABILITY = (9, 0)

DeviceLike = Union[str, torch.device, None]


_probed = set()


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for the CPU. Raises when CUDA is wanted and absent, or when the card
    cannot run the port's kernels. The first time a card is resolved, the
    probe kernel is built and launched on it (as the JAX package probed its
    backend once), so a broken build or launch fails here."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    require_kernel_device(dev)
    if dev not in _probed:
        from lightningfastspeech2_tpu_torch.ops.probe import probe

        x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
        if not torch.equal(probe(x), x * 2.0):
            raise RuntimeError(f"the probe kernel computed a wrong result on {dev}")
        _probed.add(dev)
    return dev


def require_kernel_device(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA card of capability (9, 0)."""
    if device.type != "cuda":
        raise RuntimeError(f"kernel launch needs a CUDA tensor, got {device}")
    cap = torch.cuda.get_device_capability(device)
    if tuple(cap) != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(device)} has capability {cap}"
        )


def check_kernel_inputs(*tensors: Optional[torch.Tensor]) -> None:
    """Common launch checks: one CUDA device of capability (9, 0), every
    tensor contiguous."""
    devs = {t.device for t in tensors if t is not None}
    if len(devs) != 1:
        raise ValueError(f"kernel inputs span devices {devs}")
    require_kernel_device(next(iter(devs)))
    for t in tensors:
        if t is not None and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
