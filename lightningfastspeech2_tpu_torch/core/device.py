"""Device resolution and the kernel gate.

Counterpart of ``lightningfastspeech2_tpu/ops/kernel_gate.py``. There the
gate probed the backend and fell back to XLA paths; here there is no
fallback and no environment opt-out. A tensor on the CPU takes a kernel's
plain PyTorch version; a CUDA tensor launches the kernel, which needs a
Hopper card (compute capability 9.0, the ``sm_90a`` build target), or the
call raises.
"""

from __future__ import annotations

from typing import Union

import torch

from lightningfastspeech2_tpu_torch.kernels.launch import require_kernel_device

DeviceLike = Union[str, torch.device, None]


# cards on which the probe kernel ran; the capability is remembered by
# kernels/launch.py
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
    if dev not in _probed:
        require_kernel_device(dev)
        from lightningfastspeech2_tpu_torch.ops.probe import probe

        x = torch.arange(8 * 128, dtype=torch.float32, device=dev).reshape(8, 128)
        if not torch.equal(probe(x), x * 2.0):
            raise RuntimeError(f"the probe kernel computed a wrong result on {dev}")
        _probed.add(dev)
    return dev
