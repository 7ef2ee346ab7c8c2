"""Device resolution, the kernel gate and f32 precision.

Counterpart of ``lightningfastspeech2_tpu/ops/kernel_gate.py``. There the
gate probed the backend and fell back to XLA paths; here there is no
fallback and no environment opt-out. A tensor on the CPU takes a kernel's
plain PyTorch version; a CUDA tensor launches the kernel, which needs a
Hopper card (compute capability 9.0, the ``sm_90a`` build target), or the
call raises.

``f32_convolutions`` makes an f32 run f32 on the card: PyTorch runs f32
convolutions through cuDNN in TF32 by default (about three decimal
digits), which is not the JAX package's f32 computation. The CLIs call it
before they build a model.
"""

from __future__ import annotations

import contextlib
from typing import Iterator, Union

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


def f32_convolutions(precision) -> None:
    """For an f32 run (``precision`` 32 or "32", as the CLIs spell it) turn
    TF32 off for cuDNN's convolutions and cuBLAS's products, so that f32
    means f32 on the card; a bf16 run leaves both flags as they are."""
    if str(precision) == "32":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def tf32_off() -> Iterator[None]:
    """TF32 off for cuDNN and cuBLAS inside the block, whatever the process
    set, and both flags as they were after it: for work that must be f32 in
    a bf16 run (the on-device features' filterbank product)."""
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
