"""The one launch path of the port's kernels.

Every wrapper under ``ops/`` calls ``kernel_stream`` on the tensors it hands
a kernel, before it allocates the outputs, and passes the stream it returns
to the ctypes call.
It does in one pass what each launch needs, at the least host cost: every
tensor on one CUDA device and contiguous, the card of capability (9, 0)
(checked once per device index, not per launch), and the device's current
stream as the raw handle PyTorch's own generated kernels take
(``torch._C._cuda_getCurrentRawStream``), with no ``torch.cuda.Stream``
object built.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

KERNEL_CAPABILITY = (9, 0)

# device indices whose capability was checked
_capable = set()


def require_kernel_device(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA card of capability (9, 0); a card
    that passes is remembered by its index."""
    if device.type != "cuda":
        raise RuntimeError(f"kernel launch needs a CUDA tensor, got {device}")
    index = torch.cuda.current_device() if device.index is None else device.index
    if index in _capable:
        return
    cap = torch.cuda.get_device_capability(index)
    if tuple(cap) != KERNEL_CAPABILITY:
        raise RuntimeError(
            f"the port's kernels are built for sm_90a (Hopper); "
            f"{torch.cuda.get_device_name(index)} has capability {cap}"
        )
    _capable.add(index)


def refuse_grad(what: str, route: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where grad mode is on and one of ``tensors`` needs a gradient:
    a kernel's output has no ``grad_fn``, so launching it would stop the
    gradient silently. ``tensors`` are the launch's inputs and, where the
    caller has them, the parameters its prepared weights were copied from
    (``None`` entries are skipped); ``route`` names the differentiable
    route to train through instead."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{what} has no backward: an input needs a gradient; train through {route}, "
            "or call it under torch.no_grad()")


def kernel_stream(*tensors: Optional[torch.Tensor],
                  strided: Sequence[torch.Tensor] = ()) -> int:
    """Check the tensors of one launch (``None`` entries are skipped) and
    return the raw handle of their device's current stream. Raises on a
    non-contiguous tensor, on tensors that span devices, on a tensor off
    CUDA and on a card of another capability. ``strided`` tensors are held
    to the same device but may have any strides: the kernel takes them."""
    index = None
    first = None
    for n, t in enumerate((*tensors, *strided)):
        if t is None:
            continue
        if n < len(tensors) and not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if first is None:
            first, index = t, t.get_device()
        elif t.get_device() != index or (not t.is_cuda and t.device != first.device):
            devs = {u.device for u in (*tensors, *strided) if u is not None}
            raise ValueError(f"kernel inputs span devices {devs}")
    # a CPU or meta tensor's index is -1, never a checked card's
    if index not in _capable:
        require_kernel_device(first.device)
    return torch._C._cuda_getCurrentRawStream(index)
