"""Process groups and the ``(data, model)`` layout: the port's distributed
backend.

Counterpart of ``lightningfastspeech2_tpu/parallel/mesh.py``. There a
named-axis ``jax.sharding.Mesh`` lets pjit emit the collectives; here one
process (a rank) drives one card, ``torch.distributed`` carries the
collectives, and the callers issue them where the JAX program has them:

``data``   the batch axis: each data rank loads its share of the global
           batch (``host_local_batch_size``) from its shard of the corpus,
           and the gradients are summed over it (train/step.py).
``model``  replicates: the JAX package passes no sharding rules to
           ``param_sharding``, so a model axis above 1 only copies the
           model. The ranks of one model group read the same data shard
           and compute the same step; there is no tensor parallelism.

A rank ``r`` sits at ``(r // model, r % model)``, as the JAX package
reshapes ``jax.devices()`` to ``(data, model)``; its data group is the
column of ranks that share its model index.

``distributed_init`` starts the default group from ``torch.distributed.run``'s
environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``):

    python -m torch.distributed.run --standalone --nproc_per_node 2 \\
        -m lightningfastspeech2_tpu_torch.cli.train ...

NCCL where every local rank has a card of its own, gloo where ranks share a
card or run on the CPU (gloo reduces CUDA tensors through host copies).
"""

from __future__ import annotations

import contextlib
import contextvars
import os
from dataclasses import dataclass
from typing import Any, Iterator, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from lightningfastspeech2_tpu_torch.core.config import MeshConfig

def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if initialized() else 1


def rank() -> int:
    return dist.get_rank() if initialized() else 0


def is_main() -> bool:
    """Rank 0, the one that writes files and logs (the JAX package's
    ``jax.process_index() == 0``)."""
    return rank() == 0


def barrier(name: str) -> None:
    """Every rank waits here for the others; ``name`` says which wait this
    is in a hang's traceback. A no-op in one process."""
    if world_size() > 1:
        dist.barrier()


@contextlib.contextmanager
def main_first(name: str) -> Iterator[None]:
    """Rank 0 runs the block, then the other ranks do: for work that writes
    a file the others then read (a feature or d-vector cache), so that no
    two ranks write one path and no rank reads a file half written."""
    if not is_main():
        barrier(name)
    yield
    if is_main():
        barrier(name)


def distributed_init(device=None) -> Optional[str]:
    """Start the default process group when ``WORLD_SIZE`` > 1 and none is
    running; returns its backend, or None where this did nothing (one
    process, or a group started by the caller).

    The backend is decided once, the same on every rank, and never retried:
    ``nccl`` where ``LOCAL_WORLD_SIZE`` <= the visible cards, ``gloo`` where
    ranks share a card or ``device`` is the CPU. Before any CUDA work each
    rank's current device becomes card ``LOCAL_RANK`` (modulo the cards,
    when they are shared), so that ``core/device.py resolve_device`` names
    it. A rank that wants CUDA and sees no card raises."""
    n = int(os.environ.get("WORLD_SIZE", "1"))
    if n <= 1 or initialized():
        return None
    r = int(os.environ["RANK"])
    local_rank = int(os.environ.get("LOCAL_RANK", r))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", n))
    kwargs = {}
    if torch.device("cuda" if device is None else device).type == "cpu":
        backend, where = "gloo", "cpu"
    else:
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError(f"rank {r}: no CUDA device is available; pass --device cpu "
                               "to train on the CPU")
        card = local_rank % cards
        torch.cuda.set_device(card)
        backend, where = ("nccl" if local_world <= cards else "gloo"), f"cuda:{card}"
        if backend == "nccl":
            kwargs["device_id"] = torch.device("cuda", card)
    print(f"rank {r}/{n}: torch.distributed backend {backend} on {where}", flush=True)
    dist.init_process_group(backend, init_method="env://", rank=r, world_size=n, **kwargs)
    return backend


def mesh_layout(cfg: MeshConfig, n: int) -> np.ndarray:
    """The ranks ``0..n-1`` as a ``(data, model)`` array, with the JAX
    package's checks and messages (``make_mesh``): ``cfg.data == -1`` takes
    every rank the model axis leaves."""
    model = cfg.model
    if n % model != 0:
        raise ValueError(f"{n} devices not divisible by model axis {model}")
    data = n // model if cfg.data == -1 else cfg.data
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} available devices")
    return np.arange(n).reshape(data, model)


def data_axis_for_batch(cfg: MeshConfig, n: int, batch_size: int) -> int:
    """The JAX train CLI's data axis for ``n`` devices: every device the
    model axis leaves (or ``cfg.data``), halved until it divides the global
    batch (``cli/train.py:376-389``)."""
    data = n // cfg.model if cfg.data == -1 else cfg.data
    while data > 1 and batch_size % data != 0:
        data //= 2
    return data


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the ``(data, model)`` layout and the group it
    reduces over. ``devices`` holds the ranks, ``data_group`` the ranks of
    this rank's model index (None without a process group). The methods
    are the collectives the callers need; each is one call over the data
    group, and without a group each returns its input."""

    devices: np.ndarray
    rank: int = 0
    data_group: Any = None

    @property
    def data(self) -> int:
        return int(self.devices.shape[0])

    @property
    def model(self) -> int:
        return int(self.devices.shape[1])

    @property
    def data_rank(self) -> int:
        return self.rank // self.model

    @property
    def model_rank(self) -> int:
        return self.rank % self.model

    @property
    def sharded(self) -> bool:
        """Whether the batch is split: each step then computes the global
        batch's losses from every data rank's share."""
        return self.data > 1

    def _device(self) -> torch.device:
        if dist.get_backend(self.data_group) == "nccl":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device("cpu")

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the data ranks, in place; returns ``x``."""
        if self.data_group is not None:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.data_group)
        return x

    def _ints(self, values: Sequence[int], op) -> List[int]:
        if self.data_group is None:
            return [int(v) for v in values]
        t = torch.tensor([int(v) for v in values], dtype=torch.int64, device=self._device())
        dist.all_reduce(t, op=op, group=self.data_group)
        return [int(v) for v in t.tolist()]

    def max(self, values: Sequence[int]) -> List[int]:
        """Each of ``values`` (ints) at its largest over the data ranks."""
        return self._ints(values, dist.ReduceOp.MAX)

    def min(self, values: Sequence[int]) -> List[int]:
        """Each of ``values`` (ints) at its smallest over the data ranks."""
        return self._ints(values, dist.ReduceOp.MIN)

    def any(self, x: torch.Tensor) -> torch.Tensor:
        """A bool tensor, True where it is True on any data rank."""
        if self.data_group is None:
            return x
        t = x.to(torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.data_group)
        return t.bool()

    def gather(self, obj: Any) -> List[Any]:
        """Every data rank's ``obj`` (picklable host values), in data-rank
        order, on every rank."""
        if self.data_group is None:
            return [obj]
        out: List[Any] = [None] * dist.get_world_size(self.data_group)
        dist.all_gather_object(out, obj, group=self.data_group)
        return out


# the mesh whose data ranks hold the batch of the forward running in this
# context (``global_batch``), or None
_GLOBAL_BATCH: contextvars.ContextVar = contextvars.ContextVar("global_batch", default=None)


@contextlib.contextmanager
def global_batch(mesh: Optional[Mesh]) -> Iterator[None]:
    """Inside the block a model's reductions over the batch axis
    (``batch_any``) span the global batch split over ``mesh``'s data ranks,
    as the JAX package's global-batch program reduces over the whole batch.
    A no-op without a split batch."""
    token = _GLOBAL_BATCH.set(mesh if mesh is not None and mesh.sharded else None)
    try:
        yield
    finally:
        _GLOBAL_BATCH.reset(token)


def batch_any(mask: torch.Tensor) -> torch.Tensor:
    """``mask.any(0, keepdim=True)``: over the global batch inside
    ``global_batch`` (one all-reduce), over this batch otherwise."""
    extent = mask.any(0, keepdim=True)
    mesh = _GLOBAL_BATCH.get()
    return extent if mesh is None else mesh.any(extent)


def make_mesh(cfg: MeshConfig = MeshConfig(), n: Optional[int] = None) -> Mesh:
    """The ``(data, model)`` mesh over the ``n`` ranks (the world by
    default). Under a process group of ``n`` ranks every rank must call it,
    in the same order, since it creates the data groups: the world itself
    where the model axis is 1."""
    n = world_size() if n is None else n
    devices = mesh_layout(cfg, n)
    group = None
    if initialized() and world_size() == n:
        if devices.shape[1] == 1:
            group = dist.group.WORLD
        else:
            for m in range(devices.shape[1]):
                ranks = devices[:, m].tolist()
                g = dist.new_group(ranks)
                if rank() in ranks:
                    group = g
    return Mesh(devices, rank() if initialized() else 0, group)


def host_local_batch_size(global_batch: int, n: int) -> int:
    """The items each of ``n`` data ranks loads a micro-batch: the global
    batch over ``n``. Raises where it does not divide (the JAX package's
    per-host batch over its processes)."""
    if global_batch % n != 0:
        raise ValueError(f"global batch {global_batch} not divisible by {n} hosts")
    return global_batch // n
