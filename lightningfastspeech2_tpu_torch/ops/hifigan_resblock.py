"""HiFi-GAN ResBlock1, one at a time (``resblock``) or all of one upsample
stage at once, averaged (``resblock_trio``).

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_hifigan.py``
(``fused_resblock`` / ``_resblock_kernel`` and ``fused_resblock_trio`` /
``_resblock_trio_kernel``). For a CUDA tensor the wrappers launch the
kernel in ``csrc/resblock.cu``; for a CPU tensor they run the plain
versions below. The TPU kernels' time-into-lanes fold (``tap_blocks``) was
a trick for the MXU and is not carried over: signals stay (B, L, C).

Numerics, kernel and plain alike: leaky_relu(0.1) on the working dtype
before the first conv of a pair, f32 accumulation, bias and the second
leaky in f32, a cast to the working dtype before the second conv and before
each residual add, every conv zero outside the signal. The trio sums its
resblock outputs in the working dtype and divides by their count.

Tap stacks are prepared once, when weights load
(``prepare_resblock_weights``), not per call.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream

LRELU_SLOPE = 0.1
# shared memory a block may take (of the H100's 227 KB), and the tile cap
_SMEM_BUDGET = 200 * 1024
_TILE_CAP = 256
_SLACK_ROWS = 4  # csrc/resblock.cu kRowsPerThread
_c_fn = None

# one residual pair: (w1, b1, dilation, w2, b2), torch Conv1d layout (C, C, k)
Pair = Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor]


@dataclass
class ResblockWeights:
    """Prepared weights of ``n_res`` ResBlock1s of one stage."""

    channels: int
    dtype: torch.dtype
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[Tuple[int, ...], ...]
    taps: torch.Tensor      # every conv's (k, C_in, C_out) taps, flat, working dtype
    bias: torch.Tensor      # (n_convs, C) f32
    pairs: List[List[Pair]]  # per resblock, f32 weights rounded through dtype

    @property
    def n_res(self) -> int:
        return len(self.kernel_sizes)

    @property
    def reaches(self) -> Tuple[Tuple[int, ...], ...]:
        """Per resblock, each conv's reach in samples, in chain order: the
        dilated conv's d·(k−1)/2, then the plain conv's (k−1)/2."""
        return tuple(tuple(r for d in ds for r in (d * (k - 1) // 2, (k - 1) // 2))
                     for k, ds in zip(self.kernel_sizes, self.dilations))

    @property
    def halo(self) -> int:
        """Largest sum of conv reaches over the resblocks (60 for k=11,
        dilations 1, 3, 5)."""
        return max(sum(r) for r in self.reaches)

    @property
    def layout(self) -> Tuple[int, ...]:
        out: List[int] = []
        for k, ds in zip(self.kernel_sizes, self.dilations):
            out += [k, len(ds), *ds]
        return tuple(out)


def prepare_resblock_weights(
    blocks: Sequence[Tuple[int, Sequence[int], Sequence[Tuple[torch.Tensor, ...]]]],
    dtype: torch.dtype,
) -> ResblockWeights:
    """``blocks``: per resblock (kernel_size, dilations, [(w1, b1, w2, b2)
    per dilation]) with torch Conv1d weights (C, C, k)."""
    with torch.no_grad():
        taps, biases, pairs = [], [], []
        for k, ds, convs in blocks:
            rb_pairs = []
            for d, (w1, b1, w2, b2) in zip(ds, convs):
                for w, b in ((w1, b1), (w2, b2)):
                    taps.append(w.to(dtype).permute(2, 1, 0).reshape(-1))
                    biases.append(b.float())
                rb_pairs.append((w1.to(dtype).float(), b1.float(), int(d),
                                 w2.to(dtype).float(), b2.float()))
            pairs.append(rb_pairs)
        return ResblockWeights(
            channels=blocks[0][2][0][0].shape[0],
            dtype=dtype,
            kernel_sizes=tuple(int(k) for k, _, _ in blocks),
            dilations=tuple(tuple(int(d) for d in ds) for _, ds, _ in blocks),
            taps=torch.cat(taps).contiguous(),
            bias=torch.stack(biases).contiguous(),
            pairs=pairs,
        )


def _conv_f32(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dilation: int) -> torch.Tensor:
    pad = dilation * (w.shape[-1] - 1) // 2
    return F.conv1d(h.float().transpose(1, 2), w, b, padding=pad,
                    dilation=dilation).transpose(1, 2)


def _one_plain(x: torch.Tensor, pairs: Sequence[Pair]) -> torch.Tensor:
    dt = x.dtype
    for w1, b1, d, w2, b2 in pairs:
        t = torch.maximum(x, x * LRELU_SLOPE)
        t = _conv_f32(t, w1, b1, d)
        t = torch.maximum(t, t * LRELU_SLOPE).to(dt)
        t = _conv_f32(t, w2, b2, 1)
        x = x + t.to(dt)
    return x


def resblock_plain(x: torch.Tensor, w: ResblockWeights) -> torch.Tensor:
    """One ResBlock1 on x (B, L, C)."""
    if w.n_res != 1:
        raise ValueError(f"resblock takes one resblock, got {w.n_res}")
    return _one_plain(x, w.pairs[0])


def resblock_trio_plain(x: torch.Tensor, w: ResblockWeights) -> torch.Tensor:
    """All ResBlock1s of a stage on x (B, L, C), averaged."""
    out = None
    for pairs in w.pairs:
        y = _one_plain(x, pairs)
        out = y if out is None else out + y
    return out / float(w.n_res)


def kernel_tile(channels: int, halo: int, dtype: torch.dtype) -> Tuple[int, bool]:
    """(time tile, residual signal in shared memory) for the kernel: the
    largest multiple of 32 up to 256 whose buffers fit the budget, with
    both buffers in shared memory when they fit and the residual signal in
    a per-block device-memory scratch otherwise."""
    row_bytes = channels * torch.empty((), dtype=dtype).element_size()
    for buffers in (2, 1):
        tile = _SMEM_BUDGET // (buffers * row_bytes) - 2 * halo - _SLACK_ROWS
        tile = min(_TILE_CAP, tile // 32 * 32)
        if tile >= 32:
            return tile, buffers == 2
    raise ValueError(f"resblock kernel: C={channels} with halo {halo} does not fit")


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = build.load("resblock")
        fn = lib.lfs2_resblock
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.POINTER(ctypes.c_int),
                       i, i, i, p]
        fn.restype = ctypes.c_int
        _c_fn = (lib, fn)
    return _c_fn


def _launch(x: torch.Tensor, w: ResblockWeights, what: str) -> torch.Tensor:
    stream = kernel_stream(x, w.taps, w.bias)
    B, L, C = x.shape
    if x.dtype not in build.DTYPE_CODES or w.taps.dtype != x.dtype:
        raise ValueError(f"{what} takes f32 or bf16 x with taps of the same dtype, "
                         f"got {x.dtype}, {w.taps.dtype}")
    if C != w.channels or C not in (32, 64, 128, 256):
        raise ValueError(f"{what} kernel takes C in (32, 64, 128, 256) matching "
                         f"its weights, got C={C}, weights {w.channels}")
    if w.n_res > 3 or any(len(ds) > 3 for ds in w.dilations):
        raise ValueError(f"{what} kernel takes up to 3 resblocks of up to 3 pairs")
    halo = w.halo
    tile, x_in_smem = kernel_tile(C, halo, x.dtype)
    n_blocks = B * -(-L // tile)
    scratch = (torch.empty(0, dtype=x.dtype, device=x.device) if x_in_smem else
               torch.empty(n_blocks * (tile + 2 * halo + _SLACK_ROWS) * C,
                           dtype=x.dtype, device=x.device))
    layout = w.layout
    c_layout = (ctypes.c_int * len(layout))(*layout)
    out = torch.empty_like(x)
    lib, fn = _fn()
    rc = fn(x.data_ptr(), out.data_ptr(), w.taps.data_ptr(), w.bias.data_ptr(),
            scratch.data_ptr(), B, L, C, tile, halo, c_layout, w.n_res,
            int(x_in_smem), build.DTYPE_CODES[x.dtype], stream)
    build.check(lib, rc, what)
    return out


def resblock(x: torch.Tensor, w: ResblockWeights) -> torch.Tensor:
    """One ResBlock1 on x (B, L, C), f32 or bf16."""
    if x.device.type == "cpu":
        return resblock_plain(x, w)
    if w.n_res != 1:
        raise ValueError(f"resblock takes one resblock, got {w.n_res}")
    out = _launch(x, w, "resblock")
    resblock.launches += 1
    return out


def resblock_trio(x: torch.Tensor, w: ResblockWeights) -> torch.Tensor:
    """The ResBlock1s of one stage on x (B, L, C) from one read, averaged."""
    if x.device.type == "cpu":
        return resblock_trio_plain(x, w)
    out = _launch(x, w, "resblock_trio")
    resblock_trio.launches += 1
    return out


resblock.launches = 0
resblock_trio.launches = 0
