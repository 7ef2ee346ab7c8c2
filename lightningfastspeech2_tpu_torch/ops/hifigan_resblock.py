"""HiFi-GAN ResBlock1, one at a time (``resblock``) or all of one upsample
stage at once, averaged (``resblock_trio``).

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_hifigan.py``
(``fused_resblock`` / ``_resblock_kernel`` and ``fused_resblock_trio`` /
``_resblock_trio_kernel``). For a CUDA tensor the wrappers launch the
kernel in ``csrc/resblock.cu``; for a CPU tensor they run the plain
versions below. The TPU kernels' time-into-lanes fold (``tap_blocks``) was
a trick for the MXU and is not carried over: signals stay (B, L, C).
Every route runs on the tensor cores: bf16 at C >= 128 through wgmma,
bf16 below through mma.sync, f32 through mma.sync with split-TF32
products (three TF32 products each, f32 accuracy). The fused kernels are
built for C in ``KERNEL_CHANNELS`` (HiFi-GAN V1's stages and V2's narrower
ones). Past C = 256 (a HiFi-GAN at ``upsample_initial_channel`` 1024 has
C = 512 at stage 0) ``resblock`` takes the wide route of the same source
(route "gemm"): one launch a conv of the chain, each an implicit GEMM on
mma.sync with the output channels split across blocks, the intermediate
signals through device memory. A resblock of another C is zero-padded to
the width its route runs (``kernel_channels``: the next of
``KERNEL_CHANNELS`` up to 256, the next multiple of 128 past it):
``prepare_resblock_weights`` pads the taps and biases, the served
generator carries its stages' signals at the padded width, and a direct
call at the resblock's own C pads x once here. The padded channels stay
exactly 0 through the chain (leaky(0) = 0, zero taps and biases), and the
real channels see only added zeros.

The kernels have no backward: on a CUDA tensor the wrappers raise when
grad mode is on and x needs a gradient. A generator that trains runs its
resblocks on the training route (``Generator.forward(mel,
train_route=True)``: plain ``F.conv1d`` on the live parameters), and
serves again after ``Generator.prepare()``.

Numerics, kernel and plain alike: leaky_relu(0.1) on the working dtype
before the first conv of a pair, f32 accumulation, bias and the second
leaky in f32, a cast to the working dtype before the second conv and before
each residual add, every conv zero outside the signal. The trio sums its
resblock outputs in the working dtype and divides by their count.

Tap stacks are prepared once, when weights load
(``prepare_resblock_weights``, in the order the route reads them), not per
call. ``tile_plan`` is the one place that sizes a launch: the time tile,
its shared memory and blocks, and the share of conv work spent on halo
rows. Below C = 32 the plan weighs the bytes a block moves: there a row
is 16 to 64 bytes and the kernel is bound by bytes, not products.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream, refuse_grad
from lightningfastspeech2_tpu_torch.ops import gemm

LRELU_SLOPE = 0.1
# the H100 SXM: shared memory a block may take, and streaming multiprocessors
SMEM_PER_BLOCK = 232_448
SM_COUNT = 132
# bf16 routes: taps stream in K-chunks of this many elements (see
# _bf16_geometry); x and t rows are padded by 8 elements
_CHUNK = 8192
# f32 route (csrc/resblock.cu F32Geo): the tile plan's time model of a
# block, fitted to scripts/bench_resblock.py --sweep on an H100: each
# K-chunk costs _F32_CHUNK_US (its wait and block barrier) plus
# _F32_MMA_US per TF32 product of the busiest of the SM's four
# sub-partitions
_F32_CHUNK_US = 0.76
_F32_MMA_US = 0.0057
# clusters of 4 blocks an H100 runs at once (more take a second wave:
# scripts/bench_resblock.py --sweep, 32 clusters as slow as two waves)
_F32_CLUSTERS_AT_ONCE = 28
# the channel counts the fused kernels are built for; a narrower C is padded
# up to the next of them, a wider one to the wide route's multiple of 128
# (its product's output tile, ops/gemm.py)
KERNEL_CHANNELS = (8, 16, 32, 64, 128, 256)
# below this many channels a launch is bound by bytes (see tile_plan)
_NARROW = 32
_c_fn = None
_c_wide = None

# one residual pair: (w1, b1, dilation, w2, b2), torch Conv1d layout (C, C, k)
Pair = Tuple[torch.Tensor, torch.Tensor, int, torch.Tensor, torch.Tensor]


@dataclass(frozen=True)
class ChainShape:
    """What a launch's plan depends on besides (B, L): the channels, the
    dtype and the resblocks' kernel sizes and dilations."""

    channels: int
    dtype: torch.dtype
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[Tuple[int, ...], ...]

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


def kernel_channels(C: int) -> int:
    """The width the kernels run a C-channel resblock at: the least entry
    of ``KERNEL_CHANNELS`` that is at least C; past 256 the next multiple of
    128 (the wide route's tile)."""
    return next((k for k in KERNEL_CHANNELS if k >= C), -(-C // gemm.TILE) * gemm.TILE)


@dataclass
class ResblockWeights:
    """Prepared weights of ``n_res`` ResBlock1s of one stage, zero-padded
    from the resblocks' ``real_channels`` to ``channels``, the width the
    kernels run at."""

    channels: int
    real_channels: int
    dtype: torch.dtype
    kernel_sizes: Tuple[int, ...]
    dilations: Tuple[Tuple[int, ...], ...]
    taps: torch.Tensor      # every conv's taps, flat, working dtype, as _kernel_taps lays them
    bias: torch.Tensor      # (n_convs, C) f32
    pairs: List[List[Pair]]  # per resblock, f32 weights rounded through dtype
    # the tensors the taps were copied from: where they need a gradient, the
    # kernels refuse to launch under grad mode
    sources: Tuple[torch.Tensor, ...] = ()

    @property
    def shape(self) -> ChainShape:
        return ChainShape(self.channels, self.dtype, self.kernel_sizes, self.dilations)

    @property
    def n_res(self) -> int:
        return len(self.kernel_sizes)

    @property
    def reaches(self) -> Tuple[Tuple[int, ...], ...]:
        return self.shape.reaches

    @property
    def halo(self) -> int:
        return self.shape.halo

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
    per dilation]) with torch Conv1d weights (C, C, k). The taps, biases
    and plain-version weights are zero-padded to ``kernel_channels(C)``
    channels, in and out."""
    C = blocks[0][2][0][0].shape[0]
    P = kernel_channels(C)
    with torch.no_grad():
        taps, biases, pairs = [], [], []
        for k, ds, convs in blocks:
            rb_pairs = []
            for d, (w1, b1, w2, b2) in zip(ds, convs):
                w1, w2 = (F.pad(w, (0, 0, 0, P - C, 0, P - C)) for w in (w1, w2))
                b1, b2 = (F.pad(b, (0, P - C)) for b in (b1, b2))
                for w, b in ((w1, b1), (w2, b2)):
                    taps.append(_kernel_taps(w.to(dtype).permute(2, 1, 0)))
                    biases.append(b.float())
                rb_pairs.append((w1.to(dtype).float(), b1.float(), int(d),
                                 w2.to(dtype).float(), b2.float()))
            pairs.append(rb_pairs)
        return ResblockWeights(
            channels=P,
            real_channels=C,
            dtype=dtype,
            kernel_sizes=tuple(int(k) for k, _, _ in blocks),
            dilations=tuple(tuple(int(d) for d in ds) for _, ds, _ in blocks),
            taps=torch.cat(taps).contiguous(),
            bias=torch.stack(biases).contiguous(),
            pairs=pairs,
            sources=tuple(t for _, _, convs in blocks for c in convs for t in c),
        )


def _kernel_taps(w: torch.Tensor) -> torch.Tensor:
    """One conv's (k, C_in, C_out) taps, flat, as the kernel reads them.
    The wgmma route (bf16, C >= 128) copies 8192-element K-chunks of the
    (k C_in, C_out) matrix into shared memory as they lie, so each chunk is
    stored as its shared-memory image: 64-channel boxes of 128-byte rows,
    the 16-byte pieces of row r at piece index ^ (r % 8). The f32 route
    takes them split (``split_taps``). bf16 below C = 128, and a C that no
    kernel takes, keep the order; the wide route past C = 256 (both dtypes,
    f32 split as read) takes the (C_out, k C_in) transpose, each output
    channel's taps contiguous."""
    k, C, _ = w.shape
    if C > KERNEL_CHANNELS[-1]:
        return w.permute(2, 0, 1).reshape(-1)
    if C not in KERNEL_CHANNELS:
        return w.reshape(-1)
    if w.dtype == torch.float32:
        return split_taps(w, _f32_split(C))
    if _bf16_geometry(C)[0] != "wgmma":
        return w.reshape(-1)
    kc = _CHUNK // C
    # (chunk, row, box, piece, element) -> (chunk, box, row, swizzled piece, element)
    m = w.reshape(k * C // kc, kc, C // 64, 8, 8).permute(0, 2, 1, 3, 4)
    piece = torch.arange(8)[None, :] ^ (torch.arange(kc)[:, None] % 8)   # (row, slot)
    idx = piece.to(w.device)[None, None, :, :, None].expand(m.shape)
    return torch.gather(m, 3, idx).reshape(-1)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """f32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32``: integer ops on the bits."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_taps(w: torch.Tensor, ns: int = 1) -> torch.Tensor:
    """f32 (k, C_in, C_out) taps as the f32 route reads them: hi = tf32(w),
    lo = tf32(w - hi), so hi + lo is w within 2^-22 of |w|, in mma.sync's
    B-fragment order. Row kk = j C_in + c_in of the (k C_in, C_out) matrix
    lies in k-step kk // 8; within the k-step, channels 2t and 2t + 1 are
    the product's k indices t and t + 4. The outputs are cut into ``ns``
    blocks' parts (a cluster's blocks, C_out / ns channels each), one after
    the other; within a part, per (k-step, n8 tile of its outputs, lane =
    4 g + t) four floats: hi of rows 2t, 2t + 1 at output 8 nt + g, then lo
    of the same. A K-chunk of a part is a run of whole k-steps, so it is
    one contiguous piece."""
    k, C, Co = w.shape
    hi = tf32(w.float())
    lo = tf32(w.float() - hi)
    # (k-step, t, e, part, n8 tile, g) -> (part, k-step, n8 tile, g, t, hi/lo, e)
    parts = [h.reshape(k * C // 8, 4, 2, ns, Co // 8 // ns, 8).permute(3, 0, 4, 5, 1, 2)
             for h in (hi, lo)]
    return torch.stack(parts, dim=5).reshape(-1)


def _conv_f32(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              dilation: int) -> torch.Tensor:
    pad = dilation * (w.shape[-1] - 1) // 2
    return F.conv1d(h.float().transpose(1, 2), w, b, padding=pad,
                    dilation=dilation).transpose(1, 2)


def leaky(x: torch.Tensor) -> torch.Tensor:
    """max(x, 0.1 x) in x's dtype: for bf16 the product is taken in f32
    (0.1f, not bf16's 0.10009765625) and rounded once, as the kernels do."""
    return torch.maximum(x, x * LRELU_SLOPE)


def _one_plain(x: torch.Tensor, pairs: Sequence[Pair]) -> torch.Tensor:
    dt = x.dtype
    for w1, b1, d, w2, b2 in pairs:
        t = _conv_f32(leaky(x), w1, b1, d)
        t = leaky(t).to(dt)
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


def conv_rows(w: ChainShape | ResblockWeights, tile: int) -> Tuple[Tuple[int, ...], ...]:
    """Per resblock, the rows each conv of the chain computes for a tile:
    the tile plus twice the reach of the convs still ahead of it."""
    out = []
    for reaches in w.reaches:
        rem = sum(reaches)
        rows = []
        for q in reaches:
            rem -= q
            rows.append(tile + 2 * rem)
        out.append(tuple(rows))
    return tuple(out)


def halo_share(w: ChainShape | ResblockWeights, tile: int) -> float:
    """Share of the kernel's conv work spent on halo rows, which the
    neighbouring block computes too."""
    total = extra = 0
    for k, rows in zip(w.kernel_sizes, conv_rows(w, tile)):
        total += k * sum(rows)
        extra += k * sum(r - tile for r in rows)
    return extra / total


@dataclass(frozen=True)
class TilePlan:
    """How one launch is cut: ``tile`` output rows a block (a row tile
    shared by a cluster of 4 blocks on route "mma_tf32_c4"), ``blocks`` in
    all, ``smem_bytes`` of shared memory each; ``x_in_smem`` keeps the
    residual signal in shared memory, else (f32 only) in device scratch."""

    route: str             # bf16: "wgmma" (C >= 128) or "mma" (mma.sync); f32 (split
    tile: int              # TF32): "mma_tf32", "mma_tf32_xl2" (x in L2), "mma_tf32_c4";
    #                        past C = 256 both: "gemm" (one launch a conv; tile: its rows a block)
    blocks: int
    smem_bytes: int
    x_in_smem: bool
    halo_share: float


def _t_lo(w: ChainShape) -> int:
    """The lowest buffer row of the first convs' outputs t."""
    return min(w.halo - sum(r) + r[0] for r in w.reaches)


def _bf16_ld(C: int) -> int:
    """The bf16 row stride in shared memory (elements): C + 8, and 24 at
    C = 8, so that eight consecutive rows fall in distinct bank groups."""
    return 24 if C == 8 else C + 8


def _bf16_geometry(C: int) -> Tuple[str, int, int, int, int]:
    """(route, rows a pass, rows a warp or warpgroup tile, K rows a chunk,
    tap-ring bytes) at C channels, as csrc/resblock.cu MmaGeo<C>, WgGeo<C>
    and bf16_smem_bytes lay them out (a card test and chip_smoke.py hold
    launches' tile, grid and shared memory against the plan, as
    ``last_launch`` reads them): wgmma at C >= 128, a 3-stage ring of
    swizzled chunks, the 1 KB that aligns it and 64 bytes of mbarriers;
    mma.sync below, a 2-stage ring of row-padded chunks of at most 256
    K rows."""
    if C >= 128:
        return "wgmma", 128, 64, _CHUNK // C, 1024 + 3 * _CHUNK * 2 + 64
    kc = min(_CHUNK // C, 256)
    return "mma", 256, 32, kc, 2 * kc * _bf16_ld(C) * 2


def _bf16_smem(w: ChainShape, tile: int) -> int:
    """The bf16 launch's shared memory: the tap ring, the signal x (tile +
    2 halo rows) and the first convs' outputs t, from their lowest row."""
    C, halo = w.channels, w.halo
    rows = (tile + 2 * halo) + (tile + 2 * (halo - _t_lo(w)))
    return _bf16_geometry(C)[4] + rows * _bf16_ld(C) * 2


def _bf16_cost(w: ChainShape, tile: int) -> float:
    """A block's work in units of one full chunk at C=256: every pass of
    every conv walks all of the conv's K-chunks (the loads), and a chunk
    costs more than a load where its products outweigh a C=256 pass's."""
    C = w.channels
    _, pass_rows, tile_rows, kc, _ = _bf16_geometry(C)
    cost = 0.0
    for k, rows in zip(w.kernel_sizes, conv_rows(w, tile)):
        chunks = -(-k * C // kc)
        for n in rows:
            for p0 in range(0, n, pass_rows):
                active = -(-min(pass_rows, n - p0) // tile_rows) * tile_rows
                cost += chunks * max(1.0, active * kc * C / (64 * _CHUNK))
    return cost


def _f32_split(C: int) -> int:
    """Blocks that share a row tile, each with C / n of the outputs: 4 at
    C = 256 (a cluster), else 1."""
    return 4 if C == 256 else 1


def _f32_kc(C: int) -> int:
    """K rows of an f32 chunk (csrc/resblock.cu F32Geo<C, NS>::KC): 192
    below C = 32 (a whole conv's taps up to k = 12 at C = 16), else as many
    as fit 32 KB, at most C."""
    return 192 if C < _NARROW else min(C, 4096 // (C // _f32_split(C)))


def _f32_geometry(C: int) -> Tuple[int, int, int, int]:
    """(rows a pass, warps across a block's channels, m16 tiles a warp,
    bytes of a K-chunk of hi and lo taps) at C channels, as csrc/resblock.cu
    F32Geo<C, NS> lays them out: eight warps of 32 rows by 64 of the
    block's CN = C / NS output channels (CN at CN <= 32), chunks of 32 KB
    (8 KB at C = 32, 24 KB at 16, 12 KB at 8) in a 2-stage ring, 16 bytes
    of mbarriers beside it."""
    cn = C // _f32_split(C)
    mt, wn = 2, max(1, cn // 64)
    return 16 * mt * (8 // wn), wn, mt, _f32_kc(C) * cn * 8


def _f32_smem(w: ChainShape, tile: int, x_in_smem: bool) -> int:
    """The f32 launch's shared memory: the tap ring and its mbarriers, then
    t (one block a tile) and x (where it lies there), at C + 8 floats a
    row."""
    C, halo = w.channels, w.halo
    t_rows = tile + 2 * (halo - _t_lo(w)) if _f32_split(C) == 1 else 0
    rows = t_rows + (tile + 2 * halo if x_in_smem else 0)
    return 2 * _f32_geometry(C)[3] + 16 + rows * (C + 8) * 4


def _f32_us(w: ChainShape, tile: int) -> float:
    """A block's time by the model above: every pass of every conv walks
    all of the conv's K-chunks, each with its products for the warps of
    the row groups that have rows in the pass."""
    C = w.channels
    pass_rows, wn, mt, _ = _f32_geometry(C)
    cn = C // _f32_split(C)
    kc = _f32_kc(C)
    step = 3 * mt * (cn // 8 // wn) * _F32_MMA_US   # one warp's k-step
    us = 0.0
    for k, rows in zip(w.kernel_sizes, conv_rows(w, tile)):
        for n in rows:
            for p0 in range(0, n, pass_rows):
                groups = -(-min(pass_rows, n - p0) // (16 * mt))
                busy = -(-groups * wn // 4)
                us += -(-k * C // kc) * _F32_CHUNK_US + k * C // 8 * busy * step
    return us


def _narrow_bytes(w: ChainShape, tile: int) -> int:
    """The bytes a block moves below C = 32, where the work is bound by
    them: each resblock's x rows (the tile and its reach on both sides),
    the output's tile written once and read again by each later resblock
    of a trio, and every conv's taps."""
    C, f32 = w.channels, w.dtype == torch.float32
    rows = sum(tile + 2 * sum(r) for r in w.reaches) + (2 * len(w.reaches) - 1) * tile
    taps = sum(2 * len(ds) * k * C * C for k, ds in zip(w.kernel_sizes, w.dilations))
    # f32 taps are split into TF32 hi and lo halves
    return rows * C * (4 if f32 else 2) + taps * (8 if f32 else 2)


def tile_plan(w: ResblockWeights, B: int, L: int) -> TilePlan:
    """The launch of ``w``'s kernel on (B, L, C): the tile (a multiple of
    16) that minimises the waves of blocks over the card's SMs times a
    block's time, larger tiles winning ties. bf16 weighs a block's chunk
    loads and products (``_bf16_cost``); f32 (``_f32_us``) also picks where
    x lies below C = 256: with x in L2 a tile can be larger. Below C = 32
    both weigh the bytes a block moves (``_narrow_bytes``): the least
    waves, and in them the shortest tile, so the least halo. The latest
    plans are kept per (shape, B, L): serving asks for a few frame
    buckets' lengths, each launch looks its plan up."""
    return _make_plan(w.shape, B, L)


def _f32_options(w: ChainShape, tile: int):
    """(route, x_in_smem, shared memory) of the f32 launches of a tile that
    fit: one block a tile with x in shared memory or in L2; at C = 256 a
    cluster of 4 blocks a tile with x and t in L2 (the rest of the SM's
    256 KB then caches their reads in L1)."""
    routes = ((("mma_tf32_c4", False),) if _f32_split(w.channels) > 1 else
              (("mma_tf32", True), ("mma_tf32_xl2", False)))
    for route, xs in routes:
        smem = _f32_smem(w, tile, xs)
        if smem <= SMEM_PER_BLOCK:
            yield route, xs, smem


def _wide_plan(w: ChainShape, B: int, L: int) -> TilePlan:
    """The wide route's launches (every conv alike): ``ops/gemm.py``'s 128
    rows by 128 output channels a block over all B L rows; no halo
    recomputed."""
    blocks = (w.channels // gemm.TILE) * -(-B * L // gemm.TILE)
    return TilePlan("gemm", gemm.TILE, blocks, gemm.smem_bytes(w.dtype), False, 0.0)


@functools.lru_cache(maxsize=256)
def _make_plan(w: ChainShape, B: int, L: int) -> TilePlan:
    C, halo = w.channels, w.halo
    if C > KERNEL_CHANNELS[-1]:
        return _wide_plan(w, B, L)
    best = None
    split = _f32_split(C) if w.dtype == torch.float32 else 1
    at_once = SM_COUNT if split == 1 else _F32_CLUSTERS_AT_ONCE * split
    for tile in range(16, 16 * -(-L // 16) + 1, 16):
        blocks = split * B * -(-L // tile)
        waves = math.ceil(blocks / at_once)
        if w.dtype == torch.bfloat16:
            smem = _bf16_smem(w, tile)
            cost = _narrow_bytes(w, tile) if C < _NARROW else _bf16_cost(w, tile)
            options = ([(_bf16_geometry(C)[0], True, smem, cost)]
                       if smem <= SMEM_PER_BLOCK else [])
        else:
            options = [(route, xs, smem,
                        _narrow_bytes(w, tile) if C < _NARROW else _f32_us(w, tile))
                       for route, xs, smem in _f32_options(w, tile)]
        if not options:
            break
        for route, xs, smem, cost in options:
            est = waves * cost
            # larger tiles win ties, and x in shared memory wins ties with L2
            if best is None or est < best[0] or (est == best[0] and xs >= best[5]):
                best = (est, route, tile, blocks, smem, xs)
    if best is None:
        raise ValueError(f"resblock kernel: C={C} with halo {halo} does not fit")
    _, route, tile, blocks, smem, xs = best
    return TilePlan(route, tile, blocks, smem, xs, halo_share(w, tile))


def _wide_fn():
    global _c_wide
    if _c_wide is None:
        lib = build.load("resblock")
        fn = lib.lfs2_resblock_wide
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, ctypes.POINTER(ctypes.c_int), i, p]
        fn.restype = ctypes.c_int
        _c_wide = (lib, fn)
    return _c_wide


def _fn():
    global _c_fn
    if _c_fn is None:
        lib = build.load("resblock")
        fn = lib.lfs2_resblock
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, i, i, ctypes.POINTER(ctypes.c_int),
                       i, i, i, i, p]
        fn.restype = ctypes.c_int
        lib.lfs2_resblock_last_launch.argtypes = [ctypes.POINTER(ctypes.c_int)]
        lib.lfs2_resblock_last_launch.restype = ctypes.c_int
        _c_fn = (lib, fn)
    return _c_fn


def last_launch() -> Dict[str, int]:
    """The kernel's latest launch, either route, as the library recorded it
    when the launch was accepted: its blocks, shared-memory bytes a block
    and time tile; zeros before the first."""
    lib, _ = _fn()
    rec = (ctypes.c_int * 5)()
    build.check(lib, lib.lfs2_resblock_last_launch(rec), "resblock launch query")
    return {"blocks": rec[0] * rec[1] * rec[2], "smem_bytes": rec[3], "tile": rec[4]}


def _launch(x: torch.Tensor, w: ResblockWeights, what: str,
            plan: TilePlan | None = None) -> torch.Tensor:
    stream = kernel_stream(x, w.taps, w.bias)
    B, L, C = x.shape
    if x.dtype not in build.DTYPE_CODES or w.taps.dtype != x.dtype:
        raise ValueError(f"{what} takes f32 or bf16 x with taps of the same dtype, "
                         f"got {x.dtype}, {w.taps.dtype}")
    if C != w.channels:
        raise ValueError(f"{what}: x has C={C}, its weights {w.channels}")
    if w.n_res > 3 or any(len(ds) > 3 for ds in w.dilations):
        raise ValueError(f"{what} kernel takes up to 3 resblocks of up to 3 pairs")
    if C not in KERNEL_CHANNELS:
        if C % gemm.TILE or w.n_res != 1:
            raise ValueError(f"{what} kernel takes C in {KERNEL_CHANNELS} or, one resblock "
                             f"at a time, a multiple of {gemm.TILE} (padded by "
                             f"kernel_channels), got C={C} with {w.n_res} resblocks")
        layout = w.layout
        out, y = torch.empty_like(x), torch.empty_like(x)   # y: each pair's first conv
        lib, fn = _wide_fn()
        rc = fn(x.data_ptr(), out.data_ptr(), w.taps.data_ptr(), w.bias.data_ptr(),
                y.data_ptr(), B, L, C, (ctypes.c_int * len(layout))(*layout),
                build.DTYPE_CODES[x.dtype], stream)
        build.check(lib, rc, what)
        return out
    plan = plan or tile_plan(w, B, L)
    split = _f32_split(C) if x.dtype == torch.float32 else 1
    if plan.x_in_smem:
        scratch = torch.empty(0, dtype=x.dtype, device=x.device)
    else:  # x, and with a split tile t, per tile
        rows = plan.tile + 2 * w.halo
        if split > 1:
            rows += plan.tile + 2 * (w.halo - _t_lo(w.shape))
        scratch = torch.empty(plan.blocks // split * rows * C, dtype=x.dtype, device=x.device)
    layout = w.layout
    c_layout = (ctypes.c_int * len(layout))(*layout)
    out = torch.empty_like(x)
    lib, fn = _fn()
    rc = fn(x.data_ptr(), out.data_ptr(), w.taps.data_ptr(), w.bias.data_ptr(),
            scratch.data_ptr(), B, L, C, plan.tile, w.halo, c_layout, w.n_res,
            int(plan.x_in_smem), split, build.DTYPE_CODES[x.dtype], stream)
    build.check(lib, rc, what)
    return out


_TRAIN_ROUTE = "the generator's training route (Generator.forward(mel, train_route=True))"


def _padded_call(wrapper, x: torch.Tensor, w: ResblockWeights) -> torch.Tensor:
    """``wrapper`` on x (B, L, C) given at the resblocks' own C below the
    kernels' width: x zero-padded once (one copy, counted in the wrapper's
    ``pad_copies``), the output cut back to C. The served generator never
    takes this: its stages carry the padded width."""
    C = x.shape[-1]
    wrapper.pad_copies += 1
    out = wrapper(F.pad(x, (0, w.channels - C)), w)
    return out[..., :C].contiguous()


def resblock(x: torch.Tensor, w: ResblockWeights) -> torch.Tensor:
    """One ResBlock1 on x (B, L, C), f32 or bf16; C is the weights' padded
    width, or their own (then x is padded here). On the card it raises
    under grad mode where x or a parameter the taps came from needs a
    gradient (the kernel has no backward)."""
    if x.shape[-1] == w.real_channels != w.channels:
        return _padded_call(resblock, x, w)
    if x.device.type == "cpu":
        return resblock_plain(x, w)
    if w.n_res != 1:
        raise ValueError(f"resblock takes one resblock, got {w.n_res}")
    refuse_grad("resblock", _TRAIN_ROUTE, x, *w.sources)
    out = _launch(x, w, "resblock")
    resblock.launches += 1
    resblock.by_width[w.real_channels] = resblock.by_width.get(w.real_channels, 0) + 1
    return out


def resblock_trio(x: torch.Tensor, w: ResblockWeights) -> torch.Tensor:
    """The ResBlock1s of one stage on x (B, L, C) from one read, averaged;
    C as for ``resblock``. On the card it raises as ``resblock`` does under
    grad mode."""
    if x.shape[-1] == w.real_channels != w.channels:
        return _padded_call(resblock_trio, x, w)
    if x.device.type == "cpu":
        return resblock_trio_plain(x, w)
    refuse_grad("resblock_trio", _TRAIN_ROUTE, x, *w.sources)
    out = _launch(x, w, "resblock_trio")
    resblock_trio.launches += 1
    resblock_trio.by_width[w.real_channels] = resblock_trio.by_width.get(w.real_channels, 0) + 1
    return out


resblock.launches = 0
resblock_trio.launches = 0
# launches by the resblocks' own channel count, set to {} with the count
resblock.by_width = {}
resblock_trio.by_width = {}
# copies of x padded to the kernels' width in a direct call (_padded_call)
resblock.pad_copies = 0
resblock_trio.pad_copies = 0
