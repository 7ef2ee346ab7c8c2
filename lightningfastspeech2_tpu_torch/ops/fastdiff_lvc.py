"""FastDiff's time-aware LVC chain: all layers of one upsample stage.

Counterpart of ``lightningfastspeech2_tpu/ops/pallas_fastdiff.py``
(``fused_lvc_stack`` / ``_stack_kernel``). Per layer i of a stage with hop
``hop`` (the samples one mel frame covers at that stage):

    x += audio_down; y = leaky(x, 0.2); y = dilated_conv_i(y)  (k=3, d=3^i)
    y = leaky(y, 0.2); g = LVC(y, frame kernels and biases of layer i)
    x += sigmoid(g[:C]) * tanh(g[C:])          (or the Padé gate)

For a CUDA tensor ``lvc_stack`` launches the kernel in
``csrc/lvc_stack.cu``; for a CPU tensor it runs ``lvc_stack_plain``. Both
round where the TPU kernel rounds: x and audio_down, the leaky input of the
conv and the LVC input in the working dtype; conv and LVC products summed
in f32 with f32 biases; the gate in f32, rounded to the working dtype
before the residual add.

``lvc_plan`` is the one place that sizes a launch: the route (the tensor
cores when the hop is a multiple of 8 and a launch fits, the CUDA cores
otherwise), the tile, halo, frames, shared memory and blocks. The wrapper
passes it to the library and holds the launch the library records
(``last_launch``) to it.

The fused kernel is built at C = 16, 32, 64 and 128 (``KERNEL_CHANNELS``).
Other widths up to 128 are zero-padded to the next of them
(``pad_lvc_inputs``) and the output sliced back: padded channels of x,
audio_down, the conv's taps and bias and the frame kernels' and biases'
rows and columns are 0, so each stays 0 through every layer (its gate is
sigmoid(0) tanh(0) = 0, and 0 with the Padé gate too) and adds nothing to
the real channels. Past 128 the wide route (``WIDE_ROUTE``) takes every
width: one layer at a time, x, audio_down and the conv's taps zero-padded
to the next multiple of 16 (``wide_channels``), the frame kernels and
biases read at the real C and never copied.

The elementwise pieces (``fast_tanh``, ``gated_activation``) and
``location_variable_convolution`` live here too; ``vocoder.fastdiff``
takes them from this module.

Which stages take the kernel is the JAX package's rule
(``vocoder/fastdiff.py`` ``eps_apply_fused``), kept as it stands:
``routes_to_kernel``.
"""

from __future__ import annotations

import ctypes
import functools
import os
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream, refuse_grad

LRELU_SLOPE = 0.2
# the JAX path's frame tile for a stage whose hop is below the reach when
# LFS2_FUSED_STAGE1 is set (max(tile, 16), and its dtype tiles are <= 16)
HALO_TILE_FRAMES = 16
# the H100 SXM: shared memory a block may take, and streaming multiprocessors
SMEM_PER_BLOCK = 232_448
SM_COUNT = 132
# the widths csrc/lvc_stack.cu is built at; others up to the last are padded
# to the next of them
KERNEL_CHANNELS = (16, 32, 64, 128)
MAX_CHANNELS = KERNEL_CHANNELS[-1]
# past MAX_CHANNELS: csrc/lvc_stack.cu's wide route (lfs2_lvc_stack_wide),
# 64 rows of one frame by 128 gate columns a block, two shared-memory
# stages of (64 + 256) rows of 3 CK k values (wide::smem_bytes: 71,680
# bytes in both dtypes)
WIDE_ROUTE = "wide"
WIDE_ROWS, WIDE_GATE_COLUMNS = 64, 128
WIDE_SMEM = 71_680
# CUDA-core route: output rows per block, largest first (the largest that
# still gives every SM a block); below them, for wide rows, the largest
# that fits a block; regions rounded to 4 rows
_CORES_TILES = (256, 128, 64)
_CORES_SMALL_TILES = (32, 16)
_CORES_ALIGN = 4
# tensor-core route (csrc/lvc_stack.cu): output rows per block, largest
# first
_MMA_TILES = (512, 256, 128, 64, 32)
_c_fn = None
_c_last = None


def fast_tanh(x: torch.Tensor) -> torch.Tensor:
    """Clamped Padé(7,6) tanh: max abs error 9.6e-5 over the whole line."""
    t = torch.clamp(x, -4.97, 4.97)
    t2 = t * t
    num = t * (135135.0 + t2 * (17325.0 + t2 * (378.0 + t2)))
    den = 135135.0 + t2 * (62370.0 + t2 * (3150.0 + t2 * 28.0))
    return torch.clamp(num / den, -1.0, 1.0)


def fast_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """sigmoid(x) = 0.5 (1 + tanh(x/2)) via fast_tanh; max err ~5e-5."""
    return 0.5 * (fast_tanh(0.5 * x) + 1.0)


def gated_activation(y: torch.Tensor, channels: int, fast: bool) -> torch.Tensor:
    """sigmoid(y[..., :C]) * tanh(y[..., C:]), or the rational
    approximations with ``fast`` (the config's ``fast_gating``)."""
    a, b = y[..., :channels], y[..., channels:]
    if fast:
        return fast_sigmoid(a) * fast_tanh(b)
    return torch.sigmoid(a) * torch.tanh(b)


def location_variable_convolution(x: torch.Tensor, kernels: torch.Tensor,
                                  bias: torch.Tensor, hop: int) -> torch.Tensor:
    """Per-frame convolution with frame-local kernels: x (B, L, Cin),
    kernels (B, nL, Cin, Cout, ks), bias (B, nL, Cout) -> (B, L, Cout). Tap
    k reads the rows [k, k + L) of the zero-padded signal, reshaped to
    (nL, hop): three shifted batched products, no gather."""
    B, L, Cin = x.shape
    _, nL, _, Cout, ks = kernels.shape
    if L != nL * hop:
        raise ValueError(f"{L} != {nL}*{hop}")
    pad = (ks - 1) // 2
    xp = F.pad(x, (0, 0, pad, pad))
    out = None
    for k in range(ks):
        seg = xp[:, k:k + L].reshape(B, nL, hop, Cin)
        contrib = torch.einsum("blti,blio->blto", seg, kernels[..., k])
        out = contrib if out is None else out + contrib
    out = out + bias[:, :, None, :]
    return out.reshape(B, L, Cout)


def lvc_reach(layers: int) -> int:
    """Samples the chain reaches on each side: each layer's dilated conv
    (3^i) and its LVC (1); 44 for four layers."""
    return sum(3 ** i + 1 for i in range(layers))


def pick_halo_frames(reach: int, hop: int, frames: int):
    """Smallest divisor of ``frames`` whose rows cover ``reach``, or None
    (the JAX package's ``pick_halo_frames``, used here only for routing)."""
    for h in range(1, frames + 1):
        if frames % h == 0 and h * hop >= reach:
            return h
    return None


def stage1_opt_in() -> bool:
    """``LFS2_FUSED_STAGE1``, read at each call: sends a stage whose hop is
    below the reach to the kernel too, where the JAX path would fuse it."""
    return os.environ.get("LFS2_FUSED_STAGE1", "0").lower() in ("1", "true", "on")


def routes_to_kernel(hop: int, n_frames: int, layers: int) -> bool:
    """Whether a stage's chain goes to ``lvc_stack``: the JAX gate of
    ``eps_apply_fused``, ``hop >= reach``, or the opt-in with a halo of
    whole frames inside a tile of min(16, n_frames) frames."""
    reach = lvc_reach(layers)
    if hop >= reach:
        return True
    return stage1_opt_in() and pick_halo_frames(
        reach, hop, min(HALO_TILE_FRAMES, n_frames)) is not None


def _conv_f32(y: torch.Tensor, w: torch.Tensor, b: torch.Tensor, d: int) -> torch.Tensor:
    """Same-padded dilated conv of y (B, L, C) with taps w (3, Cin, Cout),
    in f32."""
    wt = w.float().permute(2, 1, 0)
    return F.conv1d(y.float().transpose(1, 2), wt, b.float(), padding=d,
                    dilation=d).transpose(1, 2)


def lvc_stack_plain(x, audio_down, kernels, biases, conv_w, conv_b, hop: int,
                    fast_gating: bool = False) -> torch.Tensor:
    """The chain in plain PyTorch, rounding where the kernel rounds.

    x, audio_down (B, L, C) in the working dtype; kernels (B, nL, layers,
    C, 2C, 3) (the kernel predictor's layout); biases (B, nL, layers, 2C);
    conv_w (layers, 3, C, C) taps (k, in, out); conv_b (layers, C)."""
    dt = x.dtype
    C = x.shape[-1]
    ad = audio_down.to(dt)
    for i in range(kernels.shape[2]):
        d = 3 ** i
        x = x + ad
        y = torch.maximum(x, x * LRELU_SLOPE)
        y = _conv_f32(y, conv_w[i].to(dt), conv_b[i], d)
        y = torch.maximum(y, y * LRELU_SLOPE).to(dt)
        g = location_variable_convolution(
            y.float(), kernels[:, :, i].to(dt).float(), biases[:, :, i].float(), hop)
        x = x + gated_activation(g, C, fast_gating).to(dt)
    return x


# lvc_stack in bf16 against lvc_stack_plain, which rounds at the same
# places: a value differs only where a sum taken in another order rounds
# the other way, and that flip carries down the residual chain
# (chip_smoke.py prints both measures for each shape it checks)
BF16_MAX_ULPS = 3
BF16_MAX_UNEQUAL = 0.02
# past MAX_CHANNELS (the wide route): the share of unequal values a chain
# may show, whatever its width
BF16_WIDE_UNEQUAL = 0.16


def bf16_chain_limits(C: int):
    """(most ulps, largest share of unequal values) for a bf16 chain of C
    channels: ``BF16_MAX_ULPS`` and ``BF16_MAX_UNEQUAL`` up to C = 32, past
    it the ulps times C / 32 and, up to 128, the share times (C / 32)^2. A
    flip reaches further as C grows: each conv and LVC input feeds 3C sums
    of its row's neighbours, and longer sums flip more roundings. The plain
    chain itself, against the same chain with its sums taken in f64,
    differs at about 0.02 % of values at C = 32, 0.16 % at 64 and 0.9 % at
    128, by up to 0.5, 1 and 2 ulps (tests/test_torch_lvc_plan.py). Past
    128 that share stops growing (2.8 % at 192, 2.6 % at 256, 3.9 % at
    512, by up to 2.9, 5.3 and 12 ulps): the 3C-term LVC sums saturate more
    gates, and a saturated gate rounds alike in any order. So past 128 the
    share is ``BF16_WIDE_UNEQUAL``, four times the most of them, where a
    gate off by 1e-3 changes 22-30 % of values."""
    w = max(1.0, C / 32)
    if C > MAX_CHANNELS:
        return BF16_MAX_ULPS * w, BF16_WIDE_UNEQUAL
    return BF16_MAX_ULPS * w, BF16_MAX_UNEQUAL * w * w


def bf16_chain_error(out, ref, x, audio_down, layers: int):
    """How far a bf16 chain ``out`` lies from ``ref`` (both from x0 = ``x``
    and ``audio_down``): the largest |out - ref| in bf16 ulps of a bound on
    every |x| the chain holds at that value, |x0| + layers (|audio_down| +
    1) (each gate lies in (-1, 1)), and the share of values that differ.
    They agree within ``bf16_chain_limits`` of the width. A value's
    own |ref| is no bound: x cancels to near 0 where it held a large value."""
    s = x.float().abs() + layers * (audio_down.float().abs() + 1.0)
    diff = (out.float() - ref.float()).abs()
    ulps = diff / torch.exp2(torch.floor(torch.log2(s)) - 7)
    return ulps.max().item(), (diff > 0).float().mean().item()


def _fn():
    """The library and its two launchers: the fused chain
    (``lfs2_lvc_stack``) and the wide route (``lfs2_lvc_stack_wide``)."""
    global _c_fn
    if _c_fn is None:
        lib = build.load("lvc_stack")
        p, i = ctypes.c_void_p, ctypes.c_int
        fused, wide = lib.lfs2_lvc_stack, lib.lfs2_lvc_stack_wide
        fused.argtypes = [p] * 7 + [i] * 11 + [p]
        wide.argtypes = [p] * 8 + [i] * 7 + [p]
        fused.restype = wide.restype = ctypes.c_int
        _c_fn = (lib, fused, wide)
    return _c_fn


def _floor_to(v: int, m: int) -> int:
    return v // m * m


def mma_regions(layers: int, tile: int):
    """The tensor-core route's rows, as ``make_mma_spec`` computes them:
    (halo, rows, [(b_lo, b_hi)], [(c_lo, c_hi)]) in buffer rows (row 0 is
    signal position tile_start - halo), per layer the dilated conv's rows
    and the LVC's, exactly what the next step reads; the halo is the
    chain's reach rounded up to 8."""
    lo, hi = 0, tile
    b, c = [None] * layers, [None] * layers
    for i in reversed(range(layers)):
        c[i] = (lo, hi)
        b[i] = (lo - 1, hi + 1)
        lo, hi = b[i][0] - 3 ** i, b[i][1] + 3 ** i
    halo = -_floor_to(lo, 8)
    return (halo, tile + 2 * halo, [(x + halo, y + halo) for x, y in b],
            [(x + halo, y + halo) for x, y in c])


def _cores_halo(layers: int, tile: int) -> int:
    """The CUDA-core route's halo, as ``make_spec`` computes it: each step's
    rows rounded out to 4."""
    lo, hi = 0, tile
    for i in reversed(range(layers)):
        lo = _floor_to(lo, _CORES_ALIGN) - 1 - 3 ** i
        hi = -_floor_to(-hi, _CORES_ALIGN) + 1 + 3 ** i
    return -_floor_to(-max(-lo, hi - tile), _CORES_ALIGN)


def kernel_channels(C: int) -> int:
    """The width the kernel runs a C-channel chain at: the narrowest of
    ``KERNEL_CHANNELS`` that holds C (a multiple of 16: the tensor cores'
    m16 tiles and k16 steps); past them ``wide_channels``."""
    return next((k for k in KERNEL_CHANNELS if k >= C), None) or wide_channels(C)


def wide_channels(C: int) -> int:
    """The width of the wide route's signal rows (x, audio_down, the conv's
    output): C rounded up to 16, so that its 16-byte row loads stay whole."""
    return -(-C // 16) * 16


def mma_direct(dtype: torch.dtype, C: int) -> bool:
    """Whether the tensor-core route reads its weights straight from device
    memory at kernel width C (``Mma<T, C>::DIRECT``): where one frame's
    staged kernel leaves no room beside the rows, bf16 at C = 128 and f32
    from C = 64 (route "mma_direct"); elsewhere it stages them (route
    "mma")."""
    return C >= (128 if dtype == torch.bfloat16 else 64)


def mma_smem_bytes(dtype: torch.dtype, rows: int, round_frames: int, nt: int,
                   C: int = 32) -> int:
    """Shared memory of a tensor-core launch at kernel width C
    (``mma_smem_bytes`` in the source): two mbarriers, x, audio_down and the
    LVC input rows (a row C + 16 bytes' worth of elements); staged, in bf16
    the conv taps and per staged frame its kernel in [k][out] order and its
    raw copy, in f32 the conv taps split into TF32 hi and lo halves and per
    frame its kernel in [out][k] order, split where chunks hold more than
    one row tile (``nt`` > 1, the next round's raw kernels then wait in
    registers, two frames at most), else two raw copies by round parity,
    read raw; direct, nothing more."""
    elem = torch.finfo(dtype).bits // 8
    K, frame, ldt = 3 * C, C * 2 * C * 3, 3 * C + 4
    rows_bytes = 16 + 3 * rows * (C + 16 // elem) * elem
    if mma_direct(dtype, C):
        return rows_bytes
    if dtype == torch.bfloat16:
        return rows_bytes + 2 * (K * (C + 8) + round_frames * (K * (2 * C + 8) + frame))
    per_frame = 2 * 2 * C * ldt if nt > 1 else 2 * frame
    return rows_bytes + 4 * (2 * C * ldt + round_frames * per_frame)


def _frames_touched(hop: int, n_rows: int, n_frames: int) -> int:
    """The most frames ``n_rows`` consecutive signal rows can touch."""
    return min(n_frames, (hop + n_rows - 2) // hop + 1)


@dataclass(frozen=True)
class LvcPlan:
    """One launch of ``lvc_stack``. ``route``: "mma" (tensor cores,
    weights staged in shared memory), "mma_direct" (tensor cores, weights
    read from device memory), "cuda_cores" or "wide" (C > 128: per layer a
    conv launch and an LVC launch, the record and these fields the LVC
    launch's); ``tile``: output rows a block (the wide route's rows of one
    frame); ``halo``: rows a side (0 on the wide route, whose rows are
    one layer's); ``rows``: tile + 2 halo; ``frames``: the most frames one
    layer's LVC rows touch in a block; ``round_frames``: frames whose
    kernels a block stages at once (0 on the other routes, which read them
    from device memory); ``nt``: n8 row tiles of an LVC chunk (0 on the
    CUDA cores and the wide route); ``smem_bytes`` a block; ``blocks`` a
    launch; ``channels``: the kernel's width (``kernel_channels``)."""

    route: str
    tile: int
    halo: int
    rows: int
    frames: int
    round_frames: int
    nt: int
    smem_bytes: int
    blocks: int
    channels: int

    @property
    def record(self) -> dict:
        """What the library records of this launch (``last_launch``)."""
        return {"route": self.route, "tile": self.tile, "blocks": self.blocks,
                "smem_bytes": self.smem_bytes, "round_frames": self.round_frames,
                "nt": self.nt, "channels": self.channels}


@functools.lru_cache(maxsize=None)
def lvc_plan(B: int, L: int, hop: int, layers: int, dtype: torch.dtype,
             C: int = 32) -> LvcPlan:
    """The launch of one stage's chain on (B, L, C) in ``dtype``, at the
    kernel width ``kernel_channels(C)``.

    The rule on shape: the tensor cores when the hop is a multiple of 8 (an
    n8 tile of rows then lies in one frame) and a 32-row tile fits a block
    (with one frame staged a round where the width stages its weights,
    ``mma_direct``); the CUDA cores otherwise (a hop such as 6, or a chain
    whose halo leaves no room, as f32 at six layers).

    Tensor cores: the largest tile of ``_MMA_TILES`` that fits and gives
    at least one block per two SMs (the smallest that fits when none does):
    every block recomputes 44 rows a side in its first layers, and on the
    H100 that work costs more than idle SMs do down to about half of them
    (``scripts/bench_lvc_stack.py``'s shapes, swept on the card); each round
    stages as many frames as fit, up to all that one layer's rows touch;
    chunks of up to 32 rows of one frame in bf16 (a warp's weight fragments
    then serve 4 row tiles), 16 in f32 (measured faster: its split operands
    take the registers). The direct route takes its tile by the same
    rule, stages nothing (``round_frames`` 0) and takes the same ``nt``.
    CUDA cores: the largest of ``_CORES_TILES`` that fits a block and gives
    every SM a block (the smallest of them that fits when none does), as
    before the tensor-core route; where none of them fits (rows of 64 or 128
    channels), the largest of ``_CORES_SMALL_TILES`` that does. A chain
    whose halo leaves no room at any tile keeps the smallest of
    ``_CORES_TILES``, which ``lvc_stack`` refuses.

    Past ``MAX_CHANNELS`` every hop takes the wide route: a block owns
    ``WIDE_ROWS`` rows of one frame (ceil(hop / 64) tiles a frame) by
    ``WIDE_GATE_COLUMNS`` gate columns, one block a tile, frame and item."""
    if dtype not in (torch.bfloat16, torch.float32) or L % hop or C < 1:
        raise ValueError(f"lvc_plan: dtype {dtype}, L {L}, hop {hop}, C {C}")
    Cp = kernel_channels(C)
    n_frames = L // hop
    if C > MAX_CHANNELS:
        blocks = B * n_frames * -(-hop // WIDE_ROWS) * -(-C // WIDE_GATE_COLUMNS)
        return LvcPlan(WIDE_ROUTE, WIDE_ROWS, 0, WIDE_ROWS, 1, 0, 0, WIDE_SMEM, blocks, Cp)
    direct = mma_direct(dtype, Cp)

    def blocks(tile):
        return B * -(-L // tile)

    def frames(tile):  # layer 0's LVC rows: the tile and the later layers' reach
        return _frames_touched(hop, tile + 2 * (lvc_reach(layers) - 2), n_frames)

    if hop % 8 == 0:
        nt = 4 if hop % 32 == 0 and dtype == torch.bfloat16 else 2 if hop % 16 == 0 else 1
        fitting = []
        for tile in _MMA_TILES:
            halo, rows, _, _ = mma_regions(layers, tile)
            most = 0 if direct else 2 if dtype == torch.float32 and nt > 1 else frames(tile)
            fit = [f for f in range(0 if direct else 1, min(frames(tile), most) + 1)
                   if mma_smem_bytes(dtype, rows, f, nt, Cp) <= SMEM_PER_BLOCK]
            if fit:
                fitting.append((tile, halo, rows, fit[-1]))
        if fitting:
            full = [t for t in fitting if blocks(t[0]) >= -(-SM_COUNT // 2)]
            tile, halo, rows, rf = full[0] if full else fitting[-1]
            return LvcPlan("mma_direct" if direct else "mma", tile, halo, rows, frames(tile),
                           rf, nt, mma_smem_bytes(dtype, rows, rf, nt, Cp), blocks(tile), Cp)

    def cores_smem(tile):
        return 4 * (tile + 2 * _cores_halo(layers, tile)) * Cp * (torch.finfo(dtype).bits // 8)

    fits = [t for t in _CORES_TILES if cores_smem(t) <= SMEM_PER_BLOCK]
    if fits:
        tile = next((t for t in fits if blocks(t) >= SM_COUNT), fits[-1])
    else:  # the smallest tile, which may still not fit (the wrapper raises)
        tile = next((t for t in _CORES_SMALL_TILES if cores_smem(t) <= SMEM_PER_BLOCK),
                    _CORES_TILES[-1])
    halo = _cores_halo(layers, tile)
    return LvcPlan("cuda_cores", tile, halo, tile + 2 * halo, frames(tile), 0, 0,
                   cores_smem(tile), blocks(tile), Cp)


_ROUTES = ("cuda_cores", "mma", "mma_direct", WIDE_ROUTE)


def last_launch() -> dict:
    """The latest accepted launch as the library recorded it (the route,
    tile, blocks, shared memory, frames staged a round, n8 tiles of an LVC
    chunk and the kernel's width)."""
    global _c_last
    if _c_last is None:
        lib = _fn()[0]
        fn = lib.lfs2_lvc_stack_last_launch
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _c_last = (fn, (ctypes.c_int * 8)())
    fn, buf = _c_last
    fn(buf)
    route, tile, gx, gy, smem, rf, nt, ch = list(buf)
    return {"route": _ROUTES[route], "tile": tile, "blocks": gx * gy, "smem_bytes": smem,
            "round_frames": rf, "nt": nt, "channels": ch}


def pad_lvc_inputs(x, audio_down, kernels, biases, conv_w, conv_b, Cp: int):
    """The chain's inputs at C channels zero-padded to ``Cp``: x and
    audio_down (B, L, Cp); each frame kernel's input rows and both gate
    halves' output columns (sigmoid's at [0, C), tanh's at [Cp, Cp + C));
    the biases the same; the conv's taps (layers, 3, Cp, Cp) and bias."""
    C = x.shape[-1]
    p = Cp - C
    kp = kernels.new_zeros(*kernels.shape[:3], Cp, 2 * Cp, 3)
    kp[:, :, :, :C, :C] = kernels[:, :, :, :, :C]
    kp[:, :, :, :C, Cp:Cp + C] = kernels[:, :, :, :, C:]
    bp = biases.new_zeros(*biases.shape[:3], 2 * Cp)
    bp[..., :C] = biases[..., :C]
    bp[..., Cp:Cp + C] = biases[..., C:]
    return (F.pad(x, (0, p)), F.pad(audio_down, (0, p)), kp, bp,
            F.pad(conv_w, (0, p, 0, p)), F.pad(conv_b, (0, p)))


def pad_wide_inputs(x, audio_down, conv_w, conv_b, Cp: int):
    """The wide route's inputs at C channels: x and audio_down (B, L, Cp),
    the conv's taps (layers, 3, Cp, Cp) and bias, zero-padded (the channels
    past C stay 0 through every layer); each 16-byte aligned (a tensor that
    is not is copied; the frame kernels are not touched)."""
    p = Cp - x.shape[-1]
    if p:
        return (F.pad(x, (0, p)), F.pad(audio_down, (0, p)), F.pad(conv_w, (0, p, 0, p)),
                F.pad(conv_b, (0, p)))
    return tuple(t if t.data_ptr() % 16 == 0 else t.clone()
                 for t in (x, audio_down, conv_w, conv_b))


def lvc_stack(x, audio_down, kernels, biases, conv_w, conv_b, hop: int,
              fast_gating: bool = False) -> torch.Tensor:
    """The whole chain of one stage (see ``lvc_stack_plain`` for the
    arguments): the kernel for CUDA tensors, the plain version on the CPU.
    C up to ``MAX_CHANNELS``: a width the kernel is not built at runs
    zero-padded (``pad_lvc_inputs``) and the output is sliced back; wider
    takes the wide route (``lvc_plan``), its signal, conv taps and bias
    zero-padded to ``wide_channels`` (``pad_wide_inputs``), the frame
    kernels and biases as given. The kernel's result is invisible to
    autograd, so on the card it raises
    when grad mode is on and an input needs a gradient: a caller that
    trains takes FastDiff's training route (``FastDiff.forward(...,
    train_route=True)``, the plain chain JAX's ``FastDiff.apply`` runs)."""
    if x.device.type == "cpu":
        return lvc_stack_plain(x, audio_down, kernels, biases, conv_w, conv_b, hop,
                               fast_gating)
    refuse_grad("lvc_stack", "FastDiff's training route (FastDiff.forward(..., "
                "train_route=True))", x, audio_down, kernels, biases, conv_w, conv_b)
    B, L, C = x.shape
    layers = kernels.shape[2]
    dt = x.dtype
    if dt not in build.DTYPE_CODES:
        raise ValueError(f"lvc_stack kernel takes f32 or bf16 x, got {dt}")
    if (audio_down.shape != x.shape or kernels.shape != (B, L // hop, layers, C, 2 * C, 3)
            or L % hop or biases.shape != (B, L // hop, layers, 2 * C)
            or conv_w.shape != (layers, 3, C, C) or conv_b.shape != (layers, C)):
        raise ValueError(
            f"lvc_stack: shapes x {tuple(x.shape)}, audio_down {tuple(audio_down.shape)}, "
            f"kernels {tuple(kernels.shape)}, biases {tuple(biases.shape)}, "
            f"conv_w {tuple(conv_w.shape)}, conv_b {tuple(conv_b.shape)} at hop {hop}")
    for name, t in (("audio_down", audio_down), ("kernels", kernels), ("conv_w", conv_w)):
        if t.dtype != dt:
            raise ValueError(f"lvc_stack: {name} is {t.dtype}, x is {dt}")
    plan = lvc_plan(B, L, hop, layers, dt, C)
    if plan.smem_bytes > SMEM_PER_BLOCK:
        raise ValueError(f"lvc_stack: no launch of {layers} layers at C={C} in {dt} fits "
                         f"{SMEM_PER_BLOCK} bytes of shared memory (planned {plan})")
    wide = plan.route == WIDE_ROUTE
    if wide:
        x, audio_down, conv_w, conv_b = pad_wide_inputs(x, audio_down, conv_w, conv_b,
                                                        plan.channels)
    elif plan.channels != C:
        x, audio_down, kernels, biases, conv_w, conv_b = pad_lvc_inputs(
            x, audio_down, kernels, biases, conv_w, conv_b, plan.channels)
    elif plan.route != "cuda_cores":  # its 16-byte copies need 16-byte aligned rows
        x, audio_down, kernels, conv_w = (t if t.data_ptr() % 16 == 0 else t.clone()
                                          for t in (x, audio_down, kernels, conv_w))
    biases, conv_b = biases.float().contiguous(), conv_b.float().contiguous()
    stream = kernel_stream(x, audio_down, kernels, biases, conv_w, conv_b)
    out = torch.empty_like(x)
    lib, fused, wide_fn = _fn()
    if wide:  # kernels as given: its loads take any C and alignment
        y = torch.empty_like(x)
        rc = wide_fn(x.data_ptr(), audio_down.data_ptr(), kernels.data_ptr(), biases.data_ptr(),
                     conv_w.data_ptr(), conv_b.data_ptr(), out.data_ptr(), y.data_ptr(), B, L, C,
                     hop, layers, int(fast_gating), build.DTYPE_CODES[dt], stream)
    else:
        rc = fused(x.data_ptr(), audio_down.data_ptr(), kernels.data_ptr(), biases.data_ptr(),
                   conv_w.data_ptr(), conv_b.data_ptr(), out.data_ptr(), B, L, plan.channels,
                   hop, layers, plan.tile, int(fast_gating), build.DTYPE_CODES[dt],
                   _ROUTES.index(plan.route), plan.round_frames, plan.nt, stream)
    build.check(lib, rc, "lvc_stack")
    lvc_stack.launches += 1
    lvc_stack.by_width[C] = lvc_stack.by_width.get(C, 0) + 1
    if last_launch() != plan.record:
        raise RuntimeError(f"lvc_stack launched {last_launch()}, planned {plan}")
    return out if plan.channels == C else out[..., :C].contiguous()


lvc_stack.launches = 0
lvc_stack.by_width = {}  # launches by channel count C, set to {} with the count
