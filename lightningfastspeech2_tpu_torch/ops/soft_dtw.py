"""Soft-DTW: the exact soft dynamic-time-warping value and its gradient.

Counterpart of ``lightningfastspeech2_tpu/ops/soft_dtw.py`` (the
anti-diagonal recurrence, the dispatcher, ``soft_dtw``/``soft_dtw_batch``)
and ``ops/pallas_soft_dtw.py`` (``soft_dtw_from_dist_pallas``: ``_fwd_kernel``
and ``_bwd_kernel`` joined by a custom VJP), one module as
``ops/attention.py`` is for flash attention.

    R[i,j] = D[i,j] + softmin_gamma(R[i-1,j], R[i,j-1], R[i-1,j-1])
    softmin_gamma(a,b,c) = -gamma * logsumexp(-[a,b,c]/gamma)

with R[0,0] = D[0,0]; the value is R[N-1,M-1]. ``soft_dtw_from_dist`` runs
``soft_dtw_from_dist_plain`` (autograd through the recurrence) for CPU
tensors and, for CUDA tensors, the forward and backward kernels of
``csrc/soft_dtw.cu`` through an autograd Function. The forward kernel
returns the value and, as the backward's residual, the softmin weights each
cell gives its three predecessors, formed from the cell's own softmin
inputs (the TPU kernel's ``R_next - R - D_next`` loses digits where R is
large; see the kernel's source); the backward is the E-recurrence (Cuturi &
Blondel 2017) over those weights, giving dValue/dD. ``soft_dtw_fwd_plain``
and ``soft_dtw_bwd_plain`` are the two kernels' contract in plain PyTorch,
their oracles on the card; ``soft_dtw_plan`` sizes both launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

import torch

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream

_INF = 1e10
# a block has at most MAX_THREADS threads of up to MAX_ROWS_PER_THREAD rows
# each (csrc/soft_dtw.cu kMaxThreads: 128 registers a thread), so the
# kernels take N <= MAX_ROWS = 4096 rows
MAX_ROWS_PER_THREAD = 8
MAX_THREADS = 512
MAX_ROWS = MAX_ROWS_PER_THREAD * MAX_THREADS
SMEM_PER_BLOCK = 232448
# rows a thread: the fewest that keep a lattice within this many warps
_MAX_WARPS = 10
_c_fns = None
_c_last = None


@dataclass(frozen=True)
class SoftDtwLaunch:
    """One launch of a soft-DTW kernel, one block a lattice:
    ``rows_per_thread`` (K), ``warps`` a block, ``threads`` a block,
    ``steps`` anti-diagonals a chunk (P: the forward's prefetch distance and
    both kernels' hand-over period between warps), ``smem_bytes`` a block,
    ``blocks`` a launch."""

    rows_per_thread: int
    warps: int
    threads: int
    steps: int
    smem_bytes: int
    blocks: int

    @property
    def record(self) -> dict:
        """What the library records of this launch (``last_launch``)."""
        return {"rows_per_thread": self.rows_per_thread, "threads": self.threads,
                "steps": self.steps, "smem_bytes": self.smem_bytes, "blocks": self.blocks}


@dataclass(frozen=True)
class SoftDtwPlan:
    """Both launches of one call on (L, N, M) lattices, and the residual the
    forward hands the backward: each warp's band of weights, (L, warps,
    32 K + M - 1, 3, 32 K) f32 (``residual_bands``)."""

    fwd: SoftDtwLaunch
    bwd: SoftDtwLaunch
    residual_shape: tuple

    @property
    def residual_bytes(self) -> int:
        return 4 * math.prod(self.residual_shape)


# a hand-over ring holds this many chunks of steps (csrc/soft_dtw.cu kRingChunks)
_RING_CHUNKS = 4
# the chunk lengths each rows-a-thread K is built with (csrc/soft_dtw.cu's
# instantiations): the forward's prefetch ring holds K x P distances a
# thread, the backward's chunk of weights 3 K P registers; the longest each
# holds without a spill
FWD_STEPS = {1: 16, 2: 8, 4: 8, 8: 1}
BWD_STEPS = {1: 8, 2: 4, 4: 2, 8: 2}


def _ring_bytes(warps: int, P: int) -> int:
    """csrc/soft_dtw.cu ring_bytes: each warp's hand-over ring of 8-byte
    slots, four chunks of P steps, and the warps' progress counts."""
    return warps * _RING_CHUNKS * P * 8 + (warps + 3) // 4 * 16


def fwd_smem_bytes(warps: int, K: int, P: int) -> int:
    """csrc/soft_dtw.cu fwd_smem_bytes: the rings, then each warp's chunk
    of weights (P steps of 3 planes of its 32 K rows)."""
    return _ring_bytes(warps, P) + warps * P * 3 * 32 * K * 4


def bwd_smem_bytes(warps: int, K: int, P: int) -> int:
    """csrc/soft_dtw.cu bwd_smem_bytes: two chunks of P steps of three
    weights for each row (the one the chain reads, the one in flight), each
    warp's chunk of dD (P x (32 K + 1) floats), then the rings."""
    stage = 2 * P * 3 * 32 * warps * K
    ebuf = (warps * P * (32 * K + 1) + 3) // 4 * 4
    return 4 * (stage + ebuf) + _ring_bytes(warps, P)


def _warps(N: int, K: int) -> int:
    return -(-N // (32 * K))


def residual_bands(L: int, N: int, M: int, K: int) -> tuple:
    """The residual's shape at K rows a thread: each warp's band of
    32 K + M - 1 steps (those where its rows hold cells) of three weights of
    its 32 K rows, (L, warps, 32 K + M - 1, 3, 32 K)."""
    return (L, _warps(N, K), 32 * K + M - 1, 3, 32 * K)


def _launch(L: int, N: int, K: int, P: int, fwd: bool) -> SoftDtwLaunch:
    warps = _warps(N, K)
    smem = fwd_smem_bytes(warps, K, P) if fwd else bwd_smem_bytes(warps, K, P)
    return SoftDtwLaunch(K, warps, 32 * warps, P, smem, L)


@functools.lru_cache(maxsize=None)
def soft_dtw_plan(L: int, N: int, M: int) -> SoftDtwPlan:
    """The launches of the forward and backward kernels on L lattices of
    N x M (N <= MAX_ROWS, M >= 1), one block a lattice.

    Rows a thread: the fewest of 1, 2, 4 that keep a lattice within
    ``_MAX_WARPS`` warps, else 8; chunks of ``FWD_STEPS[K]`` and
    ``BWD_STEPS[K]`` steps, the backward's weights staged one chunk ahead.
    ``scripts/bench_soft_dtw.py --sweep`` measured the choices (H100): one
    row a thread beat two at 256 rows and four beat eight at 1100; staging
    more chunks ahead or two lattices a block gained nothing.

    The residual (``residual_bands``) takes 4 L warps (32 K + M - 1) 3 (32 K)
    bytes, at most 12 L (N + 255)(M + 255): three floats a cell and each
    warp's start and end of band. At the mel loss's (64, 256, 256) that is
    56.4 MB for 50.3 MB of cells; the most at 4096 rows is 12 L 4096
    (M + 255) bytes, 31.4 MB at (2, 4096, 64)."""
    if not (1 <= N <= MAX_ROWS and M >= 1 and L >= 1):
        raise ValueError(f"soft_dtw kernels take 1 <= N <= {MAX_ROWS} rows, got "
                         f"({L}, {N}, {M})")
    K = next((k for k in (1, 2, 4) if -(-N // k) <= 32 * _MAX_WARPS), MAX_ROWS_PER_THREAD)
    fwd = _launch(L, N, K, FWD_STEPS[K], True)
    bwd = _launch(L, N, K, BWD_STEPS[K], False)
    assert max(fwd.smem_bytes, bwd.smem_bytes) <= SMEM_PER_BLOCK, (fwd, bwd)
    return SoftDtwPlan(fwd, bwd, residual_bands(L, N, M, K))


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(..., N, C), (..., M, C) -> (..., N, M) squared euclidean distances,
    ``max(xx + yy - 2 x.y^T, 0)``. Types promote as in JAX: ``xx`` is a sum
    in x's dtype, ``yy`` in y's, the product runs in the promoted dtype
    (f32 for a bf16 prediction against an f32 target)."""
    dt = torch.promote_types(x.dtype, y.dtype)
    xx = torch.sum(x * x, dim=-1)[..., :, None]
    yy = torch.sum(y * y, dim=-1)[..., None, :]
    prod = torch.matmul(x.to(dt), y.to(dt).transpose(-1, -2))
    return torch.clamp(xx + yy - 2.0 * prod, min=0.0)


def _diagonal_rows(N: int, M: int, device) -> tuple:
    """(rows (N,), valid (N + M - 1, N), cols clamped): cell (i, d - i) of
    anti-diagonal d, indexed by row i."""
    rows = torch.arange(N, device=device)
    cols = torch.arange(N + M - 1, device=device)[:, None] - rows[None, :]
    return rows, (cols >= 0) & (cols < M), cols.clamp(0, M - 1)


def soft_dtw_from_dist_plain(D: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Plain, autograd-differentiable version for D (..., N, M) -> (...):
    ``_soft_dtw_from_dist_scan`` batched over lattices, one anti-diagonal
    per step (diagonal d holds the cells (i, d - i), indexed by row i)."""
    lead, (N, M) = D.shape[:-2], D.shape[-2:]
    D = D.reshape(-1, N, M)
    L, n_diag = D.shape[0], N + M - 1
    rows, valid, cols = _diagonal_rows(N, M, D.device)
    inf = torch.full((), _INF, dtype=D.dtype, device=D.device)
    # the lattice skewed once: diags[:, d, i] = D[:, i, d - i] (INF outside)
    diags = torch.where(valid, D[:, rows[None, :], cols], inf)
    r_prev2 = r_prev = torch.full((L, N), _INF, dtype=D.dtype, device=D.device)
    first_row = rows[None, :] > 0
    for d in range(n_diag):
        up = torch.where(first_row, torch.roll(r_prev, 1, dims=1), inf)      # (i-1, j)
        diag = torch.where(first_row, torch.roll(r_prev2, 1, dims=1), inf)   # (i-1, j-1)
        left = r_prev                                                       # (i, j-1)
        # -gamma * logsumexp(-[up, left, diag] / gamma) in the kernels' form:
        # the exponents are differences from the minimum, so autograd's
        # weights do not lose the digits that R's size (~1e4) takes
        m = torch.minimum(torch.minimum(up, left), diag)
        soft = m - gamma * torch.log(torch.exp((m - up) / gamma) + torch.exp((m - left) / gamma)
                                     + torch.exp((m - diag) / gamma))
        if d == 0:   # (0, 0) starts the recursion: R[0,0] = D[0,0]
            soft = torch.where(rows[None, :] == 0, torch.zeros_like(inf), soft)
        r_new = torch.where(valid[d], diags[:, d] + soft, inf)
        r_prev2, r_prev = r_prev, r_new
    return r_prev[:, N - 1].reshape(lead)


def _band_cells(N: int, M: int, K: int, device) -> tuple:
    """(step, row, on), each (warps, 32 K + M - 1, 32 K): the anti-diagonal
    and row of every entry of a band (clamped into the lattice's), and
    whether it is a cell of the lattice."""
    R, warps = 32 * K, _warps(N, K)
    first = torch.arange(warps, device=device)[:, None, None] * R
    row = first + torch.arange(R, device=device)[None, None, :]
    step = first + torch.arange(R + M - 1, device=device)[None, :, None]
    col = step - row
    on = (row < N) & (col >= 0) & (col < M)
    return step.clamp(max=N + M - 2), row.clamp(max=N - 1), on


def _skewed_to_bands(Ws: torch.Tensor, N: int, M: int, K: int) -> torch.Tensor:
    """Skewed weights (L, N + M - 1, 3, N) -> the bands at K rows a thread,
    0 off the lattice."""
    step, row, on = _band_cells(N, M, K, Ws.device)
    bands = Ws.permute(0, 2, 1, 3)[:, :, step, row]          # (L, 3, warps, steps, 32 K)
    return torch.where(on, bands, 0.0).permute(0, 2, 3, 1, 4).contiguous()


def _bands_to_skewed(W: torch.Tensor, N: int) -> torch.Tensor:
    """The bands (L, warps, 32 K + M - 1, 3, 32 K) -> skewed weights
    (L, N + M - 1, 3, N), 0 off the lattice."""
    R = W.shape[-1]
    M = W.shape[2] - R + 1
    rows, valid, _ = _diagonal_rows(N, M, W.device)
    d = torch.arange(N + M - 1, device=W.device)[:, None]
    w, r = rows // R, rows % R
    t = (d - w * R).clamp(0, W.shape[2] - 1)                  # (N + M - 1, N)
    Ws = W.permute(0, 3, 1, 2, 4)[:, :, w[None, :], t, r[None, :]]   # (L, 3, ndiag, N)
    return torch.where(valid, Ws, 0.0).permute(0, 2, 1, 3)


def residual_cells(N: int, M: int, device) -> torch.Tensor:
    """(warps, 32 K + M - 1, 3, 32 K) bool at the plan's K: the entries of
    the residual that hold a weight of a cell of the lattice (the kernel's
    residual holds nothing defined elsewhere)."""
    K = soft_dtw_plan(1, N, M).fwd.rows_per_thread
    on = _band_cells(N, M, K, device)[2]
    return on[:, :, None, :].expand(-1, -1, 3, -1)


def _softmin_constants(gamma: float):
    """c = log2(e) / gamma and gamma ln 2 in f32, as the kernels take them."""
    return math.log2(math.e) / gamma, gamma * math.log(2.0)


def _skewed_weights(D: torch.Tensor, gamma: float):
    """``soft_dtw_fwd_plain`` with the weights skewed, (L, N + M - 1, 3, N):
    [l, d, x, i] the weight of cell (i, d - i), 0 off the lattice."""
    L, N, M = D.shape
    dev, f32 = D.device, torch.float32
    c, gl = (torch.tensor(v, dtype=f32, device=dev) for v in _softmin_constants(gamma))
    rows, valid, cols = _diagonal_rows(N, M, dev)
    inf = torch.full((), _INF, dtype=f32, device=dev)
    zero = torch.zeros((), dtype=f32, device=dev)
    diags = D[:, rows[None, :], cols]                              # D skewed: (L, ndiag, N)
    W = torch.zeros(L, N + M - 1, 3, N, dtype=f32, device=dev)
    r_prev2 = r_prev = torch.full((L, N), _INF, dtype=f32, device=dev)
    first_row = rows[None, :] > 0
    for d in range(N + M - 1):
        up = torch.where(first_row, torch.roll(r_prev, 1, dims=1), inf)
        left = r_prev
        # (0, 0)'s diagonal input is 0, so its softmin is exactly 0
        dg = torch.where(first_row, torch.roll(r_prev2, 1, dims=1), zero if d == 0 else inf)
        mn, mx = torch.minimum(up, left), torch.maximum(up, left)
        m, hi = torch.minimum(mn, dg), torch.maximum(mx, dg)
        mid = torch.maximum(mn, torch.minimum(mx, dg))
        e1, e2 = torch.exp2((m - mid) * c), torch.exp2((m - hi) * c)
        S = (e1 + e2) + 1.0
        r_new = torch.where(valid[d], diags[:, d] + (m - gl * torch.log2(S)), inf)
        rS = 1.0 / S
        a1, a2 = e1 * rS, e2 * rS
        for x, v in enumerate((up, left, dg)):
            w = torch.where(v == m, rS, torch.where(v == mid, a1, a2))
            W[:, d, x] = torch.where(valid[d], w, zero)
        r_prev2, r_prev = r_prev, r_new
    return r_prev[:, N - 1], W


def soft_dtw_fwd_plain(D: torch.Tensor, gamma: float):
    """The forward kernel's contract in plain PyTorch, one anti-diagonal of
    every lattice a step: D (L, N, M) f32 -> (value (L,), W), W the weights
    in the plan's bands (``residual_bands``): W[l, w, t, x, r] the weight
    cell (i, s - i), i = 32 K w + r, s = 32 K w + t, gives its predecessor x
    (0 up (i-1, j), 1 left (i, j-1), 2 diag (i-1, j-1)), exp((m - R_x) /
    gamma) / S with m the least of the three and S the sum, 0 off the
    lattice (where the kernel's entries are undefined). The arithmetic is
    the kernel's: the softmin in base 2 with the minimum's term 1,
    R = D + (m - gamma ln2 log2 S), R(0, 0) = D(0, 0) through a diagonal
    input of 0."""
    L, N, M = D.shape
    value, Ws = _skewed_weights(D, gamma)
    return value, _skewed_to_bands(Ws, N, M, soft_dtw_plan(L, N, M).fwd.rows_per_thread)


def soft_dtw_bwd_plain(W: torch.Tensor, g: torch.Tensor, N: int) -> torch.Tensor:
    """The backward kernel's contract in plain PyTorch: the forward's
    weights W (``soft_dtw_fwd_plain``'s bands) of N-row lattices and the
    upstream gradient g (L,) -> g * dValue/dD (L, N, M), by the E-recurrence
    in reverse anti-diagonal order, E(i, j) = E(i, j+1) w_left(i, j+1) +
    (E(i+1, j) w_up(i+1, j) + E(i+1, j+1) w_diag(i+1, j+1)), E(N-1, M-1) = 1."""
    W = _bands_to_skewed(W, N)
    L, n_diag = W.shape[:2]
    M = n_diag - N + 1
    dev = W.device
    rows, valid, cols = _diagonal_rows(N, M, dev)
    zero = torch.zeros((L, 1), dtype=W.dtype, device=dev)
    E = torch.zeros(L, n_diag, N, dtype=W.dtype, device=dev)
    E[:, n_diag - 1, N - 1] = 1.0
    # per diagonal, what a row sends the row above: E w_up of its own cell
    # and E w_diag of its cell one diagonal later
    up1 = E[:, n_diag - 1] * W[:, n_diag - 1, 0, :N]
    dg2 = torch.zeros_like(up1)
    for d in range(n_diag - 2, -1, -1):
        e1 = E[:, d + 1]
        from_below = torch.cat([(up1 + dg2)[:, 1:], zero], dim=1)   # rows i + 1
        e = torch.where(valid[d], e1 * W[:, d + 1, 1, :N] + from_below, 0.0)
        E[:, d] = e
        dg2 = e1 * W[:, d + 1, 2, :N]
        up1 = e * W[:, d, 0, :N]
    return E[:, rows[:, None] + torch.arange(M, device=dev)[None, :], rows[:, None]] \
        * g.to(W.dtype)[:, None, None]


def _fns():
    global _c_fns
    if _c_fns is None:
        lib = build.load("soft_dtw")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd = lib.lfs2_soft_dtw_fwd
        fwd.argtypes = [p, p, p, i, i, i, f, f, i, i, i, i, p]
        fwd.restype = ctypes.c_int
        bwd = lib.lfs2_soft_dtw_bwd
        bwd.argtypes = [p, p, p, i, i, i, i, i, i, i, p]
        bwd.restype = ctypes.c_int
        _c_fns = (lib, fwd, bwd)
    return _c_fns


def last_launch() -> dict:
    """The latest accepted launches as the library recorded them:
    {"fwd": record, "bwd": record}, each as ``SoftDtwLaunch.record``."""
    global _c_last
    if _c_last is None:
        fn = _fns()[0].lfs2_soft_dtw_last_launch
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _c_last = (fn, (ctypes.c_int * 10)())
    fn, buf = _c_last
    fn(buf)
    keys = ("rows_per_thread", "threads", "steps", "smem_bytes", "blocks")
    return {part: dict(zip(keys, buf[5 * n:5 * n + 5])) for n, part in enumerate(("fwd", "bwd"))}


def _check(D: torch.Tensor) -> None:
    if D.dtype != torch.float32 or D.dim() != 3:
        raise ValueError(f"soft_dtw kernels take an (L, N, M) f32 lattice, got "
                         f"{tuple(D.shape)} {D.dtype}")
    L, N, M = D.shape
    if min(N, M) < 1 or N > MAX_ROWS or N * M >= 2 ** 31:
        raise ValueError(f"soft_dtw kernels take 1 <= N <= {MAX_ROWS} rows and N * M < 2^31, "
                         f"got {tuple(D.shape)}")


def soft_dtw_fwd(D: torch.Tensor, gamma: float):
    """Launch the forward kernel on D (L, N, M) f32, one block a lattice, as
    ``soft_dtw_plan`` sizes it; returns (value (L,), W) with W the banded
    weights of ``soft_dtw_fwd_plain`` (entries off the lattice undefined),
    which the backward reads. CUDA only."""
    _check(D)
    stream = kernel_stream(D)
    L, N, M = D.shape
    plan = soft_dtw_plan(L, N, M)
    value = torch.empty(L, dtype=torch.float32, device=D.device)
    W = torch.empty(plan.residual_shape, dtype=torch.float32, device=D.device)
    c, gl = _softmin_constants(gamma)
    f = plan.fwd
    lib, fn, _ = _fns()
    rc = fn(D.data_ptr(), W.data_ptr(), value.data_ptr(), L, N, M, c, gl, f.rows_per_thread,
            f.warps, f.steps, f.smem_bytes, stream)
    build.check(lib, rc, "soft_dtw")
    soft_dtw.launches += 1
    if last_launch()["fwd"] != f.record:
        raise RuntimeError(f"soft_dtw launched {last_launch()['fwd']}, planned {f}")
    return value, W


def soft_dtw_bwd(W: torch.Tensor, g: torch.Tensor, N: int):
    """Launch the backward kernel (the E-recurrence in reverse anti-diagonal
    order) on the forward's banded weights W of N-row lattices
    (``residual_bands``); returns dValue/dD (L, N, M) scaled by the upstream
    gradient ``g`` (L,). CUDA only."""
    g = g.to(torch.float32).contiguous()
    L = W.shape[0]
    M = W.shape[2] - W.shape[-1] + 1 if W.dim() == 5 else 0
    if (W.dtype != torch.float32 or M < 1 or not 1 <= N <= MAX_ROWS or not W.is_contiguous()
            or tuple(W.shape) != soft_dtw_plan(L, N, M).residual_shape or g.shape != (L,)):
        raise ValueError(f"soft_dtw_bwd takes the forward's f32 weights of {N}-row lattices "
                         f"and g (L,), got W {tuple(W.shape)} {W.dtype}, g {tuple(g.shape)}")
    stream = kernel_stream(W, g)
    plan = soft_dtw_plan(L, N, M)
    dD = torch.empty(L, N, M, dtype=torch.float32, device=W.device)
    b = plan.bwd
    lib, _, fn = _fns()
    rc = fn(W.data_ptr(), g.data_ptr(), dD.data_ptr(), L, N, M, b.rows_per_thread, b.warps,
            b.steps, b.smem_bytes, stream)
    build.check(lib, rc, "soft_dtw_bwd")
    soft_dtw_bwd.launches += 1
    if last_launch()["bwd"] != b.record:
        raise RuntimeError(f"soft_dtw_bwd launched {last_launch()['bwd']}, planned {b}")
    return dD


class _SoftDTW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma):
        value, W = soft_dtw_fwd(D, gamma)
        ctx.save_for_backward(W)
        ctx.rows = D.shape[1]
        return value

    @staticmethod
    def backward(ctx, g):
        (W,) = ctx.saved_tensors
        return soft_dtw_bwd(W, g, ctx.rows), None


def soft_dtw_from_dist(D: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Soft-DTW value of each lattice of D (..., N, M) -> (...).

    The gate of the JAX package's dispatcher: a CUDA tensor with
    min(N, M) >= 8 runs the kernels in f32 (as ``_run_fwd`` casts D); a
    smaller lattice takes the plain recurrence. That is the JAX package's
    own rule on shape, not a fallback on failure: a CUDA lattice at or above
    it launches the kernels or raises. CPU tensors take the plain version."""
    lead, (N, M) = D.shape[:-2], D.shape[-2:]
    if D.device.type == "cpu" or min(N, M) < 8:
        return soft_dtw_from_dist_plain(D, gamma)
    flat = D.to(torch.float32).reshape(-1, N, M).contiguous()
    return _SoftDTW.apply(flat, float(gamma)).reshape(lead)


def soft_dtw(x: torch.Tensor, y: torch.Tensor, gamma: float = 1.0,
             normalize: bool = False) -> torch.Tensor:
    """(..., N, C), (..., M, C) -> (...) soft-DTW; ``normalize`` gives the
    debiased d(x, y) - (d(x, x) + d(y, y)) / 2."""
    value = soft_dtw_from_dist(pairwise_sqdist(x, y), gamma)
    if normalize:
        xx = soft_dtw_from_dist(pairwise_sqdist(x, x), gamma)
        yy = soft_dtw_from_dist(pairwise_sqdist(y, y), gamma)
        value = value - 0.5 * (xx + yy)
    return value


def soft_dtw_batch(x: torch.Tensor, y: torch.Tensor, gamma: float = 1.0,
                   normalize: bool = False) -> torch.Tensor:
    """(B, N, C), (B, M, C) -> (B,): every item's lattice in one call."""
    return soft_dtw(x, y, gamma=gamma, normalize=normalize)


soft_dtw.launches = 0
soft_dtw_bwd.launches = 0
