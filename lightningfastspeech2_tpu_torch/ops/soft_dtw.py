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
``csrc/soft_dtw.cu`` through an autograd Function. The backward is the
E-recurrence (Cuturi & Blondel 2017), giving dValue/dD, with each weight
formed from its successor's softmin inputs, as autograd of the forward
forms it (the TPU kernel's form loses digits where R is large; see the
kernel's source).
"""

from __future__ import annotations

import ctypes

import torch

from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.kernels.launch import kernel_stream

_INF = 1e10
# rows of the lattice one thread owns in the kernels; blocks have at most
# 1024 threads, so N <= MAX_ROWS_PER_THREAD * 1024
MAX_ROWS_PER_THREAD = 4
_c_fns = None


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


def soft_dtw_from_dist_plain(D: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Plain, autograd-differentiable version for D (..., N, M) -> (...):
    ``_soft_dtw_from_dist_scan`` batched over lattices, one anti-diagonal
    per step (diagonal d holds the cells (i, d - i), indexed by row i)."""
    lead, (N, M) = D.shape[:-2], D.shape[-2:]
    D = D.reshape(-1, N, M)
    L, n_diag = D.shape[0], N + M - 1
    rows = torch.arange(N, device=D.device)
    d_idx = torch.arange(n_diag, device=D.device)[:, None]
    cols = d_idx - rows[None, :]
    valid = (cols >= 0) & (cols < M)                              # (n_diag, N)
    inf = torch.full((), _INF, dtype=D.dtype, device=D.device)
    # the lattice skewed once: diags[:, d, i] = D[:, i, d - i] (INF outside)
    diags = torch.where(valid, D[:, rows[None, :], cols.clamp(0, M - 1)], inf)
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


def _fns():
    global _c_fns
    if _c_fns is None:
        lib = build.load("soft_dtw")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fwd = lib.lfs2_soft_dtw_fwd
        fwd.argtypes = [p, p, p, i, i, i, f, p]
        fwd.restype = ctypes.c_int
        bwd = lib.lfs2_soft_dtw_bwd
        bwd.argtypes = [p, p, p, i, i, i, f, p]
        bwd.restype = ctypes.c_int
        _c_fns = (lib, fwd, bwd)
    return _c_fns


def _check(D: torch.Tensor) -> None:
    if D.dtype != torch.float32 or D.dim() != 3:
        raise ValueError(f"soft_dtw kernels take an (L, N, M) f32 lattice, got "
                         f"{tuple(D.shape)} {D.dtype}")
    L, N, M = D.shape
    if min(N, M) < 1 or N > MAX_ROWS_PER_THREAD * 1024:
        raise ValueError(f"soft_dtw kernels take 1 <= N <= {MAX_ROWS_PER_THREAD * 1024} "
                         f"rows, got {tuple(D.shape)}")


def soft_dtw_fwd(D: torch.Tensor, gamma: float):
    """Launch the forward kernel on D (L, N, M) f32, one block per lattice;
    returns (value (L,), R) with R the lattice skewed by anti-diagonal,
    R[l, d, i] = R_l[i, d - i] (1e10 off the lattice), which the backward
    reads. CUDA only."""
    _check(D)
    stream = kernel_stream(D)
    L, N, M = D.shape
    value = torch.empty(L, dtype=torch.float32, device=D.device)
    R = torch.empty(L, N + M - 1, N, dtype=torch.float32, device=D.device)
    lib, fn, _ = _fns()
    rc = fn(D.data_ptr(), R.data_ptr(), value.data_ptr(), L, N, M, float(gamma), stream)
    build.check(lib, rc, "soft_dtw")
    soft_dtw.launches += 1
    return value, R


def soft_dtw_bwd(R: torch.Tensor, g: torch.Tensor, gamma: float):
    """Launch the backward kernel (the E-recurrence in reverse diagonal
    order) on the forward's skewed lattice R (L, N + M - 1, N); returns
    dValue/dD (L, N, M) scaled by the upstream gradient ``g`` (L,). CUDA
    only."""
    g = g.to(torch.float32).contiguous()
    if R.dtype != torch.float32 or R.dim() != 3 or g.shape != (R.shape[0],):
        raise ValueError(f"soft_dtw_bwd takes the forward's f32 lattice and g (L,), got "
                         f"R {tuple(R.shape)} {R.dtype}, g {tuple(g.shape)}")
    stream = kernel_stream(R, g)
    L, n_diag, N = R.shape
    M = n_diag - N + 1
    E = torch.empty(L, N, M, dtype=torch.float32, device=R.device)
    lib, _, fn = _fns()
    rc = fn(R.data_ptr(), g.data_ptr(), E.data_ptr(), L, N, M, float(gamma), stream)
    build.check(lib, rc, "soft_dtw_bwd")
    soft_dtw_bwd.launches += 1
    return E


class _SoftDTW(torch.autograd.Function):
    @staticmethod
    def forward(ctx, D, gamma):
        value, R = soft_dtw_fwd(D, gamma)
        ctx.save_for_backward(R)
        ctx.gamma = gamma
        return value

    @staticmethod
    def backward(ctx, g):
        (R,) = ctx.saved_tensors
        return soft_dtw_bwd(R, g, ctx.gamma), None


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
