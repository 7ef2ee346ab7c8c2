"""``ops/soft_dtw.py soft_dtw_plan`` on the CPU: every lattice the kernels
take (1 <= N <= 4096 rows, any M) gets a forward and a backward launch that
the library accepts (an instantiated rows-a-thread and chunk length, the
block and shared-memory limits, every row covered, no warp empty), the
residual's layout (each warp's band) and its largest size, and the soft-DTW loss's folding of its chunks into one
call (one forward and one backward launch a loss on the card). Needs no card
and imports no JAX."""

import re
from pathlib import Path

import pytest
import torch

from lightningfastspeech2_tpu_torch.ops import soft_dtw as tsd
from lightningfastspeech2_tpu_torch.train import losses as tlosses

SOURCE = (Path(__file__).resolve().parent.parent / "lightningfastspeech2_tpu_torch" / "csrc"
          / "soft_dtw.cu").read_text()


def _instantiated(kind):
    """(K, P) of every soft_dtw_wave_<kind><K, P> the library dispatches to."""
    return {(int(k), int(p)) for k, p in
            re.findall(rf"kern = soft_dtw_wave_{kind}<(\d+), (\d+)>;", SOURCE)}


def _check_launch(launch, N, kind):
    K, T, P = launch.rows_per_thread, launch.threads, launch.steps
    assert (K, P) in _instantiated(kind), (N, kind, launch)
    assert T == 32 * launch.warps and T <= tsd.MAX_THREADS
    assert T * K >= N and (T - 32) * K < N, (N, launch)   # every row, no empty warp
    assert K * P <= 32        # a warp's coalesced copies keep each lane's rows in order
    assert (32 * K) % P == 0  # a warp's band starts at a chunk's first step
    assert launch.smem_bytes <= tsd.SMEM_PER_BLOCK
    smem = tsd.fwd_smem_bytes if kind == "fwd" else tsd.bwd_smem_bytes
    assert launch.smem_bytes == smem(launch.warps, K, P)


def test_plan_fits_every_row_count():
    for N in range(1, tsd.MAX_ROWS + 1):
        plan = tsd.soft_dtw_plan(3, N, 57)
        _check_launch(plan.fwd, N, "fwd")
        _check_launch(plan.bwd, N, "bwd")
        assert plan.fwd.blocks == plan.bwd.blocks == 3
        assert plan.fwd.rows_per_thread == plan.bwd.rows_per_thread


@pytest.mark.parametrize("N,M", [(1, 1), (8, 300), (31, 57), (256, 256), (300, 8),
                                 (1100, 1100), (4096, 64), (4095, 5000)])
def test_plan_residual_layout(N, M):
    # each warp's band: the 32 K + M - 1 steps where its 32 K rows hold cells
    plan = tsd.soft_dtw_plan(2, N, M)
    K, warps = plan.fwd.rows_per_thread, plan.fwd.warps
    assert plan.residual_shape == (2, warps, 32 * K + M - 1, 3, 32 * K)
    assert plan.residual_bytes == 4 * 2 * warps * (32 * K + M - 1) * 3 * 32 * K
    # the largest residual the kernels allocate (soft_dtw_plan's docstring)
    assert plan.residual_bytes <= 12 * 2 * (N + 255) * (M + 255)
    assert int(tsd.residual_cells(N, M, "cpu").sum()) == 3 * N * M


def test_residual_at_the_most_rows_stays_near_its_cells():
    # 4096 rows of 64 columns: 16 warps' bands of 319 steps, 31.4 MB for
    # 6.3 MB of cells (the full skew of N + M - 1 steps of every row would
    # be 409 MB)
    plan = tsd.soft_dtw_plan(2, tsd.MAX_ROWS, 64)
    assert plan.residual_shape == (2, 16, 319, 3, 256)
    assert plan.residual_bytes == 31_358_976
    assert plan.residual_bytes < 5 * 12 * 2 * tsd.MAX_ROWS * 64


@pytest.mark.parametrize("N,M", [(8, 33), (40, 12), (100, 7), (700, 30)])
def test_bands_hold_every_cell_once(N, M):
    # the skewed weights through the bands and back are unchanged; a band
    # entry off the lattice is 0
    g = torch.Generator().manual_seed(N)
    K = tsd.soft_dtw_plan(1, N, M).fwd.rows_per_thread
    valid = tsd._diagonal_rows(N, M, "cpu")[1]
    Ws = torch.where(valid[None, :, None, :], torch.rand(2, N + M - 1, 3, N, generator=g), 0.0)
    W = tsd._skewed_to_bands(Ws, N, M, K)
    assert W.shape == tsd.soft_dtw_plan(2, N, M).residual_shape
    assert not W[:, ~tsd.residual_cells(N, M, "cpu")].any()
    assert torch.equal(tsd._bands_to_skewed(W, N), Ws)


@pytest.mark.parametrize("N,K,warps", [(8, 1, 1), (256, 1, 8), (320, 1, 10), (600, 2, 10),
                                       (1100, 4, 9), (2048, 8, 8), (4096, 8, 16)])
def test_plan_rows_per_thread(N, K, warps):
    plan = tsd.soft_dtw_plan(64, N, 256)
    assert (plan.fwd.rows_per_thread, plan.fwd.warps) == (K, warps)
    assert (plan.bwd.rows_per_thread, plan.bwd.warps) == (K, warps)


@pytest.mark.parametrize("L,N,M", [(1, 4097, 64), (1, 0, 64), (1, 64, 0), (0, 64, 64)])
def test_plan_refuses_what_the_kernels_do_not_take(L, N, M):
    with pytest.raises(ValueError, match="soft_dtw kernels take"):
        tsd.soft_dtw_plan(L, N, M)


@pytest.mark.parametrize("T,chunk,calls", [(512, 256, 1), (600, 256, 2), (37, 10, 2)])
def test_loss_folds_its_chunks_into_one_call(monkeypatch, T, chunk, calls):
    # one soft_dtw_batch call for the full chunks of every item, one for the
    # tail: on the card each is one forward and one backward launch (a
    # stand-in records the calls)
    seen = []
    monkeypatch.setattr(tlosses, "soft_dtw_batch",
                        lambda x, y, **kw: seen.append(tuple(x.shape)) or x.sum(dim=(-1, -2)))
    g = torch.Generator().manual_seed(T)
    pred, truth = torch.randn(2, T, 3, generator=g), torch.randn(2, T, 3, generator=g)
    tlosses.soft_dtw_loss(pred, truth, torch.ones(2, T, dtype=torch.bool), 0.1, chunk)
    assert len(seen) == calls
    assert seen[0] == (2 * (T // chunk), chunk, 3)   # every item's full chunks in one call
