"""The tile plan of ``lvc_stack`` (ops/fastdiff_lvc.py lvc_plan) and the
tensor-core route's rows and K order, on the CPU and without JAX: every
launch at FastDiff's stages and the serving path's frame buckets fits a
block's shared memory and has blocks; the route follows the rule on shape;
each layer's rows cover what the next step reads; and a product with the
frame kernels in the order the kernel stages them (k = tap * C + cin)
equals ``location_variable_convolution``."""

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc as lvc

# mel frames of one vocoder call: a 1-frame mel and the serving path's
# frame buckets; FastDiff's stage hops (8, 64, 256) and one that is not a
# multiple of 8
MEL_FRAMES = (1, 256, 512, 768, 1280)
HOPS = (8, 64, 256, 6)
LAYERS = 4


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("hop", HOPS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plans_fit_a_block_and_follow_the_rule(dtype, hop, B):
    for frames in MEL_FRAMES:
        L = frames * hop
        plan = lvc.lvc_plan(B, L, hop, LAYERS, dtype)
        assert plan.route == ("mma" if hop % 8 == 0 else "cuda_cores")
        assert 0 < plan.smem_bytes <= lvc.SMEM_PER_BLOCK
        assert plan.blocks == B * -(-L // plan.tile) >= 1
        assert plan.halo == 48 and plan.rows == plan.tile + 2 * plan.halo
        assert 1 <= plan.frames <= frames
        if plan.route == "mma":
            assert plan.tile % 8 == 0 and hop % (8 * plan.nt) == 0
            assert 1 <= plan.round_frames <= plan.frames
            assert plan.smem_bytes == lvc.mma_smem_bytes(dtype, plan.rows, plan.round_frames,
                                                         plan.nt)
        else:
            assert plan.tile % 4 == 0 and plan.round_frames == plan.nt == 0
        assert lvc.lvc_plan(B, L, hop, LAYERS, dtype) is plan  # cached


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_plans_at_512_frames(dtype):
    """The served bucket: stage 3 takes 512-row tiles in bf16, three of the
    four frames a layer's rows can touch staged a round, and 256-row tiles
    in f32, one frame a round; stage 2 256-row tiles in both; stage 1
    32-row tiles; every stage launches at least 66 blocks at B=1."""
    plans = {hop: lvc.lvc_plan(1, 512 * hop, hop, LAYERS, dtype) for hop in (8, 64, 256)}
    assert all(p.route == "mma" and p.blocks >= 66 for p in plans.values())
    p3 = plans[256]
    assert (p3.tile, p3.round_frames, p3.frames) == (
        (512, 3, 4) if dtype == torch.bfloat16 else (256, 1, 3))
    assert plans[64].tile == 256 and plans[8].tile == 32
    assert p3.nt == (4 if dtype == torch.bfloat16 else 2) and plans[8].nt == 1


def test_a_chain_whose_tensor_core_launch_does_not_fit_takes_the_cuda_cores():
    # six layers reach 370 rows a side: in bf16 a 64-row tile still fits
    # with one frame a round, in f32 none does
    bf = lvc.lvc_plan(1, 512 * 64, 64, 6, torch.bfloat16)
    assert (bf.route, bf.tile, bf.round_frames) == ("mma", 64, 1)
    assert bf.smem_bytes <= lvc.SMEM_PER_BLOCK
    f32 = lvc.lvc_plan(1, 512 * 64, 64, 6, torch.float32)
    assert f32.route == "cuda_cores" and f32.halo >= lvc.lvc_reach(6)


@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("tile", [32, 128, 256])
def test_rows_cover_what_the_next_step_reads(layers, tile):
    halo, rows, b, c = lvc.mma_regions(layers, tile)
    assert halo % 8 == 0 and halo >= lvc.lvc_reach(layers) and rows == tile + 2 * halo
    assert c[-1] == (halo, halo + tile)  # the last LVC computes the tile
    for i in range(layers):
        d = 3 ** i
        # the conv covers the LVC's taps at -1, +1 ...
        assert b[i][0] <= c[i][0] - 1 and b[i][1] >= c[i][1] + 1
        # ... and reads x rows inside the buffer, written by the LVC before
        assert b[i][0] - d >= 0 and b[i][1] + d <= rows
        if i > 0:
            assert c[i - 1][0] <= b[i][0] - d and c[i - 1][1] >= b[i][1] + d
    # layer 0's conv reads the chain's whole reach a side of the tile
    assert (b[0][0] - 1, b[0][1] + 1) == (halo - lvc.lvc_reach(layers),
                                          halo + tile + lvc.lvc_reach(layers))


@pytest.mark.parametrize("hop", [8, 64])
def test_staged_kernel_order_gives_the_lvc(hop):
    """A frame's (C, 2C, 3) kernel staged as [tap * C + cin][out], the
    reordering csrc/lvc_stack.cu does in shared memory (the JAX wrapper's
    order, pallas_fastdiff.py:193), times the rows at offsets -1, 0, +1
    equals location_variable_convolution."""
    rng = np.random.default_rng(hop)
    B, nL, C = 2, 5, 32
    y = torch.from_numpy(rng.standard_normal((B, nL * hop, C))).double()
    k = torch.from_numpy(rng.standard_normal((B, nL, C, 2 * C, 3))).double()
    bias = torch.from_numpy(rng.standard_normal((B, nL, 2 * C))).double()
    want = lvc.location_variable_convolution(y, k, bias, hop)
    staged = k.permute(0, 1, 4, 2, 3).reshape(B, nL, 3 * C, 2 * C)
    yp = torch.nn.functional.pad(y, (0, 0, 1, 1))
    rows = torch.cat([yp[:, t:t + nL * hop] for t in range(3)], dim=-1)
    got = torch.einsum("bftk,bfko->bfto", rows.reshape(B, nL, hop, 3 * C), staged)
    got = (got + bias[:, :, None, :]).reshape(B, nL * hop, 2 * C)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)
