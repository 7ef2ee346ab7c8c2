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


WIDTHS = (16, 32, 48, 64, 128)


@pytest.mark.parametrize("B", [1, 8])
@pytest.mark.parametrize("hop", [8, 64, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", WIDTHS)
def test_plans_at_every_width_fit_a_block_and_follow_the_rule(C, dtype, hop, B):
    """Every inner width up to 128 at a 512-frame bucket's stages: the
    kernel's width is the narrowest built one that holds C (48 runs as 64);
    the tensor cores take every stage, staging the weights where a frame's
    kernel fits beside the rows (bf16 to 64, f32 to 32) and reading them
    from device memory past that; every launch fits a block."""
    L = 512 * hop
    plan = lvc.lvc_plan(B, L, hop, LAYERS, dtype, C)
    Cp = lvc.kernel_channels(C)
    assert plan.channels == Cp and Cp in lvc.KERNEL_CHANNELS and C <= Cp
    assert all(k < C for k in lvc.KERNEL_CHANNELS if k < Cp)
    direct = Cp >= (128 if dtype == torch.bfloat16 else 64)
    assert lvc.mma_direct(dtype, Cp) == direct
    assert plan.route == ("mma_direct" if direct else "mma")
    assert 0 < plan.smem_bytes <= lvc.SMEM_PER_BLOCK
    assert plan.smem_bytes == lvc.mma_smem_bytes(dtype, plan.rows, plan.round_frames, plan.nt, Cp)
    assert plan.blocks == B * -(-L // plan.tile) and plan.blocks >= lvc.SM_COUNT // 2
    assert plan.halo == 48 and plan.rows == plan.tile + 2 * plan.halo
    assert plan.tile % 8 == 0 and hop % (8 * plan.nt) == 0
    assert plan.round_frames == 0 if direct else 1 <= plan.round_frames <= plan.frames
    assert plan.record["channels"] == Cp


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("C", WIDTHS)
def test_cuda_core_tile_is_sized_by_shared_memory(C, dtype):
    """A hop that is not a multiple of 8 takes the CUDA cores at every
    width: its tile is the largest that fits a block's shared memory (4
    rows a C-wide row of x, audio_down and both conv operands), down to
    16 rows at C = 128 in f32, where a 256-row tile would need 360,448
    bytes."""
    for B, frames in ((1, 512), (8, 512), (1, 1)):
        plan = lvc.lvc_plan(B, frames * 6, 6, LAYERS, dtype, C)
        elem = torch.finfo(dtype).bits // 8
        assert plan.route == "cuda_cores" and plan.round_frames == plan.nt == 0
        assert plan.smem_bytes == 4 * plan.rows * plan.channels * elem <= lvc.SMEM_PER_BLOCK
        bigger = [t for t in (256, 128, 64, 32, 16) if t > plan.tile]
        fits = [t for t in bigger
                if 4 * (t + 2 * lvc._cores_halo(LAYERS, t)) * plan.channels * elem
                <= lvc.SMEM_PER_BLOCK]
        # a larger tile that fits is passed over only for the SMs' sake
        assert all(B * -(-frames * 6 // t) < lvc.SM_COUNT for t in fits)
    wide = lvc.lvc_plan(1, 512 * 6, 6, LAYERS, torch.float32, 128)
    assert (wide.tile, wide.smem_bytes) == (16, 229_376)


@pytest.mark.parametrize("hop", [8, 50, 64, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_widths_past_128_plan_the_wide_route(dtype, hop):
    """Every C from 129 to 512 at a 512-frame bucket's stage (and hop 50, not
    a multiple of 8) takes the wide route: a block owns 64 rows of one frame
    by 128 gate columns, its shared memory fits, the blocks cover every
    frame's rows and both halves of every gate column, the signal runs at
    C rounded up to 16, and the record is the plan's."""
    frames = 512
    for C in range(129, 513):
        plan = lvc.lvc_plan(1, frames * hop, hop, LAYERS, dtype, C)
        assert plan.route == lvc.WIDE_ROUTE and plan.record["route"] == "wide"
        assert plan.channels == lvc.wide_channels(C) == lvc.kernel_channels(C)
        assert C <= plan.channels < C + 16 and plan.channels % 16 == 0
        assert plan.smem_bytes == lvc.WIDE_SMEM <= lvc.SMEM_PER_BLOCK
        tiles, cols = -(-hop // plan.tile), -(-C // lvc.WIDE_GATE_COLUMNS)
        assert (tiles - 1) * plan.tile < hop <= tiles * plan.tile
        assert (cols - 1) * lvc.WIDE_GATE_COLUMNS < C <= cols * lvc.WIDE_GATE_COLUMNS
        assert plan.blocks == frames * tiles * cols
        assert (plan.round_frames, plan.nt, plan.halo) == (0, 0, 0)
    with pytest.raises(ValueError, match="C 0"):
        lvc.lvc_plan(1, frames * hop, hop, LAYERS, dtype, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_padding_is_exact(dtype):
    """The wide route's padding: the plain chain at C = 200 equals the plain
    chain on x, audio_down and the conv's taps and bias padded to 208
    (``pad_wide_inputs``) with the frame kernels and biases padded the same
    way, sliced back: the padded channels stay 0 (f32: within the card
    test's 2e-4 (1 + max |x|); bf16: ``bf16_chain_limits(200)``)."""
    g = torch.Generator().manual_seed(200)
    B, nL, hop, C = 1, 2, 8, 200
    L = nL * hop
    x = torch.randn(B, L, C, generator=g).to(dtype)
    ad = torch.randn(B, L, C, generator=g).to(dtype)
    k = (0.2 * torch.randn(B, nL, LAYERS, C, 2 * C, 3, generator=g)).to(dtype)
    b = 0.1 * torch.randn(B, nL, LAYERS, 2 * C, generator=g)
    cw = (0.1 * torch.randn(LAYERS, 3, C, C, generator=g)).to(dtype)
    cb = 0.1 * torch.randn(LAYERS, C, generator=g)
    want = lvc.lvc_stack_plain(x, ad, k, b, cw, cb, hop)
    Cp = lvc.wide_channels(C)
    xp, adp, cwp, cbp = lvc.pad_wide_inputs(x, ad, cw, cb, Cp)
    assert [tuple(t.shape) for t in (xp, adp, cwp, cbp)] == [
        (B, L, Cp), (B, L, Cp), (LAYERS, 3, Cp, Cp), (LAYERS, Cp)]
    _, _, kp, bp, _, _ = lvc.pad_lvc_inputs(x, ad, k, b, cw, cb, Cp)
    got = lvc.lvc_stack_plain(xp, adp, kp, bp, cwp, cbp, hop)
    assert not got[..., C:].any()
    if dtype == torch.float32:
        # summation order only, in sums of 600 terms (test_torch_kernels.py's
        # f32 bound for the card)
        err, top = (got[..., :C] - want).abs().max().item(), want.abs().max().item()
        assert err <= 2e-4 * (1 + top), (err, top)
    else:
        ulps, share = lvc.bf16_chain_error(got[..., :C], want, x, ad, LAYERS)
        most_ulps, most_unequal = lvc.bf16_chain_limits(C)
        assert ulps <= most_ulps and share <= most_unequal, (ulps, share)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_zero_padding_is_exact(dtype, fast):
    """The wrapper's padding: the plain chain at C = 48 equals the plain
    chain on the inputs padded to 64 (``pad_lvc_inputs``), sliced back to
    48: the padded channels stay exactly 0 through every layer and add
    only zeros to the real ones, so the two differ only where the f32 sums
    of F.conv1d and the LVC's einsum run in another order at another width
    (f32: within 1e-6 of |x|; bf16: ``bf16_chain_error``'s bounds)."""
    g = torch.Generator().manual_seed(48)
    B, nL, hop, C = 2, 3, 8, 48
    L = nL * hop
    x = torch.randn(B, L, C, generator=g).to(dtype)
    ad = torch.randn(B, L, C, generator=g).to(dtype)
    k = (0.2 * torch.randn(B, nL, LAYERS, C, 2 * C, 3, generator=g)).to(dtype)
    b = 0.1 * torch.randn(B, nL, LAYERS, 2 * C, generator=g)
    cw = (0.1 * torch.randn(LAYERS, 3, C, C, generator=g)).to(dtype)
    cb = 0.1 * torch.randn(LAYERS, C, generator=g)
    want = lvc.lvc_stack_plain(x, ad, k, b, cw, cb, hop, fast)
    padded = lvc.pad_lvc_inputs(x, ad, k, b, cw, cb, 64)
    assert [tuple(t.shape) for t in padded] == [
        (B, L, 64), (B, L, 64), (B, nL, LAYERS, 64, 128, 3), (B, nL, LAYERS, 128),
        (LAYERS, 3, 64, 64), (LAYERS, 64)]
    got = lvc.lvc_stack_plain(*padded, hop, fast)
    assert got.dtype == dtype and not got[..., C:].any()
    if dtype == torch.float32:
        torch.testing.assert_close(got[..., :C], want, rtol=1e-6, atol=1e-6)
    else:
        ulps, share = lvc.bf16_chain_error(got[..., :C], want, x, ad, LAYERS)
        assert ulps <= lvc.BF16_MAX_ULPS and share <= lvc.BF16_MAX_UNEQUAL, (ulps, share)


def _chain_f64_sums(x, ad, k, b, cw, cb, hop):
    """``lvc_stack_plain`` with the conv's and the LVC's sums taken in f64,
    rounded where the kernel rounds: the chain free of any f32 sum order."""
    import torch.nn.functional as F

    dt, C = x.dtype, x.shape[-1]
    for i in range(k.shape[2]):
        d = 3 ** i
        x = x + ad.to(dt)
        y = torch.maximum(x, x * lvc.LRELU_SLOPE)
        y = F.conv1d(y.double().transpose(1, 2), cw[i].to(dt).double().permute(2, 1, 0),
                     cb[i].double(), padding=d, dilation=d).transpose(1, 2)
        y = torch.maximum(y, y * lvc.LRELU_SLOPE).to(dt)
        g = lvc.location_variable_convolution(y.double(), k[:, :, i].to(dt).double(),
                                              b[:, :, i].double(), hop)
        x = x + lvc.gated_activation(g.float(), C, False).to(dt)
    return x


@pytest.mark.parametrize("C", [16, 32, 64, 128, 192, 256])
def test_bf16_chain_limits_leave_room_over_the_plain_chains_own_order(C):
    """``bf16_chain_limits`` against the order the sums are taken in: the
    plain bf16 chain (f32 sums) against the same chain with f64 sums
    differs by at most half the width's ulps limit, at a quarter of its
    share of unequal values or less: a kernel summing in another order
    flips more values as C grows, and the limits grow with it past 32, the
    share up to 128 (past it ``BF16_WIDE_UNEQUAL``, well below 1)."""
    g = torch.Generator().manual_seed(C)
    B, nL, hop = 2, 7, 64
    L = nL * hop
    x = torch.randn(B, L, C, generator=g).bfloat16()
    ad = torch.randn(B, L, C, generator=g).bfloat16()
    k = (0.2 * torch.randn(B, nL, LAYERS, C, 2 * C, 3, generator=g)).bfloat16()
    b = 0.1 * torch.randn(B, nL, LAYERS, 2 * C, generator=g)
    cw = (0.1 * torch.randn(LAYERS, 3, C, C, generator=g)).bfloat16()
    cb = 0.1 * torch.randn(LAYERS, C, generator=g)
    ulps, share = lvc.bf16_chain_error(lvc.lvc_stack_plain(x, ad, k, b, cw, cb, hop),
                                       _chain_f64_sums(x, ad, k, b, cw, cb, hop), x, ad, LAYERS)
    most_ulps, most_unequal = lvc.bf16_chain_limits(C)
    assert ulps <= most_ulps / 2 and share <= most_unequal / 4, (ulps, share)
    w = max(1, C // 32)
    share = lvc.BF16_MAX_UNEQUAL * w * w if C <= 128 else lvc.BF16_WIDE_UNEQUAL
    assert lvc.bf16_chain_limits(C) == (lvc.BF16_MAX_ULPS * w, share) and share < 0.5
