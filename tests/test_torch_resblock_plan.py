"""The resblock kernels' tile plan (ops/hifigan_resblock.py tile_plan), the
bf16 leaky both bf16 routes share and the f32 route's split taps, on the
CPU and without JAX: every HiFi-GAN V1 stage's launch fits a block's shared
memory and has blocks; each conv of the chain computes the tile plus twice
the reach still ahead; the leaky rounds 0.1f * a once, which a bf16 0.1
would not; the f32 taps are split into TF32 hi and lo halves that keep
f32's digits, in the order the split-TF32 route reads them."""

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as trb
from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator, HifiGanConfig
from tests.torch_port_helpers import torch_threads

# mel frames of one vocoder call: a 1-frame mel and the serving path's
# frame buckets
MEL_FRAMES = (1, 256, 512, 768, 1280)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _stage_weights(stage, dtype):
    return Generator(HifiGanConfig(), dtype).stage_weights[stage]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_v1_stage_plans_fit_a_block(stage, dtype):
    cfg = HifiGanConfig()
    hop = int(np.prod(cfg.upsample_rates[:stage + 1]))
    for w in _stage_weights(stage, dtype):
        for frames in MEL_FRAMES:
            for B in (1, 8):
                L = frames * hop
                plan = trb.tile_plan(w, B, L)
                f32 = dtype == torch.float32
                want = ({"mma_tf32_c4"} if f32 and w.channels == 256 else
                        {"mma_tf32", "mma_tf32_xl2"} if f32 else
                        {"wgmma" if w.channels >= 128 else "mma"})
                assert plan.route in want
                assert plan.x_in_smem == (plan.route in ("mma_tf32", "wgmma", "mma"))
                assert 0 < plan.smem_bytes <= 232_448
                split = 4 if plan.route == "mma_tf32_c4" else 1
                assert plan.blocks == split * B * -(-L // plan.tile) >= 1
                # a multiple of 16, no larger than the signal needs
                assert plan.tile % 16 == 0 and plan.tile <= 16 * -(-L // 16)
                assert 0.0 <= plan.halo_share < 1.0


def test_v1_bf16_plans_at_512_frames_fill_the_card():
    """At B=1 every stage of a 512-frame call launches at least 86 blocks
    (stage 0 k=7, 11) on the 132 SMs, and stages 2 and 3 fill them."""
    cfg, L = HifiGanConfig(), 512
    blocks = []
    for stage in range(4):
        L *= cfg.upsample_rates[stage]
        blocks += [trb.tile_plan(w, 1, L).blocks for w in _stage_weights(stage, torch.bfloat16)]
    assert min(blocks) >= 86
    assert blocks[-2] >= 128 and blocks[-1] >= 128


def _v2_stage_weights(stage, dtype):
    """HiFi-GAN V2's stage: its trio, then each resblock alone."""
    gen = Generator(HifiGanConfig(upsample_initial_channel=128), dtype)
    n = len(gen.cfg.resblock_kernel_sizes)
    return gen.stage_weights[stage] + [
        trb.prepare_resblock_weights([gen.resblocks[stage * n + j].spec()], dtype)
        for j in range(n)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stage", [2, 3])
def test_v2_narrow_stage_plans_fit_a_block_and_cover_l(stage, dtype):
    """HiFi-GAN V2's stages of 16 and 8 channels: every launch the kernels
    take at a served mel's lengths fits a block's shared memory (the ring,
    at csrc/resblock.cu's geometry, then t and x), and its tiles cover L;
    the byte-bound plan fills the SMs before it lengthens a tile."""
    cfg = HifiGanConfig(upsample_initial_channel=128)
    hop = int(np.prod(cfg.upsample_rates[:stage + 1]))
    f32 = dtype == torch.float32
    for w in _v2_stage_weights(stage, dtype):
        C, halo = w.channels, w.halo
        assert C == 128 // 2 ** (stage + 1)
        t_lo = min(halo - sum(r) + r[0] for r in w.reaches)
        for frames in MEL_FRAMES:
            for B in (1, 8):
                L = frames * hop
                plan = trb.tile_plan(w, B, L)
                assert plan.route in ({"mma_tf32", "mma_tf32_xl2"} if f32 else {"mma"})
                assert 0 < plan.smem_bytes <= 232_448
                tiles = -(-L // plan.tile)
                assert plan.tile % 16 == 0 and plan.blocks == B * tiles
                assert plan.tile * tiles >= L > plan.tile * (tiles - 1)
                if B * -(-L // 16) >= 132:
                    assert plan.blocks >= 128 or plan.tile >= 1024
                t_rows = plan.tile + 2 * (halo - t_lo)
                x_rows = plan.tile + 2 * halo if plan.x_in_smem else 0
                if f32:  # two chunks of 192 K-rows, hi and lo, and 16 bytes of mbarriers
                    assert plan.smem_bytes == 2 * 192 * C * 8 + 16 + (t_rows + x_rows) * (C + 8) * 4
                else:    # two chunks of 256 K-rows, rows padded to 48 (C = 8) or C + 8 elements
                    ld = 24 if C == 8 else C + 8
                    assert plan.smem_bytes == (2 * 256 + t_rows + x_rows) * ld * 2


def test_other_channel_counts_lay_out_plain_taps():
    """A width no kernel takes (a tiny test vocoder's 4 channels) still
    prepares: its taps keep the (k, C_in, C_out) order, for no kernel to read."""
    w = torch.randn(3, 4, 4)
    assert torch.equal(trb._kernel_taps(w), w.reshape(-1))
    assert 4 not in trb.KERNEL_CHANNELS and 8 in trb.KERNEL_CHANNELS


@pytest.mark.parametrize("ks,dils", [((11,), (1, 3, 5)), ((3, 7, 11), (1, 3, 5)),
                                     ((5,), (2,)), ((3, 7), (1, 2))])
@pytest.mark.parametrize("tile", [16, 48, 1008])
def test_conv_rows_are_the_tile_plus_the_reach_ahead(ks, dils, tile):
    def convs(k):
        return [(torch.zeros(8, 8, k), torch.zeros(8), torch.zeros(8, 8, k), torch.zeros(8))
                for _ in dils]

    w = trb.prepare_resblock_weights([(k, dils, convs(k)) for k in ks], torch.bfloat16)
    rows = trb.conv_rows(w, tile)
    extra = total = 0
    for k, got in zip(ks, rows):
        reach = [r for d in dils for r in (d * (k - 1) // 2, (k - 1) // 2)]
        want = [tile + 2 * sum(reach[i + 1:]) for i in range(len(reach))]
        assert list(got) == want
        assert got[-1] == tile
        extra += k * sum(n - tile for n in want)
        total += k * sum(want)
    assert trb.halo_share(w, tile) == pytest.approx(extra / total, rel=1e-12)


def test_bf16_leaky_rounds_the_f32_product_once():
    a = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32)
                         ).to(torch.bfloat16)
    af = a.float().numpy()
    once = torch.from_numpy(af * np.float32(0.1)).to(torch.bfloat16)
    bf16_tenth = torch.from_numpy(
        af * torch.tensor(0.1, dtype=torch.bfloat16).float().numpy()).to(torch.bfloat16)
    # a bf16 0.1 (0.10009765625) moves some products to another bf16 value
    assert torch.tensor(0.1, dtype=torch.bfloat16).item() == 0.10009765625
    assert (once != bf16_tenth).any()
    want = torch.maximum(a, once)
    got = trb.leaky(a)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("C_,k", [(256, 3), (128, 7), (64, 3), (16, 11), (8, 7)])
def test_kernel_taps_are_the_wgmma_chunk_images(C_, k):
    """bf16 taps at C >= 128 are stored as the wgmma route's shared-memory
    chunks: tap row kk, channel c of chunk kk // KC at box c // 64, row
    kk % KC, 16-byte piece ((c % 64) // 8) ^ (row % 8); below 128 channels
    the (k, C_in, C_out) order stays; f32 taps are split (split_taps)."""
    g = torch.Generator().manual_seed(C_ + k)
    w = torch.randn(k, C_, C_, generator=g).to(torch.bfloat16)
    flat = trb._kernel_taps(w)
    assert torch.equal(trb._kernel_taps(w.float()),
                       trb.split_taps(w.float(), 4 if C_ == 256 else 1))
    if C_ < 128:
        assert torch.equal(flat, w.reshape(-1))
        return
    kc = 8192 // C_
    kk = torch.arange(k * C_)[:, None]
    c = torch.arange(C_)[None, :]
    row = kk % kc
    off = ((kk // kc) * kc * C_ + (c // 64) * kc * 64 + row * 64
           + (((c % 64) // 8) ^ (row % 8)) * 8 + c % 8)
    assert torch.equal(flat[off], w.reshape(k * C_, C_))
    assert torch.equal(flat.sort().values, w.reshape(-1).sort().values)


# PR 10's f32 plan of a 512-frame call at B=1 (CUDA cores): blocks of stage
# 0's three launches (k = 3, 7, 11), which left most of the 132 SMs idle
PR10_F32_STAGE0_BLOCKS = (64, 43, 64)


def test_v1_f32_plans_at_512_frames_fill_the_card():
    """Stage 0's split-TF32 launches (C = 256: clusters of 4 blocks, each a
    quarter of the channels of a shared row tile) have more blocks than PR
    10's, and stages 1-3 at least 128 blocks on the 132 SMs: their plans
    take larger tiles than PR 10's (less halo, measured faster on the card
    by scripts/bench_resblock.py --sweep) but still one block for nearly
    every SM."""
    cfg, L = HifiGanConfig(), 512
    for stage in range(4):
        L *= cfg.upsample_rates[stage]
        for i, w in enumerate(_stage_weights(stage, torch.float32)):
            plan = trb.tile_plan(w, 1, L)
            if stage == 0:
                assert plan.route == "mma_tf32_c4"
                assert plan.blocks > PR10_F32_STAGE0_BLOCKS[i]
            else:
                assert plan.route in ("mma_tf32", "mma_tf32_xl2")
                assert plan.blocks >= 128


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_f32_plan_smem_is_the_ring_t_and_x(stage):
    """The f32 launch's shared memory as csrc/resblock.cu f32_smem counts it:
    a ring of two K-chunks (hi and lo, 32 KB each, 8 KB at C = 32) and 16
    bytes of mbarriers, then t and, in shared memory, x, at C + 8 floats a
    row. At C = 256 a cluster of 4 blocks shares a tile with x and t in
    L2: the ring alone."""
    cfg, L = HifiGanConfig(), 512
    for s_ in range(stage + 1):
        L *= cfg.upsample_rates[s_]
    for w in _stage_weights(stage, torch.float32):
        plan = trb.tile_plan(w, 1, L)
        C, halo = w.channels, w.halo
        t_lo = min(halo - sum(r) + r[0] for r in w.reaches)
        chunk = 8192 if C == 32 else 32768
        if C == 256:
            assert plan.route == "mma_tf32_c4" and plan.smem_bytes == 2 * chunk + 16
            continue
        rows = plan.tile + 2 * (halo - t_lo) + (plan.tile + 2 * halo if plan.x_in_smem else 0)
        assert plan.smem_bytes == 2 * chunk + 16 + rows * (C + 8) * 4


@pytest.mark.parametrize("C_,k", [(256, 11), (128, 3), (32, 7), (16, 11), (8, 3)])
def test_f32_split_taps_keep_f32_digits(C_, k):
    """hi + lo equals each f32 tap within 2^-22 of its size, and both halves
    are TF32 values (the low 13 bits of each f32 zero)."""
    g = torch.Generator().manual_seed(C_ * k)
    w = torch.randn(k, C_, C_, generator=g) * 0.05
    f = trb.split_taps(w).reshape(k * C_ // 8, C_ // 8, 32, 2, 2)
    hi, lo = f[..., 0, :], f[..., 1, :]
    for h in (hi, lo):
        assert not (h.contiguous().view(torch.int32) & 0x1FFF).any()
    # back to (k C, C) order: (k-step, n8 tile, g, t, e) -> row 8 s + 2 t + e, column 8 nt + g
    def unpack(h):
        return h.reshape(k * C_ // 8, C_ // 8, 8, 4, 2).permute(0, 3, 4, 1, 2).reshape(k * C_, C_)
    want = w.reshape(k * C_, C_).double()
    got = unpack(hi).double() + unpack(lo).double()
    assert ((got - want).abs() <= 2.0 ** -22 * want.abs()).all()
    assert ((unpack(hi).double() - want).abs() > 2.0 ** -22 * want.abs()).any()


@pytest.mark.parametrize("C_,k", [(256, 3), (64, 11), (32, 3)])
def test_f32_taps_lie_in_mma_fragment_order(C_, k):
    """split_taps lays each K-step of 8 rows of the (k C_in, C_out) matrix as
    the route reads it: per n8 tile of outputs, per lane (g = lane // 4,
    t = lane % 4) one 16-byte piece, hi of rows 2t and 2t + 1 at output
    8 nt + g, then lo of the same; a K-chunk of KC rows is then the
    contiguous run of its k-steps, one bulk copy."""
    g = torch.Generator().manual_seed(C_ + k)
    w = torch.randn(k, C_, C_, generator=g)
    flat = trb.split_taps(w)
    W = w.reshape(k * C_, C_)
    hi = trb.tf32(W)
    lo = trb.tf32(W - hi)
    s = torch.arange(k * C_ // 8)[:, None, None]
    nt = torch.arange(C_ // 8)[None, :, None]
    lane = torch.arange(32)[None, None, :]
    row, col = 8 * s + 2 * (lane % 4), 8 * nt + lane // 4
    want = torch.stack([hi[row, col], hi[row + 1, col], lo[row, col], lo[row + 1, col]], -1)
    assert torch.equal(flat.reshape(k * C_ // 8, C_ // 8, 32, 4), want)
    # chunk i of KC rows starts at float 2 * i * KC * C
    kc = C_ if C_ < 128 else 4096 // C_
    chunk = flat.reshape(-1, 2 * kc * C_)[1]
    assert torch.equal(chunk, want[kc // 8:2 * kc // 8].reshape(-1))


def test_f32_taps_of_a_split_tile_hold_each_blocks_outputs_in_turn():
    """At C = 256 a cluster of 4 blocks shares a tile, block r computing
    outputs [64 r, 64 r + 64): split_taps(w, 4) lays block r's part (its
    outputs, in the fragment order of test_f32_taps_lie_in_mma_fragment_order)
    as the r-th quarter of the conv's taps."""
    k, C_ = 3, 256
    g = torch.Generator().manual_seed(7)
    w = torch.randn(k, C_, C_, generator=g)
    parts = trb.split_taps(w, 4).reshape(4, -1)
    for r in range(4):
        assert torch.equal(parts[r], trb.split_taps(w[:, :, 64 * r:64 * r + 64].contiguous()))
