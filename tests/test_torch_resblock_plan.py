"""The resblock kernels' tile plan (ops/hifigan_resblock.py tile_plan) and
the bf16 leaky both routes share, on the CPU and without JAX: every HiFi-GAN
V1 stage's launch fits a block's shared memory and has blocks; each conv of
the chain computes the tile plus twice the reach still ahead; the leaky
rounds 0.1f * a once, which a bf16 0.1 would not."""

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as trb
from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator, HifiGanConfig

# mel frames of one vocoder call: a 1-frame mel and the serving path's
# frame buckets
MEL_FRAMES = (1, 256, 512, 768, 1280)


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
                want = "f32" if dtype == torch.float32 else ("wgmma" if w.channels >= 128 else "mma")
                assert plan.route == want
                assert 0 < plan.smem_bytes <= 232_448
                assert plan.blocks == B * -(-L // plan.tile) >= 1
                if plan.route != "f32":
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


@pytest.mark.parametrize("C_,k", [(256, 3), (128, 7), (64, 3)])
def test_kernel_taps_are_the_wgmma_chunk_images(C_, k):
    """bf16 taps at C >= 128 are stored as the wgmma route's shared-memory
    chunks: tap row kk, channel c of chunk kk // KC at box c // 64, row
    kk % KC, 16-byte piece ((c % 64) // 8) ^ (row % 8); below 128 channels,
    and in f32, the (k, C_in, C_out) order stays."""
    g = torch.Generator().manual_seed(C_ + k)
    w = torch.randn(k, C_, C_, generator=g).to(torch.bfloat16)
    flat = trb._kernel_taps(w)
    assert torch.equal(trb._kernel_taps(w.float()), w.float().reshape(-1))
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
