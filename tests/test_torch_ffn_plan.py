"""The FFN kernels' tile plan (ops/ffn.py ffn_plan) and weight image, on the
CPU and without JAX: every flagship FFN launch (the 4 encoder and 4 decoder
blocks of a training step, and the serving shape) covers T with blocks that
each own rows and fits a block's shared memory, in both dtypes;
ffn_train_fits accepts what the kernels take; the bf16 kernels' weight
image puts every W1 and W2f element at the byte the descriptors read."""

import pytest
import torch

from lightningfastspeech2_tpu_torch.ops import ffn

C, F = 256, 1024
# (B, T, k, mode): the training step's encoder (P = 256) and decoder
# (T = 2048) blocks, and the served batch's decoder bucket
SHAPES = ([(8, 256, k, m) for k in (5, 25, 13, 9) for m in ("train", "bwd")]
          + [(8, 2048, k, m) for k in (17, 21, 9, 13) for m in ("train", "bwd")]
          + [(8, 512, 17, "serve")])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,k,mode", SHAPES)
def test_flagship_launches_cover_t_and_fit_a_block(B, T, k, mode, dtype):
    plan = ffn.ffn_plan(C, F, k, B, T, dtype, mode)
    want = {("bf16", "bwd"): ["ffn_ln_kernel", "ffn_dup_kernel", "ffn_dt1_kernel"],
            ("f32", "bwd"): ["ffn_bwd_kernel"]}.get(
        ("bf16" if dtype == torch.bfloat16 else "f32", mode),
        ["ffn_ln_kernel" if dtype == torch.bfloat16 else "ffn_ln_f32_kernel"])
    assert [p.kernel for p in plan] == want
    for p in plan:
        assert p.rows >= 1
        assert p.grid[0] * p.rows >= T > (p.grid[0] - 1) * p.rows
        assert p.grid[1:] == (B, 1)
        assert 0 < p.smem_bytes <= ffn.SMEM_LIMIT
        if p.fchunk:
            assert F % p.fchunk == 0
    if dtype == torch.bfloat16:
        # the wgmma launches: 128-row blocks of two warpgroups, 64-column chunks
        assert all((p.rows, p.fchunk, p.threads) == (128, 64, 256)
                   for p in plan if p.kernel != "ffn_dt1_kernel")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_fits_takes_what_the_kernels_take(dtype):
    kmax = 63 if dtype == torch.bfloat16 else 31
    for c in (32, 64, 128, 256):
        for k in (1, 5, 25, kmax):
            assert ffn.ffn_train_fits(c, F, k, dtype), (c, k)
        assert not ffn.ffn_train_fits(c, F, kmax + 1, dtype)
        assert not ffn.ffn_train_fits(c, 1000, 5, dtype)
    assert not ffn.ffn_train_fits(96, F, 5, dtype)
    assert ffn.ffn_train_fits(256, 1024, 25, dtype)


@pytest.mark.parametrize("C_,F_", [(32, 128), (128, 128)])
def test_weight_image_puts_each_element_where_the_descriptors_read(C_, F_):
    # W1 chunk: CP rows (channels) of 64 columns, 128 bytes a row; W2f
    # chunk: CP / 64 boxes of 64 rows (filter columns) by 64 channels; the
    # 16-byte piece q of row r stored at q ^ (r % 8); channels past C zero
    g = torch.Generator().manual_seed(0)
    w1 = torch.randn(C_, F_, generator=g).bfloat16().float()
    w2f = torch.randn(F_, C_, generator=g).bfloat16().float()
    img = ffn._weight_image(w1, w2f).float()
    cp = max(C_, 64)
    assert img.shape == (F_ // 64, 2 * cp * 64) and img.dtype == torch.float32
    c = torch.arange(cp)[:, None]
    f = torch.arange(64)[None, :]
    w1_at = (c * 128 + (((f // 8) ^ (c % 8)) * 16) + (f % 8) * 2) // 2        # (cp, 64)
    fr = torch.arange(64)[:, None]
    cc = torch.arange(cp)[None, :]
    w2_at = cp * 64 + ((cc // 64) * 8192 + fr * 128 + ((((cc % 64) // 8) ^ (fr % 8)) * 16)
                       + (cc % 8) * 2) // 2                                     # (64, cp)
    for i in range(F_ // 64):
        want1 = torch.zeros(cp, 64)
        want1[:C_] = w1[:, 64 * i:64 * i + 64]
        want2 = torch.zeros(64, cp)
        want2[:, :C_] = w2f[64 * i:64 * i + 64]
        assert torch.equal(img[i][w1_at], want1)
        assert torch.equal(img[i][w2_at], want2)
