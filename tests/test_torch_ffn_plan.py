"""The FFN kernels' tile plan (ops/ffn.py ffn_plan) and weight images, on
the CPU and without JAX: every flagship FFN launch (the 4 encoder and 4
decoder blocks of a training step, and the serving shape) covers T with
blocks that each own rows and fits a block's shared memory, in both dtypes;
the f32 route's launches own every row they compute at the flagship's and
the f32 reference step's shapes and take 64-row blocks where those fill the
card; ffn_train_fits accepts what the kernels take; the bf16 kernels'
weight image puts every W1 and W2f element at the byte the descriptors
read, and the f32 kernels' split pieces put every element where the
fragment loads read it, hi + lo within 2^-22 of the weight."""

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu_torch.ops import ffn, gemm

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
            ("f32", "bwd"): ["ffn_tf32_kernel", "ffn_dup_tf32_kernel", "ffn_dt1_kernel"]}.get(
        ("bf16" if dtype == torch.bfloat16 else "f32", mode),
        ["ffn_ln_kernel" if dtype == torch.bfloat16 else "ffn_tf32_kernel"])
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
    else:
        # the split-TF32 launches: 64- or 32-row blocks of eight warps, F in
        # chunks of 32 (forward, chain) and 16 (dup)
        assert all(p.rows in (32, 64) and p.threads == 256 for p in plan
                   if p.kernel != "ffn_dt1_kernel")
        assert [p.fchunk for p in plan] == [32, 16, 0][:len(plan)]


# phase 9's f32 step of chip_smoke.py: B = 2, P = 128, T = 1024
F32_SHAPES = ([(B, P, k) for B, P in ((8, 256), (2, 128)) for k in (5, 25, 13, 9)]
              + [(B, T, k) for B, T in ((8, 2048), (2, 1024)) for k in (17, 21, 9, 13)])


@pytest.mark.parametrize("B,T,k", F32_SHAPES)
def test_f32_launches_own_every_row_they_compute(B, T, k):
    # the chain and the dup pass form their products on the block's own
    # rows only (no halo row is computed twice), the grids tile T exactly
    # once, and every launch fits a block's shared memory and, for the
    # forward, the t1 window of its piece buffers
    fwd, = ffn.ffn_plan(C, F, k, B, T, torch.float32, "train")
    chain, dup, dt1 = ffn.ffn_plan(C, F, k, B, T, torch.float32, "bwd")
    assert chain == fwd
    for p in (chain, dup, dt1):
        assert p.grid[0] == -(-T // p.rows) and p.grid[1:] == (B, 1)
        assert p.smem_bytes <= ffn.SMEM_LIMIT
    assert dup.rows == chain.rows and dup.grid == chain.grid
    assert chain.rows + k - 1 <= 2 * 32 * 8 // 4   # the window over two 32-column pieces
    assert ffn.ffn_train_fits(C, F, k, torch.float32)


@pytest.mark.parametrize("B,T,rows", [(8, 2048, 64), (8, 256, 32), (2, 1024, 32), (2, 128, 32),
                                      (16, 2048, 64), (3, 300, 32)])
def test_f32_rows_fill_the_card(B, T, rows):
    # 64-row blocks where they fill as many waves of the card's 132 SMs as
    # 32-row ones (half the weight streaming a row), 32 where 64 would leave
    # SMs idle (the encoder's 2048 rows: 32 blocks of 64 against 64 of 32)
    assert ffn.ffn_plan(C, F, 9, B, T, torch.float32, "serve")[0].rows == rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_fits_takes_what_the_kernels_take(dtype):
    # f32: the dt1 tile (64 + k - 1 rows of f32 dacc and t1) at C = 256
    kmax = 63 if dtype == torch.bfloat16 else 50
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


@pytest.mark.parametrize("C_,F_,which", [(32, 128, "fwd"), (64, 256, "fwd"), (32, 128, "dup"),
                                         (128, 128, "dup")])
def test_f32_pieces_lie_where_the_fragment_loads_read(C_, F_, which):
    # per chunk of fc F columns, pieces (K x N): fwd W1 (C x fc), W2f (fc x
    # C); dup W1 (C x fc), W2f^T (C x fc), W1^T (fc x C). Lane 4 g + t of
    # k-step s and n8 tile j reads one float4 at ((s N / 8 + j) 32 + lane):
    # hi of rows 8 s + 2 t and 8 s + 2 t + 1 at column 8 j + g, then lo
    g = torch.Generator().manual_seed(C_ + F_)
    w1 = torch.randn(C_, F_, generator=g)
    w2f = torch.randn(F_, C_, generator=g)
    img = ffn._f32_image(w1, w2f, which)
    fc = 32 if which == "fwd" else 16
    n_pieces = 2 if which == "fwd" else 3
    assert img.shape == (F_ // fc, n_pieces, C_ * fc * 2) and img.dtype == torch.float32
    rng = np.random.default_rng(0)
    for _ in range(200):
        ci = int(rng.integers(F_ // fc))
        m = int(rng.integers(n_pieces))
        w1c, w2c = w1[:, ci * fc:(ci + 1) * fc], w2f[ci * fc:(ci + 1) * fc]
        mat = [w1c, w2c if which == "fwd" else w2c.t(), w1c.t()][m]
        K, N = mat.shape
        s, j = int(rng.integers(K // 8)), int(rng.integers(N // 8))
        gg, t = int(rng.integers(8)), int(rng.integers(4))
        at = ((s * (N // 8) + j) * 32 + 4 * gg + t) * 4
        quad = img[ci, m, at:at + 4]
        for e in range(2):
            x = mat[8 * s + 2 * t + e, 8 * j + gg]
            hi, lo = quad[e], quad[2 + e]
            assert hi == ffn.tf32(x.reshape(1))[0] and lo == ffn.tf32((x - hi).reshape(1))[0]


@pytest.mark.parametrize("which", ["fwd", "dup"])
def test_f32_pieces_keep_f32_digits(which):
    # hi + lo gives back each f32 weight to 2^-22 of its size, and both
    # halves are TF32 values (their low 13 mantissa bits zero)
    g = torch.Generator().manual_seed(7)
    w1 = torch.randn(256, 1024, generator=g) * 0.05
    w2f = torch.randn(1024, 256, generator=g) * 0.05
    img = ffn._f32_image(w1, w2f, which).reshape(-1, 4)
    hi, lo = img[:, :2].reshape(-1), img[:, 2:].reshape(-1)
    assert not (hi.view(torch.int32) & 0x1FFF).any() and not (lo.view(torch.int32) & 0x1FFF).any()
    x = hi.double() + lo.double()
    assert x.numel() == (3 if which == "dup" else 2) * w1.numel()
    # every weight appears (in its pieces' order): compare the sorted values
    src = torch.cat([w1.reshape(-1), w2f.reshape(-1)] + ([w1.reshape(-1)] if which == "dup" else []))
    assert torch.allclose(x.sort().values, src.double().sort().values, rtol=2.0 ** -22, atol=0)


# lightspeech_true76m's serving widths (C = 640, F = 2560) at every kernel
# size of its blocks, a request's and a batch's buckets, and C = 384 / 512
WIDE_SHAPES = ([(640, 2560, k, B, T) for k in (5, 9, 13, 17, 21, 25)
                for B, T in ((1, 32), (1, 256), (8, 512))]
               + [(384, 1536, 17, 8, 512), (512, 2048, 17, 8, 512)])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_,F_,k,B,T", WIDE_SHAPES)
def test_wide_serving_launch_covers_t_and_fits_a_block(C_, F_, k, B, T, dtype):
    """The wide route's two launches: ffn_wide_kernel's blocks own 64 rows
    (bf16) or 32 (f32) of one item and 32-column F chunks; its grid covers
    every row of every item once per split of F (grid x padded to whole
    clusters by less than a cluster), every split takes chunks, and the
    LN2 pass covers every row once; both fit a block."""
    main, ln2 = ffn.ffn_plan(C_, F_, k, B, T, dtype, "serve")
    R, threads = (32, 288) if dtype == torch.float32 else (64, 256)
    assert (main.kernel, main.rows, main.fchunk, main.threads) == ("ffn_wide_kernel", R, 32, threads)
    x, by, splits = main.grid
    tiles = -(-T // R)
    assert by == B and x % main.cluster == 0 and tiles <= x < tiles + main.cluster
    nch = F_ // main.fchunk
    per = -(-nch // splits)
    assert 1 <= splits <= nch and (splits - 1) * per < nch <= splits * per
    assert main.smem_bytes == ffn._wide_smem(C_, k, dtype) and ffn._fits(main, k)
    assert 0 < main.smem_bytes <= ffn.SMEM_LIMIT
    # L2 serves each weight tile once per cluster of row tiles: 64 rows or more
    assert R * main.cluster >= 64 or tiles == 1
    assert (ln2.kernel, ln2.cluster, ln2.smem_bytes, ln2.threads) == ("ffn_wide_ln2_kernel", 1, 0, 256)
    assert ln2.rows == 8 // min(8, 1 << (splits.bit_length() - 1))   # up to 8 warps a row
    assert ln2.grid[1:] == (1, 1) and ln2.grid[0] * ln2.rows >= B * T > (ln2.grid[0] - 1) * ln2.rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [32, 256])
def test_wide_small_launches_fill_half_the_card(T, dtype):
    """A B = 1 launch at a sentence's phones or a request's frame bucket
    splits F until at least half of the card's 132 SMs hold a block, and
    its clusters still read the image about once (no more than two row
    clusters an item)."""
    main, _ = ffn.ffn_plan(640, 2560, 5, 1, T, dtype, "serve")
    assert main.grid[0] * main.grid[1] * main.grid[2] >= 66
    assert main.grid[0] // main.cluster <= 2


def test_wide_batch_reads_a_quarter_of_the_first_designs_weight_bytes():
    """At (8, 512, 640) the bf16 launch reads the 6.55 MB image once per
    cluster of row tiles: at most a quarter of the 839 MB that 128 blocks
    of 32 rows read; f32 (the split halves, 26.2 MB) at most half of 3.35
    GB."""
    for dtype, image, share in ((torch.bfloat16, 2 * 640 * 2560 * 2, 4),
                                (torch.float32, 2 * 640 * 2560 * 8, 2)):
        main, _ = ffn.ffn_plan(640, 2560, 17, 8, 512, dtype, "serve")
        reads = main.grid[0] // main.cluster * main.grid[1] * image
        assert reads * share <= 128 * image, (dtype, reads)


def _first_design_smem(C_, k, dtype):
    """The first wide kernel's shared memory (32-row blocks, the whole t1
    window in f32): the widths ``_fits`` admitted before this design."""
    f32 = dtype == torch.float32
    w = 32 + k - 1
    return ((32 * C_ * 4 if f32 else 32 * (C_ + 8) * 2)
            + max(w * C_ * 4, 32 * (C_ + 4) * 4, 2 * (32 * 32 * 8 if f32 else 32 * 40 * 2)) + w * 8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_", ffn.WIDE_C)
def test_wide_takes_every_kernel_size_it_took_before(C_, dtype):
    """No depthwise width that launched on the first design raises now."""
    kmax = max(k for k in range(1, 200) if _first_design_smem(C_, k, dtype) <= ffn.SMEM_LIMIT)
    assert kmax >= (27 if (C_, dtype) == (640, torch.float32) else 43)
    for k in range(1, kmax + 1):
        assert ffn._fits(ffn.ffn_plan(C_, 4 * C_, k, 1, 256, dtype, "serve")[0], k), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_", ffn.WIDE_C)
def test_training_past_256_is_admitted_where_the_jax_estimate_admits_it(C_, dtype):
    """Past C = 256 the training kernels (csrc/ffn_wide.cu's chain) take
    every width the JAX gate's fit estimate admits, so the port's gate
    admits it too: C up to 768 with F = 1024, and C + 512 (896 to 1152)
    with F = 512, where F < C, which the row kernels past 768 take."""
    from lightningfastspeech2_tpu_torch.models.layers import ffn_fused_ok

    for C, F in ((C_, 1024), (C_ + 512, 512)):
        assert ffn.ffn_train_fits(C, F, 5, dtype)
        assert ffn_fused_ok(C, F, True)
        assert ffn_fused_ok(C, F, False)   # serving takes them
    assert ffn_fused_ok(896, 768, True)


# the training widths past C = 256: what a depthwise block builds (F a
# multiple of C) and what the JAX fit estimate alone also admits; past 768
# (the row kernels that read a row again) up to 4096
CHAIN_WIDTHS = [(384, 384), (384, 768), (384, 1152), (512, 512), (512, 1024), (640, 640),
                (768, 768), (384, 1024), (640, 1024), (768, 896),
                (896, 768), (1024, 512), (1024, 1024), (2048, 2048), (4096, 4096)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_,F_", CHAIN_WIDTHS)
def test_training_chain_covers_the_rows_and_fits_a_block(C_, F_, dtype):
    """ffn_ln_train from C = 384 runs csrc/ffn_wide.cu: the forward's five
    launches and the backward's eleven cover every row, channel and F
    column (the products' tiles, the depthwise tiles of each item, the row
    kernels' rows; dW1 and dW2f split over all B T rows), and each fits a
    block, at every kernel size the C = 256 kernels take; past C = 768 the
    four LN row kernels are the ones that read a row again."""
    ln = "wide_ln{}_long_kernel" if C_ > ffn.LANE_MAX_C else "wide_ln{}_kernel"
    for B, T in ((1, 1), (8, 256), (8, 2048), (3, 300)):
        M = B * T
        fwd = ffn.ffn_plan(C_, F_, 5, B, T, dtype, "train")
        bwd = ffn.ffn_plan(C_, F_, 5, B, T, dtype, "bwd")
        assert [x.kernel for x in fwd] == [ln.format(1), "wide_dw_kernel", "gemm_up",
                                           "gemm_down", ln.format(2)]
        assert [x.kernel for x in bwd[:4]] == [x.kernel for x in fwd[:4]]
        assert [bwd[4].kernel, bwd[10].kernel] == [ln.format("2_bwd"), ln.format("1_bwd")]
        assert len(bwd) == 11
        for x in fwd + bwd:
            gx, gy, gz = x.grid
            if x.kernel.startswith("gemm_dw"):   # (N tiles, M' tiles, splits of the rows)
                n, m = (F_, C_) if x.kernel == "gemm_dw1" else (C_, F_)
                kper = gemm.split_k_rows((C_ // 128) * (F_ // 128), M)
                assert (gx * 128, gy * 128) == (n, m) and (gz - 1) * kper < M <= gz * kper
            elif x.kernel.startswith("gemm_"):
                assert gx * 128 in (C_, F_) and gy * 128 >= M > (gy - 1) * 128 and gz == 1
            elif "dw" in x.kernel:
                assert (gy * 64, gz) == (C_, B) and gx * 64 >= T > (gx - 1) * 64
            else:
                assert gx * x.rows >= M > (gx - 1) * x.rows
    for k in range(1, ffn._MAX_K[dtype] + 1):
        assert ffn.ffn_train_fits(C_, F_, k, dtype), k
    assert not ffn.ffn_train_fits(C_, F_, ffn._MAX_K[dtype] + 1, dtype)


def _wide_boxes(img, C_, F_):
    """``_wide_image`` read as the bf16 kernel's descriptors read it: per
    chunk, part and 4 KB box, the 32 x 64 matrix whose row r's 16-byte piece
    q ^ (r % 8) lies at bytes 128 r + 16 q (the 128-byte swizzle)."""
    x = img.float().reshape(F_ // 32, 2, C_ // 64, 32, 8, 8)
    r = torch.arange(32)[:, None]
    q = torch.arange(8)[None, :] ^ (r % 8)          # logical piece -> stored piece
    return x[:, :, :, r, q].reshape(F_ // 32, 2, C_ // 64, 32, 64)


@pytest.mark.parametrize("C_,F_", [(384, 256), (640, 128)])
def test_wide_image_puts_each_element_where_the_fragment_loads_read(C_, F_):
    """``_wide_image``: per 32-column chunk i, C / 64 W1 boxes (the up
    product's B, K-major: row f, 64 channels) then C / 64 W2f boxes (the
    down product's B, MN-major: row f, 64 channels), each 32 rows of 128
    bytes in the 128-byte swizzle, rounded to bf16."""
    g = torch.Generator().manual_seed(C_)
    w1, w2f = torch.randn(C_, F_, generator=g), torch.randn(F_, C_, generator=g)
    img = ffn._wide_image(w1, w2f)
    assert img.shape == (F_ // 32, 64 * C_) and img.dtype == torch.bfloat16
    boxes = _wide_boxes(img, C_, F_)
    for i in range(F_ // 32):
        for b in range(C_ // 64):
            want1 = w1[64 * b:64 * b + 64, 32 * i:32 * i + 32].t().bfloat16().float()
            want2 = w2f[32 * i:32 * i + 32, 64 * b:64 * b + 64].bfloat16().float()
            assert torch.equal(boxes[i, 0, b], want1)
            assert torch.equal(boxes[i, 1, b], want2)


def _wide_f32_parts(img, C_, F_):
    """``_wide_f32_image`` read as the f32 kernel's fragment loads read it:
    per chunk the W1 part (C x 32) and the W2f part (32 x C), hi + lo. Lane
    4 g + t of W1 slab kb reads the float4 at ((s 4 + j) 32 + lane): hi of
    rows 64 kb + 8 s + 2 t, + 1 at column 8 j + g, then lo; of W2f slab nb
    at ((s 8 + j) 32 + lane): rows 8 s + 2 t, + 1 at column 64 nb + 8 j +
    g."""
    n, nb = F_ // 32, C_ // 64
    x = img.double().reshape(n, 2, nb, -1, 32, 4)
    val = x[..., :2] + x[..., 2:]                      # (n, part, slab, s j, lane, e)
    w1 = torch.zeros(n, C_, 32, dtype=torch.float64)
    w2 = torch.zeros(n, 32, C_, dtype=torch.float64)
    lane = torch.arange(32)
    gg, t = lane // 4, lane % 4
    for kb in range(nb):
        for s in range(8):
            for j in range(4):
                for e in range(2):
                    w1[:, 64 * kb + 8 * s + 2 * t + e, 8 * j + gg] = val[:, 0, kb, 4 * s + j, :, e]
        for s in range(4):
            for j in range(8):
                for e in range(2):
                    w2[:, 8 * s + 2 * t + e, 64 * kb + 8 * j + gg] = val[:, 1, kb, 8 * s + j, :, e]
    return w1, w2


@pytest.mark.parametrize("C_,F_", [(384, 64), (640, 32)])
def test_wide_f32_image_puts_each_element_where_the_fragment_loads_read(C_, F_):
    """``_wide_f32_image``: per 32-column chunk C / 64 W1 slabs, then C / 64
    W2f slabs, 16 KB each; every weight where its lane reads it, hi + lo
    within 2^-22 of it, both TF32 values."""
    g = torch.Generator().manual_seed(C_ + F_)
    w1, w2f = torch.randn(C_, F_, generator=g), torch.randn(F_, C_, generator=g)
    img = ffn._wide_f32_image(w1, w2f)
    assert img.shape == (F_ // 32, 2, 64 * C_) and img.dtype == torch.float32
    assert not (img.view(torch.int32) & 0x1FFF).any()
    p1, p2 = _wide_f32_parts(img, C_, F_)
    for i in range(F_ // 32):
        torch.testing.assert_close(p1[i], w1[:, 32 * i:32 * i + 32].double(), rtol=2.0 ** -22, atol=0)
        torch.testing.assert_close(p2[i], w2f[32 * i:32 * i + 32].double(), rtol=2.0 ** -22, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wide_splits_rebuild_the_ffn_from_the_image(dtype):
    """The wide launch's dataflow on the CPU: each split of F takes its
    chunks' tiles from the image as the kernel streams them (chunks split s
    .. of ceil(F / 32 / splits)), forms up = relu(h0 W1 + b1) at the plain
    version's rounding points and its ff partial sums; the LN2 pass adds
    the splits in order with b2f and the residual. Held to ffn_ln_plain."""
    from tests.torch_port_helpers import ffn_modules, ffn_params

    C_, F_, k, B, T = 384, 768, 5, 1, 40
    w = ffn.prepare_ffn_weights(**ffn_modules(ffn_params(4, C_, F_, k)), dtype=dtype)
    z = torch.randn(B, T, C_, generator=torch.Generator().manual_seed(5)).to(dtype)
    main, _ = ffn.ffn_plan(C_, F_, k, B, 1, dtype, "serve")   # one row tile: F split 24 ways
    splits = main.grid[2]
    assert splits == F_ // 32
    if dtype == torch.float32:
        w1p, w2p = (p.float() for p in _wide_f32_parts(ffn._wide_f32_image(w.w1, w.w2f), C_, F_))
    else:
        boxes = _wide_boxes(ffn._wide_image(w.w1, w.w2f), C_, F_)
        w1p = boxes[:, 0].permute(0, 2, 1, 3).reshape(F_ // 32, 32, C_).transpose(1, 2)
        w2p = boxes[:, 1].permute(0, 2, 1, 3).reshape(F_ // 32, 32, C_)
    g1, be1, g2, be2, bd, b2f = w.lnp
    t1 = ffn.layer_norm_fn(z, g1, be1, dtype, w.eps).float()
    h0 = ffn.depthwise_conv1d(t1, w.wd.t().unsqueeze(1), bd).to(dtype).float()
    nch, per = F_ // 32, -(-F_ // 32 // splits)
    parts = []
    for s in range(splits):
        ff = torch.zeros(B, T, C_)
        for c in range(s * per, min(nch, s * per + per)):
            up = torch.relu(h0 @ w1p[c] + w.b1[32 * c:32 * c + 32]).to(dtype).float()
            ff += up @ w2p[c]
        parts.append(ff)
    ff = sum(parts[1:], parts[0]) + b2f
    out = ffn.layer_norm_fn(t1 + ff, g2, be2, dtype, w.eps)
    ref = ffn.ffn_ln_plain(z, w)
    tol = 2e-5 if dtype == torch.float32 else 0.07
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_", [896, 1024, 2048, 4096])
def test_serving_past_768_covers_the_rows_and_fits_a_block(C_, dtype):
    """ffn_ln serves every multiple of 128 past 768 on csrc/ffn_wide.cu's
    chain, its LN rows on the kernels that read a row twice (no per-lane
    registers, any C): every launch covers its rows, channels and F columns
    and fits a block, at every kernel size the chain takes."""
    assert ffn.serve_ok(C_) and ffn.train_ok(C_)
    assert ffn.on_chain(C_, "serve") and ffn.on_chain(C_, "train")
    for F_ in (C_, 4 * C_, 512):
        for B, T in ((1, 1), (1, 64), (8, 512), (3, 300)):
            M = B * T
            plan = ffn.ffn_plan(C_, F_, 17, B, T, dtype, "serve")
            assert [x.kernel for x in plan] == ["wide_ln1_long_kernel", "wide_dw_kernel",
                                                "gemm_up", "gemm_down", "wide_ln2_long_kernel"]
            for x in plan:
                gx, gy, gz = x.grid
                if x.kernel.startswith("gemm_"):
                    assert gx * 128 in (C_, F_) and gy * 128 >= M > (gy - 1) * 128 and gz == 1
                elif "dw" in x.kernel:
                    assert (gy * 64, gz) == (C_, B) and gx * 64 >= T > (gx - 1) * 64
                else:
                    assert gx * x.rows >= M > (gx - 1) * x.rows
        for k in range(1, ffn._CHAIN_MAX_K + 1):
            assert all(ffn._fits(x, k) for x in ffn.ffn_plan(C_, F_, k, 1, 64, dtype, "serve"))


def test_every_width_the_jax_serving_gate_fuses_is_served():
    """No width rule refuses what the JAX serving gate admits (hidden and
    filter multiples of 128): C = 128 and 256 on the fused kernels, 384-640
    on ffn_wide_kernel, 768 on with the chain; the chain's lane kernels end
    at 768, its long-row kernels start past it."""
    for C_ in range(128, 4097, 128):
        assert ffn.serve_ok(C_), C_
        plan = ffn.ffn_plan(C_, 1024, 17, 1, 64, torch.bfloat16, "serve")
        want = ("ffn_ln_kernel" if C_ <= 256 else "ffn_wide_kernel" if C_ in ffn.WIDE_C
                else "wide_ln1_kernel" if C_ == 768 else "wide_ln1_long_kernel")
        assert plan[0].kernel == want, C_
    assert not any(ffn.serve_ok(c) for c in (96, 320, 900, 1000))
