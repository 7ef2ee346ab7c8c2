"""Split-TF32 products, as the f32 route of flash attention forms them on the
tensor cores (csrc/flash_attention.cu), emulated on the CPU: TF32 rounding
by integer ops on the f32 bits (``cvt.rna.tf32.f32``), and at the card
tests' smallest flash shape the score and P.V products held to the f32
card tolerance of ``test_flash_attention_kernels_match_plain`` (1e-4 of
each item's largest element, 1e-5 on the mean), which the split products
meet and one-pass TF32 products do not; and one stage-2 frame of the LVC
product of csrc/lvc_stack.cu's f32 route, held to that kernel's f32 card
tolerance the same way; and one product of a stage-0 HiFi-GAN resblock
conv as csrc/resblock.cu's f32 route forms it, held to that kernel's f32
card tolerance; and the FFN half's up product (64 rows, K = C = 256) and
down product (K = F = 1024, summed 64 k indices at a time in f32) as the
f32 route of csrc/ffn_ln.cu forms them, held to ffn_ln_train's f32 card
tolerance. Imports no JAX."""

import math

import numpy as np
import pytest
import torch

from torch_port_helpers import tf32_matmul, tf32_round

# the card tests' smallest flash case (_FLASH_CASES["T1024"]): B, H, T, valid keys
B, H, T, D = 2, 2, 1024, 128
LENGTHS = (1024, 700)


@pytest.mark.parametrize("x,want", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),                   # a tie goes away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 3 * 2.0 ** -11, 1.0 + 2.0 ** -9),                 # ... whichever way that is
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),                    # below half an ulp: down
    (3.0 + 2.0 ** -9, 3.0 + 2.0 ** -9),                      # representable: unchanged
])
def test_tf32_round_is_cvt_rna(x, want):
    got = tf32_round(torch.tensor([x], dtype=torch.float32)).item()
    assert got == want


def test_split_keeps_22_bits():
    # x - hi is exact in f32 and within 2^-11 |x|; lo keeps 11 bits of it
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    hi = tf32_round(x)
    lo = tf32_round(x - hi)
    assert bool((tf32_round(hi) == hi).all() and (tf32_round(lo) == lo).all())
    assert ((x - hi).abs() <= 2.0 ** -11 * x.abs()).all()
    assert ((x.double() - hi.double() - lo.double()).abs() <= 2.0 ** -22 * x.double().abs()).all()


@pytest.fixture(scope="module")
def operands():
    """Per product, the f32 operands (a, b) of a @ b at the card tests'
    smallest flash shape: q and k^T / sqrt(d) for the scores; the
    probabilities of the masked softmax (rounded to f32 from f64) and v for
    P.V."""
    rng = np.random.default_rng(1024)
    q, k, v = (torch.from_numpy(rng.standard_normal((B, H, T, D)).astype(np.float32))
               for _ in range(3))
    kt = (k / math.sqrt(D)).transpose(-1, -2).contiguous()
    s = q.double() @ kt.double()
    mask = torch.arange(T)[None, :] < torch.tensor(LENGTHS)[:, None]
    p = torch.softmax(torch.where(mask[:, None, None, :], s, -1e30), dim=-1).float()
    return {"scores": (q, kt), "pv": (p, v)}


def _within_card_tolerance(got, want):
    """test_torch_kernels.py's f32 flash check: per batch item, max error
    <= 1e-4 of the item's largest element + 1e-6, mean <= 1e-5 of it + 1e-7."""
    for b in range(want.shape[0]):
        top = want[b].abs().max().item()
        err = (got[b].double() - want[b]).abs()
        if err.max().item() > 1e-4 * top + 1e-6 or err.mean().item() > 1e-5 * top + 1e-7:
            return False
    return True


@pytest.mark.parametrize("split", [True, False], ids=["split", "one_pass"])
@pytest.mark.parametrize("product", ["scores", "pv"])
def test_split_tf32_products_hold_the_f32_card_tolerance(operands, product, split):
    a, b = operands[product]
    want = a.double() @ b.double()
    got = tf32_matmul(a, b, split)
    assert _within_card_tolerance(got, want) == split
    if split:
        # and by a wide margin: within 1e-6 of each item's largest element
        for i in range(B):
            top = want[i].abs().max().item()
            assert (got[i].double() - want[i]).abs().max().item() <= 1e-6 * top


@pytest.fixture(scope="module")
def lvc_frame():
    """One stage-2 frame (hop 64) of the LVC product as the f32 route of
    csrc/lvc_stack.cu forms it: the (hop, 3C) rows of the leaky LVC input at
    offsets -1, 0, +1 (column tap * C + cin) and the frame's kernel, drawn
    as the card tests draw it (x0.2), in that order, (3C, 2C)."""
    rng = np.random.default_rng(64)
    hop, C = 64, 32
    y = rng.standard_normal((hop + 2, C)).astype(np.float32)
    y = np.maximum(y, np.float32(0.2) * y)
    k = (0.2 * rng.standard_normal((C, 2 * C, 3))).astype(np.float32)
    a = np.concatenate([y[t:t + hop] for t in range(3)], axis=1)
    b = k.transpose(2, 0, 1).reshape(3 * C, 2 * C)
    return torch.from_numpy(a), torch.from_numpy(np.ascontiguousarray(b))


@pytest.mark.parametrize("split", [True, False], ids=["split", "one_pass"])
def test_split_tf32_lvc_frame_product_holds_the_f32_card_tolerance(lvc_frame, split):
    # the f32 lvc_stack card tolerance, 2e-4 (1 + max |ref|): split products
    # (three TF32 products a product) meet it by three orders of magnitude,
    # one TF32 product does not
    a, b = lvc_frame
    want = a.double() @ b.double()
    top = want.abs().max().item()
    err = (tf32_matmul(a, b, split).double() - want).abs().max().item()
    assert (err <= 2e-4 * (1 + top)) == split, (err, top)
    if split:
        assert err <= 1e-6 * (1 + top)


@pytest.fixture(scope="module")
def resblock_rows():
    """A few dozen rows of HiFi-GAN V1 stage 0's first dilated conv (k = 11,
    dilation 1, C = 256) as the f32 route of csrc/resblock.cu forms it, an
    implicit GEMM: the leaky input rows at tap offsets j - 5 side by side
    (column j C + c_in) and the conv's taps as (k C_in, C_out), drawn as the
    card tests draw them (weights x2 / sqrt(C k), biases apart)."""
    rng = np.random.default_rng(11)
    rows, k, C = 48, 11, 256
    x = rng.standard_normal((rows + k - 1, C)).astype(np.float32)
    x = np.maximum(x, np.float32(0.1) * x)
    w = (2.0 * rng.standard_normal((k, C, C)) / np.sqrt(C * k)).astype(np.float32)
    a = np.concatenate([x[j:j + rows] for j in range(k)], axis=1)
    return torch.from_numpy(a), torch.from_numpy(w.reshape(k * C, C))


@pytest.mark.parametrize("split", [True, False], ids=["split", "one_pass"])
def test_split_tf32_resblock_conv_product_holds_the_f32_card_tolerance(resblock_rows, split):
    # test_resblock_kernels_match_plain's f32 tolerance, 2e-5 max |ref|: the
    # split products (three TF32 products a product, k C = 2816 terms, the
    # sums in f32) meet it by an order of magnitude, one TF32 product a
    # product does not
    a, b = resblock_rows
    want = a.double() @ b.double()
    top = want.abs().max().item()
    err = (tf32_matmul(a, b, split).double() - want).abs().max().item()
    assert (err <= 2e-5 * top) == split, (err, top)
    if split:
        assert err <= 2e-6 * top


@pytest.fixture(scope="module")
def ffn_operands():
    """One 64-row block of the flagship FFN half's two products: h0 (64, C)
    and W1 (C, F) drawn at unit and 1 / sqrt(C) scale, and the down
    product's up = relu(h0 W1) with W2f (F, C) at 1 / sqrt(F)."""
    rng = np.random.default_rng(256)
    rows, C, F = 64, 256, 1024
    h0 = torch.from_numpy(rng.standard_normal((rows, C)).astype(np.float32))
    w1 = torch.from_numpy((rng.standard_normal((C, F)) / np.sqrt(C)).astype(np.float32))
    w2f = torch.from_numpy((rng.standard_normal((F, C)) / np.sqrt(F)).astype(np.float32))
    up = torch.relu(h0.double() @ w1.double()).float()
    return {"up": (h0, w1), "down": (up, w2f)}


@pytest.mark.parametrize("split", [True, False], ids=["split", "one_pass"])
@pytest.mark.parametrize("product", ["up", "down"])
def test_split_tf32_ffn_products_hold_the_f32_card_tolerance(ffn_operands, product, split):
    # test_ffn_ln_train_kernels_match_plain's f32 tolerance: 2e-4 of the
    # largest element, the mean within 2e-5 of it. The down product sums F
    # = 1024 terms as the kernel does, 64 at a time, the runs added in f32.
    # Split products meet it by two orders of magnitude, one TF32 product a
    # product does not.
    a, b = ffn_operands[product]
    want = a.double() @ b.double()
    if product == "down":
        got = sum(tf32_matmul(a[:, i:i + 64], b[i:i + 64], split) for i in range(0, b.shape[0], 64))
    else:
        got = tf32_matmul(a, b, split)
    top = want.abs().max().item()
    err = (got.double() - want).abs()
    held = err.max().item() <= 2e-4 * top and err.mean().item() <= 2e-5 * top
    assert held == split, (err.max().item(), err.mean().item(), top)
    if split:
        assert err.max().item() <= 2e-6 * top
