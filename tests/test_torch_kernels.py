"""The port's CUDA kernels against their plain PyTorch versions on a Hopper
card: ``probe``, ``ffn_ln``, ``resblock``, ``resblock_trio``, the
training kernels ``ffn_ln_train`` (bf16 gradients against the staged plain
backward ``ffn_ln_train_bwd_plain``; every launch's grid and shared memory
against ``ffn_plan``) and ``flash_attention`` (forward and
backward, gradients against the plain version's autograd, on both routes:
bf16 through the wgmma kernels, f32 through the split-TF32 mma.sync ones,
which are also held to the function in f64), ``soft_dtw``
(value and dD), the length regulator's expand and segment-sum, and the
FastDiff LVC chain ``lvc_stack`` (with the launches of one ε pass). Marked
``gpu``; the ``cuda_card`` fixture skips them without a card. This file
imports neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m gpu
"""

import contextlib
import faulthandler
import math

import pytest
import torch

from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2, make_dummy_batch
from lightningfastspeech2_tpu_torch.ops import attention as tatt
from lightningfastspeech2_tpu_torch.ops import fastdiff_lvc as tlvc
from lightningfastspeech2_tpu_torch.ops import ffn as tffn
from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as trb
from lightningfastspeech2_tpu_torch.ops import length_regulator as tlr
from lightningfastspeech2_tpu_torch.ops import soft_dtw as tsd
from lightningfastspeech2_tpu_torch.ops.depthwise import depthwise_conv1d
from lightningfastspeech2_tpu_torch.ops.layer_norm import layer_norm_fn
from lightningfastspeech2_tpu_torch.ops.probe import probe
from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step
from lightningfastspeech2_tpu_torch.vocoder import fastdiff as tfd
from torch_port_helpers import (  # noqa: F401
    cuda_card,
    ffn_modules,
    ffn_params,
    resblock_block,
    resblock_params,
    tf32_round,
    tiny_config,
)


@pytest.mark.gpu
def test_probe_kernel(cuda_card):
    x = torch.randn(8, 128, device=cuda_card)
    before = probe.launches
    y = probe(x)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(y, x * 2.0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_,F_,k,T", [(256, 1024, 25, 300), (64, 128, 4, 5)])
def test_ffn_ln_kernel_matches_plain(cuda_card, C_, F_, k, T, dtype):
    p = ffn_params(1, C_, F_, k)
    w = tffn.prepare_ffn_weights(
        **{n: type(v)(**{a: t.to(cuda_card) for a, t in vars(v).items()})
           for n, v in ffn_modules(p).items()}, dtype=dtype)
    z = torch.randn(3, T, C_, device=cuda_card).to(dtype)
    before = tffn.ffn_ln.launches
    out = tffn.ffn_ln(z, w)
    torch.cuda.synchronize()
    assert tffn.ffn_ln.launches == before + 1
    ref = tffn.ffn_ln_plain(z, w)
    # f32: summation order only; bf16: one-ulp flips at the rounding points
    tol = 2e-4 if dtype == torch.float32 else 0.07
    assert (out.float() - ref.float()).abs().max().item() <= tol


# (C, L, kernel sizes, B): the small shapes, HiFi-GAN V1's own at a
# 512-frame mel (stage 0's three resblocks, stage 1's trio), and the edges a
# tiling can break: L shorter than the halo (1, 37), L one past a tile
# boundary ("tile+1", resolved against the plan), and B = 2
RESBLOCK_CASES = [
    (256, 300, (11,), 2), (128, 257, (3, 7, 11), 2), (32, 40, (3, 7, 11), 2),
    (256, 4096, (3,), 1), (256, 4096, (7,), 1), (256, 4096, (11,), 1),
    (128, 32768, (3, 7, 11), 1),
    (256, 1, (11,), 1), (64, 1, (3, 7, 11), 2), (256, 37, (7,), 2), (32, 37, (3, 7, 11), 1),
    (256, "tile+1", (11,), 1), (128, "tile+1", (3, 7, 11), 2), (64, "tile+1", (3, 7, 11), 1),
]


def _one_past_a_tile(w, B):
    """The least L > 4000 whose planned tile leaves one row in the last block."""
    for L in range(4001, 1 << 17):
        if L % trb.tile_plan(w, B, L).tile == 1:
            return L
    raise AssertionError("no L one past a tile boundary")


def _resblock_weights(C_, ks, dtype, dev):
    blocks = [resblock_block(resblock_params(k, C_, k, scale=2.0), k) for k in ks]
    return trb.prepare_resblock_weights(
        [(k, d, [tuple(t.to(dev) for t in c) for c in convs]) for k, d, convs in blocks], dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_,L,ks,B", RESBLOCK_CASES)
def test_resblock_kernels_match_plain(cuda_card, C_, L, ks, B, dtype):
    w = _resblock_weights(C_, ks, dtype, cuda_card)
    if L == "tile+1":
        L = _one_past_a_tile(w, B)
    x = torch.randn(B, L, C_, device=cuda_card).to(dtype)
    kernel, plain = ((trb.resblock, trb.resblock_plain) if len(ks) == 1 else
                     (trb.resblock_trio, trb.resblock_trio_plain))
    before = kernel.launches
    out = kernel(x, w)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    ref = plain(x, w).float()
    # the six chained convs reach |x| ~ 15 here, so both tolerances scale
    # with the largest output: f32 differs by summation order only (2e-5
    # relative); in bf16 a one-ulp flip at a rounding point compounds
    # through the residual chain (four bf16 ulps at the largest |x|)
    top = ref.abs().max().item()
    tol = 2e-5 * top if dtype == torch.float32 else 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("C_,ks", [(256, (11,)), (256, (3,)), (128, (3, 7, 11)),
                                   (32, (3, 7, 11))])
def test_resblock_plan_smem_matches_the_library(cuda_card, C_, ks):
    """The tile plan's tile, blocks and shared memory are the ones each
    launch takes, on either route (csrc/resblock.cu lfs2_resblock_last_launch)."""
    for dtype in (torch.bfloat16, torch.float32):
        w = _resblock_weights(C_, ks, dtype, cuda_card)
        kernel = trb.resblock if len(ks) == 1 else trb.resblock_trio
        for L in (1, 37, 4096, 32768):
            kernel(torch.zeros(1, L, C_, device=cuda_card, dtype=dtype), w)
            plan = trb.tile_plan(w, 1, L)
            assert trb.last_launch() == {"blocks": plan.blocks, "tile": plan.tile,
                                         "smem_bytes": plan.smem_bytes}


@pytest.mark.gpu
def test_ffn_ln_raises_when_grad_is_needed(cuda_card):
    # the serving kernel is invisible to autograd: on the card it must not
    # silently give the FFN and LayerNorm parameters no gradient
    p = ffn_params(2, 64, 128, 4)
    w = tffn.prepare_ffn_weights(
        **{n: type(v)(**{a: t.to(cuda_card) for a, t in vars(v).items()})
           for n, v in ffn_modules(p).items()}, dtype=torch.float32)
    z = torch.randn(2, 40, 64, device=cuda_card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tffn.ffn_ln(z, w)
    with torch.no_grad():
        assert tffn.ffn_ln(z, w).shape == z.shape


def _bulk_close(got, want, frac, mean_frac, what, top=None):
    top = want.abs().max().item() if top is None else top
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= frac * top + 1e-6, (what, err.max().item(), top)
    assert err.mean().item() <= mean_frac * top + 1e-7, (what, err.mean().item(), top)


# An f32 sum of C <= 256 products lies within C * 2^-24 <= 2^-16 of their
# magnitudes' sum from the exact value, whatever the order. The kernel and
# the plain version sum the ReLU input in different orders, from depthwise
# outputs a few ulps apart, so both stay within twice that of the exact
# value and take the same ReLU branch wherever it lies farther than this:
KINK_MARGIN = 2.0 ** -14
_FFN_GRADS = ("out", "dz", "dwd", "dbd", "dw1", "db1", "dw2f", "db2f", "dg1", "dbe1",
              "dg2", "dbe2")


def _relu_input(z, p, eps=1e-5):
    """``ffn_ln_train_plain``'s ReLU input h0 @ w1 + b1 (B, T, F) as it forms
    it, and, in f64, the exact h0 @ w1 and the sum of the products'
    magnitudes."""
    wd, bd, w1, b1, _, _, g1, be1, _, _ = (t.detach() for t in p)
    dt = z.dtype
    with torch.no_grad():
        t1 = tffn._rnd(layer_norm_fn(z, g1, be1, torch.float32, eps), dt)
        h0 = tffn._rnd(depthwise_conv1d(t1, wd.t().unsqueeze(1).float(), bd.float()), dt)
        w1r = tffn._rnd(w1.float(), dt)
        return (h0 @ w1r + b1.float(), h0.double() @ w1r.double(),
                h0.abs().double() @ w1r.abs().double())


def _near_kink(exact, mag, b1):
    b = b1.double()
    return (exact + b).abs() <= KINK_MARGIN * (mag + b.abs())


def _b1_off_the_kink(z, p):
    """b1 with every F column that holds a ReLU input within ``KINK_MARGIN``
    of zero moved by the least multiple of 0.01 that clears the column, so
    that f32 arithmetic fixes every unit's branch."""
    _, exact, mag = _relu_input(z, p)
    F = exact.shape[-1]
    exact, mag = exact.reshape(-1, F), mag.reshape(-1, F)
    b1 = p[3].detach().clone()
    for step in range(1, 100):
        bad = _near_kink(exact, mag, b1).any(0)
        if not bad.any():
            return b1
        b1 = torch.where(bad, p[3].detach() + 0.01 * step, b1)
    raise AssertionError("no b1 clears the kink")


def _ffn_train_grads(fn, z, params, seed, rate, dout):
    zz = z.clone().requires_grad_(True)
    out = fn(zz, params, seed, rate)
    return (out, *torch.autograd.grad(out, [zz, *params], dout))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C_,F_,k", [(3, 300, 256, 1024, 25), (2, 40, 64, 128, 4)])
def test_ffn_ln_train_kernels_match_plain(cuda_card, B, T, C_, F_, k, dtype, rate):
    params = [t.detach().to(cuda_card).clone().requires_grad_(True)
              for t in tffn.ffn_train_params(**ffn_modules(ffn_params(3, C_, F_, k)))]
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_card)
    z = torch.randn(B, T, C_, device=cuda_card).to(dtype)
    dout = torch.randn(B, T, C_, device=cuda_card).to(dtype)
    # a ReLU input within rounding of zero may fall on one side in the kernel
    # and on the other in the plain version, which moves dz on the k rows it
    # reaches past any tolerance (test_ffn_ln_train_gap_lies_at_the_relu_kink):
    # such draws move b1 off the kink first
    params[3] = _b1_off_the_kink(z, params).requires_grad_(True)

    n_fwd, n_bwd = tffn.ffn_ln_train.launches, tffn.ffn_ln_train_bwd.launches
    out, *grads = _ffn_train_grads(tffn.ffn_ln_train, z, params, seed, rate, dout)
    torch.cuda.synchronize()
    assert (tffn.ffn_ln_train.launches, tffn.ffn_ln_train_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    ref, *ref_grads = _ffn_train_grads(tffn.ffn_ln_train_plain, z, params, seed, rate, dout)
    assert all(g.dtype == torch.float32 for g in grads[1:])
    if dtype == torch.bfloat16:
        # the oracle of the gradients: the kernels' stages in plain PyTorch,
        # with their rounding points (dff and dup rounded before their
        # products)
        ref_grads = tffn.ffn_ln_train_bwd_plain(dout, z, params, seed, rate)
    for name, got, want in zip(_FFN_GRADS, (out, *grads), (ref, *ref_grads)):
        if dtype == torch.float32:
            # f32: summation order and atomics' order only
            _bulk_close(got, want, 2e-4, 2e-5, name)
        elif name == "out":
            # one-ulp flips at the rounding points of the forward
            _bulk_close(got, want, 0.03, 0.005, name)
        else:
            # the same rounding points, met by values that differ in f32
            # summation order: a rounded value (h0, up, dff, dup) may land
            # one bf16 ulp (2^-8) away, and a gradient's path crosses up to
            # four of them: 4 ulps (2^-6) of its largest element, the bulk
            # within 2^-9
            _bulk_close(got, want, 2.0 ** -6, 2.0 ** -9, name)


@pytest.mark.gpu
def test_ffn_ln_train_gap_lies_at_the_relu_kink(cuda_card):
    # Sixteen seeded f32 draws with b1 as drawn. While dz leaves the
    # tolerance on some row, flip the plain version's branch at one ReLU
    # input that reaches that row (its depthwise window) by moving b1 of its
    # column by twice that input, trying the inputs nearest zero first. Each
    # flipped input must lie within KINK_MARGIN of zero, every row that left
    # the tolerance within the k rows a flipped input reaches, and then every
    # gradient must meet the f32 tolerance of the test above.
    B, T, C_, F_, k = 3, 300, 256, 1024, 25
    lpad, rpad = (k - 1) // 2, k - 1 - (k - 1) // 2
    base = [t.detach().to(cuda_card) for t in
            tffn.ffn_train_params(**ffn_modules(ffn_params(3, C_, F_, k)))]
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_card)
    for draw in range(16):
        g = torch.Generator(device=cuda_card).manual_seed(draw)
        z = torch.randn(B, T, C_, device=cuda_card, generator=g)
        dout = torch.randn(B, T, C_, device=cuda_card, generator=g)
        params = [t.clone().requires_grad_(True) for t in base]
        got = _ffn_train_grads(tffn.ffn_ln_train, z, params, seed, 0.0, dout)

        def plain(b1):
            ps = params[:3] + [b1.clone().requires_grad_(True)] + params[4:]
            want = _ffn_train_grads(tffn.ffn_ln_train_plain, z, ps, seed, 0.0, dout)
            tol = 2e-4 * want[1].abs().max().item() + 1e-6
            return ps, want, (got[1] - want[1]).abs().amax(-1), tol

        b1 = params[3].detach().clone()
        ps, want, row_gap, tol = plain(b1)
        first_gap, bad_rows = row_gap.max().item(), (row_gap > tol).nonzero().tolist()
        fails = [n for n, a, w in zip(_FFN_GRADS, got, want)
                 if (a - w).abs().max().item() > 2e-4 * w.abs().max().item() + 1e-6]
        _, exact, mag = _relu_input(z, params)
        flipped = []
        while row_gap.max().item() > tol:
            assert len(flipped) < 4, (draw, flipped, row_gap.max().item())
            b, t = divmod(int(row_gap.argmax()), T)
            lo = max(t - rpad, 0)
            pre = _relu_input(z, ps)[0][b, lo:t + lpad + 1]
            for i in pre.abs().flatten().argsort()[:4].tolist():
                gr, f = lo + i // F_, i % F_
                trial = b1.clone()
                trial[f] -= 2 * pre[i // F_, f] + pre[i // F_, f].sign() * 2.0 ** -20
                ps_t, want_t, gap_t, tol_t = plain(trial)
                if gap_t[b, t] <= tol_t:
                    break
            else:
                raise AssertionError(f"draw {draw}: no ReLU input flip clears row {(b, t)}")
            flipped.append((b, gr, f, pre[i // F_, f].item()))
            b1, ps, want, row_gap, tol = trial, ps_t, want_t, gap_t, tol_t
        print(f"draw {draw}: dz gap {first_gap:.3g} of largest dz "
              f"{want[1].abs().max().item():.3g} (tolerance {tol:.3g}); over it: {fails}, "
              f"{len(bad_rows)} rows; ReLU inputs flipped (b, t, f, value): {flipped}; "
              f"dz gap after: {row_gap.max().item():.3g}")
        for b, gr, f, _ in flipped:
            assert _near_kink(exact[b, gr, f], mag[b, gr, f], params[3].detach()[f])
        assert all(any(b == fb and fg - lpad <= t <= fg + rpad for fb, fg, _, _ in flipped)
                   for b, t in bad_rows)
        for name, a, w in zip(_FFN_GRADS, got, want):
            _bulk_close(a, w, 2e-4, 2e-5, name)


@pytest.mark.gpu
def test_ffn_ln_train_backward_dz_is_deterministic(cuda_card):
    # dz takes no atomics: two runs on the same inputs agree bit for bit
    params = [t.detach().to(cuda_card).clone().requires_grad_(True)
              for t in tffn.ffn_train_params(**ffn_modules(ffn_params(3, 256, 1024, 25)))]
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_card)
    g = torch.Generator(device=cuda_card).manual_seed(2)
    z, dout = (torch.randn(3, 300, 256, device=cuda_card, generator=g) for _ in range(2))
    dz = [tffn.ffn_ln_train_bwd(dout, z, params, seed, 0.0)[0] for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(d, dz[0]) for d in dz)


@pytest.mark.gpu
def test_ffn_ln_train_backward_dz_is_deterministic_bf16(cuda_card):
    # the bf16 route: dacc sums over F in one block's fixed order and the
    # depthwise/LN1 backward takes no atomics, so dz agrees bit for bit
    params = [t.detach().to(cuda_card).clone()
              for t in tffn.ffn_train_params(**ffn_modules(ffn_params(3, 256, 1024, 25)))]
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_card)
    g = torch.Generator(device=cuda_card).manual_seed(2)
    z, dout = (torch.randn(3, 300, 256, device=cuda_card, generator=g).to(torch.bfloat16)
               for _ in range(2))
    dz = [tffn.ffn_ln_train_bwd(dout, z, params, seed, 0.1)[0] for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(d, dz[0]) for d in dz)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ffn_launch_record_matches_the_plan(cuda_card, dtype):
    # every launch of a serving call, a training forward and a backward, as
    # the libraries recorded it, against ops/ffn.py ffn_plan
    B, T, C_, F_, k = 3, 300, 256, 1024, 25
    p = ffn_params(3, C_, F_, k)
    params = [t.detach().to(cuda_card).clone()
              for t in tffn.ffn_train_params(**ffn_modules(p))]
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_card)
    z = torch.randn(B, T, C_, device=cuda_card).to(dtype)

    def plan(mode):
        return [tffn.planned_launch(x) for x in tffn.ffn_plan(C_, F_, k, B, T, dtype, mode)]

    w = tffn.prepare_ffn_weights(
        **{n: type(v)(**{a: t.to(cuda_card) for a, t in vars(v).items()})
           for n, v in ffn_modules(p).items()}, dtype=dtype)
    with torch.no_grad():
        tffn.ffn_ln(z, w)
    torch.cuda.synchronize()
    assert [tffn.last_launches()["ffn_ln"]] == plan("serve")
    tffn.ffn_ln_train_fwd(z, params, seed, 0.1)
    torch.cuda.synchronize()
    assert [tffn.last_launches()["ffn_ln"]] == plan("train")
    tffn.ffn_ln_train_bwd(torch.randn_like(z), z, params, seed, 0.1)
    torch.cuda.synchronize()
    rec = tffn.last_launches()
    want = plan("bwd")
    if dtype == torch.bfloat16:  # the chain (ffn_ln.cu), then the dup and dt1 passes
        assert [rec["ffn_ln"], *rec["ffn_ln_train_bwd"]] == want
    else:
        assert rec["ffn_ln_train_bwd"] == want


@contextlib.contextmanager
def _deadline(seconds):
    """Ends the process with a traceback when the block outlasts
    ``seconds``: a hung kernel fails its test instead of the run."""
    faulthandler.dump_traceback_later(seconds, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()


# (B, H, T, valid keys per item): T from the flash gate's 1024 to the
# longest frame bucket 2816, B * H from 1 to 16; the 2048 case pads whole
# 128-key tiles, and has an item with one valid key and one with none
_FLASH_CASES = {"T1024": (2, 2, 1024, (1024, 700)),
                "T2048": (8, 2, 2048, (2048, 1900, 1000, 300, 129, 128, 1, 0)),
                "T2816": (1, 1, 2816, (2000,))}


def _flash_inputs(device, dtype, B, H, T, lengths):
    g = torch.Generator(device=device).manual_seed(T + B)
    q, k, v, do = (torch.randn(B, H, T, 128, device=device, generator=g).to(dtype)
                   for _ in range(4))
    mask = torch.arange(T, device=device)[None, :] < torch.tensor(lengths, device=device)[:, None]
    return q, k, v, do, mask, torch.tensor([777], dtype=torch.int32, device=device)


def _flash_run(fn, q, k, v, do, mask, rate, seed):
    qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = fn(*qkv, mask, rate, seed)
    return (out, *torch.autograd.grad(out, qkv, do))


def _each_item_close(got, want, frac, mean_frac, what):
    """``_bulk_close`` for each batch item, scaled by the item's own largest
    element, so one item's large values (a one-key item's o and dV) set no
    other's tolerance. Where the reference is 0 throughout the item (dq and
    dk of a one-key or no-key item: the function's gradient is 0 there, and
    the kernel's is what is left of a cancellation), the whole batch's
    largest element sets the scale."""
    top = want.abs().max().item()
    for b in range(want.shape[0]):
        item_top = want[b].abs().max().item()
        _bulk_close(got[b], want[b], frac, mean_frac, (what, b), item_top if item_top else top)


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_FLASH_CASES))
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(cuda_card, dtype, rate, case):
    q, k, v, do, mask, seed = _flash_inputs(cuda_card, dtype, *_FLASH_CASES[case])
    n_fwd, n_bwd = tatt.flash_attention.launches, tatt.flash_attention_bwd.launches
    with _deadline(300):
        got = _flash_run(tatt.flash_attention, q, k, v, do, mask, rate, seed)
        torch.cuda.synchronize()
    assert (tatt.flash_attention.launches, tatt.flash_attention_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    want = _flash_run(tatt.flash_attention_plain, q, k, v, do, mask, rate, seed)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        if dtype == torch.float32:
            # f32; online softmax and the split backward sum in other orders
            _each_item_close(a, b, 1e-4, 1e-5, name)
        else:
            # bf16 inputs and outputs; the kernel rounds p (against the
            # running max) and dS to bf16 before its products
            _each_item_close(a, b, 0.02, 0.004, name)


def _flash_f64(q, k, v, do, mask, rate, seed):
    """The function in f64 (scores, softmax, dropout, P.V and autograd's
    gradients) on the f32 inputs: the reference the f32 kernels are held
    to."""
    B, H, T, d = q.shape
    qkv = [t.double().requires_grad_(True) for t in (q, k, v)]
    s = torch.einsum("bhqd,bhkd->bhqk", qkv[0], qkv[1]) / math.sqrt(d)
    p = torch.softmax(torch.where(mask[:, None, None, :], s, tatt.NEG_INF), dim=-1)
    if rate > 0.0:
        keep = tatt.attention_keep_mask(B, H, T, rate, seed, q.device)
        p = torch.where(keep, p, 0.0) / (1.0 - rate)
    out = p @ qkv[2]
    return (out, *torch.autograd.grad(out, qkv, do.double()))


def _worst_item(got, want):
    """The largest (max error, mean error) over batch items, each over the
    item's largest |want| (the batch's where the item's is 0)."""
    top = want.abs().max().item()
    worst = (0.0, 0.0)
    for b in range(want.shape[0]):
        scale = want[b].abs().max().item() or top
        err = (got[b].double() - want[b].double()).abs()
        worst = (max(worst[0], err.max().item() / scale), max(worst[1], err.mean().item() / scale))
    return worst


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_f32_kernels_hold_an_f64_reference(cuda_card, rate):
    # Split-TF32 products keep f32's digits (a relative 2^-22 per operand):
    # o, dq, dk and dv within 2e-5 of each item's largest element (2e-6 on
    # the mean) of the function in f64. One TF32 product keeps 11 bits of
    # each operand (2^-11, 5e-4): its scores and P.V err by about 3e-4 of
    # the largest element (tests/test_torch_tf32_split.py), fifteen times
    # this tolerance, as the plain version on TF32-rounded operands shows.
    q, k, v, do, mask, seed = _flash_inputs(cuda_card, torch.float32, *_FLASH_CASES["T1024"])
    with _deadline(120):
        got = _flash_run(tatt.flash_attention, q, k, v, do, mask, rate, seed)
        torch.cuda.synchronize()
    want = _flash_f64(q, k, v, do, mask, rate, seed)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        _each_item_close(a, b, 2e-5, 2e-6, name)
    one_pass = _flash_run(tatt.flash_attention_plain, *(tf32_round(t) for t in (q, k, v, do)),
                          mask, rate, seed)
    worst = [_worst_item(a, b) for a, b in zip(one_pass, want)]
    assert any(m > 2e-5 or mu > 2e-6 for m, mu in worst), worst


@pytest.mark.gpu
def test_flash_attention_backward_is_deterministic(cuda_card):
    # neither backward pass takes atomics: two runs agree bit for bit
    q, k, v, do, mask, seed = _flash_inputs(cuda_card, torch.bfloat16, *_FLASH_CASES["T2048"])
    m32 = mask.to(torch.int32)
    with _deadline(120):
        _, lse, o32 = tatt.flash_attention_fwd(q, k, v, m32, seed, 0.1)
        runs = [tatt.flash_attention_bwd(do, q, k, v, m32, seed, o32, lse, 0.1) for _ in range(2)]
        torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(*runs))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "flash_attention_sm90"),
                                         (torch.float32, "flash_attention")])
def test_flash_attention_route_by_dtype(cuda_card, dtype, route):
    # bf16 goes through the wgmma kernels, f32 through the split-TF32 ones
    q, k, v, do, mask, seed = _flash_inputs(cuda_card, dtype, *_FLASH_CASES["T1024"])
    before = {fn: dict(fn.by_route) for fn in (tatt.flash_attention, tatt.flash_attention_bwd)}
    with _deadline(120):
        _flash_run(tatt.flash_attention, q, k, v, do, mask, 0.1, seed)
        torch.cuda.synchronize()
    for fn, counts in before.items():
        assert {r: fn.by_route[r] - n for r, n in counts.items()} == {
            r: int(r == route) for r in counts}


@pytest.mark.gpu
def test_train_step_then_serving_forward_on_the_card(cuda_card):
    # a small model whose FFN widths the training kernels take (C 64, F 128):
    # one optimizer step through them, then the serving forward must use the
    # updated weights (the optimizer's in-place update moves the version
    # counters the prepared ffn_ln layouts are keyed on)
    stack = dict(hidden=64, heads=2, layers=1, conv_filter_size=128)
    cfg = tiny_config(TC, encoder=TC.StackConfig(kernel_sizes=(3,), **stack),
                      decoder=TC.StackConfig(kernel_sizes=(5,), **stack))
    model = build_fastspeech2(cfg.model, device=cuda_card)
    batch = make_dummy_batch(cfg.model, batch_size=2, n_phones=8)
    tb = {k: torch.as_tensor(v, device=cuda_card) for k, v in batch.items()}
    with torch.no_grad():
        before = model(tb)["mel"]
    n = tffn.ffn_ln_train_bwd.launches
    state = create_train_state(model, cfg)
    _, metrics = make_train_step(model, cfg)(
        state, batch, torch.Generator(device=cuda_card).manual_seed(0))
    assert tffn.ffn_ln_train_bwd.launches == n + 2
    assert all(torch.isfinite(v) for v in metrics.values())
    model.eval()
    fresh = build_fastspeech2(cfg.model, device=cuda_card,
                              state_dict={k: v.clone() for k, v in model.state_dict().items()})
    with torch.no_grad():
        after, ref = model(tb)["mel"], fresh(tb)["mel"]
    torch.cuda.synchronize()
    assert torch.equal(after, ref)
    assert not torch.equal(after, before)


@pytest.mark.gpu
@pytest.mark.parametrize("gamma", [1.0, 0.1])
@pytest.mark.parametrize("L,N,M", [(4, 256, 256), (3, 31, 57), (2, 1100, 1100)])
def test_soft_dtw_kernels_match_plain(cuda_card, L, N, M, gamma):
    # (2, 1100, 1100): more rows than one block has threads
    g = torch.Generator(device=cuda_card).manual_seed(N)
    D = torch.rand(L, N, M, device=cuda_card, generator=g) * 2.0
    n_fwd, n_bwd = tsd.soft_dtw.launches, tsd.soft_dtw_bwd.launches
    Dk = D.clone().requires_grad_(True)
    val = tsd.soft_dtw_from_dist(Dk, gamma)
    (grad,) = torch.autograd.grad(val, Dk, torch.linspace(0.5, 1.5, L, device=cuda_card))
    torch.cuda.synchronize()
    assert (tsd.soft_dtw.launches, tsd.soft_dtw_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    Dp = D.clone().requires_grad_(True)
    ref = tsd.soft_dtw_from_dist_plain(Dp, gamma)
    (ref_grad,) = torch.autograd.grad(ref, Dp, torch.linspace(0.5, 1.5, L, device=cuda_card))
    # f32 on both sides, the same softmin form: R to 1e-5 relative; dD (the
    # alignment weights, within [0, 1.5]) to 1e-4 of the largest
    torch.testing.assert_close(val, ref, rtol=1e-5, atol=1e-5)
    _bulk_close(grad, ref_grad, 1e-4, 1e-6, "dD")


def _regulate_inputs(device, dtype):
    g = torch.Generator().manual_seed(11)
    B, P, H, T = 8, 256, 256, 2048
    x = torch.randn(B, P, H, generator=g).to(device, dtype)
    d = torch.randint(0, 15, (B, P), generator=g)
    d[1, 200:] = 0                       # ragged totals
    d[2, ::3] = 0                        # zero durations inside an item
    d[3] = 0                             # an empty item
    d[4] = 12                            # a total above T (3072 frames)
    return x, d.to(device), T


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_regulate_kernels_match_gather(cuda_card, dtype):
    x, d, T = _regulate_inputs(cuda_card, dtype)
    dout = torch.randn(x.shape[0], T, x.shape[2], device=cuda_card)
    n_fwd, n_bwd = tlr.regulate.launches, tlr.regulate_bwd.launches
    xk = x.clone().requires_grad_(True)
    frames, mask = tlr.regulate_kernel(xk, d, T)
    (grad,) = torch.autograd.grad(frames, xk, dout.to(dtype))
    torch.cuda.synchronize()
    assert (tlr.regulate.launches, tlr.regulate_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    ref, ref_mask = tlr.regulate_plain(x, d, T)
    assert torch.equal(frames, ref) and torch.equal(mask, ref_mask)   # a copy: bit for bit
    # the gradient against the f32 gather's of the same inputs; in bf16 that
    # f32 gradient rounded once, since the gather's own bf16 backward adds
    # in bf16: within one bf16 ulp of it (the kernel sums in f32)
    xf = x.float().requires_grad_(True)
    (ref_grad,) = torch.autograd.grad(tlr.regulate_plain(xf, d, T)[0], xf, dout.to(dtype).float())
    assert not grad[3].any()
    if dtype == torch.float32:
        # two f32 sums of the same <= 14 frames in other orders: 1e-6 plus
        # the bound on their rounding, 2 * 14 * 2^-24 * sum |g|
        (absum,) = torch.autograd.grad(tlr.regulate_plain(xf, d, T)[0], xf, dout.abs())
        assert ((grad - ref_grad).abs() <= 1e-6 + 28 * 2.0 ** -24 * absum).all()
    else:
        want = ref_grad.to(torch.bfloat16).float()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
        assert ((grad.float() - want).abs() <= ulp).all()


@pytest.mark.gpu
def test_regulate_takes_the_kernel_only_when_opted_in(cuda_card, monkeypatch):
    x, d, _ = _regulate_inputs(cuda_card, torch.bfloat16)
    n = tlr.regulate.launches
    monkeypatch.delenv("LFS2_PALLAS_LR", raising=False)
    tlr.regulate(x, d, 512)
    assert tlr.regulate.launches == n
    monkeypatch.setenv("LFS2_PALLAS_LR", "1")
    a, _ = tlr.regulate(x, d, 512)
    assert tlr.regulate.launches == n + 1
    tlr.regulate(x, d, 500)                  # max_frames % 256 != 0: the gather
    tlr.regulate(x[..., 0], d, 512)          # 2-D: the gather
    torch.cuda.synchronize()
    assert tlr.regulate.launches == n + 1
    assert torch.equal(a, tlr.regulate_plain(x, d, 512)[0])


def _lvc_inputs(device, B, nL, hop, dtype, seed, layers=4, C=32):
    """The JAX kernel tests' draws: x, audio_down, per-frame kernels (x0.2),
    biases (x0.1, f32), conv taps (x0.1) and conv biases (f32)."""
    g = torch.Generator().manual_seed(seed)
    L = nL * hop
    x, ad = torch.randn(B, L, C, generator=g), torch.randn(B, L, C, generator=g)
    k = torch.randn(B, nL, layers, C, 2 * C, 3, generator=g) * 0.2
    b = torch.randn(B, nL, layers, 2 * C, generator=g) * 0.1
    cw = torch.randn(layers, 3, C, C, generator=g) * 0.1
    cb = torch.randn(layers, C, generator=g) * 0.1
    return ([t.to(device, dtype) for t in (x, ad, k)] + [b.to(device)]
            + [cw.to(device, dtype), cb.to(device)])


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hop,nL", [(8, 25), (64, 7), (256, 5), (256, 80), (6, 9)])
def test_lvc_stack_kernel_matches_plain(cuda_card, hop, nL, dtype, fast):
    # (8, 25): stage 1, tail tile; (256, 80): 256-row tiles; (6, 9): a hop
    # that is not a multiple of 4 (one row a chunk), one partial tile
    args = _lvc_inputs(cuda_card, 2, nL, hop, dtype, seed=hop + nL)
    n = tlvc.lvc_stack.launches
    out = tlvc.lvc_stack(*args, hop, fast_gating=fast)
    torch.cuda.synchronize()
    assert tlvc.lvc_stack.launches == n + 1 and out.dtype == dtype
    ref = tlvc.lvc_stack_plain(*args, hop, fast_gating=fast).float()
    if dtype == torch.float32:   # summation order only
        err = (out - ref).abs().max().item()
        top = ref.abs().max().item()
        assert err <= 2e-4 * (1 + top), (err, top)
    else:
        # both round at the same places: a few one-ulp flips, carried down
        # the residual chain, held per value
        ulps, share = tlvc.bf16_chain_error(out, ref, args[0], args[1], args[2].shape[2])
        assert ulps <= tlvc.BF16_MAX_ULPS and share <= tlvc.BF16_MAX_UNEQUAL, (ulps, share)


@pytest.mark.gpu
@pytest.mark.parametrize("opt_in", [False, True])
def test_fastdiff_pass_launches_and_matches_cpu(cuda_card, monkeypatch, opt_in):
    # one f32 ε pass at the reference widths and 16 frames: stages 2 and 3
    # on the kernel, stage 1 too under the opt-in; the card's output against
    # the CPU's plain path
    if opt_in:
        monkeypatch.setenv("LFS2_FUSED_STAGE1", "1")
    else:
        monkeypatch.delenv("LFS2_FUSED_STAGE1", raising=False)
    cfg = tfd.FastDiffConfig()
    model = tfd.FastDiff(cfg)
    tfd.init_fastdiff_weights(model, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16 * cfg.hop_length, generator=g)
    c = torch.randn(2, 16, cfg.cond_channels, generator=g)
    ts = torch.tensor([3.25, 77.5])
    with torch.no_grad():
        ref = model(x, c, ts)
        model.to(cuda_card)
        n = tlvc.lvc_stack.launches
        out = model(x.to(cuda_card), c.to(cuda_card), ts.to(cuda_card))
        torch.cuda.synchronize()
    assert tlvc.lvc_stack.launches == n + (3 if opt_in else 2)
    top = ref.abs().max().item()
    assert torch.isfinite(out).all() and top > 0
    # f32 on both sides, TF32 off: summation order only, through the network
    assert (out.cpu() - ref).abs().max().item() <= 1e-3 * top
