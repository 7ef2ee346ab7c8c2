"""The port's CUDA kernels against their plain PyTorch versions on a Hopper
card: ``probe``, ``ffn_ln``, ``resblock``, ``resblock_trio`` (the f32
route also held to the chain in f64; past C = 256 the wide route), the
training kernels ``ffn_ln_train`` (bf16 gradients against the staged plain
backward ``ffn_ln_train_bwd_plain``; every launch's grid and shared memory
against ``ffn_plan``; at C = 384-768 the chain of ``csrc/ffn_wide.cu``,
which also serves every multiple of 128 from C = 768) and ``flash_attention`` (forward and
backward, gradients against the plain version's autograd, on both routes:
bf16 through the wgmma kernels, f32 through the split-TF32 mma.sync ones,
which are also held to the function in f64), ``soft_dtw``
(value and dD; each kernel alone against its plain twin; the launch record
against ``soft_dtw_plan``; dD repeatable bit for bit), the length regulator's two kernels (forward bit for bit at
every shape the bench times and at rows that are not 16-byte aligned, the running sums it
writes, the backward repeatable bit for bit and on strided gradients, one device
kernel a direction by the profiler's count), and the
FastDiff LVC chain ``lvc_stack`` (at inner widths 16-128 and the served
batch too; the f32 route
held to the chain in f64; every launch as recorded against ``lvc_plan``;
the launches of one ε pass). Marked
``gpu``; the ``cuda_card`` fixture skips them without a card. This file
imports neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m gpu
"""

import contextlib
import faulthandler
import math
from pathlib import Path

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


# (C, B, T) of the wide kernel's cases: lightspeech_true76m's width at a
# phone, an encoder launch, a request's and a batch's decoder bucket and a
# batch of 2 ending mid-tile; C = 384 and 512 at that batch. "max" is the
# largest depthwise kernel each dtype takes at C (ops/ffn.py _fits)
WIDE_FFN_CASES = ([(640, B, T) for B, T in ((1, 1), (1, 32), (1, 256), (2, 300), (8, 512))]
                  + [(384, 2, 300), (512, 2, 300)])


def _wide_kmax(C_, dtype):
    return max(k for k in range(1, 400)
               if tffn._fits(tffn.ffn_plan(C_, 4 * C_, k, 1, 1, dtype, "serve")[0], k))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [5, 25, "max"])
@pytest.mark.parametrize("C_,B,T", WIDE_FFN_CASES)
def test_ffn_ln_wide_matches_plain(cuda_card, C_, B, T, k, dtype):
    # ffn_wide_kernel and its LN2 pass, serving at C = 384 to 640 with F =
    # 4 C against ffn_ln_plain; two launches give the same bits (the splits
    # are added in order, no atomics); both launches as the library
    # recorded them (grid, cluster, shared memory) against ffn_plan
    k = _wide_kmax(C_, dtype) if k == "max" else k
    F_ = 4 * C_
    p = ffn_params(1, C_, F_, k)
    w = tffn.prepare_ffn_weights(
        **{n: type(v)(**{a: t.to(cuda_card) for a, t in vars(v).items()})
           for n, v in ffn_modules(p).items()}, dtype=dtype)
    z = torch.randn(B, T, C_, device=cuda_card).to(dtype)
    before = tffn.ffn_ln.launches
    out = tffn.ffn_ln(z, w)
    again = tffn.ffn_ln(z, w)
    torch.cuda.synchronize()
    assert tffn.ffn_ln.launches == before + 2
    plan = tffn.ffn_plan(C_, F_, k, B, T, dtype, "serve")
    assert [x.kernel for x in plan] == ["ffn_wide_kernel", "ffn_wide_ln2_kernel"]
    rec = tffn.last_launches()
    assert [rec["ffn_ln"], rec["ffn_ln_wide_ln2"]] == [tffn.planned_launch(x) for x in plan]
    assert rec["ffn_ln_max_active_clusters"] != 0
    assert torch.equal(out, again)
    ref = tffn.ffn_ln_plain(z, w)
    # f32: summation order only; bf16: one-ulp flips at the rounding points
    tol = 2e-4 if dtype == torch.float32 else 0.07
    err = (out.float() - ref.float()).abs().max().item()
    assert torch.isfinite(out).all() and err <= tol, err


# (C, L, kernel sizes, B): the small shapes, HiFi-GAN V1's own at a
# 512-frame mel (stage 0's three resblocks, stage 1's trio), and the edges a
# tiling can break: L shorter than the halo (1, 37), L one past a tile
# boundary ("tile+1", resolved against the plan), and B = 2; then HiFi-GAN
# V2's narrow stages (C = 16, 8) at a 512-frame mel, the same edges, and
# single resblocks of odd k at C = 8 (a half k-step at the end of each
# conv's K)
RESBLOCK_CASES = [
    (256, 300, (11,), 2), (128, 257, (3, 7, 11), 2), (32, 40, (3, 7, 11), 2),
    (256, 4096, (3,), 1), (256, 4096, (7,), 1), (256, 4096, (11,), 1),
    (128, 32768, (3, 7, 11), 1),
    (256, 1, (11,), 1), (64, 1, (3, 7, 11), 2), (256, 37, (7,), 2), (32, 37, (3, 7, 11), 1),
    (256, "tile+1", (11,), 1), (128, "tile+1", (3, 7, 11), 2), (64, "tile+1", (3, 7, 11), 1),
    (16, 65536, (3, 7, 11), 1), (8, 131072, (3, 7, 11), 1), (16, 300, (3, 7, 11), 2),
    (8, 37, (3, 7, 11), 2), (8, 1, (3, 7, 11), 1), (16, "tile+1", (3, 7, 11), 1),
    (8, "tile+1", (3, 7, 11), 2), (8, 5000, (3,), 1), (8, 5000, (11,), 2), (16, 5000, (7,), 1),
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
                                   (32, (3, 7, 11)), (16, (3, 7, 11)), (8, (3, 7, 11)),
                                   (8, (11,))])
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


def _resblock_chain(x, w, operand=lambda t: t):
    """The resblock chain of ``w`` on x (B, L, C) in the dtype of x, every
    conv operand (input and taps) passed through ``operand`` first: in f64
    the function itself; in f32 with ``tf32_round`` the chain as one TF32
    product a product would give it."""
    import torch.nn.functional as F

    dt = x.dtype
    out = None
    for pairs in w.pairs:
        y = x
        for w1, b1, d, w2, b2 in pairs:
            t = y
            for wc, bc, dc, first in ((w1, b1, d, True), (w2, b2, 1, False)):
                t = torch.maximum(t, t * trb.LRELU_SLOPE)  # leaky before each conv
                t = F.conv1d(operand(t.transpose(1, 2).contiguous()), operand(wc.to(dt)),
                             bc.to(dt), padding=dc * (wc.shape[-1] - 1) // 2,
                             dilation=dc).transpose(1, 2)
            y = y + t
        out = y if out is None else out + y
    return out / float(w.n_res)


@pytest.mark.gpu
@pytest.mark.parametrize("C_,L,ks,B", [(256, 4096, (11,), 1), (32, 8192, (3, 7, 11), 2)])
def test_resblock_f32_kernels_hold_an_f64_reference(cuda_card, C_, L, ks, B):
    # Split-TF32 products keep f32's digits: the f32 route (stage 0's k=11
    # launch at C=256 and a C=32 trio) lies within 1e-5 of max |ref| of the
    # chain computed in f64 (its own f32 roundings and sums are about 1e-6
    # of it); one TF32 product a product keeps 11 bits of each operand, and
    # that chain misses the same tolerance (tests/test_torch_tf32_split.py
    # shows one conv's product alone)
    w = _resblock_weights(C_, ks, torch.float32, cuda_card)
    x = torch.randn(B, L, C_, device=cuda_card)
    kernel = trb.resblock if len(ks) == 1 else trb.resblock_trio
    got = kernel(x, w)
    torch.cuda.synchronize()
    assert trb.tile_plan(w, B, L).route in ("mma_tf32", "mma_tf32_xl2", "mma_tf32_c4")
    want = _resblock_chain(x.double(), w)
    top = want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * top, (err, top)
    one_pass = _resblock_chain(x, w, operand=tf32_round)
    assert (one_pass.double() - want).abs().max().item() > 1e-5 * top


@pytest.mark.gpu
@pytest.mark.parametrize("C_,ks", [(32, (3, 7, 11)), (256, (11,)), (8, (3, 7, 11))])
def test_resblock_raises_when_grad_is_needed(cuda_card, C_, ks):
    # the kernels have no backward: on the card they must not silently give
    # the resblock parameters (and everything before them) no gradient
    w = _resblock_weights(C_, ks, torch.float32, cuda_card)
    kernel = trb.resblock if len(ks) == 1 else trb.resblock_trio
    x = torch.randn(1, 64, C_, device=cuda_card, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel(x, w)
    with torch.no_grad():
        assert kernel(x, w).shape == x.shape
    assert kernel(x.detach(), w).shape == x.shape
    # x needs no gradient (conv_pre and ups frozen), but a parameter the
    # taps were copied from does
    w.sources[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernel(x.detach(), w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_,L,k,B", [(512, 4096, 11, 1), (512, 1000, 3, 2), (384, 1000, 7, 2),
                                      (320, 300, 11, 1), (512, 1, 3, 1)])
def test_resblock_wide_channels_match_plain(cuda_card, C_, L, k, B, dtype):
    """Past C = 256 (ROADMAP B16w) the wide route, one launch a conv: a C
    that is not a multiple of 128 runs zero-padded to the next one (the
    padded channels exactly 0); each launch as the library recorded it
    against the plan; test_resblock_kernels_match_plain's tolerance."""
    w = _resblock_weights(C_, (k,), dtype, cuda_card)
    P = trb.kernel_channels(C_)
    assert (w.real_channels, w.channels) == (C_, P) and P % 128 == 0
    x = torch.nn.functional.pad(torch.randn(B, L, C_, device=cuda_card), (0, P - C_)).to(dtype)
    before = trb.resblock.launches
    out = trb.resblock(x, w)
    torch.cuda.synchronize()
    assert trb.resblock.launches == before + 1
    plan = trb.tile_plan(w, B, L)
    assert plan.route == "gemm"
    assert trb.last_launch() == {"blocks": plan.blocks, "tile": plan.tile,
                                 "smem_bytes": plan.smem_bytes}
    assert torch.count_nonzero(out[..., C_:]) == 0
    ref = trb.resblock_plain(x, w).float()
    top = ref.abs().max().item()
    tol = 2e-5 * top if dtype == torch.float32 else 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_,ks", [(24, (3,)), (24, (3, 7, 11)), (40, (3, 7, 11)),
                                   (96, (7,)), (96, (3, 7, 11)), (192, (11,)), (192, (3,))])
def test_resblock_padded_widths_match_plain(cuda_card, C_, ks, dtype):
    """A width the kernels are not built for runs zero-padded to the next
    one (ROADMAP B16): called at its own C, the wrapper pads x once and
    launches at the padded width; called at the padded width (as the
    served generator calls it) it copies nothing and the padded channels
    come back exactly 0. Held against the plain version on the padded
    weights, with test_resblock_kernels_match_plain's tolerance."""
    w = _resblock_weights(C_, ks, dtype, cuda_card)
    P = trb.kernel_channels(C_)
    assert (w.real_channels, w.channels) == (C_, P) and P in trb.KERNEL_CHANNELS
    kernel, plain = ((trb.resblock, trb.resblock_plain) if len(ks) == 1 else
                     (trb.resblock_trio, trb.resblock_trio_plain))
    x = torch.randn(2, 1000, C_, device=cuda_card).to(dtype)
    xp = torch.nn.functional.pad(x, (0, P - C_))
    before, copies = kernel.launches, kernel.pad_copies
    widths = dict(kernel.by_width)
    out = kernel(x, w)
    outp = kernel(xp, w)
    torch.cuda.synchronize()
    assert kernel.launches == before + 2 and kernel.pad_copies == copies + 1
    assert kernel.by_width[C_] == widths.get(C_, 0) + 2
    assert out.shape == x.shape and torch.equal(outp[..., :C_], out)
    assert torch.count_nonzero(outp[..., C_:]) == 0
    ref = plain(xp, w)[..., :C_].float()
    top = ref.abs().max().item()
    tol = 2e-5 * top if dtype == torch.float32 else 4 * 2.0 ** (math.floor(math.log2(top)) - 7)
    assert (out.float() - ref).abs().max().item() <= tol


@pytest.mark.gpu
def test_kernel_dump_writes_sass_and_ptx(cuda_card, tmp_path):
    """utils/debug.py kernel_dump_to, the port's counterpart of the JAX
    package's xla_dump_to: a library's SASS through cuobjdump, its PTX
    through nvcc."""
    from lightningfastspeech2_tpu_torch.utils.debug import kernel_dump_to

    out = kernel_dump_to(tmp_path, names=("probe",))
    sass = out["probe"]["sass"].read_text()
    assert "sm_90a" in sass and "Function : " in sass and "probe" in sass
    ptx = out["probe"]["ptx"].read_text()
    assert ".target sm_90a" in ptx and ".entry" in ptx


@pytest.mark.gpu
def test_generator_train_route_gives_every_parameter_a_gradient(cuda_card):
    # HiFi-GAN V1 in f32 on the card: the serving route raises under grad,
    # the training route reaches every parameter, and matches the serving
    # route (phase 4's f32 tolerance, relative to the output)
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import (
        Generator, HifiGanConfig, init_generator_weights)

    gen = Generator(HifiGanConfig())
    init_generator_weights(gen, torch.Generator().manual_seed(0))
    with torch.no_grad():  # every stage carries signal, tanh short of saturation
        for p in gen.parameters():
            p.mul_(4.0)
    gen.to(cuda_card)
    mel = torch.randn(2, 16, 80, generator=torch.Generator().manual_seed(3)).to(cuda_card)
    with pytest.raises(RuntimeError, match="no backward"):
        gen(mel)
    gen.conv_pre.requires_grad_(False)
    gen.ups.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        gen(mel)   # the resblocks alone train
    gen.requires_grad_(True)
    out = gen(mel, train_route=True)
    out.square().mean().backward()
    assert all(p.grad is not None and p.grad.abs().sum() > 0 for p in gen.parameters())
    with torch.no_grad():
        served = gen(mel)
    assert (served - out.detach()).abs().max().item() <= 1e-4 * out.abs().max().item() + 1e-7


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


def _near_kink(exact, mag, b1, margin=KINK_MARGIN):
    b = b1.double()
    return (exact + b).abs() <= margin * (mag + b.abs())


def _b1_off_the_kink(z, p, margin=KINK_MARGIN):
    """b1 with every F column that holds a ReLU input within ``margin``
    (``KINK_MARGIN`` unless given) of zero moved by the least multiple of
    0.01 that clears the column, so that f32 arithmetic fixes every unit's
    branch."""
    _, exact, mag = _relu_input(z, p)
    F = exact.shape[-1]
    exact, mag = exact.reshape(-1, F), mag.reshape(-1, F)
    b1 = p[3].detach().clone()
    for step in range(1, 100):
        bad = _near_kink(exact, mag, b1, margin).any(0)
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
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,C_,F_,k", [(2, 300, 384, 768, 17), (2, 150, 512, 1024, 25),
                                         (3, 64, 640, 1024, 5), (2, 200, 768, 896, 9),
                                         (1, 1, 768, 768, 5),
                                         # past 768: the row kernels that read a row again
                                         (2, 64, 896, 768, 9), (1, 48, 1024, 1024, 5)])
def test_ffn_ln_train_wide_kernels_match_plain(cuda_card, B, T, C_, F_, k, dtype, rate):
    """The chain of csrc/ffn_wide.cu (every C from 384, its LN rows past 768
    on the long-row kernels) against the plain version, with
    test_ffn_ln_train_kernels_match_plain's tolerances; b1 is moved off the
    ReLU kink at four times its margin (a sum of up to 1024 products), and
    every launch as the library recorded it against ffn_plan. F need not be
    a multiple of C here (the JAX fit estimate admits (640, 1024), (768,
    896) and (896, 768)), so the kernel's own parameters are drawn, not a
    block's."""
    g = torch.Generator().manual_seed(C_ + F_)

    def draw(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(*shape, generator=g)).to(cuda_card).requires_grad_(True)

    params = [draw(k, C_, scale=0.3), draw(C_, scale=0.1), draw(C_, F_, scale=C_ ** -0.5),
              draw(F_, scale=0.1), draw(F_, C_, scale=F_ ** -0.5), draw(C_, scale=0.1),
              draw(C_, scale=0.1, shift=1.0), draw(C_, scale=0.1), draw(C_, scale=0.1, shift=1.0),
              draw(C_, scale=0.1)]
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_card)
    z = torch.randn(B, T, C_, device=cuda_card).to(dtype)
    dout = torch.randn(B, T, C_, device=cuda_card).to(dtype)
    params[3] = _b1_off_the_kink(z, params, 4 * KINK_MARGIN).requires_grad_(True)
    widths = dict(tffn.ffn_ln_train.by_width)
    out, *grads = _ffn_train_grads(tffn.ffn_ln_train, z, params, seed, rate, dout)
    torch.cuda.synchronize()
    assert tffn.ffn_ln_train.by_width[C_] == widths.get(C_, 0) + 1
    assert tffn.last_launches()["ffn_wide"] == [
        tffn.planned_launch(x) for x in tffn.ffn_plan(C_, F_, k, B, T, dtype, "bwd")]
    ref, *ref_grads = _ffn_train_grads(tffn.ffn_ln_train_plain, z, params, seed, rate, dout)
    if dtype == torch.bfloat16:
        ref_grads = tffn.ffn_ln_train_bwd_plain(dout, z, params, seed, rate)
    for name, got, want in zip(_FFN_GRADS, (out, *grads), (ref, *ref_grads)):
        if dtype == torch.float32:
            _bulk_close(got, want, 2e-4, 2e-5, name)
        elif name == "out":
            _bulk_close(got, want, 0.03, 0.005, name)
        else:
            _bulk_close(got, want, 2.0 ** -6, 2.0 ** -9, name)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,F_,k", [(2, 300, 768, 17), (1, 32, 1536, 5), (8, 512, 3072, 25)])
def test_ffn_ln_serves_c768_through_the_chain(cuda_card, B, T, F_, k, dtype):
    """Serving at C = 768, past ffn_wide_kernel: the chain without dropout,
    against ffn_ln_plain (test_ffn_ln_kernel_matches_plain's tolerance), its
    launches against ffn_plan."""
    p = ffn_params(1, 768, F_, k)
    w = tffn.prepare_ffn_weights(
        **{n: type(v)(**{a: t.to(cuda_card) for a, t in vars(v).items()})
           for n, v in ffn_modules(p).items()}, dtype=dtype)
    z = torch.randn(B, T, 768, device=cuda_card).to(dtype)
    widths = dict(tffn.ffn_ln.by_width)
    with torch.no_grad():
        out = tffn.ffn_ln(z, w)
    torch.cuda.synchronize()
    assert tffn.ffn_ln.by_width[768] == widths.get(768, 0) + 1
    assert tffn.last_launches()["ffn_wide"] == [
        tffn.planned_launch(x) for x in tffn.ffn_plan(768, F_, k, B, T, dtype, "serve")]
    ref = tffn.ffn_ln_plain(z, w)
    tol = 2e-4 if dtype == torch.float32 else 0.07
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_,B,T,F_,k", [(896, 2, 300, 896, 17), (1024, 2, 512, 1024, 17),
                                         (1024, 1, 64, 4096, 5), (2048, 1, 256, 2048, 25)])
def test_ffn_ln_serves_past_c768_through_the_chain(cuda_card, C_, B, T, F_, k, dtype):
    """Serving past C = 768: the chain with its long-row LN kernels, against
    ffn_ln_plain (the C = 768 test's tolerance; f32 at no more than 2 x
    1024 rows), its launches against ffn_plan."""
    p = ffn_params(C_, C_, F_, k)
    w = tffn.prepare_ffn_weights(
        **{n: type(v)(**{a: t.to(cuda_card) for a, t in vars(v).items()})
           for n, v in ffn_modules(p).items()}, dtype=dtype)
    z = torch.randn(B, T, C_, device=cuda_card).to(dtype)
    widths = dict(tffn.ffn_ln.by_width)
    with torch.no_grad():
        out = tffn.ffn_ln(z, w)
    torch.cuda.synchronize()
    assert tffn.ffn_ln.by_width[C_] == widths.get(C_, 0) + 1
    plan = tffn.ffn_plan(C_, F_, k, B, T, dtype, "serve")
    assert plan[0].kernel == "wide_ln1_long_kernel"
    assert tffn.last_launches()["ffn_wide"] == [tffn.planned_launch(x) for x in plan]
    ref = tffn.ffn_ln_plain(z, w)
    tol = 2e-4 if dtype == torch.float32 else 0.07
    assert (out.float() - ref.float()).abs().max().item() <= tol


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
def test_ffn_ln_train_backward_dz_is_deterministic_at_the_decoder_shape(cuda_card):
    # the f32 route at the flagship decoder's (8, 2048, 256), k = 21 (64-row
    # blocks): dacc sums over F in one block's fixed order and dz takes no
    # atomics, so dz agrees bit for bit
    params = [t.detach().to(cuda_card).clone()
              for t in tffn.ffn_train_params(**ffn_modules(ffn_params(3, 256, 1024, 21)))]
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_card)
    g = torch.Generator(device=cuda_card).manual_seed(2)
    z, dout = (torch.randn(8, 2048, 256, device=cuda_card, generator=g) for _ in range(2))
    assert tffn.ffn_plan(256, 1024, 21, 8, 2048, torch.float32, "bwd")[1].rows == 64
    dz = [tffn.ffn_ln_train_bwd(dout, z, params, seed, 0.1)[0] for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(d, dz[0]) for d in dz)


def _ffn_train_f64(z, p, seed, rate, operand=lambda t: t, eps=1e-5):
    """The training FFN half as a function, in the dtype of z (f64: the
    function itself), every product operand passed through ``operand``
    first (in f32 with ``tf32_round``: one TF32 product a product), with
    ffn_ln_train_plain's keep masks; differentiable."""
    wd, bd, w1, b1, w2f, b2f, g1, be1, g2, be2 = (t.to(z.dtype) for t in p)
    B, T, C = z.shape
    F = w1.shape[1]
    ik = 1.0 / (1.0 - rate)
    seeds = tffn.batch_seeds(seed, B)
    gpos = torch.arange(T, device=z.device)

    def ln(x, gm, bt):
        mean = x.mean(-1, keepdim=True)
        var = ((x - mean) ** 2).mean(-1, keepdim=True)
        return (x - mean) / torch.sqrt(var + eps) * gm + bt

    t1 = ln(z, g1, be1)
    h0 = depthwise_conv1d(t1, wd.t().unsqueeze(1), bd)
    up = torch.relu(operand(h0) @ operand(w1) + b1)
    up = torch.where(tffn.ffn_keep_mask(gpos, F, rate, seeds, 1), up * ik, 0.0)
    ff = operand(up) @ operand(w2f) + b2f
    ff = torch.where(tffn.ffn_keep_mask(gpos, C, rate, seeds, 2), ff * ik, 0.0)
    return ln(t1 + ff, g2, be2)


@pytest.mark.gpu
def test_ffn_ln_train_f32_kernels_hold_an_f64_reference(cuda_card):
    # Split-TF32 products keep f32's digits: at the flagship decoder's shape
    # (8, 2048, 256), k = 21, F = 1024, rate 0.1, the f32 kernels' output
    # lies within 1e-5 of max |ref| of the function computed in f64 (one
    # TF32 product a product misses that: tests/test_torch_tf32_split.py
    # shows the up and down products alone), and every gradient within the
    # f32 card tolerance of the f64 gradient (2e-4 of its largest element,
    # the bulk within 2e-5). b1 is moved off the ReLU kink first, as in
    # test_ffn_ln_train_kernels_match_plain, with a margin of 2^-18 of the
    # products' magnitude sum: the kernel's ReLU inputs lie within about
    # 2^-20 of it of the exact value (split TF32 keeps 2^-22 a product, and
    # a 64-term run on the tensor cores truncates at most eight sums of
    # 2^-23), while KINK_MARGIN (2^-14, for two f32 sums of C products in
    # any order) leaves no b1 clear at 16384 rows a column.
    B, T, C_, F_, k, rate = 8, 2048, 256, 1024, 21, 0.1
    params = [t.detach().to(cuda_card).clone()
              for t in tffn.ffn_train_params(**ffn_modules(ffn_params(3, C_, F_, k)))]
    seed = torch.tensor([12345], dtype=torch.int32, device=cuda_card)
    g = torch.Generator(device=cuda_card).manual_seed(21)
    z, dout = (torch.randn(B, T, C_, device=cuda_card, generator=g) for _ in range(2))
    params[3] = _b1_off_the_kink(z, params, margin=2.0 ** -18)
    params = [t.requires_grad_(True) for t in params]
    out, *grads = _ffn_train_grads(tffn.ffn_ln_train, z, params, seed, rate, dout)
    torch.cuda.synchronize()
    p64 = [t.detach().double().requires_grad_(True) for t in params]
    ref, *ref_grads = _ffn_train_grads(lambda zz, pp, s, r: _ffn_train_f64(zz, pp, s, r),
                                       z.double(), p64, seed, rate, dout.double())
    top = ref.abs().max().item()
    with torch.no_grad():
        one_pass = _ffn_train_f64(z, [t.detach() for t in params], seed, rate,
                                  operand=tf32_round)
    errs = {"out": (out.double() - ref).abs().max().item() / top,
            "one_pass_out": (one_pass.double() - ref).abs().max().item() / top}
    for name, got, want in zip(_FFN_GRADS[1:], grads, ref_grads):
        d = (got.double() - want).abs()
        w = want.abs().max().item()
        errs[name] = (d.max().item() / w, d.mean().item() / w)
    print("errors relative to the largest element:", errs)
    assert errs["out"] <= 1e-5 and errs["one_pass_out"] > 1e-5, errs
    for name, got, want in zip(_FFN_GRADS[1:], grads, ref_grads):
        _bulk_close(got.double(), want, 2e-4, 2e-5, name)


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
    # the chain (ffn_ln.cu), then the dup and dt1 passes, in either dtype
    assert [rec["ffn_ln"], *rec["ffn_ln_train_bwd"]] == plan("bwd")


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


def _flash_inputs(device, dtype, B, H, T, lengths, d=128):
    g = torch.Generator(device=device).manual_seed(T + B)
    q, k, v, do = (torch.randn(B, H, T, d, device=device, generator=g).to(dtype)
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


# (B, H, T, d, lengths): head dim 256 on the tensor-core routes, 512 on the
# CUDA-core one
_WIDE_FLASH_CASES = {"d256": (2, 2, 2048, 256, (2048, 1500)),
                     "d512": (1, 1, 1024, 512, (900,))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(_WIDE_FLASH_CASES))
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_wide_head_dims_match_plain(cuda_card, dtype, rate, case):
    B, H, T, d, lengths = _WIDE_FLASH_CASES[case]
    q, k, v, do, mask, seed = _flash_inputs(cuda_card, dtype, B, H, T, lengths, d)
    route = (tatt.ROUTES if d in tatt.TENSOR_CORE_DIMS else tatt.WIDE_ROUTES)[dtype]
    assert tatt.kernel_route(q, k, v) == route
    before = {fn: (dict(fn.by_route), fn.by_head_dim.get((route, d), 0))
              for fn in (tatt.flash_attention, tatt.flash_attention_bwd)}
    with _deadline(300):
        got = _flash_run(tatt.flash_attention, q, k, v, do, mask, rate, seed)
        torch.cuda.synchronize()
    for fn, (counts, at_d) in before.items():
        assert {r: fn.by_route[r] - n for r, n in counts.items()} == {
            r: int(r == route) for r in counts}
        assert fn.by_head_dim[(route, d)] == at_d + 1
    want = _flash_run(tatt.flash_attention_plain, q, k, v, do, mask, rate, seed)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert torch.isfinite(a).all(), name
        if dtype == torch.float32:
            _each_item_close(a, b, 1e-4, 1e-5, name)
        else:
            _each_item_close(a, b, 0.02, 0.004, name)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [128, 256])
def test_flash_attention_launches_from_a_fresh_thread(cuda_card, d):
    # a thread that has run no CUDA work has no current context (autograd's
    # device thread before its first kernel is one): the bf16 route's tensor
    # maps need one, and the launch must not fail there
    import threading

    q, k, v, do, mask, seed = _flash_inputs(cuda_card, torch.bfloat16, 1, 2, 1024, (1024,), d)
    m32 = mask.to(torch.int32)
    errors = []

    def run():
        try:
            _, lse, o32 = tatt.flash_attention_fwd(q, k, v, m32, seed, 0.1)
            tatt.flash_attention_bwd(do, q, k, v, m32, seed, o32, lse, 0.1)
            torch.cuda.synchronize()
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    th = threading.Thread(target=run)
    th.start()
    th.join()
    assert not errors, errors


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
    # a small model whose FFN widths the training kernels take and the FFN
    # gate fuses (C 128, F 128: multiples of 128): one optimizer step through
    # them, then the serving forward must use the updated weights (the
    # optimizer's in-place update moves the version counters the prepared
    # ffn_ln layouts are keyed on)
    stack = dict(hidden=128, heads=2, layers=1, conv_filter_size=128)
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


def _soft_dtw_lattices(device, L, N, M, mel):
    """D (L, N, M) f32: uniform in [0, 2), or (``mel``) squared distances of
    a small bf16 prediction against unit targets over 80 channels, as the
    mel loss forms them (R reaches ~1e4)."""
    g = torch.Generator(device=device).manual_seed(N)
    if mel:
        pred = (0.5 * torch.randn(L, N, 80, device=device, generator=g)).to(torch.bfloat16)
        truth = torch.randn(L, M, 80, device=device, generator=g)
        return tsd.pairwise_sqdist(pred, truth).contiguous()
    return torch.rand(L, N, M, device=device, generator=g) * 2.0


# (L, N, M, mel-like D): the card's first shapes; the mel loss's 64 lattices
# of the flagship's step; the longest lattice the kernels take (8 rows a
# thread); the fewest rows the gate admits
SOFT_DTW_CASES = [(4, 256, 256, False), (3, 31, 57, False), (2, 1100, 1100, False),
                  (64, 256, 256, True), (2, 4096, 64, False), (5, 8, 300, False)]


@pytest.mark.gpu
@pytest.mark.parametrize("gamma", [1.0, 0.1])
@pytest.mark.parametrize("L,N,M,mel", SOFT_DTW_CASES)
def test_soft_dtw_kernels_match_plain(cuda_card, L, N, M, mel, gamma):
    # (2, 1100, 1100): more rows than one block has threads
    D = _soft_dtw_lattices(cuda_card, L, N, M, mel)
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


@pytest.mark.gpu
@pytest.mark.parametrize("L,N,M,mel", [(4, 256, 256, False), (8, 256, 256, True),
                                       (2, 1100, 1100, False), (2, 4096, 64, False),
                                       (5, 8, 300, False)])
def test_soft_dtw_kernels_alone_match_their_plain_twins(cuda_card, L, N, M, mel):
    gamma = 0.1
    D = _soft_dtw_lattices(cuda_card, L, N, M, mel)
    g = torch.linspace(0.5, 1.5, L, device=cuda_card)
    value, W = tsd.soft_dtw_fwd(D, gamma)
    ref_value, ref_W = tsd.soft_dtw_fwd_plain(D, gamma)
    dD = tsd.soft_dtw_bwd(ref_W, g, N)
    ref_dD = tsd.soft_dtw_bwd_plain(ref_W, g, N)
    torch.cuda.synchronize()
    # the forward: the same arithmetic, ex2 / lg2 / rcp.approx against exp2 /
    # log2 / division; where that moves R by an ulp in a near tie a weight
    # moves by up to ulp(R) / (4 gamma): 1e-3 at most, 1e-7 on average
    torch.testing.assert_close(value, ref_value, rtol=1e-5, atol=1e-5)
    err = (W - ref_W).abs()[:, tsd.residual_cells(N, M, cuda_card)]
    assert err.max().item() <= 1e-3 and err.mean().item() <= 1e-7, (err.max(), err.mean())
    # the backward on the same residual: the same products in the same
    # order, one of them fused
    _bulk_close(dD, ref_dD, 1e-5, 1e-7, "dD")


@pytest.mark.gpu
@pytest.mark.parametrize("L,N,M", [(64, 256, 256), (3, 31, 57), (2, 600, 80), (2, 1100, 1100),
                                   (2, 4096, 64)])
def test_soft_dtw_launch_record_matches_the_plan(cuda_card, L, N, M):
    """Each launch as the library recorded it (lfs2_soft_dtw_last_launch) is
    ops/soft_dtw.py soft_dtw_plan's: rows a thread 1, 1, 2, 4 and 8 here."""
    D = torch.rand(L, N, M, device=cuda_card)
    _, W = tsd.soft_dtw_fwd(D, 1.0)
    tsd.soft_dtw_bwd(W, torch.ones(L, device=cuda_card), N)
    torch.cuda.synchronize()
    plan = tsd.soft_dtw_plan(L, N, M)
    assert tsd.last_launch() == {"fwd": plan.fwd.record, "bwd": plan.bwd.record}
    assert W.shape == plan.residual_shape


@pytest.mark.gpu
def test_soft_dtw_backward_is_deterministic(cuda_card):
    # no atomics: every dD element is written once, by one thread
    D = _soft_dtw_lattices(cuda_card, 64, 256, 256, True)
    _, W = tsd.soft_dtw_fwd(D, 0.1)
    g = torch.ones(64, device=cuda_card)
    a, b = tsd.soft_dtw_bwd(W, g, 256), tsd.soft_dtw_bwd(W, g, 256)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


# (B, P, H, T, dtype): the flagship's training step in f32 and bf16, a
# one-sentence request bucket, the lightspeech_true76m width, long items (P
# above the forward's scan chunk of 256 phones), and rows that are not
# 16-byte aligned (134 bytes: 2-byte copies; 264: 4-byte copies, int32
# durations)
REGULATE_SHAPES = [(8, 256, 256, 2048, torch.float32), (8, 256, 256, 2048, torch.bfloat16),
                   (1, 64, 256, 512, torch.bfloat16), (8, 256, 640, 2048, torch.bfloat16),
                   (2, 1024, 256, 8192, torch.bfloat16), (2, 40, 67, 256, torch.bfloat16),
                   (2, 40, 66, 256, torch.float32)]
_BITS = {torch.float32: torch.int32, torch.bfloat16: torch.int16}


def _regulate_inputs(device, dtype, B=8, P=256, H=256, T=2048):
    """x with a -0.0 and a NaN with a payload in it, and int64 durations
    (int32 where H is 66): ragged totals, zeros inside an item, an empty
    item, negative durations (clamped) and an item above T, as far as B
    allows."""
    g = torch.Generator().manual_seed(11)
    x = torch.randn(B, P, H, generator=g).to(device, dtype)
    bits = x.view(_BITS[dtype])
    bits[0, 0, 0] = 0x7FC00001 if dtype == torch.float32 else 0x7FC1   # NaN, payload 1
    x[0, 0, 1] = -0.0
    d = torch.randint(0, 15, (B, P), generator=g)
    d[0, 1::7] = -4                      # negative durations count as 0
    if B > 1:
        d[1, P * 25 // 32:] = 0          # ragged totals
    if B == 2:
        d[0, ::2] = 2 * T // P + 1       # a total above T
    if B > 2:
        d[2, ::3] = 0                    # zero durations inside an item
    if B > 3:
        d[3] = 0                         # an empty item
    if B > 4:
        d[4] = 12                        # a total above T (3072 frames)
    if H == 66:
        d = d.to(torch.int32)
    return x, d.to(device), T


def _device_kernels(fn):
    """``chip_smoke.device_kernels``: the device kernels a call of ``fn``
    runs, by name, from torch.profiler."""
    import importlib.util

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.device_kernels(fn, calls=5)


@pytest.mark.gpu
@pytest.mark.parametrize("B,P,H,T,dtype", REGULATE_SHAPES)
def test_regulate_kernels_match_gather(cuda_card, B, P, H, T, dtype):
    x, d, T = _regulate_inputs(cuda_card, dtype, B, P, H, T)
    dout = torch.randn(B, T, H, device=cuda_card)
    n_fwd, n_bwd = tlr.regulate.launches, tlr.regulate_bwd.launches
    xk = x.clone().requires_grad_(True)
    frames, mask = tlr.regulate_kernel(xk, d, T)
    (grad,) = torch.autograd.grad(frames, xk, dout.to(dtype))
    torch.cuda.synchronize()
    assert (tlr.regulate.launches, tlr.regulate_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    # a copy: bit for bit, -0.0 and the NaN's payload included (the gather
    # run on the bits as integers)
    ref, ref_mask = tlr.regulate_plain(x.view(_BITS[dtype]), d, T)
    assert torch.equal(frames.view(_BITS[dtype]), ref) and torch.equal(mask, ref_mask)
    # ends: the running sums of the clamped durations, in int32
    _, _, ends = tlr.regulate_fwd(x, d, T)
    assert ends.dtype == torch.int32
    assert torch.equal(ends, torch.cumsum(d.clamp(min=0).to(torch.int32), -1, dtype=torch.int32))
    # the gradient against the f32 gather's of the same inputs; in bf16 that
    # f32 gradient rounded once, since the gather's own bf16 backward adds
    # in bf16: within one bf16 ulp of it (the kernel sums in f32)
    xf = x.float().requires_grad_(True)
    (ref_grad,) = torch.autograd.grad(tlr.regulate_plain(xf, d, T)[0], xf, dout.to(dtype).float())
    if B > 3:
        assert not grad[3].any()
    if dtype == torch.float32:
        # two f32 sums of the same frames in other orders: 1e-6 plus the
        # bound on their rounding, 2 * n * 2^-24 * sum |g| with n the
        # longest run
        n = int(d.clamp(min=0).max())
        (absum,) = torch.autograd.grad(tlr.regulate_plain(xf, d, T)[0], xf, dout.abs())
        assert ((grad - ref_grad).abs() <= 1e-6 + 2 * n * 2.0 ** -24 * absum).all()
    else:
        want = ref_grad.to(torch.bfloat16).float()
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp(min=1e-30))) - 7)
        assert ((grad.float() - want).abs() <= ulp).all()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,P,H,T", [(8, 256, 256, 2048), (1, 64, 256, 512)])
def test_regulate_backward_repeats_and_takes_strides(cuda_card, dtype, B, P, H, T):
    # no atomics: every dx element is written once, by one lane, in an
    # order fixed by the shape (a phone's frames dealt among the warps the
    # plan gives it: one at the flagship's shape, in frame order; 8 for one
    # item of 64 phones, their partial sums added in warp order); a gradient
    # with other strides sums the same values in the same order (16-byte
    # loads for contiguous rows, one element a load else)
    x, d, T = _regulate_inputs(cuda_card, dtype, B, P, H, T)
    _, _, ends = tlr.regulate_fwd(x, d, T)
    g = torch.randn(B, T, H, device=cuda_card).to(dtype)
    a, b = tlr.regulate_bwd(g, ends), tlr.regulate_bwd(g, ends)
    transposed = g.transpose(1, 2).contiguous().transpose(1, 2)
    row = torch.randn(H, device=cuda_card).to(dtype)
    expanded = row.expand(B, T, H)                # as the gradient of a sum
    c = tlr.regulate_bwd(transposed, ends)
    e = tlr.regulate_bwd(expanded, ends)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(e, tlr.regulate_bwd(expanded.contiguous(), ends))
    # against the plain segment-sum: both sum in f32 and round once, so in
    # bf16 within one ulp; in f32 within the two orders' rounding (runs of
    # at most 14 frames)
    ref = tlr.regulate_bwd_plain(g, ends).float()
    if dtype == torch.float32:
        tol = 1e-6 + 28 * 2.0 ** -24 * tlr.regulate_bwd_plain(g.abs(), ends)
    else:
        tol = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
    assert ((a.float() - ref).abs() <= tol).all()


@pytest.mark.gpu
def test_regulate_is_one_kernel_a_direction(cuda_card):
    # the only device kernel a call runs is the regulator's, and the
    # wrapper launched it once a call
    x, d, T = _regulate_inputs(cuda_card, torch.bfloat16)
    xk = x.clone().requires_grad_(True)
    dout = torch.randn(x.shape[0], T, x.shape[2], device=cuda_card).to(torch.bfloat16)
    frames, _ = tlr.regulate_kernel(xk, d, T)      # built and warmed up
    torch.autograd.grad(frames, xk, dout, retain_graph=True)
    cases = (("regulate_fwd_kernel", tlr.regulate, lambda: tlr.regulate_kernel(xk, d, T)),
             ("regulate_bwd_kernel", tlr.regulate_bwd,
              lambda: torch.autograd.grad(frames, xk, dout, retain_graph=True)))
    for name, counter, fn in cases:
        n, calls = counter.launches, []
        prof = _device_kernels(lambda: calls.append(fn()))
        assert counter.launches == n + len(calls)
        assert prof["names"] == [name] and prof["kernels"] == 1, prof
    with torch.no_grad():                          # serving: no autograd Function
        prof = _device_kernels(lambda: tlr.regulate_kernel(x, d, T))
    assert prof["names"] == ["regulate_fwd_kernel"] and prof["kernels"] == 1, prof


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
    # bit for bit (x holds a NaN)
    assert torch.equal(a.view(torch.int16), tlr.regulate_plain(x.view(torch.int16), d, 512)[0])


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


# (8, 25): stage 1, tail tile; (256, 80): 256-row tiles; (6, 9): a hop
# that is not a multiple of 4 (one row a chunk), one partial tile; (50, 9):
# not a multiple of 8; at every inner width the kernel is built at, 48
# (padded to 64), and past 128 the wide route: 129 (element loads of the
# frame kernels, signal padded to 144), 200 (padded to 208), 192, 256 and
# 512 (but at 80 frames, whose f32 frame kernels alone would take 4 GB)
_LVC_CASES = [(hop, nL, C) for hop, nL in ((8, 25), (64, 7), (256, 5), (256, 80), (6, 9), (50, 9))
              for C in (32, 16, 48, 64, 128, 129, 192, 200, 256, 512) if nL * C <= 80 * 256]


@pytest.mark.gpu
@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hop,nL,C", _LVC_CASES)
def test_lvc_stack_kernel_matches_plain(cuda_card, hop, nL, dtype, fast, C):
    args = _lvc_inputs(cuda_card, 2, nL, hop, dtype, seed=hop + nL, C=C)
    n, widths = tlvc.lvc_stack.launches, dict(tlvc.lvc_stack.by_width)
    out = tlvc.lvc_stack(*args, hop, fast_gating=fast)
    torch.cuda.synchronize()
    assert tlvc.lvc_stack.launches == n + 1 and out.dtype == dtype and out.shape == args[0].shape
    assert tlvc.lvc_stack.by_width[C] == widths.get(C, 0) + 1
    assert tlvc.last_launch() == tlvc.lvc_plan(2, nL * hop, hop, 4, dtype, C).record
    ref = tlvc.lvc_stack_plain(*args, hop, fast_gating=fast).float()
    if dtype == torch.float32:   # summation order only
        err = (out - ref).abs().max().item()
        top = ref.abs().max().item()
        assert err <= 2e-4 * (1 + top), (err, top)
    else:
        # both round at the same places: a few one-ulp flips, carried down
        # the residual chain, held per value
        ulps, share = tlvc.bf16_chain_error(out, ref, args[0], args[1], args[2].shape[2])
        most_ulps, most_unequal = tlvc.bf16_chain_limits(C)
        assert ulps <= most_ulps and share <= most_unequal, (ulps, share)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lvc_stack_past_128_channels_takes_the_wide_route(cuda_card, dtype):
    """C = 256 launches the wide route once, as planned, and allocates no
    tensor the size of the frame kernels (its 16 times the signal here):
    the peak over the call stays below what one copy of them would add."""
    args = _lvc_inputs(cuda_card, 1, 64, 64, dtype, seed=0, C=256)
    kbytes = args[2].numel() * args[2].element_size()
    assert kbytes >= 16 * args[0].numel() * args[0].element_size()
    n = tlvc.lvc_stack.launches
    tlvc.lvc_stack(*args, 64)          # the build and the first launch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda_card)
    base = torch.cuda.memory_allocated(cuda_card)
    out = tlvc.lvc_stack(*args, 64)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(cuda_card) - base
    assert tlvc.lvc_stack.launches == n + 2
    plan = tlvc.lvc_plan(1, 64 * 64, 64, 4, dtype, 256)
    assert plan.route == "wide" and tlvc.last_launch() == plan.record
    assert peak < kbytes / 4, (peak, kbytes)
    assert out.shape == args[0].shape


@pytest.mark.gpu
def test_lvc_stack_raises_when_grad_is_needed(cuda_card):
    # the kernel is invisible to autograd: on the card it must not silently
    # stop the gradient at an LVC stage; training takes FastDiff's route
    args = _lvc_inputs(cuda_card, 1, 5, 256, torch.float32, seed=3)
    args[2].requires_grad_(True)
    n = tlvc.lvc_stack.launches
    with pytest.raises(RuntimeError, match="train_route"):
        tlvc.lvc_stack(*args, 256)
    assert tlvc.lvc_stack.launches == n
    with torch.no_grad():
        assert tlvc.lvc_stack(*args, 256).shape == args[0].shape
    # the training route on the card: no kernel launch, gradients flow
    fd = tfd.FastDiff(tfd.FastDiffConfig()).to(cuda_card)
    x = torch.randn(1, 5 * 256, device=cuda_card)
    c = torch.randn(1, 5, 80, device=cuda_card)
    n = tlvc.lvc_stack.launches
    fd(x, c, torch.full((1,), 3.0, device=cuda_card), train_route=True).square().sum().backward()
    assert tlvc.lvc_stack.launches == n
    assert all(p.grad is not None for p in fd.parameters())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lvc_stack_kernel_matches_plain_at_the_served_batch(cuda_card, dtype):
    # stage 3 of the served batch at frame bucket 512: B = 8, hop 256
    args = _lvc_inputs(cuda_card, 8, 512, 256, dtype, seed=8)
    out = tlvc.lvc_stack(*args, 256)
    torch.cuda.synchronize()
    ref = tlvc.lvc_stack_plain(*args, 256).float()
    if dtype == torch.float32:
        err = (out - ref).abs().max().item()
        top = ref.abs().max().item()
        assert err <= 2e-4 * (1 + top), (err, top)
    else:
        ulps, share = tlvc.bf16_chain_error(out, ref, args[0], args[1], args[2].shape[2])
        assert ulps <= tlvc.BF16_MAX_ULPS and share <= tlvc.BF16_MAX_UNEQUAL, (ulps, share)


def _lvc_chain(x, ad, k, b, cw, cb, hop, operand=lambda t: t):
    """The chain in the dtype of x with every product operand passed
    through ``operand`` first: in f64 the function itself; in f32 with
    ``tf32_round`` the chain as one TF32 product a product would give it."""
    import torch.nn.functional as F

    dt = x.dtype
    for i in range(k.shape[2]):
        d = 3 ** i
        x = x + ad
        y = torch.maximum(x, x * tlvc.LRELU_SLOPE)
        w = operand(cw[i].to(dt)).permute(2, 1, 0)
        y = F.conv1d(operand(y).transpose(1, 2), w, cb[i].to(dt), padding=d,
                     dilation=d).transpose(1, 2)
        y = torch.maximum(y, y * tlvc.LRELU_SLOPE)
        g = tlvc.location_variable_convolution(operand(y), operand(k[:, :, i].to(dt)),
                                               b[:, :, i].to(dt), hop)
        x = x + tlvc.gated_activation(g, x.shape[-1], False)
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("hop,nL", [(64, 7), (8, 25), (256, 3)])
def test_lvc_stack_f32_kernel_holds_an_f64_reference(cuda_card, hop, nL):
    # Split-TF32 products keep f32's digits: the f32 route lies within 1e-5
    # (1 + max |ref|) of the chain computed in f64 (its own f32 roundings of
    # x are about 1e-7 of |x|). One TF32 product a product keeps 11 bits of
    # each operand: that chain misses the same tolerance
    # (tests/test_torch_tf32_split.py shows the product alone).
    args = _lvc_inputs(cuda_card, 2, nL, hop, torch.float32, seed=hop + 2 * nL)
    got = tlvc.lvc_stack(*args, hop)
    torch.cuda.synchronize()
    assert tlvc.last_launch()["route"] == "mma"
    want = _lvc_chain(*(t.double() for t in args), hop)
    top = want.abs().max().item()
    err = (got.double() - want).abs().max().item()
    assert err <= 1e-5 * (1 + top), (err, top)
    one_pass = _lvc_chain(*args, hop, operand=tf32_round)
    assert (one_pass.double() - want).abs().max().item() > 1e-5 * (1 + top)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lvc_launch_record_matches_the_plan(cuda_card, dtype):
    """Each launch's route, tile, blocks, shared memory, frames a round and
    row tiles a chunk, as csrc/lvc_stack.cu recorded it
    (lfs2_lvc_stack_last_launch), are ops/fastdiff_lvc.py lvc_plan's: hop 8
    and 6 (the CUDA-core rule), the stages of a 512-frame bucket."""
    for B, nL, hop in ((2, 25, 8), (2, 9, 6), (1, 512, 8), (1, 512, 64), (1, 512, 256),
                       (2, 5, 256)):
        args = _lvc_inputs(cuda_card, B, nL, hop, dtype, seed=nL)
        tlvc.lvc_stack(*args, hop)
        torch.cuda.synchronize()
        plan = tlvc.lvc_plan(B, nL * hop, hop, 4, dtype)
        assert tlvc.last_launch() == plan.record
        assert plan.route == ("mma" if hop % 8 == 0 else "cuda_cores")


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


@pytest.mark.gpu
def test_generate_cli_on_the_card_matches_cpu(cuda_card, tmp_path):
    """The generate CLI at a tiny size (C 32, F 128; HiFi-GAN 64 -> 32
    channels, hop 16) from a port checkpoint with d-vectors: on the card the
    neural G2P spells the OOV word as on the CPU and the f32 waveform agrees
    within phase 6's tolerance (1e-3 of the peak)."""
    import dataclasses

    import numpy as np

    from lightningfastspeech2_tpu_torch.cli import generate as cli
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.data.vocab import (
        ARPABET_TO_IPA,
        PUNCTUATION_TOKENS,
        SILENCE,
    )
    from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg

    phones = sorted(set(ARPABET_TO_IPA.values()) | set(PUNCTUATION_TOKENS.values()) | {SILENCE})
    phone2id = {"[PAD]": 0, **{p: i + 1 for i, p in enumerate(phones)}}
    stack = dict(hidden=32, heads=2, layers=2, conv_filter_size=128)
    cfg = tiny_config(TC, encoder=TC.StackConfig(kernel_sizes=(3, 5), **stack),
                      decoder=TC.StackConfig(kernel_sizes=(5, 3), **stack),
                      audio=TC.AudioConfig(hop_length=16), vocab_size=len(phone2id))
    model = build_fastspeech2(cfg.model, device="cpu")
    with torch.no_grad():  # every phone 7 frames
        head = model.variance_adaptor.duration_predictor.linear
        head.weight.zero_()
        head.bias.fill_(math.log(8.0))
    g = np.random.default_rng(0)
    dvecs = {f"spk{i}": g.standard_normal(16).astype(np.float32) for i in range(2)}
    Checkpointer(tmp_path / "ck").save(1, model.state_dict(), cfg,
                                       {"phone2id": phone2id, "speaker2dvector": dvecs})
    hcfg = thg.HifiGanConfig(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                             upsample_initial_channel=128)
    voc = thg.Synthesiser(hcfg, device="cpu", seed=1).model
    Checkpointer(tmp_path / "voc").save(
        1, {"gen": {k: v * 8.0 for k, v in voc.state_dict().items()}},
        sidecar={"hifigan_config": dataclasses.asdict(hcfg)})

    argv = ["--checkpoint_dir", str(tmp_path / "ck"), "--hifigan_checkpoint",
            str(tmp_path / "voc"), "--sentence", "hello zyxwort world.", "--seed", "0",
            "--speaker", "spk1"]
    wavs, ids = {}, {}
    for dev in ("cuda", "cpu"):
        run = argv + ["--device", dev, "--output_path", str(tmp_path / dev)]
        wavs[dev] = cli.main(run)
        gen, _, _ = cli.load_generator(cli.build_parser().parse_args(run))
        ids[dev] = gen.text_to_ids("zyxwort")
    assert list(ids["cuda"]) == list(ids["cpu"]) and len(ids["cpu"]) > 2
    a, b = wavs["cuda"], wavs["cpu"]
    top = float(np.abs(b).max())
    assert a.shape == b.shape and np.isfinite(a).all() and top > 0.01
    assert float(np.abs(a - b).max()) <= 1e-3 * top + 1e-7


@pytest.mark.gpu
def test_dvector_embedding_card_matches_cpu(cuda_card):
    """One second of speech-like audio through ``data/dvector.py`` (the
    front-end's FFT and the cuDNN LSTM on the card, TF32 off) against the
    CPU: within 5e-4 (``tests/test_torch_dvector.py``'s pipeline tolerance,
    near-clamp log-mel bins), unit norm; the d-vector train CLI path."""
    import numpy as np

    from lightningfastspeech2_tpu_torch.data.dvector import DVectorPipeline

    sr = 22050
    g = np.random.default_rng(0)
    t = np.arange(sr) / sr
    wav = (0.5 * np.sin(2 * np.pi * (120 + 80 * t) * t) * (t > 0.15)
           + 0.02 * g.standard_normal(sr)).astype(np.float32)
    a = DVectorPipeline(device=cuda_card).embed_wav(wav, sr)
    b = DVectorPipeline(device="cpu").embed_wav(wav, sr)
    assert a.shape == b.shape == (256,)
    assert float(np.abs(a - b).max()) <= 5e-4
    assert abs(float(np.linalg.norm(a)) - 1.0) <= 1e-5


@pytest.mark.gpu
def test_on_device_features_card_matches_cpu(cuda_card, tmp_path):
    """``train/on_device_features.py`` on a raw batch (make_corpus, 3 items,
    int16 wavs) with pitch (CWT), energy, SNR and SRMR, on the card with
    both TF32 flags on (the extraction turns them off and restores them)
    against the CPU: the mel linear within 2e-6 of each item's peak and log10
    within 1e-4 within 30 dB of it; energy and SNR de-normalized within
    their prefix sums' rounding bounds; SRMR rtol 1e-4; the pitch (CWT)
    signal rtol 1e-5, spectrogram atol 1e-5, mean and std rtol 1e-5 in the
    items whose YIN track is alike on both devices (a decision taken the
    other way moves an item's whole CWT)."""
    import numpy as np

    from lightningfastspeech2_tpu_torch.audio import pitch as pitch_mod
    from lightningfastspeech2_tpu_torch.audio.features import energy_rounding_bound
    from lightningfastspeech2_tpu_torch.audio.snr import snr_rounding_bound
    from lightningfastspeech2_tpu_torch.data import dataset as dsm
    from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
    from lightningfastspeech2_tpu_torch.train.loop import stats_tree
    from lightningfastspeech2_tpu_torch.train.on_device_features import (
        augment_batch_with_features)

    variances = ("pitch", "energy", "snr", "srmr")
    corpus = make_corpus(tmp_path / "c", n_speakers=1, n_utts=3, seed=5)
    ds = dsm.TTSDataset(corpus, dsm.DataConfig(
        variances=variances, variance_levels=("frame",) * 4,
        variance_transforms=("cwt", "none", "none", "none"), augment_duration=0.0,
        raw_mode=True, wav_dtype="int16"), device="cpu")
    batch = ds.collate([ds.__getitem__(i, augment=False) for i in range(len(ds))])
    arrays = {k: torch.from_numpy(v) for k, v in batch.items() if isinstance(v, np.ndarray)}
    var = TC.VarianceConfig(variances=variances, levels=("frame",) * 4,
                            transforms=("cwt", "none", "none", "none"), losses=("mse",) * 4,
                            nlayers=(2,) * 4, kernel_sizes=(3,) * 4, dropouts=(0.0,) * 4,
                            loss_weights=(0.1,) * 4)
    cfg = TC.Config(model=TC.ModelConfig(variance=var))
    stats = stats_tree(ds, variances)
    st = dict(stats)
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        out = {dev: {k: v.float().cpu().numpy() for k, v in augment_batch_with_features(
            {k: v.to(dev) for k, v in arrays.items()}, cfg, stats).items()
            if torch.is_tensor(v)} for dev in (cuda_card, "cpu")}
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    a, b = out[cuda_card], out["cpu"]
    wav = batch["wav"].astype(np.float32) / 32768.0
    f0 = {dev: pitch_mod.track(torch.from_numpy(wav).to(dev)).cpu().numpy()
          for dev in (cuda_card, "cpu")}
    alike = 0
    for i, n in enumerate(int(d.sum()) for d in batch["duration"]):
        la, lb = 10.0 ** a["mel"][i].astype(np.float64), 10.0 ** b["mel"][i].astype(np.float64)
        assert np.abs(la - lb).max() <= 2e-6 * lb.max()
        loud = lb >= 1e-3 * lb.max()
        assert np.abs(a["mel"][i] - b["mel"][i])[loud].max() <= 1e-4
        ea, eb = (x["variances_energy"][i].astype(np.float64) * st["energy"].std
                  + st["energy"].mean for x in (a, b))
        assert np.abs(ea ** 2 - eb ** 2).max() <= energy_rounding_bound(wav[i])
        sa, sb = (x["variances_snr"][i].astype(np.float64) * st["snr"].std + st["snr"].mean
                  for x in (a, b))
        assert np.abs(sa - sb).max() <= snr_rounding_bound(wav[i], sb[:n])
        sra, srb = (x["variances_srmr"][i].astype(np.float64) * st["srmr"].std
                    + st["srmr"].mean for x in (a, b))
        np.testing.assert_allclose(sra, srb, rtol=1e-4, atol=1e-7)
        fa, fb = f0[cuda_card][i, :n], f0["cpu"][i, :n]
        if ((fa > 0) != (fb > 0)).any() or (np.abs(fa - fb) > 1e-5 * np.maximum(fb, 1)).any():
            continue
        alike += 1
        np.testing.assert_allclose(a["variances_pitch_signal"][i], b["variances_pitch_signal"][i],
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(a["variances_pitch_spectrogram"][i],
                                   b["variances_pitch_spectrogram"][i], rtol=0, atol=1e-5)
        for k in ("variances_pitch_mean", "variances_pitch_std"):
            np.testing.assert_allclose(a[k][i], b[k][i], rtol=1e-5)
    assert alike >= 2


@pytest.mark.gpu
def test_cwt_stays_f32_with_tf32_on(cuda_card):
    """``audio/cwt.py decompose_padded`` at a 2048-frame bucket (the widest
    scale's kernel 2048 taps) on the card with both TF32 flags on, as a
    bf16 training process may have them, against the CPU: the spectrogram
    within 1e-5, mean and std rtol 1e-6 (the FFT convolution takes no
    TF32). The flags are restored."""
    import numpy as np

    from lightningfastspeech2_tpu_torch.audio import cwt

    g = np.random.default_rng(0)
    sig = (np.abs(g.standard_normal((2, 2048))) * 100 + 80).astype(np.float32)
    length = np.asarray([2048, 1500])
    sig[1, 1500:] = 0
    flags = (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    try:
        a = cwt.decompose_padded(torch.from_numpy(sig).to(cuda_card),
                                 torch.from_numpy(length).to(cuda_card))
        a = {k: v.cpu().numpy() for k, v in a.items()}
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    b = {k: v.numpy() for k, v in cwt.decompose_padded(torch.from_numpy(sig),
                                                       torch.from_numpy(length)).items()}
    np.testing.assert_allclose(a["spectrogram"], b["spectrogram"], rtol=0, atol=1e-5)
    for k in ("mean", "std", "signal"):
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7)
    assert np.abs(b["spectrogram"]).max() > 0.05
