"""The port's CUDA kernels against their plain PyTorch versions on a Hopper
card: ``probe``, ``ffn_ln``, ``resblock``, ``resblock_trio``, and the
training kernels ``ffn_ln_train`` and ``flash_attention`` (forward and
backward, gradients against the plain version's autograd). Marked
``gpu``; the ``cuda_card`` fixture skips them without a card. This file
imports neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m gpu
"""

import math

import pytest
import torch

from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2, make_dummy_batch
from lightningfastspeech2_tpu_torch.ops import attention as tatt
from lightningfastspeech2_tpu_torch.ops import ffn as tffn
from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as trb
from lightningfastspeech2_tpu_torch.ops.probe import probe
from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step
from torch_port_helpers import (  # noqa: F401
    cuda_card,
    ffn_modules,
    ffn_params,
    resblock_block,
    resblock_params,
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


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("C_,L,ks", [(256, 300, (11,)), (128, 257, (3, 7, 11)),
                                     (32, 40, (3, 7, 11))])
def test_resblock_kernels_match_plain(cuda_card, C_, L, ks, dtype):
    blocks = [resblock_block(resblock_params(k, C_, k, scale=2.0), k) for k in ks]
    w = trb.prepare_resblock_weights(
        [(k, d, [tuple(t.to(cuda_card) for t in c) for c in convs])
         for k, d, convs in blocks], dtype)
    x = torch.randn(2, L, C_, device=cuda_card).to(dtype)
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


def _bulk_close(got, want, frac, mean_frac, what):
    top = want.abs().max().item()
    err = (got.float() - want.float()).abs()
    assert err.max().item() <= frac * top + 1e-6, (what, err.max().item(), top)
    assert err.mean().item() <= mean_frac * top + 1e-7, (what, err.mean().item(), top)


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

    def run(fn):
        zz = z.clone().requires_grad_(True)
        out = fn(zz, params, seed, rate)
        grads = torch.autograd.grad(out, [zz, *params], dout)
        return out, grads

    n_fwd, n_bwd = tffn.ffn_ln_train.launches, tffn.ffn_ln_train_bwd.launches
    out, grads = run(tffn.ffn_ln_train)
    torch.cuda.synchronize()
    assert (tffn.ffn_ln_train.launches, tffn.ffn_ln_train_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    ref, ref_grads = run(tffn.ffn_ln_train_plain)
    assert all(g.dtype == torch.float32 for g in grads[1:])
    names = ("out", "dz", "dwd", "dbd", "dw1", "db1", "dw2f", "db2f", "dg1", "dbe1", "dg2", "dbe2")
    for name, got, want in zip(names, (out, *grads), (ref, *ref_grads)):
        if dtype == torch.float32:
            # f32: summation order and atomics' order only
            _bulk_close(got, want, 2e-4, 2e-5, name)
        else:
            # bf16 activations; the kernel rounds dff and dup to bf16 before
            # its products where the plain version keeps f32 gradients
            _bulk_close(got, want, 0.03, 0.005, name)


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernels_match_plain(cuda_card, dtype, rate):
    B, H, T, d = 2, 2, 1024, 128
    g = torch.Generator(device=cuda_card).manual_seed(0)
    q, k, v, do = (torch.randn(B, H, T, d, device=cuda_card, generator=g).to(dtype)
                   for _ in range(4))
    mask = torch.arange(T, device=cuda_card)[None, :] < torch.tensor([[T], [700]], device=cuda_card)
    seed = torch.tensor([777], dtype=torch.int32, device=cuda_card)

    def run(fn):
        qkv = [t.clone().requires_grad_(True) for t in (q, k, v)]
        out = fn(*qkv, mask, rate, seed)
        return (out, *torch.autograd.grad(out, qkv, do))

    n_fwd, n_bwd = tatt.flash_attention.launches, tatt.flash_attention_bwd.launches
    got = run(tatt.flash_attention)
    torch.cuda.synchronize()
    assert (tatt.flash_attention.launches, tatt.flash_attention_bwd.launches) == (n_fwd + 1, n_bwd + 1)
    want = run(tatt.flash_attention_plain)
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        if dtype == torch.float32:
            # f32; online softmax and the split backward sum in other orders
            _bulk_close(a, b, 1e-4, 1e-5, name)
        else:
            # bf16 inputs and outputs; the kernel rounds p (against the
            # running max) and dS to bf16 before its products
            _bulk_close(a, b, 0.02, 0.004, name)


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
