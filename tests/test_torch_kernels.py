"""The port's CUDA kernels against their plain PyTorch versions on a Hopper
card: ``probe``, ``ffn_ln``, ``resblock`` and ``resblock_trio``. Marked
``gpu``; the ``cuda_card`` fixture skips them without a card. This file
imports neither JAX nor the JAX package, so it runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_kernels.py -q -m gpu
"""

import math

import pytest
import torch

from lightningfastspeech2_tpu_torch.ops import ffn as tffn
from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as trb
from lightningfastspeech2_tpu_torch.ops.probe import probe
from torch_port_helpers import (  # noqa: F401
    cuda_card,
    ffn_modules,
    ffn_params,
    resblock_block,
    resblock_params,
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
