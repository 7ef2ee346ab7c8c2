"""The port's flash attention (ops/attention.py ``flash_attention_plain``,
the CPU path of ``flash_attention``) against the JAX package's
``flash_attention`` run in interpret mode on the CPU: the dropout hash bit
for bit, the forward and dq/dk/dv with a ragged key mask. The CUDA kernels
against the plain version are in test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.ops.pallas_attention import _dropout_keep, flash_attention as jflash
from lightningfastspeech2_tpu_torch.ops import attention as tatt


@pytest.mark.parametrize("rate", [0.1, 0.5])
@pytest.mark.parametrize("seed,b,h,H", [(0, 0, 0, 2), (424242, 3, 1, 2),
                                         (2 ** 31 - 2, 7, 1, 2)])
def test_attention_keep_bit_exact(seed, b, h, H, rate):
    # query rows up to 2816 (the longest frame bucket), key columns up to
    # 1024; the last case's int32 seed + b * H + h wraps past 2**31
    seed_bh = jnp.int32(seed) + jnp.int32(b * H + h)
    ref = np.asarray(_dropout_keep((2816, 1024), rate, seed_bh, 0))
    sbh = torch.tensor((seed + b * H + h) & 0xFFFFFFFF, dtype=torch.int64)
    out = tatt.attn_keep_hash(torch.arange(2816), torch.arange(1024), sbh, rate).numpy()
    np.testing.assert_array_equal(out, ref)
    # the (B, H, T, T) mask of the plain version picks the same (b, h) slice
    full = tatt.attention_keep_mask(8, H, 256, rate, torch.tensor([seed], dtype=torch.int32))
    np.testing.assert_array_equal(full[b, h].numpy(), ref[:256, :256])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_flash_attention_plain_matches_pallas_interpret(dtype, rate):
    B, H, T, d = 1, 2, 256, 16
    rng = np.random.default_rng(11)
    q, k, v, do = (rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(4))
    mask = np.arange(T)[None, :] < 201                 # ragged: 55 padded keys
    seed = 31337
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def f(q_, k_, v_):
        return jflash(q_, k_, v_, jnp.asarray(mask), dropout_rate=rate, seed=seed,
                      interpret=True)

    ref, vjp = jax.vjp(f, *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do).astype(jdt))

    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    out = tatt.flash_attention(qt, kt, vt, torch.from_numpy(mask), rate,
                               torch.tensor([seed], dtype=torch.int32))
    assert out.dtype == tdt and out.shape == (B, H, T, d)
    out.backward(torch.from_numpy(do).to(tdt))
    pairs = [("o", out, ref)] + [(n, t.grad, g) for n, t, g in
                                 zip(("dq", "dk", "dv"), (qt, kt, vt), ref_grads)]
    for name, got, want in pairs:
        got = got.detach().float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        top = np.abs(want).max()
        if dtype == "float32":
            # f32 throughout; the kernel normalises after P.V and sums
            # dK/dV per query tile, autograd in other orders
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * max(top, 1.0),
                                       err_msg=name)
        else:
            # bf16 inputs and outputs; the TPU kernel also accumulates dK/dV
            # across query tiles in bf16 and rounds P before P.V and dS
            # before its products, the plain version keeps P and the
            # gradients f32 (one rounding at the end): 2 % of the largest
            # value, the bulk within 0.4 %
            np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * top, err_msg=name)
            assert np.mean(np.abs(got - want)) <= 0.004 * top, name
