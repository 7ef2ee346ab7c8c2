"""The port's FFN half (ops/ffn.py) against the JAX package's fused Pallas
kernel (ops/pallas_ffn.py ``fused_ffn_ln``) run in interpret mode on the CPU,
plus the fold of the grouped conv into the down-projection. The CUDA kernel
against its plain version is in test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.ops.pallas_ffn import (
    fold_grouped_into_down as jax_fold,
    fused_ffn_ln,
)
from lightningfastspeech2_tpu_torch.ops import ffn as tffn
from tests.torch_port_helpers import ffn_modules, ffn_params

C, F = 32, 64  # hidden / filter; groups = C (the reference's conv2 quirk)


def _jax(z, p, tile_m):
    a = {k: jnp.asarray(v) for k, v in p.items()}
    return fused_ffn_ln(
        jnp.asarray(z), a["wd"], a["bd"], a["w1"], a["b1"], a["wg"], a["bg"],
        a["w2"], a["b2"], a["g1"], a["be1"], a["g2"], a["be2"],
        tile_m=tile_m, interpret=True)


def _weights(p, dtype):
    return tffn.prepare_ffn_weights(**ffn_modules(p), dtype=dtype)


# (k, T): odd and even k including the flagship's 25; T not a multiple of
# the 16-row tile; T = 7 smaller than the k=25 halo (12 rows)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k,T", [(5, 40), (4, 40), (25, 40), (25, 7)])
def test_ffn_ln_plain_matches_pallas_interpret(k, T, dtype):
    p = ffn_params(k * 100 + T, C, F, k)
    z = np.random.default_rng(T).standard_normal((2, T, C)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = np.asarray(_jax(jnp.asarray(z).astype(jdt), p, 16).astype(jnp.float32))
    zt = torch.from_numpy(z).to(tdt)
    out = tffn.ffn_ln(zt, _weights(p, tdt))   # CPU tensor -> plain version
    assert out.dtype == tdt and out.shape == (2, T, C)
    out = out.float().numpy()
    if dtype == "float32":
        # f32 everywhere; only summation order and the LN's multiply order
        # differ (outputs are O(1) after LN2)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    else:
        # bf16 rounding points are the same, but an f32 difference of one
        # ulp before a rounding can flip a bf16 ulp (2^-7 relative): allow a
        # few ulps at |v| <= 4 and require the bulk to agree
        np.testing.assert_allclose(out, ref, rtol=0, atol=0.07)
        assert np.mean(np.abs(out - ref)) < 3e-3


def test_fold_grouped_into_down_matches_jax():
    p = ffn_params(0, C, F, 3)
    m = ffn_modules(p)
    w2f, b2f = tffn.fold_grouped_into_down(
        m["conv2_group"].weight, m["conv2_group"].bias,
        m["conv2_point"].weight, m["conv2_point"].bias, groups=C)
    jw, jb = jax_fold(jnp.asarray(p["wg"]), jnp.asarray(p["bg"]),
                      jnp.asarray(p["w2"]), jnp.asarray(p["b2"]))
    # f32 products of the same terms, in another summation order
    np.testing.assert_allclose(w2f.numpy(), np.asarray(jw), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(b2f.numpy(), np.asarray(jb), rtol=1e-5, atol=1e-6)
    # and the fold equals grouped conv then down-projection applied in turn
    h = torch.randn(3, F, generator=torch.Generator().manual_seed(0))
    G, ci = C, F // C
    wg = m["conv2_group"].weight[:, :, 0].reshape(G, F // G, ci)
    hg = torch.einsum("goi,tgi->tgo", wg, h.reshape(3, G, ci)).reshape(3, F) \
        + m["conv2_group"].bias
    two_step = hg @ m["conv2_point"].weight[:, :, 0].T + m["conv2_point"].bias
    np.testing.assert_allclose((h @ w2f + b2f).numpy(), two_step.numpy(),
                               rtol=1e-5, atol=1e-5)
