"""The port's HiFi-GAN (vocoder/hifigan.py, ops/hifigan_resblock.py) against
the JAX package: the resblock plain versions against the fused Pallas
kernels in interpret mode, the whole generator against ``Generator.apply``
with weights carried by ``from_jax_hifigan``, and the weight-norm fold. The
CUDA kernels against their plain versions are in test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.ops import pallas_hifigan as pk
from lightningfastspeech2_tpu.vocoder import hifigan as jhg
from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as trb
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_hifigan
from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg
from tests.torch_port_helpers import (
    resblock_block,
    resblock_params,
    tiny_hifigan,
)

C = 8
DILS = (1, 3, 5)


def _signal(seed, B, L, C_):
    return np.random.default_rng(seed).standard_normal((B, L, C_)).astype(np.float32)


@pytest.mark.parametrize("k,L", [(3, 72), (11, 50)])
def test_resblock_plain_matches_pallas_interpret(k, L):
    p = resblock_params(k, C, k, scale=2.0)
    x = _signal(L, 2, L, C)
    w, s, b = pk.resblock_taps(p, k, DILS, 1, jnp.float32)
    ref = np.asarray(pk.fused_resblock(jnp.asarray(x), w, s, b, tile_m=32,
                                       interpret=True))
    tw = trb.prepare_resblock_weights([resblock_block(p, k)], torch.float32)
    out = trb.resblock(torch.from_numpy(x), tw).numpy()   # CPU -> plain
    # f32 throughout; six chained convs in another summation order
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-5)


@pytest.mark.parametrize("fold", [1, 2])
def test_resblock_trio_plain_matches_pallas_interpret(fold):
    """The JAX trio takes a time-folded (B, L/f, f*C) signal; fold and
    unfold it with a reshape around the call."""
    B, L = 2, 48
    ps = [resblock_params(10 + k, C, k, scale=2.0) for k in (3, 7, 11)]
    x = _signal(fold, B, L, C)
    weights, shifts, biases = [], [], []
    for k, p in zip((3, 7, 11), ps):
        w, s, b = pk.resblock_taps(p, k, DILS, fold, jnp.float32)
        weights += w
        shifts += s
        biases.append(b)
    xf = jnp.asarray(x).reshape(B, L // fold, fold * C)
    ref = np.asarray(pk.fused_resblock_trio(
        xf, weights, shifts, jnp.concatenate(biases, 0), n_res=3, tile_m=16,
        interpret=True)).reshape(B, L, C)
    tw = trb.prepare_resblock_weights(
        [resblock_block(p, k) for k, p in zip((3, 7, 11), ps)], torch.float32)
    out = trb.resblock_trio(torch.from_numpy(x), tw).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=2e-5)


def test_resblock_reaches_and_halo():
    """Each conv's reach, in chain order, and the kernel's halo: the
    largest sum over the resblocks (60 samples for k=11, d=(1, 3, 5))."""
    ks = (3, 7, 11)
    tw = trb.prepare_resblock_weights(
        [resblock_block(resblock_params(k, C, k), k) for k in ks], torch.float32)
    assert tw.reaches == ((1, 1, 3, 1, 5, 1), (3, 3, 9, 3, 15, 3), (5, 5, 15, 5, 25, 5))
    assert tw.halo == 60
    one = trb.prepare_resblock_weights([resblock_block(resblock_params(3, C, 3), 3)],
                                       torch.float32)
    assert one.halo == 12


def test_generator_matches_jax_generator():
    jcfg, tcfg = tiny_hifigan(jhg), tiny_hifigan(thg)
    mel = _signal(3, 2, 12, 80)
    gen = jhg.Generator(jcfg)
    params = gen.init(jax.random.PRNGKey(0), jnp.asarray(mel))
    # the N(0, 0.01) init leaves the output near zero; scale the weights
    # so every stage carries signal and tanh stays out of saturation
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 8.0, params)
    ref = np.asarray(gen.apply(params, jnp.asarray(mel)))
    synth = thg.Synthesiser(tcfg, from_jax_hifigan(params, tcfg), device="cpu")
    out = synth(mel) / 32768.0
    assert out.shape == ref.shape == (2, 12 * tcfg.hop_length)
    assert 0.05 < np.abs(ref).max() < 0.99
    # f32 end to end; conv summation orders differ between XLA and torch
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def test_fold_weight_norm_matches_jax():
    g = np.random.default_rng(4)
    v = g.standard_normal((6, 4, 3)).astype(np.float32)
    wg = np.abs(g.standard_normal((6, 1, 1))).astype(np.float32)
    ref = jhg.fold_weight_norm(wg, v)
    np.testing.assert_allclose(thg.fold_weight_norm(wg, v), ref, rtol=1e-6)
    out = thg.fold_weight_norm(torch.from_numpy(wg), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-7)
    # a weight-normed state dict loads as its folded weights
    state = {"conv_pre.weight_g": wg, "conv_pre.weight_v": v, "conv_pre.bias": wg[:, 0, 0]}
    folded = thg.fold_weight_norm_state(state)
    assert set(folded) == {"conv_pre.weight", "conv_pre.bias"}
    np.testing.assert_allclose(folded["conv_pre.weight"], ref, rtol=1e-6)
