"""HiFi-GAN stages at widths the resblock kernels are not built for
(ROADMAP B16): ``upsample_initial_channel`` 384 (stages 192, 96, 48, 24)
and 200 (100, 50, 25, 12). The port serves each stage zero-padded to the
next kernel width; on the CPU that route runs the kernels' plain versions
on the padded weights. Held to the JAX ``Generator`` (f32, weights carried
by ``from_jax_hifigan``), with the padded channels exactly 0 at every
stage, and a direct resblock call at its own C held to the JAX fused
kernel in interpret mode."""

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
from tests.torch_port_helpers import resblock_block, resblock_params, seeded_params, torch_threads

# upsample_initial_channel -> (each stage's padded width, launches a stage)
WIDTHS = {384: ((256, 128, 64, 32), (3, 1, 1, 1)),
          200: ((128, 64, 32, 16), (1, 1, 1, 1))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def test_kernel_channels():
    want = {4: 8, 8: 8, 12: 16, 24: 32, 25: 32, 40: 64, 48: 64, 96: 128, 100: 128,
            192: 256, 256: 256, 384: 384, 512: 512}
    assert {c: trb.kernel_channels(c) for c in want} == want


@pytest.mark.parametrize("channels", sorted(WIDTHS))
def test_padded_generator_matches_jax(channels, monkeypatch):
    jcfg = jhg.HifiGanConfig(upsample_initial_channel=channels)
    tcfg = thg.HifiGanConfig(upsample_initial_channel=channels)
    mel = np.random.default_rng(3).standard_normal((2, 12, 80)).astype(np.float32)
    gen = jhg.Generator(jcfg)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0), jnp.asarray(mel))
    params = seeded_params(shapes, channels)
    ref = np.asarray(jax.jit(gen.apply)(params, jnp.asarray(mel)))
    synth = thg.Synthesiser(tcfg, from_jax_hifigan(params, tcfg), device="cpu")
    model = synth.model
    widths, launches = WIDTHS[channels]
    assert [s[0].channels for s in model.stage_weights] == list(widths)
    assert [len(s) for s in model.stage_weights] == list(launches)

    # every resblock call's input and output: the real channels first, the
    # padded ones exactly 0
    seen = []
    for name in ("resblock", "resblock_trio"):
        wrapped = getattr(thg, name)

        def record(x, w, wrapped=wrapped):
            out = wrapped(x, w)
            seen.append((w.real_channels, x, out))
            return out

        monkeypatch.setattr(thg, name, record)
    copies = trb.resblock.pad_copies + trb.resblock_trio.pad_copies
    out = synth(mel) / 32768.0
    assert trb.resblock.pad_copies + trb.resblock_trio.pad_copies == copies  # no signal padded
    assert [x.shape[-1] for _, x, _ in seen] == [P for P, n in zip(widths, launches)
                                                 for _ in range(n)]
    for C, x, y in seen:
        assert torch.count_nonzero(x[..., C:]) == 0 and torch.count_nonzero(y[..., C:]) == 0
        assert torch.count_nonzero(y[..., :C]) > 0
    assert out.shape == ref.shape == (2, 12 * tcfg.hop_length)
    assert 0.05 < np.abs(ref).max() < 0.99
    # f32 end to end; conv summation orders differ between XLA and torch,
    # and the padded convs add zeros in another order again
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    # the training route (the live, unpadded parameters) agrees
    with torch.no_grad():
        train = model(torch.from_numpy(mel), train_route=True).numpy()
    np.testing.assert_allclose(train, ref, rtol=0, atol=2e-5)
    # the state dict is the unpadded one
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == {
        k: v.shape for k, v in from_jax_hifigan(params, tcfg).items()}


@pytest.mark.parametrize("C,ks", [(24, (3,)), (40, (3, 7, 11))])
def test_direct_call_pads_x_once(C, ks):
    """``resblock`` / ``resblock_trio`` on x at the resblocks' own C pad it
    once in the wrapper and cut the output back; held to the JAX fused
    kernels (interpret mode) at that C."""
    B, L = 2, 40
    ps = [resblock_params(C + k, C, k, scale=2.0) for k in ks]
    x = np.random.default_rng(C).standard_normal((B, L, C)).astype(np.float32)
    weights, shifts, biases = [], [], []
    for k, p in zip(ks, ps):
        w, s, b = pk.resblock_taps(p, k, (1, 3, 5), 1, jnp.float32)
        weights += w
        shifts += s
        biases.append(b)
    if len(ks) == 1:
        ref = pk.fused_resblock(jnp.asarray(x), weights, shifts, biases[0], tile_m=16,
                                interpret=True)
    else:
        ref = pk.fused_resblock_trio(jnp.asarray(x), weights, shifts, jnp.concatenate(biases, 0),
                                     n_res=len(ks), tile_m=16, interpret=True)
    tw = trb.prepare_resblock_weights([resblock_block(p, k) for k, p in zip(ks, ps)],
                                      torch.float32)
    assert (tw.real_channels, tw.channels) == (C, trb.kernel_channels(C))
    kernel = trb.resblock if len(ks) == 1 else trb.resblock_trio
    before = kernel.pad_copies
    out = kernel(torch.from_numpy(x), tw)
    assert kernel.pad_copies == before + 1 and out.shape == (B, L, C) and out.is_contiguous()
    # f32 throughout; the chained convs in another summation order
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=2e-5)
    # at the padded width the wrapper copies nothing, and the padded
    # channels come back 0
    xp = torch.nn.functional.pad(torch.from_numpy(x), (0, tw.channels - C))
    outp = kernel(xp, tw)
    assert kernel.pad_copies == before + 1
    assert torch.equal(outp[..., :C], out) and torch.count_nonzero(outp[..., C:]) == 0
