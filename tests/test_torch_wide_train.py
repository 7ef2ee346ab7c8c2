"""The widths past C = 256 (ROADMAP B9t, B16w) against the JAX package on
the CPU: the training FFN half's plain versions (the CPU path of
``ffn_ln_train`` and the staged backward ``ffn_ln_train_bwd_plain``, the
card kernels' oracles) at C = 384 and 768 against ``fused_ffn_ln_train`` in
interpret mode; the plain resblock at C = 512 against ``fused_resblock`` in
interpret mode; a HiFi-GAN generator at ``upsample_initial_channel`` 1024
against the JAX ``Generator``; and the train step at hidden 384, filter
768, which the port's FFN gate now sends to the fused call, against the
JAX step. The CUDA kernels against these plain versions are in
test_torch_kernels.py."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from lightningfastspeech2_tpu.models.fastspeech2 import make_dummy_batch as jax_dummy_batch
from lightningfastspeech2_tpu.ops import pallas_hifigan as pk
from lightningfastspeech2_tpu.ops.pallas_ffn import fused_ffn_ln_train
from lightningfastspeech2_tpu.train.step import create_train_state as jax_create_state
from lightningfastspeech2_tpu.train.step import make_train_step as jax_make_step
from lightningfastspeech2_tpu.vocoder import hifigan as jhg
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
from lightningfastspeech2_tpu_torch.models.layers import ffn_fused_ok
from lightningfastspeech2_tpu_torch.ops import ffn as tffn
from lightningfastspeech2_tpu_torch.ops import hifigan_resblock as trb
from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastspeech2, from_jax_hifigan
from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg
from tests.test_torch_train_ffn import _torch_grads
from tests.test_torch_train_step import _adam_mu
from tests.torch_port_helpers import (
    ffn_modules,
    ffn_params,
    resblock_block,
    resblock_params,
    seeded_params,
    tiny_config,
    torch_threads,
)

NAMES = ("z", "wd", "bd", "w1", "b1", "wg", "bg", "w2", "b2", "g1", "be1", "g2", "be2")
SEED, K, B, T = 987654, 5, 2, 32


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_ffn(args, dout, rate):
    def f(*a):
        return fused_ffn_ln_train(*a, SEED, 1e-5, rate, 16, True)

    out, vjp = jax.vjp(f, *args)
    return out, vjp(dout.astype(out.dtype))


def _inputs(C, F, dtype):
    p = ffn_params(C + F, C, F, K)
    rng = np.random.default_rng(C)
    z, dout = (rng.standard_normal((B, T, C)).astype(np.float32) for _ in range(2))
    args = [jnp.asarray(z).astype(jnp.dtype(dtype))] + [jnp.asarray(p[n]) for n in NAMES[1:]]
    return p, z, dout, args


def _grads_close(grads, ref_grads, dtype):
    # test_torch_train_ffn.py's tolerances: f32 summation order only; bf16
    # the same rounding points, a one-ulp flip carried by the products (3 %
    # of the largest gradient, the bulk within 0.5 %)
    for name, ref in zip(NAMES, ref_grads):
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        got = grads[name]
        assert got.shape == ref.shape, name
        top = np.abs(ref).max()
        if dtype == "float32":
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * max(top, 1.0), err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=0, atol=0.03 * top, err_msg=name)
            assert np.mean(np.abs(got - ref)) <= 0.005 * top, name


def _holders(p):
    mods = ffn_modules(p)
    for m in mods.values():
        for t in vars(m).values():
            t.requires_grad_(True)
    return mods


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("C,F", [(384, 768), (768, 768)])
def test_wide_ffn_train_matches_pallas_interpret(C, F, rate, dtype):
    """``ffn_ln_train`` on the CPU (``ffn_ln_train_plain``, autograd) at the
    widths the JAX gate trains fused and the port's gate now takes."""
    assert tffn.ffn_train_fits(C, F, K, getattr(torch, dtype))
    p, z, dout, args = _inputs(C, F, dtype)
    ref_out, ref_grads = _jax_ffn(args, jnp.asarray(dout), rate)
    mods = _holders(p)
    tdt = getattr(torch, dtype)
    zt = torch.from_numpy(z).to(tdt).requires_grad_(True)
    out = tffn.ffn_ln_train(zt, tffn.ffn_train_params(**mods),
                            torch.tensor([SEED], dtype=torch.int32), rate)
    out.backward(torch.from_numpy(dout).to(tdt))
    ref_out = np.asarray(ref_out.astype(jnp.float32))
    out = out.detach().float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(out, ref_out, rtol=0, atol=2e-5)
    else:
        np.testing.assert_allclose(out, ref_out, rtol=0, atol=0.07)
        assert np.mean(np.abs(out - ref_out)) < 3e-3
    _grads_close(_torch_grads(mods, zt), ref_grads, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C,F", [(384, 768), (768, 768)])
def test_wide_staged_backward_matches_pallas_interpret(C, F, dtype):
    """``ffn_ln_train_bwd_plain`` (the kernels' stages with their rounding
    points) against the TPU kernel's VJP at rate 0.1, carried back through
    the grouped-conv fold to the modules."""
    p, z, dout, args = _inputs(C, F, dtype)
    _, ref_grads = _jax_ffn(args, jnp.asarray(dout), 0.1)
    mods = _holders(p)
    params = tffn.ffn_train_params(**mods)
    tdt = getattr(torch, dtype)
    dz, *dp = tffn.ffn_ln_train_bwd_plain(torch.from_numpy(dout).to(tdt),
                                          torch.from_numpy(z).to(tdt), params,
                                          torch.tensor([SEED], dtype=torch.int32), 0.1)
    assert dz.dtype == tdt and all(g.dtype == torch.float32 for g in dp)
    torch.autograd.backward(params, dp)
    zt = torch.zeros_like(dz)
    zt.grad = dz
    _grads_close(_torch_grads(mods, zt), ref_grads, dtype)


def test_resblock_plain_matches_pallas_interpret_at_c512():
    """The plain resblock at C = 512 (the wide route's oracle on the card)
    against the fused TPU kernel in interpret mode."""
    C, k, L = 512, 3, 64
    p = resblock_params(C, C, k, scale=2.0)
    x = np.random.default_rng(5).standard_normal((1, L, C)).astype(np.float32)
    w, s, b = pk.resblock_taps(p, k, (1, 3, 5), 1, jnp.float32)
    ref = np.asarray(pk.fused_resblock(jnp.asarray(x), w, s, b, tile_m=32, interpret=True))
    tw = trb.prepare_resblock_weights([resblock_block(p, k)], torch.float32)
    assert (tw.channels, trb.tile_plan(tw, 1, L).route) == (512, "gemm")
    out = trb.resblock(torch.from_numpy(x), tw).numpy()   # CPU -> plain
    # f32 throughout; six chained convs of 1536 terms each in another
    # order, and the chain reaches |x| ~ 10: 2e-5 of the largest output
    # (test_torch_kernels.py's f32 resblock tolerance)
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5 * np.abs(ref).max())


def test_generator_at_1024_channels_matches_jax():
    """HiFi-GAN V1's structure at ``upsample_initial_channel`` 1024 (stage 0
    at C = 512 on the wide route, ``resblock`` three times a call) against the JAX
    ``Generator`` on a 4-frame mel, weights carried by ``from_jax_hifigan``."""
    jcfg = jhg.HifiGanConfig(upsample_initial_channel=1024)
    tcfg = thg.HifiGanConfig(upsample_initial_channel=1024)
    mel = np.random.default_rng(4).standard_normal((1, 4, 80)).astype(np.float32)
    gen = jhg.Generator(jcfg)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0), jnp.asarray(mel))
    params = seeded_params(shapes, 1024)
    ref = np.asarray(jax.jit(gen.apply)(params, jnp.asarray(mel)))
    synth = thg.Synthesiser(tcfg, from_jax_hifigan(params, tcfg), device="cpu")
    stages = synth.model.stage_weights
    assert [(len(s), s[0].channels) for s in stages] == [(3, 512), (3, 256), (1, 128), (1, 64)]
    out = synth(mel) / 32768.0
    assert out.shape == ref.shape == (1, 4 * tcfg.hop_length)
    assert 0.05 < np.abs(ref).max() < 0.99
    # f32 end to end; conv summation orders differ between XLA and torch
    np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)


def _hidden_384(C):
    cfg = tiny_config(
        C, encoder=C.StackConfig(hidden=384, heads=2, layers=1, kernel_sizes=(3,),
                                 conv_filter_size=768),
        decoder=C.StackConfig(hidden=384, heads=2, layers=1, kernel_sizes=(5,),
                              conv_filter_size=768))
    m = cfg.model
    return C.replace(cfg, **{
        "model.encoder": C.replace(m.encoder, dropout=0.0),
        "model.decoder": C.replace(m.decoder, dropout=0.0),
        "model.variance": C.replace(m.variance, dropouts=(0.0,) * len(m.variance.variances)),
        "model.duration": C.replace(m.duration, dropout=0.0),
        "train.warmup_steps": 1,
    })


def test_train_step_at_hidden_384_matches_jax(monkeypatch):
    """The slice whole: one train step at hidden 384, filter 768, 1 + 1
    blocks (B = 2, 128 frames), whose FFN halves the port's gate sends to
    ``ffn_ln_train`` (it raised B9t before), against the JAX step with the
    weights carried across: the losses, ``grad_norm``, the gradients (each
    side's first Adam moment) and the update
    (test_torch_train_step.py's comparison)."""
    jcfg, tcfg = _hidden_384(JC), _hidden_384(TC)
    assert JC.to_dict(jcfg) == TC.to_dict(tcfg)
    assert ffn_fused_ok(384, 768, True)
    batch = jax_dummy_batch(jcfg.model, batch_size=2, n_phones=8, n_frames=128, seed=0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxFastSpeech2(jcfg.model)
    state, optimizer = jax_create_state(model, jcfg, jax.random.PRNGKey(0), jb)
    params0 = jax.tree_util.tree_map(np.array, state.params)
    jstate, jm = jax_make_step(model, jcfg, optimizer, donate=False)(
        state, jb, jax.random.PRNGKey(1))

    port = build_fastspeech2(tcfg.model, device="cpu",
                             state_dict=from_jax_fastspeech2(params0, tcfg.model))
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    widths = []
    plain = tffn.ffn_ln_train_plain
    monkeypatch.setattr(tffn, "ffn_ln_train_plain",
                        lambda z, *a, **kw: widths.append(z.shape[-1]) or plain(z, *a, **kw))
    st, tm = make_train_step(port, tcfg)(create_train_state(port, tcfg), batch,
                                         torch.Generator().manual_seed(0))
    # both blocks' FFN halves took the fused call (on the CPU its plain
    # version), not the unfused modules
    assert widths == [384, 384]
    # f32 on both sides, another summation order
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-5, atol=1e-6,
                                   err_msg=key)
    after_ref = from_jax_fastspeech2(jax.tree_util.tree_map(np.array, jstate.params),
                                     tcfg.model)
    before_ref = from_jax_fastspeech2(params0, tcfg.model)
    grad_ref = from_jax_fastspeech2(_adam_mu(jstate.opt_state), tcfg.model)
    adam = {n: st.optimizer.state[p]["exp_avg"] for n, p in port.named_parameters()
            if p in st.optimizer.state}
    after = port.state_dict()
    for name, ref1 in after_ref.items():
        g_ref = grad_ref[name] / 0.1
        g = adam[name].numpy() / 0.1 if name in adam else np.zeros_like(g_ref)
        np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=1e-7, err_msg=name)
        # an AdamW step of lr 1e-4 moves an element by about lr * g / |g|:
        # compared where |g| > 1e-6, to 2 % of lr
        sure = np.abs(g_ref) > 1e-6
        upd, upd_ref = (after[name] - before[name]).numpy(), ref1 - before_ref[name]
        np.testing.assert_allclose(upd[sure], upd_ref[sure], rtol=0, atol=2e-6, err_msg=name)
