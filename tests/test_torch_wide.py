"""The pieces the other presets need, against the JAX package on the CPU:
the FFN gate (the JAX ``_fused_ffn_ok`` as it runs on a chip), the FFN half
at C = 640 and flash attention at head dim 256 against the JAX kernels in
interpret mode, the flash routes over every head dim the gate admits, the
bf16-moment AdamW against optax, and the ResBlock2 HiFi-GAN generator."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightningfastspeech2_tpu.models import layers as jlayers
from lightningfastspeech2_tpu.ops import kernel_gate
from lightningfastspeech2_tpu.ops.pallas_attention import flash_attention as jflash
from lightningfastspeech2_tpu.ops.pallas_ffn import fused_ffn_ln
from lightningfastspeech2_tpu.vocoder import hifigan as jhg
from lightningfastspeech2_tpu_torch.kernels import build
from lightningfastspeech2_tpu_torch.models.layers import ffn_fused_ok
from lightningfastspeech2_tpu_torch.ops import attention as tatt
from lightningfastspeech2_tpu_torch.ops import ffn as tffn
from lightningfastspeech2_tpu_torch.train.optim import AdamWBf16Mu
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_hifigan
from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg
from tests.torch_port_helpers import ffn_modules, ffn_params

GATE_WIDTHS = [(256, 1024), (640, 2560), (384, 1024), (96, 384), (640, 1024), (512, 1024),
               (768, 768), (1024, 512),
               # serving past C = 768 (the chain with its long-row LN kernels)
               (896, 896), (1024, 1024), (1024, 4096), (2048, 2048), (4096, 4096),
               # training past C = 768 where the JAX estimate admits it (F < C)
               (896, 768)]


@pytest.mark.parametrize("training", [False, True], ids=["serve", "train"])
@pytest.mark.parametrize("C,F", GATE_WIDTHS)
def test_ffn_gate_is_the_jax_gate_on_a_chip(monkeypatch, C, F, training):
    """The JAX gate with its backend switched to a chip's (Pallas on, not
    interpreted), in both dtypes; where it admits training widths, the
    port's training kernels take them (C >= 896 with F < C too: (1024,
    512), (896, 768))."""
    monkeypatch.setattr(kernel_gate, "pallas_enabled", lambda: True)
    monkeypatch.setattr(kernel_gate, "pallas_interpret", lambda: False)
    monkeypatch.delenv("LFS2_FUSED_FFN", raising=False)
    want = jlayers._fused_ffn_ok(C, F, train=training)
    assert ffn_fused_ok(C, F, training) == want
    for dtype in (torch.float32, torch.bfloat16):
        if training and want:
            assert tffn.ffn_train_fits(C, F, 5, dtype)


def _ffn_ln_against_pallas_interpret(C, F, k, T, dtype):
    p = ffn_params(C, C, F, k)
    z = np.random.default_rng(C).standard_normal((1, T, C)).astype(np.float32)
    a = {n: jnp.asarray(v) for n, v in p.items()}
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref = fused_ffn_ln(jnp.asarray(z).astype(jdt), a["wd"], a["bd"], a["w1"], a["b1"], a["wg"],
                       a["bg"], a["w2"], a["b2"], a["g1"], a["be1"], a["g2"], a["be2"],
                       tile_m=16, interpret=True)
    ref = np.asarray(ref.astype(jnp.float32))
    w = tffn.prepare_ffn_weights(**ffn_modules(p), dtype=tdt)
    out = tffn.ffn_ln(torch.from_numpy(z).to(tdt), w).float().numpy()
    if dtype == "float32":
        # summation order only (test_torch_ffn.py's tolerance)
        np.testing.assert_allclose(out, ref, rtol=0, atol=2e-5)
    else:
        # the same rounding points; a one-ulp f32 difference before a bf16
        # rounding can flip a bf16 ulp (test_torch_ffn.py's tolerance)
        np.testing.assert_allclose(out, ref, rtol=0, atol=0.07)
        assert np.mean(np.abs(out - ref)) < 3e-3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_ln_plain_matches_pallas_interpret_at_c640(dtype):
    _ffn_ln_against_pallas_interpret(640, 2560, 17, 32, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_ln_plain_matches_pallas_interpret_at_c1024(dtype):
    # a hidden-1024 model's serving half (the chain's long-row LN kernels
    # on the card)
    assert tffn.serve_ok(1024)
    _ffn_ln_against_pallas_interpret(1024, 1024, 17, 64, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ffn_ln_train_matches_pallas_interpret_at_c1024(dtype):
    """``ffn_ln_train`` on the CPU (``ffn_ln_train_plain``, autograd) at C =
    F = 1024, the card's chain with its long-row backward there: the
    forward and the VJP at rate 0.1 against ``fused_ffn_ln_train`` in
    interpret mode, one item of 48 frames, with test_torch_wide_train.py's
    tolerances."""
    from tests.test_torch_train_ffn import _torch_grads
    from tests.test_torch_wide_train import NAMES, SEED, K, _grads_close, _holders, _jax_ffn

    C = F = 1024
    p = ffn_params(C + F, C, F, K)
    rng = np.random.default_rng(C)
    z, dout = (rng.standard_normal((1, 48, C)).astype(np.float32) for _ in range(2))
    args = [jnp.asarray(z).astype(jnp.dtype(dtype))] + [jnp.asarray(p[n]) for n in NAMES[1:]]
    ref_out, ref_grads = _jax_ffn(args, jnp.asarray(dout), 0.1)
    mods, tdt = _holders(p), getattr(torch, dtype)
    zt = torch.from_numpy(z).to(tdt).requires_grad_(True)
    out = tffn.ffn_ln_train(zt, tffn.ffn_train_params(**mods),
                            torch.tensor([SEED], dtype=torch.int32), 0.1)
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
def test_flash_attention_plain_matches_pallas_interpret_at_head_dim_256(dtype):
    B, H, T, d, rate = 1, 1, 128, 256, 0.1
    rng = np.random.default_rng(256)
    q, k, v, do = (rng.standard_normal((B, H, T, d)).astype(np.float32) for _ in range(4))
    mask = np.arange(T)[None, :] < 90
    seed = 4242
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)

    def f(q_, k_, v_):
        return jflash(q_, k_, v_, jnp.asarray(mask), dropout_rate=rate, seed=seed,
                      interpret=True)

    ref, vjp = jax.vjp(f, *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    ref_grads = vjp(jnp.asarray(do).astype(jdt))
    qt, kt, vt = (torch.from_numpy(a).to(tdt).requires_grad_(True) for a in (q, k, v))
    out = tatt.flash_attention_plain(qt, kt, vt, torch.from_numpy(mask), rate,
                                     torch.tensor([seed], dtype=torch.int32))
    out.backward(torch.from_numpy(do).to(tdt))
    pairs = [("o", out, ref)] + [(n, t.grad, g) for n, t, g in
                                 zip(("dq", "dk", "dv"), (qt, kt, vt), ref_grads)]
    for name, got, want in pairs:
        got = got.detach().float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        top = np.abs(want).max()
        # test_torch_attention.py's tolerances at head dim 128
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0, atol=2e-5 * max(top, 1.0),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=0.02 * top, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", range(128, 1025, 128))
def test_kernel_route_takes_every_head_dim_the_gate_admits(d, dtype):
    """flash_ok admits any head dim that is a multiple of 128 (the JAX
    gate); a kernel takes each: the tensor-core routes at 128 and 256, the
    CUDA-core route past them, all built from the repository's sources."""
    qkv = [torch.zeros(1, 1, 1024, d, dtype=dtype) for _ in range(3)]
    route = tatt.kernel_route(*qkv)
    assert route == (tatt.ROUTES if d <= 256 else tatt.WIDE_ROUTES)[dtype]
    assert tatt.LIBRARY[route] in build.SOURCES


def test_adamw_bf16_moments_matches_optax():
    """Three steps against optax's adamw with mu_dtype=bfloat16 on the same
    gradients: the parameters, and the first moment bit for bit."""
    g = np.random.default_rng(7)
    p0 = {"w": g.standard_normal((64, 48)).astype(np.float32),
          "b": g.standard_normal(48).astype(np.float32)}
    grads = [{k: (g.standard_normal(v.shape) * 0.3).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    lr, betas, eps, wd = 1e-3, (0.9, 0.98), 1e-8, 0.01
    tx = optax.adamw(lr, b1=betas[0], b2=betas[1], eps=eps, weight_decay=wd,
                     mu_dtype=jnp.bfloat16)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    st = tx.init(jp)
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
    opt = AdamWBf16Mu(params.values(), lr=lr, betas=betas, eps=eps, weight_decay=wd)
    for gr in grads:
        upd, st = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, st, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in params.items():
            p.grad = torch.from_numpy(gr[k])
        opt.step()
    mu = st[0].mu
    for k, p in params.items():
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6,
                                   err_msg=k)
        assert opt.state[p]["exp_avg"].dtype == torch.bfloat16
        np.testing.assert_array_equal(opt.state[p]["exp_avg"].float().numpy(),
                                      np.asarray(mu[k].astype(jnp.float32)), err_msg=k)


def test_adamw_bf16_moments_steps_each_parameter_by_its_own_count():
    """A parameter without a gradient skips a step and keeps its own step
    count (its bias correction): the grouped update equals one optimizer
    per parameter, bit for bit."""
    g = np.random.default_rng(8)
    p0 = [g.standard_normal((16, 8)).astype(np.float32), g.standard_normal(8).astype(np.float32)]
    grads = [[(g.standard_normal(v.shape) * 0.3).astype(np.float32) for v in p0]
             for _ in range(3)]
    kw = dict(lr=1e-3, betas=(0.9, 0.98), eps=1e-8, weight_decay=0.01)
    both = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in p0]
    alone = [torch.nn.Parameter(torch.from_numpy(v.copy())) for v in p0]
    opt = AdamWBf16Mu(both, **kw)
    opts = [AdamWBf16Mu([p], **kw) for p in alone]
    for i, gr in enumerate(grads):
        for j in range(2):
            has = not (j == 1 and i == 0)   # the second parameter skips the first step
            both[j].grad = torch.from_numpy(gr[j]) if has else None
            alone[j].grad = torch.from_numpy(gr[j]) if has else None
        opt.step()
        for o in opts:
            o.step()
    assert [opt.state[p]["step"] for p in both] == [3, 2]
    for a, b, o in zip(both, alone, opts):
        assert torch.equal(a, b)
        assert torch.equal(opt.state[a]["exp_avg"], o.state[b]["exp_avg"])


def test_resblock2_generator_matches_jax():
    """A ResBlock2 generator (HiFi-GAN V3's block, at test size) against the
    JAX ``Generator.apply`` on a 16-frame mel, weights carried across by
    ``from_jax_hifigan``."""
    kw = dict(resblock="2", upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
              upsample_initial_channel=32, resblock_kernel_sizes=(3, 5),
              resblock_dilation_sizes=((1, 2), (2, 6)))
    jcfg, tcfg = jhg.HifiGanConfig(**kw), thg.HifiGanConfig(**kw)
    mel = np.random.default_rng(2).standard_normal((1, 16, 80)).astype(np.float32)
    gen = jhg.Generator(jcfg)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0), jnp.asarray(mel))
    g = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: (g.standard_normal(s.shape) * 0.1).astype(np.float32), shapes)
    ref = np.asarray(jax.jit(gen.apply)(params, jnp.asarray(mel)))
    synth = thg.Synthesiser(tcfg, state_dict=from_jax_hifigan(params, tcfg), device="cpu")
    assert not synth.model.stage_weights   # plain convs: no resblock kernel stacks
    with torch.no_grad():
        out = synth.model(torch.from_numpy(mel)).numpy()
    assert out.shape == ref.shape == (1, 16 * 16)
    # f32 through two frameworks' convs (test_torch_model.py's tolerance)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    assert np.abs(ref).max() > 0.05
