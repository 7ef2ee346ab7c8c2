"""HiFi-GAN training in the port (vocoder/hifigan_train.py) against the JAX
package's (``lightningfastspeech2_tpu/vocoder/hifigan_train.py``), in f32
on the CPU at the tiny generator of tests/test_hifigan_train.py (rates
(8, 2), 16 initial channels, one resblock of k = 3, dilations (1, 3),
segments of 1024, B = 2) with the full-width discriminators:

(a) the discriminators' logits and every feature map, weights carried by
    ``from_jax_discriminators``, at T = 1024 and at T = 1000 (the period
    discriminators reflect-pad), within 1e-5 of each tensor's largest
    value: the same f32 convolutions in another summation order;
(b) the four losses on the same arrays, within 1e-6 relative;
(c) one full trainer step from the JAX trainer's own initial weights:
    the losses within 1e-4 relative, the updated parameters within 2 lr +
    1e-7 everywhere and within 1e-6 where the JAX gradient exceeds 1e-3
    of its tensor's largest (Adam's first update is lr g / (|g| + eps): a
    tiny gradient whose sign differs moves a weight 2 lr the other way);
(d) the optimizer against optax.adamw(exponential_decay(...)) over 3
    steps of fixed gradients, within 1e-7 (weights ~0.1);
(e) the generator's training route: every parameter gets a non-zero
    gradient, in f32 and bf16, for V1 and the tiny config; it equals the
    serving route (f32 within tests/test_torch_hifigan.py's 2e-5, bf16
    within four bf16 ulps of the largest output, the kernel tests'
    tolerance, as one flipped rounding carries through the residual
    chain), and so does a serving route rebuilt by ``prepare()`` after an
    optimizer step.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from lightningfastspeech2_tpu.core.config import AudioConfig as JAudioConfig
from lightningfastspeech2_tpu.vocoder import hifigan as jhg
from lightningfastspeech2_tpu.vocoder import hifigan_train as jht
from lightningfastspeech2_tpu_torch.core.config import AudioConfig
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_discriminators, from_jax_hifigan
from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg
from lightningfastspeech2_tpu_torch.vocoder import hifigan_train as tht
from tests.torch_port_helpers import torch_threads

SEGMENT, B, LR = 1024, 2, 2e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _tiny(hg):
    return hg.HifiGanConfig(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                            upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                            resblock_dilation_sizes=((1, 3),), num_mels=80)


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _recording(tx):
    """``tx`` with the gradients of its latest update kept in its state."""
    def init(params):
        return jax.tree_util.tree_map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope="module")
def jax_step():
    """One step of the JAX trainer: its weights before and after, its
    gradients (kept by a recording transform ahead of its own adamw) and
    its metrics."""
    jt = jht.HifiGanTrainer(_tiny(jhg), jht.HifiGanTrainConfig(segment_size=SEGMENT, lr=LR),
                            JAudioConfig(), rng=jax.random.PRNGKey(0))
    gen0, disc0 = _numpy(jt.gen_params), _numpy(jt.disc_params)
    jt.gen_tx, jt.disc_tx = _recording(jt.gen_tx), _recording(jt.disc_tx)
    jt.gen_opt, jt.disc_opt = jt.gen_tx.init(jt.gen_params), jt.disc_tx.init(jt.disc_params)
    g = np.random.default_rng(2)
    mel = g.standard_normal((B, SEGMENT // 16, 80)).astype(np.float32)
    wav = np.repeat((0.3 * np.sin(2 * np.pi * 220 * np.arange(SEGMENT) / 22050)
                     + 0.01 * g.standard_normal(SEGMENT))[None], B, 0).astype(np.float32)
    metrics = {k: float(v) for k, v in jt.train_step(jnp.asarray(mel), jnp.asarray(wav)).items()}
    return SimpleNamespace(gen0=gen0, disc0=disc0, gen1=_numpy(jt.gen_params),
                           disc1=_numpy(jt.disc_params), g_grads=_numpy(jt.gen_opt[0]),
                           d_grads=_numpy(jt.disc_opt[0]), metrics=metrics, mel=mel, wav=wav)


def _port_discriminators(params):
    d = tht.Discriminators(device="cpu")
    d.load_state_dict({k: torch.from_numpy(v) for k, v in from_jax_discriminators(params).items()})
    return d


@pytest.mark.parametrize("T", [1024, 1000])
def test_discriminators_match_jax(jax_step, T):
    wav = (0.5 * np.random.default_rng(T).standard_normal((B, T))).astype(np.float32)
    ref_outs, ref_feats = jax.jit(jht.Discriminators().apply)(jax_step.disc0, jnp.asarray(wav))
    with torch.no_grad():
        outs, feats = _port_discriminators(jax_step.disc0)(torch.from_numpy(wav))
    assert len(outs) == len(ref_outs) == 8 and len(feats) == 8
    for o, r in zip(outs, ref_outs):
        r = np.asarray(r)
        assert o.shape == r.shape
        assert np.abs(o.numpy() - r).max() <= 1e-5 * np.abs(r).max()
    for i, (fl, rl) in enumerate(zip(feats, ref_feats)):
        assert len(fl) == len(rl) == (6 if i < 5 else 8)
        for f, r in zip(fl, rl):
            # NCHW / NCL against flax's NHWC / NWC
            f = f.numpy().transpose((0, 2, 3, 1) if f.dim() == 4 else (0, 2, 1))
            r = np.asarray(r)
            assert f.shape == r.shape
            assert np.abs(f - r).max() <= 1e-5 * np.abs(r).max()


def test_losses_match_jax():
    g = np.random.default_rng(5)
    shapes = [(B, 7), (B, 30), (B, 11)]
    real = [g.standard_normal(s).astype(np.float32) for s in shapes]
    fake = [g.standard_normal(s).astype(np.float32) for s in shapes]
    feats = [[g.standard_normal((B, 4, 5, 3)).astype(np.float32),
              g.standard_normal((B, 6, 9)).astype(np.float32)] for _ in range(2)]
    feats2 = [[a + 0.1 * g.standard_normal(a.shape).astype(np.float32) for a in fl]
              for fl in feats]
    wa, wb = (0.3 * g.standard_normal((2, B, SEGMENT))).astype(np.float32)
    T, J = lambda xs: [torch.from_numpy(x) for x in xs], lambda xs: [jnp.asarray(x) for x in xs]
    pairs = [
        (tht.discriminator_loss(T(real), T(fake)), jht.discriminator_loss(J(real), J(fake))),
        (tht.generator_adv_loss(T(fake)), jht.generator_adv_loss(J(fake))),
        (tht.feature_matching_loss([T(f) for f in feats], [T(f) for f in feats2]),
         jht.feature_matching_loss([J(f) for f in feats], [J(f) for f in feats2])),
        (tht.mel_l1_loss(torch.from_numpy(wa), torch.from_numpy(wb), AudioConfig()),
         jht.mel_l1_loss(jnp.asarray(wa), jnp.asarray(wb), JAudioConfig())),
    ]
    for got, want in pairs:
        assert float(got) == pytest.approx(float(want), rel=1e-6)


def test_one_trainer_step_matches_jax(jax_step):
    tr = tht.HifiGanTrainer(_tiny(thg), tht.HifiGanTrainConfig(lr=LR),
                            AudioConfig(), device="cpu")
    tr.load({"gen": from_jax_hifigan(jax_step.gen0, _tiny(thg)),
             "disc": from_jax_discriminators(jax_step.disc0)})
    metrics = tr.train_step(torch.from_numpy(jax_step.mel), torch.from_numpy(jax_step.wav))
    for k in ("d_loss", "g_loss", "adv", "fm", "mel"):
        assert float(metrics[k]) == pytest.approx(jax_step.metrics[k], rel=1e-4), k
    for module, after, grads in (
            (tr.generator, from_jax_hifigan(jax_step.gen1, _tiny(thg)),
             from_jax_hifigan(jax_step.g_grads, _tiny(thg))),
            (tr.discriminators, from_jax_discriminators(jax_step.disc1),
             from_jax_discriminators(jax_step.d_grads))):
        state = module.state_dict()
        assert set(state) == set(after)
        for name, want in after.items():
            diff = np.abs(state[name].numpy() - want)
            assert diff.max() <= 2 * LR + 1e-7, name
            g = np.abs(grads[name])
            big = g > 1e-3 * g.max()
            assert not big.any() or diff[big].max() <= 1e-6, name


def test_optimizer_matches_optax():
    g = np.random.default_rng(7)
    params = {"a": (0.1 * g.standard_normal((5, 3))).astype(np.float32),
              "b": (0.1 * g.standard_normal(4)).astype(np.float32)}
    grads = [{k: g.standard_normal(v.shape).astype(np.float32) * 10.0 ** -i
              for k, v in params.items()} for i in range(3)]
    cfg = tht.HifiGanTrainConfig(lr=1e-2, lr_decay=0.9)
    tx = optax.adamw(optax.exponential_decay(cfg.lr, 1, cfg.lr_decay), b1=cfg.adam_b1,
                     b2=cfg.adam_b2)
    jp, state = {k: jnp.asarray(v) for k, v in params.items()}, None
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in params.items()}
    opt = tht.make_optimizer(list(tp.values()), cfg)
    for i, gr in enumerate(grads):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in gr.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        assert tht.optimizer_count(opt) == i
        assert tht.scheduled_lr(opt, cfg) == pytest.approx(cfg.lr * cfg.lr_decay ** i)
        for k, p in tp.items():
            p.grad = torch.from_numpy(gr[k])
        opt.step()
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7)


def _served_and_trained(gen, mel):
    out = gen(mel, train_route=True)
    with torch.no_grad():
        served = gen(mel)
    return out, served


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("which", ["tiny", "v1"])
def test_train_route_reaches_every_parameter(which, dtype):
    cfg = _tiny(thg) if which == "tiny" else thg.HifiGanConfig()
    gen = thg.Generator(cfg, dtype)
    thg.init_generator_weights(gen, torch.Generator().manual_seed(1))
    with torch.no_grad():  # every stage carries signal, tanh short of saturation
        for p in gen.parameters():
            p.mul_(8.0 if which == "tiny" else 4.0)
    gen.prepare()
    mel = torch.from_numpy(np.random.default_rng(3).standard_normal((1, 4, 80)).astype(np.float32))
    opt = tht.make_optimizer(gen.parameters(), tht.HifiGanTrainConfig(lr=1e-3))
    for step in range(2):
        out, served = _served_and_trained(gen, mel)
        top = out.detach().float().abs().max().item()
        assert 0.0 < top < 0.99
        tol = (2e-5 if dtype == torch.float32
               else 4 * 2.0 ** (np.floor(np.log2(top)) - 7))
        assert (served.float() - out.detach().float()).abs().max().item() <= tol
        if step:
            break
        opt.zero_grad()
        out.float().square().mean().backward()
        empty = [n for n, p in gen.named_parameters()
                 if p.grad is None or not p.grad.abs().sum() > 0]
        assert not empty
        opt.step()
        gen.prepare()   # the serving route's taps from the updated weights
