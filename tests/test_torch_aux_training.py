"""Training the neural G2P and the denoiser in the port (``synthesis/
neural_g2p.py train_neural_g2p``, ``synthesis/denoiser.py train_denoiser``)
against the JAX trainers on the CPU, from the JAX trainers' own initial
weights carried over, and their bundles across the two packages; with the
two reference defects the port repairs (the vocoder pad floor from the
config, the denoiser's guard when no frame is valid).

Tolerances: each step's loss rtol 1e-5 (f32, other summation orders).
After the steps the parameters within 3 x 2 lr + 1e-6: Adam's update of a
weight whose gradient is near 0 takes its sign, so a rounding can move such
a weight by 2 lr a step the other way (PR 21's rule for HiFi-GAN); the
median difference is held to 1e-6. Bundles load bit for bit.
"""

import json

import jax
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.synthesis import denoiser as jdn
from lightningfastspeech2_tpu.synthesis import neural_g2p as jng
from lightningfastspeech2_tpu_torch.cli import train_denoiser as dcli
from lightningfastspeech2_tpu_torch.cli import train_g2p as gcli
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.synthesis import denoiser as tdn
from lightningfastspeech2_tpu_torch.synthesis import neural_g2p as tng
from lightningfastspeech2_tpu_torch.synthesis.g2p import BUILTIN_LEXICON, EnglishG2P
from lightningfastspeech2_tpu_torch.synthesis.generator import SpeechGenerator, mel_pad_floor
from tests.torch_port_helpers import torch_threads

LR = 1e-3
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture
def jax_steps(monkeypatch):
    """The JAX trainers' jitted update, recorded: ``params`` the weights it
    was first given (the trainer's own init), ``losses`` each value it
    returns as its third output (the step's loss). ``jax.jit`` is wrapped
    for the test; nothing in the JAX package changes."""
    rec = {"params": None, "losses": []}
    real_jit = jax.jit

    def jit(fn, **kwargs):
        compiled = real_jit(fn, **kwargs)

        def call(*args):
            out = compiled(*args)
            if isinstance(out, tuple) and len(out) == 3:
                if rec["params"] is None:
                    rec["params"] = jax.tree_util.tree_map(np.asarray, args[0])
                rec["losses"].append(float(out[2]))
            return out
        return call

    monkeypatch.setattr(jax, "jit", jit)
    return rec


def _close_params(got, want, null=()):
    """``null``: tensors whose gradient is 0 but for rounding (attention's
    key bias shifts every score of a query alike), which Adam moves by
    about lr a step in the rounding's direction: held to the bound only."""
    for k, w in want.items():
        diff = np.abs(got[k].detach().numpy() - np.asarray(w))
        assert diff.max() <= STEPS * 2 * LR + 1e-6, k
        if not k.endswith(null):
            assert np.median(diff) <= 1e-6, k


@pytest.fixture(scope="module")
def lexicon():
    full = EnglishG2P(str(BUILTIN_LEXICON)).lexicon
    words = sorted(full)[:: max(len(full) // 64, 1)][:64]
    return {w: full[w] for w in words}


def test_train_g2p_matches_jax(lexicon, jax_steps, tmp_path):
    """d = 32, 64 words, batch 8, 3 steps: the JAX trainer's first weights
    (its ``model.init`` at PRNGKey(0)) carried over."""
    jmodel = jng.train_neural_g2p(lexicon, steps=STEPS, batch_size=8, lr=LR, d=32, seed=0)
    losses = []
    tmodel = tng.train_neural_g2p(lexicon, steps=STEPS, batch_size=8, lr=LR, d=32, seed=0,
                                  device="cpu", init=tng.flax_state_dict(jax_steps["params"]),
                                  losses=losses)
    assert len(jax_steps["losses"]) == STEPS
    np.testing.assert_allclose(losses, jax_steps["losses"], rtol=1e-5)
    _close_params(tmodel.model.state_dict(), tng.flax_state_dict(jmodel.params),
                  null=("key.bias",))

    # the port's bundle in the JAX loader, the JAX bundle in the port's
    tmodel.save(tmp_path / "port.npz")
    back = jng.NeuralG2P.load(tmp_path / "port.npz")
    assert back.char2id == tmodel.char2id and back.phone_list == tmodel.phone_list
    for k, v in tng.flax_state_dict(back.params).items():
        np.testing.assert_array_equal(np.asarray(v), tmodel.model.state_dict()[k].numpy(), k)
    jmodel.save(tmp_path / "jax.npz")
    loaded = tng.NeuralG2P.load(tmp_path / "jax.npz", "cpu")
    assert json.dumps(loaded.phone_list) == json.dumps(jmodel.phone_list)
    for k, v in tng.flax_state_dict(jmodel.params).items():
        np.testing.assert_array_equal(loaded.model.state_dict()[k].numpy(), np.asarray(v), k)


def test_train_g2p_cli(tmp_path):
    """The entry point on the CPU: a 64-word lexicon file, a stem holdout of
    8, 2 steps; the bundle loads in the port."""
    full = EnglishG2P(str(BUILTIN_LEXICON)).lexicon
    lex = tmp_path / "lex.txt"
    lex.write_text("".join(f"{w.upper()}  {' '.join(full[w])}\n" for w in sorted(full)[:64]))
    out = tmp_path / "g2p.npz"
    res = gcli.main(["--lexicon", str(lex), "--out", str(out), "--steps", "2", "--batch_size",
                     "4", "--d", "32", "--holdout", "8", "--holdout_mode", "stem",
                     "--device", "cpu"])
    assert res["held"] >= 8 and len(res["losses"]) == 2 and 0 <= res["per"]
    assert np.isfinite(res["losses"]).all()
    assert len(tng.NeuralG2P.load(out, "cpu")(["zyzzyva"])) == 1


def _clips():
    rng = np.random.default_rng(4)
    return [dcli.make_clean(rng, seconds=0.5), dcli.make_clean(rng, seconds=1.0)]


def test_train_denoiser_matches_jax(jax_steps, tmp_path):
    """MaskNet on batches of 2 x 64 frames, 3 steps, from the JAX trainer's
    first weights carried over."""
    clips = _clips()
    jparams = jdn.train_denoiser(clips, steps=STEPS, batch=2, frames=64, lr=LR, seed=0)
    jdn.save(jax_steps["params"], tmp_path / "init.npz")
    init_net = tdn.load(tmp_path / "init.npz", "cpu")
    losses = []
    net = tdn.train_denoiser(clips, steps=STEPS, batch=2, frames=64, lr=LR, seed=0,
                             device="cpu", init=init_net.state_dict(), losses=losses)
    assert len(jax_steps["losses"]) == STEPS
    np.testing.assert_allclose(losses, jax_steps["losses"], rtol=1e-5)
    jdn.save(jparams, tmp_path / "jax.npz")
    want = tdn.load(tmp_path / "jax.npz", "cpu").state_dict()
    _close_params(net.state_dict(), {k: v.numpy() for k, v in want.items()})

    # the port's npz in the JAX loader, and the JAX one (above) in the port's
    tdn.save(net, tmp_path / "port.npz")
    back = jdn.load(tmp_path / "port.npz")
    for i, conv in enumerate(net.convs):
        np.testing.assert_array_equal(np.asarray(back[f"Conv_{i}"]["kernel"]),
                                      conv.weight.numpy().transpose(2, 3, 1, 0))
        np.testing.assert_array_equal(np.asarray(back[f"Conv_{i}"]["bias"]), conv.bias.numpy())
    for k, v in tdn.load(tmp_path / "port.npz", "cpu").state_dict().items():
        np.testing.assert_array_equal(v.numpy(), net.state_dict()[k].numpy(), k)


def test_train_denoiser_cli(tmp_path):
    """No corpus: the synthetic clips; 2 steps; the npz serves one
    ``apply_mask_net`` in the port."""
    out = tmp_path / "dn.npz"
    res = dcli.main(["--corpus", str(tmp_path / "none"), "--steps", "2", "--batch", "1",
                     "--out", str(out), "--device", "cpu"])
    assert res["clips"] == 16 and len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    mag = torch.rand(32, 513) + 0.01
    masked = tdn.apply_mask_net(tdn.load(out, "cpu"), mag)
    assert masked.shape == mag.shape and torch.isfinite(masked).all()


@pytest.mark.parametrize("valid", ["some", "none"])
def test_apply_mask_net_guards_no_valid_frame(valid):
    """Where some frames are valid the port matches the JAX function (atol
    1e-6 of the magnitude's scale); where none is, JAX gives NaN (its
    padded frames take the +inf minimum of no frame) and the port a finite
    masked magnitude."""
    g = np.random.default_rng(6)
    mag = (np.abs(g.standard_normal((40, 513))) + 1e-3).astype(np.float32)
    fv = np.arange(40) < (30 if valid == "some" else 0)
    params, net = jdn.load(), tdn.load(device="cpu")
    want = np.asarray(jax.jit(lambda m, v: jdn.apply_mask_net(params, m, frame_valid=v))(mag, fv))
    got = tdn.apply_mask_net(net, torch.from_numpy(mag), frame_valid=torch.from_numpy(fv)).numpy()
    if valid == "some":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * mag.max())
    else:
        assert np.isnan(want).any()
        assert np.isfinite(got).all() and (got >= 0.03 * mag - 1e-7).all()


@pytest.mark.parametrize("clip_val, log10", [(1e-6, True), (1e-5, True), (1e-5, False)])
def test_vocoder_pad_floor_follows_the_front_end(clip_val, log10):
    """Padded vocoder frames sit at the config's log-mel floor: -6.0 at the
    default (the JAX package's constant), log10 or ln of another clip."""
    audio = TC.AudioConfig(clip_val=clip_val, log10=log10)
    floor = mel_pad_floor(audio)
    assert floor == np.float32(np.log10(clip_val) if log10 else np.log(clip_val))
    if (clip_val, log10) == (1e-6, True):
        assert floor == np.float32(-6.0)
    # generate_samples hands the vocoder the bucket's mel, the padded
    # frames at the floor
    gen = SpeechGenerator.__new__(SpeechGenerator)
    seen = []
    gen.cfg = TC.Config(model=TC.ModelConfig(audio=audio))
    gen.synthesiser = lambda m: seen.append(m) or np.zeros(m.shape[0] * 256, np.float32)
    gen.postprocess = None
    mel = torch.randn(1, 8, 80)
    mask = torch.arange(8)[None] < 5
    gen.infer = lambda batch: {"mel": mel, "frame_mask": mask}
    gen.generate_samples({})
    np.testing.assert_array_equal(seen[0][:5], mel[0, :5].numpy())
    assert (seen[0][5:] == floor).all()
