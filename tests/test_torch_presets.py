"""The JAX package's other model presets through the port: both presets'
config JSON, then ``fastspeech2_27m`` (plain ConvFFN blocks, no speaker)
and ``lightspeech_true76m`` (hidden 640, filter 2560, 5 heads) at their
full widths cut to one encoder and one decoder block, against the JAX
package on the same seeded weights (carried across by
``from_jax_fastspeech2``): the inference forward and the losses of one
train step, every dropout rate 0; and the flagship's every-layer speaker
and prior embeddings, forward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
    make_dummy_batch,
)
from lightningfastspeech2_tpu.train.losses import compute_losses as jax_losses
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
from lightningfastspeech2_tpu_torch.train.step import create_train_state, make_train_step
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastspeech2
from tests.torch_port_helpers import seeded_params as _seeded, tiny_config, torch_threads

# f32 end to end; XLA and torch sum in different orders (test_torch_model.py's)
ATOL = 1e-4
PRESETS = ("fastspeech2_27m", "lightspeech_true76m")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("preset", PRESETS)
def test_preset_json_matches_jax(preset):
    assert TC.to_dict(getattr(TC, preset)()) == JC.to_dict(getattr(JC, preset)())


def _cut(C, preset):
    """The preset at its full widths, one encoder and one decoder block, a
    32-phone and 128-frame bucket, every dropout rate 0."""
    cfg = getattr(C, preset)()
    m = cfg.model
    stack = [C.replace(s, layers=1, kernel_sizes=s.kernel_sizes[:1], dropout=0.0)
             for s in (m.encoder, m.decoder)]
    model = C.replace(m, encoder=stack[0], decoder=stack[1], max_phones=32, max_frames=128,
                      variance=C.replace(m.variance, dropouts=(0.0,) * len(m.variance.variances)),
                      duration=C.replace(m.duration, dropout=0.0))
    return C.replace(cfg, model=model)


def _pair(jcfg, tcfg, seed=0):
    """The JAX model, its seeded parameters (duration head biased to about 7
    frames a phone), a batch of 2 (the second item shorter), and the port's
    model on the same weights."""
    assert JC.to_dict(jcfg) == TC.to_dict(tcfg)
    model = JaxFastSpeech2(jcfg.model)
    batch = make_dummy_batch(jcfg.model, batch_size=2, n_phones=12, n_frames=96, seed=seed)
    batch["phones"][1, 9:] = 0
    batch["duration"][1, 9:] = 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = _seeded(jax.eval_shape(lambda r, b: model.init(r, b, deterministic=True),
                                    jax.random.PRNGKey(0), jb), seed)
    head = params["params"]["variance_adaptor"]["duration_predictor"]["linear"]
    head["kernel"][:] = 0.0
    head["bias"][:] = np.log(8.0)
    port = build_fastspeech2(tcfg.model, device="cpu",
                             state_dict=from_jax_fastspeech2(params, tcfg.model))
    return model, params, batch, jb, port


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                               rtol=0, atol=atol)


@pytest.fixture(scope="module", params=PRESETS)
def preset(request):
    jcfg, tcfg = _cut(JC, request.param), _cut(TC, request.param)
    return (jcfg, tcfg, *_pair(jcfg, tcfg))


def test_preset_inference_matches_jax(preset):
    jcfg, _, model, params, _, jb, port = preset
    ref = jax.jit(lambda p, b: model.apply(p, b, inference=True))(params, jb)
    tb = {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}
    with torch.no_grad():
        out = port(tb, inference=True)
    np.testing.assert_array_equal(np.asarray(ref["duration_rounded"]),
                                  out["duration_rounded"].numpy())
    assert out["duration_rounded"].numpy()[0].sum() > 50   # regulation expanded the phones
    np.testing.assert_array_equal(np.asarray(ref["frame_mask"]), out["frame_mask"].numpy())
    _close(ref["mel"], out["mel"].numpy())


def test_preset_train_step_losses_match_jax(preset):
    """The losses of one port train step (teacher forced, rates 0) against
    the JAX package's on the same forward: both before the update."""
    jcfg, tcfg, model, params, batch, jb, port = preset
    ref = jax.jit(lambda p, b: jax_losses(model.apply(p, b), b, jcfg))(params, jb)
    state = create_train_state(port, tcfg)
    _, metrics = make_train_step(port, tcfg)(state, batch, torch.Generator().manual_seed(0))
    assert set(ref) <= set(metrics)
    for key in ref:
        _close(ref[key], float(metrics[key]))
    assert np.isfinite(float(metrics["grad_norm"])) and float(metrics["grad_norm"]) > 0


def test_every_layer_embeddings_match_jax():
    """Speaker and prior embeddings added before every encoder layer (and
    the speaker's before every decoder layer): the flagship's structure at
    test size, teacher-forced forward."""
    def cfg(C):
        return tiny_config(C, priors=("pitch", "energy"), speaker_embedding_every_layer=True,
                           prior_embedding_every_layer=True)

    jcfg, tcfg = cfg(JC), cfg(TC)
    model, params, _, jb, port = _pair(jcfg, tcfg, seed=3)
    ref = jax.jit(lambda p, b: model.apply(p, b))(params, jb)
    with torch.no_grad():
        out = port({k: torch.from_numpy(np.array(v)) for k, v in jb.items()})
    _close(ref["mel"], out["mel"].numpy())
    _close(ref["duration_prediction"], out["duration_prediction"].numpy())
    # the embeddings really enter every layer: once only gives another mel
    once = build_fastspeech2(TC.replace(tcfg.model, speaker_embedding_every_layer=False,
                                        prior_embedding_every_layer=False),
                             device="cpu", state_dict=port.state_dict())
    with torch.no_grad():
        other = once({k: torch.from_numpy(np.array(v)) for k, v in jb.items()})
    assert np.abs(other["mel"].numpy() - out["mel"].numpy()).max() > 1e-2


@pytest.mark.parametrize("preset,resblock", [("fastspeech2_27m", "2"),
                                             ("lightspeech_true76m", "1")])
def test_preset_checkpoint_serves_through_the_cli(tmp_path, preset, resblock):
    """A port checkpoint of each preset (full widths, one block a stack)
    serves a sentence through ``cli.generate.main`` on the CPU, with a
    vocoder directory of each residual block kind (test size)."""
    import dataclasses

    from lightningfastspeech2_tpu_torch.cli import generate as tcli
    from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
    from lightningfastspeech2_tpu_torch.data.vocab import (
        ARPABET_TO_IPA,
        PUNCTUATION_TOKENS,
        SILENCE,
    )
    from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg

    phones = sorted(set(ARPABET_TO_IPA.values()) | set(PUNCTUATION_TOKENS.values()) | {SILENCE})
    phone2id = {"[PAD]": 0, **{p: i + 1 for i, p in enumerate(phones)}}
    cfg = _cut(TC, preset)
    cfg = TC.replace(cfg, model=TC.replace(cfg.model, vocab_size=len(phone2id), max_frames=512))
    model = build_fastspeech2(cfg.model, device="cpu", seed=0)
    stats = {v: {"min": -2.0, "max": 3.0, "mean": 0.0, "std": 1.0}
             for v in cfg.model.variance.variances}
    dvec = {"spk0": np.ones(cfg.model.dvector_dim, np.float32)}
    sidecar = {"phone2id": phone2id, "stats": stats,
               **({"speaker2dvector": dvec} if cfg.model.speaker_type == "dvector" else {})}
    Checkpointer(tmp_path / "ckpt").save(1, model.state_dict(), cfg, sidecar)
    vcfg = thg.HifiGanConfig(resblock=resblock, upsample_rates=(8, 8, 4),
                             upsample_kernel_sizes=(16, 16, 8), upsample_initial_channel=64,
                             resblock_kernel_sizes=(3, 5), resblock_dilation_sizes=((1, 2), (2, 6)))
    voc = thg.Synthesiser(vcfg, device="cpu", seed=1).model
    Checkpointer(tmp_path / "voc").save(1, {"gen": voc.state_dict()},
                                        sidecar={"hifigan_config": dataclasses.asdict(vcfg)})
    wav = tcli.main(["--checkpoint_dir", str(tmp_path / "ckpt"), "--hifigan_checkpoint",
                     str(tmp_path / "voc"), "--sentence", "hello world.", "--seed", "0",
                     "--lexicon_path", "none", "--g2p_model", "none", "--device", "cpu",
                     "--output_path", str(tmp_path / "out")])
    assert wav.size > 0 and wav.size % 256 == 0 and np.isfinite(wav).all()
    assert (tmp_path / "out" / "sentence.wav").exists()
