"""The port's serving path against the JAX package's: ``SpeechGenerator.
generate_from_text`` and a batched ``generate_samples`` with the tiny model
and the tiny HiFi-GAN, the same sentence, seed, d-vector table and rule G2P,
the JAX weights carried across by ``from_jax_fastspeech2`` and
``from_jax_hifigan``. Both packages run the duration pass, the frame bucket,
the full pass at that bucket and the vocoder at the bucket length."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.core.bucketing import Bucketer as JBucketer
from lightningfastspeech2_tpu.data.vocab import Vocab as JVocab
from lightningfastspeech2_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
    init_params,
    make_dummy_batch,
)
from lightningfastspeech2_tpu.synthesis.g2p import EnglishG2P as JG2P
from lightningfastspeech2_tpu.synthesis.generator import SpeechGenerator as JGenerator
from lightningfastspeech2_tpu.vocoder import hifigan as jhg
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.core.bucketing import Bucketer as TBucketer
from lightningfastspeech2_tpu_torch.core.bucketing import pad_to
from lightningfastspeech2_tpu_torch.data.vocab import Vocab as TVocab
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
from lightningfastspeech2_tpu_torch.synthesis.g2p import EnglishG2P as TG2P
from lightningfastspeech2_tpu_torch.synthesis.generator import (
    PostProcessChain,
    SpeechGenerator as TGenerator,
)
from lightningfastspeech2_tpu_torch.utils.convert import (
    from_jax_fastspeech2,
    from_jax_hifigan,
)
from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg
from tests.torch_port_helpers import tiny_config, tiny_hifigan

SENTENCE = "hello world, this is a test."
# f32 end to end through two models; XLA and torch sum in other orders
# (mel differences ~1e-6, the waveform lies in [-1, 1])
ATOL = 1e-4
HOP = 16


@pytest.fixture(scope="module")
def generators():
    # the audio hop matches the tiny vocoder's (8 x 2), so the waveform is
    # trimmed to valid frames x hop inside the bucket
    jcfg = tiny_config(JC, audio=JC.AudioConfig(hop_length=HOP))
    tcfg = tiny_config(TC, audio=TC.AudioConfig(hop_length=HOP))
    model = JaxFastSpeech2(jcfg.model)
    dummy = {k: jnp.asarray(v) for k, v in
             make_dummy_batch(jcfg.model, batch_size=1, n_phones=8, seed=0).items()}
    params = jax.tree_util.tree_map(
        np.array, init_params(model, jax.random.PRNGKey(0), dummy))
    # every phone 7 frames (round(exp(log 8) - 1)) instead of the untrained
    # head's draw-dependent ~1: the lengths below then hold whatever the
    # random weights are (duration prediction itself is compared in
    # test_torch_model.py)
    head = params["params"]["variance_adaptor"]["duration_predictor"]["linear"]
    head["kernel"][:] = 0.0
    head["bias"][:] = np.log(8.0)

    hcfg_j, hcfg_t = tiny_hifigan(jhg), tiny_hifigan(thg)
    gen = jhg.Generator(hcfg_j)
    hparams = gen.init(jax.random.PRNGKey(1), jnp.zeros((1, 16, 80)))
    # the N(0, 0.01) init leaves the waveform near zero: scale it up
    hparams = jax.tree_util.tree_map(lambda a: np.asarray(a) * 8.0, hparams)

    phones = sorted(set(JG2P()(SENTENCE + " a second sentence.")))
    dvecs = {f"spk{i}": np.random.default_rng(i).standard_normal(16).astype(np.float32)
             for i in range(3)}
    jgen = JGenerator(jcfg, model, params["params"], JVocab(phones), JG2P(),
                      synthesiser=jhg.Synthesiser(hcfg_j, hparams),
                      speaker2dvector=dvecs)
    tgen = TGenerator(
        tcfg,
        build_fastspeech2(tcfg.model, device="cpu",
                          state_dict=from_jax_fastspeech2(params, tcfg.model)),
        TVocab(phones), TG2P(),
        synthesiser=thg.Synthesiser(hcfg_t, from_jax_hifigan(hparams, hcfg_t),
                                    device="cpu"),
        speaker2dvector=dvecs,
        postprocess=PostProcessChain(lambda w, sr: w * 1.0))
    # fine frame buckets so the bucket sits well below max_frames (the
    # default 256-frame step would give one bucket at this size)
    jgen.bucketer = JBucketer(jcfg.model.max_phones, jcfg.model.max_frames, frame_step=16)
    tgen.bucketer = TBucketer(tcfg.model.max_phones, tcfg.model.max_frames, frame_step=16)
    return jgen, tgen


def test_generate_from_text_matches_jax(generators):
    jgen, tgen = generators
    ref = jgen.generate_from_text(SENTENCE, seed=3)
    out = tgen.generate_from_text(SENTENCE, seed=3)
    assert out.dtype == np.float32 and out.ndim == 1
    assert len(out) == len(ref) and len(out) % HOP == 0
    frames = len(out) // HOP
    assert frames == 7 * len(tgen.text_to_ids(SENTENCE))
    assert frames % 16 != 0   # trimmed inside its 16-frame bucket
    assert np.isfinite(out).all() and np.abs(ref).max() > 0.05
    np.testing.assert_allclose(out, ref, rtol=0, atol=ATOL)


def test_batched_generate_samples_matches_jax(generators):
    jgen, tgen = generators
    ids = [tgen.text_to_ids(SENTENCE), tgen.text_to_ids("a second sentence.")]
    P = tgen.bucketer.phone_bucket(max(len(i) for i in ids))
    batch = {"phones": np.stack([pad_to(i, P) for i in ids]),
             "speaker": np.stack([tgen.speaker2dvector["spk0"],
                                  tgen.speaker2dvector["spk1"]])}
    ref = jgen.generate_samples(batch)
    out = tgen.generate_samples(batch)
    assert [len(a) for a in out] == [len(a) for a in ref]
    # the shorter item is cut to its own valid frames inside the shared bucket
    assert [len(a) for a in out] == [7 * HOP * len(i) for i in ids]
    assert len(out[1]) % (16 * HOP) != 0
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL)
