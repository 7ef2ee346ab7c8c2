"""The port's d-vector pipeline (data/dvector.py) against the JAX package's:
the wav2mel front-end, the LSTM encoder with the JAX package's weights
through ``utils/convert.py from_jax_dvector``, and the dataset's
``create_dvectors`` / ``get_speaker_dvectors`` on a ``make_corpus`` corpus.

Tolerances: the mel powers within 1e-4 relative plus 1e-6 of the
utterance's peak power (two f32 FFTs); the encoder alone, on the same
log-mel, within 1e-6 absolute (unit vectors through three f32 LSTM layers in
two frameworks; 5e-8 measured); the whole pipeline within 5e-4: the
log-mel of a bin whose power is near the 1e-9 clamp moves by up to 0.05
between the two FFTs (a chirp's, 1e-10 of its peak power), and the encoder
reads the log (6e-5 measured)."""

import jax
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.data import dataset as jds
from lightningfastspeech2_tpu.data import dvector as jdv
from lightningfastspeech2_tpu_torch.data import dataset as tds
from lightningfastspeech2_tpu_torch.data import dvector as tdv
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_dvector
from tests.torch_port_helpers import torch_threads

SR = 22050
EMB_ATOL = 5e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def jax_pipeline():
    return jdv.DVectorPipeline()


@pytest.fixture(scope="module")
def port_pipeline(jax_pipeline):
    params = jax.tree_util.tree_map(np.asarray, jax_pipeline.params)
    return tdv.DVectorPipeline(from_jax_dvector(params), device="cpu")


def _wavs():
    g = np.random.default_rng(0)
    t = np.arange(SR) / SR
    tone = 0.5 * np.sin(2 * np.pi * 220 * t) * (t > 0.2) + 0.01 * g.standard_normal(SR)
    chirp = np.sin(2 * np.pi * (100 + 300 * t) * t) * np.minimum(1, 4 * t)
    return [tone.astype(np.float32), chirp.astype(np.float32),
            (0.3 * g.standard_normal(SR // 2)).astype(np.float32)]


@pytest.mark.parametrize("i", [0, 1, 2])
def test_wav2mel_matches_jax(i):
    wav = _wavs()[i]
    ref = np.exp(jdv.wav2mel(wav, SR).astype(np.float64))
    got = np.exp(tdv.wav2mel(wav, SR).numpy().astype(np.float64))
    assert got.shape == ref.shape and got.shape[1] == 40
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-6 * ref.max())


def test_silence_helpers_match_jax():
    g = np.random.default_rng(1)
    wav = np.concatenate([np.zeros(3000), g.standard_normal(5000), np.zeros(800),
                          g.standard_normal(4000), np.zeros(2500)]).astype(np.float32)
    np.testing.assert_array_equal(tdv.remove_silence(wav, 16000), jdv.remove_silence(wav, 16000))
    np.testing.assert_array_equal(tdv.normalize_db(wav), jdv.normalize_db(wav))


def test_dvector_embedding_matches_jax(jax_pipeline, port_pipeline):
    import jax.numpy as jnp

    for wav in _wavs()[:2]:   # one length: one JAX compile
        mel = jdv.wav2mel(wav, SR)
        ref = np.asarray(jax_pipeline._embed(jax_pipeline.params, jnp.asarray(mel))[0])
        with torch.no_grad():
            got = port_pipeline.model(torch.from_numpy(np.array(mel)))[0].numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
        ref = jax_pipeline.embed_wav(wav, SR)
        got = port_pipeline.embed_wav(wav, SR)
        assert got.shape == (256,) and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=EMB_ATOL)
        np.testing.assert_allclose(np.linalg.norm(got), 1.0, rtol=1e-6)


def test_from_jax_dvector_round_trips(jax_pipeline):
    params = jax.tree_util.tree_map(np.asarray, jax_pipeline.params)
    sd = from_jax_dvector(params)
    back = jdv.convert_torch_state_dict(sd)["params"]
    for path, leaf in jax.tree_util.tree_flatten_with_path(back)[0]:
        ref = params["params"]
        for p in path:
            ref = ref[p.key]
        np.testing.assert_array_equal(np.asarray(leaf), ref)


def test_default_weights_are_seeded_and_tagged():
    a, b = tdv.DVectorPipeline(device="cpu"), tdv.DVectorPipeline(device="cpu")
    c = tdv.DVectorPipeline(seed=1, device="cpu")
    wav = _wavs()[0]
    np.testing.assert_array_equal(a.embed_wav(wav, SR), b.embed_wav(wav, SR))
    assert a.cache_tag == b.cache_tag != c.cache_tag
    assert a.cache_tag.startswith(".") and len(a.cache_tag) == 9
    assert a.cache_path("x/utt.wav").name == f"utt{a.cache_tag}.npy"


def test_dataset_dvectors_match_jax(tmp_path, jax_pipeline, port_pipeline):
    corpus = make_corpus(tmp_path / "corpus", n_speakers=2, n_utts=2, seed=0)
    cfg = dict(variances=("energy",), variance_levels=("frame",), variance_transforms=("none",))
    jd = jds.TTSDataset(corpus, jds.DataConfig(**cfg))
    td = tds.TTSDataset(corpus, tds.DataConfig(**cfg), device="cpu")
    jtable = jd.create_dvectors(jax_pipeline)
    ttable = td.create_dvectors(port_pipeline)
    assert set(ttable) == set(jtable) == set(td.speakers)
    for spk in jtable:
        np.testing.assert_allclose(ttable[spk], jtable[spk], rtol=0, atol=EMB_ATOL)
    # the port's files carry its weights' tag beside the JAX package's plain ones
    tag = port_pipeline.cache_tag
    for e in td.entries:
        plain, tagged = e.audio_path.with_suffix(".npy"), e.audio_path.with_suffix(tag + ".npy")
        assert plain.exists() and tagged.exists()
        np.testing.assert_allclose(np.load(tagged), np.load(plain), rtol=0, atol=EMB_ATOL)
        assert (e.audio_path.parent / f"speaker{tag}.npy").exists()
    got = dict(td.get_speaker_dvectors())
    ref = dict(jd.get_speaker_dvectors())
    for spk in ref:
        np.testing.assert_allclose(got[spk], ref[spk], rtol=0, atol=EMB_ATOL)
    # items carry the speaker means and, from the tagged files, the
    # utterance d-vectors
    for i in range(len(td)):
        a, b = td.__getitem__(i, augment=False), jd.__getitem__(i, augment=False)
        np.testing.assert_allclose(a["speaker"], b["speaker"], rtol=0, atol=EMB_ATOL)
        np.testing.assert_allclose(a["utterance_dvec"], b["utterance_dvec"], rtol=0,
                                   atol=EMB_ATOL)
    # a cached file is read, not recomputed; a plain <utt>.npy alone is not
    # the default pipeline's
    e = td.entries[0]
    np.save(e.audio_path.with_suffix(tag + ".npy"), np.full(256, 7.0, np.float32))
    assert port_pipeline.process_entries([e])[e.speaker][0] == 7.0
    fresh = tds.TTSDataset(corpus, tds.DataConfig(**cfg), device="cpu")
    assert dict(fresh.get_speaker_dvectors()).keys() == dict(jd.get_speaker_dvectors()).keys()
    fresh.create_dvectors(port_pipeline, cache=False)   # anew: the poisoned file is unread
    assert fresh.dvector_suffix == ".npy"
    np.testing.assert_allclose(fresh.speaker2dvector[e.speaker], ttable[e.speaker], rtol=0,
                               atol=1e-6)
