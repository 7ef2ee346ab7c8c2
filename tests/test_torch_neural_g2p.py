"""The port's neural G2P against the JAX package's: the shipped bundle
decoded without flax or msgpack array for array, identical phones on 250
words, one decode step's logits, a model that JAX ``NeuralG2P.save`` wrote,
and ``EnglishG2P`` with the neural OOV fallback."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from lightningfastspeech2_tpu.synthesis.g2p import EnglishG2P as JG2P
from lightningfastspeech2_tpu.synthesis.neural_g2p import (
    G2PTransformer as JTransformer,
    NeuralG2P as JNeuralG2P,
    _char_vocab,
)
from lightningfastspeech2_tpu_torch.synthesis import neural_g2p as tn
from lightningfastspeech2_tpu_torch.synthesis.g2p import BUILTIN_LEXICON
from lightningfastspeech2_tpu_torch.synthesis.g2p import EnglishG2P as TG2P
from lightningfastspeech2_tpu_torch.utils import flax_msgpack
from tests.torch_port_helpers import jax_neural_g2p, torch_threads

JAX_BUNDLE = Path(__file__).resolve().parent.parent / "lightningfastspeech2_tpu/data/g2p_en.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def models():
    return jax_neural_g2p(JAX_BUNDLE), tn.NeuralG2P.load(tn.BUILTIN_PATH, device="cpu")


def _words():
    lexicon = [line.split()[0].lower() for line in open(BUILTIN_LEXICON, encoding="utf-8")
               if line.strip() and not line.startswith(";")][:200]
    g = np.random.default_rng(0)
    letters = list("abcdefghijklmnopqrstuvwxyz")
    nonsense = ["".join(g.choice(letters, int(g.integers(3, 14)))) for _ in range(49)]
    # one word longer than MAX_WORD, with characters the model does not know
    nonsense.append("pneumono-ultramicroscopicsilicovolcano2conioses")
    return lexicon, nonsense


def test_builtin_bundle_is_the_jax_one():
    assert tn.BUILTIN_PATH.read_bytes() == JAX_BUNDLE.read_bytes()


def test_msgpack_decoder_matches_flax():
    data = np.load(tn.BUILTIN_PATH)["params"].tobytes()
    ref = serialization.msgpack_restore(data)
    out = flax_msgpack.restore(data)
    fr = jax.tree_util.tree_flatten_with_path(ref)[0]
    fo = jax.tree_util.tree_flatten_with_path(out)[0]
    assert len(fr) == len(fo) == 89
    for (kr, a), (ko, b) in zip(fr, fo):
        assert kr == ko and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    # the rest of the subset flax writes: scalars, nested lists, long
    # strings and maps, chunked arrays
    tree = {"a": np.arange(5, dtype=np.int64), "b": {
        "s": np.float32(3.5), "f": 1.5, "i": -3, "u": 300, "n": -200, "big": 2 ** 40,
        "list": [1, [2, 3]], "t": True, "none": None, "str": "x" * 300,
        "h": np.zeros((2, 3), np.float16),
        "m": {str(i): i for i in range(20)}}}
    for key, val in (("tree", tree), ("chunked", {"w": np.arange(40, dtype=np.float32).reshape(5, 8)})):
        old = serialization.MAX_CHUNK_SIZE
        serialization.MAX_CHUNK_SIZE = 16 if key == "chunked" else old
        try:
            blob = serialization.msgpack_serialize(val)
        finally:
            serialization.MAX_CHUNK_SIZE = old
        ref, out = serialization.msgpack_restore(blob), flax_msgpack.restore(blob)
        assert repr(jax.tree_util.tree_map(np.asarray, ref)) == repr(
            jax.tree_util.tree_map(np.asarray, out))


def test_phones_match_jax(models):
    j, t = models
    lexicon, nonsense = _words()
    words = lexicon + nonsense
    ref, out = j(words), t(words)
    assert out == ref
    assert all(out[:200]) and sum(len(p) for p in out) > 1000
    # the cache answers a second time without decoding
    assert t._cache[nonsense[0]] is out[200]


def test_decode_step_logits(models):
    j, t = models
    _, nonsense = _words()
    chars = np.stack([t.encode_word(w) for w in nonsense[:8]])
    g = np.random.default_rng(1)
    toks = np.zeros((8, tn.MAX_PHONES), np.int64)
    toks[:, 0] = tn.BOS
    toks[:, 1:12] = g.integers(3, len(t.phone_list) + 3, (8, 11))
    ref = np.asarray(jax.jit(j.model.apply)(j.params, jnp.asarray(chars, jnp.int32),
                                            jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        out = t.model(torch.as_tensor(chars), torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_all_masked_row_is_uniform_not_nan(models):
    _, t = models
    with torch.no_grad():
        enc, mask = t.model.encode(torch.zeros(1, tn.MAX_WORD, dtype=torch.long))
    assert not mask.any() and torch.isfinite(enc).all()


def test_jax_saved_small_model_loads(tmp_path):
    char2id = _char_vocab()
    phones = ["AA1", "B", "K", "T", "IY0", "S"]
    model = JTransformer(n_chars=len(char2id) + 3, n_phones=len(phones) + 3, d=32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(3),
                            jnp.zeros((1, tn.MAX_WORD), jnp.int32),
                            jnp.zeros((1, tn.MAX_PHONES), jnp.int32))
    g = np.random.default_rng(3)
    params = jax.tree_util.tree_map(
        lambda s: (g.standard_normal(s.shape) * 0.2).astype(np.float32), shapes)
    JNeuralG2P(params, char2id, phones, d=32).save(tmp_path / "small.npz")
    t = tn.NeuralG2P.load(tmp_path / "small.npz", device="cpu")
    assert t.model.d == 32 and t.phone_list == phones
    chars = np.stack([t.encode_word(w) for w in ("cab", "stack", "tea")])
    toks = np.random.default_rng(2).integers(0, len(phones) + 3, (3, tn.MAX_PHONES))
    ref = np.asarray(jax.jit(model.apply)(params, jnp.asarray(chars, jnp.int32),
                                          jnp.asarray(toks, jnp.int32)))
    with torch.no_grad():
        out = t.model(torch.as_tensor(chars), torch.as_tensor(toks)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_english_g2p_neural_fallback_matches_jax(models):
    j, t = models
    text = "The zyxwort and the blorptastic quonx met Stella, again!"
    ref = JG2P(BUILTIN_LEXICON, neural=j)(text)
    out = TG2P(BUILTIN_LEXICON, neural=t)(text)
    assert out == ref
    # the fallback changes the OOV words' phones from the rule LTS's
    assert out != TG2P(BUILTIN_LEXICON)(text)
