"""The port's generate CLI against the JAX package's, end to end on the CPU.

A JAX checkpoint (tiny model with d-vectors, pitch and energy priors, the
prior and d-vector GMM pickles) and a tiny HiFi-GAN vocoder directory are
written by the JAX ``Checkpointer``, converted by
``scripts/jax_checkpoint_to_torch.py``, and both CLIs synthesize the same
sentence with an out-of-vocabulary word (the builtin lexicon and neural
G2P): the phone ids are identical, the waveforms agree within
``test_torch_serving.py``'s tolerance before the write and within one LSB
in the wav files. In ``--dataset`` mode both re-synthesize one
``make_corpus`` corpus: the ``.meta`` phones and durations, the ``.lab``
text and the ``_original.wav`` copies are identical, the waveforms agree as
in sentence mode."""

import dataclasses
import pickle
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.cli import generate as jcli
from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.core.checkpoint import Checkpointer as JCheckpointer
from lightningfastspeech2_tpu.data.vocab import ARPABET_TO_IPA, PUNCTUATION_TOKENS, SILENCE
from lightningfastspeech2_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
    make_dummy_batch,
)
from lightningfastspeech2_tpu.synthesis import generator as jgen_mod
from lightningfastspeech2_tpu.synthesis.neural_g2p import NeuralG2P as JNeuralG2P
from lightningfastspeech2_tpu.utils.log_gmm import fit_dvector_gmms, fit_speaker_gmms
from lightningfastspeech2_tpu.vocoder import hifigan as jhg
from lightningfastspeech2_tpu_torch.cli import generate as tcli
from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
from lightningfastspeech2_tpu_torch.synthesis import generator as tgen_mod
from tests.torch_port_helpers import jax_neural_g2p, tiny_config, tiny_hifigan, torch_threads
from tests.torch_port_helpers import seeded_params as _seeded

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "scripts"))
from jax_checkpoint_to_torch import convert  # noqa: E402

# "zyxwort" is in no lexicon: the neural G2P spells it
SENTENCE = "hello zyxwort world."
ATOL = 1e-4   # test_torch_serving.py's: f32 through two models
HOP = 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    root = tmp_path_factory.mktemp("ckpts")
    phones = sorted(set(ARPABET_TO_IPA.values()) | set(PUNCTUATION_TOKENS.values())
                    | {SILENCE})
    phone2id = {"[PAD]": 0, **{p: i + 1 for i, p in enumerate(phones)}}
    cfg = tiny_config(JC, audio=JC.AudioConfig(hop_length=HOP), priors=("pitch", "energy"),
                      vocab_size=len(phone2id))
    model = JaxFastSpeech2(cfg.model)
    dummy = {k: jnp.asarray(v) for k, v in
             make_dummy_batch(cfg.model, batch_size=1, n_phones=8, seed=0).items()}
    params = _seeded(jax.eval_shape(lambda r, b: model.init(r, b, deterministic=True),
                                    jax.random.PRNGKey(0), dummy), seed=0)["params"]
    # every phone 7 frames, whatever the random weights (as test_torch_serving)
    head = params["variance_adaptor"]["duration_predictor"]["linear"]
    head["kernel"][:] = 0.0
    head["bias"][:] = np.log(8.0)

    g = np.random.default_rng(0)
    dvecs = {f"spk{i}": g.standard_normal(16).astype(np.float32) for i in range(2)}
    # two clusters of utterance priors, so the BIC picks k > 1
    priors = {s: {"pitch": np.concatenate([g.uniform(100, 120, 60), g.uniform(180, 210, 60)]),
                  "energy": np.concatenate([g.uniform(0.2, 0.4, 60), g.uniform(0.6, 0.9, 60)])}
              for s in dvecs}
    stats = {v: {"min": -2.0, "max": 3.0, "mean": 0.5, "std": 1.5} for v in ("pitch", "energy", "snr")}
    stats["priors_pitch"] = {"min": 90.0, "max": 220.0, "mean": 150.0, "std": 40.0}
    stats["priors_energy"] = {"min": 0.1, "max": 1.0, "mean": 0.5, "std": 0.2}
    sidecar = {"phone2id": phone2id, "stats": stats, "speaker2dvector": dvecs,
               "speaker2priors": priors}
    state = SimpleNamespace(params=params, opt_state={"count": np.zeros((), np.int32)},
                            step=np.asarray(3, np.int32))
    jax_dir = root / "jax"
    JCheckpointer(jax_dir).save(3, state, cfg, sidecar)
    gmms = fit_speaker_gmms(priors, ("pitch", "energy"))
    assert max(m.gmm.n_components for m in gmms.values()) > 1
    dv_gmms = fit_dvector_gmms(
        [(s, v + 0.1 * g.standard_normal((30, 16))) for s, v in dvecs.items()])
    (jax_dir / "prior_gmms.pkl").write_bytes(pickle.dumps(gmms))
    (jax_dir / "dvector_gmms.pkl").write_bytes(pickle.dumps(dv_gmms))

    hcfg = tiny_hifigan(jhg)
    # the JAX init's N(0, 0.01) kernels and zero biases, scaled up 8x so the
    # waveform is not near zero (as test_torch_serving)
    hparams = _seeded(jax.eval_shape(jhg.Generator(hcfg).init, jax.random.PRNGKey(1),
                                     jnp.zeros((1, 16, 80))), seed=1, kernel_std=0.08)
    voc_dir = root / "jax_voc"
    JCheckpointer(voc_dir).save(
        # the generator alone: the script converts a discriminator tree and
        # the optimizer states only beside a real one (tests/test_torch_vocoder_resume.py)
        2, SimpleNamespace(params={"gen": hparams},
                           opt_state={"gen": [np.zeros(1, np.float32)]},
                           step=np.asarray(2, np.int32)),
        sidecar={"hifigan_config": dataclasses.asdict(hcfg)})

    torch_dir, torch_voc = root / "torch", root / "torch_voc"
    convert(jax_dir, torch_dir)
    convert(voc_dir, torch_voc)
    return SimpleNamespace(jax=jax_dir, jax_voc=voc_dir, torch=torch_dir, torch_voc=torch_voc,
                           root=root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """2 speakers (spk0, spk1: the checkpoint's d-vector table) x 2
    utterances."""
    return make_corpus(tmp_path_factory.mktemp("cli_corpus"), n_speakers=2, n_utts=2, seed=0)


@pytest.fixture(autouse=True)
def _jax_g2p_loaded_once(monkeypatch):
    """The JAX CLI loads the builtin neural G2P on every run (a model.init
    and a decode compile, seconds each on the CPU); here each path is loaded
    by ``NeuralG2P.load`` once per process and the same model serves every
    run."""
    load = JNeuralG2P.load
    monkeypatch.setattr(JNeuralG2P, "load",
                        classmethod(lambda cls, path: jax_neural_g2p(path, load)))


def _record(monkeypatch, module):
    """Record the phone ids and the float waveform the CLI's generator
    makes (the waveform as save_audio gets it, before the int16 write)."""
    seen = {}
    cls = module.SpeechGenerator
    text_to_ids, save_audio = cls.text_to_ids, cls.save_audio

    def ids(self, text):
        seen["ids"] = text_to_ids(self, text)
        return seen["ids"]

    def save(self, path, audio):
        seen["wav"], seen["rate"] = np.array(audio), self.output_sampling_rate
        return save_audio(self, path, audio)

    monkeypatch.setattr(cls, "text_to_ids", ids)
    monkeypatch.setattr(cls, "save_audio", save)
    return seen


@pytest.mark.parametrize("flags", [
    ["--prior_strategy", "sample"],
    ["--prior_strategy", "gmm"],
    ["--prior_strategy", "gmm", "--sample_dvector"],
], ids=["sample", "gmm", "sample_dvector"])
def test_cli_matches_jax(checkpoints, monkeypatch, flags):
    c = checkpoints
    tag = "_".join(flags).replace("-", "")
    common = ["--sentence", SENTENCE, "--seed", "3", "--speaker", "spk1", *flags]
    jseen = _record(monkeypatch, jgen_mod)
    jcli.main(["--checkpoint_dir", str(c.jax), "--hifigan_checkpoint", str(c.jax_voc),
               "--output_path", str(c.root / f"out_jax_{tag}"), *common])
    tseen = _record(monkeypatch, tgen_mod)
    wav = tcli.main(["--checkpoint_dir", str(c.torch), "--hifigan_checkpoint",
                     str(c.torch_voc), "--output_path", str(c.root / f"out_torch_{tag}"),
                     "--device", "cpu", *common])
    np.testing.assert_array_equal(tseen["ids"], jseen["ids"])
    assert len(tseen["ids"]) > 10
    np.testing.assert_array_equal(wav, tseen["wav"])
    ref = jseen["wav"]
    assert wav.shape == ref.shape and len(wav) == 7 * HOP * len(tseen["ids"])
    assert np.isfinite(wav).all() and np.abs(ref).max() > 0.05
    np.testing.assert_allclose(wav, ref, rtol=0, atol=ATOL)
    a, sr_a = wav_io.read(c.root / f"out_torch_{tag}" / "sentence.wav")
    b, sr_b = wav_io.read(c.root / f"out_jax_{tag}" / "sentence.wav")
    assert sr_a == sr_b == 22050 == tseen["rate"]
    assert np.abs(a * 32768 - b * 32768).max() <= 1.0


def _record_saves(monkeypatch, module):
    """The float waveform of every save_audio call, by file path."""
    seen = {}
    save_audio = module.SpeechGenerator.save_audio

    def save(self, path, audio):
        seen[Path(path)] = np.array(audio)
        return save_audio(self, path, audio)

    monkeypatch.setattr(module.SpeechGenerator, "save_audio", save)
    return seen


def test_cli_dataset_matches_jax(checkpoints, corpus, monkeypatch):
    c = checkpoints
    out_j, out_t = c.root / "resynth_jax", c.root / "resynth_torch"
    jseen = _record_saves(monkeypatch, jgen_mod)
    jcli.main(["--checkpoint_dir", str(c.jax), "--hifigan_checkpoint", str(c.jax_voc),
               "--dataset", str(corpus), "--output_path", str(out_j)])
    tseen = _record_saves(monkeypatch, tgen_mod)
    wavs = tcli.main(["--checkpoint_dir", str(c.torch), "--hifigan_checkpoint",
                      str(c.torch_voc), "--dataset", str(corpus), "--output_path", str(out_t),
                      "--device", "cpu"])
    files = sorted(p.relative_to(out_j) for p in out_j.rglob("*") if p.is_file())
    assert files == sorted(p.relative_to(out_t) for p in out_t.rglob("*") if p.is_file())
    assert len(files) == 4 * 4 and len(wavs) == 4
    for key, wav in wavs.items():
        name = Path(key + ".wav")
        ref = jseen[out_j / name]
        np.testing.assert_array_equal(wav, tseen[out_t / name])
        meta_t = pickle.loads((out_t / key).with_suffix(".meta").read_bytes())
        meta_j = pickle.loads((out_j / key).with_suffix(".meta").read_bytes())
        assert set(meta_t) == set(meta_j) == {"phones", "durations"}
        for k in meta_j:
            assert meta_t[k].dtype == meta_j[k].dtype
            np.testing.assert_array_equal(meta_t[k], meta_j[k])
        assert (out_t / key).with_suffix(".lab").read_text() == \
            (out_j / key).with_suffix(".lab").read_text() == "synthetic"
        orig = Path(key + "_original.wav")
        assert (out_t / orig).read_bytes() == (out_j / orig).read_bytes()
        # every phone 7 frames of 16 samples, as in sentence mode
        assert wav.shape == ref.shape and len(wav) == 7 * HOP * len(meta_j["phones"])
        assert np.isfinite(wav).all() and np.abs(ref).max() > 0.05
        np.testing.assert_allclose(wav, ref, rtol=0, atol=ATOL)
        a, sr_a = wav_io.read(out_t / name)
        b, sr_b = wav_io.read(out_j / name)
        assert sr_a == sr_b == 22050
        assert np.abs(a * 32768 - b * 32768).max() <= 1.0


def test_cli_picks_differ_by_strategy(checkpoints):
    """The three runs above drew different priors / d-vectors: the prior
    GMM and the d-vector GMM change the request."""
    c = checkpoints
    outs = []
    for flags in (["--prior_strategy", "sample"], ["--prior_strategy", "gmm"],
                  ["--prior_strategy", "gmm", "--sample_dvector"]):
        args = tcli.build_parser().parse_args(
            ["--checkpoint_dir", str(c.torch), "--hifigan_checkpoint", str(c.torch_voc),
             "--sentence", SENTENCE, "--seed", "3", "--speaker", "spk1", "--device", "cpu",
             *flags])
        gen, cfg, _ = tcli.load_generator(args)
        outs.append(tcli.synthesize_sentence(gen, cfg, args))
    assert not np.allclose(outs[0], outs[1]) and not np.allclose(outs[1], outs[2])


def test_vocoder_dir_keeps_speaker_tables(checkpoints):
    """The vocoder directory's sidecar must not replace the acoustic one's:
    the speaker, prior and GMM tables survive (the port's counterpart of
    test_cli.py test_trained_vocoder_dir_keeps_speaker_tables)."""
    c = checkpoints
    args = tcli.build_parser().parse_args(
        ["--checkpoint_dir", str(c.torch), "--hifigan_checkpoint", str(c.torch_voc),
         "--device", "cpu"])
    gen, _, sidecar = tcli.load_generator(args)
    assert set(gen.speaker2dvector) == {"spk0", "spk1"}
    assert set(gen.speaker2priors) == {"spk0", "spk1"}
    assert set(gen.speaker_gmms) == {"spk0", "spk1"} and set(gen.dvector_gmms) == {"spk0", "spk1"}
    assert sidecar.get("speaker2dvector") and "hifigan_config" not in sidecar
    assert gen.synthesiser.cfg.upsample_rates == (8, 2)


def test_cli_raises_without_card(checkpoints, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcli.main(["--checkpoint_dir", str(checkpoints.torch), "--sentence", "hello.",
                   "--output_path", str(tmp_path)])


def test_cli_unported_modes_name_their_roadmap_items(checkpoints, corpus, tmp_path):
    """``--hub`` alone still raises naming A8; ``--dataset`` (A9) runs, and
    stops at ``--hours``."""
    out = tcli.main(["--checkpoint_dir", str(checkpoints.torch), "--dataset", str(corpus),
                     "--device", "cpu", "--no_vocoder", "--output_path", str(tmp_path / "all")])
    assert len(out) == 4 and all(np.isfinite(w).all() and w.size for w in out.values())
    for key in out:
        for suffix in (".wav", "_original.wav", ".lab", ".meta"):
            assert (tmp_path / "all" / f"{key}{suffix}").exists()
    one = tcli.main(["--checkpoint_dir", str(checkpoints.torch), "--dataset", str(corpus),
                     "--device", "cpu", "--no_vocoder", "--hours", "1e-9",
                     "--output_path", str(tmp_path / "one")])
    assert list(one) == list(out)[:1]
    with pytest.raises(SystemExit, match="--dataset"):
        tcli.main(["--checkpoint_dir", str(checkpoints.torch), "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="A8"):
        tcli.main(["--hub", "some/repo", "--sentence", "hello.", "--device", "cpu"])


def test_cli_hub_with_checkpoint_dir_serves_the_directory(checkpoints):
    """As the JAX CLI (``cli/generate.py`` there): ``--hub`` downloads only
    without ``--checkpoint_dir``; with one, the directory serves."""
    c = checkpoints
    wav = tcli.main(["--hub", "some/repo", "--checkpoint_dir", str(c.torch),
                     "--hifigan_checkpoint", str(c.torch_voc), "--sentence", "hello world.",
                     "--seed", "3", "--speaker", "spk1", "--device", "cpu",
                     "--output_path", str(c.root / "out_hub")])
    assert wav.size > 0 and np.isfinite(wav).all()
    assert (c.root / "out_hub" / "sentence.wav").exists()


def test_load_torch_generator_matches_jax(tmp_path):
    """A released-layout generator file (nested under "generator", one conv
    weight-normed) loads through the port's ``load_torch_generator`` as
    through the JAX package's, whose tree ``from_jax_hifigan`` maps."""
    from lightningfastspeech2_tpu_torch.utils.convert import from_jax_hifigan
    from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg

    cfg_t, cfg_j = tiny_hifigan(thg), tiny_hifigan(jhg)
    state = thg.Synthesiser(cfg_t, device="cpu", seed=4).model.state_dict()
    g = torch.Generator().manual_seed(0)
    state = {k: v + 0.01 * torch.randn(v.shape, generator=g) for k, v in state.items()}
    w = state.pop("conv_pre.weight")
    state["conv_pre.weight_g"] = w.flatten(1).norm(dim=1).reshape(-1, 1, 1) * 2.0
    state["conv_pre.weight_v"] = w
    torch.save({"generator": state}, tmp_path / "g.pth.tar")
    ours = thg.load_torch_generator(tmp_path / "g.pth.tar", cfg_t)
    ref = from_jax_hifigan(jhg.load_torch_generator(tmp_path / "g.pth.tar", cfg_j), cfg_t)
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(ours["conv_pre.weight"].numpy(), 2.0 * w.numpy(), rtol=1e-5)
    with pytest.raises(ValueError, match="not a HiFi-GAN generator"):
        torch.save({"x": torch.zeros(1)}, tmp_path / "bad.pt")
        thg.load_torch_generator(tmp_path / "bad.pt", cfg_t)
