"""The port's HiFi-GAN training CLI (cli/train_vocoder.py) on the CPU, as
tests/test_vocoder_cli.py drives the JAX one: its segment sampler draws
the JAX CLI's batches bit for bit; a tiny HiFi-GAN, warm-started through
``--from_torch_hifigan`` from a weight-normed torch generator, trains 3
steps at lr 0 (checkpoint every 2, log every 1), checkpointing the folded
weights, and resumes for one more from the saved step counter; the
generate CLI serves the directory through ``--hifigan_checkpoint`` with
the architecture rebuilt from its sidecar; and an f32 ``main`` of each of
the three CLIs turns both TF32 flags off."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.cli import train_vocoder as jcli
from lightningfastspeech2_tpu_torch.cli import generate as gen_cli
from lightningfastspeech2_tpu_torch.cli import train as train_cli
from lightningfastspeech2_tpu_torch.cli import train_vocoder as tcli
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
from lightningfastspeech2_tpu_torch.data.vocab import ARPABET_TO_IPA, PUNCTUATION_TOKENS, SILENCE
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg
from tests.torch_port_helpers import tiny_config, torch_threads

TINY = ["--upsample_rates", "8", "2", "--upsample_kernel_sizes", "16", "4",
        "--upsample_initial_channel", "16", "--resblock_kernel_sizes", "3",
        "--segment_size", "1024", "--batch_size", "2", "--device", "cpu"]
TINY_CFG = thg.HifiGanConfig(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                             upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                             resblock_dilation_sizes=((1, 3, 5),))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _tf32_on():
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True


def _tf32_flags():
    return torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32


@pytest.fixture(autouse=True)
def _restore_tf32():
    before = _tf32_flags()
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


@pytest.fixture(scope="module")
def wav_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    for i in range(4):
        t = np.arange(8000 + 700 * i) / 22050.0
        sig = 0.4 * np.sin(2 * np.pi * (150 + 40 * i) * t) + 0.01 * rng.standard_normal(len(t))
        wav_io.write(root / f"utt{i}.wav", sig.astype(np.float32), 22050)
    return root


@pytest.mark.parametrize("segment", [1024, 9000])
def test_segment_sampler_matches_jax(wav_corpus, segment):
    # 9000 samples: longer than some files, which are zero-padded
    ours = tcli.SegmentSampler(wav_corpus, 22050, segment, seed=45)
    theirs = jcli.SegmentSampler(wav_corpus, 22050, segment, seed=45)
    assert [p.name for p in ours.paths] == [p.name for p in theirs.paths]
    for _ in range(4):
        a, b = ours.batch(3), theirs.batch(3)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def _torch_generator_state(rng):
    """A weight-normed torch generator's state dict at TINY_CFG."""
    state = {}

    def add(prefix, shape, out_c):
        state[f"{prefix}.weight_g"] = torch.tensor(
            np.abs(rng.standard_normal((shape[0], 1, 1))).astype(np.float32))
        state[f"{prefix}.weight_v"] = torch.tensor(rng.standard_normal(shape).astype(np.float32))
        state[f"{prefix}.bias"] = torch.tensor(rng.standard_normal(out_c).astype(np.float32))

    add("conv_pre", (16, 80, 7), 16)
    add("conv_post", (1, 4, 7), 1)
    add("ups.0", (16, 8, 16), 8)    # ConvTranspose1d: (in, out, k), bias of out
    add("ups.1", (8, 4, 4), 4)
    for rb, ch in ((0, 8), (1, 4)):
        for j in range(3):
            add(f"resblocks.{rb}.convs1.{j}", (ch, ch, 3), ch)
            add(f"resblocks.{rb}.convs2.{j}", (ch, ch, 3), ch)
    return state


@pytest.fixture(scope="module")
def trained(wav_corpus, tmp_path_factory):
    """3 steps warm-started from a torch generator at lr 0 (checkpoint every
    2), then a resume at the default lr for one more step."""
    root = tmp_path_factory.mktemp("voc")
    ckpt, logs = root / "voc_ckpts", root / "logs"
    base = ["--train_target_path", str(wav_corpus), "--checkpoint_dir", str(ckpt),
            "--log_dir", str(logs), "--log_every", "1", *TINY]
    torch_state = _torch_generator_state(np.random.default_rng(0))
    torch.save(torch_state, root / "gen.pth")
    before = _tf32_flags()
    _tf32_on()
    tcli.main(base + ["--max_steps", "3", "--checkpoint_every", "2",
                      "--from_torch_hifigan", str(root / "gen.pth"), "--lr", "0"])
    flags = _tf32_flags()
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before
    first = sorted(p.name for p in ckpt.glob("step_*"))
    warm = Checkpointer(ckpt).restore()[0]["params"]["gen"]
    tcli.main(base + ["--from_checkpoint", str(ckpt), "--max_steps", "4",
                      "--checkpoint_every", "100"])
    return {"ckpt": ckpt, "logs": logs, "root": root, "flags": flags, "first": first,
            "torch_state": torch_state, "warm": warm}


def test_cli_trains_checkpoints_and_resumes(trained):
    ckpt = trained["ckpt"]
    # every 2 steps from step 1 on, and the last: step 2 is both
    assert trained["first"] == ["step_00000003"]
    lines = [json.loads(l) for l in (trained["logs"] / "metrics.jsonl").read_text().splitlines()
             if l.strip()]
    # the fresh run logged steps 0..2, the resumed one 3
    assert [l["step"] for l in lines] == [0, 1, 2, 3]
    for l in lines:
        for k in ("d_loss", "g_loss", "adv", "fm", "mel", "steps_per_s"):
            assert np.isfinite(l[f"train/{k}"]), k
    tree, cfg, sidecar = Checkpointer(ckpt).restore()
    assert tree["step"] == 4 and cfg is None
    assert set(tree["params"]) == {"gen", "disc"} and set(tree["opt_state"]) == {"gen", "disc"}
    for opt in tree["opt_state"].values():   # both optimizers made 4 updates
        assert {int(s["step"]) for s in opt["state"].values()} == {4}
    assert thg.HifiGanConfig.from_dict(sidecar["hifigan_config"]) == TINY_CFG
    # the resumed step, at the default lr, moved the generator
    assert any(not torch.equal(v, trained["warm"][k]) for k, v in tree["params"]["gen"].items())


def _acoustic_checkpoint(root: Path) -> Path:
    """A tiny acoustic checkpoint of the port, every phone 7 frames."""
    phones = sorted(set(ARPABET_TO_IPA.values()) | set(PUNCTUATION_TOKENS.values()) | {SILENCE})
    phone2id = {"[PAD]": 0, **{p: i + 1 for i, p in enumerate(phones)}}
    cfg = tiny_config(TC, vocab_size=len(phone2id))
    model = build_fastspeech2(cfg.model, device="cpu", seed=0)
    with torch.no_grad():
        head = model.variance_adaptor.duration_predictor.linear
        head.weight.zero_()
        head.bias.fill_(np.log(8.0))
    stats = {v: {"min": -2.0, "max": 3.0, "mean": 0.0, "std": 1.0}
             for v in cfg.model.variance.variances}
    dvec = np.random.default_rng(0).standard_normal(cfg.model.dvector_dim).astype(np.float32)
    Checkpointer(root / "acoustic").save(
        1, model.state_dict(), cfg,
        {"phone2id": phone2id, "stats": stats, "speaker2dvector": {"spk0": dvec}})
    return root / "acoustic"


def test_generate_serves_the_vocoder_directory(trained):
    acoustic = _acoustic_checkpoint(trained["root"])
    argv = ["--checkpoint_dir", str(acoustic), "--sentence", "hello world.",
            "--output_path", str(trained["root"] / "gen"), "--hifigan_checkpoint",
            str(trained["ckpt"]), "--device", "cpu", "--lexicon_path", "none",
            "--g2p_model", "none", "--seed", "0"]
    _tf32_on()
    wav = gen_cli.main(argv)
    assert _tf32_flags() == (False, False)
    gen, _, _ = gen_cli.load_generator(gen_cli.build_parser().parse_args(argv))
    assert gen.synthesiser.cfg == TINY_CFG
    # the served generator is the checkpoint's
    tree, _, _ = Checkpointer(trained["ckpt"]).restore()
    for k, v in gen.synthesiser.model.state_dict().items():
        assert torch.equal(v, tree["params"]["gen"][k]), k
    written, sr = wav_io.read(trained["root"] / "gen" / "sentence.wav")
    assert sr == 22050 and written.size == wav.size > 0 and np.isfinite(wav).all()
    assert wav.size % TINY_CFG.hop_length == 0


def test_from_torch_hifigan_warm_start(trained):
    """A weight-normed torch generator warm-starts the trainer; with lr 0 the
    checkpointed generator is its folded weights."""
    want = thg.fold_weight_norm_state(trained["torch_state"])
    assert set(trained["warm"]) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(trained["warm"][k], v, rtol=0, atol=1e-6)


def test_f32_runs_turn_tf32_off(trained, tmp_path):
    """train_vocoder's run (the fixture's), generate's (above) and the
    train CLI's ``--precision 32`` run leave both flags off."""
    assert trained["flags"] == (False, False)
    corpus = make_corpus(tmp_path / "corpus", n_speakers=1, n_utts=2, seed=1)
    tiny = ("--variances pitch energy --variance_levels phone frame --variance_transforms "
            "none none --variance_nlayers 2 2 --encoder_hidden 32 --decoder_hidden 32 "
            "--encoder_layers 2 --decoder_layers 2 --encoder_kernel_sizes 3 5 "
            "--decoder_kernel_sizes 5 3 --encoder_conv_filter_size 64 "
            "--decoder_conv_filter_size 64 --variance_filter_size 32 "
            "--duration_filter_size 32 --stat_entries 4 --augment_duration 0").split()
    _tf32_on()
    train_cli.main(["--train_target_path", str(corpus), "--checkpoint_dir", str(tmp_path / "ck"),
                    "--log_dir", str(tmp_path / "logs"), "--max_steps", "1", "--batch_size", "2", "--eval_every", "100",
                    "--checkpoint_every", "100", "--log_every", "1", "--num_workers", "0",
                    "--device", "cpu", "--precision", "32"] + tiny)
    assert _tf32_flags() == (False, False)
