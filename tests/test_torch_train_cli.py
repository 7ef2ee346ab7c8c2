"""The port's train CLI (cli/train.py): its config against the JAX CLI's for
the same arguments, the flags whose modules were ported late (one of them,
``--on_device_features``, training a step), the default
device, and one run on the CPU at tiny widths (5 steps with evals,
asynchronous checkpoints, d-vectors and their GMMs, SWA, prior GMMs), whose
checkpoint the port's generate CLI then serves; a second run warm-starts
from it and restores every tensor."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.cli import train as jcli
from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu_torch.cli import generate as gcli
from lightningfastspeech2_tpu_torch.cli import train as tcli
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
from lightningfastspeech2_tpu_torch.utils.log_gmm import load_gmms
from lightningfastspeech2_tpu_torch.vocoder import hifigan as thg
from lightningfastspeech2_tpu_torch.data.dataset import DataConfig, TTSDataset
from lightningfastspeech2_tpu_torch.models.fastdiff_variances import (
    FastDiffSpeakerGenerator,
    FastDiffVarianceAdaptor,
)
from lightningfastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2
from lightningfastspeech2_tpu_torch.models.joint import JointFastSpeech2FastDiff, make_fastdiff_config
from lightningfastspeech2_tpu_torch.models.sdp import StochasticDurationPredictor
from lightningfastspeech2_tpu_torch.vocoder.fastdiff import FastDiff
from tests.torch_port_helpers import tiny_hifigan, torch_threads

TINY = ("--variances pitch energy --variance_levels phone frame --variance_transforms none none "
        "--variance_nlayers 2 2 --encoder_hidden 32 --decoder_hidden 32 --encoder_layers 2 "
        "--decoder_layers 2 --encoder_kernel_sizes 3 5 --decoder_kernel_sizes 5 3 "
        "--encoder_conv_filter_size 64 --decoder_conv_filter_size 64 --variance_filter_size 32 "
        "--duration_filter_size 32 --stat_entries 4 --augment_duration 0 --precision 32").split()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("argv", [
    [],
    TINY + ["--priors", "pitch", "duration", "--swa", "True", "--batch_size", "3"],
    ["--variances", "pitch", "energy", "snr", "--variance_transforms", "cwt",
     "--variance_levels", "frame", "--accumulate_grad_batches", "4", "--mel_loss", "soft_dtw",
     "--bf16_moments", "True", "--speaker_type", "id", "--decoder_layers", "3",
     "--zero1", "True", "--mesh_data", "2", "--seed", "7"],
])
def test_args_to_config_matches_jax(argv):
    argv = ["--train_target_path", "corpus"] + argv
    got = tcli.args_to_config(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    ref = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    assert json.dumps(TC.to_dict(got), sort_keys=True) == json.dumps(JC.to_dict(ref),
                                                                      sort_keys=True)


def test_parsers_have_the_same_flags_and_defaults():
    t = {a.dest: a.default for a in tcli.build_parser()._actions}
    j = {a.dest: a.default for a in jcli.build_parser()._actions}
    assert t.pop("device") == "cuda"
    assert t == j


@pytest.fixture(scope="module")
def srmr_corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("srmr_corpus"), n_speakers=1, n_utts=2, seed=3)


@pytest.mark.parametrize("flag,item", [
    (["--on_device_features", "True"], "A14"),
    (["--fastdiff_vocoder", "True"], "A13"),
    (["--fastdiff_variances", "True"], "A13"),
    (["--fastdiff_speakers", "True"], "A13"),
    (["--duration_stochastic", "True"], "A11"),
    (["--variances", "pitch", "srmr"], "A16"),
])
def test_unported_flags_raise_with_their_item(tmp_path, srmr_corpus, flag, item):
    """Each flag once unported is ported now (A11, A13, A14, A16): it builds
    the JAX CLI's config and the module it names; ``--on_device_features``
    (A14) trains one step on the CPU from raw wavs shipped as int16, and
    refuses ``--priors`` (raw-mode items carry none; the JAX CLI fails on
    the missing ``priors_*`` at its first batch)."""
    if item == "A14":
        argv = ["--train_target_path", str(srmr_corpus)] + TINY + flag
        got = tcli.args_to_config(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
        ref = jcli.args_to_config(jcli.build_parser().parse_args(argv))
        assert json.dumps(TC.to_dict(got), sort_keys=True) == json.dumps(JC.to_dict(ref),
                                                                          sort_keys=True)
        assert got.train.on_device_features
        run = argv + ["--device", "cpu", "--checkpoint_dir", str(tmp_path / "c"),
                      "--log_dir", str(tmp_path / "l"), "--max_steps", "1", "--batch_size", "2",
                      "--num_workers", "0", "--log_every", "1", "--compute_dvectors", "False"]
        with pytest.raises(ValueError, match="priors"):
            tcli.main(run + ["--priors", "pitch"])
        result = tcli.main(run)
        last = result.history[-1]
        assert np.isfinite([last[k] for k in ("total", "mel", "pitch", "energy")]).all()
        assert (tmp_path / "c" / "latest").exists()
        return
    if flag[0] == "--variances":
        flag = flag + ["--variance_transforms", "none", "none"]
    argv = ["--train_target_path", "corpus"] + TINY + ["--variance_levels", "frame", "frame"] + flag
    got = tcli.args_to_config(tcli.build_parser().parse_args(argv + ["--device", "cpu"]))
    ref = jcli.args_to_config(jcli.build_parser().parse_args(argv))
    assert json.dumps(TC.to_dict(got), sort_keys=True) == json.dumps(JC.to_dict(ref),
                                                                      sort_keys=True)
    tcli.check_flags(tcli.build_parser().parse_args(argv))
    m = got.model
    if item == "A16":
        ds = TTSDataset(srmr_corpus, DataConfig(variances=m.variance.variances,
                                                variance_levels=m.variance.levels,
                                                variance_transforms=m.variance.transforms,
                                                augment_duration=0.0),
                        device="cpu", compute_stats=False)
        srmr = ds[0]["variances_srmr"]
        assert srmr.shape == ds[0]["mel"].shape[:1] and np.isfinite(srmr).all()
        return
    if flag[0] == "--fastdiff_vocoder":
        module = JointFastSpeech2FastDiff(m, make_fastdiff_config(m), device="cpu").fastdiff
        want = FastDiff
    else:
        model = FastSpeech2(m, device="cpu")
        module, want = {
            "--fastdiff_variances": (model.variance_adaptor, FastDiffVarianceAdaptor),
            "--fastdiff_speakers": (getattr(model, "fastdiff_speaker_generator", None),
                                    FastDiffSpeakerGenerator),
            "--duration_stochastic": (model.variance_adaptor.duration_predictor,
                                      StochasticDurationPredictor),
        }[flag[0]]
    assert isinstance(module, want)


def test_default_device_raises_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--train_target_path", str(tmp_path)])


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_cli")
    corpus = make_corpus(root / "corpus", n_speakers=2, n_utts=4, seed=42)
    argv = ["--train_target_path", str(corpus), "--valid_target_path", str(corpus),
            "--checkpoint_dir", str(root / "ckpts"), "--log_dir", str(root / "logs"),
            "--max_steps", "5", "--batch_size", "2", "--eval_every", "5",
            "--checkpoint_every", "2", "--log_every", "1", "--priors", "pitch", "duration",
            "--cache_path", str(root / "cache"),
            "--priors_gmm", "True", "--swa", "True", "--dvector_gmm", "True",
            "--num_workers", "0", "--device", "cpu"] + TINY
    result = tcli.main(argv)
    return root, corpus, argv, result


def test_train_cli_runs_and_writes_what_generate_serves(trained):
    root, corpus, _, result = trained
    ckpts = root / "ckpts"
    assert result.state.step == 5 and len(result.history) == 5
    for h in result.history:
        assert all(np.isfinite(v) for v in h.values())
    lines = [json.loads(l) for l in (root / "logs" / "metrics.jsonl").read_text().splitlines()]
    train = [l for l in lines if "train/total_loss" in l]
    evals = [l for l in lines if "eval/mel_loss" in l]
    assert [l["step"] for l in train] == [0, 1, 2, 3, 4]
    assert [l["step"] for l in evals] == [4, 5]
    assert {"train/grad_norm", "train/lr", "train/steps_per_s", "train/mel_loss"} <= set(train[0])
    assert all(np.isfinite(v) for l in evals for k, v in l.items() if k.startswith("eval/"))
    assert {"eval/softdtw_mel", "eval/mcd_mel", "eval/jensenshannon_pitch"} <= set(evals[0])
    assert list((root / "logs" / "eval_examples" / "step_00000005").glob("*_pred.png"))
    # the latest checkpoint restores, with the optimizer, priors and d-vectors
    assert (ckpts / "latest").read_text() == "step_00000005"
    assert (ckpts / (ckpts / "best").read_text() / "tree.pt").exists()
    tree, cfg, side = Checkpointer(ckpts).restore()
    assert tree["step"] == 5 and tree["opt_state"]["state"]
    assert cfg.model.encoder.hidden == 32 and cfg.model.priors == ("pitch", "duration")
    assert set(side["speaker2priors"]) == set(side["speaker2dvector"]) == {"spk0", "spk1"}
    # SWA averaged steps 3 and 4 (from 75 % of 5 steps)
    swa, _, _ = Checkpointer(ckpts / "swa").restore()
    live = result.state.model.state_dict()
    assert set(swa["params"]) == set(live)
    assert any(not torch.equal(swa["params"][k], live[k].cpu()) for k in live)
    for name in ("prior_gmms", "dvector_gmms"):
        gmms = load_gmms(ckpts / f"{name}.pkl")
        assert set(gmms) == {"spk0", "spk1"}
    # the d-vector files carry the pipeline's tag
    assert len(list(corpus.rglob("*.????????.npy"))) == 8 + 2


def test_generate_serves_the_trained_checkpoint(trained):
    root, _, _, _ = trained
    out = root / "gen"
    hcfg = tiny_hifigan(thg)   # a small vocoder directory: the CPU's time goes to the CLIs
    Checkpointer(root / "voc").save(
        1, {"gen": thg.Synthesiser(hcfg, device="cpu", seed=1).model.state_dict()},
        sidecar={"hifigan_config": dataclasses.asdict(hcfg)})
    wav = gcli.main(["--checkpoint_dir", str(root / "ckpts"), "--sentence", "hello world.",
                     "--hifigan_checkpoint", str(root / "voc"),
                     "--output_path", str(out), "--prior_strategy", "gmm", "--sample_dvector",
                     "--speaker", "spk1", "--seed", "0", "--lexicon_path", "none",
                     "--g2p_model", "none", "--device", "cpu"])
    written, sr = wav_io.read(out / "sentence.wav")
    assert sr == 22050 and written.size == wav.size > 0 and np.isfinite(wav).all()


def test_warm_start_restores_every_tensor(trained, capsys):
    root, _, argv, first = trained
    argv = [a for a in argv]
    argv[argv.index("--checkpoint_dir") + 1] = str(root / "warm")
    argv[argv.index("--max_steps") + 1] = "1"
    argv += ["--from_checkpoint", str(root / "ckpts"), "--valid_target_path", "",
             "--priors_gmm", "False", "--dvector_gmm", "False", "--swa", "False"]
    res = tcli.main(argv)
    n = len(first.state.model.state_dict())
    assert f"warm start: {n} tensors restored, 0 kept fresh" in capsys.readouterr().out
    assert res.state.step == 1


JOINT = ["--fastdiff_vocoder", "true", "--fastdiff_variances", "true", "--fastdiff_speakers",
         "true", "--fastdiff_inner_channels", "8", "--fastdiff_kpnet_hidden", "8",
         "--fastdiff_lvc_layers", "2", "--variances", "energy", "srmr", "--variance_levels",
         "frame", "frame"]


@pytest.mark.parametrize("flags", [JOINT, ["--duration_stochastic", "true"]],
                         ids=["joint", "stochastic_duration"])
def test_joint_and_stochastic_runs_train_and_serve(srmr_corpus, tmp_path, flags):
    """Two steps with the joint flags (the diffusion adaptor, the speaker
    generator, FastDiff, an SRMR variance) or the stochastic duration
    predictor, then the generate CLI serves the checkpoint (the joint one
    through FastDiff)."""
    ck = tmp_path / "ck"
    argv = ["--train_target_path", str(srmr_corpus), "--checkpoint_dir", str(ck),
            "--log_dir", str(tmp_path / "logs"), "--max_steps", "2", "--batch_size", "2",
            "--log_every", "1", "--num_workers", "0", "--device", "cpu"] + TINY + flags
    result = tcli.main(argv)
    assert result.state.step == 2 and len(result.history) == 2
    keys = {"fastdiff", "speakers", "srmr", "duration"} if flags is JOINT else {"duration"}
    for h in result.history:
        assert keys <= set(h) and all(np.isfinite(v) for v in h.values())
    tree, cfg, _ = Checkpointer(ck).restore()
    assert (set(tree["params"]) == {"acoustic", "fastdiff"}) == (flags is JOINT)
    extra = ["--use_fastdiff", "true"] if flags is JOINT else ["--no_vocoder"]
    wav = gcli.main(["--checkpoint_dir", str(ck), "--sentence", "hello world.",
                     "--output_path", str(tmp_path / "gen"), "--lexicon_path", "none",
                     "--g2p_model", "none", "--device", "cpu"] + extra)
    assert wav.size > 0 and np.isfinite(wav).all()
