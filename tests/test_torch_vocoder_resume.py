"""A JAX HiFi-GAN run resumed by the port: the JAX train_vocoder CLI at
tests/test_torch_train_vocoder_cli.py's tiny config trains 3 steps with a
checkpoint after each; scripts/jax_checkpoint_to_torch.py converts its
step-2 directory (generator, discriminators, both optax AdamW states, the
step); the port's train_vocoder CLI resumes it for one step, which is held
to the JAX CLI's third step. The corpus is one file shorter than a
segment, so every batch is that file and the JAX run's third step sees
the batch the resumed run draws (a resumed sampler reseeds)."""

import importlib.util
import shutil
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.cli import train_vocoder as jcli
from lightningfastspeech2_tpu.core.checkpoint import Checkpointer as JaxCheckpointer
from lightningfastspeech2_tpu_torch.cli import train_vocoder as tcli
from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
from lightningfastspeech2_tpu_torch.data import wav as wav_io
from lightningfastspeech2_tpu_torch.utils.convert import (
    from_jax_discriminators,
    from_jax_hifigan,
)
from lightningfastspeech2_tpu_torch.vocoder.hifigan_train import HifiGanTrainConfig
from tests.torch_port_helpers import torch_threads

TINY = ["--upsample_rates", "8", "2", "--upsample_kernel_sizes", "16", "4",
        "--upsample_initial_channel", "16", "--resblock_kernel_sizes", "3",
        "--segment_size", "1024", "--batch_size", "2", "--log_every", "1"]
SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "jax_checkpoint_to_torch.py"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def _restore_tf32():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = before


def _script():
    spec = importlib.util.spec_from_file_location("jax_checkpoint_to_torch", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("resume")
    corpus = root / "wavs"
    t = np.arange(1000) / 22050.0
    rng = np.random.default_rng(0)
    wav_io.write(corpus / "utt0.wav", (0.5 * np.sin(2 * np.pi * 220 * t)
                                       + 0.05 * rng.standard_normal(t.size)).astype(np.float32),
                 22050)
    jax_dir, port_dir = root / "jax", root / "port"
    jcli.main(["--train_target_path", str(corpus), "--checkpoint_dir", str(jax_dir),
               "--log_dir", str(root / "jax_logs"), "--max_steps", "3",
               "--checkpoint_every", "1", *TINY])
    _script().convert(jax_dir, port_dir, step=2)
    converted = Checkpointer(port_dir).restore()[0]
    tcli.main(["--train_target_path", str(corpus), "--checkpoint_dir", str(port_dir),
               "--log_dir", str(root / "port_logs"), "--from_checkpoint", str(port_dir),
               "--max_steps", "3", "--checkpoint_every", "100", "--device", "cpu", *TINY])
    jax_ck = JaxCheckpointer(jax_dir)
    jax_trees = {s: jax_ck.restore(jax_dir / f"step_{s:08d}")[0] for s in (2, 3)}
    yield {"jax": jax_trees, "converted": converted,
           "resumed": Checkpointer(port_dir).restore()[0]}
    # four checkpoints of the 70.7M-parameter discriminators and their moments
    shutil.rmtree(root, ignore_errors=True)


def _port_params(tree):
    params = jax.tree_util.tree_map(np.asarray, tree["params"])
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import HifiGanConfig

    hcfg = HifiGanConfig(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                         upsample_initial_channel=16, resblock_kernel_sizes=(3,),
                         resblock_dilation_sizes=((1, 3, 5),))
    return ({"gen": from_jax_hifigan(params["gen"], hcfg),
             "disc": from_jax_discriminators(params["disc"])}, params, hcfg)


def test_conversion_carries_weights_moments_and_step(runs):
    want, params, hcfg = _port_params(runs["jax"][2])
    conv = runs["converted"]
    assert int(conv["step"]) == 2
    for part in ("gen", "disc"):
        assert set(conv["params"][part]) == set(want[part])
        for k, v in want[part].items():
            assert np.array_equal(conv["params"][part][k].numpy(), v), k
    # the moments, rebuilt here by JAX's own unflatten and mapped like the
    # weights, sit at the port parameters' indices in the optimizer
    import optax

    tcfg = HifiGanTrainConfig()
    tx = optax.adamw(optax.exponential_decay(tcfg.lr, 1, tcfg.lr_decay),
                     b1=tcfg.adam_b1, b2=tcfg.adam_b2)
    to_state = {"gen": lambda p: from_jax_hifigan(p, hcfg), "disc": from_jax_discriminators}
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator
    from lightningfastspeech2_tpu_torch.vocoder.hifigan_train import Discriminators

    names = {"gen": [n for n, _ in Generator(hcfg).named_parameters()],
             "disc": [n for n, _ in Discriminators(device="cpu").named_parameters()]}
    for part in ("gen", "disc"):
        leaves = runs["jax"][2]["opt_state"][part]
        if isinstance(leaves, dict):
            leaves = [leaves[k] for k in sorted(leaves, key=int)]
        opt = jax.tree_util.tree_unflatten(
            jax.tree_util.tree_structure(tx.init(params[part])),
            [np.asarray(l) for l in leaves])
        adam = opt[0]
        assert int(adam.count) == int(opt[2].count) == 2
        mu, nu = to_state[part](adam.mu), to_state[part](adam.nu)
        state = conv["opt_state"][part]["state"]
        assert len(state) == len(names[part])
        for i, name in enumerate(names[part]):
            assert int(state[i]["step"]) == 2
            assert np.array_equal(state[i]["exp_avg"].numpy(), mu[name]), name
            assert np.array_equal(state[i]["exp_avg_sq"].numpy(), nu[name]), name
        assert any(np.abs(v).max() > 0 for v in mu.values())


def test_resumed_step_matches_the_jax_third_step(runs):
    """The resumed port step against the JAX CLI's third: each parameter
    within 2 lr + 1e-7 (PR 21's bound: an Adam update is at most about lr
    a parameter, and a sign can differ where the two gradients are near
    0), lr the schedule's rate at step 2."""
    want, _, _ = _port_params(runs["jax"][3])
    before, _, _ = _port_params(runs["jax"][2])
    got = runs["resumed"]
    assert int(got["step"]) == 3
    tcfg = HifiGanTrainConfig()
    lr = tcfg.lr * tcfg.lr_decay ** 2
    moved = 0
    for part in ("gen", "disc"):
        for k, v in want[part].items():
            err = np.abs(got["params"][part][k].numpy() - v).max()
            assert err <= 2 * lr + 1e-7, (part, k, err)
            moved += int(np.abs(v - before[part][k]).max() > 0.1 * lr)
    assert moved > 0   # the third step moved the weights
    for opt in got["opt_state"].values():
        assert {int(s["step"]) for s in opt["state"].values()} == {3}
