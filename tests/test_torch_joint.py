"""The port's canonical joint composition (models/joint.py with the
diffusion adaptor, the speaker generator and FastDiff's training route)
against the JAX package's, on the CPU in f32.

- ``canonical_joint``'s config JSON equals the JAX preset's.
- A small joint model (``train_config`` widths, the ``energy`` and ``srmr``
  variances, a narrow FastDiff) from the same seeded weights, over the JAX
  dataset's batches (the wav loaded, so the inputs are bitwise equal), with
  JAX's draws recorded and handed to the port: the teacher-forced forward's
  mel, ε prediction and the other noise predictions within atol 1e-4, z's
  and masks exactly, and its losses within rtol 2e-5; then ``fit`` for 2
  steps (JAX's ``fit`` path): every logged loss, ``grad_norm`` and ``lr``
  within rtol 2e-5, as ``test_torch_train_loop.py`` (f32 through two
  frameworks; the second step reads the first update). The joint step
  reaches every FastDiff parameter with a non-zero gradient (its training
  route is autograd's).
- The weight conversion round trip: the JAX joint tree saved by the JAX
  ``Checkpointer``, converted by ``scripts/jax_checkpoint_to_torch.py``, is
  what the port's model holds; the generate CLI serves it with FastDiff.
- A stochastic request (the diffusion adaptor with the speaker generator,
  and the SDP): the duration-only pass's durations equal the full pass's."""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.audio import srmr as jsr
from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.core.checkpoint import Checkpointer as JCheckpointer
from lightningfastspeech2_tpu.data import dataset as jds
from lightningfastspeech2_tpu.train import loop as jloop
from lightningfastspeech2_tpu.train.losses import compute_losses as j_compute_losses
from lightningfastspeech2_tpu.train.optim import make_optimizer as j_make_optimizer
from lightningfastspeech2_tpu.train.step import TrainState as JTrainState
from lightningfastspeech2_tpu_torch.cli import generate as gcli
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer
from lightningfastspeech2_tpu_torch.data.synthetic import make_corpus
from lightningfastspeech2_tpu_torch.models.draws import HandedDraws, ModuleStreams
from lightningfastspeech2_tpu_torch.models.joint import flatten_joint, make_fastdiff_config
from lightningfastspeech2_tpu_torch.train import loop as tloop
from lightningfastspeech2_tpu_torch.train.losses import compute_losses
from lightningfastspeech2_tpu_torch.train.step import create_train_state, to_device
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastdiff, from_jax_fastspeech2
from tests.torch_port_helpers import (
    data_config,
    recorded_jax_draws,
    seeded_params,
    train_config,
    torch_threads,
)

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
from jax_checkpoint_to_torch import convert  # noqa: E402

RTOL = 2e-5
ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True, scope="module")
def _jitted_jax_srmr():
    """JAX's ``srmr_per_window`` jitted (the JAX dataset looks it up at each
    call): one compile a length instead of one per primitive."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jsr, "srmr_per_window",
                   jax.jit(jsr.srmr_per_window, static_argnums=(1, 2, 3)))
        yield


def joint_config(C):
    """``train_config`` cut to one block a stack and one layer a predictor
    (the JAX compiles are the file's time), with two diffusion variances."""
    cfg = train_config(C)
    m = cfg.model
    var = C.replace(m.variance, variances=("energy", "srmr"), levels=("frame", "frame"),
                    transforms=("none", "none"), losses=("mse", "mse"), nlayers=(1, 1),
                    kernel_sizes=(3, 3), dropouts=(0.0, 0.0), loss_weights=(1.0, 0.5))
    return C.replace(cfg, **{
        "model.encoder": C.replace(m.encoder, layers=1, kernel_sizes=(3,)),
        "model.decoder": C.replace(m.decoder, layers=1, kernel_sizes=(5,)),
        "model.duration": C.replace(m.duration, nlayers=1),
        "model.variance": var, "model.fastdiff_vocoder": True,
        "model.fastdiff_variances": True, "model.fastdiff_speakers": True,
        "model.fastdiff_inner_channels": 8, "model.fastdiff_kpnet_hidden": 8,
        "model.fastdiff_lvc_layers": 2})


def test_canonical_joint_config_matches_jax():
    assert json.dumps(TC.to_dict(TC.canonical_joint()), sort_keys=True) == json.dumps(
        JC.to_dict(JC.canonical_joint()), sort_keys=True)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    corpus = make_corpus(tmp_path_factory.mktemp("joint_corpus"), n_speakers=2, n_utts=2,
                         seed=0)
    jcfg, tcfg = joint_config(JC), joint_config(TC)
    assert JC.to_dict(jcfg) == TC.to_dict(tcfg)
    dc = data_config(jds, jcfg)
    dataset = jds.TTSDataset(corpus, jds.DataConfig(**{**vars(dc), "load_wav": True}))
    model = jloop.build_model(jcfg, dataset)
    first = next(jloop.batch_iterator(dataset, 2, seed=0))
    assert "wav" in first and first["mel"].shape[1] >= 64
    batch = {k: jnp.asarray(v) for k, v in first.items() if isinstance(v, np.ndarray)}
    rngs = {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1),
            "sdp": jax.random.PRNGKey(2)}
    shapes = jax.eval_shape(lambda b: model.init(rngs, b, deterministic=True), batch)
    params = seeded_params(shapes["params"], 0)
    return SimpleNamespace(corpus=corpus, jcfg=jcfg, tcfg=tcfg, dataset=dataset, model=model,
                           params=params, first=first, batch=batch)


def _port_state(setup):
    model = tloop.build_model(setup.tcfg, setup.dataset, device="cpu")
    p = setup.params
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in flatten_joint({
        "acoustic": from_jax_fastspeech2(p["acoustic"], model.cfg),
        "fastdiff": from_jax_fastdiff(p["fastdiff"], make_fastdiff_config(model.cfg))}).items()})
    return create_train_state(model, setup.tcfg)


def _forward_and_losses(model, cfg, params, batch):
    out = model.apply({"params": params}, batch, schedule_p=1.0,
                      rngs={"sdp": jax.random.PRNGKey(4)})
    return out, j_compute_losses(out, batch, cfg)


def test_teacher_forced_forward_and_losses_match_jax(setup):
    with recorded_jax_draws() as draws:
        ref, ref_losses = jax.jit(lambda p, b: _forward_and_losses(
            setup.model, setup.jcfg, p, b))(setup.params, setup.batch)
    assert len(draws) == 12
    model = _port_state(setup).model.eval()
    tb = to_device({k: v for k, v in setup.first.items() if isinstance(v, np.ndarray)},
                   torch.device("cpu"))
    with torch.no_grad():
        out = model(tb, schedule_p=1.0, draws=HandedDraws(draws))
        losses = compute_losses(out, tb, setup.tcfg)
    eps, z = out["fastdiff"]
    np.testing.assert_allclose(eps.numpy(), np.asarray(ref["fastdiff"][0]), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(z.numpy(), np.asarray(ref["fastdiff"][1]))
    np.testing.assert_array_equal(out["wav_mask"].numpy(), np.asarray(ref["wav_mask"]))
    for k in ("mel", "fastdiff_var", "speaker_pred", "duration_prediction",
              "variances_energy", "variances_srmr"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), rtol=0, atol=ATOL,
                                   err_msg=k)
    assert set(losses) == set(ref_losses) >= {"fastdiff", "speakers", "srmr", "duration"}
    for k in ref_losses:
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=RTOL, err_msg=k)


@pytest.fixture(scope="module")
def fitted(setup):
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    jstate = JTrainState(params, j_make_optimizer(setup.jcfg.train).init(params),
                         jnp.zeros((), jnp.int32))
    with recorded_jax_draws() as draws:
        ref = jloop.fit(setup.jcfg, setup.dataset, max_steps=2, state=jstate)
    state = _port_state(setup)
    got = tloop.fit(setup.tcfg, setup.dataset, max_steps=2, state=state,
                    draws=HandedDraws(draws))
    return ref, got, draws


def test_fit_matches_jax(fitted):
    ref, got, draws = fitted
    assert len(draws) == 24
    assert len(got.history) == len(ref.history) == 2
    for a, b in zip(got.history, ref.history):
        assert set(a) == set(b) and "fastdiff" in b
        for k in b:
            if k != "steps_per_s":
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-7, err_msg=k)


def test_joint_step_reaches_every_fastdiff_parameter(fitted):
    model = fitted[1].state.model
    for name, p in model.fastdiff.named_parameters():
        assert p.grad is not None and float(p.grad.abs().sum()) > 0, name
    sg = model.acoustic.fastdiff_speaker_generator
    assert all(float(p.grad.abs().sum()) > 0 for p in sg.parameters())


def test_conversion_round_trip_and_generate(setup, tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    ds = setup.dataset
    sidecar = {"phone2id": ds.vocab.to_dict(), "stats": ds.stats,
               "speaker2dvector": ds.speaker2dvector}
    JCheckpointer(jdir).save(2, SimpleNamespace(params=setup.params,
                                                opt_state={"count": np.zeros((), np.int32)},
                                                step=np.asarray(2, np.int32)),
                             setup.jcfg, sidecar)
    convert(jdir, tdir)
    tree, cfg, _ = Checkpointer(tdir).restore()
    assert set(tree["params"]) == {"acoustic", "fastdiff"}
    want = _port_state(setup).model.state_dict()
    flat = flatten_joint(tree["params"])
    assert set(flat) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(flat[k].numpy(), v.numpy(), err_msg=k)
    phones = " ".join(p for p in list(ds.vocab.phone2id)[1:6])
    wav = gcli.main(["--checkpoint_dir", str(tdir), "--sentence", phones, "--use_fastdiff",
                     "true", "--lexicon_path", "none", "--g2p_model", "none", "--device", "cpu",
                     "--output_path", str(tmp_path / "gen")])
    assert wav.size > 0 and np.isfinite(wav).all()


@pytest.mark.parametrize("variant", ["diffusion", "sdp"])
def test_stochastic_request_draws_the_same_durations_in_both_passes(setup, variant):
    """The serving passes (``synthesis/generator.py infer``: per-module
    streams made anew for each pass) over the diffusion adaptor with the
    speaker generator, and over the SDP."""
    from lightningfastspeech2_tpu_torch.models.fastspeech2 import FastSpeech2

    m = setup.tcfg.model
    cfg = TC.replace(m, vocab_size=max(len(setup.dataset.vocab), 2), fastdiff_vocoder=False)
    if variant == "sdp":
        cfg = TC.replace(cfg, fastdiff_variances=False,
                         duration=TC.replace(m.duration, stochastic=True))
    model = FastSpeech2(cfg, device="cpu").eval()
    tb = to_device({k: v for k, v in setup.first.items() if isinstance(v, np.ndarray)},
                   torch.device("cpu"))
    with torch.no_grad():
        short = model(tb, inference=True, duration_only=True, draws=ModuleStreams(5))
        full = model(tb, inference=True, draws=ModuleStreams(5))
        other = model(tb, inference=True, duration_only=True, draws=ModuleStreams(6))
    np.testing.assert_array_equal(short["duration_rounded"].numpy(),
                                  full["duration_rounded"].numpy())
    assert not torch.equal(short["duration_prediction"], other["duration_prediction"])
