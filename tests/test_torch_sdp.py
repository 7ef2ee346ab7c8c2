"""The port's stochastic duration predictor (models/sdp.py) and its adaptor
branch against the JAX package's, on the CPU in f32, from the same seeded
non-zero weights (``seeded_params``: at init every ConvFlow's ``proj`` is
zero and every spline the identity, which would prove nothing).

JAX's draws are recorded in order (``recorded_jax_draws``) and handed to the
port (``HandedDraws``). Through the whole model (a small config with
``DurationConfig.stochastic``, four flows): the training pass's per-item
NLL within rtol 1e-4 (a sum over every frame of four flows' splines, each
carrying f32 rounding through its slope), the mel within atol 1e-4, and the
losses (the SDP's is the NLL summed over items) and ``total`` within rtol
1e-4; the inference pass's log-durations within atol 1e-4 and its rounded
durations exactly, and the port's duration-only pass draws what its full
pass draws. ``round_durations_stochastic`` equals JAX's bit for bit on
inputs whose exp lies 1e-4 or more (relative) from an integer, with exact
zeros and negatives among them. Every SDP parameter gets a gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from lightningfastspeech2_tpu.models.sdp import StochasticDurationPredictor as JaxSDP
from lightningfastspeech2_tpu.ops import length_regulator as jlr
from lightningfastspeech2_tpu.train.losses import compute_losses as j_compute_losses
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models.draws import HandedDraws, ModuleStreams
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2, make_dummy_batch
from lightningfastspeech2_tpu_torch.models.sdp import StochasticDurationPredictor
from lightningfastspeech2_tpu_torch.ops import length_regulator as tlr
from lightningfastspeech2_tpu_torch.train.losses import compute_losses
from lightningfastspeech2_tpu_torch.utils import convert
from tests.torch_port_helpers import recorded_jax_draws, seeded_params, tiny_config, torch_threads

RTOL = 1e-4
ATOL = 1e-4
C, HC, K = 16, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def sdp_pair():
    g = np.random.default_rng(0)
    B, T = 2, 12
    x = g.standard_normal((B, T, C)).astype(np.float32)
    mask = np.arange(T)[None, :] < np.array([[T], [9]])
    dur = g.integers(1, 9, (B, T)).astype(np.float32) * mask
    jm = JaxSDP(C, HC, K, 0.0, n_flows=4)
    rngs = {"params": jax.random.PRNGKey(0), "sdp": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jm.init(rngs, jnp.asarray(x), jnp.asarray(mask),
                                            jnp.asarray(dur)))
    params = seeded_params(shapes["params"], 3)
    state = {}
    convert._sdp(state, "m", params, 4)
    tm = StochasticDurationPredictor(C, HC, K, 0.0, 4)
    tm.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in state.items()})
    return jm, params, tm, x, mask, dur


def test_sdp_gradients_reach_the_flows(sdp_pair):
    _, _, tm, x, mask, dur = sdp_pair
    nll = tm(torch.from_numpy(x), torch.from_numpy(mask), torch.from_numpy(dur),
             draws=ModuleStreams(0))
    nll.sum().backward()
    for name, p in tm.named_parameters():
        assert p.grad is not None and p.grad.abs().sum() > 0, name
    tm.zero_grad(set_to_none=True)


def test_round_durations_stochastic_bit_for_bit():
    g = np.random.default_rng(7)
    x = g.uniform(-4.0, 5.0, 4096).astype(np.float32)
    e = np.exp(x.astype(np.float64))
    x = x[np.abs(e - np.round(e)) > 1e-4 * e]
    x[:64] = 0.0
    x = x.reshape(-1, 8)
    ref = np.asarray(jlr.round_durations_stochastic(jnp.asarray(x)))
    got = tlr.round_durations_stochastic(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[:8].any() and got.max() > 100


@pytest.fixture(scope="module")
def model_pair():
    # one variance and one block a stack: the JAX compiles are the file's time
    def cfg(C):
        return tiny_config(
            C, duration=C.DurationConfig(nlayers=4, filter_size=32, stochastic=True,
                                         dropout=0.0),
            encoder=C.StackConfig(hidden=32, heads=2, layers=1, kernel_sizes=(3,),
                                  conv_filter_size=64),
            decoder=C.StackConfig(hidden=32, heads=2, layers=1, kernel_sizes=(5,),
                                  conv_filter_size=64),
            variance=C.VarianceConfig(variances=("energy",), levels=("frame",),
                                      transforms=("none",), losses=("mse",), nlayers=(1,),
                                      kernel_sizes=(3,), dropouts=(0.0,), loss_weights=(0.1,),
                                      filter_size=32, nbins=16))

    jcfg, tcfg = cfg(JC), cfg(TC)
    assert JC.to_dict(jcfg) == TC.to_dict(tcfg)
    batch = make_dummy_batch(tcfg.model, batch_size=2, n_phones=12, seed=0)
    batch["phones"][1, 9:] = 0
    batch["duration"][1, 9:] = 0
    jm = JaxFastSpeech2(jcfg.model)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rngs = {"params": jax.random.PRNGKey(0), "sdp": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jm.init(rngs, jb))
    params = seeded_params(shapes["params"], 1)
    port = build_fastspeech2(tcfg.model, device="cpu",
                             state_dict=convert.from_jax_fastspeech2(params, tcfg.model))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return jcfg, tcfg, jm, params, jb, port, tb


def _with_losses(out, batch, cfg):
    return out, j_compute_losses(out, batch, cfg)


def test_adaptor_branch_and_loss_match_jax(model_pair):
    jcfg, tcfg, jm, params, jb, port, tb = model_pair
    with recorded_jax_draws() as draws:
        ref, ref_losses = jax.jit(lambda p, b: _with_losses(
            jm.apply({"params": p}, b, rngs={"sdp": jax.random.PRNGKey(2)}), b, jcfg))(params, jb)
    assert len(draws) == 1
    with torch.no_grad():
        out = port(tb, draws=HandedDraws(draws))
        losses = compute_losses(out, tb, tcfg)
    np.testing.assert_allclose(out["duration_prediction"].numpy(),
                               np.asarray(ref["duration_prediction"]), rtol=RTOL)
    np.testing.assert_allclose(out["mel"].numpy(), np.asarray(ref["mel"]), rtol=0, atol=ATOL)
    assert set(losses) == set(ref_losses)
    for k in ref_losses:
        np.testing.assert_allclose(float(losses[k]), float(ref_losses[k]), rtol=RTOL, err_msg=k)
    assert float(losses["duration"]) == pytest.approx(
        float(out["duration_prediction"].sum()), rel=1e-6)


def test_adaptor_inference_matches_jax_in_both_passes(model_pair):
    _, _, jm, params, jb, port, tb = model_pair
    with recorded_jax_draws() as draws:
        ref = jax.jit(lambda p, b: jm.apply({"params": p}, b, inference=True,
                                            rngs={"sdp": jax.random.PRNGKey(3)}))(params, jb)
    with torch.no_grad():
        out = port(tb, inference=True, draws=HandedDraws(draws))
        np.testing.assert_allclose(out["duration_prediction"].numpy(),
                                   np.asarray(ref["duration_prediction"]), rtol=0, atol=ATOL)
        np.testing.assert_array_equal(out["duration_rounded"].numpy(),
                                      np.asarray(ref["duration_rounded"]))
        # the serving passes: per-module streams made anew for each pass
        short = port(tb, inference=True, duration_only=True, draws=ModuleStreams(11))
        full = port(tb, inference=True, draws=ModuleStreams(11))
    np.testing.assert_array_equal(short["duration_rounded"].numpy(),
                                  full["duration_rounded"].numpy())
    assert int(full["duration_rounded"].sum()) > 0
