"""The port's diffusion variance adaptor and speaker generator
(models/fastdiff_variances.py) against the JAX package's, on the CPU in f32,
from the same seeded weights (``seeded_params``) with non-default variance
statistics, JAX's draws recorded in order and handed to the port.

Training: every noise prediction and its z, the duration's, the regulated
hidden states with the teacher values' embeddings and the frame mask agree
within atol 1e-4 (the z's and the masks exactly: they are the handed draws
and integer durations). Inference runs the 4-step samplers on the handed
x_T and per-step noises: the sampled duration and variances within atol
1e-4 (f32 through four ε passes), the rounded durations exactly (the seeded
weights keep the samples away from a rounding tie), and the sampled
variances' embeddings in the hidden states within atol 1e-4. The speaker
generator's ε prediction and sample agree within atol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.models import fastdiff_variances as jfv
from lightningfastspeech2_tpu.models.variance_adaptor import VarianceStats as JStats
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models import fastdiff_variances as tfv
from lightningfastspeech2_tpu_torch.models.draws import HandedDraws
from lightningfastspeech2_tpu_torch.models.variance_adaptor import VarianceStats as TStats
from lightningfastspeech2_tpu_torch.utils import convert
from tests.torch_port_helpers import recorded_jax_draws, seeded_params, torch_threads

ATOL = 1e-4
H, B, P, T = 16, 2, 8, 48
STATS = {"pitch": dict(min=-1.5, max=2.0, mean=0.2, std=1.3),
         "energy": dict(min=-1.0, max=1.0, mean=-0.1, std=0.7)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _cfgs(C):
    var = C.VarianceConfig(variances=("pitch", "energy"), levels=("frame", "frame"),
                           transforms=("none", "none"), losses=("mse", "mse"),
                           nlayers=(2, 2), kernel_sizes=(3, 5), dropouts=(0.0, 0.0),
                           loss_weights=(1.0, 1.0), filter_size=H, nbins=16)
    return var, C.DurationConfig(nlayers=2, kernel_size=3, filter_size=H, dropout=0.0)


@pytest.fixture(scope="module")
def adaptor_pair():
    g = np.random.default_rng(0)
    x = g.standard_normal((B, P, H)).astype(np.float32)
    mask = np.arange(P)[None, :] < np.array([[P], [6]])
    dur = (g.integers(2, 6, (B, P)) * mask).astype(np.int32)
    targets = {"duration": dur,
               **{f"variances_{v}": g.standard_normal((B, T)).astype(np.float32)
                  for v in STATS}}
    jvar, jdur = _cfgs(JC)
    jstats = tuple((v, JStats(**s)) for v, s in STATS.items())
    jm = jfv.FastDiffVarianceAdaptor(jvar, jdur, H, T, jstats, 16, 4)
    jt = {k: jnp.asarray(v) for k, v in targets.items()}
    rngs = {"params": jax.random.PRNGKey(0), "sdp": jax.random.PRNGKey(1)}
    shapes = jax.eval_shape(lambda: jm.init(rngs, jnp.asarray(x), jnp.asarray(mask), jt))
    params = seeded_params(shapes["params"], 2)
    tvar, tdur = _cfgs(TC)
    state = {}
    convert._diffusion_adaptor(state, "a", params,
                               TC.ModelConfig(variance=tvar, duration=tdur))
    tm = tfv.FastDiffVarianceAdaptor(tvar, tdur, H, tuple((v, TStats(**s))
                                                          for v, s in STATS.items()), 16, 4)
    tm.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in state.items()})
    tm.eval()
    tt = {k: torch.from_numpy(v) for k, v in targets.items()}
    return jm, params, tm, x, mask, jt, tt


def _run(adaptor_pair, inference):
    jm, params, tm, x, mask, jt, tt = adaptor_pair
    with recorded_jax_draws() as draws:
        ref = jax.jit(lambda p, a, m, t: jm.apply({"params": p}, a, m, t, inference=inference,
                                                  rngs={"sdp": jax.random.PRNGKey(3)}))(
            params, jnp.asarray(x), jnp.asarray(mask), jt)
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(mask), T, tt, inference=inference,
                 draws=HandedDraws(draws))
    return ref, got, draws


def _close(a, b, what):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=ATOL, err_msg=what)


def test_adaptor_training_matches_jax(adaptor_pair):
    ref, got, draws = _run(adaptor_pair, inference=False)
    # U for the duration, then (step, noise) for the duration and each variance
    assert [d.shape for d in draws] == [(B, P), (B,), (B, P)] + [(B,), (B, T)] * 2
    for k in ("duration_prediction", "x", "out") + tuple(f"variances_{v}" for v in STATS):
        _close(got[k], ref[k], k)
    for k in ("duration_z", "frame_mask", "duration_rounded") + tuple(
            f"variances_{v}_z" for v in STATS):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), err_msg=k)


def test_adaptor_inference_matches_jax(adaptor_pair):
    ref, got, draws = _run(adaptor_pair, inference=True)
    # each 4-step sampler: x_T, then one noise a step
    assert [d.shape for d in draws] == [(B, P)] * 5 + [(B, T)] * 10
    np.testing.assert_array_equal(got["duration_rounded"].numpy(),
                                  np.asarray(ref["duration_rounded"]))
    assert got["frame_mask"].sum() > 10
    for k in ("duration_prediction", "x", "out") + tuple(f"variances_{v}" for v in STATS):
        _close(got[k], ref[k], k)
    assert got["duration_z"] is None and got["variances_pitch_z"] is None


@pytest.mark.parametrize("inference", [False, True])
def test_speaker_generator_matches_jax(inference):
    D, HID = 16, 32
    g = np.random.default_rng(5)
    mean = g.standard_normal((B, D)).astype(np.float32)
    utt = (mean + 0.3 * g.standard_normal((B, D))).astype(np.float32)
    jm = jfv.FastDiffSpeakerGenerator(HID, D, D, 4)
    shapes = jax.eval_shape(lambda: jm.init({"params": jax.random.PRNGKey(0),
                                             "sdp": jax.random.PRNGKey(1)},
                                            jnp.asarray(mean), jnp.asarray(utt)))
    params = seeded_params(shapes["params"], 6)
    state = {}
    convert._speaker_generator(state, "s", params)
    tm = tfv.FastDiffSpeakerGenerator(HID, D, D, 4)
    tm.load_state_dict({k[2:]: torch.from_numpy(np.array(v)) for k, v in state.items()})
    with recorded_jax_draws() as draws:
        ref = jax.jit(lambda p, m, u: jm.apply({"params": p}, m, u, inference=inference,
                                               rngs={"sdp": jax.random.PRNGKey(7)}))(
            params, jnp.asarray(mean), jnp.asarray(utt))
    with torch.no_grad():
        got = tm(torch.from_numpy(mean), torch.from_numpy(utt), inference=inference,
                 draws=HandedDraws(draws))
    if inference:
        assert len(draws) == 5
        _close(got, ref, "sample")
    else:
        _close(got[0], ref[0], "eps")
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
