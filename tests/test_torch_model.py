"""The port's acoustic model against the JAX package's, with the JAX weights
carried across by ``from_jax_fastspeech2``: the FFT stack, the variance
adaptor and the whole FastSpeech2 in teacher-forced, inference and
duration-only modes (rounded durations compared exactly), the bucket
boundaries bit for bit, and a naming round trip through the JAX package's
own torch-state-dict converter."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.models.fastspeech2 import (
    FastSpeech2 as JaxFastSpeech2,
    init_params,
    make_dummy_batch,
)
from lightningfastspeech2_tpu.models.layers import FFTStack as JaxFFTStack
from lightningfastspeech2_tpu.models.variance_adaptor import (
    VarianceAdaptor as JaxVarianceAdaptor,
    default_stats,
)
from lightningfastspeech2_tpu.utils.torch_convert import convert_fastspeech2_state_dict
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models import variance_adaptor as tva
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastspeech2
from tests.torch_port_helpers import tiny_config

# f32 end to end; XLA and torch sum in different orders (observed ~1e-6)
ATOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = tiny_config(JC), tiny_config(TC)
    assert JC.to_dict(jcfg) == TC.to_dict(tcfg)  # identical config JSON
    assert TC.to_dict(TC.from_dict(TC.Config, JC.to_dict(jcfg))) == JC.to_dict(jcfg)
    assert TC.to_dict(TC.lightspeech_flagship()) == JC.to_dict(JC.lightspeech_flagship())
    model = JaxFastSpeech2(jcfg.model)
    batch = make_dummy_batch(jcfg.model, batch_size=2, n_phones=12, seed=0)
    batch["phones"][1, 9:] = 0                   # a shorter second item
    batch["duration"][1, 9:] = 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    params = jax.tree_util.tree_map(
        np.array, init_params(model, jax.random.PRNGKey(0), jb))
    # an untrained duration head predicts ~0 frames per phone; a bias of
    # log(8) gives ~7 frames, so inference exercises real regulation
    params["params"]["variance_adaptor"]["duration_predictor"]["linear"]["bias"][:] = np.log(8.0)
    port = build_fastspeech2(tcfg.model, device="cpu",
                             state_dict=from_jax_fastspeech2(params, tcfg.model))
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    return jcfg, model, params, jb, port, tb


def _close(a, b, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b, np.float64), np.asarray(a, np.float64),
                               rtol=0, atol=atol)


def test_fft_stack_matches(pair):
    jcfg, _, params, _, port, _ = pair
    g = np.random.default_rng(1)
    x = g.standard_normal((2, 20, 32)).astype(np.float32)
    mask = np.arange(20)[None, :] < np.array([[20], [13]])
    ref = JaxFFTStack(jcfg.model.encoder).apply(
        {"params": params["params"]["encoder"]}, jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        out = port.encoder(torch.from_numpy(x), torch.from_numpy(mask))
    _close(ref, out.numpy())


@pytest.mark.parametrize("inference", [False, True])
def test_variance_adaptor_matches(pair, inference):
    jcfg, _, params, jb, port, tb = pair
    m = jcfg.model
    g = np.random.default_rng(2)
    x = g.standard_normal((2, 32, 32)).astype(np.float32)
    phone_mask = np.asarray(jb["phones"]) != 0
    adaptor = JaxVarianceAdaptor(m.variance, m.duration, m.hidden, m.max_frames,
                                 default_stats(m.variance.variances), m.variance.nbins)
    ref = adaptor.apply({"params": params["params"]["variance_adaptor"]},
                        jnp.asarray(x), jnp.asarray(phone_mask), jb, inference=inference)
    with torch.no_grad():
        out = port.variance_adaptor(torch.from_numpy(x), torch.from_numpy(phone_mask),
                                    m.max_frames, tb, inference=inference)
    np.testing.assert_array_equal(np.asarray(ref["duration_rounded"]),
                                  out["duration_rounded"].numpy())
    np.testing.assert_array_equal(np.asarray(ref["frame_mask"]), out["frame_mask"].numpy())
    _close(ref["x"], out["x"].numpy())
    _close(ref["variances_energy"], out["variances_energy"].numpy())
    key = "reconstructed_signal" if inference else "spectrogram"
    _close(ref["variances_pitch"][key], out["variances_pitch"][key].numpy())


@pytest.mark.parametrize("mode", ["teacher_forced", "inference", "duration_only"])
def test_fastspeech2_matches(pair, mode):
    _, model, params, jb, port, tb = pair
    kw = {"teacher_forced": {}, "inference": {"inference": True},
          "duration_only": {"inference": True, "duration_only": True}}[mode]
    ref = model.apply(params, jb, **kw)
    with torch.no_grad():
        out = port(tb, **kw)
    rounded = out["duration_rounded"].numpy()
    np.testing.assert_array_equal(np.asarray(ref["duration_rounded"]), rounded)
    _close(ref["duration_prediction"], out["duration_prediction"].numpy())
    if mode == "duration_only":
        assert set(out) == {"duration_prediction", "duration_rounded", "phone_mask"}
        return
    if mode == "inference":
        assert rounded[0].sum() > 50  # regulation really expanded the phones
    np.testing.assert_array_equal(np.asarray(ref["frame_mask"]), out["frame_mask"].numpy())
    _close(ref["mel"], out["mel"].numpy())
    _close(ref["variances_snr"], out["variances_snr"].numpy())


def test_state_dict_names_round_trip(pair):
    jcfg, _, params, _, port, _ = pair
    state = {k: v.numpy() for k, v in port.state_dict().items()}
    back = convert_fastspeech2_state_dict(state, jcfg.model)
    flat_ref = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(flat_ref) == len(flat_back) == len(state) > 50
    for path, ref in flat_ref:
        np.testing.assert_array_equal(np.asarray(flat_back[path]), ref)


@pytest.mark.parametrize("lo,hi,num", [(0.0, 1.0, 15), (np.log(1e-10), 0.0, 255),
                                       (-3.7, 5.2, 255), (60.0, 400.0, 255)])
def test_bucket_boundaries_bit_exact(lo, hi, num):
    # the bins as the jitted JAX model computes them, lo and hi being
    # constants there (eager jnp.linspace differs by an ulp in a few places)
    ref = np.asarray(jax.jit(lambda: jnp.linspace(lo, hi, num))())
    bins = tva.linspace_f32(lo, hi, num)
    assert bins.dtype == np.float32
    np.testing.assert_array_equal(bins, ref)
    g = np.random.default_rng(num)
    x = np.concatenate([g.uniform(lo - 1, hi + 1, 500), ref]).astype(np.float32)
    idx = tva.bucketize(torch.from_numpy(x), torch.from_numpy(bins)).numpy()
    np.testing.assert_array_equal(
        idx, np.asarray(jnp.searchsorted(jnp.asarray(ref), jnp.asarray(x), side="left")))
