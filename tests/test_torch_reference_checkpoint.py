"""Reference checkpoints through the port (utils/reference_checkpoint.py)
and through the JAX package (utils/torch_convert.py): a reference-layout
litfass ``.ckpt`` (the state dict and the sidecar the reference adds) and a
FastDiff checkpoint with weight-norm pairs nested at
``["state_dict"]["model"]``, both written from seeded port weights. The
two loaders' models give the same outputs, and the sidecars are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from lightningfastspeech2_tpu.models.fastspeech2 import make_dummy_batch
from lightningfastspeech2_tpu.utils import torch_convert as jtc
from lightningfastspeech2_tpu.vocoder import fastdiff as jfd
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2
from lightningfastspeech2_tpu_torch.utils import reference_checkpoint as trc
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastdiff
from lightningfastspeech2_tpu_torch.vocoder import fastdiff as tfd
from tests.torch_port_helpers import seeded_params, tiny_config, torch_threads

# f32 end to end; XLA and torch sum in different orders
# (tests/test_torch_model.py's tolerance)
ATOL = 1e-4
# a small FastDiff (tests/test_torch_fastdiff.py's SMALL)
SMALL = dict(inner_channels=8, upsample_ratios=(2, 2, 4), lvc_layers_each_block=2,
             kpnet_hidden_channels=16, step_embed_dim_in=32, step_embed_dim_mid=64,
             step_embed_dim_out=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _sidecar():
    g = np.random.default_rng(5)
    return {
        "stats": {"pitch": {"min": -2.0, "max": 3.0, "mean": 0.1, "std": 1.2}},
        "phone2id": {"[PAD]": 0, "a": 1, "b": 2},
        "speaker2id": {"spk0": 0, "spk1": 1},
        "speaker2dvector": {"spk0": g.standard_normal(16).astype(np.float32)},
        "speaker2priors": {"spk0": {"pitch": [0.5, 0.25]}},
        "speaker_gmms": {"spk0": {"weights": [1.0]}},
        "dvector_gmms": {"all": {"means": [[0.0, 1.0]]}},
    }


@pytest.mark.parametrize("prefix", ["", "model."])
def test_reference_ckpt_matches_jax(tmp_path, prefix):
    jcfg, tcfg = tiny_config(JC), tiny_config(TC)
    port = build_fastspeech2(tcfg.model, device="cpu", seed=3)
    with torch.no_grad():   # about 7 frames a phone, so inference expands
        port.variance_adaptor.duration_predictor.linear.bias.fill_(np.log(8.0))
    state = {prefix + k: v for k, v in port.state_dict().items()}
    state[prefix + "loss_weights"] = torch.ones(3)     # a key neither model has
    path = tmp_path / "reference.ckpt"
    torch.save({"state_dict": state, "epoch": 3, "optimizer_states": [{}], **_sidecar()}, path)

    variables, jside = jtc.load_reference_checkpoint(str(path), jcfg)
    tstate, tside = trc.load_reference_checkpoint(path, tcfg)
    assert set(tside) == set(jside) == set(trc.SIDECAR_KEYS)
    for k, v in _sidecar().items():
        if k == "speaker2dvector":
            assert np.array_equal(tside[k]["spk0"], v["spk0"])
            assert np.array_equal(jside[k]["spk0"], v["spk0"])
        else:
            assert tside[k] == jside[k] == v
    assert set(tstate) == set(port.state_dict())
    loaded = build_fastspeech2(tcfg.model, device="cpu", state_dict=tstate)

    batch = make_dummy_batch(jcfg.model, batch_size=2, n_phones=12, seed=0)
    batch["phones"][1, 9:] = 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    ref = jax.jit(lambda p, b: JaxFastSpeech2(jcfg.model).apply(p, b, inference=True))(
        variables, jb)
    with torch.no_grad():
        out = loaded(tb, inference=True)
    rounded = out["duration_rounded"].numpy()
    np.testing.assert_array_equal(np.asarray(ref["duration_rounded"]), rounded)
    assert rounded[0].sum() > 50
    np.testing.assert_array_equal(np.asarray(ref["frame_mask"]), out["frame_mask"].numpy())
    np.testing.assert_allclose(out["mel"].numpy(), np.asarray(ref["mel"]), rtol=0, atol=ATOL)


def test_reference_ckpt_lacking_a_key_raises(tmp_path):
    tcfg = tiny_config(TC)
    state = build_fastspeech2(tcfg.model, device="cpu", seed=0).state_dict()
    del state["linear.weight"]
    torch.save({"state_dict": state}, tmp_path / "bad.ckpt")
    with pytest.raises(KeyError, match="linear.weight"):
        trc.load_reference_checkpoint(tmp_path / "bad.ckpt", tcfg)


def _weight_normed(state, rng):
    """Every conv weight (3-D) of ``state`` as a weight_g / weight_v pair
    that folds back to it: v = w scaled by a positive factor per slice of
    dim 0, g = the slice's norm."""
    out = {}
    for k, w in state.items():
        if k.endswith(".weight") and w.ndim == 3:
            p = k[: -len(".weight")]
            norm = np.sqrt((w.astype(np.float64) ** 2).sum(axis=(1, 2), keepdims=True))
            scale = rng.uniform(0.5, 2.0, size=(w.shape[0], 1, 1))
            out[f"{p}.weight_v"] = torch.from_numpy((w * scale).astype(np.float32))
            out[f"{p}.weight_g"] = torch.from_numpy(norm.astype(np.float32))
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(w))
    return out


def test_reference_fastdiff_matches_jax(tmp_path):
    jcfg, tcfg = jfd.FastDiffConfig(**SMALL), tfd.FastDiffConfig(**SMALL)
    model = jfd.FastDiff(jcfg)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 2 * jcfg.hop_length), jnp.float32),
                            jax.ShapeDtypeStruct((1, 2, jcfg.cond_channels), jnp.float32),
                            jax.ShapeDtypeStruct((1,), jnp.float32))
    seeded = from_jax_fastdiff(seeded_params(shapes, 11), tcfg)
    state = _weight_normed(seeded, np.random.default_rng(12))
    assert sum(k.endswith(".weight_v") for k in state) > 20
    path = tmp_path / "fastdiff.ckpt"
    torch.save({"state_dict": {"model": state}, "steps": 7}, path)
    ckpt = torch.load(path, map_location="cpu", weights_only=True)

    variables = jtc.convert_fastdiff_state_dict(
        {k: v.numpy() for k, v in ckpt["state_dict"]["model"].items()},
        n_blocks=len(jcfg.upsample_ratios), lvc_layers=jcfg.lvc_layers_each_block)
    tstate = trc.fastdiff_state_dict(ckpt)
    assert set(tstate) == set(seeded)
    for k, v in seeded.items():   # the pairs fold back to the weights
        np.testing.assert_allclose(tstate[k].numpy(), v, rtol=1e-5, atol=1e-7)
    # the bare state dict loads alike
    bare = trc.fastdiff_state_dict(ckpt["state_dict"]["model"])
    assert all(torch.equal(bare[k], v) for k, v in tstate.items())
    port = tfd.FastDiff(tcfg)
    port.load_state_dict(tstate)

    g = np.random.default_rng(4)
    x = g.normal(size=(2, 6 * jcfg.hop_length)).astype(np.float32)
    c = g.normal(size=(2, 6, jcfg.cond_channels)).astype(np.float32)
    ts = np.asarray([3.25, 77.5], np.float32)
    ref = np.asarray(jax.jit(model.apply)(variables, jnp.asarray(x), jnp.asarray(c),
                                          jnp.asarray(ts)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(c), torch.from_numpy(ts)).numpy()
    assert got.shape == ref.shape and np.abs(ref).max() > 0.1
    # f32: summation order only (tests/test_torch_fastdiff.py's tolerance)
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-4)
