"""The port's train step (train/step.py) against the JAX package's on the
tiny config with every dropout rate 0: the loss dict, ``grad_norm`` and the
update (after - before) of one optimizer step, plain, with two
micro-batches, with a frozen component, and with the soft-DTW mel loss
over chunks of 48 frames (five chunks and a tail of 16); the eval step's losses; the
dummy batch draw for draw; and the serving forward after a step (the
``ffn_ln`` weights follow the parameters)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.models.fastspeech2 import FastSpeech2 as JaxFastSpeech2
from lightningfastspeech2_tpu.models.fastspeech2 import make_dummy_batch as jax_dummy_batch
from lightningfastspeech2_tpu.train.step import (
    create_train_state as jax_create_state,
    make_eval_step as jax_make_eval_step,
    make_train_step as jax_make_step,
)
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.models.fastspeech2 import build_fastspeech2, make_dummy_batch
from lightningfastspeech2_tpu_torch.train.step import (
    create_train_state,
    make_eval_step,
    make_train_step,
)
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastspeech2
from tests.torch_port_helpers import tiny_config, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _no_dropout(C):
    cfg = tiny_config(C)
    m = cfg.model
    return C.replace(cfg, **{
        "model.encoder": C.replace(m.encoder, dropout=0.0),
        "model.decoder": C.replace(m.decoder, dropout=0.0),
        "model.variance": C.replace(m.variance, dropouts=(0.0,) * len(m.variance.variances)),
        "model.duration": C.replace(m.duration, dropout=0.0),
        "train.warmup_steps": 1,   # lr 1e-4 at the first update
    })


@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _no_dropout(JC), _no_dropout(TC)
    assert JC.to_dict(jcfg) == TC.to_dict(tcfg)
    batch = jax_dummy_batch(jcfg.model, batch_size=2, n_phones=8, seed=0)
    batch["phones"][1, 6:] = 0                 # a shorter second item
    batch["duration"][1, 6:] = 0
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxFastSpeech2(jcfg.model)
    state, optimizer = jax_create_state(model, jcfg, jax.random.PRNGKey(0), jb)
    params0 = jax.tree_util.tree_map(np.array, state.params)
    return jcfg, tcfg, model, state, optimizer, params0, batch


def _port(tcfg, params):
    return build_fastspeech2(tcfg.model, device="cpu",
                             state_dict=from_jax_fastspeech2(params, tcfg.model))


def _accum(batch, n):
    out = {k: np.stack([v] * n) for k, v in batch.items()}
    out["mel"][1] = out["mel"][1][::-1] * 0.5   # the second micro-batch differs
    return out


def _soft_dtw_mel(C, cfg):
    return C.replace(cfg, **{"train.mel_loss": "soft_dtw", "train.soft_dtw_chunk_size": 48})


@pytest.mark.parametrize("case", ["plain", "accum2", "frozen_pitch", "soft_dtw_mel"])
def test_train_step_matches_jax(setup, case):
    jcfg, tcfg, model, state, optimizer, params0, batch = setup
    if case == "soft_dtw_mel":
        jcfg, tcfg = _soft_dtw_mel(JC, jcfg), _soft_dtw_mel(TC, tcfg)
    frozen = ("pitch",) if case == "frozen_pitch" else ()
    b = _accum(batch, 2) if case == "accum2" else batch
    jstep = jax_make_step(model, jcfg, optimizer, donate=False)
    jstate, jm = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                       jax.random.PRNGKey(1), frozen=frozen)
    jparams1 = jax.tree_util.tree_map(np.array, jstate.params)

    port = _port(tcfg, params0)
    before = {k: v.detach().clone() for k, v in port.state_dict().items()}
    st = create_train_state(port, tcfg)
    step = make_train_step(port, tcfg)
    st, tm = step(st, b, torch.Generator().manual_seed(0), frozen=frozen)
    assert st.step == 1

    # losses and grad norm: f32 on both sides, another summation order
    assert set(tm) == set(jm)
    for key in jm:
        np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=2e-5, atol=1e-6,
                                   err_msg=key)
    after_ref = from_jax_fastspeech2(jparams1, tcfg.model)
    before_ref = from_jax_fastspeech2(params0, tcfg.model)
    # the clipped gradients, from each side's first Adam moment (1 - b1) g
    grad_ref = from_jax_fastspeech2(_adam_mu(jstate.opt_state), tcfg.model)
    adam = {n: st.optimizer.state[p]["exp_avg"] for n, p in port.named_parameters()
            if p in st.optimizer.state}
    after = port.state_dict()
    n_moved = 0
    for name, ref1 in after_ref.items():
        g_ref = grad_ref[name] / 0.1
        g = adam[name].numpy() / 0.1 if name in adam else np.zeros_like(g_ref)
        # f32 gradients through two frameworks: summation order only
        np.testing.assert_allclose(g, g_ref, rtol=1e-3, atol=1e-7, err_msg=name)
        upd_ref = ref1 - before_ref[name]
        upd = (after[name] - before[name]).numpy()
        # one AdamW step of lr 1e-4 moves each element by about lr * g / |g|;
        # where |g| is float noise (e.g. the key bias, whose true gradient
        # is 0) that direction is arbitrary, so elements are compared where
        # |g| > 1e-6, to 2 % of lr
        sure = np.abs(g_ref) > 1e-6
        np.testing.assert_allclose(upd[sure], upd_ref[sure], rtol=0, atol=2e-6, err_msg=name)
        if "encoders.pitch." in name and frozen:
            assert not np.any(upd), name
        n_moved += int(np.abs(upd_ref).max() > 5e-5)
    assert n_moved > 0.8 * len(after_ref)


def _adam_mu(opt_state):
    if hasattr(opt_state, "mu"):
        return jax.tree_util.tree_map(np.asarray, opt_state.mu)
    for s in opt_state if isinstance(opt_state, tuple) else ():
        mu = _adam_mu(s)
        if mu is not None:
            return mu
    return None


def test_eval_step_matches_jax(setup):
    jcfg, tcfg, model, state, _, params0, batch = setup
    jlosses, _, jout_inf, _ = jax_make_eval_step(model, jcfg)(
        state.params, {k: jnp.asarray(v) for k, v in batch.items()})
    losses, _, out_inf, _ = make_eval_step(_port(tcfg, params0), tcfg)(batch)
    for key in jlosses:
        np.testing.assert_allclose(float(losses[key]), float(jlosses[key]), rtol=2e-5,
                                   atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(out_inf["duration_rounded"].numpy(),
                                  np.asarray(jout_inf["duration_rounded"]))


def test_forward_after_step_uses_updated_weights(setup):
    _, tcfg, _, _, _, params0, batch = setup
    port = _port(tcfg, params0)
    st = create_train_state(port, tcfg)
    make_train_step(port, tcfg)(st, batch, torch.Generator().manual_seed(0))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    fresh = build_fastspeech2(tcfg.model, device="cpu",
                              state_dict={k: v.clone() for k, v in port.state_dict().items()})
    port.eval()
    with torch.no_grad():
        a, b = port(tb)["mel"], fresh(tb)["mel"]
        before = _port(tcfg, params0)(tb)["mel"]
    assert torch.equal(a, b)
    assert not torch.equal(a, before)


def test_dummy_batch_matches_jax():
    cfg_j, cfg_t = tiny_config(JC), tiny_config(TC)
    ref = jax_dummy_batch(cfg_j.model, batch_size=3, n_phones=10, seed=5)
    out = make_dummy_batch(cfg_t.model, batch_size=3, n_phones=10, seed=5)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k])
    filled = make_dummy_batch(cfg_t.model, batch_size=3, n_phones=10, n_frames=256,
                              seed=5, fill_frames=True)
    assert (filled["duration"].sum(1) == 256).all()
    assert (filled["duration"][:, 10:] == 0).all()
