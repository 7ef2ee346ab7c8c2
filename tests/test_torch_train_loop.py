"""The port's training loop (train/loop.py), SWA (train/swa.py) and the
training half of core/checkpoint.py against the JAX package's, on the CPU.

``fit`` runs 2 steps of the tiny config (every dropout rate 0, f32) from the
same seeded parameters (``from_jax_fastspeech2``) over the same
batches (the JAX dataset's, so the inputs are bitwise equal): the logged
losses, ``grad_norm`` and ``lr`` agree within rtol 2e-5 (f32 through two
frameworks, as ``test_torch_train_step.py``; 1.6e-6 measured; the second
step's losses read the first update). ``evaluate`` on the same
parameters agrees within rtol 2e-5 (the KDE-JS on predictions that differ in
the last f32 bits, soft-DTW and MCD in float64 over them); the rounded
durations, and so the duration metrics, exactly. These batches put silent
frames' energy exactly on the first bin boundary, which is what
``models/variance_adaptor.py denormalize`` keeps in step with XLA's fused
multiply-add."""

import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.train import loop as jloop
from lightningfastspeech2_tpu.train.optim import make_optimizer as j_make_optimizer
from lightningfastspeech2_tpu.train.step import TrainState as JTrainState
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.core.checkpoint import Checkpointer, warm_start
from lightningfastspeech2_tpu_torch.data import dataset as tds
from lightningfastspeech2_tpu_torch.train import loop as tloop
from lightningfastspeech2_tpu_torch.train.step import create_train_state
from lightningfastspeech2_tpu_torch.train.swa import SWA
from lightningfastspeech2_tpu_torch.utils.convert import from_jax_fastspeech2
from lightningfastspeech2_tpu_torch.utils.plotting import FRAME_PX, MAGMA, item_layout
from tests.torch_port_helpers import data_config, jax_train_setup, train_config, torch_threads

RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return jax_train_setup(tmp_path_factory)


@pytest.fixture(scope="module")
def port_dataset(setup, tmp_path_factory):
    """The port's dataset on the same corpus, with a feature cache of its own."""
    return tds.TTSDataset(setup.corpus, data_config(tds, setup.jcfg), device="cpu",
                          cache_dir=tmp_path_factory.mktemp("port_cache"))


def _port_state(setup, tcfg):
    model = tloop.build_model(tcfg, setup.dataset, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                           from_jax_fastspeech2(setup.params, model.cfg).items()})
    return create_train_state(model, tcfg)


def _jax_state(setup):
    params = jax.tree_util.tree_map(jnp.asarray, setup.params)
    return JTrainState(params, j_make_optimizer(setup.jcfg.train).init(params),
                       jnp.zeros((), jnp.int32))


@pytest.mark.parametrize("kw", [dict(), dict(shuffle=False, epochs=1),
                                dict(sort_by_length=True, seed=3)])
def test_batch_iterator_matches_jax(setup, port_dataset, kw):
    ref = list(jloop.batch_iterator(setup.dataset, 2, **{"epochs": 1, **kw}))
    got = list(tloop.batch_iterator(setup.dataset, 2, **{"epochs": 1, **kw}))
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # over the port's own dataset: the same order and integer keys
    for a, b in zip(tloop.batch_iterator(port_dataset, 2, **{"epochs": 1, **kw}), ref):
        for k in ("phones", "duration", "phones_lengths", "mel_lengths"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_fit_matches_jax(setup):
    tcfg = train_config(TC)
    ref = jloop.fit(setup.jcfg, setup.dataset, max_steps=2, state=_jax_state(setup))
    state = _port_state(setup, tcfg)
    got = tloop.fit(tcfg, setup.dataset, max_steps=2, state=state)
    assert got.state is state and state.step == 2
    assert len(got.history) == len(ref.history) == 2
    for a, b in zip(got.history, ref.history):
        assert set(a) == set(b)
        for k in b:
            if k != "steps_per_s":
                np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=1e-7, err_msg=k)
        assert a["steps_per_s"] > 0
    assert 0 <= got.loader_wait_s <= got.loop_s


def _png_size(data: bytes):
    """An RGB PNG's width, height and (h, w, 3) pixels."""
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    assert data[25] == 2   # colour type RGB
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    rows = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8).reshape(h, 3 * w + 1)
    assert not rows[:, 0].any()
    return w, h, rows[:, 1:].reshape(h, w, 3)


def test_evaluate_matches_jax(setup, tmp_path):
    tcfg = train_config(TC)
    ref = jloop.evaluate(setup.jcfg, setup.dataset, setup.model,
                         jax.tree_util.tree_map(jnp.asarray, setup.params))
    model = _port_state(setup, tcfg).model
    got = tloop.evaluate(tcfg, setup.dataset, model, media_dir=tmp_path, step=7,
                         max_examples=2)
    assert set(got) == set(ref) and "eval/mcd_mel" in got and "eval/mel_loss" in got
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL, atol=1e-7, err_msg=k)
    for k in ("eval/mae_duration", "eval/jensenshannon_duration"):
        assert got[k] == pytest.approx(ref[k], rel=1e-12)
    assert model.training   # evaluate leaves the training mode as it found it
    pngs = sorted((tmp_path / "step_00000007").glob("*.png"))
    assert [p.name for p in pngs] == ["0_pred.png", "0_true.png", "1_pred.png", "1_true.png"]
    # each mel through plot_item: the title strip over the 80 bins, the
    # mel's own range spanning the colour map's ends
    w, h, img = _png_size(pngs[1].read_bytes())
    geo = item_layout(w // FRAME_PX, 80, 0, phones=False)
    assert (h, w) == (geo["height"], geo["width"]) and w > 10
    mel = img[geo["mel_top"]:].reshape(-1, 3)
    assert {tuple(MAGMA[0]), tuple(MAGMA[-1])} <= {tuple(p) for p in mel}


def test_swa_is_a_running_mean_of_copies():
    g = torch.Generator().manual_seed(0)
    live = {"a": torch.randn(3, 4, generator=g), "b": torch.randn(5, generator=g)}
    swa = SWA(start_step=2, every=2)
    seen = []
    for step in range(8):
        for v in live.values():
            v.add_(torch.randn(v.shape, generator=g))   # the step updates in place
        swa.update(step, live)
        if step >= 2 and (step - 2) % 2 == 0:
            seen.append({k: v.clone() for k, v in live.items()})
    assert swa.n == len(seen) == 3
    for k in live:
        np.testing.assert_allclose(swa.params[k].numpy(),
                                   np.mean([s[k].numpy() for s in seen], axis=0), rtol=1e-6)
        assert swa.params[k].data_ptr() != live[k].data_ptr()


def test_restore_encoder_params_and_snapshots(setup):
    model = _port_state(setup, train_config(TC)).model
    snap = tloop.encoder_snapshot(model, "pitch")
    dur = tloop.encoder_snapshot(model, "duration")
    assert snap and dur and not tloop.encoder_snapshot(model, "srmr")
    assert all(not k.startswith("variance_adaptor") for k in snap)
    zeroed = {k: torch.zeros_like(v) for k, v in snap.items()}
    out = tloop.restore_encoder_params(model.state_dict(), {"pitch": zeroed, "energy": None,
                                                            "duration": dur})
    for k, v in out.items():
        if k.startswith("variance_adaptor.encoders.pitch."):
            assert not v.any()
        else:
            assert torch.equal(v, model.state_dict()[k]), k


def test_fit_freezes_restores_and_stops(setup):
    """eval_fn's (frozen, restores) writes the snapshot back and freezes the
    encoder for the steps after it; StopTraining ends the loop."""
    tcfg = train_config(TC, eval_every=1)
    state = _port_state(setup, tcfg)
    snap0 = tloop.encoder_snapshot(state.model, "pitch")
    calls = []

    def eval_fn(step_i, st):
        calls.append(step_i)
        if step_i == 0:
            return ("pitch",), {"pitch": snap0}
        if step_i == 2:
            raise tloop.StopTraining
        return ("pitch",)

    res = tloop.fit(tcfg, setup.dataset, max_steps=5, state=state, eval_fn=eval_fn)
    assert calls == [0, 1, 2] and state.step == 3 and len(res.history) == 3
    for k, v in tloop.encoder_snapshot(state.model, "pitch").items():
        assert torch.equal(v, snap0[k]), k


def test_fit_closes_the_loader_on_every_exit(setup, monkeypatch):
    from lightningfastspeech2_tpu_torch.data import loader as loader_mod

    closed = []

    class FakeLoader:
        def __init__(self, dataset, batch_size, bucketer, seed, num_workers, prefetch, device):
            self.args = (batch_size, seed, num_workers, prefetch, device)
            self.it = tloop.batch_iterator(dataset, batch_size, bucketer, seed=seed)

        def __iter__(self):
            return self.it

        def close(self):
            closed.append(self.args)

    monkeypatch.setattr(loader_mod, "PrefetchLoader", FakeLoader)
    tcfg = train_config(TC, num_workers=2, eval_every=1)
    setup.dataset.device = "cpu"

    def stop(step_i, st):
        raise tloop.StopTraining

    def fail(step_i, st):
        raise RuntimeError("eval failed")

    tloop.fit(tcfg, setup.dataset, max_steps=3, state=_port_state(setup, tcfg), eval_fn=stop)
    with pytest.raises(RuntimeError, match="eval failed"):
        tloop.fit(tcfg, setup.dataset, max_steps=3, state=_port_state(setup, tcfg), eval_fn=fail)
    assert closed == [(2, 0, 2, 4, "cpu")] * 2


def test_checkpoint_keeps_the_optimizer_and_publishes_latest_after_the_write(tmp_path):
    model = torch.nn.Linear(3, 2)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.ones(4, 3)).sum().backward()
    opt.step()
    ckpt = Checkpointer(tmp_path / "c", use_async=True)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ckpt.save(1, model.state_dict(), opt_state=opt.state_dict())
    with torch.no_grad():
        model.weight.add_(1.0)    # the next step updates in place
        opt.state[model.weight]["exp_avg"].add_(1.0)
    assert not (ckpt.dir / "latest").exists() or ckpt._writer is None
    ckpt.wait_until_finished()
    assert (ckpt.dir / "latest").read_text() == "step_00000001"
    ckpt.save(2, model.state_dict())
    tree, _, _ = ckpt.restore(ckpt.dir / "step_00000001")   # waits for step 2
    assert (ckpt.dir / "latest").read_text() == "step_00000002"
    for k, v in before.items():
        assert torch.equal(tree["params"][k], v)
    opt2 = torch.optim.AdamW(torch.nn.Linear(3, 2).parameters(), lr=1e-3)
    opt2.load_state_dict(tree["opt_state"])
    assert not torch.equal(next(iter(opt2.state.values()))["exp_avg"],
                           opt.state[model.weight]["exp_avg"])
    assert tree["step"] == 1 and "opt_state" not in ckpt.restore()[0]
    # a synchronous checkpointer publishes at once
    sync = Checkpointer(tmp_path / "s")
    sync.save(3, {"w": torch.ones(2)})
    assert (sync.dir / "latest").read_text() == "step_00000003"


def test_warm_start_merges_by_name_and_shape():
    fresh = {"a": torch.zeros(2, 3), "b": torch.zeros(4), "c": torch.zeros(1)}
    restored = {"a": torch.ones(2, 3, dtype=torch.float64), "b": torch.ones(5),
                "extra": torch.ones(7)}
    merged, used, dropped = warm_start(fresh, restored)
    assert (used, dropped) == (1, 2) and set(merged) == set(fresh)
    assert merged["a"].dtype == torch.float32 and merged["a"].eq(1).all()
    assert not merged["b"].any() and not merged["c"].any()
