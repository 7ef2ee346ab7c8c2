"""The port's checkpoint directories: save/restore round trips, the
``latest`` marker and explicit steps, and the JAX ``Checkpointer``'s config
and sidecar files read back identically through the port's reader."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.core.checkpoint import Checkpointer as JCheckpointer
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.core.checkpoint import (
    Checkpointer,
    read_config,
    read_sidecar,
)
from tests.torch_port_helpers import tiny_config


def _sidecar(seed):
    g = np.random.default_rng(seed)
    return {
        "phone2id": {"[PAD]": 0, "a": 1, "b": 2},
        "speaker2id": {"spk0": 0, "spk1": 1},
        "stats": {"pitch": {"min": -1.0, "max": 2.0, "mean": 0.1, "std": 0.9}},
        "speaker2dvector": {"spk0": g.standard_normal(16).astype(np.float32),
                            "spk1": g.standard_normal(16).astype(np.float32)},
        "speaker2priors": {"spk0": {"pitch": g.uniform(100, 200, 7),
                                    "energy": g.uniform(0, 1, 7)}},
        "hifigan_config": {"upsample_rates": [8, 2]},
    }


def _assert_sidecar_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if k in ("speaker2dvector", "speaker2priors"):
            assert set(a[k]) == set(b[k])
            for name in a[k]:
                x, y = a[k][name], b[k][name]
                if isinstance(x, dict):
                    assert set(x) == set(y)
                    for p in x:
                        np.testing.assert_array_equal(x[p], y[p])
                        assert x[p].dtype == y[p].dtype
                else:
                    np.testing.assert_array_equal(x, y)
                    assert x.dtype == y.dtype
        else:
            assert a[k] == b[k]


def test_roundtrip_latest_and_explicit_step(tmp_path):
    cfg = tiny_config(TC, priors=("pitch",))
    ck = Checkpointer(tmp_path / "ck")
    g = np.random.default_rng(0)
    p1 = {"acoustic": {"w": g.standard_normal((3, 4)).astype(np.float32),
                       "b": torch.arange(4, dtype=torch.float32)},
          "fastdiff": {"v": g.standard_normal(5).astype(np.float32)}}
    p2 = {"w": torch.ones(2, 2)}
    path1 = ck.save(1, p1, cfg, _sidecar(0))
    path2 = ck.save(2, p2, None, {"phone2id": {"[PAD]": 0}})
    assert path1.name == "step_00000001" and path2.name == "step_00000002"
    assert (tmp_path / "ck" / "latest").read_text() == "step_00000002"
    assert ck.latest_path() == path2

    tree, cfg2, side = ck.restore()
    assert tree["step"] == 2 and cfg2 is None and side == {"phone2id": {"[PAD]": 0}}
    assert torch.equal(tree["params"]["w"], torch.ones(2, 2))

    tree, cfg1, side = ck.restore(path1)
    assert tree["step"] == 1 and TC.to_dict(cfg1) == TC.to_dict(cfg)
    assert isinstance(tree["params"]["acoustic"]["w"], torch.Tensor)
    np.testing.assert_array_equal(tree["params"]["acoustic"]["w"].numpy(), p1["acoustic"]["w"])
    assert torch.equal(tree["params"]["acoustic"]["b"], p1["acoustic"]["b"])
    np.testing.assert_array_equal(tree["params"]["fastdiff"]["v"].numpy(), p1["fastdiff"]["v"])
    _assert_sidecar_equal(side, _sidecar(0))
    # the same layout as the JAX package's: json without the tables, npz with them
    assert sorted(np.load(path1 / "sidecar.npz").files) == [
        "dvec::spk0", "dvec::spk1", "prior::spk0::energy", "prior::spk0::pitch"]

    # saving a step again replaces its directory
    ck.save(1, p2)
    assert set(ck.restore(path1)[0]["params"]) == {"w"}
    assert not (path1 / "config.json").exists()


def test_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        Checkpointer(tmp_path / "empty").restore()
    # a marker naming a missing step is no checkpoint either
    ck = Checkpointer(tmp_path / "stale")
    (tmp_path / "stale" / "latest").write_text("step_00000009")
    assert ck.latest_path() is None
    with pytest.raises(FileNotFoundError):
        ck.restore()


def test_jax_checkpointer_files_read_identically(tmp_path):
    """config.json, sidecar.json and sidecar.npz written by the JAX
    Checkpointer restore through the port's reader as through the JAX one;
    its orbax tree is refused with a pointer to the converter."""
    jcfg = tiny_config(JC, priors=("pitch", "energy"))
    state = SimpleNamespace(params={"w": np.ones((2, 3), np.float32)},
                            opt_state={"count": np.zeros((), np.int32)},
                            step=np.asarray(5, np.int32))
    jck = JCheckpointer(tmp_path / "jax")
    path = jck.save(5, state, jcfg, _sidecar(1))
    _, jcfg_back, jside = jck.restore()

    cfg = read_config(path)
    assert isinstance(cfg, TC.Config)
    assert TC.to_dict(cfg) == JC.to_dict(jcfg_back) == JC.to_dict(jcfg)
    side = read_sidecar(path)
    _assert_sidecar_equal(side, jside)
    _assert_sidecar_equal(side, _sidecar(1))
    ck = Checkpointer(tmp_path / "jax")
    assert ck.latest_path() == path
    with pytest.raises(FileNotFoundError, match="jax_checkpoint_to_torch"):
        ck.restore()
