"""The port's debug helpers (utils/debug.py): ``profile_trace`` writes a
Chrome trace holding an ``annotate`` span (context manager and
decorator); ``nan_guard`` raises on a NaN or Inf output when enabled,
through the JAX package's ``LFS2_DEBUG_NANS`` switch too, and hands the
function back untouched when not; ``enable_nan_debugging`` switches
autograd's anomaly mode; ``kernel_dump_to`` needs the CUDA toolkit (its
SASS on the card: tests/test_torch_kernels.py)."""

import json

import pytest
import torch

from lightningfastspeech2_tpu_torch.utils import debug


def test_profile_trace_holds_the_annotations(tmp_path):
    @debug.annotate("lfs2_decorated_span")
    def step(x):
        return (x @ x).relu().sum()

    x = torch.randn(16, 16)
    with debug.profile_trace(tmp_path / "trace") as prof:
        with debug.annotate("lfs2_test_span"):
            step(x)
        step(x)
    trace = json.loads((tmp_path / "trace" / debug.TRACE_FILE).read_text())
    names = [e.get("name") for e in trace["traceEvents"]]
    assert names.count("lfs2_test_span") == 1
    assert names.count("lfs2_decorated_span") == 2
    assert any(e.key == "lfs2_test_span" for e in prof.key_averages())


def test_nan_guard_raises_naming_the_output(monkeypatch):
    def fn(x):
        return {"mel": x, "parts": (x.sum(), torch.log(x))}

    good, bad = torch.ones(3), torch.tensor([1.0, -1.0, 2.0])
    monkeypatch.delenv(debug.NAN_SWITCH, raising=False)
    assert debug.nan_guard(fn) is fn
    assert debug.nan_guard(fn, enabled=False) is fn
    guarded = debug.nan_guard(fn, enabled=True)
    assert torch.equal(guarded(good)["mel"], good)
    with pytest.raises(FloatingPointError, match=r"fn output\['parts'\]\[1\]: 1 NaN and 0 Inf"):
        guarded(bad)
    monkeypatch.setenv(debug.NAN_SWITCH, "1")
    with pytest.raises(FloatingPointError, match="Inf"):
        debug.nan_guard(lambda x: x / 0.0)(good)
    # integer outputs are not checked
    assert debug.nan_guard(lambda: torch.arange(3))().tolist() == [0, 1, 2]


def test_enable_nan_debugging():
    before = torch.is_anomaly_enabled()
    try:
        debug.enable_nan_debugging()
        assert torch.is_anomaly_enabled()
        debug.enable_nan_debugging(False)
        assert not torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)


def test_kernel_dump_needs_the_toolkit(tmp_path, monkeypatch):
    from lightningfastspeech2_tpu_torch.kernels import build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(build, "find_nvcc", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc"):
        debug.kernel_dump_to(tmp_path)
    monkeypatch.setattr(build, "find_nvcc", lambda: str(tmp_path / "bin" / "nvcc"))
    with pytest.raises(RuntimeError, match="no cuobjdump"):
        debug.kernel_dump_to(tmp_path)
