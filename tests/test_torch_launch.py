"""The port's one launch path (``kernels/launch.py kernel_stream``): the
checks it keeps, the capability check made once per device, the refusal
of a launch whose gradient would be lost (``refuse_grad``), and a source
scan that every wrapper under ``ops/`` launches through it. Needs no card
and imports no JAX."""

import ast
from pathlib import Path

import pytest
import torch

from lightningfastspeech2_tpu_torch.kernels import launch

PORT = Path(__file__).resolve().parent.parent / "lightningfastspeech2_tpu_torch"
# every module under ops/ that loads a kernel library
KERNEL_MODULES = ("attention", "fastdiff_lvc", "ffn", "hifigan_resblock", "length_regulator",
                  "probe", "soft_dtw")


def _cases():
    cpu = torch.zeros(8, 128)
    return {
        "cpu_tensor": ((cpu,), RuntimeError, "kernel launch needs a CUDA tensor, got cpu"),
        "non_contiguous": ((torch.zeros(128, 8).t(),), ValueError,
                           "kernel inputs must be contiguous"),
        "mixed_devices": ((cpu, None, torch.zeros(8, device="meta")), ValueError,
                          "kernel inputs span devices"),
        # a tensor passed as strided may have any strides, but not another device
        "strided_on_another_device": ((cpu,), ValueError, "kernel inputs span devices",
                                      (torch.zeros(128, 8, device="meta").t(),)),
        "strided_on_cpu": ((), RuntimeError, "kernel launch needs a CUDA tensor, got cpu",
                           (torch.zeros(128, 8).t(),)),
    }


@pytest.mark.parametrize("case", ["cpu_tensor", "non_contiguous", "mixed_devices",
                                  "strided_on_another_device", "strided_on_cpu"])
def test_kernel_stream_raises(case):
    tensors, exc, msg, *strided = _cases()[case]
    with pytest.raises(exc, match=msg):
        launch.kernel_stream(*tensors, strided=strided[0] if strided else ())


@pytest.mark.parametrize("cap,ok", [((9, 0), True), ((8, 0), False), ((10, 0), False)])
def test_capability_is_checked_once_per_device(monkeypatch, cap, ok):
    # a stand-in card: the check asks the capability of device 3 once, and
    # a card of another capability raises on every launch
    calls = []
    monkeypatch.setattr(launch, "_capable", set())
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda i: calls.append(i) or cap)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i: "stand-in card")
    dev = torch.device("cuda", 3)
    for _ in range(3):
        if ok:
            launch.require_kernel_device(dev)
        else:
            with pytest.raises(RuntimeError, match=r"stand-in card has capability"):
                launch.require_kernel_device(dev)
    assert calls == ([3] if ok else [3, 3, 3])
    assert launch._capable == ({3} if ok else set())


def test_refuse_grad_sees_the_parameters_the_taps_came_from():
    # a generator whose conv_pre and ups are frozen hands the resblock
    # kernels an x that needs no gradient; its resblocks' parameters still do
    from lightningfastspeech2_tpu_torch.vocoder.hifigan import Generator, HifiGanConfig

    gen = Generator(HifiGanConfig(upsample_rates=(8, 2), upsample_kernel_sizes=(16, 4),
                                  upsample_initial_channel=16))
    gen.conv_pre.requires_grad_(False)
    gen.ups.requires_grad_(False)
    stacks = [w for stage in gen.stage_weights for w in stage]
    assert {id(t) for w in stacks for t in w.sources} == {
        id(p) for p in gen.resblocks.parameters()}
    x = torch.zeros(1, 8, 8)
    for w in stacks:
        with pytest.raises(RuntimeError, match="resblock_trio has no backward.*train_route"):
            launch.refuse_grad("resblock_trio", "train_route", x, None, *w.sources)
        with torch.no_grad():
            launch.refuse_grad("resblock_trio", "train_route", x, *w.sources)
    gen.requires_grad_(False)
    for w in stacks:
        launch.refuse_grad("resblock_trio", "train_route", x, None, *w.sources)


def _calls(tree):
    """Dotted names of every call in a module."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            yield ast.unparse(node.func)


def test_kernel_modules_are_the_ones_that_load_a_library():
    loaders = sorted(p.stem for p in (PORT / "ops").glob("*.py")
                     if "build.load" in set(_calls(ast.parse(p.read_text()))))
    assert tuple(loaders) == KERNEL_MODULES


@pytest.mark.parametrize("module", KERNEL_MODULES)
def test_wrapper_launches_through_the_helper(module):
    calls = list(_calls(ast.parse((PORT / "ops" / f"{module}.py").read_text())))
    assert "kernel_stream" in calls
    assert not [c for c in calls if c.endswith(("current_stream", "get_device_capability",
                                                 "check_kernel_inputs"))]


def test_no_per_launch_stream_or_capability_outside_the_helper():
    # the capability is asked only in kernels/launch.py, and no module that
    # launches a kernel (calls kernel_stream) asks for a stream itself; a
    # stream made outside a launch (a graph capture, say) is not scanned
    bad = []
    for path in sorted(PORT.rglob("*.py")):
        if path == PORT / "kernels" / "launch.py":
            continue
        tree = ast.parse(path.read_text())
        calls = set(_calls(tree))
        words = [c for c in calls if c.endswith(("get_device_capability", "check_kernel_inputs"))]
        if "kernel_stream" in calls:
            words += [c for c in calls if c.endswith("current_stream")]
            words += [n.attr for n in ast.walk(tree)
                      if isinstance(n, ast.Attribute) and n.attr == "cuda_stream"]
        bad += [f"{path.relative_to(PORT)}: {w}" for w in words]
    assert not bad, bad
