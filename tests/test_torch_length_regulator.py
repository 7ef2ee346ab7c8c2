"""The port's length regulator (ops/length_regulator.py) against the JAX
package's Pallas regulator (``regulate_pallas`` in interpret mode): the
plain version, which a CPU tensor takes, forward bit for bit and gradient
to 1e-6; and the routing of ``regulate`` under the JAX package's opt-in
``LFS2_PALLAS_LR``."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.ops.pallas_length_regulator import regulate_pallas
from lightningfastspeech2_tpu_torch.ops import length_regulator as tlr

B, P, H, T = 2, 16, 8, 256


def _durations(case, g):
    if case == "ragged":
        d = g.integers(0, 20, (B, P))
        d[1, 10:] = 0                      # a shorter second item
    elif case == "zero":
        d = np.zeros((B, P), np.int64)
        d[0, :4] = (3, 0, 5, 0)            # item 0 nearly empty, item 1 empty
    else:                                  # "overflow": totals above T
        d = g.integers(10, 40, (B, P))
    return d.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["ragged", "zero", "overflow"])
def test_regulate_matches_regulate_pallas(case, dtype):
    g = np.random.default_rng(["ragged", "zero", "overflow"].index(case))
    x = g.standard_normal((B, P, H)).astype(np.float32)
    d = _durations(case, g)
    w = g.standard_normal((B, T, H)).astype(np.float32)
    jdt = jnp.dtype(dtype)

    def jloss(xj):
        frames, _ = regulate_pallas(xj, jnp.asarray(d), T, interpret=True)
        return jnp.sum(frames.astype(jnp.float32) * w)

    jframes, jmask = regulate_pallas(jnp.asarray(x, jdt), jnp.asarray(d), T, interpret=True)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    frames, mask = tlr.regulate_plain(xt, torch.from_numpy(d), T)
    # a copy: bit for bit in both dtypes
    np.testing.assert_array_equal(frames.detach().float().numpy(),
                                  np.asarray(jframes.astype(jnp.float32)))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert frames.dtype == tdt
    if dtype == "float32":
        jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
        torch.sum(frames * torch.from_numpy(w)).backward()
        # segment sums of a few frames each, in another order: f32 rounding
        np.testing.assert_allclose(xt.grad.numpy(), jgrad, rtol=0, atol=1e-6)
        if case == "zero":
            assert not xt.grad[1].any() and not xt.grad[0, 4:].any()


def test_regulate_routing(monkeypatch):
    # the JAX package's opt-in: its values, read at each call
    for v, on in (("1", True), ("true", True), ("ON", True), ("0", False), ("yes", False)):
        monkeypatch.setenv("LFS2_PALLAS_LR", v)
        assert tlr.kernel_opted_in() is on
    monkeypatch.delenv("LFS2_PALLAS_LR")
    assert not tlr.kernel_opted_in()

    calls, launches = [], (tlr.regulate.launches, tlr.regulate_bwd.launches)
    monkeypatch.setattr(tlr, "regulate_kernel", lambda *a: calls.append(a) or "kernel")
    monkeypatch.setenv("LFS2_PALLAS_LR", "1")
    x3 = torch.randn(B, P, H)
    d = torch.full((B, P), 3)
    # a CPU tensor, a 2-D x or max_frames % 256 != 0 stay on the gather
    for x, t in ((x3, 256), (x3[..., 0], 256), (x3, 300)):
        frames, _ = tlr.regulate(x, d, t)
        assert torch.is_tensor(frames) and frames.shape[:2] == (B, t)
    assert not calls
    assert (tlr.regulate.launches, tlr.regulate_bwd.launches) == launches
    # a CUDA tensor (stood in for here) at max_frames % 256 == 0 takes the kernel
    cuda_x = SimpleNamespace(device=torch.device("cuda"), dim=lambda: 3)
    assert tlr.regulate(cuda_x, d, 512) == "kernel"
    assert len(calls) == 1
    monkeypatch.setenv("LFS2_PALLAS_LR", "0")
    with pytest.raises(AttributeError):   # the gather touches the stand-in
        tlr.regulate(cuda_x, d, 512)
    assert len(calls) == 1
