"""The port's length regulator (ops/length_regulator.py) against the JAX
package's Pallas regulator (``regulate_pallas`` in interpret mode) and its
gather: the plain version, which a CPU tensor takes, and the kernels'
contracts (durations -> frames, mask and int32 running sums; the
segment-sum from those sums), forward bit for bit and gradient to 1e-6 in
f32, one bf16 ulp in bf16; the kernels' launch plans; and the routing of
``regulate`` under the JAX package's opt-in ``LFS2_PALLAS_LR``."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.ops.pallas_length_regulator import regulate_pallas
from lightningfastspeech2_tpu_torch.ops import length_regulator as tlr

B, P, H, T = 2, 16, 8, 256


# P and T of each case; "long" has P above the forward kernel's scan chunk of
# 256 phones
CASES = {"ragged": (16, 256), "zero": (16, 256), "overflow": (16, 256),
         "negative": (16, 256), "long": (300, 1024)}


def _durations(case, g, P):
    """int64 durations, as the model gives them."""
    if case == "ragged":
        d = g.integers(0, 20, (B, P))
        d[1, 10:] = 0                      # a shorter second item
    elif case == "zero":
        d = np.zeros((B, P), np.int64)
        d[0, :4] = (3, 0, 5, 0)            # item 0 nearly empty, item 1 empty
    elif case == "overflow":               # totals above T
        d = g.integers(10, 40, (B, P))
    elif case == "negative":               # clamped at 0
        d = g.integers(-6, 20, (B, P))
    else:                                  # "long": item 0 above T, item 1 below it
        d = g.integers(0, 7, (B, P))
        d[0] = g.integers(3, 8, P)
    return d.astype(np.int64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", list(CASES))
def test_regulate_matches_regulate_pallas(case, dtype, monkeypatch):
    from lightningfastspeech2_tpu.ops.length_regulator import regulate as jregulate

    monkeypatch.delenv("LFS2_PALLAS_LR", raising=False)   # the JAX gather
    P, T = CASES[case]
    g = np.random.default_rng(list(CASES).index(case))
    x = g.standard_normal((B, P, H)).astype(np.float32)
    d = _durations(case, g, P)
    w = g.standard_normal((B, T, H)).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jd = jnp.asarray(x, jdt), jnp.asarray(d.astype(np.int32))
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    frames, mask = tlr.regulate_plain(xt, torch.from_numpy(d), T)
    # the forward kernel's contract: frames, mask and int32 running sums
    kframes, kmask, ends = tlr.regulate_fwd_plain(xt.detach(), torch.from_numpy(d), T)
    assert frames.dtype == kframes.dtype == tdt and ends.dtype == torch.int32
    # a copy: bit for bit in both dtypes, against the Pallas kernel in
    # interpret mode and the JAX gather; the sums as the JAX package takes them
    for jframes, jmask in (regulate_pallas(jx, jd, T, interpret=True), jregulate(jx, jd, T)):
        for f, m in ((frames, mask), (kframes, kmask)):
            np.testing.assert_array_equal(f.detach().float().numpy(),
                                          np.asarray(jframes.astype(jnp.float32)))
            np.testing.assert_array_equal(m.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(
        ends.numpy(), np.asarray(jnp.cumsum(jnp.maximum(jd, 0).astype(jnp.int32), axis=-1)))

    # the gradient against the Pallas kernel's f32 VJP of the same cotangent
    # (w rounded to the dtype): the gather's autograd (f32) and the
    # backward kernel's contract, on g as autograd may hand it over
    # (contiguous, and transposed in memory); f32 to 1e-6 (segment sums in
    # another order), bf16 within one bf16 ulp of the f32 gradient rounded once
    wt = torch.from_numpy(w).to(tdt)
    _, vjp = jax.vjp(lambda xj: regulate_pallas(xj, jd, T, interpret=True)[0], jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(wt.float().numpy()))
    want = torch.from_numpy(np.array(jgrad))
    grads = [tlr.regulate_bwd_plain(gt, ends)
             for gt in (wt, wt.transpose(1, 2).contiguous().transpose(1, 2))]
    if dtype == "float32":
        torch.sum(frames * wt).backward()
        grads.append(xt.grad)
    for dx in grads:
        assert dx.dtype == tdt and dx.shape == (B, P, H)
        if dtype == "float32":
            np.testing.assert_allclose(dx.numpy(), want.numpy(), rtol=0, atol=1e-6)
        else:
            ref = want.to(torch.bfloat16).float()
            ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp(min=1e-30))) - 7)
            assert ((dx.float() - ref).abs() <= ulp).all()
        if case == "zero":
            assert not dx[1].any() and not dx[0, 4:].any()


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


@pytest.mark.parametrize("B,T,F", [(8, 2048, 64), (2, 8192, 64), (1, 512, 16), (64, 4096, 256)])
def test_forward_plan_fills_the_card(B, T, F):
    # the longest run of frames a block that still gives each of the 132
    # SMs a block; the shortest where no run does
    assert tlr.fwd_frames_per_block(B, T) == F
    assert F in tlr.FRAMES_PER_BLOCK
    assert B * -(-T // F) >= tlr.SM_COUNT or F == tlr.FRAMES_PER_BLOCK[0]


@pytest.mark.parametrize("B,P,H,elem_bytes,S", [
    (8, 256, 256, 2, 1), (8, 256, 256, 4, 1), (8, 256, 640, 2, 1), (2, 1024, 256, 2, 1),
    (2, 300, 256, 2, 2), (1, 300, 256, 2, 4), (1, 64, 256, 4, 8), (1, 64, 256, 2, 8)])
def test_backward_plan_fills_the_card(B, P, H, elem_bytes, S):
    # the fewest warps a phone run that give each of the 132 SMs a block of
    # 8 warps, counting a warp for each 512 bytes of a row; the most where
    # none does
    assert tlr.bwd_warps_per_phone(B, P, H, elem_bytes) == S
    units = B * P * -(-H * elem_bytes // 512)
    need = tlr.SM_COUNT * tlr.WARPS_PER_BLOCK
    assert units * S >= need or S == tlr.BWD_SPLITS[-1]
    assert S == 1 or units * tlr.BWD_SPLITS[tlr.BWD_SPLITS.index(S) - 1] < need


def test_kernel_path_raises_on_the_cpu():
    # no fallback: the wrappers launch on a card or raise, the CPU takes the
    # gather through ``regulate`` alone
    x, d = torch.randn(B, P, H), torch.full((B, P), 3)
    with pytest.raises(RuntimeError, match="kernel launch needs a CUDA tensor"):
        tlr.regulate_kernel(x.requires_grad_(True), d, T)
    with pytest.raises(RuntimeError, match="kernel launch needs a CUDA tensor"):
        tlr.regulate_bwd(torch.randn(B, T, H), torch.zeros(B, P, dtype=torch.int32))
    with pytest.raises(ValueError, match="int32 or int64 durations"):
        tlr.regulate_fwd(x, d.float(), T)
