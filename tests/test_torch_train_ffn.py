"""The port's training FFN half (ops/ffn.py ``ffn_ln_train_plain``, the CPU
path of ``ffn_ln_train``) against the JAX package's ``fused_ffn_ln_train``
run in interpret mode on the CPU: the dropout hash bit for bit, the forward
and all 13 gradients. The CUDA kernels against the plain version are in
test_torch_kernels.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.ops.pallas_ffn import _pos_keep, _seed_u32, fused_ffn_ln_train
from lightningfastspeech2_tpu_torch.ops import ffn as tffn
from tests.torch_port_helpers import ffn_modules, ffn_params

C, F, K, T = 32, 64, 5, 40
NAMES = ("z", "wd", "bd", "w1", "b1", "wg", "bg", "w2", "b2", "g1", "be1", "g2", "be2")


@pytest.mark.parametrize("seed", [0, 1234567, 2 ** 31 - 2])
@pytest.mark.parametrize("salt,rate", [(1, 0.1), (2, 0.3)])
def test_ffn_keep_mask_bit_exact(seed, salt, rate):
    # rows -64 .. 2815: the backward's negative halo rows up to the longest
    # frame bucket; columns up to F = 1024
    gpos = np.arange(-64, 2816, dtype=np.int32)
    for b in (0, 7):
        seed_u32 = _seed_u32(jnp.asarray([seed], jnp.int32), jnp.int32(b))
        ref = np.asarray(_pos_keep(jnp.asarray(gpos)[:, None], 1024, rate, seed_u32, salt))
        sb = tffn.batch_seeds(torch.tensor([seed], dtype=torch.int32), 8)[b]
        assert int(sb) == int(seed_u32)
        out = tffn.ffn_keep_mask(torch.from_numpy(gpos), 1024, rate, sb, salt).numpy()
        np.testing.assert_array_equal(out, ref)
        assert abs(out.mean() - (1 - rate)) < 0.01


def _jax_ffn(z, p, seed, rate, dout):
    a = [jnp.asarray(z)] + [jnp.asarray(p[n]) for n in NAMES[1:]]

    def f(*args):
        return fused_ffn_ln_train(*args, seed, 1e-5, rate, 16, True)

    out, vjp = jax.vjp(f, *a)
    return out, vjp(jnp.asarray(dout).astype(out.dtype))


def _torch_grads(mods, zt):
    """Gradients of the port's parameter holders in the JAX layouts."""
    g = {"z": zt.grad.float()}
    g["wd"] = mods["conv1_depth"].weight.grad[:, 0, :].T
    g["bd"] = mods["conv1_depth"].bias.grad
    g["w1"] = mods["conv1_point"].weight.grad[:, :, 0].T[None]
    g["b1"] = mods["conv1_point"].bias.grad
    wg = mods["conv2_group"].weight.grad[:, :, 0]          # (G*co, ci)
    G = mods["conv1_depth"].weight.shape[0]                # groups = channels
    g["wg"] = wg.reshape(G, wg.shape[0] // G, wg.shape[1]).transpose(1, 2)[None]
    g["bg"] = mods["conv2_group"].bias.grad
    g["w2"] = mods["conv2_point"].weight.grad[:, :, 0].T[None]
    g["b2"] = mods["conv2_point"].bias.grad
    for n, m in (("g1", "norm1"), ("g2", "norm2")):
        g[n] = mods[m].weight.grad
    for n, m in (("be1", "norm1"), ("be2", "norm2")):
        g[n] = mods[m].bias.grad
    return {k: v.detach().numpy() for k, v in g.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.0, 0.3])
def test_ffn_ln_train_plain_matches_pallas_interpret(dtype, rate):
    p = ffn_params(7, C, F, K)
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, T, C)).astype(np.float32)
    dout = rng.standard_normal((2, T, C)).astype(np.float32)
    seed = 987654
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    ref_out, ref_grads = _jax_ffn(jnp.asarray(z).astype(jdt), p, seed, rate, dout)

    mods = ffn_modules(p)
    for m in mods.values():
        for t in vars(m).values():
            t.requires_grad_(True)
    zt = torch.from_numpy(z).to(tdt).requires_grad_(True)
    out = tffn.ffn_ln_train(zt, tffn.ffn_train_params(**mods),
                            torch.tensor([seed], dtype=torch.int32), rate)
    assert out.dtype == tdt and out.shape == (2, T, C)
    out.backward(torch.from_numpy(dout).to(tdt))
    grads = _torch_grads(mods, zt)

    ref_out = np.asarray(ref_out.astype(jnp.float32))
    out = out.detach().float().numpy()
    if dtype == "float32":
        # f32 everywhere: summation order only
        np.testing.assert_allclose(out, ref_out, rtol=0, atol=2e-5)
    else:
        # same rounding points; a one-ulp f32 difference before a rounding
        # can flip a bf16 ulp (2^-7 relative at |v| <= 4)
        np.testing.assert_allclose(out, ref_out, rtol=0, atol=0.07)
        assert np.mean(np.abs(out - ref_out)) < 3e-3
    for name, ref in zip(NAMES, ref_grads):
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        got = grads[name]
        assert got.shape == ref.shape, name
        top = np.abs(ref).max()
        if dtype == "float32":
            # f32 gradients; the kernel's per-tile partial sums and the
            # grouped-conv fold's VJP sum in other orders than autograd
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * max(top, 1.0),
                                       err_msg=name)
        else:
            # the TPU kernel rounds dff and dup to bf16 before its products
            # and bf16 activations flip ulps; the plain version keeps its
            # gradients f32: agree to 3 % of the largest gradient, and the
            # bulk to 0.5 %
            np.testing.assert_allclose(got, ref, rtol=0, atol=0.03 * top, err_msg=name)
            assert np.mean(np.abs(got - ref)) <= 0.005 * top, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_backward_matches_pallas_interpret(dtype):
    # ffn_ln_train_bwd_plain (the bf16 kernels' stages (a)-(c) with their
    # rounding points: dff and dup rounded before their products, as
    # pallas_ffn.py rounds them) against the TPU kernel's VJP, the gradients
    # carried back through the grouped-conv fold to the modules
    rate = 0.3
    p = ffn_params(7, C, F, K)
    rng = np.random.default_rng(4)
    z = rng.standard_normal((2, T, C)).astype(np.float32)
    dout = rng.standard_normal((2, T, C)).astype(np.float32)
    seed = 987654
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    _, ref_grads = _jax_ffn(jnp.asarray(z).astype(jdt), p, seed, rate, dout)

    mods = ffn_modules(p)
    for m in mods.values():
        for t in vars(m).values():
            t.requires_grad_(True)
    params = tffn.ffn_train_params(**mods)
    zt = torch.from_numpy(z).to(tdt)
    dz, *dp = tffn.ffn_ln_train_bwd_plain(torch.from_numpy(dout).to(tdt), zt, params,
                                          torch.tensor([seed], dtype=torch.int32), rate)
    assert dz.dtype == tdt and all(g.dtype == torch.float32 for g in dp)
    torch.autograd.backward(params, dp)
    zt.grad = dz
    grads = _torch_grads(mods, zt)
    for name, ref in zip(NAMES, ref_grads):
        ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
        got = grads[name]
        top = np.abs(ref).max()
        if dtype == "float32":
            # f32 everywhere: summation order only
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5 * max(top, 1.0), err_msg=name)
        else:
            # the same rounding points; a one-ulp f32 difference before a
            # bf16 rounding flips that value's ulp (2^-8 relative), which the
            # chain of products carries: 3 % of the largest gradient, the
            # bulk within 0.5 %
            np.testing.assert_allclose(got, ref, rtol=0, atol=0.03 * top, err_msg=name)
            assert np.mean(np.abs(got - ref)) <= 0.005 * top, name


def test_staged_backward_matches_autograd_in_f32():
    # in f32 the staged backward rounds nothing: it is the plain forward's
    # gradient, to summation order
    params = [t.clone().requires_grad_(True)
              for t in tffn.ffn_train_params(**ffn_modules(ffn_params(5, C, F, K)))]
    g = torch.Generator().manual_seed(6)
    z, dout = (torch.randn(3, T, C, generator=g) for _ in range(2))
    seed = torch.tensor([31337], dtype=torch.int32)
    zz = z.clone().requires_grad_(True)
    want = torch.autograd.grad(tffn.ffn_ln_train_plain(zz, params, seed, 0.2), [zz, *params], dout)
    got = tffn.ffn_ln_train_bwd_plain(dout, z, params, seed, 0.2)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * b.abs().max().item())
