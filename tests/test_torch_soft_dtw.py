"""The port's soft-DTW (ops/soft_dtw.py) and soft-DTW losses
(train/losses.py) against the JAX package on the CPU: the plain recurrence
against the JAX scan and the Pallas kernel in interpret mode (value and
gradient), the debiased ``soft_dtw``, ``soft_dtw_loss`` (padded frames, a
ragged tail chunk) and ``compute_losses`` with soft-DTW mel, CWT and scalar
variance losses."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.core import config as JC
from lightningfastspeech2_tpu.ops import soft_dtw as jsd
from lightningfastspeech2_tpu.ops.pallas_soft_dtw import soft_dtw_from_dist_pallas
from lightningfastspeech2_tpu.train import losses as jlosses
from lightningfastspeech2_tpu_torch.core import config as TC
from lightningfastspeech2_tpu_torch.ops import soft_dtw as tsd
from lightningfastspeech2_tpu_torch.train import losses as tlosses
from tests.torch_port_helpers import tiny_config, torch_threads


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("gamma", [1.0, 0.1])
@pytest.mark.parametrize("shape", [(16, 16), (31, 57)])
def test_plain_value_matches_jax(shape, gamma):
    D = np.abs(np.random.default_rng(1).standard_normal(shape)).astype(np.float32)
    got = float(tsd.soft_dtw_from_dist_plain(torch.from_numpy(D), gamma))
    # f32 recurrences in other orders of operations
    for want in (jsd._soft_dtw_from_dist_scan(jnp.asarray(D), gamma),
                 soft_dtw_from_dist_pallas(jnp.asarray(D), gamma, True)):
        np.testing.assert_allclose(got, float(want), rtol=1e-5)


@pytest.mark.parametrize("shape", [(16, 16), (24, 40)])
def test_plain_gradient_matches_jax_kernel(shape):
    D = np.abs(np.random.default_rng(2).standard_normal(shape)).astype(np.float32)
    want = jax.grad(lambda d: soft_dtw_from_dist_pallas(d, 1.0, True))(jnp.asarray(D))
    Dt = torch.from_numpy(D).requires_grad_(True)
    tsd.soft_dtw_from_dist(Dt, 1.0).backward()
    np.testing.assert_allclose(Dt.grad.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_plain_batches_lattices():
    D = np.abs(np.random.default_rng(3).standard_normal((2, 3, 9, 12))).astype(np.float32)
    got = tsd.soft_dtw_from_dist(torch.from_numpy(D), 0.5)
    assert got.shape == (2, 3)
    for idx in np.ndindex(2, 3):
        want = float(tsd.soft_dtw_from_dist_plain(torch.from_numpy(D[idx]), 0.5))
        np.testing.assert_allclose(float(got[idx]), want, rtol=1e-6)


@pytest.mark.parametrize("normalize", [False, True])
def test_soft_dtw_matches_jax(normalize):
    g = np.random.default_rng(4)
    x = g.standard_normal((3, 12, 4)).astype(np.float32)
    y = g.standard_normal((3, 17, 4)).astype(np.float32)
    want = jsd.soft_dtw_batch(jnp.asarray(x), jnp.asarray(y), gamma=1.0, normalize=normalize)
    wgrad = jax.grad(lambda a: jnp.sum(jsd.soft_dtw_batch(a, jnp.asarray(y), gamma=1.0,
                                                          normalize=normalize)))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = tsd.soft_dtw_batch(xt, torch.from_numpy(y), gamma=1.0, normalize=normalize)
    got.sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(wgrad), rtol=1e-4, atol=1e-5)
    one = tsd.soft_dtw(torch.from_numpy(x[0]), torch.from_numpy(y[0]), 1.0, normalize)
    np.testing.assert_allclose(float(one), float(want[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("T,chunk", [(64, 16), (37, 10)])   # (37, 10): a tail of 7 frames
def test_soft_dtw_loss_matches_jax(T, chunk):
    g = np.random.default_rng(T)
    pred = g.standard_normal((2, T, 5)).astype(np.float32)
    truth = g.standard_normal((2, T, 5)).astype(np.float32)
    mask = np.ones((2, T), bool)
    mask[1, T - 13:] = False                           # padded frames
    want = jlosses.soft_dtw_loss(jnp.asarray(pred), jnp.asarray(truth), jnp.asarray(mask),
                                 0.1, chunk)
    wgrad = jax.grad(lambda p: jlosses.soft_dtw_loss(p, jnp.asarray(truth), jnp.asarray(mask),
                                                     0.1, chunk))(jnp.asarray(pred))
    pt = torch.from_numpy(pred).requires_grad_(True)
    got = tlosses.soft_dtw_loss(pt, torch.from_numpy(truth), torch.from_numpy(mask), 0.1, chunk)
    got.backward()
    # f32; the port sums the chunks of all items in another order
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(wgrad), rtol=1e-4, atol=1e-5)
    assert not pt.grad[1, T - 13:].any()


def _kernel_twin(D, gamma, tpu_weights):
    """A kernel's arithmetic in numpy f32, one anti-diagonal at a time: the
    value and dValue/dD. ``tpu_weights``: the TPU kernel's, R by the exp /
    log softmin and the E-recurrence's weights exp((R_n - R - D_n) / gamma).
    Otherwise csrc/soft_dtw.cu's: R = D + (m - gamma ln2 log2 S) with
    S = 1 + 2^((m - mid) c) + 2^((m - hi) c), c = log2(e) / gamma (m, mid,
    hi the three inputs in order, (0, 0)'s diagonal input 0), the forward
    keeping each cell's weights to its predecessors, formed from its own
    softmin inputs, and the backward's E(i, j) = E(i, j+1) w_left(i, j+1) +
    (E(i+1, j) w_up(i+1, j) + E(i+1, j+1) w_diag(i+1, j+1))."""
    f32, inf = np.float32, np.float32(1e10)
    N, M = D.shape
    g = f32(gamma)
    c, gl = f32(np.log2(np.e) / gamma), f32(gamma * np.log(2.0))
    R = np.full((N + 1, M + 1), inf, f32)   # R[i + 1, j + 1] is cell (i, j)
    Wt = np.zeros((3, N + 1, M + 1), f32)   # up, left, diag weights of cell (i, j)
    for d in range(N + M - 1):
        i = np.arange(max(0, d - M + 1), min(N, d + 1))
        j = d - i
        up, left, dg = R[i, j + 1], R[i + 1, j], R[i, j]
        if tpu_weights:
            m = np.minimum(np.minimum(up, left), dg)
            s = np.exp((m - up) / g) + np.exp((m - left) / g) + np.exp((m - dg) / g)
            R[i + 1, j + 1] = D[i, j] if d == 0 else D[i, j] + (m - g * np.log(s))
            continue
        if d == 0:
            dg = np.zeros_like(dg)
        mn, mx = np.minimum(up, left), np.maximum(up, left)
        m, hi = np.minimum(mn, dg), np.maximum(mx, dg)
        mid = np.maximum(mn, np.minimum(mx, dg))
        e1, e2 = np.exp2((m - mid) * c), np.exp2((m - hi) * c)
        S = (e1 + e2) + f32(1)
        R[i + 1, j + 1] = D[i, j] + (m - gl * np.log2(S))
        rS = f32(1) / S
        for x, v in enumerate((up, left, dg)):
            Wt[x, i, j] = np.where(v == m, rS, np.where(v == mid, e1 * rS, e2 * rS))
    Rc = R[1:, 1:]
    E = np.zeros((N + 1, M + 1), f32)
    E[N - 1, M - 1] = 1.0
    for d in range(N + M - 3, -1, -1):
        i = np.arange(max(0, d - M + 1), min(N, d + 1))
        j = d - i
        if tpu_weights:
            e = np.zeros(len(i), f32)
            for di, dj in ((1, 0), (0, 1), (1, 1)):
                ok = (i + di < N) & (j + dj < M)
                a, b = np.minimum(i + di, N - 1), np.minimum(j + dj, M - 1)
                w = np.exp(np.clip((Rc[a, b] - Rc[i, j] - D[a, b]) / g, -80, 30))
                e = e + np.where(ok, E[a, b] * w, f32(0))
        else:   # cells off the lattice hold E = 0 and weights 0
            e = E[i, j + 1] * Wt[1, i, j + 1] + (E[i + 1, j] * Wt[0, i + 1, j]
                                                 + E[i + 1, j + 1] * Wt[2, i + 1, j + 1])
        E[i, j] = e
    return Rc[N - 1, M - 1], E[:N, :M]


def test_kernel_backward_weights_keep_their_digits():
    # a 128-frame mel chunk (80 channels, an untrained model's small output
    # against unit-variance targets) at the config's gamma 0.1: R reaches
    # ~1e4, where the TPU kernel's weights lose digits; the kernels' form
    # matches JAX's autodiff of the scan as the port's plain autograd does
    g = np.random.default_rng(8)
    x = (0.05 * g.standard_normal((128, 80))).astype(np.float32)
    y = g.standard_normal((128, 80)).astype(np.float32)
    D = np.asarray(jsd.pairwise_sqdist(jnp.asarray(x), jnp.asarray(y)))
    want = np.asarray(jax.grad(lambda d: jsd._soft_dtw_from_dist_scan(d, 0.1))(jnp.asarray(D)))
    pallas = np.asarray(jax.grad(lambda d: soft_dtw_from_dist_pallas(d, 0.1, True))(jnp.asarray(D)))
    value, port = _kernel_twin(D, 0.1, tpu_weights=False)
    _, tpu = _kernel_twin(D, 0.1, tpu_weights=True)
    assert value > 5e3
    np.testing.assert_allclose(value, float(jsd._soft_dtw_from_dist_scan(jnp.asarray(D), 0.1)),
                               rtol=1e-6)
    np.testing.assert_allclose(tpu, pallas, rtol=0, atol=1e-5)   # the twin is the TPU kernel
    np.testing.assert_allclose(port, want, rtol=0, atol=1e-5)
    assert np.abs(tpu - want).max() > 1e-2


@pytest.mark.parametrize("N,M", [(12, 40), (40, 12), (8, 33)])
def test_plain_kernel_contract_matches_jax(N, M):
    # the two kernels' contract in plain PyTorch, forward then backward, on
    # two lattices with upstream gradients other than 1
    rng = np.random.default_rng(N * 100 + M)
    D = np.abs(rng.standard_normal((2, N, M))).astype(np.float32)
    g = np.array([0.7, 1.3], np.float32)
    value, W = tsd.soft_dtw_fwd_plain(torch.from_numpy(D), 0.1)
    assert W.shape == tsd.soft_dtw_plan(2, N, M).residual_shape
    assert not W[:, ~tsd.residual_cells(N, M, "cpu")].any()   # 0 off the lattice
    dD = tsd.soft_dtw_bwd_plain(W, torch.from_numpy(g), N)
    for l in range(2):
        Dl = jnp.asarray(D[l])
        # f32 recurrences in other orders of operations
        for want in (jsd._soft_dtw_from_dist_scan(Dl, 0.1), soft_dtw_from_dist_pallas(Dl, 0.1, True)):
            np.testing.assert_allclose(float(value[l]), float(want), rtol=1e-5)
        # the scan's gradient: the Pallas backward's weights lose digits
        want = g[l] * np.asarray(jax.grad(lambda d: jsd._soft_dtw_from_dist_scan(d, 0.1))(Dl))
        np.testing.assert_allclose(dD[l].numpy(), want, rtol=1e-4, atol=1e-5)


def _soft_dtw_config(C):
    cfg = tiny_config(C)
    v = cfg.model.variance
    return C.replace(cfg, **{
        "model.variance": C.replace(v, losses=("soft_dtw", "soft_dtw", "mse")),
        "train.mel_loss": "soft_dtw", "train.soft_dtw_chunk_size": 24,
        "train.soft_dtw_gamma": 0.5})


def test_compute_losses_soft_dtw_matches_jax():
    jcfg, tcfg = _soft_dtw_config(JC), _soft_dtw_config(TC)
    assert JC.to_dict(jcfg) == TC.to_dict(tcfg)
    g = np.random.default_rng(7)
    Bn, P, T = 2, 8, 60                           # 60 frames: two chunks of 24, a tail of 12
    f32 = np.float32
    frame_mask = np.arange(T)[None, :] < np.array([[T], [41]])
    phone_mask = np.arange(P)[None, :] < np.array([[P], [6]])
    result = {
        "phone_mask": phone_mask, "frame_mask": frame_mask,
        "mel": g.standard_normal((Bn, T, 20)).astype(f32),
        "duration_prediction": g.standard_normal((Bn, P)).astype(f32),
        "variances_pitch": {"spectrogram": g.standard_normal((Bn, T, 10)).astype(f32),
                            "mean": g.standard_normal(Bn).astype(f32),
                            "std": g.standard_normal(Bn).astype(f32)},
        "variances_energy": g.standard_normal((Bn, T)).astype(f32),
        "variances_snr": g.standard_normal((Bn, T)).astype(f32),
    }
    batch = {
        "mel": g.standard_normal((Bn, T + 4, 20)).astype(f32),
        "duration": g.integers(0, 9, (Bn, P)).astype(np.int32),
        "variances_pitch_spectrogram": g.standard_normal((Bn, T, 10)).astype(f32),
        "variances_pitch_mean": g.standard_normal(Bn).astype(f32),
        "variances_pitch_std": g.standard_normal(Bn).astype(f32),
        "variances_energy": g.standard_normal((Bn, T)).astype(f32),
        "variances_snr": g.standard_normal((Bn, T)).astype(f32),
    }

    def tree(fn, d):
        return {k: tree(fn, v) if isinstance(v, dict) else fn(v) for k, v in d.items()}

    want = jlosses.compute_losses(tree(jnp.asarray, result), tree(jnp.asarray, batch), jcfg)
    got = tlosses.compute_losses(tree(torch.from_numpy, result), tree(torch.from_numpy, batch),
                                 tcfg)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=1e-5, atol=1e-6,
                                   err_msg=key)


def test_masked_mean_loss_rejects_soft_dtw():
    x = torch.zeros(2, 3)
    with pytest.raises(ValueError, match="unknown loss kind"):
        tlosses.masked_mean_loss(x, x, torch.ones(2, 3, dtype=torch.bool), "soft_dtw")
