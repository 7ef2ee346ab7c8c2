"""The port's rational-quadratic spline (ops/splines.py) against the JAX
package's, on the CPU in f32.

Inside the tails the outputs agree within 2e-5 x max(1, dy/dx) (f32 through
two frameworks: the softmax, the cumsum of the knots and the quadratic's
root round differently in the last bits, and the spline carries a knot's
rounding through its local slope, which reaches e^8 at N(0, 1) parameters),
and log|det J| within 1e-3 (observed 4e-4: a bin of the minimum width 1e-3
turns an ulp of its edge into a relative error of 1e-4 in theta); outside
them both are the identity with log-det 0, exactly. Inputs are kept
``EDGE_MARGIN`` away from every knot: an input on a bin edge may fall into
the neighbouring bin in the other framework. inverse(forward(x)) returns x
within 1e-4 x max(1, dx/dy), and the forward and inverse log-dets cancel
within 1e-3 (the log-det tolerance above)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightningfastspeech2_tpu.ops import splines as jsp
from lightningfastspeech2_tpu_torch.ops import splines as tsp
from tests.torch_port_helpers import torch_threads

OUT_TOL = 2e-5      # times max(1, dy/dx)
LOGDET_TOL = 1e-3
EDGE_MARGIN = 1e-3
TAIL = 5.0
K = 10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    with torch_threads(1):
        yield


def _params(seed, n, scale=1.0):
    g = np.random.default_rng(seed)
    w = (g.standard_normal((n, K)) * scale).astype(np.float32)
    h = (g.standard_normal((n, K)) * scale).astype(np.float32)
    d = (g.standard_normal((n, K - 1)) * scale).astype(np.float32)
    return w, h, d


def _knots(u):
    e = np.exp(u - u.max(-1, keepdims=True))
    s = 1e-3 + (1 - 1e-3 * K) * e / e.sum(-1, keepdims=True)
    return np.concatenate([np.zeros((len(u), 1)), np.cumsum(s, -1)], -1) * 2 * TAIL - TAIL


def _off_edges(x, knots, margin=EDGE_MARGIN):
    """x moved away from its nearest knot where it lies within ``margin``."""
    near = np.abs(x[:, None] - knots).min(-1) < margin
    return np.where(near, x + 3 * margin, x).astype(np.float32)


def _both(x, w, h, d, inverse):
    ref = jsp.rational_quadratic_spline(jnp.asarray(x), jnp.asarray(w), jnp.asarray(h),
                                        jnp.asarray(d), inverse=inverse, tail_bound=TAIL)
    got = tsp.rational_quadratic_spline(torch.from_numpy(x), torch.from_numpy(w),
                                        torch.from_numpy(h), torch.from_numpy(d),
                                        inverse=inverse, tail_bound=TAIL)
    return [np.asarray(r) for r in ref], [g.numpy() for g in got]


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_spline_matches_jax(seed, inverse):
    n = 4096
    w, h, d = _params(seed, n)
    g = np.random.default_rng(seed + 10)
    x = g.uniform(-7.0, 7.0, n).astype(np.float32)      # a quarter of them in the tails
    x = _off_edges(x, _knots(h if inverse else w))
    ref, got = _both(x, w, h, d, inverse)
    outside = np.abs(x) > TAIL
    assert outside.sum() > 100 and (~outside).sum() > 1000
    slope = np.maximum(1.0, np.exp(np.abs(ref[1])))
    assert (np.abs(got[0] - ref[0]) <= OUT_TOL * slope).all()
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=LOGDET_TOL)
    np.testing.assert_array_equal(got[0][outside], x[outside])
    assert not got[1][outside].any()


def test_inverse_undoes_forward_and_logdets_cancel():
    n = 2048
    w, h, d = _params(3, n)
    x = np.random.default_rng(4).uniform(-4.9, 4.9, n).astype(np.float32)
    t = [torch.from_numpy(a) for a in (w, h, d)]
    y, ld = tsp.rational_quadratic_spline(torch.from_numpy(x), *t, tail_bound=TAIL)
    back, ld_inv = tsp.rational_quadratic_spline(y, *t, inverse=True, tail_bound=TAIL)
    # y's rounding comes back through the inverse's slope dx/dy
    inv_slope = np.maximum(1.0, np.exp(-ld.numpy()))
    assert (np.abs(back.numpy() - x) <= 1e-4 * inv_slope).all()
    np.testing.assert_allclose((ld + ld_inv).numpy(), 0.0, atol=LOGDET_TOL)


def test_logdet_is_the_log_slope():
    """log|dy/dx| from autograd equals the returned log-det."""
    w, h, d = (torch.from_numpy(a) for a in _params(5, 512))
    x = torch.from_numpy(np.random.default_rng(6).uniform(-4.5, 4.5, 512).astype(np.float32))
    x.requires_grad_(True)
    y, ld = tsp.rational_quadratic_spline(x, w, h, d, tail_bound=TAIL)
    (grad,) = torch.autograd.grad(y.sum(), x)
    np.testing.assert_allclose(torch.log(grad).detach().numpy(), ld.detach().numpy(),
                               atol=1e-4)


def test_spline_is_increasing_and_keeps_its_ends():
    w, h, d = (torch.from_numpy(a) for a in _params(7, 1))
    x = torch.linspace(-TAIL, TAIL, 4001)
    y, _ = tsp.rational_quadratic_spline(x, w.expand(4001, K), h.expand(4001, K),
                                         d.expand(4001, K - 1), tail_bound=TAIL)
    assert (torch.diff(y) > 0).all()
    np.testing.assert_allclose(y[[0, -1]].numpy(), [-TAIL, TAIL], atol=1e-5)
