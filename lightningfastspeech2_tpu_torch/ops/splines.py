"""Piecewise rational-quadratic spline transforms (Durkan et al. 2019,
Neural Spline Flows) with linear tails.

Counterpart of ``lightningfastspeech2_tpu/ops/splines.py`` (reference
``litfass/third_party/stochastic_duration_predictor/transforms.py:12-212``):
identity outside [-tail_bound, tail_bound], minimum bin width, height and
derivative 1e-3, softmax-normalized bins, softplus derivatives, exact forward
and inverse with log|det J|. Branch-free (``torch.where`` over the
inside-interval mask), as the JAX version.

Two spots kept as JAX writes them: the bin of an element is the count of
``x >= cum[..., 1:-1]``, clipped (``torch.searchsorted``'s side conventions
differ at a boundary), and the inverse takes the quadratic's stable root
``2c / (-b - sqrt(b^2 - 4ac))``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

DEFAULT_MIN_BIN_WIDTH = 1e-3
DEFAULT_MIN_BIN_HEIGHT = 1e-3
DEFAULT_MIN_DERIVATIVE = 1e-3


def _searchsorted_per_element(cum: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bin index for each element given its own partition ``cum``
    (..., K+1); returns (...,) int64 in [0, K-1]."""
    idx = (x[..., None] >= cum[..., 1:-1]).sum(-1)
    return torch.clamp(idx, 0, cum.shape[-1] - 2)


def _knots(unnormalized: torch.Tensor, min_bin: float, tail_bound: float):
    """Softmax bins with a floor, as knot positions (..., K+1) from
    -tail_bound to tail_bound, and the bin sizes between them."""
    K = unnormalized.shape[-1]
    e = torch.exp(unnormalized - unnormalized.amax(-1, keepdim=True))
    sizes = min_bin + (1 - min_bin * K) * (e / e.sum(-1, keepdim=True))
    cum = F.pad(torch.cumsum(sizes, -1), (1, 0))
    cum = (2 * tail_bound) * cum - tail_bound
    cum = torch.cat([torch.full_like(cum[..., :1], -tail_bound), cum[..., 1:-1],
                     torch.full_like(cum[..., :1], tail_bound)], -1)
    return cum, cum[..., 1:] - cum[..., :-1]


def rational_quadratic_spline(
    inputs: torch.Tensor,
    unnormalized_widths: torch.Tensor,
    unnormalized_heights: torch.Tensor,
    unnormalized_derivatives: torch.Tensor,
    inverse: bool = False,
    tail_bound: float = 5.0,
    min_bin_width: float = DEFAULT_MIN_BIN_WIDTH,
    min_bin_height: float = DEFAULT_MIN_BIN_HEIGHT,
    min_derivative: float = DEFAULT_MIN_DERIVATIVE,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """'linear'-tails variant: identity outside [-tail_bound, tail_bound].

    inputs (...,); unnormalized_{widths,heights} (..., K);
    unnormalized_derivatives (..., K-1), padded to K+1 with the constant
    that makes the boundary derivatives exactly 1 (transforms.py:44-51).
    Returns (outputs, logabsdet), both shaped like ``inputs``."""
    inside = torch.abs(inputs) <= tail_bound
    constant = float(np.log(np.expm1(1.0 - min_derivative)))
    unnormalized_derivatives = F.pad(unnormalized_derivatives, (1, 1), value=constant)

    cumwidths, widths = _knots(unnormalized_widths, min_bin_width, tail_bound)
    cumheights, heights = _knots(unnormalized_heights, min_bin_height, tail_bound)
    derivatives = min_derivative + F.softplus(unnormalized_derivatives)

    x_safe = torch.where(inside, inputs, torch.zeros_like(inputs))
    bin_idx = _searchsorted_per_element(cumheights if inverse else cumwidths, x_safe)[..., None]

    def take(a):
        return torch.gather(a, -1, bin_idx)[..., 0]

    input_cumwidths = take(cumwidths[..., :-1])
    input_bin_widths = take(widths)
    input_cumheights = take(cumheights[..., :-1])
    input_heights = take(heights)
    delta = input_heights / input_bin_widths
    input_derivatives = take(derivatives[..., :-1])
    input_derivatives_p1 = take(derivatives[..., 1:])
    d_sum = input_derivatives + input_derivatives_p1 - 2 * delta

    if inverse:
        y_rel = x_safe - input_cumheights
        term = y_rel * d_sum
        a = input_heights * (delta - input_derivatives) + term
        b = input_heights * input_derivatives - term
        c = -delta * y_rel
        discriminant = torch.clamp(b ** 2 - 4 * a * c, min=0.0)
        root = (2 * c) / (-b - torch.sqrt(discriminant))
        outputs_in = root * input_bin_widths + input_cumwidths
        theta = root
    else:
        theta = (x_safe - input_cumwidths) / input_bin_widths
    theta_one_minus_theta = theta * (1 - theta)
    denominator = delta + d_sum * theta_one_minus_theta
    derivative_numerator = delta ** 2 * (
        input_derivatives_p1 * theta ** 2
        + 2 * delta * theta_one_minus_theta
        + input_derivatives * (1 - theta) ** 2)
    logabsdet_in = (torch.log(torch.clamp(derivative_numerator, min=1e-24))
                    - 2 * torch.log(torch.clamp(denominator, min=1e-24)))
    if inverse:
        logabsdet_in = -logabsdet_in
    else:
        numerator = input_heights * (delta * theta ** 2
                                     + input_derivatives * theta_one_minus_theta)
        outputs_in = input_cumheights + numerator / denominator

    outputs = torch.where(inside, outputs_in, inputs)
    logabsdet = torch.where(inside, logabsdet_in, torch.zeros_like(logabsdet_in))
    return outputs, logabsdet


def piecewise_rational_quadratic_transform(
    inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
    inverse=False, tails="linear", tail_bound=5.0,
):
    """The reference's entry-point name; linear tails only."""
    if tails != "linear":
        raise ValueError("only linear tails are supported")
    return rational_quadratic_spline(
        inputs, unnormalized_widths, unnormalized_heights, unnormalized_derivatives,
        inverse=inverse, tail_bound=tail_bound)
