"""Edge-aware a-trous wavelet denoiser (post-process, opt-in).

The reference lists "accelerate and improve quality with denoising" as
unrealized future work (win32_main.cpp:184); this realizes it the
framework's way: a pure-jnp dilated 5x5 B3-spline a-trous filter
(Dammertz et al., "Edge-Avoiding A-Trous Wavelet Transform for Fast
Global Illumination Filtering", HPG 2010) with an SVGF-style per-pixel
variance guide — pixels whose Monte-Carlo variance is high accept more
smoothing, while converged pixels and color edges are preserved by the
color-distance weight. Runs on the LINEAR radiance image before the
tonemap; OFF by default (renders are unbiased without it, and golden
tests gate the raw estimator).

Shape notes: the filter is 25 static edge-clamped shifts per
iteration over an (H, W, 3) image — pure vectorized elementwise work XLA
fuses well; no gathers, no data-dependent control flow.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp

# B3-spline binomial taps (1 4 6 4 1)/16 — the classic a-trous kernel.
_B3 = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def atrous_denoise(
    img: jnp.ndarray,
    var: Optional[jnp.ndarray] = None,
    iterations: int = 3,
    sigma_color: float = 0.35,
    k_var: float = 4.0,
) -> jnp.ndarray:
    """Denoise a linear (H, W, 3) radiance image.

    Args:
      img: linear radiance, (H, W, 3) float32.
      var: optional (H, W) per-pixel variance of the MEAN estimate
        (accumulator variance / sample count, channel-averaged); widens
        the color-acceptance window where the estimate is still noisy.
      iterations: a-trous levels (dilation 1, 2, 4, ...). 0 = identity.
      sigma_color: base color-distance sigma in linear radiance units.
      k_var: variance-guide strength (sigma^2 grows by k_var * var).
    """
    if iterations <= 0:
        return img
    H, W = img.shape[0], img.shape[1]
    sig2 = jnp.float32(sigma_color * sigma_color)
    if var is not None:
        sig2 = sig2 + jnp.float32(k_var) * jnp.maximum(var, 0.0)[..., None]
    out = img
    for it in range(iterations):
        d = 1 << it
        pad = 2 * d
        p = jnp.pad(out, ((pad, pad), (pad, pad), (0, 0)), mode="edge")
        num = jnp.zeros_like(out)
        den = jnp.zeros((H, W, 1), out.dtype)
        for iy, hy in enumerate(_B3):
            for ix, hx in enumerate(_B3):
                dy, dx = (iy - 2) * d, (ix - 2) * d
                q = p[pad + dy:pad + dy + H, pad + dx:pad + dx + W, :]
                dist2 = jnp.sum((q - out) ** 2, axis=-1, keepdims=True)
                w = jnp.float32(hy * hx) * jnp.exp(
                    -dist2 / jnp.maximum(sig2, 1e-8))
                num = num + w * q
                den = den + w
        out = num / den
    return out


def accum_variance(state, config) -> jnp.ndarray:
    """(H, W) channel-mean variance of the per-pixel MEAN estimate from the
    accumulator: (E[x^2] - E[x]^2) / n, clamped nonnegative."""
    cnt = jnp.maximum(state.count, 1.0)
    vs = []
    for s, sq in ((state.sum.x, state.sum_sq.x),
                  (state.sum.y, state.sum_sq.y),
                  (state.sum.z, state.sum_sq.z)):
        mean = s / cnt
        vs.append(jnp.maximum(sq / cnt - mean * mean, 0.0) / cnt)
    v = (vs[0] + vs[1] + vs[2]) * (1.0 / 3.0)
    return v.reshape(config.height, config.width)
