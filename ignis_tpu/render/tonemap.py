"""Tonemapping + image info ops.

Parity target: reference entrypoints/tonemap.art (operators: none/reinhard/
reinhard_modified/aces/uncharted2 on luminance in xyY space; agx/pbr-neutral
on sRGB; srgb gamma; special colors for nan/inf/negative) and
entrypoints/imageinfo.art (min/max/avg/soft-percentiles/median/histograms/
error counts). Jitted whole-image ops — the interactive-view analog runs in
one fused XLA program per call.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

# sRGB <-> XYZ (D65). numpy (not jnp): module-level device arrays become
# jit-captured constants.
_RGB2XYZ = np.asarray([[0.4124564, 0.3575761, 0.1804375],
                       [0.2126729, 0.7151522, 0.0721750],
                       [0.0193339, 0.1191920, 0.9503041]], np.float32)
_XYZ2RGB = np.asarray([[3.2404542, -1.5371385, -0.4985314],
                       [-0.9692660, 1.8760108, 0.0415560],
                       [0.0556434, -0.2040259, 1.0572252]], np.float32)

TONEMAP_METHODS = {"none": 0, "linear": 0, "reinhard": 1,
                   "reinhard_modified": 2, "modified_reinhard": 2,
                   "aces": 3, "uncharted2": 4, "agx": 5, "pbr_neutral": 6}


def _reinhard(l):
    return l / (1.0 + l)


def _reinhard_modified(l):
    lwhite = 4.0
    return l * (1.0 + l / (lwhite * lwhite)) / (1.0 + l)


def _aces(l):
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return jnp.clip((l * (a * l + b)) / (l * (c * l + d) + e), 0.0, 1.0)


def _uncharted2_partial(x):
    A, B, C, D, E, F = 0.15, 0.50, 0.20, 0.20, 0.02, 0.30
    return ((x * (A * x + C * B) + D * E) / (x * (A * x + B) + D * F)) - E / F


def _uncharted2(l):
    exposure_bias = 2.0
    w = 11.2
    return _uncharted2_partial(l * exposure_bias) / _uncharted2_partial(w)


def srgb_gamma(x):
    return jnp.where(x <= 0.0031308, 12.92 * x,
                     1.055 * jnp.power(jnp.maximum(x, 1e-8), 1 / 2.4) - 0.055)


@functools.partial(jax.jit, static_argnames=("method", "use_gamma"))
def tonemap(img, scale=1.0, exposure_factor=1.0, exposure_offset=0.0,
            method: int = 0, use_gamma: bool = True):
    """img [h, w, 3] linear -> [h, w, 3] in [0, 1] display space.

    nan -> cyan, inf -> pink, negative -> orange (tonemap.art:25-31)."""
    rgb = img * scale
    # HIGHEST: a float32 contraction may otherwise run in TF32 on a GPU
    xyz = jnp.einsum("ij,hwj->hwi", _RGB2XYZ, rgb,
                     precision=jax.lax.Precision.HIGHEST)
    s = jnp.maximum(xyz.sum(-1), 1e-20)
    x = xyz[..., 0] / s
    y = xyz[..., 1] / s
    L = xyz[..., 1]

    Lp = exposure_factor * L + exposure_offset
    nL = [Lp, _reinhard(Lp), _reinhard_modified(Lp), _aces(Lp),
          _uncharted2(Lp), Lp, Lp][method]

    # xyY -> XYZ -> RGB with new luminance
    denom = jnp.maximum(y, 1e-10)
    X = nL * x / denom
    Z = nL * (1.0 - x - y) / denom
    new_xyz = jnp.stack([X, nL, Z], axis=-1)
    color = jnp.einsum("ij,hwj->hwi", _XYZ2RGB, new_xyz,
                       precision=jax.lax.Precision.HIGHEST)

    if method == 5:  # agx (approximation of the AgX fit)
        color = _agx(color)
    elif method == 6:
        color = _pbr_neutral(color)

    out = srgb_gamma(jnp.clip(color, 0.0, None)) if use_gamma else color
    out = jnp.clip(out, 0.0, 1.0)

    nan = jnp.isnan(img).any(-1)
    inf = jnp.isinf(img).any(-1)
    neg = (img < 0).any(-1)
    cyan = jnp.asarray([0.0, 1.0, 1.0])
    pink = jnp.asarray([1.0, 0.0, 150 / 255.0])
    orange = jnp.asarray([1.0, 1.0, 0.0])
    out = jnp.where(neg[..., None], orange, out)
    out = jnp.where(inf[..., None], pink, out)
    out = jnp.where(nan[..., None], cyan, out)
    return out


def _agx(color):
    # Minimal AgX: log2 encoding + sigmoid contrast (Benedikt Bitterli fit)
    lo, hi = -12.47393, 4.026069
    c = jnp.clip((jnp.log2(jnp.maximum(color, 1e-10)) - lo) / (hi - lo), 0, 1)
    c2 = c * c
    c4 = c2 * c2
    return (15.5 * c4 * c2 - 40.14 * c4 * c + 31.96 * c4 - 6.868 * c2 * c
            + 0.4298 * c2 + 0.1191 * c - 0.00232)


def _pbr_neutral(color):
    """Khronos PBR-neutral-style highlight compression (simplified)."""
    start = 0.8
    peak = jnp.max(color, axis=-1, keepdims=True)
    d = 1.0 - start
    new_peak = 1.0 - d * d / jnp.maximum(peak + d - start, 1e-6)
    scale = jnp.where(peak > start, new_peak / jnp.maximum(peak, 1e-6), 1.0)
    g = 1.0 / (1.3 * jnp.maximum(peak - start, 0.0) + 1.0)
    out = color * scale
    white = jnp.ones_like(out) * new_peak
    return out * g + white * (1.0 - g)


class ImageInfo(NamedTuple):
    min: jnp.ndarray
    max: jnp.ndarray
    average: jnp.ndarray
    soft_min: jnp.ndarray
    soft_max: jnp.ndarray
    median: jnp.ndarray
    inf_count: jnp.ndarray
    nan_count: jnp.ndarray
    neg_count: jnp.ndarray
    histogram: jnp.ndarray  # [4, bins] r/g/b/luminance


@functools.partial(jax.jit, static_argnames=("bins",))
def image_info(img, scale=1.0, bins: int = 64) -> ImageInfo:
    """Whole-image statistics (imageinfo.art:17-144)."""
    rgb = img * scale
    lum = (0.2126 * rgb[..., 0] + 0.7152 * rgb[..., 1] + 0.0722 * rgb[..., 2])
    finite = jnp.isfinite(lum)
    safe = jnp.where(finite, lum, 0.0)
    lmin = jnp.min(jnp.where(finite, lum, jnp.inf))
    lmax = jnp.max(jnp.where(finite, lum, -jnp.inf))
    avg = jnp.sum(safe) / jnp.maximum(jnp.sum(finite), 1)
    sorted_l = jnp.sort(safe.reshape(-1))
    n = sorted_l.shape[0]
    soft_min = sorted_l[max(int(n * 0.01), 0)]
    soft_max = sorted_l[min(int(n * 0.99), n - 1)]
    median = sorted_l[n // 2]
    inf_count = jnp.sum(jnp.isinf(rgb))
    nan_count = jnp.sum(jnp.isnan(rgb))
    neg_count = jnp.sum(rgb < 0)

    lo = soft_min
    hi = jnp.maximum(soft_max, lo + 1e-6)
    def hist(ch):
        idx = jnp.clip(((ch - lo) / (hi - lo) * bins).astype(jnp.int32),
                       0, bins - 1)
        return jnp.zeros(bins, jnp.int32).at[idx.reshape(-1)].add(1)
    histogram = jnp.stack([hist(rgb[..., 0]), hist(rgb[..., 1]),
                           hist(rgb[..., 2]), hist(lum)])
    return ImageInfo(lmin, lmax, avg, soft_min, soft_max, median,
                     inf_count, nan_count, neg_count, histogram)
