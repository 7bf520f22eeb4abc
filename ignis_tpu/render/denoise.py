"""AOV-guided denoiser.

The reference wires Intel Open Image Denoise behind Runtime (extra/OIDN.h,
fed by the `infobuffer` Normals/Albedo AOVs). A neural denoiser is not
portable here, so this is a classical equivalent with the same
API shape and guide inputs: an edge-avoiding à-trous wavelet filter
(Dammertz et al. 2010) jointly guided by color, normal, albedo and depth.
Runs fully in JAX (stacked shifted images, no gather loops) so it executes
on-device right after the render.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# 5x5 B3-spline kernel weights (separable 1/16 [1 4 6 4 1]); plain python
# floats — module-level jnp constants turn into tracers under this jax
# version's jit and break float()
_K1D = [1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16]


def _shift2d(img, dy, dx):
    """Shift with edge clamp (works for [h, w, c])."""
    h, w = img.shape[0], img.shape[1]
    ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


@functools.partial(jax.jit, static_argnames=("iterations",))
def denoise_image(color, normals=None, albedo=None, depth=None,
                  iterations: int = 4, sigma_color: float = 0.45,
                  sigma_normal: float = 0.2, sigma_albedo: float = 0.25,
                  sigma_depth: float = 0.03):
    """Edge-avoiding a-trous filter; all inputs [h, w, 3] (depth [h, w])."""
    color = jnp.asarray(color, jnp.float32)
    h, w = color.shape[0], color.shape[1]
    if normals is None:
        normals = jnp.zeros_like(color)
    if albedo is None:
        albedo = jnp.zeros_like(color)
    if depth is None:
        depth = jnp.zeros((h, w), jnp.float32)
    depth = jnp.asarray(depth, jnp.float32)
    dscale = 1.0 / jnp.maximum(jnp.max(jnp.abs(depth)), 1e-6)
    depth = depth * dscale

    out = color
    for it in range(iterations):
        step = 1 << it
        acc = jnp.zeros_like(out)
        wsum = jnp.zeros((h, w, 1), jnp.float32)
        for ky in range(5):
            for kx in range(5):
                dy = (ky - 2) * step
                dx = (kx - 2) * step
                kw = _K1D[ky] * _K1D[kx]
                c_s = _shift2d(out, dy, dx)
                n_s = _shift2d(normals, dy, dx)
                a_s = _shift2d(albedo, dy, dx)
                d_s = _shift2d(depth[..., None], dy, dx)[..., 0]
                dc = jnp.sum((c_s - out) ** 2, axis=-1)
                dn = jnp.sum((n_s - normals) ** 2, axis=-1)
                da = jnp.sum((a_s - albedo) ** 2, axis=-1)
                dd = (d_s - depth) ** 2
                wgt = kw * jnp.exp(
                    -dc / (sigma_color * sigma_color * (1 << it))
                    - dn / (sigma_normal * sigma_normal)
                    - da / (sigma_albedo * sigma_albedo)
                    - dd / (sigma_depth * sigma_depth))
                acc = acc + c_s * wgt[..., None]
                wsum = wsum + wgt[..., None]
        out = acc / jnp.maximum(wsum, 1e-8)
    return out


def _box_filter(img, r):
    """Mean filter of radius r over [h, w] via shifted sums."""
    acc = jnp.zeros_like(img)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            acc = acc + _shift2d(img[..., None], dy, dx)[..., 0]
    return acc / float((2 * r + 1) ** 2)


def _estimate_noise(color):
    """Global MC-noise scale from the median absolute high-pass response
    (Immerkaer-style); relative to local luminance so the threshold tracks
    the signal-proportional variance of path tracing."""
    # an elementwise sum: a float32 matmul may run in TF32 on a GPU
    lum = (0.2126 * color[..., 0] + 0.7152 * color[..., 1]
           + 0.0722 * color[..., 2])
    lap = (4.0 * lum
           - _shift2d(lum[..., None], 0, 1)[..., 0]
           - _shift2d(lum[..., None], 0, -1)[..., 0]
           - _shift2d(lum[..., None], 1, 0)[..., 0]
           - _shift2d(lum[..., None], -1, 0)[..., 0])
    rel = jnp.abs(lap) / (lum + 5e-2)
    s = 1.4826 * jnp.median(rel) / jnp.sqrt(20.0)
    return s, lum


@functools.partial(jax.jit, static_argnames=("search_radius",
                                             "patch_radius"))
def denoise_image_nlm(color, normals=None, albedo=None, depth=None,
                      search_radius: int = 5, patch_radius: int = 1,
                      sigma_normal: float = 0.35, sigma_albedo: float = 0.3,
                      sigma_depth: float = 0.05, k: float = 0.45):
    """AOV-guided non-local means (the default denoiser).

    Patch-SSD weights with the noise-offset subtraction of Buades et al.
    (w = exp(-max(SSD - 2sigma^2, 0)/h^2)) so flat-but-noisy regions
    average aggressively while real edges survive, jointly gated by the
    Normals/Albedo/Depth guides the reference feeds OIDN
    (/root/reference/src/runtime/extra/OIDN.cpp:92-121). Noise level is
    estimated from the image (luminance-relative median high-pass), so
    the filter adapts to spp without parameters."""
    color = jnp.asarray(color, jnp.float32)
    h, w = color.shape[0], color.shape[1]
    if normals is None:
        normals = jnp.zeros_like(color)
    if albedo is None:
        albedo = jnp.zeros_like(color)
    if depth is None:
        depth = jnp.zeros((h, w), jnp.float32)
    depth = jnp.asarray(depth, jnp.float32)
    depth = depth / jnp.maximum(jnp.max(jnp.abs(depth)), 1e-6)

    # Per-pixel noise floor calibrated EMPIRICALLY from the data: the
    # patch-SSD to the immediate 8-neighborhood is ~2*noise-variance in
    # statistically-flat regions (heavy-tailed MC noise defeats
    # Gaussian-model estimates). A smoothed version of that local floor
    # is what distant candidates must beat to be rejected.
    floor = jnp.zeros((h, w), jnp.float32)
    cnt = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy == 0 and dx == 0:
                continue
            d2 = jnp.mean((_shift2d(color, dy, dx) - color) ** 2, axis=-1)
            floor = floor + _box_filter(d2, patch_radius)
            cnt += 1
    floor = _box_filter(floor / cnt, 2)
    hh = jnp.maximum(k * floor, 1e-12)

    acc = jnp.zeros_like(color)
    wsum = jnp.zeros((h, w), jnp.float32)
    for dy in range(-search_radius, search_radius + 1):
        for dx in range(-search_radius, search_radius + 1):
            c_s = _shift2d(color, dy, dx)
            d2 = jnp.mean((c_s - color) ** 2, axis=-1)
            ssd = _box_filter(d2, patch_radius)
            n_s = _shift2d(normals, dy, dx)
            a_s = _shift2d(albedo, dy, dx)
            d_s = _shift2d(depth[..., None], dy, dx)[..., 0]
            dn = jnp.sum((n_s - normals) ** 2, axis=-1)
            da = jnp.sum((a_s - albedo) ** 2, axis=-1)
            dd = (d_s - depth) ** 2
            wgt = jnp.exp(
                -jnp.maximum(ssd - floor, 0.0) / hh
                - dn / (sigma_normal * sigma_normal)
                - da / (sigma_albedo * sigma_albedo)
                - dd / (sigma_depth * sigma_depth))
            acc = acc + c_s * wgt[..., None]
            wsum = wsum + wgt
    return acc / jnp.maximum(wsum[..., None], 1e-8)


def has_denoiser() -> bool:
    """Reference Runtime::hasDenoiser analog (always available here)."""
    return True
