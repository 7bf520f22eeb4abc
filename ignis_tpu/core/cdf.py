"""1D / 2D discrete CDF construction and sampling.

Wavefront analog of the reference CDF library
(/root/reference/src/artic/core/cdf.art) used for environment-map importance
sampling, mesh area sampling and light selection. Construction happens
host-side (numpy-friendly jnp); sampling runs inside jit using
jnp.searchsorted (log-n gathers).

Layout convention matches the reference: a 1D CDF over n bins is an array of
n entries cdf[i] = sum(w[0..i]) / total, so cdf[n-1] == 1. Sampling draws
u in [0,1), finds the first bin with cdf >= u, and re-scales the residual for
reuse (stratification-preserving).
"""
from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class CDF1D(NamedTuple):
    cdf: jnp.ndarray  # [n] inclusive prefix sums, last == 1

    @property
    def size(self):
        return self.cdf.shape[-1]


def build_cdf_1d(weights) -> CDF1D:
    w = jnp.asarray(weights, jnp.float32)
    c = jnp.cumsum(w, axis=-1)
    total = c[..., -1:]
    # Degenerate (all-zero) rows fall back to uniform.
    n = w.shape[-1]
    uniform = (jnp.arange(1, n + 1, dtype=jnp.float32) / n)
    uniform = jnp.broadcast_to(uniform, c.shape)
    c = jnp.where(total > 0, c / jnp.where(total > 0, total, 1.0), uniform)
    return CDF1D(c)


def sample_cdf_1d(c: CDF1D, u):
    """Sample bin index ~ weights. Returns (index, remapped_u, pdf)."""
    cdf = c.cdf
    n = cdf.shape[-1]
    idx = jnp.clip(jnp.searchsorted(cdf, u, side="right"), 0, n - 1)
    lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    hi = cdf[idx]
    pdf = hi - lo
    rem = jnp.where(pdf > 0, (u - lo) / jnp.where(pdf > 0, pdf, 1.0), 0.0)
    return idx, jnp.clip(rem, 0.0, 1.0), pdf


def pdf_cdf_1d(c: CDF1D, idx):
    cdf = c.cdf
    lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    return cdf[idx] - lo


class CDF2D(NamedTuple):
    """Row-marginal + per-row-conditional CDF over an (h, w) grid.

    sample() returns continuous (x, y) in [0,1)^2 with pdf w.r.t. the unit
    square (i.e. pdf integrates to 1 over the square; multiply by h*w to get
    the per-texel discrete pdf).
    """
    marginal: jnp.ndarray     # [h] CDF over rows
    conditional: jnp.ndarray  # [h, w] CDF along each row

    @property
    def height(self):
        return self.conditional.shape[0]

    @property
    def width(self):
        return self.conditional.shape[1]


def build_cdf_2d(weights) -> CDF2D:
    w = jnp.asarray(weights, jnp.float32)  # [h, w]
    h, n = w.shape
    row_sum = jnp.sum(w, axis=-1)
    cond = build_cdf_1d(w).cdf
    marg = build_cdf_1d(row_sum).cdf
    return CDF2D(marg, cond)


def sample_cdf_2d(c: CDF2D, u, v):
    """Continuous 2D sample. Returns (x, y, pdf) — unit-square pdf."""
    h, w = c.height, c.width
    # Row from marginal (using v)
    ri = jnp.clip(jnp.searchsorted(c.marginal, v, side="right"), 0, h - 1)
    rlo = jnp.where(ri > 0, c.marginal[jnp.maximum(ri - 1, 0)], 0.0)
    rhi = c.marginal[ri]
    rp = rhi - rlo
    rrem = jnp.where(rp > 0, (v - rlo) / jnp.where(rp > 0, rp, 1.0), 0.0)
    # Column from conditional row (using u); gather the row then search.
    row = c.conditional[ri]  # [..., w]
    ci = jnp.clip(_searchsorted_rows(row, u), 0, w - 1)
    clo = jnp.where(ci > 0, jnp.take_along_axis(
        row, jnp.maximum(ci - 1, 0)[..., None], axis=-1)[..., 0], 0.0)
    chi = jnp.take_along_axis(row, ci[..., None], axis=-1)[..., 0]
    cp = chi - clo
    crem = jnp.where(cp > 0, (u - clo) / jnp.where(cp > 0, cp, 1.0), 0.0)

    x = (ci.astype(jnp.float32) + jnp.clip(crem, 0.0, 1.0)) / w
    y = (ri.astype(jnp.float32) + jnp.clip(rrem, 0.0, 1.0)) / h
    pdf = (rp * h) * (cp * w)
    return x, y, pdf


def pdf_cdf_2d(c: CDF2D, x, y):
    """Unit-square pdf at continuous position (x, y)."""
    h, w = c.height, c.width
    ri = jnp.clip((y * h).astype(jnp.int32), 0, h - 1)
    ci = jnp.clip((x * w).astype(jnp.int32), 0, w - 1)
    rlo = jnp.where(ri > 0, c.marginal[jnp.maximum(ri - 1, 0)], 0.0)
    rp = c.marginal[ri] - rlo
    row = c.conditional[ri]
    clo = jnp.where(ci > 0, jnp.take_along_axis(
        row, jnp.maximum(ci - 1, 0)[..., None], axis=-1)[..., 0], 0.0)
    cp = jnp.take_along_axis(row, ci[..., None], axis=-1)[..., 0] - clo
    return (rp * h) * (cp * w)


def _searchsorted_rows(rows, u):
    """searchsorted along the last axis of `rows` for scalar-per-row `u`."""
    # rows: [..., w]; u: [...] -> index [...]
    return jnp.sum((rows < u[..., None]).astype(jnp.int32), axis=-1)


# ---------------------------------------------------------------------------
# Summed-area-table 2D CDF (reference core/cdf.art make_cdf_2d_sat:164-270).
# Construction is host-side; sampling inverts the piecewise-bilinear SAT by
# fixed-depth bisection (log2(n)+2 iterations, branchless per lane).
# ---------------------------------------------------------------------------

class SAT2D(NamedTuple):
    table: jnp.ndarray  # [h+1, w+1] exclusive 2D prefix sums, table[-1,-1]=1
    grid: jnp.ndarray   # [h, w] unit-square density (integrates to 1)

    @property
    def height(self):
        return self.grid.shape[0]

    @property
    def width(self):
        return self.grid.shape[1]


def build_sat_2d(weights) -> SAT2D:
    import numpy as np
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    total = w.sum()
    if total <= 0:
        w = np.ones_like(w)
        total = w.sum()
    p = w / total                      # texel probabilities
    h, n = p.shape
    table = np.zeros((h + 1, n + 1), np.float64)
    table[1:, 1:] = p.cumsum(axis=0).cumsum(axis=1)
    table[-1, -1] = 1.0
    grid = p * (h * n)                 # density over the unit square
    return SAT2D(jnp.asarray(table.astype(np.float32)),
                 jnp.asarray(grid.astype(np.float32)))


def _sat_F(table, x, y):
    """Bilinear evaluation of the SAT at continuous (x, y) in [0,1]^2:
    the cumulative mass of the box [0,x] x [0,y]."""
    h = table.shape[0] - 1
    w = table.shape[1] - 1
    kx = jnp.clip(x, 0.0, 1.0) * w
    ky = jnp.clip(y, 0.0, 1.0) * h
    ix = jnp.clip(kx.astype(jnp.int32), 0, w - 1)
    iy = jnp.clip(ky.astype(jnp.int32), 0, h - 1)
    fx = kx - ix
    fy = ky - iy
    p00 = table[iy, ix]
    p10 = table[iy, ix + 1]
    p01 = table[iy + 1, ix]
    p11 = table[iy + 1, ix + 1]
    top = p00 * (1 - fx) + p10 * fx
    bot = p01 * (1 - fx) + p11 * fx
    return top * (1 - fy) + bot * fy


def _bisect_boundaries(cdf_at, u, n):
    """Invert a piecewise-linear CDF whose values at the n+1 texel
    boundaries are exact (given by `cdf_at(i)`). Bisecting on INTEGER
    boundaries lands the bracket exactly on one texel, so the final lerp
    is exact — a free-floating midpoint bisection can straddle a boundary
    between a heavy and a near-empty texel and leak samples into the
    empty one (the pdf there then under-reports by orders of magnitude).
    Returns (continuous position in [0,1], texel index)."""
    import math
    lo = jnp.zeros_like(u, dtype=jnp.int32)
    hi = jnp.full_like(lo, n)
    for _ in range(int(math.ceil(math.log2(max(n, 2))))):
        mid = (lo + hi) // 2
        go_hi = cdf_at(mid) > u
        hi = jnp.where(go_hi, mid, hi)
        lo = jnp.where(go_hi, lo, mid)
    lo = jnp.minimum(lo, n - 1)
    hi = lo + 1
    flo = cdf_at(lo)
    d = cdf_at(hi) - flo
    t = jnp.where(d > 1e-12, (u - flo) / jnp.where(d > 1e-12, d, 1.0), 0.5)
    pos = (lo.astype(jnp.float32) + jnp.clip(t, 0.0, 1.0)) / n
    return pos, lo


def sample_sat_2d(s: SAT2D, u, v):
    """Continuous 2D sample from the SAT (cdf.art sample_continuous:228).
    Returns (x, y, pdf) with a unit-square pdf."""
    h, w = s.height, s.width
    x, ix = _bisect_boundaries(lambda i: s.table[h, i], u, w)
    strip = s.table[h, ix + 1] - s.table[h, ix]
    inv_strip = jnp.where(strip > 1e-12, 1.0 / jnp.where(strip > 1e-12,
                                                         strip, 1.0), 0.0)
    y, iy = _bisect_boundaries(
        lambda j: (s.table[j, ix + 1] - s.table[j, ix]) * inv_strip, v, h)
    return x, y, s.grid[iy, ix]


def pdf_sat_2d(s: SAT2D, x, y):
    h, w = s.height, s.width
    ix = jnp.clip((x * w).astype(jnp.int32), 0, w - 1)
    iy = jnp.clip((y * h).astype(jnp.int32), 0, h - 1)
    return s.grid[iy, ix]


# ---------------------------------------------------------------------------
# Hierarchical (mip-pyramid) 2D warp (reference core/cdf.art
# make_cdf_2d_hierachical:275-355). The descent here remaps the uniform by
# the actual branch probability at every level (the reference's dyadic
# 2u - sel remap is only measure-preserving for equal branch masses), so
# sample() and pdf() agree exactly.
# ---------------------------------------------------------------------------

class Hier2D(NamedTuple):
    levels: tuple  # ([S,S], [S/2,S/2], ..., [2,2]); level 0 normalized to
    # mean 1 (its value IS the unit-square density)

    @property
    def size(self):
        return self.levels[0].shape[0]


def build_hier_2d(weights, max_size: int = 1024) -> Hier2D:
    import math

    import numpy as np
    w = np.maximum(np.asarray(weights, np.float64), 0.0)
    if w.sum() <= 0:
        w = np.ones_like(w)
    h, n = w.shape
    size = 1 << int(math.ceil(math.log2(max(h, n, 2))))
    size = min(size, max_size)
    # area-average resample onto the square power-of-two grid
    ys = (np.arange(size) + 0.5) / size * h
    xs = (np.arange(size) + 0.5) / size * n
    g = w[np.minimum(ys.astype(np.int64), h - 1)[:, None],
          np.minimum(xs.astype(np.int64), n - 1)[None, :]]
    if g.sum() <= 0:
        g = np.ones_like(g)
    g = g / g.mean()
    levels = [g]
    while levels[-1].shape[0] > 2:
        a = levels[-1]
        levels.append(a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2)
                      .sum(axis=(1, 3)))
    return Hier2D(tuple(jnp.asarray(l.astype(np.float32)) for l in levels))


def sample_hier_2d(hz: Hier2D, u, v):
    """Top-down 2x2 descent. Returns (x, y, pdf) with unit-square pdf.

    Comparisons use the ORIGINAL uniforms against interval bounds tracked
    per node (instead of serially stretching the uniform each level,
    which exhausts f32 precision after a few levels and leaks samples
    into near-empty texels)."""
    ix = jnp.zeros_like(u, dtype=jnp.int32)
    iy = jnp.zeros_like(u, dtype=jnp.int32)
    ulo = jnp.zeros_like(u)
    uw = jnp.ones_like(u)
    vlo = jnp.zeros_like(v)
    vw = jnp.ones_like(v)
    for l in range(len(hz.levels) - 1, -1, -1):
        lv = hz.levels[l]
        cx = 2 * ix
        cy = 2 * iy
        x00 = lv[cy, cx]
        x01 = lv[cy, cx + 1]
        x10 = lv[cy + 1, cx]
        x11 = lv[cy + 1, cx + 1]
        total = x00 + x01 + x10 + x11
        pl = jnp.where(total > 0, (x00 + x10) / jnp.where(total > 0, total,
                                                          1.0), 0.5)
        thr = ulo + pl * uw
        go_l = u < thr
        ulo = jnp.where(go_l, ulo, thr)
        uw = uw * jnp.where(go_l, pl, 1.0 - pl)
        ix = jnp.where(go_l, cx, cx + 1)
        colt = jnp.where(go_l, x00 + x10, x01 + x11)
        topv = jnp.where(go_l, x00, x01)
        pt = jnp.where(colt > 0, topv / jnp.where(colt > 0, colt, 1.0), 0.5)
        thr_v = vlo + pt * vw
        go_t = v < thr_v
        vlo = jnp.where(go_t, vlo, thr_v)
        vw = vw * jnp.where(go_t, pt, 1.0 - pt)
        iy = jnp.where(go_t, cy, cy + 1)
    uu = jnp.clip((u - ulo) / jnp.maximum(uw, 1e-30), 0.0, 1.0 - 1e-7)
    vv = jnp.clip((v - vlo) / jnp.maximum(vw, 1e-30), 0.0, 1.0 - 1e-7)
    size = hz.size
    x = (ix.astype(jnp.float32) + uu) / size
    y = (iy.astype(jnp.float32) + vv) / size
    return x, y, hz.levels[0][iy, ix]


def pdf_hier_2d(hz: Hier2D, x, y):
    size = hz.size
    ix = jnp.clip((x * size).astype(jnp.int32), 0, size - 1)
    iy = jnp.clip((y * size).astype(jnp.int32), 0, size - 1)
    return hz.levels[0][iy, ix]
