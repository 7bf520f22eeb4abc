"""Glare analysis (igexplorer analog; reference
/root/reference/src/frontend/explorer/glare.art:23 compute_glare — a GPU
evalglare reimplementation with a single glare source).

Given a rendered radiance image and the camera, computes the standard
daylighting glare metrics: DGP (Wienold-Christoffersen), DGI / modified
DGI, DGR + VCP, UGR / experimental UGR, UGP, with the Guth (above line of
sight) / Iwata (below) position index and automatic vertical illuminance.
Everything is one jitted reduction pass over the image — no GUI needed;
``igtpu-util glare image.exr`` prints the table the explorer's overview
widget shows (OverviewWidget.cpp:46-74).

Conventions (matching the reference):
- luminance [cd/m^2] = 179 lm/W (illuminant-E white efficiency,
  core/color.art:78) * CIE luma * ``scale``
- glare source: pixels with luminance > ``mul`` * average task luminance
  (default multiplier 5, RenderWidget.cpp:203)
- E_v < 100 lx -> all metrics report 0 (insufficient light); E_v < 1000 lx
  applies the DGP low-light correction.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def _dot(a, b):
    """Float32 dot product (a GPU may otherwise contract in TF32)."""
    return jnp.dot(a, b, precision=jax.lax.Precision.HIGHEST)

WHITE_EFFICIENCY = 179.0  # lm/W, illuminant E (reference core/color.art:78)


class GlareResult(NamedTuple):
    dgp: float
    dgi: float
    dgi_mod: float
    dgr: float
    vcp: float
    ugr: float
    ugr_exp: float
    ugp: float
    vertical_illuminance: float
    avg_lum: float
    max_lum: float
    source_lum: float
    source_omega: float
    source_x: float
    source_y: float
    source_map: np.ndarray  # [h, w] relative source luminance in [0, 1]


def _pixel_dirs(cam_eye, cam_dir, cam_up, fov_deg, w, h, xs, ys):
    """Perspective pixel->direction grid at pixel corners (xs, ys in
    [0, w] x [0, h] continuous corner coordinates)."""
    d = jnp.asarray(cam_dir, jnp.float32)
    d = d / jnp.linalg.norm(d)
    up = jnp.asarray(cam_up, jnp.float32)
    r = jnp.cross(d, up)
    r = r / jnp.linalg.norm(r)
    u = jnp.cross(r, d)
    tan_h = math.tan(math.radians(fov_deg) / 2.0)
    aspect = h / w
    px = (2.0 * xs / w - 1.0) * tan_h
    py = (1.0 - 2.0 * ys / h) * tan_h * aspect
    v = (d[None, None, :] + px[..., None] * r[None, None, :]
         + py[..., None] * u[None, None, :])
    return v / jnp.linalg.norm(v, axis=-1, keepdims=True)


@functools.partial(jax.jit, static_argnames=("w", "h", "fov_deg"))
def _glare_reductions(img, cam_dir, cam_up, w: int, h: int, fov_deg: float,
                      mul, scale, e_v_override):
    # corner direction grid [(h+1), (w+1), 3]
    xs = jnp.broadcast_to(jnp.arange(w + 1, dtype=jnp.float32)[None, :],
                          (h + 1, w + 1))
    ys = jnp.broadcast_to(jnp.arange(h + 1, dtype=jnp.float32)[:, None],
                          (h + 1, w + 1))
    corners = _pixel_dirs(None, cam_dir, cam_up, fov_deg, w, h, xs, ys)

    # per-pixel solid angle via the spherical-excess of the 4 corner rays
    # (pict_get_omega analog, glare.art:75-104)
    r1 = corners[:-1, :-1]   # (x, y)
    r2 = corners[1:, :-1]    # (x, y+1)
    r3 = corners[1:, 1:]     # (x+1, y+1)
    r4 = corners[:-1, 1:]    # (x+1, y)

    def splane(a, b):
        n = jnp.cross(a, b - a)
        l2 = jnp.sum(n * n, axis=-1, keepdims=True)
        return jnp.where(l2 > 0, n / jnp.sqrt(jnp.maximum(l2, 1e-30)), 0.0)

    n1 = splane(r1, r2)
    n2 = splane(r2, r3)
    n3 = splane(r3, r4)
    n4 = splane(r4, r1)
    ang = lambda a, b: jnp.pi - jnp.abs(jnp.arccos(jnp.clip(
        jnp.sum(a * b, axis=-1), -1.0, 1.0)))
    omega = ang(n1, n2) + ang(n2, n3) + ang(n3, n4) + ang(n4, n1) \
        - 2.0 * jnp.pi

    # center directions for cos / position-index terms
    cd = 0.25 * (r1 + r2 + r3 + r4)
    cd = cd / jnp.linalg.norm(cd, axis=-1, keepdims=True)

    d = jnp.asarray(cam_dir, jnp.float32)
    d = d / jnp.linalg.norm(d)
    up = jnp.asarray(cam_up, jnp.float32)
    hv = jnp.cross(d, up)
    hv = hv / jnp.linalg.norm(hv)
    vv = jnp.cross(d, hv)
    vv = vv / jnp.linalg.norm(vv)

    # luminance (explicit lux assuming sRGB, glare.art:107)
    luma = (0.2126 * img[..., 0] + 0.7152 * img[..., 1]
            + 0.0722 * img[..., 2])
    lum = WHITE_EFFICIENCY * luma * scale

    cos_f = jnp.abs(jnp.sum(cd * d, axis=-1))
    total_omega = jnp.sum(omega)
    total_lum = jnp.sum(lum * omega)
    max_lum = jnp.max(lum)
    e_v_auto = jnp.sum(lum * omega * cos_f)
    e_v = jnp.where(e_v_override < 0, e_v_auto, e_v_override)

    lum_avg = total_lum / total_omega
    lum_source = lum_avg * mul

    # glare-source aggregation (single source, glare.art:145-171)
    is_src = lum > lum_source
    xi = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
    yi = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
    src_omega = jnp.sum(jnp.where(is_src, omega, 0.0))
    src_lum_o = jnp.sum(jnp.where(is_src, lum * omega, 0.0))
    src_x = jnp.sum(jnp.where(is_src, xi * omega, 0.0))
    src_y = jnp.sum(jnp.where(is_src, yi * omega, 0.0))

    # relative source-luminance map (primary glare source scan)
    max_diff = jnp.maximum(max_lum - lum_source, 1e-20)
    source_map = jnp.where(is_src, (lum - lum_source) / max_diff, 0.0)

    # position index at the source centroid (Guth above / Iwata below the
    # line of sight, glare.art:36-70)
    so = jnp.maximum(src_omega, 1e-20)
    gx = src_x / so
    gy = src_y / so
    gxi = jnp.clip(gx, 0.0, w - 1.0)
    gyi = jnp.clip(gy, 0.0, h - 1.0)
    gdir = _pixel_dirs(None, cam_dir, cam_up, fov_deg, w, h,
                       jnp.reshape(gxi + 0.5, (1, 1)),
                       jnp.reshape(gyi + 0.5, (1, 1)))[0, 0]
    vangle = jnp.arccos(jnp.clip(_dot(vv, gdir), -1, 1)) - jnp.pi / 2
    hangle = jnp.pi / 2 - jnp.arccos(jnp.clip(_dot(hv, gdir), -1, 1))
    t = _dot(d, gdir)
    sigma = jnp.degrees(jnp.abs(jnp.arccos(jnp.clip(t, -1, 1))))
    hvn = gdir / jnp.maximum(t, 1e-6) - gdir
    hvn = hvn / jnp.maximum(jnp.linalg.norm(hvn), 1e-20)
    tau = jnp.degrees(jnp.arccos(jnp.clip(_dot(vv, hvn), -1, 1)))
    phi = jnp.maximum(vangle, 1e-5)
    theta = jnp.maximum(hangle, 1e-5)
    # Guth model (the reference's phi<0 Iwata branch is dead code after its
    # own fmax clamp, glare.art:49-52; mirrored faithfully)
    posindex = jnp.exp(
        (35.2 - 0.31889 * tau - 1.22 * jnp.exp(-2 * tau / 9)) / 1000 * sigma
        + (21 + 0.26667 * tau - 0.002963 * tau * tau) / 100000 * sigma * sigma)
    posindex = jnp.minimum(posindex, 16.0)

    return (total_omega, total_lum, max_lum, e_v, lum_avg, lum_source,
            src_omega, src_lum_o, gx, gy, posindex, source_map)


def compute_glare(img, cam_dir=(0, 0, 1), cam_up=(0, 1, 0), fov_deg=60.0,
                  mul=5.0, scale=1.0, vertical_illuminance=-1.0) -> GlareResult:
    """Glare metrics for a radiance image (reference compute_glare,
    glare.art:23-300). ``img``: [h, w, 3] linear radiance."""
    img = jnp.asarray(img, jnp.float32)
    h, w = img.shape[0], img.shape[1]
    (total_omega, total_lum, max_lum, e_v, lum_avg, lum_source,
     src_omega, src_lum_o, gx, gy, posi, source_map) = [
        np.asarray(v) for v in _glare_reductions(
            img, jnp.asarray(cam_dir, jnp.float32),
            jnp.asarray(cam_up, jnp.float32), w, h, float(fov_deg),
            jnp.float32(mul), jnp.float32(scale),
            jnp.float32(vertical_illuminance))]
    total_omega, total_lum = float(total_omega), float(total_lum)
    max_lum, e_v = float(max_lum), float(e_v)
    lum_avg, lum_source = float(lum_avg), float(lum_source)
    src_omega, src_lum_o = float(src_omega), float(src_lum_o)
    posi = float(posi)

    glare_omega = src_omega
    glare_lum = src_lum_o / glare_omega if glare_omega > 0 else 0.0
    lum_a = e_v / math.pi
    if glare_omega <= 1e-9:
        lum_backg = lum_avg
    else:
        lum_backg = (total_lum - src_lum_o) / (total_omega - src_omega)

    def dgp():
        c1, c2, c3 = 5.87e-5, 0.092, 0.159
        acc = (glare_lum ** 2) / (posi ** 2) * glare_omega / (e_v ** 1.87)
        source_dgp = math.log10(1 + acc)
        if glare_omega > 0:
            return c1 * e_v + c2 * source_dgp + c3
        return c1 * e_v + c3

    def dgi():
        omega_s = glare_omega / (posi * posi)
        s = 0.478 * glare_lum ** 1.6 * omega_s ** 0.8 / (
            lum_backg + 0.07 * glare_omega ** 0.5 * glare_lum)
        return 10 * math.log10(max(s, 1e-30))

    def dgi_mod():
        omega_s = glare_omega / (posi * posi)
        s = 0.478 * glare_lum ** 1.6 * omega_s ** 0.8 / (
            lum_a ** 0.85 + 0.07 * glare_omega ** 0.5 * glare_lum)
        return 10 * math.log10(max(s, 1e-30))

    def dgr():
        return 0.5 * glare_lum * (
            20.4 * glare_omega + 1.52 * glare_omega ** 0.2 - 0.075) / (
            posi * lum_avg ** 0.44)

    def vcp(dgr_v):
        if dgr_v > 750:
            return 0.0
        if dgr_v < 20:
            return 100.0
        return 50 * math.erf((6.374 - 1.3227 * math.log(dgr_v))
                             / 1.414213562373) + 50

    def ugr():
        s = (glare_lum / posi) ** 2 * glare_omega
        if s == 0:
            return 0.0
        return 8 * math.log10(0.25 / lum_backg * s)

    def ugr_exp():
        s = (1 / posi) ** 2 * glare_lum * glare_omega
        if s == 0:
            return 0.0
        return 8 * math.log10(lum_a) + 8 * math.log10(s / lum_backg)

    low_light = math.exp(0.024 * e_v - 4)
    low_light_corr = low_light / (1 + low_light) if e_v < 1000 else 1.0
    insufficient = e_v < 100

    z = lambda f: 0.0 if insufficient else f
    dgr_v = z(dgr())
    return GlareResult(
        dgp=z(low_light_corr * dgp()), dgi=z(dgi()), dgi_mod=z(dgi_mod()),
        dgr=dgr_v, vcp=z(vcp(dgr_v)) if not insufficient else 0.0,
        ugr=z(ugr()), ugr_exp=z(ugr_exp()),
        ugp=z(ugr() / 8 * 0.26),
        vertical_illuminance=e_v, avg_lum=lum_avg, max_lum=max_lum,
        source_lum=glare_lum, source_omega=glare_omega,
        source_x=float(gx), source_y=float(gy),
        source_map=np.asarray(source_map))


def glare_from_runtime(rt, mul=5.0, scale=1.0,
                       vertical_illuminance=-1.0) -> GlareResult:
    """Compute glare metrics for a Runtime's current (normalized) film,
    using its camera orientation and fov — the explorer's overview pass."""
    img = rt.framebuffer(normalized=True)
    cam = rt.scene.camera
    cd = [float(cam.dir.x), float(cam.dir.y), float(cam.dir.z)]
    cu = [float(cam.up.x), float(cam.up.y), float(cam.up.z)]
    fov = math.degrees(2.0 * math.atan(float(cam.tan_half_fov))) \
        if hasattr(cam, "tan_half_fov") else 60.0
    return compute_glare(img, cd, cu, fov, mul, scale, vertical_illuminance)
