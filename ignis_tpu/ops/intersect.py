"""Ray-primitive intersection on flat SoA geometry.

Small scenes intersect ray wavefronts against triangle *chunks* with dense
math — a `lax.scan` over chunks of the (padded) triangle soup, fused by
XLA, with no gathers in the inner loop. Scenes from BVH_THRESHOLD
triangles up walk a BVH8 instead (ops/bvh.py, ops/bvh_gpu.py).
Möller-Trumbore mirrors the semantics of
/root/reference/src/artic/traversal/intersection.art:74.

Geometry layout (see ignis_tpu.scene.build): triangles padded to a multiple
of TRI_CHUNK with degenerate (zero-edge) entries that can never hit.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.vec import Vec3, cross, dot

TRI_CHUNK = 256
FLT_MAX = 3.0e38  # python float: jnp module constants become captured buffers
MT_EPS = 1e-9     # |det| below which the replayed winner is degenerate


class Rays(NamedTuple):
    org: Vec3   # [N]
    dir: Vec3   # [N]
    tmin: jnp.ndarray
    tmax: jnp.ndarray


class Hit(NamedTuple):
    t: jnp.ndarray      # [N] f32, FLT_MAX if miss
    prim: jnp.ndarray   # [N] i32 global primitive id (-1 if miss)
    u: jnp.ndarray      # [N] f32 barycentric / param
    v: jnp.ndarray      # [N] f32

    @property
    def is_hit(self):
        return self.prim >= 0


class TriSoup(NamedTuple):
    """Padded SoA triangle soup; count is a multiple of TRI_CHUNK."""
    v0: Vec3   # [T]
    e1: Vec3   # v1 - v0
    e2: Vec3   # v2 - v0


def _moeller_trumbore(org: Vec3, d: Vec3, v0: Vec3, e1: Vec3, e2: Vec3):
    """Batched MT: org/d are [N, 1]-broadcastable against [1, C] tris.

    Returns (t, u, v, ok) with shapes broadcast([N, C]).
    """
    pvec = cross(d, e2)
    det = dot(e1, pvec)
    inv_det = jnp.where(jnp.abs(det) > 1e-16, 1.0 / jnp.where(det == 0, 1.0, det), 0.0)
    tvec = org - v0
    u = dot(tvec, pvec) * inv_det
    qvec = cross(tvec, e1)
    v = dot(d, qvec) * inv_det
    t = dot(e2, qvec) * inv_det
    ok = (jnp.abs(det) > 1e-16) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
    return t, u, v, ok


def _expand(v: Vec3, axis: int) -> Vec3:
    return Vec3(jnp.expand_dims(v.x, axis), jnp.expand_dims(v.y, axis),
                jnp.expand_dims(v.z, axis))


def _mt_terms(ox, oy, oz, dx, dy, dz,
              v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z):
    """Differentiable Möller-Trumbore (intersection.art:74 semantics) on
    scalar components, for replaying a fixed winner in a backward pass.

    Broadcast-agnostic: ray components and triangle components may carry
    any mutually broadcastable shapes. Returns (t, u, v, det)."""
    pvx = dy * e2z - dz * e2y                                 # d x e2
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    tvx = ox - v0x
    tvy = oy - v0y
    tvz = oz - v0z
    qvx = tvy * e1z - tvz * e1y                               # tvec x e1
    qvy = tvz * e1x - tvx * e1z
    qvz = tvx * e1y - tvy * e1x
    inv_det = 1.0 / jnp.where(jnp.abs(det) < MT_EPS, 1.0, det)
    u = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
    v = (dx * qvx + dy * qvy + dz * qvz) * inv_det
    t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
    return t, u, v, det


def _pad_soup(soup: TriSoup) -> TriSoup:
    """Pad the soup to a TRI_CHUNK multiple with degenerate (zero-edge)
    triangles so the chunked scan covers every real triangle. Shapes are
    static, so this is free under jit when already aligned."""
    n_tri = soup.v0.x.shape[0]
    pad = (-n_tri) % TRI_CHUNK
    if pad == 0:
        return soup
    z = jnp.zeros((pad,), soup.v0.x.dtype)
    pv = lambda v: Vec3(jnp.concatenate([v.x, z]), jnp.concatenate([v.y, z]),
                        jnp.concatenate([v.z, z]))
    return TriSoup(pv(soup.v0), pv(soup.e1), pv(soup.e2))


def intersect_tris_dense(rays: Rays, soup: TriSoup, any_hit: bool = False) -> Hit:
    """Closest hit over the whole padded tri soup: an XLA scan over
    TRI_CHUNK chunks, whose body XLA fuses into one loop."""
    soup = _pad_soup(soup)
    n_chunks = soup.v0.x.shape[0] // TRI_CHUNK

    org = _expand(rays.org, -1)   # [N, 1]
    d = _expand(rays.dir, -1)
    tmin = rays.tmin[..., None]
    tmax = rays.tmax[..., None]

    def chunk_slice(c):
        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, c * TRI_CHUNK, TRI_CHUNK)
        return (Vec3(*map(sl, soup.v0)), Vec3(*map(sl, soup.e1)),
                Vec3(*map(sl, soup.e2)))

    def body(carry, c):
        best_t, best_prim, best_u, best_v = carry
        v0, e1, e2 = chunk_slice(c)
        t, u, v, ok = _moeller_trumbore(org, d, _expand(v0, 0), _expand(e1, 0),
                                        _expand(e2, 0))
        ok = ok & (t > tmin) & (t < tmax) & (t < best_t[..., None])
        # Arg-min over the chunk axis
        t_masked = jnp.where(ok, t, FLT_MAX)
        j = jnp.argmin(t_masked, axis=-1)
        t_j = jnp.take_along_axis(t_masked, j[..., None], axis=-1)[..., 0]
        got = t_j < best_t
        u_j = jnp.take_along_axis(u, j[..., None], axis=-1)[..., 0]
        v_j = jnp.take_along_axis(v, j[..., None], axis=-1)[..., 0]
        prim_j = c * TRI_CHUNK + j
        return (jnp.where(got, t_j, best_t),
                jnp.where(got, prim_j.astype(jnp.int32), best_prim),
                jnp.where(got, u_j, best_u),
                jnp.where(got, v_j, best_v)), None

    n = rays.tmin.shape
    init = (jnp.full(n, FLT_MAX), jnp.full(n, -1, jnp.int32),
            jnp.zeros(n), jnp.zeros(n))
    if n_chunks > 0:
        (t, prim, u, v), _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    else:
        t, prim, u, v = init
    return Hit(t, prim, u, v)


def occluded_tris_dense(rays: Rays, soup: TriSoup,
                        shadow_visible: jnp.ndarray | None = None) -> jnp.ndarray:
    """Boolean any-hit test. `shadow_visible` is a per-triangle mask of
    triangles that participate in shadowing (reference: entity
    `shadow_visible` flag)."""
    soup = _pad_soup(soup)
    if shadow_visible is not None:
        pad = soup.v0.x.shape[0] - shadow_visible.shape[0]
        if pad:
            shadow_visible = jnp.concatenate(
                [shadow_visible, jnp.zeros((pad,), shadow_visible.dtype)])
    n_chunks = soup.v0.x.shape[0] // TRI_CHUNK
    org = _expand(rays.org, -1)
    d = _expand(rays.dir, -1)
    tmin = rays.tmin[..., None]
    tmax = rays.tmax[..., None]

    def body(carry, c):
        def sl(a):
            return jax.lax.dynamic_slice_in_dim(a, c * TRI_CHUNK, TRI_CHUNK)
        v0 = Vec3(*map(sl, soup.v0))
        e1 = Vec3(*map(sl, soup.e1))
        e2 = Vec3(*map(sl, soup.e2))
        t, _, _, ok = _moeller_trumbore(org, d, _expand(v0, 0), _expand(e1, 0),
                                        _expand(e2, 0))
        ok = ok & (t > tmin) & (t < tmax)
        if shadow_visible is not None:
            ok = ok & sl(shadow_visible)[None, :]
        return carry | jnp.any(ok, axis=-1), None

    init = jnp.zeros(rays.tmin.shape, bool)
    if n_chunks > 0:
        out, _ = jax.lax.scan(body, init, jnp.arange(n_chunks))
    else:
        out = init
    return out


# ---------------------------------------------------------------------------
# Analytic spheres (world-space center/radius; see scene.build)
# ---------------------------------------------------------------------------

class SphereSoup(NamedTuple):
    center: Vec3        # [S]
    radius: jnp.ndarray  # [S] (<= 0 entries are padding)


def intersect_spheres_dense(rays: Rays, spheres: SphereSoup,
                            prim_offset: int) -> Hit:
    """Dense ray-sphere closest hit; prim ids offset past the tri soup.

    (u, v) parameterize the hit normal's spherical coordinates like the
    reference sphere shape (shapes/sphere.art).
    """
    s = spheres.radius.shape[0]
    if s == 0:
        n = rays.tmin.shape
        return Hit(jnp.full(n, FLT_MAX), jnp.full(n, -1, jnp.int32),
                   jnp.zeros(n), jnp.zeros(n))
    org = _expand(rays.org, -1)
    d = _expand(rays.dir, -1)
    c = _expand(spheres.center, 0)
    r = spheres.radius[None, :]
    oc = org - c
    a = dot(d, d)
    b = 2.0 * dot(oc, d)
    cc = dot(oc, oc) - r * r
    disc = b * b - 4.0 * a * cc
    ok = (disc >= 0.0) & (r > 0.0)
    # sqrt's derivative is infinite at 0: keep missed lanes off it
    sq = jnp.where(ok, jnp.sqrt(jnp.where(ok, disc, 1.0)), 0.0)
    inv2a = 1.0 / (2.0 * a)
    t0 = (-b - sq) * inv2a
    t1 = (-b + sq) * inv2a
    tmin = rays.tmin[..., None]
    tmax = rays.tmax[..., None]
    t0v = jnp.where(ok & (t0 > tmin) & (t0 < tmax), t0, FLT_MAX)
    t1v = jnp.where(ok & (t1 > tmin) & (t1 < tmax), t1, FLT_MAX)
    t = jnp.minimum(t0v, t1v)
    j = jnp.argmin(t, axis=-1)
    t_j = jnp.take_along_axis(t, j[..., None], axis=-1)[..., 0]
    hit = t_j < FLT_MAX
    return Hit(jnp.where(hit, t_j, FLT_MAX),
               jnp.where(hit, (prim_offset + j).astype(jnp.int32), -1),
               jnp.zeros_like(t_j), jnp.zeros_like(t_j))


def occluded_spheres_dense(rays: Rays, spheres: SphereSoup,
                           shadow_visible: jnp.ndarray | None = None) -> jnp.ndarray:
    if spheres.radius.shape[0] == 0:
        return jnp.zeros(rays.tmin.shape, bool)
    h = intersect_spheres_dense(rays, spheres, 0)
    return h.prim >= 0


def merge_hits(a: Hit, b: Hit) -> Hit:
    take_b = b.t < a.t
    return Hit(jnp.where(take_b, b.t, a.t),
               jnp.where(take_b, b.prim, a.prim),
               jnp.where(take_b, b.u, a.u),
               jnp.where(take_b, b.v, a.v))
