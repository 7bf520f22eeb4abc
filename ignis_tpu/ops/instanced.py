"""Two-level acceleration: instanced geometry with world->local transforms.

Analog of the reference's top-level EntityLeaf BVH
(/root/reference/src/artic/traversal/bvh.art:40-61 world->local 3x4
transforms; src/runtime/loader/LoaderEntity.cpp:18-32 two-level scene BVH;
src/runtime/bvh/SceneBVHAdapter.h:110-128): N entities sharing one shape
keep ONE local-space triangle soup (O(1 mesh) memory) instead of N
world-space copies.

Wavefront shape: there is no per-ray TLAS descent — a lax.scan over
instances runs the whole ray block through each instance's local-space
BLAS (the dense chunk sweep), with a per-instance world-AABB slab test
culling rays up front.
Closest hits fold with the usual min-t carry; t is world-invariant
because local rays use d' = A d unnormalized.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.vec import Vec2, Vec3
from .intersect import FLT_MAX, Hit, Rays, TriSoup


class InstancedGeo(NamedTuple):
    """One shared local-space mesh + per-instance transforms. A scene
    builds one InstancedGeo per reused shape group (scene/build.py)."""
    soup: TriSoup                 # local space, chunk-padded
    n0: Vec3                      # local vertex normals
    n1: Vec3
    n2: Vec3
    uv0: Vec2
    uv1: Vec2
    uv2: Vec2
    w2l: jnp.ndarray              # [I, 3, 4] world -> local affine
    nrm_mat: jnp.ndarray          # [I, 3, 3] normal matrix (w2l linear)^T
    ent: jnp.ndarray              # [I] i32 entity ids
    shadow_visible: jnp.ndarray   # [I] bool
    aabb_min: jnp.ndarray         # [I, 3] world-space instance bounds
    aabb_max: jnp.ndarray         # [I, 3]

    @property
    def n_instances(self) -> int:
        return self.w2l.shape[0]

    @property
    def tris_per_instance(self) -> int:
        return self.soup.v0.x.shape[0]


def _local_rays(rays: Rays, m: jnp.ndarray) -> Rays:
    """Transform rays into one instance's local space (d unnormalized so
    local t == world t)."""
    A, b = m[:3, :3], m[:3, 3]
    o = Vec3(A[0, 0] * rays.org.x + A[0, 1] * rays.org.y
             + A[0, 2] * rays.org.z + b[0],
             A[1, 0] * rays.org.x + A[1, 1] * rays.org.y
             + A[1, 2] * rays.org.z + b[1],
             A[2, 0] * rays.org.x + A[2, 1] * rays.org.y
             + A[2, 2] * rays.org.z + b[2])
    d = Vec3(A[0, 0] * rays.dir.x + A[0, 1] * rays.dir.y
             + A[0, 2] * rays.dir.z,
             A[1, 0] * rays.dir.x + A[1, 1] * rays.dir.y
             + A[1, 2] * rays.dir.z,
             A[2, 0] * rays.dir.x + A[2, 1] * rays.dir.y
             + A[2, 2] * rays.dir.z)
    return Rays(o, d, rays.tmin, rays.tmax)


def _slab_hits(rays: Rays, bmin, bmax, tmax):
    """World-space AABB test (the TLAS leaf test)."""
    inv = lambda d: jnp.where(jnp.abs(d) > 1e-12, 1.0 / d,
                              jnp.where(d >= 0, 1e12, -1e12))
    ts = []
    for org, dr, lo, hi in ((rays.org.x, rays.dir.x, bmin[0], bmax[0]),
                            (rays.org.y, rays.dir.y, bmin[1], bmax[1]),
                            (rays.org.z, rays.dir.z, bmin[2], bmax[2])):
        i = inv(dr)
        t0, t1 = (lo - org) * i, (hi - org) * i
        ts.append((jnp.minimum(t0, t1), jnp.maximum(t0, t1)))
    tn = jnp.maximum(jnp.maximum(ts[0][0], ts[1][0]),
                     jnp.maximum(ts[2][0], rays.tmin))
    tf = jnp.minimum(jnp.minimum(ts[0][1], ts[1][1]),
                     jnp.minimum(ts[2][1], tmax))
    return tn <= tf


def intersect_instanced(rays: Rays, geo: InstancedGeo, prim_base: int,
                        any_hit: bool = False):
    """Closest hit (or occlusion) over all instances.

    Returns Hit with prim encoded as prim_base + inst * T + local_prim
    (miss = -1), or a bool occlusion mask for any_hit."""
    from . import intersect as isect

    T = geo.tris_per_instance
    n = rays.tmin.shape[0]

    if any_hit:
        def body(occ, xs):
            m, bmin, bmax, svis = xs
            blk = _slab_hits(rays, bmin, bmax, rays.tmax) & svis & ~occ
            # dead-lane the culled rays so the sweep is cheap-ish for them
            lr = _local_rays(rays, m)
            lr = lr._replace(tmax=jnp.where(blk, lr.tmax, -1.0))
            h = isect.intersect_tris_dense(lr, geo.soup, any_hit=True)
            return occ | (h.prim >= 0), None
        occ0 = jnp.zeros((n,), bool)
        occ, _ = jax.lax.scan(
            body, occ0,
            (geo.w2l, geo.aabb_min, geo.aabb_max, geo.shadow_visible))
        return occ

    def body(carry, xs):
        best_t, best_prim, best_u, best_v = carry
        m, bmin, bmax, inst = xs
        blk = _slab_hits(rays, bmin, bmax, jnp.minimum(rays.tmax, best_t))
        lr = _local_rays(rays, m)
        lr = lr._replace(tmax=jnp.where(blk, jnp.minimum(rays.tmax, best_t),
                                        -1.0))
        h = isect.intersect_tris_dense(lr, geo.soup)
        better = (h.prim >= 0) & (h.t < best_t)
        prim = prim_base + inst * T + jnp.clip(h.prim, 0, None)
        return (jnp.where(better, h.t, best_t),
                jnp.where(better, prim, best_prim),
                jnp.where(better, h.u, best_u),
                jnp.where(better, h.v, best_v)), None

    init = (jnp.full((n,), FLT_MAX), jnp.full((n,), -1, jnp.int32),
            jnp.zeros((n,)), jnp.zeros((n,)))
    ids = jnp.arange(geo.n_instances, dtype=jnp.int32)
    (t, prim, u, v), _ = jax.lax.scan(
        body, init, (geo.w2l, geo.aabb_min, geo.aabb_max, ids))
    return Hit(t, prim, u, v)


def instanced_surface(geo: InstancedGeo, prim_local: jnp.ndarray):
    """Gather per-hit local attributes + the instance's normal matrix /
    entity id. prim_local = prim - prim_base (clamped by the caller)."""
    from .gather import gather_cols, take_rows

    T = geo.tris_per_instance
    inst = jnp.clip(prim_local // T, 0, geo.n_instances - 1)
    lp = jnp.clip(prim_local % T, 0, T - 1)
    (e1x, e1y, e1z, e2x, e2y, e2z,
     n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z,
     uv0x, uv0y, uv1x, uv1y, uv2x, uv2y) = gather_cols(lp, [
         geo.soup.e1.x, geo.soup.e1.y, geo.soup.e1.z,
         geo.soup.e2.x, geo.soup.e2.y, geo.soup.e2.z,
         geo.n0.x, geo.n0.y, geo.n0.z, geo.n1.x, geo.n1.y, geo.n1.z,
         geo.n2.x, geo.n2.y, geo.n2.z,
         geo.uv0.x, geo.uv0.y, geo.uv1.x, geo.uv1.y,
         geo.uv2.x, geo.uv2.y])
    nm = geo.nrm_mat[inst]                       # [N, 3, 3]
    ent = take_rows(geo.ent, inst)

    # normals (face + vertex) transform by the normal matrix
    # (l2w)^-T == w2l_lin^T; normalization happens in the caller
    def xform_n(x, y, z):
        return Vec3(nm[:, 0, 0] * x + nm[:, 0, 1] * y + nm[:, 0, 2] * z,
                    nm[:, 1, 0] * x + nm[:, 1, 1] * y + nm[:, 1, 2] * z,
                    nm[:, 2, 0] * x + nm[:, 2, 1] * y + nm[:, 2, 2] * z)

    fn_local = Vec3(e1y * e2z - e1z * e2y,
                    e1z * e2x - e1x * e2z,
                    e1x * e2y - e1y * e2x)
    face_n = xform_n(fn_local.x, fn_local.y, fn_local.z)
    return (face_n,
            xform_n(n0x, n0y, n0z), xform_n(n1x, n1y, n1z),
            xform_n(n2x, n2y, n2z),
            Vec2(uv0x, uv0y), Vec2(uv1x, uv1y), Vec2(uv2x, uv2y),
            ent)
