"""Batched BVH8 traversal in plain JAX (the portable reference walk).

Lockstep version of the reference's per-ray stack traversal
(/root/reference/src/artic/traversal/mapping_cpu.art, stack.art): the whole
ray wavefront advances together; each step every live lane pops a node,
slab-tests its 8 children (gathered SoA bounds), pushes inner hits and
intersects leaf triangle ranges with a static unrolled loop. Lane stacks
live in one [N, STACK] array with scatter/gather updates. Traversal ends
when every lane's stack is empty; tmax pruning keeps step counts near the
per-ray optimum. On CUDA the renderer runs the per-ray kernel of
ops/bvh_gpu.py instead; this walk is its reference and the CPU path.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.vec import Vec3
from .intersect import FLT_MAX, Hit, Rays, TriSoup, _moeller_trumbore

STACK = 48
WIDTH = 8
LEAF_SIZE = 4


class BVHArrays(NamedTuple):
    """Device-side BVH8 (see bvh/builder.py for the layout)."""
    cmin_x: jnp.ndarray
    cmin_y: jnp.ndarray
    cmin_z: jnp.ndarray
    cmax_x: jnp.ndarray
    cmax_y: jnp.ndarray
    cmax_z: jnp.ndarray
    child: jnp.ndarray


def intersect_bvh(rays: Rays, soup: TriSoup, bvh: BVHArrays,
                  any_hit: bool = False,
                  shadow_visible=None):
    """Closest-hit (or any-hit boolean) traversal. Returns Hit (closest) or
    bool occlusion mask (any_hit)."""
    n = rays.tmin.shape[0]
    inv_dx = jnp.where(jnp.abs(rays.dir.x) > 1e-12, 1.0 / rays.dir.x, 1e12)
    inv_dy = jnp.where(jnp.abs(rays.dir.y) > 1e-12, 1.0 / rays.dir.y, 1e12)
    inv_dz = jnp.where(jnp.abs(rays.dir.z) > 1e-12, 1.0 / rays.dir.z, 1e12)

    lane = jnp.arange(n)

    class St(NamedTuple):
        stack: jnp.ndarray   # [N, STACK] i32 node refs
        sp: jnp.ndarray      # [N] stack pointer
        t: jnp.ndarray
        prim: jnp.ndarray
        u: jnp.ndarray
        v: jnp.ndarray
        occ: jnp.ndarray

    stack0 = jnp.zeros((n, STACK), jnp.int32)
    # push root (node 0 encoded as itself; sentinel: sp==0 empty, root pushed)
    stack0 = stack0.at[:, 0].set(0)
    init = St(stack=stack0, sp=jnp.ones(n, jnp.int32),
              t=jnp.minimum(rays.tmax, FLT_MAX), prim=jnp.full(n, -1, jnp.int32),
              u=jnp.zeros(n), v=jnp.zeros(n),
              occ=jnp.zeros(n, bool))

    def cond(st: St):
        live = (st.sp > 0) & (~st.occ if any_hit else jnp.ones(n, bool))
        return jnp.any(live)

    def body(st: St):
        live = (st.sp > 0) & (~st.occ if any_hit else jnp.ones(n, bool))
        sp1 = jnp.maximum(st.sp - 1, 0)
        node = st.stack[lane, sp1]           # popped ref (inner id or leaf)
        sp = jnp.where(live, sp1, st.sp)

        is_leaf = node < 0
        inner = jnp.clip(node, 0, None)

        # ---- inner: slab-test 8 children -----------------------------
        g = lambda a: a[inner]               # [N, 8]
        t0x = (g(bvh.cmin_x) - rays.org.x[:, None]) * inv_dx[:, None]
        t1x = (g(bvh.cmax_x) - rays.org.x[:, None]) * inv_dx[:, None]
        t0y = (g(bvh.cmin_y) - rays.org.y[:, None]) * inv_dy[:, None]
        t1y = (g(bvh.cmax_y) - rays.org.y[:, None]) * inv_dy[:, None]
        t0z = (g(bvh.cmin_z) - rays.org.z[:, None]) * inv_dz[:, None]
        t1z = (g(bvh.cmax_z) - rays.org.z[:, None]) * inv_dz[:, None]
        tnear = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                        jnp.minimum(t0y, t1y)),
                            jnp.maximum(jnp.minimum(t0z, t1z),
                                        rays.tmin[:, None]))
        tfar = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                       jnp.maximum(t0y, t1y)),
                           jnp.minimum(jnp.maximum(t0z, t1z),
                                       st.t[:, None]))
        cref = g(bvh.child)
        hit_child = (tnear <= tfar) & (cref != 0) & live[:, None] \
            & (~is_leaf)[:, None]

        # push hit children (static unroll over 8 slots)
        stack = st.stack
        for j in range(WIDTH):
            m = hit_child[:, j]
            slot = jnp.minimum(sp, STACK - 1)
            stack = stack.at[lane, slot].set(
                jnp.where(m, cref[:, j], stack[lane, slot]))
            sp = sp + m.astype(jnp.int32)

        # ---- leaf: intersect up to LEAF_SIZE triangles ----------------
        lv = -(node) - 1
        start = lv >> 4
        count = lv & 15
        t_best, prim, u, v, occ = st.t, st.prim, st.u, st.v, st.occ
        for k in range(LEAF_SIZE):
            ti = jnp.clip(start + k, 0, soup.v0.x.shape[0] - 1)
            va = Vec3(soup.v0.x[ti], soup.v0.y[ti], soup.v0.z[ti])
            ea = Vec3(soup.e1.x[ti], soup.e1.y[ti], soup.e1.z[ti])
            eb = Vec3(soup.e2.x[ti], soup.e2.y[ti], soup.e2.z[ti])
            tt, uu, vv, ok = _moeller_trumbore(rays.org, rays.dir, va, ea, eb)
            ok = ok & (tt > rays.tmin) & (tt < t_best) & is_leaf & live \
                & (k < count)
            if shadow_visible is not None:
                ok = ok & shadow_visible[ti]
            if any_hit:
                occ = occ | ok
            else:
                t_best = jnp.where(ok, tt, t_best)
                prim = jnp.where(ok, ti, prim)
                u = jnp.where(ok, uu, u)
                v = jnp.where(ok, vv, v)

        return St(stack=stack, sp=sp, t=t_best, prim=prim, u=u, v=v, occ=occ)

    final = jax.lax.while_loop(cond, body, init)
    if any_hit:
        return final.occ
    t_out = jnp.where(final.prim >= 0, final.t, FLT_MAX)
    return Hit(t_out, final.prim, final.u, final.v)
