"""Per-ray stack BVH8 traversal for NVIDIA GPUs (Pallas, Triton route).

The design follows the reference's GPU backend, which walks the BVH per
ray with a private stack inside one kernel (traversal/mapping_gpu.art,
the while-while walk). Each Pallas program owns BLOCK rays (a few
warps); every ray walks the tri-leaf BVH8 of ops/bvh.py (8-wide nodes,
leaves of <= 4 triangles) on its own. Nodes and triangles are gathered
from device memory through L1/L2 — no scene size is routed elsewhere.

Per loop iteration a ray does at most one leaf step (intersect its leaf's
triangles, then pop) and one inner step (slab-test the node's 8
children, descend into the nearest hit child, push the others). Both
steps sit behind block-uniform branches, so a block whose rays are all
in inner nodes skips the triangle code and vice versa. Closest-hit
prunes child boxes with the ray's current best t; any-hit honours the
per-triangle `shadow_visible` mask and retires a ray at its first hit.

Triton has no per-thread scratch memory, so the stacks live in a device
buffer returned as an extra output, laid out [program, depth, lane]: a
block's pushes and pops at equal depth touch one contiguous row.

`trace_bvh` is the entry the renderer calls: it dispatches with
`lax.platform_dependent` (this kernel on CUDA, the XLA lockstep walk of
ops/bvh.py elsewhere) under one fixed-winner custom VJP, so both paths
differentiate in the rays and the triangle soup the same way.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..core.vec import Vec3
from .intersect import FLT_MAX, Hit, Rays, TriSoup, _moeller_trumbore, \
    _mt_terms

BLOCK = 64          # rays per program (two warps: one ray per thread)
NUM_WARPS = 2
STACK_DEPTH = 64    # per-ray stack entries; pushes past it overwrite the top
WIDTH = 8
LEAF_SIZE = 4


def _any(mask):
    """Block-uniform 'any lane set' (Triton reduces over the block)."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _walk_kernel(any_hit: bool, n_tris: int,
                 ox_ref, oy_ref, oz_ref, dx_ref, dy_ref, dz_ref,
                 tmin_ref, tmax_ref,
                 v0x_ref, v0y_ref, v0z_ref, e1x_ref, e1y_ref, e1z_ref,
                 e2x_ref, e2y_ref, e2z_ref, vis_ref,
                 bminx_ref, bminy_ref, bminz_ref,
                 bmaxx_ref, bmaxy_ref, bmaxz_ref, child_ref,
                 t_ref, prim_ref, u_ref, v_ref, stack_ref):
    nb = ox_ref.shape[0]
    org = Vec3(ox_ref[...], oy_ref[...], oz_ref[...])
    d = Vec3(dx_ref[...], dy_ref[...], dz_ref[...])
    tmin = tmin_ref[...]
    tmax = tmax_ref[...]
    inv = lambda a: jnp.where(jnp.abs(a) > 1e-12, 1.0 / a, 1e12)
    idx, idy, idz = inv(d.x), inv(d.y), inv(d.z)
    lane = jax.lax.broadcasted_iota(jnp.int32, (nb,), 0)
    sbase = pl.program_id(0) * (STACK_DEPTH * nb) + lane

    def pop(mask, cur, has, sp):
        can = mask & (sp > 0)
        sp = jnp.where(can, sp - 1, sp)
        top = plgpu.load(stack_ref.at[sbase + sp * nb], mask=can, other=0)
        return jnp.where(can, top, cur), jnp.where(mask, can, has), sp

    def leaf_step(st):
        cur, has, sp, bt, bp, bu, bv = st
        at_leaf = has & (cur < 0)
        lv = -cur - 1
        start, count = lv >> 4, lv & 15
        occ = jnp.zeros((nb,), jnp.bool_)
        for k in range(LEAF_SIZE):
            ok = at_leaf & (k < count)
            ti = jnp.clip(start + k, 0, n_tris - 1)
            ld = lambda r: plgpu.load(r.at[ti], mask=ok, other=0.0)
            tt, uu, vv, good = _moeller_trumbore(
                org, d, Vec3(ld(v0x_ref), ld(v0y_ref), ld(v0z_ref)),
                Vec3(ld(e1x_ref), ld(e1y_ref), ld(e1z_ref)),
                Vec3(ld(e2x_ref), ld(e2y_ref), ld(e2z_ref)))
            hit = ok & good & (tt > tmin) & (tt < bt)
            if any_hit:
                occ = occ | (hit & (ld(vis_ref) > 0.0))
            else:
                bt = jnp.where(hit, tt, bt)
                bp = jnp.where(hit, ti, bp)
                bu = jnp.where(hit, uu, bu)
                bv = jnp.where(hit, vv, bv)
        if any_hit:
            # occlusion is recorded in bp; an occluded ray retires
            bp = jnp.where(occ, 0, bp)
            has = has & ~occ
            at_leaf = at_leaf & ~occ
        cur, has, sp = pop(at_leaf, cur, has, sp)
        return cur, has, sp, bt, bp, bu, bv

    def inner_step(st):
        cur, has, sp, bt, bp, bu, bv = st
        at_inner = has & (cur >= 0)
        base = jnp.maximum(cur, 0) * WIDTH
        near_c = jnp.zeros((nb,), jnp.int32)
        near_t = jnp.full((nb,), FLT_MAX, jnp.float32)
        for j in range(WIDTH):
            ci = base + j
            ld = lambda r: plgpu.load(r.at[ci], mask=at_inner, other=0.0)
            c = plgpu.load(child_ref.at[ci], mask=at_inner, other=0)
            t0x = (ld(bminx_ref) - org.x) * idx
            t1x = (ld(bmaxx_ref) - org.x) * idx
            t0y = (ld(bminy_ref) - org.y) * idy
            t1y = (ld(bmaxy_ref) - org.y) * idy
            t0z = (ld(bminz_ref) - org.z) * idz
            t1z = (ld(bmaxz_ref) - org.z) * idz
            tn = jnp.maximum(jnp.maximum(jnp.minimum(t0x, t1x),
                                         jnp.minimum(t0y, t1y)),
                             jnp.maximum(jnp.minimum(t0z, t1z), tmin))
            tf = jnp.minimum(jnp.minimum(jnp.maximum(t0x, t1x),
                                         jnp.maximum(t0y, t1y)),
                             jnp.minimum(jnp.maximum(t0z, t1z), bt))
            hit = at_inner & (c != 0) & (tn <= tf)
            # keep the nearest hit child in hand, push the rest
            closer = hit & (tn < near_t)
            push = hit & (~closer | (near_c != 0))
            slot = jnp.minimum(sp, STACK_DEPTH - 1)
            plgpu.store(stack_ref.at[sbase + slot * nb],
                        jnp.where(closer, near_c, c), mask=push)
            sp = jnp.minimum(sp + push.astype(jnp.int32), STACK_DEPTH)
            near_c = jnp.where(closer, c, near_c)
            near_t = jnp.where(closer, tn, near_t)
        descend = at_inner & (near_c != 0)
        cur = jnp.where(descend, near_c, cur)
        cur, has, sp = pop(at_inner & ~descend, cur, has, sp)
        return cur, has, sp, bt, bp, bu, bv

    def body(st):
        cur, has = st[0], st[1]
        st = jax.lax.cond(_any(has & (cur < 0)), leaf_step, lambda s: s, st)
        cur, has = st[0], st[1]
        return jax.lax.cond(_any(has & (cur >= 0)), inner_step,
                            lambda s: s, st)

    init = (jnp.zeros((nb,), jnp.int32),           # cur: root
            tmax >= tmin,                          # has: dead lanes idle
            jnp.zeros((nb,), jnp.int32),           # sp
            jnp.minimum(tmax, FLT_MAX),            # best t
            jnp.full((nb,), -1, jnp.int32),        # prim
            jnp.zeros((nb,), jnp.float32), jnp.zeros((nb,), jnp.float32))
    _, _, _, bt, bp, bu, bv = jax.lax.while_loop(
        lambda st: _any(st[1]), body, init)
    hit = bp >= 0
    t_ref[...] = jnp.where(hit, 0.0 if any_hit else bt, FLT_MAX)
    prim_ref[...] = bp
    u_ref[...] = bu
    v_ref[...] = bv


@functools.partial(jax.jit, static_argnames=("any_hit", "interpret"))
def walk_kernel(ox, oy, oz, dx, dy, dz, tmin, tmax,
                v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, vis,
                cmin_x, cmin_y, cmin_z, cmax_x, cmax_y, cmax_z, child,
                any_hit: bool = False, interpret: bool = False):
    """Raw traversal: (t, prim, u, v) with prim = -1 on a miss. For
    any_hit, prim >= 0 marks an occluded ray and t/u/v carry nothing.
    Rays are padded to a multiple of BLOCK with dead lanes."""
    n = ox.shape[0]
    n_pad = -(-n // BLOCK) * BLOCK
    rays = [ox, oy, oz, dx, dy, dz, tmin, tmax]
    if n_pad != n:
        rays = [jnp.pad(a, (0, n_pad - n)) for a in rays[:7]] \
            + [jnp.pad(tmax, (0, n_pad - n), constant_values=-1.0)]
    grid = n_pad // BLOCK
    flat = lambda a: a.reshape(-1)
    scene = [v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z,
             vis.astype(jnp.float32),
             flat(cmin_x), flat(cmin_y), flat(cmin_z),
             flat(cmax_x), flat(cmax_y), flat(cmax_z),
             flat(child).astype(jnp.int32)]
    lane_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))
    stack_len = grid * STACK_DEPTH * BLOCK
    out_lane = lambda dt: jax.ShapeDtypeStruct((n_pad,), dt)
    t, prim, u, v, _ = pl.pallas_call(
        functools.partial(_walk_kernel, any_hit, v0x.shape[0]),
        grid=(grid,),
        in_specs=[lane_spec] * 8 + [whole(a) for a in scene],
        out_specs=[lane_spec] * 4 + [pl.BlockSpec((stack_len,),
                                                  lambda i: (0,))],
        out_shape=[out_lane(jnp.float32), out_lane(jnp.int32),
                   out_lane(jnp.float32), out_lane(jnp.float32),
                   jax.ShapeDtypeStruct((stack_len,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="bvh8_walk",
    )(*rays, *scene)
    return t[:n], prim[:n], u[:n], v[:n]


def _ray_args(rays: Rays):
    return (rays.org.x, rays.org.y, rays.org.z,
            rays.dir.x, rays.dir.y, rays.dir.z, rays.tmin, rays.tmax)


def _soup_args(soup: TriSoup):
    return (soup.v0.x, soup.v0.y, soup.v0.z, soup.e1.x, soup.e1.y,
            soup.e1.z, soup.e2.x, soup.e2.y, soup.e2.z)


def _xla_walk(*args, any_hit: bool):
    """ops/bvh.intersect_bvh over the flat kernel argument list."""
    from .bvh import BVHArrays, intersect_bvh
    ray, tri, vis, bvh = args[:8], args[8:17], args[17], args[18:]
    rays = Rays(Vec3(*ray[:3]), Vec3(*ray[3:6]), ray[6], ray[7])
    soup = TriSoup(Vec3(*tri[:3]), Vec3(*tri[3:6]), Vec3(*tri[6:9]))
    if any_hit:
        occ = intersect_bvh(rays, soup, BVHArrays(*bvh), any_hit=True,
                            shadow_visible=vis > 0)
        z = jnp.zeros(occ.shape, jnp.float32)
        return (jnp.where(occ, 0.0, FLT_MAX), jnp.where(occ, 0, -1)
                .astype(jnp.int32), z, z)
    return tuple(intersect_bvh(rays, soup, BVHArrays(*bvh)))


def _dispatch(args, any_hit: bool, kernel: str):
    """kernel: "auto" picks the Triton walk on CUDA and the XLA walk
    elsewhere; "interpret" runs the Triton walk in the Pallas
    interpreter (tests); "xla" forces the XLA walk."""
    gpu = functools.partial(walk_kernel, any_hit=any_hit)
    xla = functools.partial(_xla_walk, any_hit=any_hit)
    if kernel == "interpret":
        return walk_kernel(*args, any_hit=any_hit, interpret=True)
    if kernel == "xla":
        return xla(*args)
    return jax.lax.platform_dependent(*args, cuda=gpu, default=xla)


# --- fixed-winner VJP --------------------------------------------------------
# Traversal picks a winner (prim) per ray; the gradient replays
# Moller-Trumbore on that one triangle (_mt_terms) with the winner held
# fixed. Box bounds, the visibility mask and the tree are layout data.

@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _closest(kernel, *args):
    return _dispatch(args, False, kernel)


def _closest_fwd(kernel, *args):
    out = _dispatch(args, False, kernel)
    return out, (args, out[1])


def _closest_bwd(kernel, res, cts):
    args, prim = res
    ray, tri = args[:6], args[8:17]
    gt, _, gu, gv = cts
    hit = prim >= 0
    p = jnp.clip(prim, 0, tri[0].shape[0] - 1)

    def replay(*xs):
        r, s = xs[:6], [a[p] for a in xs[6:]]
        t, u, v, _ = _mt_terms(*r, *s)
        m = hit.astype(t.dtype)
        return t * m, u * m, v * m

    _, vjp = jax.vjp(replay, *ray, *tri)
    zero = lambda c: jnp.where(hit, c, 0.0)
    grads = vjp((zero(gt), zero(gu), zero(gv)))

    def none_like(a):
        if jnp.issubdtype(a.dtype, jnp.integer) or a.dtype == jnp.bool_:
            import numpy as np
            return np.zeros(a.shape, jax.dtypes.float0)
        return jnp.zeros_like(a)
    rest = tuple(none_like(a) for a in args[17:])
    tminmax = (jnp.zeros_like(args[6]), jnp.zeros_like(args[7]))
    return grads[:6] + tminmax + grads[6:] + rest


_closest.defvjp(_closest_fwd, _closest_bwd)


def trace_bvh(rays: Rays, soup: TriSoup, bvh, any_hit: bool = False,
              shadow_visible=None, kernel: str = "auto"):
    """Closest hit (Hit, differentiable in rays and soup) or any-hit
    occlusion mask over a tri-leaf BVH8 (ops/bvh.BVHArrays)."""
    vis = (jnp.ones(soup.v0.x.shape, jnp.float32) if shadow_visible is None
           else shadow_visible.astype(jnp.float32))
    args = _ray_args(rays) + _soup_args(soup) + (vis,) + tuple(bvh)
    if any_hit:
        args = tuple(jax.lax.stop_gradient(a) for a in args)
        return _dispatch(args, True, kernel)[1] >= 0
    return Hit(*_closest(kernel, *args))
