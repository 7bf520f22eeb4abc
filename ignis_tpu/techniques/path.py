"""Unidirectional path tracer with NEE + MIS + Russian roulette.

Wavefront re-design of the reference path tracer
(/root/reference/src/artic/technique/pathtracer.art): instead of
per-material sorted hit-shader launches, one `lax.scan` over bounce depth
advances the whole ray wavefront with masked lanes. Every bounce does one
closest-hit traversal + one shadow (any-hit) traversal; BSDF and light
dispatch are vectorized masked selects (models/bsdf.py, models/light.py).
Differentiable end-to-end (scan + masked math, no data-dependent control
flow).

MIS uses the balance heuristic in the reference's inverse-pdf form:
  hit:  w = 1 / (1 + inv_bsdf_pdf * light_select_pdf * light_pdf_solid)
  nee:  w = 1 / (1 + bsdf_pdf / light_pdf_solid)
Russian roulette is the pbrt-style max-component rule on contrib*eta^2,
clamped to [0.05, 0.95], active after min_depth.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng as rnglib
from ..core.frame import Frame, ensure_valid_reflection, make_frame
from ..core.vec import (Color, Vec2, Vec3, black, color_max_component, cross,
                        cselect, dot, length, normalize, safe_div, saturate,
                        vselect, white)
from ..models import bsdf as bsdflib
from ..models import light as lightlib
from ..models.bsdf import BsdfSample, MatParams
from ..ops import intersect as isect
from ..ops.bvh_gpu import trace_bvh
from ..ops.intersect import FLT_MAX, Hit, Rays
from ..scenedata import RenderSettings, SceneData

OFFSET = 1e-3  # python float: jnp module constants become captured buffers


class Surface(NamedTuple):
    point: Vec3
    face_n: Vec3     # oriented towards the ray
    ns: Vec3         # shading normal, oriented towards the ray
    uv: Vec2
    is_entering: jnp.ndarray
    ent: jnp.ndarray
    # UV-aligned tangent/bitangent (dP/du, dP/dv per face), zero when the
    # parameterization is degenerate -> Duff-ONB fallback. Tangent-space
    # normal/bump maps are authored against the UV tangents (mikktspace);
    # a normal-only ONB tilts bevel normals in a wrong azimuth.
    tu: Vec3 = None
    tv: Vec3 = None


def trace_scene(scene: SceneData, rays: Rays) -> Hit:
    if scene.bvh is not None:
        # per-ray walk kernel on CUDA, XLA lockstep walk elsewhere
        # (lax.platform_dependent inside trace_bvh)
        h = trace_bvh(rays, scene.tris, scene.bvh)
    else:
        h = isect.intersect_tris_dense(rays, scene.tris)
    hs = isect.intersect_spheres_dense(rays, scene.spheres,
                                       scene.tris.v0.x.shape[0])
    h = isect.merge_hits(h, hs)
    if scene.instances is not None:
        from ..ops.instanced import intersect_instanced
        base = scene.tris.v0.x.shape[0] + scene.spheres.radius.shape[0]
        for g in scene.instances:
            hi = intersect_instanced(rays, g, base)
            h = isect.merge_hits(h, hi)
            base += g.n_instances * g.tris_per_instance
    return h


def occluded_scene(scene: SceneData, rays: Rays) -> jnp.ndarray:
    if scene.bvh is not None:
        occ = trace_bvh(rays, scene.tris, scene.bvh, any_hit=True,
                        shadow_visible=scene.tri_attr.shadow_visible)
    else:
        occ = isect.occluded_tris_dense(rays, scene.tris,
                                        scene.tri_attr.shadow_visible)
    if scene.spheres.radius.shape[0] > 0:
        h = isect.intersect_spheres_dense(rays, scene.spheres, 0)
        svis = scene.sph_attr.shadow_visible[jnp.clip(h.prim, 0, None)]
        occ = occ | ((h.prim >= 0) & svis)
    if scene.instances is not None:
        from ..ops.instanced import intersect_instanced
        for g in scene.instances:
            occ = occ | intersect_instanced(rays, g, 0, any_hit=True)
    return occ


def shadow_transmittance(scene: SceneData, settings, rays: Rays,
                         init_medium=None, max_crossings: int = 4):
    """Radiance/Cycles-style transparent shadow rays (exceeds the
    reference, whose path technique uses binary occlusion —
    PathTechnique.cpp:26 enables Advanced shadows only for MIS AOVs).

    Walks up to `max_crossings` closest hits along the shadow segment;
    STRAIGHT-THROUGH delta transmitters (passthrough, thin smooth
    dielectric, BRTDfunc/Roos specular transmission) multiply their
    deterministic tint into the carried throughput, any other surface
    blocks. Homogeneous-medium attenuation between crossings is tracked
    via the crossed entity's inner/outer medium ids (Mitsuba-volpath-
    style NEE transmittance). Textured tints fall back to the table
    constant (shadow rays carry no texture context).

    Returns a Color transmittance (0 where fully occluded). The MIS
    pairing stays consistent because straight-through delta bounces
    PRESERVE the path's inv_pdf (direction measure unchanged) — see the
    bounce handler."""
    from ..models import medium as medlib
    from ..models.bsdf import BsdfKind, DELTA_ALPHA
    from ..core import fresnel as fr
    from ..ops.gather import take_rows

    n = rays.tmin.shape[0]
    one = jnp.ones(n)
    tint = Color(one, one, one)
    alive = rays.tmax > rays.tmin
    med_id = (jnp.full(n, -1, jnp.int32) if init_medium is None
              else init_medium)
    org, d = rays.org, rays.dir
    # area-light shadow rays are parameterized over an UNNORMALIZED
    # direction (t in [0,1]); medium path lengths need |d|
    dlen = length(d)
    t_cur = rays.tmin
    t_end = rays.tmax

    for _ in range(max_crossings):
        seg = Rays(org, d, t_cur + 0.0, jnp.where(alive, t_end, -1.0))
        hit = trace_scene(scene, seg)
        found = hit.t < FLT_MAX
        surf = compute_surface(scene, seg, hit)
        mid = take_rows(scene.entities.mat, jnp.clip(surf.ent, 0, None))
        m = scene.materials
        g = lambda a: take_rows(a, mid)
        gc = lambda c: Color(take_rows(c.r, mid), take_rows(c.g, mid),
                             take_rows(c.b, mid))
        kind = g(m.kind)
        base, extra = gc(m.base), gc(m.extra)
        # medium attenuation over [t_cur, t_hit] under the current medium
        seg_len = (jnp.where(found, hit.t, 0.0)
                   - jnp.where(found, t_cur, 0.0)) * dlen
        med = medlib.gather_medium(scene.media, med_id)
        tr = medlib.transmittance(med, jnp.maximum(seg_len, 0.0))
        # through-tint per crossed material kind
        cos_h = jnp.abs(dot(normalize(d), surf.face_n))
        k_ratio = g(m.p0) / jnp.maximum(g(m.p1), 1e-6)
        f_th = fr.fresnel_dielectric(k_ratio, cos_h).factor
        f_th = f_th + (1.0 - f_th) * f_th / (f_th + 1.0)
        thin_ok = (g(m.p3) > 0.5) & (g(m.p2) <= DELTA_ALPHA)
        t_pass = base                         # tinted passthrough
        t_thin = extra * (1.0 - f_th)         # thin glass: kt*(1-F_thin)
        through = Color(jnp.zeros(n), jnp.zeros(n), jnp.zeros(n))
        through = cselect(kind == BsdfKind.PASSTHROUGH, t_pass, through)
        through = cselect((kind == BsdfKind.DIELECTRIC) & thin_ok, t_thin,
                          through)
        if settings.bsdf_kinds is None or \
                int(BsdfKind.RAD_BRTDF) in settings.bsdf_kinds:
            # BRTDfunc: specular transmission color is stored in `extra`
            through = cselect(kind == BsdfKind.RAD_BRTDF, extra, through)
        if settings.bsdf_kinds is None or \
                int(BsdfKind.RAD_ROOS) in settings.bsdf_kinds:
            # Roos: `base` holds (trns_w, trns_p, trns_q) MODEL PARAMS —
            # compute the angular tau (rad.art make_rad_roos_bsdf), not a
            # color read (that tinted three-planes-roos wrong, round 5)
            tw, tp, tq = base.r, base.g, jnp.maximum(base.b, 1e-4)
            z = jnp.arccos(jnp.clip(cos_h, 0.0, 1.0 - 1e-7)) * 0.636619772368
            a_c = 8.0
            alpha_t = 5.2 + 0.7 * tq
            gamma_t = (5.26 + 0.06 * tp) + (0.73 + 0.04 * tp) * tq
            b_t = 0.25 / tq
            c_t = 1.0 - a_c - b_t
            tau = tw * (1.0 - a_c * jnp.power(z, alpha_t) - b_t * z * z
                        - c_t * jnp.power(z, gamma_t))
            tau = jnp.clip(tau, 0.0, 1.0)
            through = cselect(kind == BsdfKind.RAD_ROOS,
                              Color(tau, tau, tau), through)
        crossed = alive & found
        tint = cselect(crossed, tint.cmul(tr).cmul(through),
                       cselect(alive, tint.cmul(tr), tint))
        # update the tracked medium across the interface
        entering = surf.is_entering
        new_med = jnp.where(entering,
                            take_rows(scene.entities.med_inner,
                                      jnp.clip(surf.ent, 0, None)),
                            take_rows(scene.entities.med_outer,
                                      jnp.clip(surf.ent, 0, None)))
        med_id = jnp.where(crossed, new_med, med_id)
        t_cur = jnp.where(crossed, hit.t + OFFSET, t_end)
        alive = crossed & (color_max_component(tint) > 0.0) \
            & (t_cur < t_end)
        # lanes whose crossing is opaque: tint zeroed via `through`
    # lanes still alive after max_crossings: attenuate the remaining
    # segment under the last medium and block if anything else is there
    # (no silent light leak past the crossing budget)
    med = medlib.gather_medium(scene.media, med_id)
    rest = jnp.maximum(t_end - t_cur, 0.0) * dlen
    rest = jnp.where(jnp.isfinite(rest), rest, 0.0)
    tint = tint.cmul(medlib.transmittance(med, rest))
    residual = alive
    if True:
        fin = Rays(org, d, t_cur, jnp.where(residual, t_end, -1.0))
        blocked = occluded_scene(scene, fin)
        z = jnp.zeros(n)
        tint = cselect(residual & blocked, Color(z, z, z), tint)
    return tint


def compute_surface(scene: SceneData, rays: Rays, hit: Hit) -> Surface:
    n_tri = scene.tris.v0.x.shape[0]
    prim = jnp.clip(hit.prim, 0, None)
    is_tri = prim < n_tri
    tp = jnp.clip(prim, 0, n_tri - 1)

    g3 = lambda v, i: Vec3(v.x[i], v.y[i], v.z[i])
    g2 = lambda v, i: Vec2(v.x[i], v.y[i])

    # One fused attribute fetch for all per-triangle columns (the hit
    # shader's vertex attribute load, mapping_cpu.art:467): one [T, 22]
    # row gather instead of 22 column gathers.
    from ..ops.gather import gather_cols
    ta = scene.tri_attr
    (e1x, e1y, e1z, e2x, e2y, e2z,
     n0x, n0y, n0z, n1x, n1y, n1z, n2x, n2y, n2z,
     uv0x, uv0y, uv1x, uv1y, uv2x, uv2y, entf) = gather_cols(tp, [
         scene.tris.e1.x, scene.tris.e1.y, scene.tris.e1.z,
         scene.tris.e2.x, scene.tris.e2.y, scene.tris.e2.z,
         ta.n0.x, ta.n0.y, ta.n0.z, ta.n1.x, ta.n1.y, ta.n1.z,
         ta.n2.x, ta.n2.y, ta.n2.z,
         ta.uv0.x, ta.uv0.y, ta.uv1.x, ta.uv1.y, ta.uv2.x, ta.uv2.y,
         ta.ent.astype(jnp.float32)])
    e1 = Vec3(e1x, e1y, e1z)
    e2 = Vec3(e2x, e2y, e2z)
    fn = cross(e1, e2)
    fnl = length(fn)
    face_n = fn * safe_div(1.0, fnl)

    u, v = hit.u, hit.v
    w = 1.0 - u - v
    n0 = Vec3(n0x, n0y, n0z)
    n1 = Vec3(n1x, n1y, n1z)
    n2 = Vec3(n2x, n2y, n2z)
    ns = normalize(Vec3(n0.x * w + n1.x * u + n2.x * v,
                        n0.y * w + n1.y * u + n2.y * v,
                        n0.z * w + n1.z * u + n2.z * v))
    uv0 = Vec2(uv0x, uv0y)
    uv1 = Vec2(uv1x, uv1y)
    uv2 = Vec2(uv2x, uv2y)
    uv = Vec2(uv0.x * w + uv1.x * u + uv2.x * v,
              uv0.y * w + uv1.y * u + uv2.y * v)
    ent = jnp.round(entf).astype(jnp.int32) \
        if entf.dtype != jnp.int32 else entf

    # Per-face UV tangents dP/du, dP/dv solved from the edge/uv deltas
    # (the mikktspace-style basis tangent-space maps are authored in);
    # zeroed (-> ONB fallback) when the uv parameterization degenerates
    du1 = uv1.x - uv0.x
    dv1 = uv1.y - uv0.y
    du2 = uv2.x - uv0.x
    dv2 = uv2.y - uv0.y
    det_uv = du1 * dv2 - dv1 * du2
    inv_det = jnp.where(jnp.abs(det_uv) > 1e-12, 1.0 / det_uv, 0.0)
    tu = Vec3((e1.x * dv2 - e2.x * dv1) * inv_det,
              (e1.y * dv2 - e2.y * dv1) * inv_det,
              (e1.z * dv2 - e2.z * dv1) * inv_det)
    tv = Vec3((e2.x * du1 - e1.x * du2) * inv_det,
              (e2.y * du1 - e1.y * du2) * inv_det,
              (e2.z * du1 - e1.z * du2) * inv_det)

    # Miss lanes carry t = FLT_MAX; clamp so downstream math (and its
    # reverse-mode) stays finite — the lanes are masked out anyway.
    t_safe = jnp.where(hit.prim >= 0, hit.t, 1.0)
    point = rays.org + rays.dir * t_safe

    # Spheres: normal from center, uv spherical
    n_sph = scene.spheres.radius.shape[0]
    if n_sph > 0:
        sp = jnp.clip(prim - n_tri, 0, n_sph - 1)
        sc = g3(scene.spheres.center, sp)
        sn = normalize(point - sc)
        from ..core.warp import spherical_from_dir, PI, TWO_PI
        theta, phi = spherical_from_dir(sn)
        suv = Vec2(phi / TWO_PI, theta / PI)
        face_n = vselect(is_tri, face_n, sn)
        ns = vselect(is_tri, ns, sn)
        uv = Vec2(jnp.where(is_tri, uv.x, suv.x), jnp.where(is_tri, uv.y, suv.y))
        ent = jnp.where(is_tri, ent, scene.sph_attr.ent[sp])
        zero = Vec3(jnp.zeros_like(uv.x), jnp.zeros_like(uv.x),
                    jnp.zeros_like(uv.x))
        tu = vselect(is_tri, tu, zero)
        tv = vselect(is_tri, tv, zero)

    # Instanced region: prim >= n_tri + n_sph (two-level accel,
    # ops/instanced.py); attributes come from each group's shared local
    # mesh with the instance's normal matrix applied.
    if scene.instances is not None:
        from ..ops.instanced import instanced_surface
        base = n_tri + n_sph
        for g in scene.instances:
            size = g.n_instances * g.tris_per_instance
            in_g = (prim >= base) & (prim < base + size)
            ip = jnp.clip(prim - base, 0, size - 1)
            (ifn, in0, in1, in2, iuv0, iuv1, iuv2, ient) = \
                instanced_surface(g, ip)
            ifn = normalize(ifn)
            ins = normalize(Vec3(in0.x * w + in1.x * u + in2.x * v,
                                 in0.y * w + in1.y * u + in2.y * v,
                                 in0.z * w + in1.z * u + in2.z * v))
            iuv = Vec2(iuv0.x * w + iuv1.x * u + iuv2.x * v,
                       iuv0.y * w + iuv1.y * u + iuv2.y * v)
            keep = ~in_g
            face_n = vselect(keep, face_n, ifn)
            ns = vselect(keep, ns, ins)
            uv = Vec2(jnp.where(keep, uv.x, iuv.x),
                      jnp.where(keep, uv.y, iuv.y))
            ent = jnp.where(keep, ent, ient)
            zero = Vec3(jnp.zeros_like(uv.x), jnp.zeros_like(uv.x),
                        jnp.zeros_like(uv.x))
            tu = vselect(keep, tu, zero)
            tv = vselect(keep, tv, zero)
            base += size

    is_entering = dot(rays.dir, face_n) <= 0.0
    flip = jnp.where(is_entering, 1.0, -1.0)
    face_n = face_n * flip
    ns = ns * flip
    return Surface(point, face_n, ns, uv, is_entering, ent, tu, tv)


def shading_frame(surf: Surface) -> Frame:
    """Shading-normal frame with UV-aligned tangents when the surface
    provides them (tangent-space maps are authored against dP/du), ONB
    fallback otherwise. Bitangent handedness follows the uv winding."""
    fr = make_frame(surf.ns)
    if surf.tu is None:
        return fr
    ns = surf.ns
    proj = dot(ns, surf.tu)
    t = Vec3(surf.tu.x - ns.x * proj, surf.tu.y - ns.y * proj,
             surf.tu.z - ns.z * proj)
    tl2 = dot(t, t)
    ok = tl2 > 1e-16
    inv = 1.0 / jnp.sqrt(jnp.maximum(tl2, 1e-30))
    t = Vec3(t.x * inv, t.y * inv, t.z * inv)
    b0 = cross(ns, t)
    sgn = jnp.where(dot(b0, surf.tv) < 0.0, -1.0, 1.0)
    b = Vec3(b0.x * sgn, b0.y * sgn, b0.z * sgn)
    return Frame(vselect(ok, t, fr.t), vselect(ok, b, fr.b), ns)


def make_surface_ctx(scene: SceneData, rays: Rays, surf: Surface,
                     eval_texture):
    """PExpr shading context at a surface hit (Transpiler variable set)."""
    from ..models.texture import make_shade_ctx
    fr = shading_frame(surf)
    return make_shade_ctx(
        surf.uv,
        point=(surf.point.x, surf.point.y, surf.point.z),
        normal=(surf.ns.x, surf.ns.y, surf.ns.z),
        face_normal=(surf.face_n.x, surf.face_n.y, surf.face_n.z),
        tangent=(fr.t.x, fr.t.y, fr.t.z),
        bitangent=(fr.b.x, fr.b.y, fr.b.z),
        ray_dir=(-rays.dir.x, -rays.dir.y, -rays.dir.z),
        ray_org=(rays.org.x, rays.org.y, rays.org.z),
        entity_id=surf.ent,
        frontside=surf.is_entering,
        scene_center=(scene.scene_center.x, scene.scene_center.y,
                      scene.scene_center.z),
        scene_radius=scene.scene_radius,
        registry=scene.registry,
        dpdu=((surf.tu.x, surf.tu.y, surf.tu.z)
              if surf.tu is not None else None),
        dpdv=((surf.tv.x, surf.tv.y, surf.tv.z)
              if surf.tv is not None else None))


def gather_material(scene: SceneData, surf: Surface, eval_texture=None,
                    ctx=None) -> MatParams:
    from ..ops.gather import take_rows
    m = scene.materials
    mid = take_rows(scene.entities.mat, jnp.clip(surf.ent, 0, None))
    g = lambda a: take_rows(a, mid)
    gc = lambda c: Color(take_rows(c.r, mid), take_rows(c.g, mid),
                         take_rows(c.b, mid))
    mat = MatParams(kind=g(m.kind), base=gc(m.base), extra=gc(m.extra),
                    extra2=gc(m.extra2), p0=g(m.p0), p1=g(m.p1), p2=g(m.p2),
                    p3=g(m.p3), q0=g(m.q0), q1=g(m.q1), q2=g(m.q2),
                    q3=g(m.q3), q4=g(m.q4), q5=g(m.q5), q6=g(m.q6),
                    q7=g(m.q7), q8=g(m.q8))
    if eval_texture is not None:
        lookup_ctx = ctx if ctx is not None else surf.uv
        base_tex = take_rows(m.base_tex, mid)
        tex_col = eval_texture(base_tex, lookup_ctx)
        mat = mat._replace(base=cselect(base_tex >= 0, tex_col, mat.base))
        extra_tex = take_rows(m.extra_tex, mid)
        tex_col2 = eval_texture(extra_tex, lookup_ctx)
        mat = mat._replace(extra=cselect(extra_tex >= 0, tex_col2, mat.extra))
    return mat


def apply_normal_map(scene: SceneData, settings: RenderSettings,
                     surf: Surface, sctx, eval_texture, mid) -> Surface:
    """Perturb the shading normal for normal/bump-mapped materials
    (reference bsdf/map.art make_normalmap/make_bumpmap). No-op unless the
    scene contains mapped BSDFs (settings.has_bump, statically pruned)."""
    if not settings.has_bump or eval_texture is None:
        return surf
    from ..ops.gather import take_rows
    bk = take_rows(scene.materials.bump_kind, mid)
    bt = jnp.clip(take_rows(scene.materials.bump_tex, mid), 0, None)
    bs = take_rows(scene.materials.bump_strength, mid)
    fr = shading_frame(surf)
    ctx = sctx if sctx is not None else surf.uv

    # normalmap (map.art:56): tangent-space color -> world, lerp by strength
    c = eval_texture(bt, ctx)
    tx, ty, tz = 2.0 * c.r - 1.0, 2.0 * c.g - 1.0, 2.0 * c.b - 1.0
    oN = normalize(Vec3(fr.t.x * tx + fr.b.x * ty + fr.n.x * tz,
                        fr.t.y * tx + fr.b.y * ty + fr.n.y * tz,
                        fr.t.z * tx + fr.b.z * ty + fr.n.z * tz))
    nN = normalize(Vec3(surf.ns.x + (oN.x - surf.ns.x) * bs,
                        surf.ns.y + (oN.y - surf.ns.y) * bs,
                        surf.ns.z + (oN.z - surf.ns.z) * bs))

    # bumpmap (map.art:64): n - strength*(t*dh/du + b*dh/dv); central
    # differences in uv, scaled to a true derivative like the reference's
    # texture_dx (texture/common.art:28, delta = 0.001, /delta)
    h = 0.001
    if isinstance(ctx, Vec2):
        cpx = Vec2(ctx.x + h, ctx.y)
        cmx = Vec2(ctx.x - h, ctx.y)
        cpy = Vec2(ctx.x, ctx.y + h)
        cmy = Vec2(ctx.x, ctx.y - h)
    else:
        u, v = ctx.uv
        cpx = ctx._replace(uv=(u + h, v))
        cmx = ctx._replace(uv=(u - h, v))
        cpy = ctx._replace(uv=(u, v + h))
        cmy = ctx._replace(uv=(u, v - h))
    dx = (eval_texture(bt, cpx).r - eval_texture(bt, cmx).r) / (2.0 * h)
    dy = (eval_texture(bt, cpy).r - eval_texture(bt, cmy).r) / (2.0 * h)
    bN = normalize(Vec3(surf.ns.x - bs * (fr.t.x * dx + fr.b.x * dy),
                        surf.ns.y - bs * (fr.t.y * dx + fr.b.y * dy),
                        surf.ns.z - bs * (fr.t.z * dx + fr.b.z * dy)))

    # transform BSDF (TransformBSDF.cpp:40-44): the "normal" property is a
    # PExpr vec3 evaluated per shading point (world space), registered as
    # a procedural texture at load (build.py); its rgb IS the new normal
    ec = eval_texture(bt, ctx)
    xN = normalize(Vec3(ec.r, ec.g, ec.b))

    new_ns = vselect(bk == 1, nN,
                     vselect(bk == 2, bN,
                             vselect(bk == 3, xN, surf.ns)))
    # make_normal_set (map.art:36-42): clamp every overridden normal so
    # the view reflection stays above the geometric surface
    if not isinstance(ctx, Vec2):
        view = Vec3(*ctx.ray_dir)  # ShadeCtx.ray_dir is outward (= V)
        new_ns = vselect(bk > 0,
                         ensure_valid_reflection(surf.face_n, view, new_ns),
                         new_ns)
    return surf._replace(ns=new_ns)


class PathState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: jnp.ndarray
    tmax: jnp.ndarray
    rng: jnp.ndarray
    contrib: Color
    inv_pdf: jnp.ndarray
    eta: jnp.ndarray
    alive: jnp.ndarray
    result: Color
    depth: jnp.ndarray   # current path depth (camera segment = 1)
    sample: jnp.ndarray  # per-lane sample counter (regeneration)


def _handle_color(c: Color, settings: RenderSettings) -> Color:
    if settings.clamp > 0:
        return saturate(c, settings.clamp)
    return c


def _cadd_where(m, acc: Color, c: Color) -> Color:
    return Color(acc.r + jnp.where(m, c.r, 0.0),
                 acc.g + jnp.where(m, c.g, 0.0),
                 acc.b + jnp.where(m, c.b, 0.0))


def make_bounce(scene: SceneData, settings: RenderSettings, n,
                eval_texture=None, regen=None, collect_stats=False):
    """Build the per-bounce wavefront step (exposed for debugging/replay).

    With `regen` = (x, y, iteration, frame), dead lanes immediately restart
    the next sample of their pixel — a persistent-lane wavefront (the
    wavefront analog of the reference's in-flight ray regeneration,
    mapping_cpu.art:751). Keeps every lane busy so total iterations track
    mean path length instead of spi * max_depth.

    With `collect_stats`, the step's second return value is a quantity dict
    (the reference's in-kernel stats::add_quantity,
    /root/reference/src/artic/core/stats.art:47 / Statistics.h:57):
    CameraRay/BounceRay/ShadowRay counts for this step, as int32 scalars."""
    n_lights = settings.n_lights
    sel_pdf_const = 1.0 / max(n_lights, 1)

    def bounce(state: PathState, b):
        # Dead lanes get tmax < tmin: the traversal kernels' block-level
        # chunk culling then skips their work entirely (late wavefront
        # iterations are mostly dead lanes).
        rays_b = Rays(state.org, state.dir, state.tmin,
                      jnp.where(state.alive, state.tmax, -1.0))
        hit = trace_scene(scene, rays_b)
        found = hit.prim >= 0
        result = state.result

        # ---- miss: infinite lights (on_miss, pathtracer.art:141) ----------
        miss = state.alive & ~found
        for lid in _infinite_rows(scene, settings):
            lp = lightlib.gather_light(scene.lights,
                                       jnp.full(n, lid, jnp.int32))
            emit = lightlib.env_emission(scene, lp, state.dir, eval_texture)
            pdf_s = lightlib.env_pdf_direct(scene, lp, state.dir)
            lsel_pdf = lightlib.selector_pdf(settings, scene.lights,
                                             jnp.full(n, lid, jnp.int32),
                                             state.org)
            mis = jnp.where(
                lp.delta, 0.0,
                1.0 / (1.0 + state.inv_pdf * lsel_pdf * pdf_s)
            ) if settings.enable_nee else jnp.where(lp.delta, 0.0, 1.0)
            c = _handle_color(state.contrib.cmul(emit) * mis, settings)
            result = _cadd_where(miss & ~lp.delta, result, c)

        # ---- hit shading --------------------------------------------------
        active = state.alive & found
        surf = compute_surface(scene, rays_b, hit)
        sctx = (make_surface_ctx(scene, rays_b, surf, eval_texture)
                if eval_texture is not None else None)
        mat = gather_material(scene, surf, eval_texture, sctx)
        out_dir = -state.dir
        from ..ops.gather import take_rows
        mid = take_rows(scene.entities.mat, jnp.clip(surf.ent, 0, None))
        surf = apply_normal_map(scene, settings, surf, sctx, eval_texture, mid)
        frame = make_frame(surf.ns)
        w_override = None
        if settings.has_blend and eval_texture is not None:
            p0t = take_rows(scene.materials.p0_tex, mid)
            wtex = eval_texture(p0t, sctx if sctx is not None else surf.uv)
            w_override = jnp.where(p0t >= 0, wtex.r, mat.p0)
        shader = bsdflib.make_lane_shader(scene.materials, mid, mat, frame,
                                          surf.is_entering,
                                          settings.has_blend, w_override,
                                          settings.bsdf_kinds,
                                          measured=scene.measured)
        all_delta = shader.is_all_delta()

        # Emission on hit (on_hit, pathtracer.art:120)
        light_row = take_rows(scene.entities.light, jnp.clip(surf.ent, 0, None))
        is_emissive = light_row >= 0
        lp_hit = lightlib.gather_light(scene.lights, jnp.clip(light_row, 0, None))
        cos_l = -dot(state.dir, frame.n)
        emit_ok = active & is_emissive & surf.is_entering & (cos_l > 1e-6)
        # area light: pdf_direct in area measure = 1/total_area
        pdf_area = safe_div(1.0, lp_hit.p0)
        # Sanitize inputs: hit.t is FLT_MAX on miss lanes and cos_l can be
        # <= 0; inf/nan intermediates poison reverse-mode AD even when the
        # contribution is masked out downstream.
        t_safe = jnp.where(emit_ok, hit.t, 1.0)
        cos_safe = jnp.where(emit_ok, cos_l, 1.0)
        pdf_s = pdf_area * t_safe * t_safe / cos_safe
        esel_pdf = lightlib.selector_pdf(settings, scene.lights,
                                         jnp.clip(light_row, 0, None),
                                         state.org)
        mis_e = (1.0 / (1.0 + state.inv_pdf * esel_pdf * pdf_s)
                 if settings.enable_nee else jnp.ones(n))
        c_emit = _handle_color(state.contrib.cmul(lp_hit.intensity) * mis_e,
                               settings)
        result = _cadd_where(emit_ok, result, c_emit)

        rng = state.rng
        depth = state.depth  # camera segment = 1 (reference payload depth)

        # ---- NEE (on_shadow, pathtracer.art:52) ---------------------------
        if settings.enable_nee and n_lights > 0:
            rng, (ul, u0, u1) = rnglib.next_f32_n(rng, 3)
            lsel, sel_pdf = lightlib.select_light(settings, scene.lights,
                                                  ul, surf.point)
            lp = lightlib.gather_light(scene.lights, lsel)
            ls = lightlib.sample_direct(scene, lp, surf.point,
                                        surf.is_entering, u0, u1, eval_texture,
                                        kinds=settings.light_kinds)
            pdf_l_s = lightlib.pdf_as_solid(ls.pdf_value, ls.pdf_is_area,
                                            ls.cos, ls.dist * ls.dist) * sel_pdf
            bsdf_f = shader.eval(ls.dir, out_dir)
            bsdf_p = shader.pdf(ls.dir, out_dir)
            mis = jnp.where(lp.delta, 1.0,
                            1.0 / (1.0 + safe_div(bsdf_p, pdf_l_s)))
            factor = safe_div(ls.pdf_value, pdf_l_s)
            contrib_nee = _handle_color(
                ls.intensity.cmul(state.contrib.cmul(bsdf_f)) * (mis * factor),
                settings)
            want = (active & ~all_delta & (depth + 1 <= settings.max_depth)
                    & (pdf_l_s > 1e-9) & (ls.cos > 1e-6)
                    & (color_max_component(contrib_nee) > 0))
            # Shadow ray: finite lights aim at the sampled point (range [o,1-o])
            sdir_inf = ls.dir
            svec_fin = ls.pos - surf.point
            sdir = vselect(lp.infinite, sdir_inf, svec_fin)
            stmax = jnp.where(lp.infinite, FLT_MAX, 1.0 - OFFSET)
            # Lanes that won't use the shadow result (delta BSDFs, dead,
            # zero contribution) get tmax < tmin so traversal culls them.
            stmax = jnp.where(want, stmax, -1.0)
            shadow_rays = Rays(surf.point, sdir,
                               jnp.broadcast_to(OFFSET, n), stmax)
            if settings.transparent_shadows:
                s_tint = shadow_transmittance(scene, settings, shadow_rays)
                result = _cadd_where(
                    want & (color_max_component(s_tint) > 0.0), result,
                    contrib_nee.cmul(s_tint))
            else:
                occ = occluded_scene(scene, shadow_rays)
                result = _cadd_where(want & ~occ, result, contrib_nee)
            n_shadow = jnp.sum(want.astype(jnp.int32))
        else:
            n_shadow = jnp.int32(0)

        # ---- bounce (on_bounce, pathtracer.art:170) -----------------------
        rng, (b_pick, b0, b1, b2, b_rr) = rnglib.next_f32_n(rng, 5)
        bs = shader.sample(out_dir, b_pick, b0, b1, b2)
        new_contrib = state.contrib.cmul(bs.weight)
        rr_c = color_max_component(new_contrib) * state.eta * state.eta
        rr_prob = jnp.clip(rr_c, 0.05, 0.95)
        rr_prob = jnp.where(depth + 1 > settings.min_depth, rr_prob, 1.0)
        survive = b_rr < rr_prob
        cont = (active & bs.valid & survive & (bs.pdf > 1e-9)
                & (depth + 1 <= settings.max_depth))
        inv_s = 1.0 / rr_prob
        new_contrib = new_contrib * inv_s
        new_inv_pdf = jnp.where(bs.is_delta, 0.0, safe_div(1.0, bs.pdf))
        if settings.transparent_shadows:
            # straight-through delta transmission (passthrough / thin glass
            # / BRTDfunc trans): the direction measure is unchanged, so the
            # path's MIS density composes through the interface — preserve
            # inv_pdf instead of zeroing it. This is what keeps the
            # transparent-shadow NEE estimator and the through-chain
            # light-hit estimator weights summing to 1.
            is_through = bs.is_delta & (dot(bs.in_dir, -out_dir)
                                        > 1.0 - 1e-6)
            new_inv_pdf = jnp.where(is_through, state.inv_pdf, new_inv_pdf)

        new_state = PathState(
            org=surf.point,
            dir=bs.in_dir,
            tmin=jnp.broadcast_to(OFFSET, n),
            tmax=jnp.full(n, FLT_MAX),
            rng=rng,
            contrib=cselect(cont, new_contrib, state.contrib),
            inv_pdf=jnp.where(cont, new_inv_pdf, state.inv_pdf),
            eta=jnp.where(cont, state.eta * bs.eta, state.eta),
            alive=cont,
            result=result,
            depth=state.depth + 1,
            sample=state.sample,
        )

        if regen is not None:
            x, y, iteration, frame = regen
            died = state.alive & ~cont
            has_more = state.sample + 1 < settings.spi
            do_regen = died & has_more
            new_sample = jnp.where(do_regen, state.sample + 1, state.sample)
            fresh = rnglib.seed(new_sample.astype(jnp.uint32),
                                iteration.astype(jnp.uint32),
                                frame.astype(jnp.uint32),
                                x.astype(jnp.uint32), y.astype(jnp.uint32),
                                jnp.uint32(settings.seed))
            from ..core.sampler import sample_pixel_offsets
            sample_idx = iteration.astype(jnp.uint32) \
                * jnp.uint32(settings.spi) + new_sample.astype(jnp.uint32)
            fresh2, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler,
                                                    fresh, sample_idx, x, y)
            from ..models import camera as cameralib
            cam_rays = cameralib.generate_rays(scene.camera, settings, x, y,
                                               rx, ry, rng_state=fresh2)
            new_state = PathState(
                org=vselect(do_regen, cam_rays.org, new_state.org),
                dir=vselect(do_regen, cam_rays.dir, new_state.dir),
                tmin=jnp.where(do_regen, cam_rays.tmin, new_state.tmin),
                tmax=jnp.where(do_regen, cam_rays.tmax, new_state.tmax),
                rng=jnp.where(do_regen, fresh2, new_state.rng),
                contrib=cselect(do_regen, white(n), new_state.contrib),
                inv_pdf=jnp.where(do_regen, 0.0, new_state.inv_pdf),
                eta=jnp.where(do_regen, 1.0, new_state.eta),
                alive=cont | do_regen,
                result=result,
                depth=jnp.where(do_regen, 1, new_state.depth),
                sample=new_sample,
            )
        if not collect_stats:
            return new_state, None
        q = {
            "BounceRay": jnp.sum(state.alive.astype(jnp.int32)),
            "ShadowRay": n_shadow,
            "CameraRay": (jnp.sum(do_regen.astype(jnp.int32))
                          if regen is not None else jnp.int32(0)),
        }
        return new_state, q

    return bounce


def initial_state(rays: Rays, rng_state) -> PathState:
    n = rays.tmin.shape
    return PathState(
        org=rays.org, dir=rays.dir, tmin=rays.tmin, tmax=rays.tmax,
        rng=rng_state,
        contrib=white(n), inv_pdf=jnp.zeros(n), eta=jnp.ones(n),
        alive=jnp.ones(n, bool), result=black(n),
        depth=jnp.ones(n, jnp.int32), sample=jnp.zeros(n, jnp.int32),
    )


def path_trace_progressive(scene: SceneData, settings: RenderSettings,
                           x, y, iteration, frame, eval_texture=None) -> Color:
    """Persistent-lane progressive render: one lane per pixel traces its
    settings.spi samples back-to-back with immediate regeneration. Returns
    per-lane radiance summed over all samples (divide by spi for the mean)."""
    from ..core.sampler import sample_pixel_offsets
    from ..models import camera as cameralib
    n = x.shape
    state0 = rnglib.seed(jnp.uint32(0), iteration.astype(jnp.uint32),
                         frame.astype(jnp.uint32), x.astype(jnp.uint32),
                         y.astype(jnp.uint32), jnp.uint32(settings.seed))
    sample_idx = iteration.astype(jnp.uint32) * jnp.uint32(settings.spi)
    state0, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, state0,
                                            sample_idx, x, y)
    rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                   rng_state=state0)
    init = initial_state(rays, state0)
    bounce = make_bounce(scene, settings, n, eval_texture,
                         regen=(x, y, iteration, frame))
    max_iters = settings.spi * settings.max_depth

    def cond(carry):
        it, st = carry
        return (it < max_iters) & jnp.any(st.alive)

    def body(carry):
        it, st = carry
        st, _ = bounce(st, it)
        return (it + 1, st)

    _, final = jax.lax.while_loop(cond, body, (jnp.int32(0), init))
    return final.result


def path_trace_progressive_stats(scene: SceneData, settings: RenderSettings,
                                 x, y, iteration, frame, eval_texture=None):
    """Instrumented persistent-lane render: returns (Color, quantities).

    Quantities (reference Statistics.h:57 Quantity / stats.art:47
    add_quantity analog): CameraRay/BounceRay/ShadowRay totals, wavefront
    iterations, and lane-occupancy numerator (sum of alive lanes per
    iteration — divide by iterations*lanes for mean occupancy %)."""
    from ..core.sampler import sample_pixel_offsets
    from ..models import camera as cameralib
    n = x.shape
    state0 = rnglib.seed(jnp.uint32(0), iteration.astype(jnp.uint32),
                         frame.astype(jnp.uint32), x.astype(jnp.uint32),
                         y.astype(jnp.uint32), jnp.uint32(settings.seed))
    sample_idx = iteration.astype(jnp.uint32) * jnp.uint32(settings.spi)
    state0, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, state0,
                                            sample_idx, x, y)
    rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                   rng_state=state0)
    init = initial_state(rays, state0)
    bounce = make_bounce(scene, settings, n, eval_texture,
                         regen=(x, y, iteration, frame), collect_stats=True)
    max_iters = settings.spi * settings.max_depth
    q0 = {"BounceRay": jnp.int32(0), "ShadowRay": jnp.int32(0),
          "CameraRay": jnp.int32(x.shape[0]), "Iteration": jnp.int32(0)}

    def cond(carry):
        it, st, _ = carry
        return (it < max_iters) & jnp.any(st.alive)

    def body(carry):
        it, st, q = carry
        st2, dq = bounce(st, it)
        q = {"BounceRay": q["BounceRay"] + dq["BounceRay"],
             "ShadowRay": q["ShadowRay"] + dq["ShadowRay"],
             "CameraRay": q["CameraRay"] + dq["CameraRay"],
             "Iteration": q["Iteration"] + 1}
        return (it + 1, st2, q)

    _, final, q = jax.lax.while_loop(cond, body, (jnp.int32(0), init, q0))
    return final.result, q


# ---------------------------------------------------------------------------
# Compacting wavefront: host-orchestrated rounds over shrinking lane buckets
# ---------------------------------------------------------------------------
#
# The persistent-lane wavefront above keeps lanes busy while samples remain,
# but once a pixel's spi samples are exhausted its lane idles until the LAST
# lane finishes. The reference solves this with stream compaction
# (rv_compact, mapping_cpu.art:205-253; GPU scatter sort,
# mapping_gpu.art:409-503). The analog below: run the while_loop until at
# most 1/SHRINK of the lanes are alive, fold finished lanes' radiance into
# the film with one scatter-add, compact survivors (argsort(alive) keeps
# tile-coherent order) into a 1/SHRINK-size buffer, and continue with a
# cheaper compiled round. Static
# shapes throughout: one executable per (settings, bucket size), bucket
# sizes shrink along a fixed chain so the compile set is O(log n).
# MIN_BUCKET and SHRINK have not been tuned on the GPU.

MIN_BUCKET = 4096
SHRINK = 4   # bucket shrink factor per cascade stage


def _start_state(scene, settings, x, y, iteration, frame):
    from ..core.sampler import sample_pixel_offsets
    from ..models import camera as cameralib
    st0 = rnglib.seed(jnp.uint32(0), iteration.astype(jnp.uint32),
                      frame.astype(jnp.uint32), x.astype(jnp.uint32),
                      y.astype(jnp.uint32), jnp.uint32(settings.seed))
    sample_idx = iteration.astype(jnp.uint32) * jnp.uint32(settings.spi)
    st0, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, st0,
                                         sample_idx, x, y)
    rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                   rng_state=st0)
    return initial_state(rays, st0)


import functools as _functools


def _bucket_chain(n: int):
    """Static cascade of bucket sizes: n, n//SHRINK, ... down to
    MIN_BUCKET."""
    sizes = [n]
    while sizes[-1] // SHRINK >= MIN_BUCKET:
        sizes.append(sizes[-1] // SHRINK)
    return sizes


@_functools.lru_cache(maxsize=32)
def cascade_lane_fn(settings: RenderSettings, n: int):
    """The full compacting render as one traceable function (zero host
    syncs).

    Static structure: a chain of (round, fold, compact) stages with sizes
    n, n/SHRINK, ... Each round's while_loop exits when the alive count
    drops to <= size/SHRINK, which by construction is exactly the next
    stage's capacity — so compaction can never drop a live lane (except
    when the global iteration budget runs out, where dropping the tail is
    the same truncation max_depth already imposes). A stage whose
    precondition is already met (alive small) runs zero iterations and
    costs one reduction."""
    sizes = _bucket_chain(n)
    width = settings.width
    # technique adapter: volpath shares the cascade machinery 1:1
    if settings.technique in ("volpath",):
        from .volpath import make_vol_bounce, vol_initial_state
        make_bounce_fn = make_vol_bounce

        def start_fn(scene, settings, x, y, iteration, frame):
            from ..core.sampler import sample_pixel_offsets
            from ..models import camera as cameralib
            st0 = rnglib.seed(jnp.uint32(0), iteration.astype(jnp.uint32),
                              frame.astype(jnp.uint32), x.astype(jnp.uint32),
                              y.astype(jnp.uint32), jnp.uint32(settings.seed))
            sample_idx = iteration.astype(jnp.uint32) \
                * jnp.uint32(settings.spi)
            st0, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler,
                                                 st0, sample_idx, x, y)
            rays = cameralib.generate_rays(scene.camera, settings, x, y,
                                           rx, ry, rng_state=st0)
            return vol_initial_state(rays, st0)
    else:
        make_bounce_fn = make_bounce
        start_fn = _start_state

    def fn(scene, x, y, iteration, frame):
        from ..models.texture import make_texture_evaluator
        ev = make_texture_evaluator(settings.texture_descs, scene.textures)
        st = start_fn(scene, settings, x, y, iteration, frame)
        film_r = jnp.zeros(n, jnp.float32)
        film_g = jnp.zeros(n, jnp.float32)
        film_b = jnp.zeros(n, jnp.float32)
        budget = jnp.int32(settings.spi * settings.max_depth)
        px, py = x, y
        # fold target: the lane's ORIGINAL index, so the output is in x's
        # lane order regardless of compaction (and the whole body stays
        # valid per-shard under shard_map — each chip compacts its own
        # lanes, no cross-device traffic)
        l0 = jnp.arange(n, dtype=jnp.int32)
        for si, size in enumerate(sizes):
            last = si == len(sizes) - 1
            min_alive = 0 if last else size // SHRINK
            bounce = make_bounce_fn(scene, settings, (size,), ev,
                                    regen=(px, py, iteration, frame))

            def cond(carry, min_alive=min_alive):
                it, s = carry
                na = jnp.sum(s.alive.astype(jnp.int32))
                return (it < budget) & (na > min_alive)

            def body(carry, bounce=bounce):
                it, s = carry
                s2, _ = bounce(s, it)
                return (it + 1, s2)

            it_done, st = jax.lax.while_loop(cond, body, (jnp.int32(0), st))
            budget = budget - it_done

            # fold this stage's radiance into the film, then compact
            film_r = film_r.at[l0].add(st.result.r)
            film_g = film_g.at[l0].add(st.result.g)
            film_b = film_b.at[l0].add(st.result.b)
            if not last:
                st = st._replace(result=black((size,)))
                order = jnp.argsort(~st.alive)[:size // SHRINK]
                st = jax.tree_util.tree_map(lambda a: a[order], st)
                px, py, l0 = px[order], py[order], l0[order]
        return film_r, film_g, film_b
    return fn


@_functools.lru_cache(maxsize=32)
def _compiled_cascade(settings: RenderSettings, n: int):
    return jax.jit(cascade_lane_fn(settings, n))


def path_trace_rounds(scene: SceneData, settings: RenderSettings, x, y,
                      iteration, frame) -> Color:
    """Compacting progressive render. Returns per-lane radiance summed
    over all spi samples, in x's lane order."""
    n = int(x.shape[0])
    film_r, film_g, film_b = _compiled_cascade(settings, n)(
        scene, x, y, iteration, frame)
    return Color(film_r, film_g, film_b)


DIFF_CHUNK = 8  # checkpoint granularity of the differentiable cascade


def path_trace_cascade_diff(scene: SceneData, settings: RenderSettings,
                            x, y, iteration, frame, eval_texture=None) -> Color:
    """Differentiable compacting cascade (the gradient-path analog of
    `_compiled_cascade`).

    Reverse-mode AD cannot differentiate `lax.while_loop`, so each cascade
    stage becomes a fixed-length `lax.scan` whose iteration body is wrapped
    in `lax.cond`: once the stage's exit condition holds (alive count at or
    below the next bucket's capacity, or the global spi*max_depth budget
    spent) the remaining scan steps take the identity branch and cost ~one
    reduction each — a reverse-mode-safe early exit. Compaction (stable
    argsort gather) and the film fold (scatter-add by original lane id)
    are both differentiable, so parameter gradients flow through every
    completed path exactly as in the plain rematerialized scan, at the
    compacted wavefront's cost. Memory: `jax.checkpoint` per DIFF_CHUNK
    iterations (nested-scan rematerialization).

    Returns per-lane radiance in x's ORIGINAL lane order (sum over spi
    samples)."""
    n = int(x.shape[0])
    sizes = _bucket_chain(n)
    budget_total = settings.spi * settings.max_depth
    n_chunks = -(-budget_total // DIFF_CHUNK)
    st = _start_state(scene, settings, x, y, iteration, frame)
    film_r = jnp.zeros(n, jnp.float32)
    film_g = jnp.zeros(n, jnp.float32)
    film_b = jnp.zeros(n, jnp.float32)
    px, py = x, y
    l0 = jnp.arange(n, dtype=jnp.int32)
    consumed = jnp.int32(0)
    for si, size in enumerate(sizes):
        last = si == len(sizes) - 1
        min_alive = 0 if last else size // SHRINK
        bounce = make_bounce(scene, settings, (size,), eval_texture,
                             regen=(px, py, iteration, frame))

        def it_body(carry, _, bounce=bounce, min_alive=min_alive):
            s, cons = carry
            na = jnp.sum(s.alive.astype(jnp.int32))
            do = (na > min_alive) & (cons < budget_total)
            s2 = jax.lax.cond(do, lambda s_: bounce(s_, cons)[0],
                              lambda s_: s_, s)
            return (s2, cons + do.astype(jnp.int32)), None

        def chunk(carry, _, it_body=it_body):
            return jax.lax.scan(it_body, carry, None, length=DIFF_CHUNK)

        chunk_ckpt = jax.checkpoint(chunk, prevent_cse=False)
        (st, consumed), _ = jax.lax.scan(chunk_ckpt, (st, consumed), None,
                                         length=n_chunks)

        film_r = film_r.at[l0].add(st.result.r)
        film_g = film_g.at[l0].add(st.result.g)
        film_b = film_b.at[l0].add(st.result.b)
        if not last:
            st = st._replace(result=black((size,)))
            order = jnp.argsort(~st.alive)[:size // SHRINK]
            st = jax.tree_util.tree_map(lambda a: a[order], st)
            px, py, l0 = px[order], py[order], l0[order]
    return Color(film_r, film_g, film_b)


def path_trace(scene: SceneData, settings: RenderSettings, rays: Rays,
               rng_state, eval_texture=None) -> Color:
    """Trace one wavefront of camera rays to completion. Returns radiance."""
    n = rays.tmin.shape
    init = initial_state(rays, rng_state)
    bounce = make_bounce(scene, settings, n, eval_texture)

    if settings.remat:
        # Differentiable path: lax.scan over the full static depth with
        # per-bounce rematerialization (path-replay-style memory profile).
        bounce_ckpt = jax.checkpoint(bounce, prevent_cse=False)
        final, _ = jax.lax.scan(bounce_ckpt, init,
                                jnp.arange(settings.max_depth))
        return final.result

    # Forward path: while_loop with early exit once the whole wavefront is
    # dead — typical scenes terminate far before max_depth (RR), and the
    # reference wavefront loop has the same "while rays remain" structure
    # (mapping_cpu.art:749).
    def cond(carry):
        b, state = carry
        return (b < settings.max_depth) & jnp.any(state.alive)

    def body(carry):
        b, state = carry
        state, _ = bounce(state, b)
        return (b + 1, state)

    _, final = jax.lax.while_loop(cond, body, (jnp.int32(0), init))
    return final.result


def _infinite_rows(scene: SceneData, settings: RenderSettings):
    return list(settings.infinite_light_rows)
