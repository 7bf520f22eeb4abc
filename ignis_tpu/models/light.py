"""Light sampling / evaluation with masked kind dispatch.

Semantics mirror /root/reference/src/artic/light/*.art (point, spot,
directional, area, env, sun) in batched SoA form. Light selection is the
uniform selector (light_selector.art:26); CDF/hierarchy selectors are layered
on top via the `select_*` functions.

Pdf convention (reference driver/light.art Pdf): every direct sample carries
(pdf_value, pdf_is_area). Conversion to solid angle:
    solid = value * dist^2 / cos        (area measure)
    solid = value                       (already solid)
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core.cdf import CDF2D, pdf_cdf_2d, sample_cdf_2d
from ..core.vec import (Color, Vec2, Vec3, black, cselect, cross, dot, gray,
                        length, normalize, safe_div, vselect)
from ..core.warp import (INV_4PI, PI, TWO_PI, dir_from_spherical,
                         sample_uniform_sphere, spherical_from_dir,
                         uniform_cone_pdf, sample_uniform_cone, sample_triangle)
from ..core.frame import make_frame
from ..scenedata import Lights, SceneData

FLT_MAX = 3.0e38  # python float: jnp module constants become captured buffers


class LightKind(IntEnum):
    POINT = 0
    SPOT = 1
    DIRECTIONAL = 2
    AREA = 3
    ENV = 4        # constant (tex=-1) or textured with CDF2D
    SUN = 5


class LightParams(NamedTuple):
    kind: jnp.ndarray
    pos: Vec3
    dir: Vec3
    intensity: Color
    p0: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    tri_start: jnp.ndarray
    tri_count: jnp.ndarray
    tex: jnp.ndarray
    delta: jnp.ndarray
    infinite: jnp.ndarray


class DirectSample(NamedTuple):
    pos: Vec3          # point on the light (meaningless for infinite)
    dir: Vec3          # unit direction surface -> light
    intensity: Color   # already divided by the sample pdf
    pdf_value: jnp.ndarray
    pdf_is_area: jnp.ndarray
    cos: jnp.ndarray   # cosine on the light side
    dist: jnp.ndarray


def gather_light(lights: Lights, idx) -> LightParams:
    from ..ops.gather import take_rows
    g = lambda a: take_rows(a, idx)
    return LightParams(
        kind=g(lights.kind),
        pos=Vec3(g(lights.pos.x), g(lights.pos.y), g(lights.pos.z)),
        dir=Vec3(g(lights.dir.x), g(lights.dir.y), g(lights.dir.z)),
        intensity=Color(g(lights.intensity.r), g(lights.intensity.g),
                        g(lights.intensity.b)),
        p0=g(lights.p0), p1=g(lights.p1), p2=g(lights.p2),
        tri_start=g(lights.tri_start), tri_count=g(lights.tri_count),
        tex=g(lights.tex), delta=g(lights.delta), infinite=g(lights.infinite),
    )


def pdf_as_solid(pdf_value, pdf_is_area, cos, dist2):
    area_as_solid = pdf_value * safe_div(dist2, cos)
    return jnp.where(pdf_is_area, area_as_solid, pdf_value)


# ---------------------------------------------------------------------------
# Direct-connection sampling (NEE)
# ---------------------------------------------------------------------------

def sample_direct(scene: SceneData, lp: LightParams, from_point: Vec3,
                  from_entering, u0, u1, eval_texture=None,
                  kinds=None) -> DirectSample:
    """`kinds` is the static set of LightKind values present in the scene
    (settings.light_kinds); absent kinds' branches are pruned at trace time
    — the analog of the reference generating one shader per scene
    (LoaderLight.cpp:82: only used plugins are emitted)."""
    shape = lp.p0.shape
    one = jnp.ones(shape, jnp.float32)
    zero = jnp.zeros(shape, jnp.float32)
    k = lp.kind
    if kinds is None:
        kinds = (LightKind.POINT, LightKind.SPOT, LightKind.DIRECTIONAL,
                 LightKind.SUN, LightKind.AREA, LightKind.ENV)
    kinds = tuple(int(x) for x in kinds)

    branches = []

    if int(LightKind.POINT) in kinds or int(LightKind.SPOT) in kinds:
        to_l = lp.pos - from_point
        dist = length(to_l)
        pdir = to_l * safe_div(1.0, dist)
        if int(LightKind.POINT) in kinds:
            # point (point.art)
            branches.append((LightKind.POINT, DirectSample(
                lp.pos, pdir, lp.intensity, one, one > 0, one, dist)))
        if int(LightKind.SPOT) in kinds:
            # spot (spot.art)
            cos_cut = lp.p0
            cos_fall = lp.p1
            blend = cos_fall - cos_cut
            cos_angle = dot(-pdir, lp.dir)
            tfac = jnp.clip(safe_div(cos_angle - cos_cut, blend), 0.0, 1.0)
            sfac = jnp.where(blend <= 1e-6,
                             jnp.where(cos_angle <= cos_cut, 0.0, 1.0),
                             tfac * tfac * (3.0 - 2.0 * tfac))
            spot_valid = cos_angle > cos_cut
            branches.append((LightKind.SPOT, DirectSample(
                lp.pos, pdir, lp.intensity * sfac,
                jnp.where(spot_valid, 1.0, 0.0), one > 0,
                -dot(pdir, lp.dir), dist)))

    if int(LightKind.DIRECTIONAL) in kinds or int(LightKind.SUN) in kinds:
        # lp.dir stores the direction light -> scene; connection dir is -dir.
        ddir = -lp.dir
        if int(LightKind.DIRECTIONAL) in kinds:
            branches.append((LightKind.DIRECTIONAL, DirectSample(
                from_point + ddir * (2.0 * scene.scene_radius), ddir,
                lp.intensity, one, zero > 1, one, 2.0 * scene.scene_radius)))
        if int(LightKind.SUN) in kinds:
            # sun: uniform cone around -dir with cos_angle p0 (sun.art)
            sun_cos = lp.p0
            cdir_l, cpdf = sample_uniform_cone(u0, u1, sun_cos)
            sframe = make_frame(ddir)
            sdir = sframe.to_world(cdir_l)
            branches.append((LightKind.SUN, DirectSample(
                from_point + sdir * (2.0 * scene.scene_radius), sdir,
                lp.intensity * safe_div(1.0, cpdf), cpdf, zero > 1,
                one, 2.0 * scene.scene_radius)))

    if int(LightKind.AREA) in kinds:
        # area (area.art + CDF face sampling)
        branches.append((LightKind.AREA, _sample_area_direct(
            scene, lp, from_point, from_entering, u0, u1)))

    if int(LightKind.ENV) in kinds:
        # env (env.art)
        branches.append((LightKind.ENV, _sample_env_direct(
            scene, lp, from_point, u0, u1, eval_texture)))

    def sel(kv, s, cur):
        m = k == kv
        return DirectSample(vselect(m, s.pos, cur.pos),
                            vselect(m, s.dir, cur.dir),
                            cselect(m, s.intensity, cur.intensity),
                            jnp.where(m, s.pdf_value, cur.pdf_value),
                            jnp.where(m, s.pdf_is_area, cur.pdf_is_area),
                            jnp.where(m, s.cos, cur.cos),
                            jnp.where(m, s.dist, cur.dist))

    if not branches:
        z3 = Vec3(zero, zero, zero)
        return DirectSample(z3, z3, Color(zero, zero, zero), zero, zero > 1,
                            zero, one)
    out = branches[0][1]
    for kv, s in branches[1:]:
        out = sel(kv, s, out)
    return out


def sample_area_point(scene: SceneData, lp: LightParams, u0, u1):
    """Uniform-by-area point on an area light -> (pos, face_normal).
    Tri lights use the global concatenated CDF (build.py); sphere lights
    sample the surface uniformly."""
    lrow = _area_row_of(scene, lp)
    key = lrow.astype(jnp.float32) + jnp.clip(u0, 0.0, 0.999999)
    n = scene.lights.area_cdf.shape[0]
    pos = jnp.clip(jnp.searchsorted(scene.lights.area_cdf, key, side="right"),
                   0, max(n - 1, 0))
    from ..ops.gather import gather_cols
    cdf = scene.lights.area_cdf
    cdf_prev = jnp.concatenate([jnp.zeros((1,), cdf.dtype), cdf[:-1]])
    # entries are row + within-row fraction; the segment [lo, hi) of the
    # chosen entry, relative to its own light row
    c, cp = cdf[pos], cdf_prev[pos]
    row = jnp.ceil(c) - 1.0
    lo = jnp.where(pos > 0, jnp.clip(cp - row, 0.0, 1.0), 0.0)
    hi = jnp.clip(c - row, 0.0, 1.0)
    seg = hi - lo
    ur = jnp.where(seg > 0, (jnp.clip(u0, 0.0, 0.999999) - lo)
                   / jnp.where(seg > 0, seg, 1.0), 0.0)
    tri = scene.lights.area_tris[pos]
    (v0x_, v0y_, v0z_, e1x_, e1y_, e1z_, e2x_, e2y_, e2z_) = gather_cols(
        tri, [scene.tris.v0.x, scene.tris.v0.y, scene.tris.v0.z,
              scene.tris.e1.x, scene.tris.e1.y, scene.tris.e1.z,
              scene.tris.e2.x, scene.tris.e2.y, scene.tris.e2.z])
    v0 = Vec3(v0x_, v0y_, v0z_)
    e1 = Vec3(e1x_, e1y_, e1z_)
    e2 = Vec3(e2x_, e2y_, e2z_)
    bu, bv = sample_triangle(jnp.clip(ur, 0.0, 1.0), u1)
    p = v0 + e1 * bu + e2 * bv
    fn = cross(e1, e2)
    face_n = fn * safe_div(1.0, length(fn))

    # Analytic-sphere area emitter (tri_count == 0): uniform surface point.
    is_sphere = lp.tri_count == 0
    sdir, _ = sample_uniform_sphere(u0, u1)
    sp = lp.pos + sdir * lp.p2
    p = vselect(is_sphere, sp, p)
    face_n = vselect(is_sphere, sdir, face_n)
    return p, face_n


def _sample_area_direct(scene: SceneData, lp: LightParams, from_point: Vec3,
                        from_entering, u0, u1) -> DirectSample:
    p, face_n = sample_area_point(scene, lp, u0, u1)
    to_l = p - from_point
    dist = length(to_l)
    d = to_l * safe_div(1.0, dist)
    # reference area.art: cos = dot(dir, face_normal) * (entering ? -1 : 1)
    cos = dot(d, face_n) * jnp.where(from_entering, -1.0, 1.0)
    total_area = lp.p0
    pdf_area = safe_div(1.0, total_area)
    # DirectSample convention: intensity already divided by the sample pdf
    # (area.art make_shape_area_emitter weight = area * prim_count).
    return DirectSample(p, d, lp.intensity * total_area, pdf_area,
                        jnp.ones_like(dist) > 0, cos, dist)


def _area_row_of(scene: SceneData, lp: LightParams):
    # Recover the light row from tri_start: rows are unique per area light.
    # We store the row directly in p1 for area lights (build.py).
    return lp.p1.astype(jnp.int32)


# -- env ---------------------------------------------------------------------

def _env_uv_from_dir(local_dir: Vec3) -> Vec2:
    """(env.art map_env_uv) dir is in env space *after* switch_env_up."""
    theta, phi = spherical_from_dir(local_dir)
    v = theta / PI
    u = phi / TWO_PI
    u = jnp.mod(u + 0.25, 1.0)
    return Vec2(u, 1.0 - v)


def _switch_env_up(v: Vec3) -> Vec3:
    return Vec3(v.x, v.z, v.y)


def _sample_env_direct(scene: SceneData, lp: LightParams, from_point: Vec3,
                       u0, u1, eval_texture) -> DirectSample:
    shape = lp.p0.shape
    radius = scene.scene_radius * 1.01
    # Constant env: uniform sphere (env.art spherical variant)
    sdir, spdf = sample_uniform_sphere(u0, u1)
    const_int = lp.intensity * (1.0 / INV_4PI)  # intensity / pdf
    d = sdir
    intens = const_int
    pdf = jnp.broadcast_to(INV_4PI, shape)

    if eval_texture is not None and scene.envmap is not None \
            and _env_method(scene.envmap) is None:
        # Textured env WITHOUT an importance table (cdf: "none", or the
        # radiance is a PExpr that was not baked): keep the uniform-sphere
        # direction but weight by the texture's emission along it
        uvd = _env_uv_from_dir(_switch_env_up(d))
        tex_col = eval_texture(lp.tex, uvd)
        t_int = tex_col.cmul(lp.intensity) * (1.0 / INV_4PI)
        intens = cselect(lp.tex >= 0, t_int, intens)
    if eval_texture is not None and scene.envmap is not None \
            and _env_method(scene.envmap) is not None:
        # Textured env with a 2D importance table; which build the scene
        # carries (conditional CDF / SAT / hierarchical pyramid,
        # EnvironmentLight.cpp:22-27) is static in the pytree shapes
        x, y, p2 = _env_sample_uv(scene.envmap, u0, u1)
        theta = (1.0 - y) * PI
        phi = (x - 0.25) * TWO_PI
        ld = dir_from_spherical(theta, phi)
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - ld.z * ld.z, 0.0))
        pdf_dir = safe_div(p2, sin_theta * PI * PI * 2.0)
        wdir = _switch_env_up(ld)
        tex_col = eval_texture(lp.tex, Vec2(x, y))
        t_int = tex_col.cmul(lp.intensity) * safe_div(1.0, pdf_dir)
        use_tex = lp.tex >= 0
        d = vselect(use_tex, wdir, d)
        intens = cselect(use_tex, t_int, intens)
        pdf = jnp.where(use_tex, pdf_dir, pdf)

    return DirectSample(from_point + d * radius, d, intens, pdf,
                        jnp.zeros(shape, bool), jnp.ones(shape, jnp.float32),
                        jnp.broadcast_to(radius, shape))


def env_emission(scene: SceneData, lp: LightParams, ray_dir: Vec3,
                 eval_texture=None) -> Color:
    """Radiance of an infinite light for a ray escaping along ray_dir."""
    out = lp.intensity
    if eval_texture is not None:
        ld = _switch_env_up(ray_dir)
        uv = _env_uv_from_dir(ld)
        tex_col = eval_texture(lp.tex, uv)
        out = cselect(lp.tex >= 0, tex_col.cmul(lp.intensity), out)
    is_env = lp.kind == LightKind.ENV
    # Sun disk (sun.art emission): radiance inside the cone, else black.
    sun_dir = -lp.dir  # towards the sun
    in_cone = dot(ray_dir, sun_dir) >= lp.p0
    is_sun = (lp.kind == LightKind.SUN) & ~lp.delta
    res = cselect(is_env, out, black(lp.p0.shape))
    return cselect(is_sun & in_cone, lp.intensity, res)


def _env_method(envmap):
    """Static dispatch on which importance table the scene carries."""
    if envmap is None:
        return None
    if len(envmap.hier_levels) > 0:
        return "hierachical"
    if envmap.sat_grid.shape[0] > 1 or envmap.sat_grid.shape[1] > 1:
        return "sat"
    if envmap.conditional.shape[0] > 1 or envmap.conditional.shape[1] > 1:
        return "conditional"
    return None


def _env_sample_uv(envmap, u0, u1):
    """Sample (x, y, unit-square pdf) from the env importance table."""
    m = _env_method(envmap)
    if m == "hierachical":
        from ..core.cdf import Hier2D, sample_hier_2d
        return sample_hier_2d(Hier2D(envmap.hier_levels), u0, u1)
    if m == "sat":
        from ..core.cdf import SAT2D, sample_sat_2d
        return sample_sat_2d(SAT2D(envmap.sat_table, envmap.sat_grid),
                             u0, u1)
    return sample_cdf_2d(CDF2D(envmap.marginal, envmap.conditional), u0, u1)


def _env_pdf_uv(envmap, x, y):
    m = _env_method(envmap)
    if m == "hierachical":
        from ..core.cdf import Hier2D, pdf_hier_2d
        return pdf_hier_2d(Hier2D(envmap.hier_levels), x, y)
    if m == "sat":
        from ..core.cdf import SAT2D, pdf_sat_2d
        return pdf_sat_2d(SAT2D(envmap.sat_table, envmap.sat_grid), x, y)
    return pdf_cdf_2d(CDF2D(envmap.marginal, envmap.conditional), x, y)


def env_pdf_direct(scene: SceneData, lp: LightParams, ray_dir: Vec3):
    """Solid-angle pdf of sampling ray_dir via sample_direct (for MIS)."""
    pdf = jnp.broadcast_to(INV_4PI, lp.p0.shape)
    if scene.envmap is not None and _env_method(scene.envmap) is not None:
        ld = _switch_env_up(ray_dir)
        uv = _env_uv_from_dir(ld)
        p2 = _env_pdf_uv(scene.envmap, uv.x, uv.y)
        sin_theta = jnp.sqrt(jnp.maximum(1.0 - ld.z * ld.z, 0.0))
        pdf_tex = safe_div(p2, sin_theta * PI * PI * 2.0)
        pdf = jnp.where(lp.tex >= 0, pdf_tex, pdf)
    # Sun disk: uniform-cone pdf inside the cone (sun.art pdf_direct)
    sun_dir = -lp.dir
    in_cone = dot(ray_dir, sun_dir) >= lp.p0
    sun_pdf = jnp.where(in_cone, uniform_cone_pdf(lp.p0), 0.0)
    pdf = jnp.where(lp.kind == LightKind.SUN, sun_pdf, pdf)
    return pdf


# ---------------------------------------------------------------------------
# Light selection (uniform + flux-CDF; light_selector.art)
# ---------------------------------------------------------------------------

def select_uniform(n_lights: int, u):
    idx = jnp.clip((u * n_lights).astype(jnp.int32), 0, max(n_lights - 1, 0))
    pdf = jnp.full(jnp.shape(u), 1.0 / max(n_lights, 1), jnp.float32)
    return idx, pdf


def select_cdf(lights: Lights, n_lights: int, u):
    """Flux-weighted selection over finite lights via the select_cdf table
    (build-side estimated powers, LoaderLight.cpp:468). Falls back to
    uniform when the table is absent."""
    cdf = lights.select_cdf
    n = cdf.shape[0]
    idx = jnp.clip(jnp.searchsorted(cdf, u, side="right"), 0, n - 1)
    lo = jnp.where(idx > 0, cdf[jnp.maximum(idx - 1, 0)], 0.0)
    pdf = cdf[idx] - lo
    return idx, pdf


def _hier_cost(lights: Lights, idx, pos: Vec3):
    """Importance of a hierarchy entry from `pos`
    (light_hierarchy.art get_entry_cost: flux * cos / dist^2)."""
    ex = lights.hier_pos.x[idx] - pos.x
    ey = lights.hier_pos.y[idx] - pos.y
    ez = lights.hier_pos.z[idx] - pos.z
    dist2 = jnp.maximum(ex * ex + ey * ey + ez * ez, 1e-9)
    inv_l = 1.0 / jnp.sqrt(dist2)
    cos_d = jnp.abs((lights.hier_dir.x[idx] * ex + lights.hier_dir.y[idx] * ey
                     + lights.hier_dir.z[idx] * ez) * inv_l)
    cos_d = jnp.where(lights.hier_has_dir[idx], cos_d, 1.0)
    return safe_div(lights.hier_flux[idx] * cos_d, dist2)


def _hier_left_prob(lights: Lights, left, right, pos: Vec3):
    cl = _hier_cost(lights, left, pos)
    cr = _hier_cost(lights, right, pos)
    return jnp.clip(safe_div(1.0, 1.0 + safe_div(cr, jnp.maximum(cl, 1e-30))),
                    1e-4, 1.0 - 1e-4)


def select_hierarchy(lights: Lights, u, pos: Vec3):
    """Stochastic top-down traversal (light_hierarchy.art sample_light_id);
    the single uniform is rescaled at every split."""
    n = jnp.shape(u)
    idx0 = jnp.zeros(n, jnp.int32)

    def cond(carry):
        idx, pdf, uu = carry
        return jnp.any(lights.hier_child[idx] < 0)

    def body(carry):
        idx, pdf, uu = carry
        child = lights.hier_child[idx]
        inner = child < 0
        left = jnp.where(inner, -child - 1, idx)
        right = left + 1
        pl = _hier_left_prob(lights, left, right, pos)
        go_left = uu < pl
        uu2 = jnp.where(go_left, uu / pl, (uu - pl) / (1.0 - pl))
        uu2 = jnp.clip(uu2, 0.0, 1.0 - 1e-7)
        new_idx = jnp.where(inner, jnp.where(go_left, left, right), idx)
        new_pdf = jnp.where(inner, pdf * jnp.where(go_left, pl, 1.0 - pl),
                            pdf)
        return (new_idx, new_pdf, jnp.where(inner, uu2, uu))

    idx, pdf, _ = jax.lax.while_loop(
        cond, body, (idx0, jnp.ones(n, jnp.float32), u))
    return lights.hier_child[idx], pdf


def hierarchy_pdf(lights: Lights, light_row, pos: Vec3):
    """Deterministic re-descent by the light's path code
    (light_hierarchy.art compute_pdf)."""
    n = jnp.shape(light_row)
    code = lights.hier_code[jnp.clip(light_row, 0, None)]
    idx0 = jnp.zeros(n, jnp.int32)

    def cond(carry):
        idx, pdf, depth = carry
        return jnp.any(lights.hier_child[idx] < 0)

    def body(carry):
        idx, pdf, depth = carry
        child = lights.hier_child[idx]
        inner = child < 0
        left = jnp.where(inner, -child - 1, idx)
        right = left + 1
        pl = _hier_left_prob(lights, left, right, pos)
        go_left = ((code >> depth) & 1) == 0
        new_idx = jnp.where(inner, jnp.where(go_left, left, right), idx)
        new_pdf = jnp.where(inner, pdf * jnp.where(go_left, pl, 1.0 - pl),
                            pdf)
        return (new_idx, new_pdf, depth + jnp.where(inner, 1, 0))

    _, pdf, _ = jax.lax.while_loop(
        cond, body, (idx0, jnp.ones(n, jnp.float32), jnp.zeros(n, jnp.int32)))
    return pdf


def _hierarchy_available(settings, lights: Lights) -> bool:
    return (getattr(settings, "light_selector", "uniform") == "hierarchy"
            and lights.hier_child.shape[0] > 0 and settings.n_lights > 0)


def select_light(settings, lights: Lights, u, pos: Vec3 = None):
    if _hierarchy_available(settings, lights):
        n_inf = len(settings.infinite_light_rows)
        if pos is None:
            pos = Vec3(jnp.zeros(jnp.shape(u)), jnp.zeros(jnp.shape(u)),
                       jnp.zeros(jnp.shape(u)))
        if n_inf == 0:
            return select_hierarchy(lights, u, pos)
        if n_inf >= settings.n_lights:  # only infinite lights
            return select_uniform(settings.n_lights, u)
        # 50/50 infinite/finite split (light_selector.art:91)
        ratio = 0.5
        pick_inf = u < ratio
        u_inf = jnp.clip(u / ratio, 0.0, 1.0 - 1e-7)
        u_fin = jnp.clip((u - ratio) / (1.0 - ratio), 0.0, 1.0 - 1e-7)
        inf_rows = jnp.asarray(settings.infinite_light_rows, jnp.int32)
        i_idx = inf_rows[jnp.clip((u_inf * n_inf).astype(jnp.int32),
                                  0, n_inf - 1)]
        h_idx, h_pdf = select_hierarchy(lights, u_fin, pos)
        idx = jnp.where(pick_inf, i_idx, h_idx)
        pdf = jnp.where(pick_inf, ratio / n_inf, h_pdf * (1.0 - ratio))
        return idx, pdf
    if getattr(settings, "light_selector", "uniform") == "cdf" \
            and lights.select_cdf.shape[0] == settings.n_lights:
        return select_cdf(lights, settings.n_lights, u)
    return select_uniform(settings.n_lights, u)


def selector_pdf(settings, lights: Lights, light_row, pos: Vec3 = None):
    """Selection pdf of a specific light row (for MIS on emission hits)."""
    if _hierarchy_available(settings, lights):
        n_inf = len(settings.infinite_light_rows)
        if pos is None:
            z = jnp.zeros(jnp.shape(light_row), jnp.float32)
            pos = Vec3(z, z, z)
        if n_inf >= settings.n_lights:
            return jnp.full(jnp.shape(light_row),
                            1.0 / max(settings.n_lights, 1), jnp.float32)
        h_pdf = hierarchy_pdf(lights, light_row, pos)
        if n_inf == 0:
            return h_pdf
        from ..ops.gather import take_rows
        is_inf = take_rows(lights.infinite, jnp.clip(light_row, 0, None))
        return jnp.where(is_inf, 0.5 / n_inf, h_pdf * 0.5)
    if getattr(settings, "light_selector", "uniform") == "cdf" \
            and lights.select_cdf.shape[0] == settings.n_lights:
        idx = jnp.clip(light_row, 0, settings.n_lights - 1)
        lo = jnp.where(idx > 0, lights.select_cdf[jnp.maximum(idx - 1, 0)], 0.0)
        return lights.select_cdf[idx] - lo
    return jnp.full(jnp.shape(light_row), 1.0 / max(settings.n_lights, 1),
                    jnp.float32)


class EmissionSample(NamedTuple):
    pos: Vec3
    dir: Vec3
    intensity: Color   # divided by (pdf_area * pdf_dir)
    cos: jnp.ndarray   # cosine at the light


def sample_emission(scene: SceneData, lp: LightParams,
                    u0, u1, u2, u3, eval_texture=None) -> EmissionSample:
    """Emission sampling for light tracing (light.art sample_emission)."""
    shape = lp.p0.shape
    one = jnp.ones(shape, jnp.float32)
    k = lp.kind
    radius = scene.scene_radius * 1.01
    center = scene.scene_center

    # point: uniform sphere
    sdir, spdf = sample_uniform_sphere(u2, u3)
    point_s = EmissionSample(lp.pos, sdir,
                             lp.intensity * safe_div(1.0, spdf), one)

    # spot: uniform cone around axis. The spot's radiant intensity (per
    # the reference's direct-sampling path and its analytic integrator
    # test) is I(dir) = intensity * sfac * cos_axis, so the photon weight
    # is I(dir)/pdf_cone — the cos_axis rides in the `cos` field (the
    # light tracer multiplies it in). The reference's own
    # sample_emission (spot.art:42-47) additionally DIVIDES by
    # spot_area, which dims spot photons ~2x against its own path
    # tracer; that factor is dropped here.
    cdirl, cpdf = sample_uniform_cone(u2, u3, lp.p0)
    sp_frame = make_frame(lp.dir)
    sp_dir = sp_frame.to_world(cdirl)
    blend = lp.p1 - lp.p0
    cosang = dot(sp_dir, lp.dir)
    tfac = jnp.clip(safe_div(cosang - lp.p0, blend), 0.0, 1.0)
    sfac = jnp.where(blend <= 1e-6, jnp.where(cosang <= lp.p0, 0.0, 1.0),
                     tfac * tfac * (3.0 - 2.0 * tfac))
    spot_s = EmissionSample(lp.pos, sp_dir,
                            lp.intensity * (sfac * safe_div(1.0, cpdf)),
                            cdirl.z)

    # area: CDF face point + cosine hemisphere (tri or sphere)
    from ..core.warp import sample_cosine_hemisphere, square_to_concentric_disk
    a_pos, a_n = sample_area_point(scene, lp, u0, u1)
    a_frame = make_frame(a_n)
    hdir, hpdf = sample_cosine_hemisphere(u2, u3)
    a_dir = a_frame.to_world(hdir)
    # weight = 1 / (area_pdf * cos_pdf) = total_area / cos_pdf (area.art)
    area_s = EmissionSample(a_pos, a_dir,
                            lp.intensity * (lp.p0 * safe_div(1.0, hpdf)),
                            hdir.z)

    # env / sun / directional: direction + disk position on bounding sphere
    env_dir = -sdir  # inward
    disk = square_to_concentric_disk(u0, u1)
    dframe = make_frame(env_dir)
    dpos_pdf = safe_div(1.0, PI * radius * radius)
    def boundary_pos(d):
        off = dframe.to_world(Vec3(disk.x * radius, disk.y * radius,
                                   jnp.zeros(shape)))
        return Vec3(center.x - d.x * radius + off.x,
                    center.y - d.y * radius + off.y,
                    center.z - d.z * radius + off.z)
    env_pos = boundary_pos(env_dir)
    env_s = EmissionSample(env_pos, env_dir,
                           lp.intensity * safe_div(1.0, spdf * dpos_pdf), one)

    sun_dir_axis = lp.dir  # light -> scene
    sframe2 = make_frame(sun_dir_axis)
    scone = sframe2.to_world(cdirl)
    sun_pos = boundary_pos(scone)
    sun_s = EmissionSample(sun_pos, scone,
                           lp.intensity * safe_div(1.0, cpdf * dpos_pdf),
                           cdirl.z)
    dirl_pos = boundary_pos(lp.dir)
    dirl_s = EmissionSample(dirl_pos, lp.dir,
                            lp.intensity * safe_div(1.0, dpos_pdf), one)

    def sel(kv, s_, cur):
        m = k == kv
        return EmissionSample(vselect(m, s_.pos, cur.pos),
                              vselect(m, s_.dir, cur.dir),
                              cselect(m, s_.intensity, cur.intensity),
                              jnp.where(m, s_.cos, cur.cos))

    out = point_s
    out = sel(LightKind.SPOT, spot_s, out)
    out = sel(LightKind.AREA, area_s, out)
    out = sel(LightKind.ENV, env_s, out)
    out = sel(LightKind.SUN, sun_s, out)
    out = sel(LightKind.DIRECTIONAL, dirl_s, out)
    return out


