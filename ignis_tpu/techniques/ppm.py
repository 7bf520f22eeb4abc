"""Progressive photon mapping (PPM).

Mirrors /root/reference/src/artic/technique/photonmapper.art and
src/runtime/technique/PhotonMappingTechnique.cpp, re-designed as
wavefronts:

- Light pass: one lane per photon. The reference only bounces *delta*
  materials before depositing (photonmapper.art:206, "handles direct (LDE)
  and caustic (LS*DE) paths"), so each light path stores at most ONE photon
  -> a fixed-capacity SoA photon map with a masked deposit, no atomics.
- Grid build: instead of the reference's atomic counting sort over a Morton
  grid (photonmapper.art:470), photons are argsorted by linear cell id and
  cell ranges come from one vectorized searchsorted — static shapes, no
  scatter contention.
- Camera pass: standard wavefront path tracing; at every non-delta vertex a
  density-estimation gather visits the 2^3 grid cells overlapping the query
  ball (radius is clamped to one cell so 8 cells always suffice) and reads a
  static K photon slots per cell. BSDF evaluation against the K gathered
  photon directions is one `jax.vmap` over the slot axis.
- The radius schedule radius_i = r0 * prod_{k<i} (k+1.8)/(k+2)
  (photonmapper.art:243) is evaluated in-trace with a closed form via
  lgamma so the iteration counter stays a traced scalar (no recompiles).
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import rng as rnglib
from ..core.frame import make_frame
from ..core.vec import (Color, Vec3, black, color_max_component, cselect, dot,
                        safe_div, vselect, white)
from ..models import bsdf as bsdflib
from ..models import light as lightlib
from ..ops.intersect import FLT_MAX, Rays
from ..scenedata import RenderSettings, SceneData
from .lighttracer import _emit
from .path import (OFFSET, _cadd_where, _handle_color, _infinite_rows,
                   apply_normal_map,
                   compute_surface, gather_material, make_surface_ctx,
                   occluded_scene, trace_scene)

TAN_1_DEG = 0.017455064  # photonmapper.art:271 (primary-footprint radius)
CONTRACT = 0.8           # radius contraction ratio (photonmapper.art:244)


class PhotonMap(NamedTuple):
    pos: Vec3            # [P] deposit position
    in_dir: Vec3         # [P] direction the photon arrived FROM (toward light)
    radiance: Color      # [P] carried power (already /pdf at emission)
    depth: jnp.ndarray   # [P] i32 path depth at deposit (light segment = 1)
    valid: jnp.ndarray   # [P] bool


class PhotonGrid(NamedTuple):
    pmap: PhotonMap          # photons sorted by cell id
    offsets: jnp.ndarray     # [G^3+1] cell -> first sorted index
    gmin: Vec3               # scalars: grid origin
    inv_cell: jnp.ndarray    # scalar 1/cell_size
    cell_size: jnp.ndarray   # scalar


# --------------------------------------------------------------------------
# Light pass
# --------------------------------------------------------------------------

class _PhotonState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: jnp.ndarray
    rng: jnp.ndarray
    contrib: Color
    depth: jnp.ndarray
    alive: jnp.ndarray
    pmap: PhotonMap


def trace_photons(scene: SceneData, settings: RenderSettings, iteration,
                  frame, eval_texture=None) -> PhotonMap:
    """Emit settings.photon_count photons; each lane deposits at most one
    photon at its first non-delta surface (make_ppm_light_renderer)."""
    P = settings.photon_count
    x = jnp.arange(P, dtype=jnp.int32)
    y = jnp.zeros(P, jnp.int32)
    n = x.shape

    rng0, pos0, dir0, tmin0, rad0 = _emit(scene, settings, x, y,
                                          jnp.zeros(n, jnp.uint32),
                                          iteration, frame)
    empty = PhotonMap(
        pos=Vec3(jnp.zeros(P), jnp.zeros(P), jnp.zeros(P)),
        in_dir=Vec3(jnp.zeros(P), jnp.zeros(P), jnp.ones(P)),
        radiance=black(n),
        depth=jnp.zeros(P, jnp.int32),
        valid=jnp.zeros(P, bool))
    init = _PhotonState(org=pos0, dir=dir0, tmin=tmin0, rng=rng0,
                        contrib=rad0, depth=jnp.ones(P, jnp.int32),
                        alive=jnp.ones(P, bool), pmap=empty)

    def bounce(state: _PhotonState) -> _PhotonState:
        rays = Rays(state.org, state.dir, state.tmin, jnp.full(n, FLT_MAX))
        hit = trace_scene(scene, rays)
        active = state.alive & (hit.prim >= 0)

        surf = compute_surface(scene, rays, hit)
        sctx = (make_surface_ctx(scene, rays, surf, eval_texture)
                if eval_texture is not None else None)
        mat = gather_material(scene, surf, eval_texture, sctx)
        out_dir = -state.dir
        mid = scene.entities.mat[jnp.clip(surf.ent, 0, None)]
        surf = apply_normal_map(scene, settings, surf, sctx, eval_texture,
                                mid)
        frame_l = make_frame(surf.ns)
        shader = bsdflib.make_lane_shader(scene.materials, mid, mat, frame_l,
                                          surf.is_entering,
                                          settings.has_blend, None,
                                          settings.bsdf_kinds,
                                          measured=scene.measured)
        all_delta = shader.is_all_delta()
        emissive = scene.entities.light[jnp.clip(surf.ent, 0, None)] >= 0
        cos_o = dot(out_dir, frame_l.n)

        # Deposit on first non-delta, non-emissive surface facing the photon
        # (photonmapper.art:178).
        deposit = active & ~emissive & ~all_delta & (cos_o > 1e-6)
        pm = state.pmap
        pm = PhotonMap(
            pos=vselect(deposit, surf.point, pm.pos),
            in_dir=vselect(deposit, out_dir, pm.in_dir),
            radiance=cselect(deposit, state.contrib, pm.radiance),
            depth=jnp.where(deposit, state.depth, pm.depth),
            valid=pm.valid | deposit)

        # Bounce only through delta chains (photonmapper.art:206), adjoint.
        rng, (b_pick, b0, b1, b2) = rnglib.next_f32_n(state.rng, 4)
        bs = shader.sample(out_dir, b_pick, b0, b1, b2, adjoint=True)
        new_contrib = state.contrib.cmul(bs.weight)
        avg = (new_contrib.r + new_contrib.g + new_contrib.b) * (1.0 / 3.0)
        cont = (active & ~deposit & all_delta & bs.valid & (avg > 1e-6)
                & (state.depth + 2 <= settings.max_light_depth))
        return _PhotonState(
            org=surf.point, dir=bs.in_dir,
            tmin=jnp.broadcast_to(OFFSET, n), rng=rng,
            contrib=cselect(cont, new_contrib, state.contrib),
            depth=state.depth + 1, alive=cont, pmap=pm)

    def cond(carry):
        it, s = carry
        return (it < settings.max_light_depth) & jnp.any(s.alive)

    def body(carry):
        it, s = carry
        return (it + 1, bounce(s))

    _, final = jax.lax.while_loop(cond, body, (jnp.int32(0), init))
    return final.pmap


# --------------------------------------------------------------------------
# Grid build (per iteration)
# --------------------------------------------------------------------------

def build_photon_grid(photons: PhotonMap, scene: SceneData,
                      settings: RenderSettings) -> PhotonGrid:
    G = settings.ppm_grid
    P = photons.valid.shape[0]
    radius = scene.scene_radius
    gmin = Vec3(scene.scene_center.x - radius, scene.scene_center.y - radius,
                scene.scene_center.z - radius)
    cell = jnp.maximum(2.0 * radius / G, 1e-6)
    inv_cell = 1.0 / cell

    def axis_idx(p, lo):
        return jnp.clip(((p - lo) * inv_cell).astype(jnp.int32), 0, G - 1)

    ix = axis_idx(photons.pos.x, gmin.x)
    iy = axis_idx(photons.pos.y, gmin.y)
    iz = axis_idx(photons.pos.z, gmin.z)
    cid = ix + G * (iy + G * iz)
    cid = jnp.where(photons.valid, cid, G * G * G)  # invalid -> end bucket

    order = jnp.argsort(cid)
    cid_sorted = cid[order]
    take = lambda a: a[order]
    pm = PhotonMap(
        pos=Vec3(take(photons.pos.x), take(photons.pos.y),
                 take(photons.pos.z)),
        in_dir=Vec3(take(photons.in_dir.x), take(photons.in_dir.y),
                    take(photons.in_dir.z)),
        radiance=Color(take(photons.radiance.r), take(photons.radiance.g),
                       take(photons.radiance.b)),
        depth=take(photons.depth), valid=take(photons.valid))
    offsets = jnp.searchsorted(cid_sorted, jnp.arange(G * G * G + 1))
    offsets = offsets.astype(jnp.int32)
    return PhotonGrid(pmap=pm, offsets=offsets, gmin=gmin,
                      inv_cell=inv_cell, cell_size=cell)


def compute_radius(settings: RenderSettings, scene: SceneData, iteration):
    """ppm_compute_radius via closed form:
    prod_{i<n} (i+1+c)/(i+2) = Gamma(n+1+c) / (Gamma(1+c) Gamma(n+2))."""
    r0 = settings.merge_radius * 2.0 * scene.scene_radius
    nf = iteration.astype(jnp.float32)
    shrink = jnp.exp(jax.lax.lgamma(nf + 1.0 + CONTRACT)
                     - jax.lax.lgamma(jnp.float32(1.0 + CONTRACT))
                     - jax.lax.lgamma(nf + 2.0))
    return jnp.maximum(r0 * shrink, 1e-5)


# --------------------------------------------------------------------------
# Gather (density estimation)
# --------------------------------------------------------------------------

def _ppm_kernel(r2, d2):
    """Simpson kernel (photonmapper.art:43)."""
    ir2 = safe_div(1.0, r2)
    term = 1.0 - d2 * ir2
    return term * term * 3.0 * ir2 * (1.0 / jnp.pi)


def gather_photons(grid: PhotonGrid, settings: RenderSettings, point: Vec3,
                   radius, shader, out_dir: Vec3, normal: Vec3, cos_o,
                   cam_depth) -> Color:
    """Sum kernel-weighted photon contributions within `radius` of `point`.

    radius is clamped to one grid cell so the 2x2x2 cell neighbourhood of
    (point - radius) always covers the query ball; each cell contributes up
    to K=settings.ppm_cell_cap photons (documented truncation)."""
    G = settings.ppm_grid
    K = settings.ppm_cell_cap
    n = cos_o.shape
    P = grid.pmap.valid.shape[0]
    radius = jnp.minimum(radius, grid.cell_size)
    r2 = radius * radius

    def lo_idx(p, lo):
        return jnp.floor((p - radius - lo) * grid.inv_cell).astype(jnp.int32)

    lx, ly, lz = (lo_idx(point.x, grid.gmin.x), lo_idx(point.y, grid.gmin.y),
                  lo_idx(point.z, grid.gmin.z))

    pm = grid.pmap
    slot = jnp.arange(K, dtype=jnp.int32)

    def eval_k(din: Vec3) -> Color:
        return shader.eval(din, out_dir)

    eval_vk = jax.vmap(eval_k, in_axes=(Vec3(1, 1, 1),),
                       out_axes=Color(1, 1, 1))

    acc = black(n)
    for dz in (0, 1):
        for dy in (0, 1):
            for dx in (0, 1):
                cx, cy, cz = lx + dx, ly + dy, lz + dz
                in_grid = ((cx >= 0) & (cx < G) & (cy >= 0) & (cy < G)
                           & (cz >= 0) & (cz < G))
                cid = jnp.where(in_grid, cx + G * (cy + G * cz), 0)
                start = grid.offsets[cid]
                end = jnp.where(in_grid, grid.offsets[cid + 1], start)
                idx = start[:, None] + slot[None, :]          # [n, K]
                m = idx < end[:, None]
                idc = jnp.clip(idx, 0, P - 1)
                ppos = Vec3(pm.pos.x[idc], pm.pos.y[idc], pm.pos.z[idc])
                pdir = Vec3(pm.in_dir.x[idc], pm.in_dir.y[idc],
                            pm.in_dir.z[idc])
                prad = Color(pm.radiance.r[idc], pm.radiance.g[idc],
                             pm.radiance.b[idc])
                pdepth = pm.depth[idc]
                ex = point.x[:, None] - ppos.x
                ey = point.y[:, None] - ppos.y
                ez = point.z[:, None] - ppos.z
                d2 = ex * ex + ey * ey + ez * ez
                cos_i = (pdir.x * normal.x[:, None]
                         + pdir.y * normal.y[:, None]
                         + pdir.z * normal.z[:, None])
                ok = (m & pm.valid[idc] & (d2 <= r2[:, None])
                      & (cam_depth[:, None] + pdepth <= settings.max_depth)
                      & ((cos_o[:, None] * cos_i) > 1e-6))
                kern = _ppm_kernel(r2[:, None], d2)
                # eval includes |cos_i|; the projection is already handled on
                # the light side, so divide it back out (photonmapper.art:312)
                f = eval_vk(pdir)
                w = jnp.where(ok, safe_div(kern, jnp.abs(cos_i)), 0.0)
                # Truncation compensation: a cell holding more than K
                # photons contributes a K-subsample (cell order is
                # hash-arbitrary, i.e. unweighted); rescale by the kept
                # fraction so concentrated maps (spot/point lights) keep
                # their full flux instead of silently darkening.
                cnt = (end - start).astype(jnp.float32)
                scale = safe_div(cnt, jnp.minimum(cnt, float(K)))
                w = w * jnp.maximum(scale, 1.0)[:, None]
                acc = Color(acc.r + jnp.sum(prad.r * f.r * w, axis=1),
                            acc.g + jnp.sum(prad.g * f.g * w, axis=1),
                            acc.b + jnp.sum(prad.b * f.b * w, axis=1))
    return acc * (1.0 / settings.photon_count)


# --------------------------------------------------------------------------
# Camera pass
# --------------------------------------------------------------------------

class _CamState(NamedTuple):
    org: Vec3
    dir: Vec3
    tmin: jnp.ndarray
    tmax: jnp.ndarray
    rng: jnp.ndarray
    contrib: Color
    eta: jnp.ndarray
    radius: jnp.ndarray     # inherited primary-footprint radius
    path_type: jnp.ndarray  # 0 = delta-only so far, 1 = diffuse bounce seen
    alive: jnp.ndarray
    result: Color
    depth: jnp.ndarray
    sample: jnp.ndarray


def ppm_trace_progressive(scene: SceneData, settings: RenderSettings, x, y,
                          iteration, frame, grid: PhotonGrid, radius_it,
                          eval_texture=None) -> Color:
    """Camera pass (make_ppm_path_renderer) with persistent-lane
    regeneration; returns per-lane radiance summed over spi samples."""
    from ..core.sampler import sample_pixel_offsets
    from ..models import camera as cameralib
    n = x.shape

    def fresh_rays(sample):
        st = rnglib.seed(sample.astype(jnp.uint32),
                         iteration.astype(jnp.uint32),
                         frame.astype(jnp.uint32), x.astype(jnp.uint32),
                         y.astype(jnp.uint32), jnp.uint32(settings.seed))
        sample_idx = iteration.astype(jnp.uint32) \
            * jnp.uint32(settings.spi) + sample.astype(jnp.uint32)
        st, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, st,
                                            sample_idx, x, y)
        return st, cameralib.generate_rays(scene.camera, settings, x, y,
                                           rx, ry, rng_state=st)

    rng0, rays0 = fresh_rays(jnp.zeros(n, jnp.uint32))
    init = _CamState(org=rays0.org, dir=rays0.dir, tmin=rays0.tmin,
                     tmax=rays0.tmax, rng=rng0, contrib=white(n),
                     eta=jnp.ones(n), radius=jnp.full(n, FLT_MAX),
                     path_type=jnp.zeros(n, jnp.int32),
                     alive=jnp.ones(n, bool), result=black(n),
                     depth=jnp.ones(n, jnp.int32),
                     sample=jnp.zeros(n, jnp.int32))

    def bounce(state: _CamState) -> _CamState:
        rays_b = Rays(state.org, state.dir, state.tmin, state.tmax)
        hit = trace_scene(scene, rays_b)
        found = hit.prim >= 0
        result = state.result

        # miss: infinite lights, LS*E only (photonmapper.art:328)
        miss = state.alive & ~found & (state.path_type == 0)
        for lid in _infinite_rows(scene, settings):
            lp = lightlib.gather_light(scene.lights,
                                       jnp.full(n, lid, jnp.int32))
            emit = lightlib.env_emission(scene, lp, state.dir, eval_texture)
            c = _handle_color(state.contrib.cmul(emit), settings)
            result = _cadd_where(miss & ~lp.delta, result, c)

        active = state.alive & found
        surf = compute_surface(scene, rays_b, hit)
        sctx = (make_surface_ctx(scene, rays_b, surf, eval_texture)
                if eval_texture is not None else None)
        mat = gather_material(scene, surf, eval_texture, sctx)
        out_dir = -state.dir
        mid = scene.entities.mat[jnp.clip(surf.ent, 0, None)]
        surf = apply_normal_map(scene, settings, surf, sctx, eval_texture,
                                mid)
        frame_l = make_frame(surf.ns)
        w_override = None
        if settings.has_blend and eval_texture is not None:
            p0t = scene.materials.p0_tex[mid]
            wtex = eval_texture(p0t, sctx if sctx is not None else surf.uv)
            w_override = jnp.where(p0t >= 0, wtex.r, mat.p0)
        shader = bsdflib.make_lane_shader(scene.materials, mid, mat, frame_l,
                                          surf.is_entering,
                                          settings.has_blend, w_override,
                                          settings.bsdf_kinds,
                                          measured=scene.measured)
        all_delta = shader.is_all_delta()
        light_row = scene.entities.light[jnp.clip(surf.ent, 0, None)]
        emissive = light_row >= 0
        cos_o = dot(out_dir, frame_l.n)

        # direct hit on a light: only LS*E paths (photonmapper.art:283)
        lp_hit = lightlib.gather_light(scene.lights,
                                       jnp.clip(light_row, 0, None))
        emit_ok = (active & emissive & surf.is_entering
                   & (state.path_type == 0) & (cos_o > 1e-6))
        c_emit = _handle_color(state.contrib.cmul(lp_hit.intensity), settings)
        result = _cadd_where(emit_ok, result, c_emit)

        # density-estimation gather (photonmapper.art:296)
        footprint = hit.t * TAN_1_DEG
        prim_r = jnp.minimum(radius_it, footprint)
        actual_r = jnp.where(state.depth > 1, state.radius, prim_r)
        gather_ok = (active & ~emissive & ~all_delta
                     & (state.depth + 1 <= settings.max_depth)
                     & (jnp.abs(cos_o) > 1e-6))
        g = gather_photons(grid, settings, surf.point, actual_r, shader,
                           out_dir, frame_l.n, cos_o, state.depth)
        c_gather = _handle_color(state.contrib.cmul(g), settings)
        result = _cadd_where(gather_ok, result, c_gather)

        # bounce (photonmapper.art:358)
        rng, (b_pick, b0, b1, b2, b_rr) = rnglib.next_f32_n(state.rng, 5)
        bs = shader.sample(out_dir, b_pick, b0, b1, b2)
        new_contrib = state.contrib.cmul(bs.weight)
        rr_c = color_max_component(new_contrib) * state.eta * state.eta
        rr_prob = jnp.clip(rr_c, 0.05, 0.95)
        rr_prob = jnp.where(state.depth + 1 > settings.min_depth, rr_prob, 1.0)
        survive = b_rr < rr_prob
        cont = (active & bs.valid & survive & (bs.pdf > 1e-9)
                & (state.depth + 1 <= settings.max_depth))
        new_contrib = new_contrib * (1.0 / rr_prob)

        st = _CamState(
            org=surf.point, dir=bs.in_dir,
            tmin=jnp.broadcast_to(OFFSET, n), tmax=jnp.full(n, FLT_MAX),
            rng=rng,
            contrib=cselect(cont, new_contrib, state.contrib),
            eta=jnp.where(cont, state.eta * bs.eta, state.eta),
            radius=jnp.where(cont, actual_r, state.radius),
            path_type=jnp.where(cont & ~bs.is_delta, 1, state.path_type),
            alive=cont, result=result, depth=state.depth + 1,
            sample=state.sample)

        # regenerate finished lanes onto their next sample
        died = state.alive & ~cont
        has_more = state.sample + 1 < settings.spi
        do_regen = died & has_more
        new_sample = jnp.where(do_regen, state.sample + 1, state.sample)
        rng2, cam_rays = fresh_rays(new_sample.astype(jnp.uint32))
        return _CamState(
            org=vselect(do_regen, cam_rays.org, st.org),
            dir=vselect(do_regen, cam_rays.dir, st.dir),
            tmin=jnp.where(do_regen, cam_rays.tmin, st.tmin),
            tmax=jnp.where(do_regen, cam_rays.tmax, st.tmax),
            rng=jnp.where(do_regen, rng2, st.rng),
            contrib=cselect(do_regen, white(n), st.contrib),
            eta=jnp.where(do_regen, 1.0, st.eta),
            radius=jnp.where(do_regen, FLT_MAX, st.radius),
            path_type=jnp.where(do_regen, 0, st.path_type),
            alive=st.alive | do_regen, result=st.result,
            depth=jnp.where(do_regen, 1, st.depth),
            sample=new_sample)

    max_iters = settings.spi * settings.max_depth

    def cond(carry):
        it, s = carry
        return (it < max_iters) & jnp.any(s.alive)

    def body(carry):
        it, s = carry
        return (it + 1, bounce(s))

    _, final = jax.lax.while_loop(cond, body, (jnp.int32(0), init))
    return final.result


def ppm_render(scene: SceneData, settings: RenderSettings, x, y, iteration,
               frame, eval_texture=None) -> Color:
    """One full PPM iteration: photon pass + grid + camera pass."""
    photons = trace_photons(scene, settings, iteration, frame, eval_texture)
    grid = build_photon_grid(photons, scene, settings)
    radius_it = compute_radius(settings, scene, iteration)
    return ppm_trace_progressive(scene, settings, x, y, iteration, frame,
                                 grid, radius_it, eval_texture)
