"""Scan-differenced per-stage bounce profiling.

Per-bounce costs are differenced between N=10 and N=30 scans to cancel
fixed overhead; every timing ends in block_until_ready.

    python scripts/profile_bounce.py [scene.json] [size]

The default scene is the generated diamond_scene fixture.
"""
import functools
import os
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax
import jax.numpy as jnp

import ignis_tpu
from ignis_tpu.core import rng as rnglib
from ignis_tpu.core.sampler import sample_pixel_offsets
from ignis_tpu.models import camera as cameralib
from ignis_tpu.models.texture import make_texture_evaluator
from ignis_tpu.techniques import path as pathlib_

SCENE = sys.argv[1] if len(sys.argv) > 1 else str(
    Path(__file__).resolve().parent.parent / "tests" / "fixtures" / "scenes"
    / "diamond_scene.json")
SIZE = int(sys.argv[2]) if len(sys.argv) > 2 else 512


def scan_time(fn_body, scene, init, n, reps=3):
    """Time an N-step scan of fn_body, returning seconds."""
    def prog(sc, st):
        def body(s, i):
            return fn_body(sc, s, i), None
        out, _ = jax.lax.scan(body, st, jnp.arange(n))
        return out.result.r.sum() + out.org.x.sum() + out.rng.sum()
    f = jax.jit(prog)
    jax.block_until_ready(f(scene, init))  # compile+warm
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(f(scene, init))
    return (time.perf_counter() - t0) / reps


def main():
    rt = ignis_tpu.loadFromFile(SCENE, width=SIZE, height=SIZE, spi=8)
    scene, settings = rt.scene, rt.settings
    w, h = settings.width, settings.height
    x = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :],
                         (h, w)).reshape(-1)
    y = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None],
                         (h, w)).reshape(-1)
    state0 = rnglib.seed(jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
                         x.astype(jnp.uint32), y.astype(jnp.uint32),
                         jnp.uint32(settings.seed))
    state0, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, state0,
                                            jnp.uint32(0), x, y)
    rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                   rng_state=state0)
    init = pathlib_.initial_state(rays, state0)
    n = x.shape[0]
    print(f"{SCENE} {w}x{h} lanes={n} tris={scene.tris.v0.x.shape[0]} "
          f"bvh={scene.bvh is not None}")

    ev_of = lambda sc: make_texture_evaluator(settings.texture_descs,
                                              sc.textures)

    # --- stage bodies (each returns a full PathState to keep deps real) ---
    def body_trace(sc, st, i):
        raysb = pathlib_.Rays(st.org, st.dir, st.tmin,
                              jnp.where(st.alive, st.tmax, -1.0))
        hit = pathlib_.trace_scene(sc, raysb)
        rng, (u,) = rnglib.next_f32_n(st.rng, 1)
        return st._replace(rng=rng,
                           org=st.org._replace(x=st.org.x + hit.t * 1e-9),
                           result=st.result._replace(r=st.result.r + hit.u))

    def body_trace_surf(sc, st, i):
        raysb = pathlib_.Rays(st.org, st.dir, st.tmin,
                              jnp.where(st.alive, st.tmax, -1.0))
        hit = pathlib_.trace_scene(sc, raysb)
        surf = pathlib_.compute_surface(sc, raysb, hit)
        rng, (u,) = rnglib.next_f32_n(st.rng, 1)
        return st._replace(rng=rng,
                           org=st.org._replace(x=st.org.x + surf.point.x * 1e-9),
                           result=st.result._replace(r=st.result.r + surf.uv.x))

    def body_shadow(sc, st, i):
        raysb = pathlib_.Rays(st.org, st.dir, st.tmin,
                              jnp.where(st.alive, st.tmax, -1.0))
        occ = pathlib_.occluded_scene(sc, raysb)
        rng, (u,) = rnglib.next_f32_n(st.rng, 1)
        return st._replace(rng=rng,
                           result=st.result._replace(
                               r=st.result.r + occ.astype(jnp.float32)))

    def body_full(sc, st, i):
        b = pathlib_.make_bounce(sc, settings, (n,), ev_of(sc),
                                 regen=(x, y, jnp.uint32(0), jnp.uint32(0)))
        s2, _ = b(st, i)
        return s2

    import dataclasses
    settings_nonee = dataclasses.replace(settings, enable_nee=False)

    def body_nonee(sc, st, i):
        b = pathlib_.make_bounce(sc, settings_nonee, (n,), ev_of(sc),
                                 regen=(x, y, jnp.uint32(0), jnp.uint32(0)))
        s2, _ = b(st, i)
        return s2

    def body_noregen(sc, st, i):
        b = pathlib_.make_bounce(sc, settings, (n,), ev_of(sc))
        s2, _ = b(st, i)
        return s2

    def body_mat(sc, st, i):
        raysb = pathlib_.Rays(st.org, st.dir, st.tmin,
                              jnp.where(st.alive, st.tmax, -1.0))
        hit = pathlib_.trace_scene(sc, raysb)
        surf = pathlib_.compute_surface(sc, raysb, hit)
        ev = ev_of(sc)
        sctx = pathlib_.make_surface_ctx(sc, raysb, surf, ev)
        mat = pathlib_.gather_material(sc, surf, ev, sctx)
        rng, (u,) = rnglib.next_f32_n(st.rng, 1)
        return st._replace(rng=rng,
                           org=st.org._replace(x=st.org.x + mat.base.r * 1e-9),
                           result=st.result._replace(r=st.result.r + mat.p0))

    N0, N1 = 10, 30
    stages = [("trace", body_trace),
              ("trace+surface", body_trace_surf),
              ("trace+surf+mat", body_mat),
              ("shadow", body_shadow),
              ("full_nonee", body_nonee),
              ("full_noregen", body_noregen),
              ("full", body_full)]
    want = os.environ.get("IGNIS_PROFILE_STAGES", "")
    if want:
        sel = want.split(",")
        stages = [(k, b) for k, b in stages if k in sel]
    for name, body in stages:
        t0 = scan_time(body, scene, init, N0)
        t1 = scan_time(body, scene, init, N1)
        per = (t1 - t0) / (N1 - N0)
        print(f"  {name:18s} {per*1e3:8.2f} ms/bounce")


if __name__ == "__main__":
    main()
