"""Benchmark on one NVIDIA GPU (every leg in this one process).

Mirrors the reference protocol (scripts/benchmark.sh + scripts/Benchmark.py:
per-scene Msamples/s, warmup + timed iterations, geometric mean across
scenes), extended with forward+backward (train-step) throughput, a
per-bounce stage breakdown, and the traversal comparisons that decide
which walk the renderer uses:

  scenes     forward Msamples/s on the five generated configuration scenes
             (512x512, spi 8) and forward+backward at 256x256, spi 2
  stages     per-bounce trace / shadow / shade split on diamond_scene 512^2
  trace      BVH walk kernel vs XLA walk, one call each, on a 1080p camera
             wavefront plus as many random rays over the 1.3M-triangle scene
  big        one Runtime.step() at 1920x1080, spi 4, on that scene with the
             kernel and with the XLA walk
  threshold  dense chunk scan vs walk kernel at ~128, ~512 and ~2048
             triangles (sets scene/build.py BVH_THRESHOLD)

Timings end in jax.block_until_ready. Fails (non-zero exit) when JAX finds
no GPU or any leg raises. Prints the device line and each leg's numbers as
the leg ends, then ONE JSON line with all of them.

    python bench.py [--legs scenes,stages,trace,big,threshold]
"""
import argparse
import contextlib
import functools
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent))

CONFIG_SIZE, CONFIG_SPI = 512, 8
BWD_SIZE, BWD_SPI = 256, 2
WARMUP = 1
TIMED = 3
LEGS = ("scenes", "stages", "trace", "big", "threshold")


def device_line() -> dict:
    import jax
    d = jax.devices()[0]
    if d.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {d.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    info = {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": smi}
    print(f"# device: {info}", flush=True)
    return info


def timed(fn, *args, reps=TIMED):
    """Median seconds of `reps` calls after WARMUP calls."""
    import jax
    for _ in range(WARMUP):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def step_seconds(rt, reps=TIMED):
    return timed(lambda: rt.step()._film, reps=reps)


def substitutes():
    from ignis_tpu.scene.fixtures import ENV_TEXTURE
    from ignis_tpu.utils.envgen import ensure_substitute_env
    return {ENV_TEXTURE: str(ensure_substitute_env(4096, 2048))}


def load(scene: dict, **overrides):
    import ignis_tpu
    return ignis_tpu.loadFromString(json.dumps(scene), **overrides)


def bwd_seconds(rt):
    """Forward+backward train step (L2 image loss wrt the material colour
    table, rematerialized path)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from ignis_tpu.parallel.mesh import loss_fn

    settings = dataclasses.replace(rt.settings, remat=True)
    target = jnp.zeros((settings.height, settings.width, 3), jnp.float32)
    # the scene is an argument: captured, its arrays would be compiled in
    # as constants
    vg = jax.jit(jax.value_and_grad(
        lambda p, sc: loss_fn(p, sc, settings, target, jnp.uint32(0),
                              jnp.uint32(0))))
    return timed(vg, {"base": rt.scene.materials.base}, rt.scene)


def geomean(vals):
    return math.exp(sum(math.log(v) for v in vals) / len(vals))


def leg_scenes(detail):
    from ignis_tpu.scene.fixtures import CONFIG_SCENES
    subs = substitutes()
    fwd, bwd, fwd_small = [], [], []
    for name, make in CONFIG_SCENES.items():
        rt = load(make(CONFIG_SIZE), spi=CONFIG_SPI, texture_substitutes=subs)
        n = CONFIG_SIZE * CONFIG_SIZE * CONFIG_SPI
        fwd.append(n / step_seconds(rt) / 1e6)
        detail[name + "_fwd"] = fwd[-1]
        rt = load(make(BWD_SIZE), spi=BWD_SPI, texture_substitutes=subs)
        n = BWD_SIZE * BWD_SIZE * BWD_SPI
        fwd_small.append(n / step_seconds(rt) / 1e6)
        bwd.append(n / bwd_seconds(rt) / 1e6)
        detail[name + "_fwd_256"] = fwd_small[-1]
        detail[name + "_bwd_256"] = bwd[-1]
    detail["bwd_geomean_256"] = geomean(bwd)
    detail["bwd_over_fwd_geomean"] = geomean(bwd) / geomean(fwd_small)
    return geomean(fwd)


def leg_stages(detail):
    """Per-bounce trace/shade/shadow split on diamond_scene 512^2, from
    scans of 10 and 30 bounces differenced."""
    import jax
    import jax.numpy as jnp
    from ignis_tpu.core import rng as rnglib
    from ignis_tpu.core.sampler import sample_pixel_offsets
    from ignis_tpu.models import camera as cameralib
    from ignis_tpu.models.texture import make_texture_evaluator
    from ignis_tpu.scene.fixtures import diamond_scene
    from ignis_tpu.techniques import path as pathlib_

    rt = load(diamond_scene(512), spi=8)
    scene, settings = rt.scene, rt.settings
    w, h = settings.width, settings.height
    x = jnp.arange(w * h, dtype=jnp.int32) % w
    y = jnp.arange(w * h, dtype=jnp.int32) // w
    st0 = rnglib.seed(jnp.uint32(0), jnp.uint32(0), jnp.uint32(0),
                      x.astype(jnp.uint32), y.astype(jnp.uint32),
                      jnp.uint32(settings.seed))
    st0, (rx, ry) = sample_pixel_offsets(settings.pixel_sampler, st0,
                                         jnp.uint32(0), x, y)
    rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry,
                                   rng_state=st0)
    init = pathlib_.initial_state(rays, st0)
    n = x.shape[0]
    ev = make_texture_evaluator(settings.texture_descs, scene.textures)

    def scan_time(body, n_steps):
        def prog(sc, s0):
            def step(s, i):
                return body(sc, s, i), None
            out, _ = jax.lax.scan(step, s0, jnp.arange(n_steps))
            return out.result.r.sum() + out.org.x.sum()
        return timed(jax.jit(prog), scene, init, reps=2)

    def body_trace(sc, s, i):
        r = pathlib_.Rays(s.org, s.dir, s.tmin,
                          jnp.where(s.alive, s.tmax, -1.0))
        hit = pathlib_.trace_scene(sc, r)
        return s._replace(org=s.org._replace(x=s.org.x + hit.t * 1e-9),
                          result=s.result._replace(r=s.result.r + hit.u))

    def body_shadow(sc, s, i):
        r = pathlib_.Rays(s.org, s.dir, s.tmin,
                          jnp.where(s.alive, s.tmax, -1.0))
        occ = pathlib_.occluded_scene(sc, r)
        return s._replace(result=s.result._replace(
            r=s.result.r + occ.astype(jnp.float32)))

    def body_full(sc, s, i):
        b = pathlib_.make_bounce(sc, settings, (n,), ev,
                                 regen=(x, y, jnp.uint32(0), jnp.uint32(0)))
        return b(s, i)[0]

    out = {"lanes": n}
    for name, body in [("trace", body_trace), ("shadow", body_shadow),
                       ("full_bounce", body_full)]:
        out[name + "_ms_per_bounce"] = \
            (scan_time(body, 30) - scan_time(body, 10)) / 20 * 1e3
    out["shade_ms_per_bounce"] = (out["full_bounce_ms_per_bounce"]
                                  - out["trace_ms_per_bounce"]
                                  - out["shadow_ms_per_bounce"])
    detail["stages_diamond_512"] = out


def wavefront_rays(rt, seed=0):
    """One camera wavefront (pixel centres) plus as many random rays from
    inside the scene bounds."""
    import jax
    import jax.numpy as jnp
    from ignis_tpu.core.vec import Vec3
    from ignis_tpu.models.camera import generate_rays
    from ignis_tpu.ops.intersect import FLT_MAX, Rays
    s, sc = rt.settings, rt.scene
    n = s.width * s.height
    x = jnp.arange(n, dtype=jnp.int32) % s.width
    y = jnp.arange(n, dtype=jnp.int32) // s.width
    half = jnp.full((n,), 0.5, jnp.float32)
    cam = generate_rays(sc.camera, s, x, y, half, half)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    c = jnp.stack([sc.scene_center.x, sc.scene_center.y, sc.scene_center.z])
    o = c + jax.random.uniform(k1, (n, 3), minval=-1.0, maxval=1.0) \
        * sc.scene_radius
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    cat = lambda a, b: jnp.concatenate([jnp.broadcast_to(a, (n,)), b])
    return Rays(Vec3(cat(cam.org.x, o[:, 0]), cat(cam.org.y, o[:, 1]),
                     cat(cam.org.z, o[:, 2])),
                Vec3(cat(cam.dir.x, d[:, 0]), cat(cam.dir.y, d[:, 1]),
                     cat(cam.dir.z, d[:, 2])),
                jnp.zeros((2 * n,), jnp.float32),
                jnp.full((2 * n,), FLT_MAX, jnp.float32))


def trace_times(rt, walks=("auto", "xla")) -> dict:
    """Closest-hit and any-hit ms per call for each walk on
    wavefront_rays(rt)."""
    import jax
    from ignis_tpu.ops.bvh_gpu import trace_bvh
    sc, rays = rt.scene, wavefront_rays(rt)
    vis = sc.tri_attr.shadow_visible
    out = {}
    for walk in walks:
        name = "kernel" if walk == "auto" else walk
        c = jax.jit(lambda r, s, b, w=walk: trace_bvh(r, s, b, kernel=w))
        a = jax.jit(lambda r, s, b, v, w=walk: trace_bvh(
            r, s, b, any_hit=True, shadow_visible=v, kernel=w))
        out[name + "_closest_ms"] = timed(c, rays, sc.tris, sc.bvh) * 1e3
        out[name + "_anyhit_ms"] = timed(a, rays, sc.tris, sc.bvh, vis) * 1e3
    out["rays"] = int(rays.tmin.shape[0])
    return out


def _clear_compiled():
    from ignis_tpu.render import session
    from ignis_tpu.techniques import path
    for f in (path._compiled_cascade, path.cascade_lane_fn,
              session._compiled_iteration):
        f.cache_clear()


@contextlib.contextmanager
def xla_walk():
    """Route the renderer's BVH traversal through the XLA walk."""
    from ignis_tpu.techniques import path
    orig = path.trace_bvh
    path.trace_bvh = functools.partial(orig, kernel="xla")
    _clear_compiled()
    try:
        yield
    finally:
        path.trace_bvh = orig
        _clear_compiled()


def big_runtime(spi=4):
    from ignis_tpu.scene.fixtures import big_scene
    return load(big_scene(1920, 1080), spi=spi)


def leg_trace(detail):
    detail["trace_bigscene"] = trace_times(big_runtime())


def leg_big(detail):
    rt = big_runtime()
    n = 1920 * 1080 * rt.settings.spi
    detail["bigscene_tris"] = int(rt.scene.tris.v0.x.shape[0])
    t = time.perf_counter()
    rt.step()
    detail["bigscene_first_step_s"] = time.perf_counter() - t
    detail["bigscene_step_ms_kernel"] = step_seconds(rt, reps=2) * 1e3
    with xla_walk():
        detail["bigscene_step_ms_xla_walk"] = \
            step_seconds(rt, reps=1) * 1e3
    detail["bigscene_fwd_msps_kernel"] = \
        n / detail["bigscene_step_ms_kernel"] / 1e3


def leg_threshold(detail):
    """Dense chunk scan vs walk kernel per trace call on uv-spheres of
    ~128, ~512 and ~2048 triangles (diamond_scene layout, 512x512 camera
    wavefront plus as many random rays)."""
    import jax
    from ignis_tpu.ops import intersect as isect
    from ignis_tpu.scene import build
    from ignis_tpu.scene.fixtures import diamond_scene
    out = {}
    for stacks in (8, 16, 32):
        scene = diamond_scene()
        scene["shapes"][2] = {"type": "uvsphere", "name": "gem",
                              "radius": 0.9, "stacks": stacks,
                              "slices": stacks}
        old = build.BVH_THRESHOLD
        build.BVH_THRESHOLD = 0
        try:
            rt = load(scene)
        finally:
            build.BVH_THRESHOLD = old
        sc, rays = rt.scene, wavefront_rays(rt)
        n_tri = int((sc.tri_attr.ent >= 0).sum())
        dense = jax.jit(lambda r, s: isect.intersect_tris_dense(r, s))
        dense_a = jax.jit(lambda r, s, v: isect.occluded_tris_dense(r, s, v))
        row = trace_times(rt, walks=("auto",))
        row["dense_closest_ms"] = timed(dense, rays, sc.tris) * 1e3
        row["dense_anyhit_ms"] = timed(dense_a, rays, sc.tris,
                                       sc.tri_attr.shadow_visible) * 1e3
        row["padded_tris"] = int(sc.tris.v0.x.shape[0])
        out[f"tris_{n_tri}"] = row
    detail["threshold"] = out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--legs", default=",".join(LEGS))
    legs = ap.parse_args().legs.split(",")
    unknown = set(legs) - set(LEGS)
    if unknown:
        raise SystemExit(f"unknown legs {sorted(unknown)}")
    device = device_line()
    detail = {}
    value = None
    for name in legs:
        t = time.perf_counter()
        before = set(detail)
        r = globals()["leg_" + name](detail)
        if name == "scenes":
            value = r
        new = {k: detail[k] for k in detail if k not in before}
        print(f"# leg {name} ({time.perf_counter() - t:.1f} s): "
              f"{json.dumps(new)}", flush=True)
    print(json.dumps({"metric": "fwd_geomean_msamples_per_s",
                      "value": value, "unit": "Msamples/s",
                      "device": device, "detail": detail}))


if __name__ == "__main__":
    main()
