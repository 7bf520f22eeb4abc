#!/usr/bin/env python3
"""Smoke run of the renderer on one NVIDIA GPU: the quickest proof that
the system starts on the card and gives the right answers there.

    python chip_smoke.py            # one card, every phase below
    python chip_smoke.py --four     # the four-card path and its comparison

One card:
  0. card tests: the `gpu`-marked tests, in a child process
     (JAX_PLATFORMS=cuda) that exits before this process touches JAX;
  1. device line: JAX's platform, kind and count, and nvidia-smi's name
     and power limit;
  2. traversal kernel (ops/bvh_gpu.py) against the XLA walk
     (ops/bvh.intersect_bvh) on one 1920x1080 camera wavefront plus as
     many random rays, over the 1.3M-triangle scene: agreement and times;
  3. forward render of that scene at 1920x1080, spi 4, path, max_depth 6,
     through loadFromString -> 3x Runtime.step() -> framebuffer() -> EXR
     written and read back;
  4. one forward+backward train step at 512x512, spi 2, on the generated
     4k environment map, differentiating the material colour table and
     the environment texels;
  5. the same 64x64, spi 4 image rendered on the GPU and on the CPU.

--four runs only render_iteration_sharded_compact (diamond_scene at
1920x1080) and the train_step_sharded loss (diamond_scene at 256x256) on
four cards, each against one card, and prints each card's peak memory.

Exits non-zero, with no result line, if no GPU is found or any phase
fails. The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT = ROOT / ".cache" / "smoke"


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi unavailable ({e}); no NVIDIA GPU here")
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi found no GPU: {r.stderr.strip()}")
    return r.stdout.strip()


def phase0_card_tests():
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    t = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "pytest", "tests", "-m", "gpu",
                        "-q", "-p", "no:cacheprovider"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=900)
    tail = r.stdout.strip().splitlines()[-1:] or [""]
    log(f"[0] card tests: rc={r.returncode} {tail[0]} "
        f"({time.perf_counter() - t:.1f} s)")
    if r.returncode != 0:
        print(r.stdout[-4000:], r.stderr[-4000:], file=sys.stderr)
        fail("gpu-marked tests failed")


def timed(fn, *args, reps: int = 3):
    """(result, median seconds) after one warm-up call; every call ends in
    block_until_ready."""
    import jax
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t)
    return out, statistics.median(ts)


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", -1))


def load_big(spi: int = 4):
    import ignis_tpu
    from ignis_tpu.native import get_lib
    from ignis_tpu.scene.fixtures import big_scene
    t = time.perf_counter()
    rt = ignis_tpu.loadFromString(json.dumps(big_scene(1920, 1080)), spi=spi)
    log(f"    scene: {rt.scene.tris.v0.x.shape[0]} triangles, "
        f"{rt.scene.bvh.child.shape[0]} BVH8 nodes, load+build "
        f"{time.perf_counter() - t:.1f} s (set-up, "
        f"{'C++' if get_lib() else 'numpy'} BVH builder)")
    return rt


def phase2_kernel(rt):
    import jax
    import numpy as np
    from ignis_tpu.ops.bvh import intersect_bvh
    from bench import wavefront_rays
    from ignis_tpu.ops.bvh_gpu import trace_bvh
    sc = rt.scene
    rays = wavefront_rays(rt)
    vis = sc.tri_attr.shadow_visible
    kc = jax.jit(lambda r, s, b: trace_bvh(r, s, b))
    ka = jax.jit(lambda r, s, b, v: trace_bvh(r, s, b, any_hit=True,
                                              shadow_visible=v))
    xc = jax.jit(lambda r, s, b: intersect_bvh(r, s, b))
    xa = jax.jit(lambda r, s, b, v: intersect_bvh(r, s, b, any_hit=True,
                                                  shadow_visible=v))
    t = time.perf_counter()
    hk, tkc = timed(kc, rays, sc.tris, sc.bvh)
    log(f"    kernel compile+first call {time.perf_counter() - t:.1f} s")
    ok_, tka = timed(ka, rays, sc.tris, sc.bvh, vis)
    hx, txc = timed(xc, rays, sc.tris, sc.bvh, reps=2)
    ox_, txa = timed(xa, rays, sc.tris, sc.bvh, vis, reps=2)
    n = rays.tmin.shape[0]
    pk, px = np.asarray(hk.prim), np.asarray(hx.prim)
    agree = float((pk == px).mean())
    both = (pk == px) & (px >= 0)
    rtol, atol = 1e-5, 1e-7   # atol: barycentrics that are exactly 0

    def excess(a, b):
        """max(|a - b| - rtol |b|) over agreeing hits; <= atol passes."""
        a, b = np.asarray(a)[both], np.asarray(b)[both]
        return float(np.max(np.abs(a - b) - rtol * np.abs(b), initial=0.0))
    et, eu, ev = excess(hk.t, hx.t), excess(hk.u, hx.u), excess(hk.v, hx.v)
    occ_agree = float((np.asarray(ok_) == np.asarray(ox_)).mean())
    log(f"[2] {n} rays ({both.sum()} agreeing hits): closest prim agreement "
        f"{agree:.6f}; max(|d| - {rtol:g}|ref|) t {et:.2e} u {eu:.2e} "
        f"v {ev:.2e} (atol {atol:g}); any-hit agreement {occ_agree:.6f} "
        f"(occluded {float(np.asarray(ox_).mean()):.4f})")
    log(f"    closest: kernel {tkc * 1e3:.2f} ms, XLA walk {txc * 1e3:.2f} ms;"
        f" any-hit: kernel {tka * 1e3:.2f} ms, XLA walk {txa * 1e3:.2f} ms")
    if agree < 0.999 or occ_agree < 0.999:
        fail("traversal kernel disagrees with the XLA walk")
    if max(et, eu, ev) > atol:
        fail(f"t/u/v on agreeing hits differ beyond rtol {rtol:g}, "
             f"atol {atol:g}")


def phase3_render(rt):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ignis_tpu.render.session import _tiled_lane_coords
    from ignis_tpu.techniques.path import _compiled_cascade
    from ignis_tpu.utils.image import load_image, save_image
    t = time.perf_counter()
    rt.step()
    compile_s = time.perf_counter() - t
    steps = []
    for _ in range(2):
        t = time.perf_counter()
        rt.step()
        steps.append(time.perf_counter() - t)
    img = rt.framebuffer(normalized=True)
    OUT.mkdir(parents=True, exist_ok=True)
    path = OUT / "render_1080p.exr"
    save_image(path, img)
    back = load_image(path)
    s = rt.settings
    x, y = _tiled_lane_coords(s.width, s.height)
    exe = _compiled_cascade(s, s.width * s.height).lower(
        rt.scene, x, y, jnp.uint32(0), jnp.uint32(0)).compile()
    mem = exe.memory_analysis()
    log(f"[3] render 1920x1080 spi {s.spi} depth {s.max_depth}: first step "
        f"{compile_s:.1f} s (compile, set-up), step median "
        f"{statistics.median(steps) * 1e3:.1f} ms over {len(steps)}; "
        f"image mean {float(img.mean()):.5f}")
    log(f"    memory_analysis: temp {mem.temp_size_in_bytes} B, argument "
        f"{mem.argument_size_in_bytes} B, output {mem.output_size_in_bytes} "
        f"B; peak_bytes_in_use {peak_bytes(jax.devices()[0])}")
    if not np.isfinite(img).all() or not img.mean() > 0:
        fail("rendered image is not finite and non-zero")
    if back.shape != img.shape or not np.array_equal(back, img):
        fail("EXR read back differs from the framebuffer")


def train_runtime(size: int = 512, spi: int = 2):
    import ignis_tpu
    from ignis_tpu.scene.fixtures import ENV_TEXTURE, env_train_scene
    from ignis_tpu.utils.envgen import ensure_substitute_env
    env = ensure_substitute_env(4096, 2048)
    return ignis_tpu.loadFromString(
        json.dumps(env_train_scene(size)), spi=spi,
        texture_substitutes={ENV_TEXTURE: str(env)})


def remat(settings):
    import dataclasses
    return dataclasses.replace(settings, remat=True)


def phase4_train():
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ignis_tpu.render.session import render_iteration
    rt = train_runtime()
    settings, scene = remat(rt.settings), rt.scene
    tex_i = max(range(len(scene.textures)),
                key=lambda i: scene.textures[i].image.size)
    env_shape = scene.textures[tex_i].image.shape

    # the scene is an argument: captured, its arrays (the environment CDFs
    # among them) would be compiled in as constants
    def loss(p, scene):
        tex = list(scene.textures)
        tex[tex_i] = tex[tex_i]._replace(image=p["env"])
        sc = scene._replace(
            materials=scene.materials._replace(base=p["base"]),
            textures=tuple(tex))
        img = render_iteration(sc, settings, jnp.uint32(0), jnp.uint32(0))
        return jnp.mean((img - 0.5) ** 2)

    params = {"base": scene.materials.base,
              "env": scene.textures[tex_i].image}
    step = jax.jit(jax.value_and_grad(loss))
    t = time.perf_counter()
    (val, grads) = jax.block_until_ready(step(params, scene))
    compile_s = time.perf_counter() - t
    (val, grads), step_s = timed(step, params, scene, reps=2)
    log(f"[4] train step 512x512 spi 2 (env {env_shape}): first call "
        f"{compile_s:.1f} s (compile, set-up), step {step_s * 1e3:.1f} ms, "
        f"loss {float(val):.6f}, peak_bytes_in_use "
        f"{peak_bytes(jax.devices()[0])}")
    for name, g in (("base", grads["base"].r), ("env", grads["env"])):
        g = np.asarray(g)
        log(f"    |d loss/d {name}| max {float(np.abs(g).max()):.3e}, "
            f"non-zero {int((g != 0).sum())}/{g.size}")
        if not np.isfinite(g).all() or not np.abs(g).max() > 0:
            fail(f"gradient wrt {name} is not finite and non-zero")


def phase5_gpu_vs_cpu():
    import jax
    import numpy as np
    import ignis_tpu
    from ignis_tpu.scene.fixtures import diamond_scene
    text = json.dumps(diamond_scene(64))

    def render():
        rt = ignis_tpu.loadFromString(text, spi=4)
        rt.step()
        return rt.framebuffer(normalized=True)

    g = render()
    with jax.default_device(jax.devices("cpu")[0]):
        c = render()
    mean_rel = abs(float(g.mean()) - float(c.mean())) / float(c.mean())
    close = float((np.abs(g - c) <= 1e-2).all(axis=-1).mean())
    log(f"[5] 64x64 spi 4 GPU vs CPU: image means {float(g.mean()):.6f} vs "
        f"{float(c.mean()):.6f} (rel {mean_rel:.2e}); pixels within 1e-2: "
        f"{close:.4f}; max abs diff {float(np.abs(g - c).max()):.3e}")
    if mean_rel > 1e-3 or close < 0.99:
        fail("GPU and CPU images disagree")


def four_cards(size=(1920, 1080), train_size: int = 256):
    import jax
    import jax.numpy as jnp
    import numpy as np
    from ignis_tpu.parallel.mesh import (loss_fn, make_mesh,
                                         render_iteration_sharded_compact,
                                         train_step_sharded)
    from ignis_tpu.render.session import _render_iteration_compacting
    devs = jax.devices()
    if len(devs) < 4:
        fail(f"--four needs 4 devices, found {len(devs)}")
    import ignis_tpu
    from ignis_tpu.scene.fixtures import diamond_scene
    mesh = make_mesh(devices=devs[:4])
    it, fr = jnp.uint32(0), jnp.uint32(0)

    def load(w, h):
        scene = diamond_scene()
        scene["film"] = {"size": [w, h]}
        return ignis_tpu.loadFromString(json.dumps(scene), spi=2)

    rt = load(*size)
    sharded = jax.jit(lambda sc: render_iteration_sharded_compact(
        sc, rt.settings, it, fr, mesh))
    t = time.perf_counter()
    img4, t4 = timed(sharded, rt.scene, reps=2)
    c4 = time.perf_counter() - t - 3 * t4
    peaks = [peak_bytes(d) for d in devs[:4]]
    t = time.perf_counter()
    img1, t1 = timed(lambda sc: _render_iteration_compacting(
        sc, rt.settings, it, fr), rt.scene, reps=2)
    c1 = time.perf_counter() - t - 3 * t1
    a, b = np.asarray(img4), np.asarray(img1)
    err = float(np.max(np.abs(a - b) - 2e-4 * np.abs(b)))
    log(f"[4x] sharded compact render, diamond_scene {size[0]}x{size[1]} "
        f"spi 2: 4 cards {t4 * 1e3:.1f} ms, 1 card {t1 * 1e3:.1f} ms "
        f"(compile ~{c4:.1f} s / ~{c1:.1f} s, set-up); max(|d| - 2e-4|ref|) "
        f"{err:.3e} (atol 2e-5); image mean {float(b.mean()):.6f}")
    log(f"    peak_bytes_in_use per card after the sharded render {peaks}")
    if not np.allclose(a, b, rtol=2e-4, atol=2e-5):
        fail("sharded film differs from one card")

    trt = load(train_size, train_size)
    settings = remat(trt.settings)
    target = jnp.full((settings.height, settings.width, 3), 0.5, jnp.float32)
    lr = jnp.float32(1e-2)
    t = time.perf_counter()
    (loss4, _), s4 = timed(lambda sc: train_step_sharded(
        sc, settings, target, it, fr, lr, mesh), trt.scene, reps=2)
    peaks = [peak_bytes(d) for d in devs[:4]]
    c4 = time.perf_counter() - t - 3 * s4
    one = jax.jit(jax.value_and_grad(lambda p, sc: loss_fn(
        p, sc, settings, target, it, fr)))
    t = time.perf_counter()
    (loss1, _), s1 = timed(one, {"base": trt.scene.materials.base},
                           trt.scene, reps=2)
    c1 = time.perf_counter() - t - 3 * s1
    loss4, loss1 = float(loss4), float(loss1)
    log(f"[4x] train step, diamond_scene {train_size}x{train_size} spi 2: "
        f"loss {loss4:.8f} on 4 cards vs {loss1:.8f} on one (rel "
        f"{abs(loss4 - loss1) / abs(loss1):.2e}, rtol 1e-4); step 4 cards "
        f"{s4 * 1e3:.1f} ms, value_and_grad 1 card {s1 * 1e3:.1f} ms "
        f"(compile ~{c4:.1f} s / ~{c1:.1f} s, set-up)")
    log(f"    peak_bytes_in_use per card after the sharded step {peaks}")
    if not np.isclose(loss4, loss1, rtol=1e-4):
        fail("sharded loss differs from one card")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparison")
    ap.add_argument("--phases", default="012345",
                    help="subset of the one-card phases to run")
    args = ap.parse_args()
    if not (ROOT / "ignis_tpu").is_dir():
        fail("the ignis_tpu package is not beside this script")
    smi = nvidia_smi_line()
    if "0" in args.phases and not args.four:
        phase0_card_tests()

    import jax
    devs = jax.devices()
    d0 = devs[0]
    if d0.platform != "gpu":
        fail(f"JAX found no GPU (platform {d0.platform})")
    log(f"[1] jax {jax.__version__}: platform {d0.platform}, kind "
        f"{d0.device_kind}, count {len(devs)}")
    log(f"    nvidia-smi: {smi}")
    if args.four:
        four_cards()
    else:
        rt = load_big() if set(args.phases) & {"2", "3"} else None
        if "2" in args.phases:
            phase2_kernel(rt)
        if "3" in args.phases:
            phase3_render(rt)
        if "4" in args.phases:
            phase4_train()
        if "5" in args.phases:
            phase5_gpu_vs_cpu()
    print(json.dumps({"ok": True, "device": {"platform": d0.platform,
                                             "kind": d0.device_kind,
                                             "count": len(devs)}}),
          flush=True)


if __name__ == "__main__":
    main()
