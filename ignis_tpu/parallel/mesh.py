"""Multi-chip scaling: shard the ray wavefront over a device mesh.

The reference is single-device (SURVEY.md §2e); this module is the new
ground: data-parallel rays/pixels over the cards of a host with the scene
replicated in each card's memory, film gathered, and parameter gradients
(differentiable rendering) all-reduced by XLA from the same sharding
annotations.

Design: one mesh axis "rays". Pixel lanes are sharded along it; SceneData is
replicated. Inside jit, XLA inserts the collectives; the film segment each
chip produces is its own lane slice, so the only cross-chip traffic is the
gradient all-reduce in the backward pass.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import rng as rnglib
from ..models import camera as cameralib
from ..scenedata import RenderSettings, SceneData
from ..techniques import dispatch_technique


def _shard_map(f, mesh, in_specs, out_specs):
    """jax.shard_map with replication checking off (the cascade mixes
    replicated-initialized accumulators with per-lane updates, which the
    checker flags even though the per-shard program is correct)."""
    return jax.shard_map(f, mesh=mesh, in_specs=in_specs,
                         out_specs=out_specs, check_vma=False)


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    if devices is None:
        devices = jax.devices()[:n_devices] if n_devices else jax.devices()
    return Mesh(np.array(devices), ("rays",))


def _lane_sharding(mesh: Mesh):
    return NamedSharding(mesh, P("rays"))


def _replicated(mesh: Mesh):
    return NamedSharding(mesh, P())


def _sharded_cascade(scene: SceneData, settings: RenderSettings, iteration,
                     frame, mesh: Mesh, lane_fn):
    """[h, w, 3] mean radiance from `lane_fn(scene, x, y, it, fr) -> (r, g,
    b)` run under shard_map on each card's slice of the tiled lanes
    (scene replicated, compaction local to each card: zero collectives
    until the film all-gather)."""
    from ..render.session import _tiled_lane_coords

    w, h = settings.width, settings.height
    nd = int(np.prod(mesh.devices.shape))
    assert (h * w) % nd == 0, f"film lanes {h * w} not divisible by {nd}"
    x, y = _tiled_lane_coords(w, h)

    def worker(scene_, x_, y_, it_, fr_):
        return jnp.stack(lane_fn(scene_, x_, y_, it_, fr_), axis=-1)

    # check_vma=False: the cascade's scan carries mix replicated-initialized
    # accumulators with per-lane (varying) updates, which the replication
    # checker flags even though the program is correct per-shard
    out = _shard_map(worker, mesh=mesh,
                     in_specs=(P(), P("rays"), P("rays"), P(), P()),
                     out_specs=P("rays"))(
        scene, jnp.asarray(x), jnp.asarray(y),
        jnp.asarray(iteration, jnp.uint32), jnp.asarray(frame, jnp.uint32))
    TILE = 32
    if (w % TILE == 0) and (h % TILE == 0):
        out = out.reshape(h // TILE, w // TILE, TILE, TILE, 3) \
            .transpose(0, 2, 1, 3, 4)
    return out.reshape(h, w, 3) * (1.0 / settings.spi)


@functools.partial(jax.jit, static_argnames=("settings", "mesh"))
def render_iteration_sharded_compact(scene: SceneData,
                                     settings: RenderSettings,
                                     iteration, frame, mesh: Mesh):
    """Compacting-cascade render sharded with shard_map: lanes split over
    the "rays" axis, scene replicated, and EACH CARD runs the full
    shrinking-bucket cascade on its own lane slice. This is the
    multi-card production path for the path/volpath techniques; the
    per-shard program is identical to the single-device cascade."""
    from ..techniques.path import cascade_lane_fn

    n = settings.width * settings.height
    fn = cascade_lane_fn(settings, n // int(np.prod(mesh.devices.shape)))
    img = _sharded_cascade(scene, settings, iteration, frame, mesh, fn)
    return jax.lax.with_sharding_constraint(img, _replicated(mesh))


@functools.partial(jax.jit, static_argnames=("settings", "mesh"))
def render_iteration_sharded(scene: SceneData, settings: RenderSettings,
                             iteration, frame, mesh: Mesh):
    """Sharded analog of render.session.render_iteration.

    Lane axis (h*w) is sharded over the mesh "rays" axis; scene replicated.
    Returns the full [h, w, 3] film (XLA gathers lane slices).
    """
    w, h = settings.width, settings.height
    n = h * w
    x = jnp.broadcast_to(jnp.arange(w, dtype=jnp.int32)[None, :], (h, w)).reshape(-1)
    y = jnp.broadcast_to(jnp.arange(h, dtype=jnp.int32)[:, None], (h, w)).reshape(-1)
    lane_sh = _lane_sharding(mesh)
    x = jax.lax.with_sharding_constraint(x, lane_sh)
    y = jax.lax.with_sharding_constraint(y, lane_sh)
    scene = jax.lax.with_sharding_constraint(
        scene, _replicated(mesh))

    technique = dispatch_technique(settings.technique)
    from ..models.texture import make_texture_evaluator
    eval_texture = make_texture_evaluator(settings.texture_descs,
                                          scene.textures)
    acc = [jnp.zeros(n, jnp.float32)] * 3
    for s in range(settings.spi):
        state = rnglib.seed(jnp.uint32(s), iteration.astype(jnp.uint32),
                            frame.astype(jnp.uint32), x.astype(jnp.uint32),
                            y.astype(jnp.uint32), jnp.uint32(settings.seed))
        state, (rx, ry) = rnglib.next_f32_n(state, 2)
        rays = cameralib.generate_rays(scene.camera, settings, x, y, rx, ry)
        color = technique(scene, settings, rays, state,
                          eval_texture=eval_texture)
        acc = [acc[0] + color.r, acc[1] + color.g, acc[2] + color.b]

    inv = 1.0 / settings.spi
    img = jnp.stack([a.reshape(h, w) for a in acc], axis=-1)
    # replicate the film: each process/device ends with a full local copy
    # (XLA inserts the lane all-gather)
    return jax.lax.with_sharding_constraint(img * inv, _replicated(mesh))


def loss_fn(diff_materials, scene: SceneData, settings: RenderSettings,
            target, iteration, frame, mesh: Optional[Mesh] = None):
    """L2 image loss wrt differentiable material parameters (inverse
    rendering / gradient path for the BASELINE north star).

    With `mesh`, the path technique's differentiable cascade runs under
    shard_map, one lane slice per card. (render_iteration inside a jit
    over a mesh makes its lane coordinates replicated, so GSPMD would run
    every lane on every card.)"""
    scene = scene._replace(materials=scene.materials._replace(
        base=diff_materials["base"]))
    import dataclasses

    from ..render.session import render_iteration

    # The forward-only progressive renderer uses an early-exit while_loop,
    # which reverse-mode AD cannot differentiate; route the gradient path
    # through the rematerialized lax.scan variant instead.
    if not settings.remat:
        settings = dataclasses.replace(settings, remat=True)
    if mesh is None:
        img = render_iteration(scene, settings, iteration, frame)
    else:
        if settings.technique not in ("path", "pt"):
            raise NotImplementedError(
                "sharded training runs the path technique only, got "
                f"{settings.technique!r}")
        from ..models.texture import make_texture_evaluator
        from ..techniques.path import path_trace_cascade_diff

        def lanes(sc, x, y, it, fr):
            ev = make_texture_evaluator(settings.texture_descs, sc.textures)
            return tuple(path_trace_cascade_diff(sc, settings, x, y, it, fr,
                                                 ev))
        img = _sharded_cascade(scene, settings, iteration, frame, mesh,
                               lanes)
    return jnp.mean((img - target) ** 2)


@functools.partial(jax.jit, static_argnames=("settings", "mesh"))
def train_step_sharded(scene: SceneData, settings: RenderSettings,
                       target, iteration, frame, lr, mesh: Mesh):
    """One differentiable-rendering optimization step, sharded over rays.

    Gradients of the replicated material table are all-reduced by XLA
    (the dp-grad psum of SURVEY.md §2e's plan).
    """
    scene = jax.lax.with_sharding_constraint(scene, _replicated(mesh))
    target = jax.lax.with_sharding_constraint(target, _replicated(mesh))
    params = {"base": scene.materials.base}
    loss, grads = jax.value_and_grad(loss_fn)(params, scene, settings, target,
                                              iteration, frame, mesh)
    new_base = jax.tree_util.tree_map(lambda p, g: p - lr * g,
                                      params["base"], grads["base"])
    new_scene = scene._replace(materials=scene.materials._replace(base=new_base))
    return loss, new_scene
