"""Multi-device sharding + differentiability tests (8-CPU virtual mesh).

The mesh-shape analog of the reference's CPU/GPU duality testing: the same
scene must produce consistent images on 1 device and on an 8-way ray-sharded
mesh, and the differentiable train step must run sharded with finite grads.
"""
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import ignis_tpu
from conftest import env_substitutes, fixture_scene
from ignis_tpu.parallel.mesh import (make_mesh, render_iteration_sharded,
                                     train_step_sharded)


def small_scene(size=64, max_depth=3):
    return {
        "technique": {"type": "path", "max_depth": max_depth},
        "camera": {"type": "perspective", "fov": 60, "near_clip": 0.1,
                   "far_clip": 100,
                   "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3,
                                 0, 0, 0, 1]},
        "film": {"size": [size, size]},
        "bsdfs": [
            {"type": "diffuse", "name": "white", "reflectance": [0.7, 0.5, 0.3]},
        ],
        "shapes": [
            {"type": "rectangle", "name": "floor", "width": 4, "height": 4},
            {"type": "sphere", "name": "ball", "radius": 0.5},
        ],
        "entities": [
            {"name": "floor", "shape": "floor", "bsdf": "white",
             "transform": [{"rotate": [-90, 0, 0]}, {"translate": [0, -1, 0]}]},
            {"name": "ball", "shape": "ball", "bsdf": "white"},
        ],
        "lights": [
            {"type": "point", "name": "l", "position": [1, 2, 2], "power": 30},
            {"type": "env", "name": "e", "radiance": [0.2, 0.2, 0.3]},
        ],
    }


@pytest.fixture(scope="module")
def rt():
    return ignis_tpu.loadFromString(json.dumps(small_scene()))


def test_sharded_matches_single(rt):
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    mesh = make_mesh()
    img_sharded = render_iteration_sharded(rt.scene, rt.settings,
                                           jnp.uint32(0), jnp.uint32(0), mesh)
    from ignis_tpu.render.session import render_iteration
    img_single = render_iteration(rt.scene, rt.settings,
                                  jnp.uint32(0), jnp.uint32(0))
    np.testing.assert_allclose(np.asarray(img_sharded),
                               np.asarray(img_single), atol=1e-5)


def test_train_step_sharded(rt):
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    mesh = make_mesh()
    settings = rt.settings.__class__(**{**rt.settings.__dict__, "remat": True})
    target = jnp.zeros((settings.height, settings.width, 3), jnp.float32)
    loss, new_scene = train_step_sharded(rt.scene, settings, target,
                                         jnp.uint32(0), jnp.uint32(0),
                                         jnp.float32(1e-2), mesh)
    assert np.isfinite(float(loss))
    # The albedo parameter must have moved (gradient nonzero)
    before = np.asarray(rt.scene.materials.base.r)
    after = np.asarray(new_scene.materials.base.r)
    assert not np.allclose(before, after)


def test_sharded_loss_and_grads_match_single(rt):
    """loss_fn with a mesh (lanes sharded, one differentiable cascade per
    device) gives the single-device loss and material gradients."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    from ignis_tpu.parallel.mesh import loss_fn
    mesh = make_mesh()
    settings = _remat(rt.settings)
    target = jnp.full((settings.height, settings.width, 3), 0.5, jnp.float32)
    params = {"base": rt.scene.materials.base}
    it = jnp.uint32(0)
    vg = lambda m: jax.jit(jax.value_and_grad(
        lambda p: loss_fn(p, rt.scene, settings, target, it, it, m)))(params)
    (l1, g1), (l8, g8) = vg(None), vg(mesh)
    np.testing.assert_allclose(float(l8), float(l1), rtol=1e-5)
    for a, b in zip(jax.tree_util.tree_leaves(g8),
                    jax.tree_util.tree_leaves(g1)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-7)


def test_sharded_loss_rejects_other_techniques(rt):
    """The sharded loss runs only the path technique's cascade; another
    technique is refused instead of running every lane on every device."""
    from ignis_tpu.parallel.mesh import loss_fn
    mesh = make_mesh(devices=jax.devices()[:1])
    settings = rt.settings.__class__(
        **{**rt.settings.__dict__, "remat": True, "technique": "volpath"})
    target = jnp.zeros((settings.height, settings.width, 3), jnp.float32)
    with pytest.raises(NotImplementedError, match="volpath"):
        loss_fn({"base": rt.scene.materials.base}, rt.scene, settings,
                target, jnp.uint32(0), jnp.uint32(0), mesh)


def test_gradient_finite_difference(rt):
    """Pixel-gradient check vs finite differences on the albedo
    (BASELINE.md gradient gate, small version)."""
    from ignis_tpu.render.session import render_iteration
    settings = rt.settings.__class__(**{**rt.settings.__dict__, "remat": True})
    scene = rt.scene

    def loss_of(base_r):
        mat = scene.materials._replace(
            base=scene.materials.base._replace(r=base_r))
        img = render_iteration(scene._replace(materials=mat), settings,
                               jnp.uint32(0), jnp.uint32(0))
        return jnp.mean(img)

    base = scene.materials.base.r
    g = jax.grad(loss_of)(base)
    eps = 1e-3
    for i in range(base.shape[0]):
        fd = (loss_of(base.at[i].add(eps)) - loss_of(base.at[i].add(-eps))) / (2 * eps)
        np.testing.assert_allclose(np.asarray(g)[i], float(fd),
                                   rtol=0.05, atol=1e-5)


def test_tonemap_ops():
    from ignis_tpu.render.tonemap import image_info, tonemap
    rs = np.random.RandomState(0)
    img = jnp.asarray(rs.rand(32, 32, 3).astype(np.float32)) * 4.0
    for m in range(7):
        out = tonemap(img, method=m)
        assert out.shape == img.shape
        assert float(jnp.min(out)) >= 0 and float(jnp.max(out)) <= 1
    info = image_info(img)
    assert float(info.min) >= 0
    assert float(info.max) <= 4.0 + 1e-5
    assert int(info.nan_count) == 0
    assert info.histogram.shape == (4, 64)


def test_sharded_compact_matches_single():
    """shard_map compacting cascade (per-chip local compaction) must match
    the single-device cascade and the plain sharded render."""
    if len(jax.devices()) < 2:
        pytest.skip("needs multiple devices")
    import ignis_tpu
    from ignis_tpu.parallel.mesh import render_iteration_sharded_compact
    from ignis_tpu.render.session import _render_iteration_compacting

    sc = small_scene()
    sc["film"] = {"size": [64, 64]}   # 4096 lanes = 512/device on 8
    rt = ignis_tpu.loadFromString(json.dumps(sc))
    mesh = make_mesh()
    img_sh = np.asarray(render_iteration_sharded_compact(
        rt.scene, rt.settings, jnp.uint32(0), jnp.uint32(0), mesh))
    img_1 = np.asarray(_render_iteration_compacting(
        rt.scene, rt.settings, jnp.uint32(0), jnp.uint32(0)))
    np.testing.assert_allclose(img_sh, img_1, rtol=2e-4, atol=2e-5)


BASELINE_SCENES = ["single_triangle", "primitives", "diamond_scene",
                   "environment_map", "participating_media"]


def _fd_check(loss_of, p0, rows=2, eps=1e-3, rtol=0.08):
    """Reverse-mode grad vs central finite differences on the top-|g|
    entries of an arbitrary-rank parameter array (deterministic RNG per
    (iteration, frame) makes FD exact on the same sample set)."""
    g = np.asarray(jax.grad(loss_of)(p0))
    assert np.isfinite(g).all()
    flat = np.abs(g).reshape(-1)
    order = np.argsort(-flat)[:rows]
    assert flat[order[0]] > 0, "no differentiable signal"
    for i in order:
        idx = np.unravel_index(int(i), g.shape)
        fd = (float(loss_of(p0.at[idx].add(eps)))
              - float(loss_of(p0.at[idx].add(-eps)))) / (2 * eps)
        np.testing.assert_allclose(g[idx], fd, rtol=rtol, atol=1e-6)


def _remat(settings):
    return settings.__class__(**{**settings.__dict__, "remat": True})


@pytest.mark.parametrize("name", BASELINE_SCENES)
def test_gradient_gate_baseline_scenes(name):
    """BASELINE.md gradient gate: reverse-mode gradients on each of the
    five config scenes (generated stand-ins, tests/fixtures/scenes) must
    match central finite differences at 64x64 film. Differentiates the
    material albedo table; environment_map has no BSDFs at all, so there
    the parameter is the env radiance scale."""
    rt = ignis_tpu.loadFromFile(fixture_scene(name), width=64, height=64,
                                spi=1, texture_substitutes=env_substitutes())
    settings = _remat(rt.settings)
    scene = rt.scene
    use_light = name == "environment_map"

    def loss_of(p):
        from ignis_tpu.render.session import render_iteration
        if use_light:
            sc = scene._replace(lights=scene.lights._replace(
                intensity=scene.lights.intensity._replace(r=p)))
        else:
            sc = scene._replace(materials=scene.materials._replace(
                base=scene.materials.base._replace(r=p)))
        img = render_iteration(sc, settings, jnp.uint32(0), jnp.uint32(0))
        return jnp.mean(img)

    p0 = (scene.lights.intensity.r if use_light
          else scene.materials.base.r)
    _fd_check(loss_of, p0, rows=3)


def test_gradient_gate_roughness():
    """North-star parameter: microfacet roughness. A rough-conductor
    plane under an env light; d(image)/d(alpha) must FD-match."""
    sc = {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 45,
                   "transform": [1, 0, 0, 0, 0, 1, 0, -0.3, 0, 0, 1, -2.5,
                                 0, 0, 0, 1]},
        "film": {"size": [64, 64]},
        "bsdfs": [{"type": "roughconductor", "name": "m",
                   "material": "none", "roughness": 0.3}],
        "shapes": [{"type": "rectangle", "name": "p", "width": 3,
                    "height": 3}],
        "entities": [{"name": "p", "shape": "p", "bsdf": "m"}],
        "lights": [{"type": "env", "name": "e", "radiance": [1.0, 0.8, 0.6]}],
    }
    rt = ignis_tpu.loadFromString(json.dumps(sc), spi=1)
    settings = _remat(rt.settings)
    scene = rt.scene

    def loss_of(p):
        from ignis_tpu.render.session import render_iteration
        s2 = scene._replace(materials=scene.materials._replace(p2=p))
        img = render_iteration(s2, settings, jnp.uint32(0), jnp.uint32(0))
        return jnp.mean(img)

    _fd_check(loss_of, scene.materials.p2, rows=1, eps=5e-3, rtol=0.1)


def test_gradient_gate_texture_texels():
    """North-star parameter: texture texels. environment_map.json with
    the (small) generated env HDR; d(image)/d(texel) on the top-gradient
    texels of the env image must FD-match."""
    rt = ignis_tpu.loadFromFile(
        fixture_scene("environment_map"), width=64, height=64, spi=1,
        texture_substitutes=env_substitutes())
    assert rt.scene.textures, "env texture did not load"
    settings = _remat(rt.settings)
    scene = rt.scene

    def loss_of(img_tex):
        from ignis_tpu.render.session import render_iteration
        tex0 = scene.textures[0]._replace(image=img_tex)
        sc = scene._replace(textures=(tex0,) + tuple(scene.textures[1:]))
        img = render_iteration(sc, settings, jnp.uint32(0), jnp.uint32(0))
        return jnp.mean(img)

    _fd_check(loss_of, scene.textures[0].image, rows=2, eps=5e-3, rtol=0.1)


def test_gradient_gate_volume_sigma():
    """North-star parameter: volume scattering coefficients. The
    participating_media config scene with its medium coefficients set
    here; d(image)/d(sigma_s) and d(image)/d(sigma_a) must FD-match
    through the volpath scan."""
    d = json.loads(fixture_scene("participating_media").read_text())
    d["media"][0]["sigma_a"] = [0.4, 0.4, 0.4]
    d["media"][0]["sigma_s"] = [0.25, 0.25, 0.25]
    d["film"] = {"size": [64, 64]}
    rt = ignis_tpu.loadFromString(json.dumps(d))
    settings = _remat(rt.settings)
    scene = rt.scene
    assert float(np.asarray(scene.media.sigma_s.r).max()) > 0

    def loss_sig(p, which):
        from ignis_tpu.render.session import render_iteration
        med = scene.media
        if which == "s":
            med = med._replace(sigma_s=med.sigma_s._replace(r=p))
        else:
            med = med._replace(sigma_a=med.sigma_a._replace(r=p))
        sc = scene._replace(media=med)
        img = render_iteration(sc, settings, jnp.uint32(0), jnp.uint32(0))
        return jnp.mean(img)

    _fd_check(lambda p: loss_sig(p, "s"), scene.media.sigma_s.r,
              rows=1, eps=2e-3, rtol=0.1)
    _fd_check(lambda p: loss_sig(p, "a"), scene.media.sigma_a.r,
              rows=1, eps=2e-3, rtol=0.1)
