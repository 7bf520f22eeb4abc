"""Compacting-wavefront equivalence: the host-orchestrated shrinking-bucket
render (techniques/path.py path_trace_rounds — the wavefront analog of the
reference's stream compaction, mapping_cpu.art:205-253) must reproduce the
single-jit persistent-lane render. RNG streams are keyed by
(pixel, sample), not lane index, so compaction only changes float summation
order."""
import json

import jax.numpy as jnp
import numpy as np
import pytest

import ignis_tpu
from ignis_tpu.render.session import (_render_iteration_compacting,
                                      render_iteration)

SCENE = {
    "technique": {"type": "path", "max_depth": 8},
    "camera": {
        "type": "perspective", "fov": 60,
        "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3.85, 0, 0, 0, 1],
    },
    "film": {"size": [64, 64]},
    "bsdfs": [
        {"type": "diffuse", "name": "white", "reflectance": [0.7, 0.7, 0.7]},
        {"type": "dielectric", "name": "glass", "int_ior": 1.55},
    ],
    "shapes": [
        {"type": "rectangle", "name": "floor", "width": 6, "height": 6},
        {"type": "icosphere", "name": "ball", "radius": 0.8,
         "subdivisions": 3},
    ],
    "entities": [
        {"name": "floor", "shape": "floor", "bsdf": "white",
         "transform": [{"rotate": [-90, 0, 0]}, {"translate": [0, -1, 0]}]},
        {"name": "ball", "shape": "ball", "bsdf": "glass"},
    ],
    "lights": [
        {"type": "point", "name": "l", "position": [2, 3, 2], "power": 60},
        {"type": "env", "name": "e", "radiance": [0.2, 0.25, 0.3]},
    ],
}


@pytest.fixture(scope="module")
def rt():
    return ignis_tpu.loadFromString(json.dumps(SCENE), spi=4)


def test_rounds_match_progressive(rt, monkeypatch):
    # Force small buckets so several compaction rounds actually happen on
    # the 4096-lane film.
    from ignis_tpu.techniques import path as pathlib_
    monkeypatch.setattr(pathlib_, "MIN_BUCKET", 256)
    pathlib_._compiled_cascade.cache_clear()

    ref = np.asarray(render_iteration(rt.scene, rt.settings, jnp.uint32(0),
                                      jnp.uint32(0)))
    got = np.asarray(_render_iteration_compacting(
        rt.scene, rt.settings, jnp.uint32(0), jnp.uint32(0)))
    assert np.isfinite(got).all()
    # identical sample set; only fold/accumulation float order differs
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)

    # second iteration: different RNG stream, same scene statistics
    got1 = np.asarray(_render_iteration_compacting(
        rt.scene, rt.settings, jnp.uint32(1), jnp.uint32(0)))
    assert not np.array_equal(got, got1)
    assert abs(got.mean() - got1.mean()) < 0.05 * max(got.mean(), 1e-6)


def test_step_gate_matches(monkeypatch):
    """Runtime.step with the compaction gate forced on equals gate off."""
    from ignis_tpu.render import session as sess

    monkeypatch.setenv("IGNIS_COMPACTION", "1")
    monkeypatch.setattr(sess, "_COMPACTION_MIN_LANES", 1024)
    rt1 = ignis_tpu.loadFromString(json.dumps(SCENE), spi=2)
    rt1.step()
    on = np.asarray(rt1.framebuffer())
    monkeypatch.setenv("IGNIS_COMPACTION", "0")
    rt2 = ignis_tpu.loadFromString(json.dumps(SCENE), spi=2)
    rt2.step()
    off = np.asarray(rt2.framebuffer())
    np.testing.assert_allclose(on, off, rtol=2e-4, atol=2e-5)


VOL_SCENE = {
    "technique": {"type": "volpath", "max_depth": 8},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 3.85,
                             0, 0, 0, 1]},
    "film": {"size": [64, 64]},
    "bsdfs": [{"type": "diffuse", "name": "w",
               "reflectance": [0.7, 0.7, 0.7]},
              {"type": "dielectric", "name": "glass", "int_ior": 1.1}],
    "media": [{"type": "homogeneous", "name": "fog",
               "sigma_a": [0.1, 0.1, 0.1], "sigma_s": [0.6, 0.6, 0.6],
               "g": 0.2}],
    "shapes": [{"type": "rectangle", "name": "floor", "width": 6,
                "height": 6},
               {"type": "icosphere", "name": "ball", "radius": 0.8,
                "subdivisions": 3}],
    "entities": [
        {"name": "floor", "shape": "floor", "bsdf": "w",
         "transform": [{"rotate": [-90, 0, 0]}, {"translate": [0, -1, 0]}]},
        {"name": "ball", "shape": "ball", "bsdf": "glass",
         "inner_medium": "fog"}],
    "lights": [{"type": "point", "name": "l", "position": [2, 3, 2],
                "power": 60},
               {"type": "env", "name": "e", "radiance": [0.2, 0.25, 0.3]}],
}


def test_volpath_rounds_match(monkeypatch):
    """The volumetric wavefront shares the cascade machinery; same
    (pixel,sample) RNG streams -> same image."""
    from ignis_tpu.techniques import path as pathlib_
    monkeypatch.setattr(pathlib_, "MIN_BUCKET", 256)
    pathlib_._compiled_cascade.cache_clear()
    rt = ignis_tpu.loadFromString(json.dumps(VOL_SCENE), spi=4)
    ref = np.asarray(render_iteration(rt.scene, rt.settings, jnp.uint32(0),
                                      jnp.uint32(0)))
    got = np.asarray(_render_iteration_compacting(
        rt.scene, rt.settings, jnp.uint32(0), jnp.uint32(0)))
    assert np.isfinite(got).all() and got.mean() > 0.01
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)
