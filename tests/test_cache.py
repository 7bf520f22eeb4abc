"""Asset cache (CacheManager/serialization analog) tests.

Reference behavior: converted meshes and built BVHs are cached under a
content hash and reloaded bit-identically
(/root/reference/src/runtime/CacheManager.h:18-27)."""
import json

import numpy as np
import pytest

from ignis_tpu.scene import mesh as meshlib
from ignis_tpu.utils import cache


@pytest.fixture
def cachedir(tmp_path):
    d = cache.enable(tmp_path / "cache")
    yield d
    cache.disable()


def test_mesh_cache_roundtrip(cachedir, tmp_path):
    m = meshlib.make_uv_sphere((0, 0, 0), 1.0, stacks=8, slices=8)
    m.ensure_attributes()
    ply = tmp_path / "s.ply"
    meshlib.save_ply(str(ply), m)

    calls = []

    def loader():
        calls.append(1)
        return meshlib.load_ply(str(ply))

    m1 = cache.cached_mesh(str(ply), loader, "ply")
    m2 = cache.cached_mesh(str(ply), loader, "ply")
    assert len(calls) == 1, "second load must come from the cache"
    np.testing.assert_array_equal(m1.vertices, m2.vertices)
    np.testing.assert_array_equal(m1.indices, m2.indices)
    assert (m1.normals is None) == (m2.normals is None)
    if m1.normals is not None:
        np.testing.assert_array_equal(m1.normals, m2.normals)


def test_mesh_cache_invalidates_on_content_change(cachedir, tmp_path):
    ply = tmp_path / "t.ply"
    for radius in (1.0, 2.0):
        m = meshlib.make_uv_sphere((0, 0, 0), radius, stacks=6, slices=6)
        m.ensure_attributes()
        meshlib.save_ply(str(ply), m)
        got = cache.cached_mesh(str(ply), lambda: meshlib.load_ply(str(ply)),
                                "ply")
        assert np.isclose(np.abs(got.vertices).max(), radius, atol=1e-5)


def test_cached_arrays_roundtrip(cachedir):
    key = [np.arange(12, dtype=np.float32), "tag"]
    calls = []

    def builder():
        calls.append(1)
        return {"a": np.arange(5, dtype=np.int32),
                "b": np.ones((2, 3), np.float32)}

    z1 = cache.cached_arrays("unit", key, builder)
    z2 = cache.cached_arrays("unit", key, builder)
    assert len(calls) == 1
    np.testing.assert_array_equal(z1["a"], z2["a"])
    np.testing.assert_array_equal(z1["b"], z2["b"])
    # different key -> rebuild
    cache.cached_arrays("unit", [np.zeros(3, np.float32)], builder)
    assert len(calls) == 2


def test_scene_load_via_cache_matches(cachedir, tmp_path):
    """End-to-end: a PLY-backed scene builds identically with a warm cache."""
    import ignis_tpu

    m = meshlib.make_uv_sphere((0, 0, 1.0), 0.5, stacks=8, slices=8)
    m.ensure_attributes()
    ply = tmp_path / "ball.ply"
    meshlib.save_ply(str(ply), m)
    scene = {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -3,
                                 0, 0, 0, 1]},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "diffuse", "name": "w"}],
        "shapes": [{"type": "ply", "name": "b", "filename": str(ply)}],
        "entities": [{"name": "b", "shape": "b", "bsdf": "w"}],
        "lights": [{"type": "env", "name": "e", "radiance": 0.5}],
    }
    txt = json.dumps(scene)
    rt1 = ignis_tpu.loadFromString(txt, base_dir=str(tmp_path))
    rt2 = ignis_tpu.loadFromString(txt, base_dir=str(tmp_path))
    np.testing.assert_array_equal(
        np.asarray(rt1.scene.tris.v0.x), np.asarray(rt2.scene.tris.v0.x))


def test_compile_cache_in_checkout_when_env_unset(monkeypatch):
    """Without JAX_COMPILATION_CACHE_DIR the compile cache is the fixed
    <checkout>/.jax_cache (no temp name, pid or time in the path)."""
    import jax
    from ignis_tpu.render.session import configure_compile_cache
    from ignis_tpu.utils.cache import CHECKOUT
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        path = configure_compile_cache()
        assert path == CHECKOUT / ".jax_cache" and path.is_dir()
        assert jax.config.jax_compilation_cache_dir == str(path)
        assert configure_compile_cache() == path   # same path every time
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_left_to_jax_when_env_set(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the package sets nothing."""
    import jax
    from ignis_tpu.render.session import configure_compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    old = jax.config.jax_compilation_cache_dir
    jax.config.update("jax_compilation_cache_dir", "sentinel")
    try:
        assert configure_compile_cache() is None
        assert jax.config.jax_compilation_cache_dir == "sentinel"
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
