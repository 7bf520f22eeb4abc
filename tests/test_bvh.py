"""BVH build + traversal correctness vs dense brute force."""
import numpy as np
import jax.numpy as jnp
import pytest

from ignis_tpu.bvh.builder import build_bvh8
from ignis_tpu.core.vec import Vec3
from ignis_tpu.ops.bvh import BVHArrays, intersect_bvh
from ignis_tpu.ops.intersect import (Rays, TriSoup, intersect_tris_dense,
                                     occluded_tris_dense, TRI_CHUNK)


def random_soup(t=1000, seed=0):
    rs = np.random.RandomState(seed)
    v0 = rs.randn(t, 3).astype(np.float32) * 2
    e1 = rs.randn(t, 3).astype(np.float32) * 0.3
    e2 = rs.randn(t, 3).astype(np.float32) * 0.3
    return v0, e1, e2


def as_padded_soup(v0, e1, e2):
    t = len(v0)
    pad = (-t) % TRI_CHUNK
    z = np.zeros((pad, 3), np.float32)
    mk = lambda a: Vec3(jnp.asarray(np.vstack([a, z])[:, 0]),
                        jnp.asarray(np.vstack([a, z])[:, 1]),
                        jnp.asarray(np.vstack([a, z])[:, 2]))
    return TriSoup(mk(v0), mk(e1), mk(e2))


def random_rays(n=512, seed=1):
    rs = np.random.RandomState(seed)
    org = rs.randn(n, 3).astype(np.float32) * 4
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Rays(Vec3(*[jnp.asarray(org[:, i]) for i in range(3)]),
                Vec3(*[jnp.asarray(d[:, i]) for i in range(3)]),
                jnp.zeros(n), jnp.full(n, 3e38))


def test_bvh_matches_dense():
    v0, e1, e2 = random_soup(777)
    bvh_np = build_bvh8(v0, e1, e2)
    perm = bvh_np.prim_order
    assert sorted(perm.tolist()) == list(range(777))
    soup = as_padded_soup(v0[perm], e1[perm], e2[perm])
    bvh = BVHArrays(*[jnp.asarray(a) for a in (
        bvh_np.cmin_x, bvh_np.cmin_y, bvh_np.cmin_z,
        bvh_np.cmax_x, bvh_np.cmax_y, bvh_np.cmax_z, bvh_np.child)])
    rays = random_rays(1024)
    h_dense = intersect_tris_dense(rays, soup)
    h_bvh = intersect_bvh(rays, soup, bvh)
    np.testing.assert_array_equal(np.asarray(h_bvh.prim >= 0),
                                  np.asarray(h_dense.prim >= 0))
    hit = np.asarray(h_dense.prim >= 0)
    np.testing.assert_allclose(np.asarray(h_bvh.t)[hit],
                               np.asarray(h_dense.t)[hit], rtol=1e-5)
    # prim ids must match where the hit is unambiguous (t strictly closest)
    np.testing.assert_array_equal(np.asarray(h_bvh.prim)[hit],
                                  np.asarray(h_dense.prim)[hit])


def test_bvh_any_hit():
    v0, e1, e2 = random_soup(512, seed=3)
    bvh_np = build_bvh8(v0, e1, e2)
    perm = bvh_np.prim_order
    soup = as_padded_soup(v0[perm], e1[perm], e2[perm])
    bvh = BVHArrays(*[jnp.asarray(a) for a in (
        bvh_np.cmin_x, bvh_np.cmin_y, bvh_np.cmin_z,
        bvh_np.cmax_x, bvh_np.cmax_y, bvh_np.cmax_z, bvh_np.child)])
    rays = random_rays(512, seed=5)
    vis = jnp.ones(soup.v0.x.shape[0], bool)
    occ_dense = occluded_tris_dense(rays, soup, vis)
    occ_bvh = intersect_bvh(rays, soup, bvh, any_hit=True, shadow_visible=vis)
    np.testing.assert_array_equal(np.asarray(occ_bvh), np.asarray(occ_dense))


def test_scene_level_bvh():
    """A >4096-tri scene builds with BVH and matches a small-scene render."""
    import json
    import ignis_tpu
    scene = {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 60, "near_clip": 0.1,
                   "far_clip": 100,
                   "transform": [-1, 0, 0, 0, 0, 1, 0, 0, 0, 0, -1, 4,
                                 0, 0, 0, 1]},
        "film": {"size": [48, 48]},
        "bsdfs": [{"type": "diffuse", "name": "m", "reflectance": [0.7, 0.7, 0.7]}],
        "shapes": [{"type": "uvsphere", "name": "S", "stacks": 96,
                    "slices": 48}],
        "entities": [{"name": "S", "shape": "S", "bsdf": "m"}],
        "lights": [{"type": "env", "name": "e", "radiance": [1, 1, 1]}],
    }
    rt = ignis_tpu.loadFromString(json.dumps(scene))
    assert rt.scene.bvh is not None  # 9216 tris -> BVH path
    rt.step()
    img = rt.framebuffer(normalized=True)
    assert np.isfinite(img).all()
    # sphere center should be lit (diffuse under white env)
    assert 0.3 < img[24, 24].mean() < 1.1


def test_native_builder_matches_layout():
    """C++ builder produces a valid BVH8: full one-time leaf coverage and
    in-range child references (skipped when the toolchain is missing)."""
    import numpy as np
    import pytest
    from ignis_tpu.bvh.builder import decode_leaf
    from ignis_tpu.native import build_bvh8_native
    rng = np.random.default_rng(7)
    n = 5000
    v0 = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e1 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    e2 = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    b = build_bvh8_native(v0, e1, e2)
    if b is None:
        pytest.skip("native toolchain unavailable")
    assert sorted(b.prim_order.tolist()) == list(range(n))
    cover = np.zeros(n, bool)
    n_nodes = b.child.shape[0]
    for node in range(n_nodes):
        for j in range(8):
            c = int(b.child[node, j])
            if c < 0:
                s, cnt = decode_leaf(c)
                assert 1 <= cnt <= 4 and not cover[s:s + cnt].any()
                cover[s:s + cnt] = True
            elif c > 0:
                assert c < n_nodes
    assert cover.all()


def _icosphere_scene(subdivisions=4):
    """A built icosphere scene (5120 triangles: BVH path)."""
    import json
    import ignis_tpu
    scene = {
        "technique": {"type": "path"},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -4,
                                 0, 0, 0, 1]},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "diffuse", "name": "w"}],
        "shapes": [{"type": "icosphere", "name": "s", "radius": 1.2,
                    "subdivisions": subdivisions}],
        "entities": [{"name": "s", "shape": "s", "bsdf": "w"}],
        "lights": [{"type": "env", "name": "e", "radiance": 1.0}],
    }
    sc = ignis_tpu.loadFromString(json.dumps(scene)).scene
    assert sc.bvh is not None
    return sc


def _sphere_rays(n, seed, dead_every=0):
    """Rays from a shell around the sphere aimed near it (most hit, some
    graze or miss); every `dead_every`-th lane is dead (tmax < tmin)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o = (o / np.linalg.norm(o, axis=1, keepdims=True) * 3.0).astype(np.float32)
    aim = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    tmax = np.full(n, 1e30, np.float32)
    if dead_every:
        tmax[::dead_every] = -1.0
    return Rays(Vec3(*[jnp.asarray(o[:, i]) for i in range(3)]),
                Vec3(*[jnp.asarray(d[:, i]) for i in range(3)]),
                jnp.zeros(n), jnp.asarray(tmax))


def _check_closest(h, ref):
    pk, pr = np.asarray(h.prim), np.asarray(ref.prim)
    assert (pk == pr).mean() > 0.999
    assert (pr >= 0).mean() > 0.3
    m = (pk == pr) & (pr >= 0)
    # same Moller-Trumbore code; the two programs are compiled separately
    # and may contract different products into FMAs, which moves the
    # barycentrics (in [0, 1]) by a few float32 ulps of their operands
    np.testing.assert_allclose(np.asarray(h.t)[m], np.asarray(ref.t)[m],
                               rtol=1e-5)
    for a, b in ((h.u, ref.u), (h.v, ref.v)):
        np.testing.assert_allclose(np.asarray(a)[m], np.asarray(b)[m],
                                   rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np.asarray(h.t)[pr < 0], np.float32(3.0e38))


# (n rays, dead-lane stride): a whole number of kernel blocks, and a ray
# count that is not a multiple of the block with dead lanes
WALK_CASES = {"full_blocks": (512, 0), "ragged_dead": (300, 7)}


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_kernel_closest_interpret(case):
    """Per-ray walk kernel (Pallas interpreter) == XLA lockstep walk,
    closest hit, on a built scene."""
    from ignis_tpu.ops.bvh_gpu import trace_bvh
    sc = _icosphere_scene()
    n, dead = WALK_CASES[case]
    rays = _sphere_rays(n, seed=2, dead_every=dead)
    h = trace_bvh(rays, sc.tris, sc.bvh, kernel="interpret")
    ref = intersect_bvh(rays, sc.tris, sc.bvh)
    _check_closest(h, ref)
    if dead:
        assert (np.asarray(h.prim)[::dead] == -1).all()


@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_kernel_any_hit_interpret(case):
    """Any-hit with a shadow_visible mask that hides half the triangles:
    the kernel's occlusion equals the XLA walk's, and hidden triangles
    never occlude."""
    from ignis_tpu.ops.bvh_gpu import trace_bvh
    sc = _icosphere_scene()
    n, dead = WALK_CASES[case]
    rays = _sphere_rays(n, seed=4, dead_every=dead)
    n_tri = sc.tris.v0.x.shape[0]
    vis = jnp.asarray(np.random.default_rng(0).uniform(size=n_tri) > 0.5)
    occ = trace_bvh(rays, sc.tris, sc.bvh, any_hit=True, shadow_visible=vis,
                    kernel="interpret")
    ref = intersect_bvh(rays, sc.tris, sc.bvh, any_hit=True,
                        shadow_visible=vis)
    np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))
    assert 0.1 < np.asarray(occ).mean() < 0.9
    none = trace_bvh(rays, sc.tris, sc.bvh, any_hit=True,
                     shadow_visible=jnp.zeros(n_tri, bool), kernel="interpret")
    assert not np.asarray(none).any()


def _grads_vs_scan(kernel):
    """d/d(origin x, v0 x) of sum(t + u*v) over hits: the walk's
    fixed-winner VJP against the XLA chunk scan's autodiff gradient."""
    import jax
    from ignis_tpu.ops.bvh_gpu import trace_bvh
    from ignis_tpu.ops.intersect import intersect_tris_dense
    sc = _icosphere_scene(3)
    rays = _sphere_rays(256, seed=11)

    def loss(trace, ox, v0x):
        r = rays._replace(org=rays.org._replace(x=ox))
        s = sc.tris._replace(v0=sc.tris.v0._replace(x=v0x))
        h = trace(r, s)
        m = h.prim >= 0
        return jnp.sum(jnp.where(m, h.t + h.u * h.v, 0.0))

    walk = lambda r, s: trace_bvh(r, s, sc.bvh, kernel=kernel)
    args = (rays.org.x, sc.tris.v0.x)
    g_walk = jax.grad(lambda *a: loss(walk, *a), argnums=(0, 1))(*args)
    g_scan = jax.grad(lambda *a: loss(intersect_tris_dense, *a),
                      argnums=(0, 1))(*args)
    for gw, gs in zip(g_walk, g_scan):
        gw, gs = np.asarray(gw), np.asarray(gs)
        assert (gs != 0).sum() > 10
        np.testing.assert_allclose(gw, gs, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", ["interpret", "xla"])
def test_walk_vjp_matches_scan_gradient(kernel):
    """The fixed-winner VJP (shared by the kernel and the XLA walk)
    reproduces the scan path's gradient in ray origins and vertices."""
    _grads_vs_scan(kernel)


def test_trace_bvh_dispatch_picks_xla_walk_on_cpu():
    """On the CPU, platform_dependent lowers the XLA walk: the compiled
    program holds no Triton call, and results equal intersect_bvh."""
    import jax
    from ignis_tpu.ops.bvh_gpu import trace_bvh
    sc = _icosphere_scene(3)
    rays = _sphere_rays(128, seed=5)
    f = jax.jit(lambda r: trace_bvh(r, sc.tris, sc.bvh))
    hlo = f.lower(rays).as_text()
    assert "triton" not in hlo.lower() and "bvh8_walk" not in hlo
    h, ref = f(rays), intersect_bvh(rays, sc.tris, sc.bvh)
    np.testing.assert_array_equal(np.asarray(h.prim), np.asarray(ref.prim))
    np.testing.assert_array_equal(np.asarray(h.t), np.asarray(ref.t))


@pytest.mark.gpu
@pytest.mark.parametrize("case", WALK_CASES)
def test_walk_kernel_on_card(case, cuda_device):
    """The compiled kernel on the GPU == the XLA walk on the GPU: closest
    hit and any hit with a shadow_visible mask."""
    import jax
    from ignis_tpu.ops.bvh_gpu import trace_bvh
    with jax.default_device(cuda_device):
        sc = _icosphere_scene()
        n, dead = WALK_CASES[case]
        rays = _sphere_rays(n, seed=2, dead_every=dead)
        h = jax.jit(lambda r: trace_bvh(r, sc.tris, sc.bvh))(rays)
        _check_closest(h, intersect_bvh(rays, sc.tris, sc.bvh))
        n_tri = sc.tris.v0.x.shape[0]
        vis = jnp.asarray(np.random.default_rng(0).uniform(size=n_tri) > 0.5)
        occ = jax.jit(lambda r: trace_bvh(r, sc.tris, sc.bvh, any_hit=True,
                                          shadow_visible=vis))(rays)
        ref = intersect_bvh(rays, sc.tris, sc.bvh, any_hit=True,
                            shadow_visible=vis)
        np.testing.assert_array_equal(np.asarray(occ), np.asarray(ref))


@pytest.mark.gpu
def test_walk_vjp_on_card(cuda_device):
    """The compiled kernel's fixed-winner VJP == the scan gradient."""
    import jax
    with jax.default_device(cuda_device):
        _grads_vs_scan("auto")
