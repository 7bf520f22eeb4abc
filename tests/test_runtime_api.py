"""Runtime API surface: setParameter registry, multilayer EXR save,
mesh writers, igutil-style converters."""
import json

import numpy as np

import ignis_tpu
from ignis_tpu.scene import mesh as meshlib

SCENE = {
    "technique": {"type": "path", "max_depth": 3},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
    "film": {"size": [16, 16]},
    "parameters": {"tint": 0.2},
    "textures": [{"type": "expr", "name": "refl",
                  "expr": "vec3(tint, tint, tint)"}],
    "bsdfs": [{"type": "diffuse", "name": "g", "reflectance": "refl"}],
    "shapes": [{"type": "rectangle", "name": "B", "width": 4, "height": 4,
                "flip_normals": True}],
    "entities": [{"name": "B", "shape": "B", "bsdf": "g"}],
    "lights": [{"type": "point", "name": "P", "position": [0, 1, -1.5],
                "intensity": [8, 8, 8]}],
}


def test_set_parameter_rebuild_and_camera():
    rt = ignis_tpu.loadFromString(json.dumps(SCENE), spi=8)
    rt.step()
    a = np.asarray(rt.framebuffer(normalized=True)).mean()
    # PExpr registry parameter: lazily rebuilt scene, 4x reflectance
    rt.setParameter("tint", 0.8)
    rt.reset()
    rt.step()
    b = np.asarray(rt.framebuffer(normalized=True)).mean()
    assert abs(b / a - 4.0) < 0.01
    assert rt.getParameter("tint") == 0.8
    # camera parameter: pytree update, no rebuild
    rt.setParameter("__camera_eye", [0, 0, -4])
    rt.reset()
    rt.step()
    c = np.asarray(rt.framebuffer(normalized=True)).mean()
    assert abs(c - b) > 1e-4


def test_save_framebuffer_multilayer(tmp_path):
    from ignis_tpu.utils.exr import read_exr
    rt = ignis_tpu.loadFromString(json.dumps(SCENE), spi=8)
    rt.step()
    out = tmp_path / "multi.exr"
    rt.saveFramebuffer(str(out))
    chans, (w, h) = read_exr(str(out))
    assert {"R", "G", "B"} <= set(chans)
    assert "Normals.R" in chans and "Albedo.R" in chans
    fb = np.asarray(rt.framebuffer(normalized=True))
    assert np.allclose(chans["R"], fb[..., 0], atol=1e-6)
    raw = out.read_bytes()
    for key in (b"igCameraEye", b"igTechniqueType", b"igSPP"):
        assert key in raw


def test_mesh_writers_roundtrip(tmp_path):
    m = meshlib.make_ico_sphere((0, 0, 0), 1.0, 2)
    m.ensure_attributes()
    obj_p, ply_p = tmp_path / "s.obj", tmp_path / "s.ply"
    meshlib.save_obj(obj_p, m)
    meshlib.save_ply(ply_p, m)
    m2 = meshlib.load_obj(obj_p)
    m3 = meshlib.load_ply(ply_p)
    # the OBJ loader re-indexes vertices; compare as sorted point sets
    def canon(v):
        return v[np.lexsort(v.T)]
    assert np.allclose(canon(m.vertices), canon(m2.vertices), atol=1e-5)
    assert m2.indices.shape == m.indices.shape
    assert np.allclose(m.vertices, m3.vertices, atol=1e-5)
    assert np.allclose(m.normals, m3.normals, atol=1e-5)


def test_util_cli_convert(tmp_path):
    from ignis_tpu.util_cli import main
    m = meshlib.make_box((0, 0, 0), np.array([1, 0, 0]),
                         np.array([0, 1, 0]), np.array([0, 0, 1]))
    m.ensure_attributes()
    src = tmp_path / "b.ply"
    dst = tmp_path / "b.obj"
    meshlib.save_ply(src, m)
    assert main(["convert", str(src), str(dst)]) == 0
    m2 = meshlib.load_obj(dst)
    assert len(m2.vertices) == len(m.vertices)


def test_denoiser_reduces_mse():
    # area light -> NEE is stochastic, so a 1-spi render is actually noisy
    # (a point-light scene would be noise-free and only pick up filter bias)
    scene = json.loads(json.dumps(SCENE))
    scene["film"]["size"] = [48, 48]
    scene["bsdfs"].append({"type": "diffuse", "name": "black",
                           "reflectance": [0, 0, 0]})
    scene["shapes"].append({"type": "rectangle", "name": "L",
                            "width": 0.5, "height": 0.5})
    scene["entities"].append({"name": "L", "shape": "L", "bsdf": "black",
                              "transform": [{"translate": [1.5, 0, -1.0]}]})
    scene["lights"] = [{"type": "area", "name": "L", "entity": "L",
                        "radiance": [10, 10, 10]}]
    rt = ignis_tpu.loadFromString(json.dumps(scene), spi=1)
    rt.step()
    noisy = np.asarray(rt.framebuffer(normalized=True))
    den = rt.denoised_framebuffer()
    ref_rt = ignis_tpu.loadFromString(json.dumps(scene), spi=256)
    ref_rt.step()
    ref = np.asarray(ref_rt.framebuffer(normalized=True))
    mse_noisy = ((noisy - ref) ** 2).mean()
    mse_den = ((den - ref) ** 2).mean()
    assert np.isfinite(den).all()
    assert mse_den < mse_noisy  # default (NLM) filter helps
    # VERDICT r3 #9 gate: the guided non-local-means default must beat
    # the classical a-trous fallback by a measured margin
    den_at = rt.denoised_framebuffer(method="atrous")
    mse_at = ((den_at - ref) ** 2).mean()
    assert mse_den < 0.75 * mse_at, (mse_den, mse_at)


def test_mitsuba_converter_matches_native():
    """A Mitsuba XML scene converted with scene/mitsuba.py renders the same
    image as the hand-written ignis JSON of the same scene (both in
    tests/fixtures/scenes)."""
    from conftest import FIXTURE_SCENES
    from ignis_tpu.scene.mitsuba import convert_mitsuba
    d = convert_mitsuba(FIXTURE_SCENES / "mitsuba" / "emissive-plane.xml")
    rt = ignis_tpu.loadFromString(json.dumps(d), spi=32)
    rt.step()
    a = np.asarray(rt.framebuffer(normalized=True))
    rt2 = ignis_tpu.loadFromFile(FIXTURE_SCENES / "emissive-plane.json",
                                 spi=32)
    rt2.step()
    b = np.asarray(rt2.framebuffer(normalized=True))
    assert b.mean() > 0.05
    assert abs(a.mean() - b.mean()) / b.mean() < 0.02


def test_trace_ray_list_matches_render():
    """Jitted trace() (reference Runtime::trace, igtrace mode): radiance
    of camera rays through trace() matches the framebuffer render of the
    same scene to Monte-Carlo tolerance, across bucket-padded sizes."""
    rt = ignis_tpu.loadFromString(json.dumps(SCENE), spi=8)
    rt.step()
    img = rt.framebuffer(normalized=True)

    # rays straight at the plane from the camera eye
    n = 37  # deliberately not a bucket size
    rays = np.zeros((n, 8), np.float32)
    rays[:, 0:3] = [0, 0, -2]
    dirs = np.stack([np.linspace(-0.2, 0.2, n), np.zeros(n), np.ones(n)], 1)
    rays[:, 3:6] = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    rays[:, 7] = 3.0e38
    out = rt.trace(rays, spp=64)
    assert out.shape == (n, 3)
    assert np.all(np.isfinite(out))
    # center ray ~ center pixel radiance
    h, w, _ = img.shape
    center_px = img[h // 2 - 1:h // 2 + 1, w // 2 - 1:w // 2 + 1].mean()
    center_tr = out[n // 2].mean()
    assert abs(center_tr - center_px) / max(center_px, 1e-6) < 0.35
    # second call with a different count reuses another bucket fine
    out2 = rt.trace(rays[:5], spp=4)
    assert out2.shape == (5, 3)


def test_set_parameter_no_recompile():
    """Registry parameters (reference driver/registry.art) update a traced
    pytree leaf: the re-render must reuse the SAME compiled executable."""
    from ignis_tpu.render.session import _compiled_iteration
    rt = ignis_tpu.loadFromString(json.dumps(SCENE), spi=4)
    rt.step()
    fn = _compiled_iteration(rt.settings)
    n0 = fn._cache_size()
    a = rt.framebuffer(normalized=True).mean()
    rt.setParameter("tint", 0.8)
    rt.reset()
    rt.step()
    b = rt.framebuffer(normalized=True).mean()
    assert fn._cache_size() == n0, "parameter change must not recompile"
    assert abs(b / a - 4.0) < 0.02, (a, b)


def test_interactive_orbit_loop_no_recompile():
    """igview-style orbit: camera orientation + registry updates at
    interactive cadence without triggering recompiles (reference
    frontend/view/main.cpp:143-185 loop)."""
    from ignis_tpu.render.session import _compiled_iteration
    rt = ignis_tpu.loadFromString(json.dumps(SCENE), spi=1)
    rt.step()
    fn = _compiled_iteration(rt.settings)
    n0 = fn._cache_size()
    means = []
    for i in range(5):
        ang = i * 0.3
        eye = [2 * np.sin(ang), 0.0, -2 * np.cos(ang)]
        d = [-eye[0], 0.0, -eye[2]]
        rt.setCameraOrientation(eye, d, [0, 1, 0])
        rt.reset()
        rt.step()
        means.append(rt.framebuffer(normalized=True).mean())
    assert fn._cache_size() == n0
    assert len(set(np.round(means, 6))) > 1  # the view actually moved


def test_fixture_scenes_match_generators():
    """tests/fixtures/scenes/*.json are exactly what
    ignis_tpu.scene.fixtures writes (python -m ignis_tpu.scene.fixtures)."""
    from ignis_tpu.scene.fixtures import CONFIG_SCENES, FIXTURE_DIR
    for name, make in CONFIG_SCENES.items():
        on_disk = json.loads((FIXTURE_DIR / f"{name}.json").read_text())
        assert on_disk == json.loads(json.dumps(make())), name
