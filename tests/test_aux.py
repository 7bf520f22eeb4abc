"""Auxiliary subsystems: Logger (listeners, levels), RenderPass (user
compute pass), ParameterDescSet (UI parameter descriptors)."""
import json

import numpy as np

import ignis_tpu
from ignis_tpu.utils.logger import (ConsoleLogListener, FileLogListener,
                                    Logger, LogLevel)

SCENE = {
    "technique": {"type": "path", "max_depth": 2},
    "camera": {"type": "perspective", "fov": 60,
               "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -2]},
    "film": {"size": [8, 8]},
    "parameters": {
        "strength": {"type": "number", "value": 0.5, "min": 0, "max": 1,
                     "step": 0.1, "description": "demo knob"},
        "tintv": {"type": "vector", "value": [1, 0.5, 0.25]},
        "plain": 2.0,
    },
    "bsdfs": [{"type": "diffuse", "name": "g", "reflectance": [0.5, 0.5, 0.5]}],
    "shapes": [{"type": "rectangle", "name": "B", "width": 4, "height": 4}],
    "entities": [{"name": "B", "shape": "B", "bsdf": "g"}],
    "lights": [{"type": "point", "name": "P", "position": [0, 1, -1.5],
                "intensity": [4, 4, 4]}],
}


def test_logger_levels_and_listeners(tmp_path):
    log = Logger()
    seen = []
    log.add_listener(lambda lvl, msg: seen.append((int(lvl), msg)))
    log.set_verbosity(LogLevel.WARNING)
    log.debug("hidden")
    log.info("hidden too")
    log.warning("shown")
    log.error("also shown")
    assert [m for _, m in seen] == ["shown", "also shown"]

    f = FileLogListener(str(tmp_path / "log.txt"))
    log.add_listener(f)
    log.error("to file")
    f.close()
    text = (tmp_path / "log.txt").read_text()
    assert "to file" in text and "[Error]" in text

    log.quiet = True
    log.error("silenced")
    assert len(seen) == 3


def test_render_pass_runs_user_kernel():
    rt = ignis_tpu.loadFromString(json.dumps(SCENE), spi=2)
    rt.step()

    def lum_pass(film, aovs, gain=1.0):
        import jax.numpy as jnp
        l = (0.2126 * film[..., 0] + 0.7152 * film[..., 1]
             + 0.0722 * film[..., 2])
        return l * gain

    p = rt.createPass(lum_pass)
    out = np.asarray(p.run(gain=2.0))
    assert out.shape == (8, 8)
    film = rt.framebuffer(normalized=True)
    expect = 2.0 * (0.2126 * film[..., 0] + 0.7152 * film[..., 1]
                    + 0.0722 * film[..., 2])
    np.testing.assert_allclose(out, expect, rtol=1e-5)


def test_parameter_desc_set():
    rt = ignis_tpu.loadFromString(json.dumps(SCENE), spi=1)
    descs = rt.parameterDescs()
    assert descs["strength"]["min"] == 0
    assert descs["strength"]["max"] == 1
    assert descs["strength"]["step"] == 0.1
    assert descs["strength"]["description"] == "demo knob"
    assert descs["tintv"]["type"] == "vector"
    assert descs["plain"] == {"type": "number", "value": 2.0}


def test_aov_registry_and_bake(tmp_path):
    """General AOV registry (reference Runtime::aovs + python
    getFramebufferForHost(aov)) and the PExpr bake entry point
    (BakeShader::setupTexture2d, entrypoints/bake.art)."""
    import json

    import numpy as np

    import ignis_tpu
    from ignis_tpu.render.bake import bake_texture2d, bake_texture_average

    scene = {
        "technique": {"type": "path", "max_depth": 2},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -3,
                                 0, 0, 0, 1]},
        "film": {"size": [16, 16]},
        "bsdfs": [{"type": "diffuse", "name": "w"}],
        "shapes": [{"type": "sphere", "name": "b", "radius": 0.5}],
        "entities": [{"name": "b", "shape": "b", "bsdf": "w"}],
        "lights": [{"type": "env", "name": "e", "radiance": 0.5}],
    }
    rt = ignis_tpu.loadFromString(json.dumps(scene))
    rt.step()
    assert "Normals" in rt.AOVs
    nrm = rt.getFramebufferForHost("Normals")
    assert nrm.shape == (16, 16, 3)
    col = rt.getFramebufferForHost()
    assert col.shape == (16, 16, 3) and np.isfinite(col).all()
    # user-registered AOV round-trips and lands in the multilayer EXR
    rt.registerAOV("MyPass", np.full((16, 16, 3), 0.25, np.float32))
    assert "MyPass" in rt.AOVs
    np.testing.assert_allclose(rt.getFramebufferForHost("MyPass"), 0.25)
    out = tmp_path / "fb.exr"
    rt.saveFramebuffer(str(out))
    from ignis_tpu.utils.exr import read_exr
    channels, _meta = read_exr(str(out))
    assert any("MyPass" in k for k in channels)

    # bake: uv.x ramp -> mean 0.5; checkerboard averages its two colors
    img = bake_texture2d("vec3(uv.x, 0, 1)", 32, 16)
    assert img.shape == (16, 32, 3)
    np.testing.assert_allclose(img[..., 2], 1.0)
    assert abs(img[..., 0].mean() - 0.5) < 0.02
    avg = bake_texture_average("vec3(uv.x, uv.y, 0.25)", res=32)
    np.testing.assert_allclose(avg, [0.5, 0.5, 0.25], atol=0.02)


def test_checkpoint_resume_bitwise(tmp_path):
    """saveCheckpoint/loadCheckpoint: resuming continues the exact sample
    sequence (film accumulation + counters + registry;
    SURVEY.md §5 checkpoint/resume)."""
    import json

    import numpy as np

    import ignis_tpu

    scene = {
        "technique": {"type": "path", "max_depth": 3},
        "camera": {"type": "perspective", "fov": 60,
                   "transform": [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, -3,
                                 0, 0, 0, 1]},
        "film": {"size": [24, 24]},
        "bsdfs": [{"type": "diffuse", "name": "w"}],
        "shapes": [{"type": "sphere", "name": "b", "radius": 0.5}],
        "entities": [{"name": "b", "shape": "b", "bsdf": "w"}],
        "lights": [{"type": "point", "name": "l", "position": [1, 2, 2],
                    "power": 20},
                   {"type": "env", "name": "e", "radiance": 0.4}],
    }
    txt = json.dumps(scene)
    ck = tmp_path / "state.npz"

    rt = ignis_tpu.loadFromString(txt, spi=1)
    rt.step().step()
    rt.saveCheckpoint(str(ck))
    rt.step().step()
    want = rt.framebuffer()
    assert rt.iteration_count == 4

    rt2 = ignis_tpu.loadFromString(txt, spi=1)
    rt2.loadCheckpoint(str(ck))
    assert rt2.iteration_count == 2
    rt2.step().step()
    np.testing.assert_array_equal(rt2.framebuffer(), want)


def test_exr_roundtrip_without_cv2(tmp_path, monkeypatch):
    """EXR is written and read by the package's own code: with cv2 made
    unimportable, save_image/load_image round-trip exactly, and an LDR
    format fails with a clear error."""
    import sys
    import numpy as np
    import pytest
    from ignis_tpu.utils.image import load_image, save_image
    monkeypatch.setitem(sys.modules, "cv2", None)
    img = np.random.default_rng(0).uniform(0, 50, (37, 53, 3)) \
        .astype(np.float32)
    save_image(tmp_path / "a.exr", img)
    np.testing.assert_array_equal(load_image(tmp_path / "a.exr"), img)
    with pytest.raises(ImportError, match="OpenCV"):
        save_image(tmp_path / "a.png", img)


def test_cli_target_gpu_fails_without_cuda(capsys):
    """--target gpu exits non-zero where JAX has no CUDA device (the
    tests run on the CPU), before any scene is loaded."""
    from ignis_tpu.cli import main
    assert main(["missing_scene.json", "--target", "gpu"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
