"""Generated scenes: stand-ins for the five configuration scenes, and the
large scenes that the card smoke run and the benchmark render.

The JSON files under tests/fixtures/scenes/ are written from the first
five functions (`python -m ignis_tpu.scene.fixtures`); their README lists
how each departs from the reference's files. Every scene is a plain dict
in the reference's JSON scene format, so `loadFromString(json.dumps(d),
spi=...)` drives the normal loader. Environment textures name `ENV_TEXTURE`, which
is not shipped: callers pass `texture_substitutes={ENV_TEXTURE: path}`
with a map from utils/envgen.py.
"""
from __future__ import annotations

import json
from pathlib import Path

ENV_TEXTURE = "env_4k.exr"
FIXTURE_DIR = Path(__file__).resolve().parents[2] / "tests" / "fixtures" \
    / "scenes"


def _camera(eye=(0.0, 1.5, -4.5), target=(0.0, -0.4, 0.0),
            fov: float = 45.0) -> dict:
    return {"type": "perspective", "fov": fov, "near_clip": 0.01,
            "far_clip": 100,
            "transform": [{"lookat": {"origin": list(eye),
                                      "target": list(target),
                                      "up": [0, 1, 0]}}]}


def _technique(kind: str) -> dict:
    """Russian roulette off (min_depth = max_depth): a roulette decision
    that flips under a finite-difference step is a jump that reverse mode
    does not see, so the gradient gates compare paths of fixed length."""
    return {"type": kind, "max_depth": 8, "min_depth": 8}


def _quad(name: str, half: float, y: float, up: bool) -> dict:
    """Horizontal square at height y; its normal points up or down."""
    c = [[-half, y, -half], [-half, y, half], [half, y, half],
         [half, y, -half]]
    if not up:
        c = c[::-1]
    return {"type": "rectangle", "name": name, "p0": c[0], "p1": c[1],
            "p2": c[2], "p3": c[3]}


def _floor(name: str = "floor", size: float = 8.0, y: float = -1.0,
           bsdf: str = "ground") -> tuple[dict, dict]:
    return (_quad(name, size / 2, y, up=True),
            {"name": name, "shape": name, "bsdf": bsdf})


def _area_light(y: float = 2.5, size: float = 1.5,
                radiance=(12.0, 11.0, 9.0)) -> tuple[dict, dict, dict]:
    shape = _quad("lamp", size / 2, y, up=False)
    ent = {"name": "lamp", "shape": "lamp", "bsdf": "lamp_body"}
    light = {"type": "area", "name": "lamp_light", "entity": "lamp",
             "radiance": list(radiance)}
    return shape, ent, light


def single_triangle(size: int = 512) -> dict:
    return {
        "technique": _technique("path"),
        "camera": _camera((0.0, 0.0, -3.0), (0.0, 0.0, 0.0)),
        "film": {"size": [size, size]},
        "bsdfs": [{"type": "diffuse", "name": "white",
                   "reflectance": [0.8, 0.6, 0.4]}],
        "shapes": [{"type": "triangle", "name": "tri", "p0": [-1, -1, 0],
                    "p1": [1, -1, 0], "p2": [0, 1, 0]}],
        "entities": [{"name": "tri", "shape": "tri", "bsdf": "white"}],
        "lights": [{"type": "point", "name": "key", "position": [0, 0, -2],
                    "intensity": [4, 4, 4]},
                   {"type": "env", "name": "sky",
                    "radiance": [0.1, 0.1, 0.15]}],
    }


def primitives(size: int = 512) -> dict:
    floor, floor_ent = _floor()
    lamp, lamp_ent, lamp_light = _area_light()
    return {
        "technique": _technique("path"),
        "camera": _camera(),
        "film": {"size": [size, size]},
        "bsdfs": [
            {"type": "diffuse", "name": "ground",
             "reflectance": [0.6, 0.6, 0.55]},
            {"type": "diffuse", "name": "lamp_body",
             "reflectance": [0.3, 0.3, 0.3]},
            {"type": "diffuse", "name": "red", "reflectance": [0.7, 0.2, 0.2]},
            {"type": "roughconductor", "name": "metal", "material": "Au",
             "roughness": 0.2},
            {"type": "roughplastic", "name": "plastic",
             "diffuse_reflectance": [0.2, 0.3, 0.7], "roughness": 0.1},
        ],
        "shapes": [
            floor, lamp,
            {"type": "sphere", "name": "ball", "radius": 0.6,
             "center": [-1.2, -0.4, 0.0]},
            {"type": "cube", "name": "box", "width": 0.9, "height": 0.9,
             "depth": 0.9},
            {"type": "cylinder", "name": "can", "radius": 0.4,
             "height": 1.2},
        ],
        "entities": [
            floor_ent, lamp_ent,
            {"name": "ball", "shape": "ball", "bsdf": "metal"},
            {"name": "box", "shape": "box", "bsdf": "red",
             "transform": [{"rotate": [0, 30, 0]},
                           {"translate": [0.2, -0.55, 0.6]}]},
            {"name": "can", "shape": "can", "bsdf": "plastic",
             "transform": [{"rotate": [-90, 0, 0]},
                           {"translate": [1.4, -1.0, 0.0]}]},
        ],
        "lights": [lamp_light],
    }


def diamond_scene(size: int = 512, subdivisions: int = 3) -> dict:
    """A dielectric icosphere (20 * 4**subdivisions triangles: 1280 at the
    default, above the BVH threshold) on a diffuse floor under an area
    light."""
    floor, floor_ent = _floor()
    lamp, lamp_ent, lamp_light = _area_light()
    return {
        "technique": _technique("path"),
        "camera": _camera(),
        "film": {"size": [size, size]},
        "bsdfs": [
            {"type": "diffuse", "name": "ground",
             "reflectance": [0.7, 0.7, 0.7]},
            {"type": "diffuse", "name": "lamp_body",
             "reflectance": [0.3, 0.3, 0.3]},
            {"type": "dielectric", "name": "diamond", "int_ior": 2.42,
             "ext_ior": 1.0},
        ],
        "shapes": [floor, lamp,
                   {"type": "icosphere", "name": "gem", "radius": 0.9,
                    "subdivisions": subdivisions}],
        "entities": [floor_ent, lamp_ent,
                     {"name": "gem", "shape": "gem", "bsdf": "diamond",
                      "transform": [{"translate": [0, -0.1, 0]}]}],
        "lights": [lamp_light,
                   {"type": "env", "name": "fill",
                    "radiance": [0.05, 0.05, 0.06]}],
    }


def environment_map(size: int = 512) -> dict:
    """Only a textured environment light, as in the reference file."""
    return {
        "technique": _technique("path"),
        "camera": _camera((0.0, 0.0, -4.0), (0.0, 0.0, 0.0), 70.0),
        "film": {"size": [size, size]},
        "textures": [{"type": "image", "name": "env",
                      "filename": f"textures/{ENV_TEXTURE}",
                      "linear": True}],
        "lights": [{"type": "env", "name": "sky", "radiance": "env",
                    "scale": [1.0, 1.0, 1.0]}],
    }


def participating_media(size: int = 512) -> dict:
    floor, floor_ent = _floor()
    return {
        "technique": _technique("volpath"),
        "camera": _camera(),
        "film": {"size": [size, size]},
        "bsdfs": [
            {"type": "diffuse", "name": "ground",
             "reflectance": [0.7, 0.7, 0.7]},
            {"type": "dielectric", "name": "shell", "int_ior": 1.0,
             "ext_ior": 1.0},
        ],
        "media": [{"type": "homogeneous", "name": "smoke",
                   "sigma_a": [0.3, 0.3, 0.3], "sigma_s": [0.8, 0.8, 0.8],
                   "g": 0.3}],
        "shapes": [floor,
                   {"type": "icosphere", "name": "cloud", "radius": 0.9,
                    "subdivisions": 3}],
        "entities": [floor_ent,
                     {"name": "cloud", "shape": "cloud", "bsdf": "shell",
                      "inner_medium": "smoke"}],
        "lights": [{"type": "point", "name": "key", "position": [1.5, 2.5, -1.5],
                    "intensity": [12, 12, 12]},
                   {"type": "env", "name": "fill",
                    "radiance": [0.1, 0.1, 0.12]}],
    }


CONFIG_SCENES = {
    "single_triangle": single_triangle,
    "primitives": primitives,
    "diamond_scene": diamond_scene,
    "environment_map": environment_map,
    "participating_media": participating_media,
}


def big_scene(width: int = 1920, height: int = 1080, max_depth: int = 6,
              subdivisions: int = 8) -> dict:
    """The large render scene: a dielectric icosphere of
    20 * 4**subdivisions triangles (1,310,720 at 8) on a diffuse ground
    under an area light."""
    d = diamond_scene(subdivisions=subdivisions)
    d["technique"] = {"type": "path", "max_depth": max_depth}
    d["film"] = {"size": [width, height]}
    d["camera"]["fov"] = 40
    return d


def env_train_scene(size: int = 512, max_depth: int = 4) -> dict:
    """The differentiable-rendering scene: diffuse, plastic and rough
    conductor objects under the textured environment `ENV_TEXTURE`."""
    floor, floor_ent = _floor()
    p = primitives(size)
    return {
        "technique": {"type": "path", "max_depth": max_depth},
        "camera": _camera(),
        "film": {"size": [size, size]},
        "textures": environment_map()["textures"],
        "bsdfs": [b for b in p["bsdfs"] if b["name"] != "lamp_body"],
        "shapes": [s for s in p["shapes"] if s["name"] != "lamp"],
        "entities": [e for e in p["entities"] if e["name"] != "lamp"],
        "lights": environment_map()["lights"],
    }


def write_fixtures(out_dir: Path = FIXTURE_DIR) -> list[Path]:
    out_dir.mkdir(parents=True, exist_ok=True)
    paths = []
    for name, fn in CONFIG_SCENES.items():
        p = out_dir / f"{name}.json"
        p.write_text(json.dumps(fn(), indent=1) + "\n")
        paths.append(p)
    return paths


if __name__ == "__main__":
    for p in write_fixtures():
        print(p)
