"""Scene build: parsed scene graph -> flat SceneData pytree + RenderSettings.

This is the analog of the reference Loader pipeline
(/root/reference/src/runtime/loader/Loader.cpp:84): shapes -> entities ->
lights -> bsdfs -> media -> camera -> technique, producing flat tables.
Instead of Artic codegen, the output feeds jitted JAX render functions; XLA
specialization over the static RenderSettings replaces per-scene shader JIT.
"""
from __future__ import annotations

import math
import os
from pathlib import Path
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from ..core.vec import Color, Vec2, Vec3
from ..models.bsdf import BsdfKind, ROUGH_FLAG, THIN_FLAG
from ..models.light import LightKind
from ..ops.intersect import TRI_CHUNK, SphereSoup, TriSoup

# Triangle count from which a scene walks a BVH8 instead of the dense
# chunk sweep. Not measured on the GPU: the value is carried over, and
# which route is cheaper below it is an open question (PERF.md).
BVH_THRESHOLD = 512

from ..scenedata import (CameraData, Entities, EnvMap, Lights, Materials, Media,
                         RenderSettings, SceneData, SphereAttributes,
                         TriAttributes)
from . import mesh as meshlib
from .parser import Scene, SceneObject, parse_transform

# IOR lookup table (reference src/runtime/bsdf/Dielectrics in LoaderUtils)
DIELECTRIC_IOR = {
    "vacuum": 1.0, "air": 1.000277, "water": 1.3330, "ice": 1.31,
    "bk7": 1.5046, "glass": 1.5046, "fused_quartz": 1.458,
    "sapphire": 1.77, "diamond": 2.419, "polypropylene": 1.49,
    "ethanol": 1.361, "pet": 1.5750, "acrylic_glass": 1.49,
}

# Conductor spectra (eta, k) for common materials (public tabulated values,
# reference src/runtime/bsdf/Conductors)
CONDUCTOR_SPECTRA = {
    "gold": ((0.143085, 0.374852, 1.44208), (3.98205, 2.38506, 1.60276)),
    "au": ((0.143085, 0.374852, 1.44208), (3.98205, 2.38506, 1.60276)),
    "silver": ((0.15522, 0.116692, 0.138342), (4.81810, 3.12313, 2.14628)),
    "ag": ((0.15522, 0.116692, 0.138342), (4.81810, 3.12313, 2.14628)),
    "aluminum": ((1.34560, 0.96521, 0.61722), (7.47460, 6.39950, 5.30310)),
    "al": ((1.34560, 0.96521, 0.61722), (7.47460, 6.39950, 5.30310)),
    "copper": ((0.200438, 0.924033, 1.10221), (3.91295, 2.44763, 2.14219)),
    "cu": ((0.200438, 0.924033, 1.10221), (3.91295, 2.44763, 2.14219)),
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),  # perfect mirror
}


@dataclass
class BuiltScene:
    data: SceneData
    settings: RenderSettings
    warnings: List[str] = field(default_factory=list)


class TextureRegistry:
    """Shared registry of texture nodes + PExpr compilation.

    The ShadingTree analog: string color/number properties resolve to either
    a named texture, or an implicit PExpr texture node compiled on demand.
    """

    def __init__(self, warnings: List[str], parameters=None):
        self.descs: List = []
        self.datas: List = []
        self.name_to_tex: Dict[str, int] = {}
        self.images: Dict[str, np.ndarray] = {}
        self.measured: List = []  # measured-BSDF tables (klems etc.)
        self.warnings = warnings
        self.parameters = parameters or {}
        self._pexpr_cache: Dict[str, int] = {}

    def _compiler(self):
        from .pexpr import Compiler
        params = {}
        for name, p in self.parameters.items():
            if isinstance(p, dict):
                ptype = p.get("type", "number")
                val = p.get("value", 0)
            else:
                ptype, val = "number", p
            if ptype in ("number", "num", "int"):
                params[name] = ("num", float(val))
            elif ptype == "vector":
                params[name] = ("vec3", tuple(float(x) for x in val))
            else:
                v = list(val) + [1.0]
                params[name] = ("vec4", tuple(float(x) for x in v[:4]))
        return Compiler(self.name_to_tex, params)

    def add(self, name, desc, data) -> int:
        tid = len(self.descs)
        self.descs.append(desc)
        self.datas.append(data)
        if name:
            self.name_to_tex[name] = tid
        return tid

    def resolve_color(self, s: str, what: str) -> int:
        """Texture name or PExpr string -> texture id (-1 on failure)."""
        if s in self.name_to_tex:
            return self.name_to_tex[s]
        if s in self._pexpr_cache:
            return self._pexpr_cache[s]
        try:
            from ..models.texture import TexKind, make_procedural, \
                make_shade_ctx
            from ..core.vec import Vec2
            fn = self._compiler().compile_color(s)
            # dry-run eval on a dummy lane so unknown variables/arity
            # errors surface at load time (ErrorBSDF-style degradation,
            # reference LoaderBSDF.cpp:36-49) instead of at trace time
            import jax.numpy as _j
            z = _j.zeros((1,), _j.float32)
            fn(make_shade_ctx(Vec2(z, z),
                              textures=lambda tid, uv: (uv[0], uv[1], uv[0])))
            desc, data = make_procedural(TexKind.PEXPR, (0, 0, 0), (1, 1, 1))
            desc = desc._replace(kind=int(TexKind.PEXPR), fn=fn)
            tid = self.add(None, desc, data)
            self._pexpr_cache[s] = tid
            return tid
        except Exception as e:
            self.warnings.append(f"{what}: PExpr error: {e}")
            return -1

    def eval_constant_color(self, s: str):
        """If the PExpr is spatially constant (e.g. the exporters'
        "color(r,g,b,a)" literals), return its rgb; else None. Constants
        folded into the material row survive paths that skip texture
        evaluation (blend children) and cost nothing per lane."""
        import re as _re
        toks = set(_re.findall(r"[A-Za-z_]\w*", s))
        # never fold expressions reading declared user parameters — those
        # are read LIVE from the registry at trace time (recompile-free
        # parameter updates) and must stay a PExpr texture
        if toks & set(self.parameters):
            return None
        # never fold expressions that reference a spatial input (uv/uvw/
        # position/normal) — point probing below can false-positive on
        # periodic patterns (a 5x5 checker read at two probe points folded
        # to its dark color and flattened cycles-sun's ground, round-5)
        if toks & {"uv", "uvw", "P", "N", "Np", "Ng", "V"}:
            return None
        try:
            import jax.numpy as _j
            from ..models.texture import make_shade_ctx
            from ..core.vec import Vec2
            fn = self._compiler().compile_color(s)

            def at(u, px, py, pz):
                z = _j.full((1,), u, _j.float32)
                p = (_j.full((1,), px), _j.full((1,), py), _j.full((1,), pz))
                ctx = make_shade_ctx(
                    Vec2(z, 1.0 - z), point=p, normal=p,
                    textures=lambda tid, uv: (uv[0], uv[1], uv[0] * 0 + u))
                r, g, b = fn(ctx)
                return np.array([float(np.asarray(r)[0]),
                                 float(np.asarray(g)[0]),
                                 float(np.asarray(b)[0])])
            a = at(0.13, 0.4, -1.2, 2.0)
            b = at(0.77, -0.9, 0.3, -0.5)
            if np.allclose(a, b, atol=1e-6) and np.isfinite(a).all():
                return a
            return None
        except Exception:
            return None

    def eval_constant_number(self, s: str):
        """Evaluate a PExpr that must be constant (host-side, scalar)."""
        try:
            import jax.numpy as _j
            from ..models.texture import make_shade_ctx
            from ..core.vec import Vec2
            fn = self._compiler().compile_number(s)
            z = _j.zeros((1,), _j.float32)
            ctx = make_shade_ctx(Vec2(z, z))
            return float(np.asarray(fn(ctx))[0])
        except Exception:
            return None


def _as_color_const(v, default) -> np.ndarray:
    if v is None:
        return np.asarray(default, np.float64)
    if isinstance(v, str):
        return None  # texture/PExpr - handled by caller
    if isinstance(v, (int, float)):
        return np.full(3, float(v))
    return np.asarray(v, np.float64)


def _shape_to_mesh(obj: SceneObject, warnings: List[str]) -> Optional[meshlib.TriMesh]:
    t = obj.plugin_type
    p = obj
    if t == "triangle":
        m = meshlib.make_triangle(p.get_vec3("p0", (0, 0, 0)),
                                  p.get_vec3("p1", (1, 0, 0)),
                                  p.get_vec3("p2", (0, 1, 0)))
    elif t == "rectangle":
        if "p0" in p.props:
            m = meshlib.make_rectangle(p.get_vec3("p0", (-1, -1, 0)),
                                       p.get_vec3("p1", (1, -1, 0)),
                                       p.get_vec3("p2", (1, 1, 0)),
                                       p.get_vec3("p3", (-1, 1, 0)))
        else:
            w = p.get_number("width", 2.0)
            h = p.get_number("height", 2.0)
            origin = p.get_vec3("origin", (-w / 2, -h / 2, 0))
            m = meshlib.make_plane(origin, np.array([w, 0, 0]), np.array([0, h, 0]))
    elif t in ("cube", "box"):
        w = p.get_number("width", 2.0)
        h = p.get_number("height", 2.0)
        d = p.get_number("depth", 2.0)
        origin = p.get_vec3("origin", (-w / 2, -h / 2, -d / 2))
        m = meshlib.make_box(origin, np.array([w, 0, 0]), np.array([0, h, 0]),
                             np.array([0, 0, d]))
    elif t == "icosphere" or t == "sphere":
        m = meshlib.make_ico_sphere(p.get_vec3("center"),
                                    p.get_number("radius", 1.0),
                                    p.get_int("subdivisions", 4))
    elif t == "uvsphere":
        m = meshlib.make_uv_sphere(p.get_vec3("center"),
                                   p.get_number("radius", 1.0),
                                   p.get_int("stacks", 32),
                                   p.get_int("slices", 16))
    elif t == "cylinder":
        if "radius" in p.props:
            br = tr = p.get_number("radius", 1.0)
        else:
            br = p.get_number("bottom_radius", 1.0)
            tr = p.get_number("top_radius", br)
        m = meshlib.make_cylinder(p.get_vec3("p0"), br,
                                  p.get_vec3("p1", (0, 0, 1)), tr,
                                  p.get_int("sections", 32),
                                  p.get_bool("filled", True))
    elif t == "cone":
        m = meshlib.make_cone(p.get_vec3("p0"), p.get_number("radius", 1.0),
                              p.get_vec3("p1", (0, 0, 1)),
                              p.get_int("sections", 32),
                              p.get_bool("filled", True))
    elif t == "disk":
        m = meshlib.make_disk(p.get_vec3("origin"),
                              p.get_vec3("normal", (0, 0, 1)),
                              p.get_number("radius", 1.0),
                              p.get_int("sections", 32))
    elif t == "gauss":
        m = meshlib.make_radial_gaussian(
            p.get_vec3("origin"),
            np.asarray(p.get_vec3("normal", (0, 0, 1)), np.float64)
            * p.get_number("height", 1.0),
            p.get_number("sigma", 1.0), p.get_number("radius_scale", 1.0),
            p.get_int("sections", 32), p.get_int("slices", 16))
    elif t == "gauss_lobe":
        st = p.get_number("sigma_theta", 1.0)
        sp = p.get_number("sigma_phi", 1.0)
        an = p.get_number("anisotropy", 0.0)
        cov = [[st * st, an * st * sp], [an * st * sp, sp * sp]]
        m = meshlib.make_gaussian_lobe(
            p.get_vec3("origin"), p.get_vec3("direction", (0, 0, 1)),
            p.get_vec3("x_axis", (1, 0, 0)), p.get_vec3("y_axis", (0, 1, 0)),
            cov, p.get_int("theta_size", 64), p.get_int("phi_size", 128),
            p.get_number("scale", 1.0))
    elif t == "mitsuba":
        from ..utils.cache import cached_mesh
        si = p.get_int("shape_index", 0)
        m = cached_mesh(p.path("filename"),
                        lambda: meshlib.load_mts_serialized(
                            p.path("filename"), si), f"mts{si}")
    elif t in ("obj",):
        from ..utils.cache import cached_mesh
        si = p.get_int("shape_index", -1)
        m = cached_mesh(p.path("filename"),
                        lambda: meshlib.load_obj(p.path("filename"), si),
                        f"obj{si}")
    elif t in ("ply",):
        from ..utils.cache import cached_mesh
        m = cached_mesh(p.path("filename"),
                        lambda: meshlib.load_ply(p.path("filename")), "ply")
    elif t in ("external",):
        from ..utils.cache import cached_mesh
        m = cached_mesh(p.path("filename"),
                        lambda: meshlib.load_mesh_file(p.path("filename")),
                        "ext")
    elif t == "inline":
        verts = np.asarray(p.get("vertices", []), np.float32).reshape(-1, 3)
        idx = np.asarray(p.get("indices", []), np.int32).reshape(-1, 3)
        norms = p.get("normals")
        uvs = p.get("texcoords")
        m = meshlib.TriMesh(verts, idx,
                            np.asarray(norms, np.float32).reshape(-1, 3) if norms else None,
                            np.asarray(uvs, np.float32).reshape(-1, 2) if uvs else None)
    else:
        warnings.append(f"Unsupported shape type '{t}', skipping")
        return None

    # Post-processing flags (TriMeshProvider.cpp:525-545)
    if p.get_bool("flip_normals", False):
        m.flip_normals()
    if p.get_bool("face_normals", False):
        m.ensure_attributes()
        m.setup_face_normals_as_vertex_normals()
    elif p.get_bool("smooth_normals", False):
        m.compute_vertex_normals()
    tr = p.get_transform()
    if not np.allclose(tr, np.eye(4)):
        m.ensure_attributes()
        m.transform(tr)
    for _ in range(p.get_int("subdivision", 0)):
        m.ensure_attributes()
        m.subdivide()
    m.ensure_attributes()
    return m


def _bsdf_row(obj: SceneObject, texreg: "TextureRegistry",
              warnings: List[str]) -> dict:
    """Translate a BSDF scene object into a Materials row dict."""
    t = obj.plugin_type
    row = dict(kind=int(BsdfKind.DIFFUSE),
               base=np.array([0.8, 0.8, 0.8]), extra=np.zeros(3),
               extra2=np.zeros(3), p0=0.0, p1=0.0, p2=0.0, p3=0.0,
               q0=0.0, q1=0.0, q2=0.0, q3=0.0, q4=0.0, q5=0.0,
               q6=0.0, q7=0.0, q8=0.0,
               base_tex=-1, extra_tex=-1, p0_tex=-1, p1_tex=-1,
               bump_kind=0, bump_tex=-1, bump_strength=1.0)

    def col(key, default, slot="base", tex_slot="base_tex"):
        v = obj.get_color(key, default)
        if isinstance(v, str):
            const = texreg.eval_constant_color(v)
            if const is not None:
                row[slot] = const
                return
            tid = texreg.resolve_color(v, f"BSDF '{obj.name}' {key}")
            row[tex_slot] = tid
            if tid < 0:
                warnings.append(f"BSDF '{obj.name}': unresolved '{v}'")
            row[slot] = np.asarray(default, np.float64)
        else:
            row[slot] = v

    def ior(key, default_name):
        mat_key = key + "_material"
        s = obj.get_string(mat_key)
        if s and s.lower() in DIELECTRIC_IOR:
            return DIELECTRIC_IOR[s.lower()]
        v = obj.get(key)
        if isinstance(v, str):
            c = texreg.eval_constant_number(v)
            if c is not None:
                return c
            warnings.append(f"BSDF '{obj.name}': non-constant ior '{v}'")
            return DIELECTRIC_IOR[default_name]
        return obj.get_number(key, DIELECTRIC_IOR[default_name])

    if t == "diffuse" or t == "roughdiffuse":
        row["kind"] = int(BsdfKind.DIFFUSE)
        col("reflectance", (0.8, 0.8, 0.8))
        row["p1"] = obj.get_number("roughness", 0.0)
    elif t in ("dielectric", "glass", "roughdielectric", "thindielectric"):
        row["kind"] = int(BsdfKind.DIELECTRIC)
        col("specular_reflectance", (1, 1, 1), "base", "base_tex")
        col("specular_transmittance", (1, 1, 1), "extra", "extra_tex")
        row["p0"] = ior("ext_ior", "vacuum")
        row["p1"] = ior("int_ior", "bk7")
        row["p2"] = _roughness_uv(obj, texreg)[0]
        row["p3"] = 1.0 if (t == "thindielectric" or obj.get_bool("thin", False)) else 0.0
    elif t in ("conductor", "roughconductor", "mirror", "perfect_mirror"):
        row["kind"] = int(BsdfKind.CONDUCTOR)
        col("specular_reflectance", (1, 1, 1), "base", "base_tex")
        mat = obj.get_string("material", "none")
        eta_k = CONDUCTOR_SPECTRA.get(mat.lower(), CONDUCTOR_SPECTRA["none"])
        row["extra"] = np.asarray(obj.get_color("eta", eta_k[0]))
        row["extra2"] = np.asarray(obj.get_color("k", eta_k[1]))
        row["p2"], row["p3"] = _roughness_uv(obj, texreg)
    elif t in ("phong",):
        row["kind"] = int(BsdfKind.PHONG)
        col("specular_reflectance", (0.2, 0.2, 0.2))
        row["p0"] = obj.get_number("exponent", 30.0)
    elif t in ("plastic", "roughplastic"):
        row["kind"] = int(BsdfKind.PLASTIC)
        col("diffuse_reflectance", (0.5, 0.5, 0.5))
        col("specular_reflectance", (1, 1, 1), "extra", "extra_tex")
        row["p0"] = ior("ext_ior", "vacuum")
        row["p1"] = ior("int_ior", "bk7")
        row["p2"] = _roughness_uv(obj, texreg)[0]
    elif t in ("principled",):
        row["kind"] = int(BsdfKind.PRINCIPLED)
        col("base_color", (0.8, 0.8, 0.8))
        # reference PrincipledBSDF.cpp property set
        refl = _prop_number(obj, "reflective_ior",
                            _prop_number(obj, "ior", DIELECTRIC_IOR["bk7"], texreg),
                            texreg)
        refr = _prop_number(obj, "refractive_ior",
                            _prop_number(obj, "ior", DIELECTRIC_IOR["bk7"], texreg),
                            texreg)
        row["p0"], row["p1"] = refl, refr
        if "roughness_u" in obj.props or "roughness_v" in obj.props:
            ru = _prop_number(obj, "roughness_u", 0.5, texreg)
            rv = _prop_number(obj, "roughness_v", ru, texreg)
        else:
            r = _prop_number(obj, "roughness", 0.5, texreg)
            aniso = _prop_number(obj, "anisotropic", 0.0, texreg)
            aspect = math.sqrt(1.0 - min(max(aniso, 0.0), 1.0) * 0.99)
            ru, rv = r / aspect, r * aspect
        row["p2"], row["p3"] = ru, rv
        row["q0"] = _prop_number(obj, "metallic", 0.0, texreg)
        row["q1"] = _prop_number(obj, "specular_transmission", 0.0, texreg)
        row["q2"] = _prop_number(obj, "specular_tint", 0.0, texreg)
        row["q3"] = _prop_number(obj, "sheen", 0.0, texreg)
        row["q4"] = _prop_number(obj, "sheen_tint", 0.0, texreg)
        row["q5"] = _prop_number(obj, "clearcoat", 0.0, texreg)
        row["q6"] = _prop_number(obj, "clearcoat_gloss", 0.0, texreg)
        row["q7"] = _prop_number(obj, "clearcoat_roughness", 0.1, texreg)
        row["extra2"] = np.array([
            _prop_number(obj, "flatness", 0.0, texreg),
            _prop_number(obj, "diffuse_transmission", 0.0, texreg),
            1.0 if obj.get_bool("thin", False) else 0.0])
    elif t in ("passthrough", "null"):
        row["kind"] = int(BsdfKind.PASSTHROUGH)
        row["base"] = np.ones(3)  # untinted delta transmission
    elif t in ("blend", "mix", "add"):
        # blend of two child BSDFs (BlendBSDF.cpp); child rows resolved in a
        # fixup pass after all BSDFs are registered
        row["kind"] = int(BsdfKind.BLEND)
        row["_children"] = (obj.get_string("first", obj.get_string("bsdf1")),
                            obj.get_string("second", obj.get_string("bsdf2")))
        w = obj.get("weight", 0.5)
        if isinstance(w, str):
            tid = texreg.resolve_color(w, f"BSDF '{obj.name}' weight")
            row["p0_tex"] = tid
            row["p0"] = 0.5
        else:
            row["p0"] = float(w)
    elif t in ("mask", "cutoff"):
        # mask = blend(passthrough, inner, opacity) (MaskBSDF.cpp)
        row["kind"] = int(BsdfKind.BLEND)
        row["_children"] = ("__passthrough__", obj.get_string("bsdf"))
        w = obj.get("opacity", 1.0)
        if isinstance(w, str):
            tid = texreg.resolve_color(w, f"BSDF '{obj.name}' opacity")
            row["p0_tex"] = tid
            row["p0"] = 1.0
        else:
            row["p0"] = float(w)
        if t == "cutoff":
            row["p1"] = _prop_number(obj, "threshold", 0.5, texreg)
            row["p2"] = 1.0  # cutoff flag: weight thresholded
    elif t in ("twosided", "doublesided"):
        # Two-sided wrapper: our frames are always ray-facing, so the inner
        # BSDF already behaves two-sided; alias the inner row in fixup.
        row["kind"] = int(BsdfKind.DIFFUSE)
        row["_alias"] = obj.get_string("bsdf")
    elif t == "transform":
        # normal-override wrapper (TransformBSDF.cpp:20-44): the "normal"
        # property is a per-shading-point PExpr vec3 (world space) fed
        # through make_normal_set — e.g. the Cycles exporter's
        # ensure_valid_reflection(Ng, V, bump(...)) chains (applied in
        # path.apply_normal_map, bump_kind=3)
        row["kind"] = int(BsdfKind.DIFFUSE)
        row["_alias"] = obj.get_string("bsdf")
        nexpr = obj.get("normal")
        if isinstance(nexpr, str):
            tid = texreg.resolve_color(nexpr, f"BSDF '{obj.name}' normal")
        elif nexpr is not None:
            v = np.asarray(nexpr, np.float64).reshape(-1)[:3]
            tid = texreg.resolve_color(
                f"vec3({v[0]!r}, {v[1]!r}, {v[2]!r})",
                f"BSDF '{obj.name}' normal")
        else:
            tid = -1
        if tid >= 0:
            row["bump_kind"] = 3
            row["bump_tex"] = tid
        if "tangent" in obj.props:
            warnings.append(f"BSDF '{obj.name}': transform tangent "
                            "override not supported; using normal only")
        row["bump_strength"] = 1.0
    elif t in ("map", "normalmap", "bumpmap"):
        # normal/bump mapping wrapper (MapBSDF.cpp): shading uses the inner
        # BSDF's row (alias), with the shading normal perturbed per hit
        # from the map texture (applied in path.apply_normal_map)
        row["kind"] = int(BsdfKind.DIFFUSE)
        row["_alias"] = obj.get_string("bsdf")
        is_bump = t == "bumpmap"
        row["bump_kind"] = 2 if is_bump else 1
        m = obj.get("map", obj.get("texture"))
        if isinstance(m, str):
            row["bump_tex"] = texreg.resolve_color(
                m, f"BSDF '{obj.name}' map")
        else:
            row["bump_kind"] = 0  # constant map = no perturbation
        row["bump_strength"] = obj.get_number("strength", 1.0)
    elif t == "klems":
        # Measured Klems BSDF (KlemsBSDF.cpp): XML -> 4 scattering matrices
        from ..models.klems import from_numpy as _klems_jnp
        from .klems import load_klems
        try:
            knp = load_klems(obj.path("filename"))
            row["kind"] = int(BsdfKind.KLEMS)
            row["q6"] = float(len(texreg.measured))
            texreg.measured.append(_klems_jnp(knp))
            col("base_color", (1, 1, 1))
            up = np.asarray(obj.get_vec3("up", (0, 0, 1)), np.float64)
            up = up / max(np.linalg.norm(up), 1e-9)
            row["extra2"] = up
        except Exception as e:
            warnings.append(f"BSDF '{obj.name}': klems load failed: {e}")
            row["kind"] = int(BsdfKind.NULL_ERROR)
    elif t == "tensortree":
        # Measured tensor-tree BSDF (TensorTreeBSDF.cpp); the tree is baked
        # to dense grids at load (scene/tensortree.py). peakExtraction
        # (default true, TensorTreeBSDF.cpp:67) mirrors the shipped
        # reference semantics — see models/tensortree.py.
        from ..models.tensortree import from_numpy as _tt_jnp
        from .tensortree import load_tensortree
        try:
            tnp = load_tensortree(obj.path("filename"))
            row["kind"] = int(BsdfKind.TENSORTREE)
            row["q6"] = float(len(texreg.measured))
            texreg.measured.append(_tt_jnp(
                tnp, use_peak=obj.get_bool("peakExtraction", True)))
            col("base_color", (1, 1, 1))
            up = np.asarray(obj.get_vec3("up", (0, 0, 1)), np.float64)
            up = up / max(np.linalg.norm(up), 1e-9)
            row["extra2"] = up
        except Exception as e:
            warnings.append(f"BSDF '{obj.name}': tensortree load failed: {e}")
            row["kind"] = int(BsdfKind.NULL_ERROR)
    elif t == "djmeasured":
        # Dupuy-Jakob measured BRDF (DJMeasuredBSDF.cpp); powitacq tensor
        # file baked to per-theta_i tables (scene/djmeasured.py)
        from ..models.djmeasured import from_numpy as _dj_jnp
        from .djmeasured import load_djmeasured
        try:
            dnp = load_djmeasured(obj.path("filename"))
            row["kind"] = int(BsdfKind.DJMEASURED)
            row["q6"] = float(len(texreg.measured))
            texreg.measured.append(_dj_jnp(dnp))
            col("tint", (1, 1, 1))
        except Exception as e:
            warnings.append(f"BSDF '{obj.name}': djmeasured load failed: {e}")
            row["kind"] = int(BsdfKind.NULL_ERROR)
    elif t in ("rad_brtdfunc", "rad_roos"):
        # Radiance compliance models (RadBRTDFuncBSDF.cpp / RadRoosBSDF.cpp)
        def _cc(key, default):
            v = obj.get_color(key, default)
            if isinstance(v, str):
                c = None
                try:
                    c = texreg.eval_constant_number(v)
                except Exception:
                    pass
                if c is not None:
                    return np.full(3, float(c))
                warnings.append(f"BSDF '{obj.name}': non-constant {key}")
                return np.asarray(default, np.float64)
            return np.asarray(v, np.float64)
        dir_diff = _cc("direct_diffuse", (0, 0, 0))
        front = _cc("reflection_front_diffuse", (0, 0, 0)) + dir_diff
        back = _cc("reflection_back_diffuse", (0, 0, 0)) + dir_diff
        row["extra2"] = _cc("transmission_diffuse", (0, 0, 0))
        row["q0"], row["q1"], row["q2"] = front.tolist()
        row["q3"], row["q4"], row["q5"] = back.tolist()
        if t == "rad_brtdfunc":
            row["kind"] = int(BsdfKind.RAD_BRTDF)
            row["base"] = _cc("reflection_specular", (1, 1, 1))
            row["extra"] = _cc("transmission_specular", (0, 0, 0))
        else:
            row["kind"] = int(BsdfKind.RAD_ROOS)
            row["base"] = np.array([obj.get_number("trns_w", 0.0),
                                    obj.get_number("trns_p", 0.0),
                                    obj.get_number("trns_q", 0.0)])
            row["extra"] = np.array([obj.get_number("refl_w", 0.0),
                                     obj.get_number("refl_p", 0.0),
                                     obj.get_number("refl_q", 0.0)])
    elif t in ("transparent", "ignore"):
        # tinted delta transmission (TransparentBSDF.cpp:16-20)
        row["kind"] = int(BsdfKind.PASSTHROUGH)
        col("color", (1, 1, 1))
    else:
        warnings.append(f"Unsupported BSDF type '{t}' -> error bsdf")
        row["kind"] = int(BsdfKind.NULL_ERROR)
    return row


# DebugMode.cpp string names, in enum order
_DEBUG_MODES = ["normal", "tangent", "bitangent", "geometric normal",
                "local normal", "local tangent", "local bitangent",
                "local geometric normal", "texture coords", "prim coords",
                "point", "local point", "generated coords", "hit distance",
                "area", "raw prim id", "prim id", "raw entity id",
                "entity id", "raw material id", "material id", "is emissive",
                "is specular", "is entering", "check bsdf", "albedo",
                "medium inner", "medium outer"]


def _debug_mode_of(tech) -> int:
    v = tech.get("mode", 0)
    if isinstance(v, str):
        try:
            return _DEBUG_MODES.index(v.strip().lower())
        except ValueError:
            return 0
    try:
        return int(v)
    except (TypeError, ValueError):
        return 0


def build_scene(scene: Scene, overrides: Optional[dict] = None) -> BuiltScene:
    warnings: List[str] = []
    overrides = overrides or {}

    # --- film / technique / camera -----------------------------------------
    film = scene.film
    size = film.get("size", [800, 600]) if film else [800, 600]
    width, height = int(size[0]), int(size[1])
    if "width" in overrides:
        width = overrides["width"]
    if "height" in overrides:
        height = overrides["height"]

    tech = scene.technique
    tech_type = tech.plugin_type if tech else "path"
    # RuntimeOptions.OverrideTechnique / OverrideCamera analog
    if overrides.get("technique"):
        tech_type = str(overrides["technique"])
    # ppm spells these max_camera_depth/min_camera_depth
    # (PhotonMappingTechnique.cpp:15-16)
    max_depth = (tech.get_int("max_depth",
                              tech.get_int("max_camera_depth", 64))
                 if tech else 64)
    min_depth = (tech.get_int("min_depth",
                              tech.get_int("min_camera_depth", 2))
                 if tech else 2)
    if "max_depth" in overrides:   # --spp-style CLI/API override
        max_depth = int(overrides["max_depth"])
    clamp = tech.get_number("clamp", 0.0) if tech else 0.0
    # aept defaults NEE off (AdaptiveEnvPathTechnique.cpp:18)
    nee_default = tech_type not in ("aept", "adaptive_env")
    enable_nee = tech.get_bool("nee", nee_default) if tech else True

    cam = scene.camera
    cam_type = cam.plugin_type if cam else "perspective"
    if overrides.get("camera"):
        cam_type = str(overrides["camera"])
    cam_transform = cam.get_transform() if (cam and "transform" in cam.props) else None
    near = cam.get_number("near_clip", 0.0) if cam else 0.0
    far = cam.get_number("far_clip", 3.0e38) if cam else 3.0e38
    if cam is not None and "fov" in cam.props or cam is not None and "hfov" in cam.props or cam is not None and "vfov" in cam.props:
        pass
    aspect = width / float(height)
    if cam is not None and cam.get("aspect_ratio") is not None:
        aspect = cam.get_number("aspect_ratio", aspect)

    if cam is not None and "vfov" in cam.props:
        fov = math.radians(cam.get_number("vfov", 60.0))
        sh = math.tan(fov / 2)
        sw = sh * aspect
    else:
        fovkey = "hfov" if (cam is not None and "hfov" in cam.props) else "fov"
        fov = math.radians(cam.get_number(fovkey, 60.0) if cam else 60.0)
        sw = math.tan(fov / 2)
        sh = sw / aspect
    fish_mode = cam.get_string("mode", "circular") if cam else "circular"

    # --- shapes ------------------------------------------------------------
    meshes: Dict[str, meshlib.TriMesh] = {}
    analytic_spheres: Dict[str, tuple] = {}
    for name, obj in scene.shapes.items():
        if obj.plugin_type == "sphere":
            analytic_spheres[name] = (obj.get_vec3("center"),
                                      obj.get_number("radius", 1.0))
        else:
            m = _shape_to_mesh(obj, warnings)
            if m is not None:
                meshes[name] = m

    # --- textures ----------------------------------------------------------
    from ..models.texture import (FilterMode, TexKind, WrapMode,
                                  make_image_texture, make_procedural)
    texreg = TextureRegistry(warnings, scene.parameters)
    name_to_tex = texreg.name_to_tex
    tex_images = texreg.images  # raw image per name (env CDFs)

    def _wrap_of(s):
        return {"repeat": WrapMode.REPEAT, "mirror": WrapMode.MIRROR,
                "clamp": WrapMode.CLAMP}.get(s, WrapMode.REPEAT)

    for name, obj in scene.textures.items():
        t = obj.plugin_type
        try:
            if t in ("image", "bitmap"):
                from ..utils.image import load_image
                tex_path = obj.path("filename")
                subs = overrides.get("texture_substitutes") or {}
                sub = subs.get(Path(str(tex_path)).name)
                if sub is not None and not Path(str(tex_path)).exists():
                    warnings.append(f"Texture '{name}': missing asset "
                                    f"{Path(str(tex_path)).name} substituted "
                                    f"by {sub}")
                    tex_path = sub
                img = load_image(tex_path,
                                 linear=obj.get_bool("linear", False))
                tex_images[name] = img
                filt = {"nearest": FilterMode.NEAREST,
                        "bilinear": FilterMode.BILINEAR}.get(
                    obj.get_string("filter_type", "bicubic"), FilterMode.BICUBIC)
                wu = _wrap_of(obj.get_string("wrap_mode_u",
                                             obj.get_string("wrap_mode", "repeat")))
                wv = _wrap_of(obj.get_string("wrap_mode_v",
                                             obj.get_string("wrap_mode", "repeat")))
                tr2 = obj.get_transform()[:2, (0, 1, 3)]
                d, a = make_image_texture(img, wu, wv, filt, tr2)
            elif t == "checkerboard":
                d, a = make_procedural(
                    TexKind.CHECKERBOARD,
                    _as_color_const(obj.get("color0"), (0, 0, 0)),
                    _as_color_const(obj.get("color1"), (1, 1, 1)),
                    obj.get_number("scale_x", 2.0), obj.get_number("scale_y", 2.0))
            elif t in ("noise", "pnoise", "perlin", "fbm", "voronoi", "cellnoise"):
                kind = {"noise": TexKind.NOISE, "pnoise": TexKind.PERLIN,
                        "perlin": TexKind.PERLIN, "fbm": TexKind.FBM,
                        "voronoi": TexKind.VORONOI,
                        "cellnoise": TexKind.CELLNOISE}[t]
                d, a = make_procedural(
                    kind,
                    _as_color_const(obj.get("color0"), (0, 0, 0)),
                    _as_color_const(obj.get("color1"), (1, 1, 1)),
                    obj.get_number("scale", 20.0))
            elif t == "brick":
                # BrickPattern.cpp defaults: scale (3,6), gap (0.05,0.1)
                d, a = make_procedural(
                    TexKind.BRICK,
                    _as_color_const(obj.get("color0"), (0, 0, 0)),
                    _as_color_const(obj.get("color1"), (1, 1, 1)),
                    obj.get_number("scale_x", 3.0),
                    obj.get_number("scale_y", 6.0),
                    obj.get_transform()[:2, (0, 1, 3)],
                    obj.get_number("gap_x", 0.05),
                    obj.get_number("gap_y", 0.1))
            elif t == "transform":
                inner_name = obj.get_string("texture", "")
                inner_id = name_to_tex.get(inner_name, -1)
                if inner_id < 0:
                    warnings.append(f"Texture '{name}': transform of unknown "
                                    f"texture '{inner_name}' (define it "
                                    "first); using white")
                    d, a = make_procedural(TexKind.CONSTANT, (1, 1, 1),
                                           (1, 1, 1))
                else:
                    d, a = make_procedural(
                        TexKind.TRANSFORM, (0, 0, 0), (1, 1, 1),
                        transform=obj.get_transform()[:2, (0, 1, 3)],
                        inner=inner_id)
            elif t in ("constant",):
                d, a = make_procedural(TexKind.CONSTANT,
                                       _as_color_const(obj.get("color"), (1, 1, 1)),
                                       (1, 1, 1))
            elif t in ("expr", "pexpr"):
                src = obj.get_string("expr", obj.get_string("value", "1"))
                fn = texreg._compiler().compile_color(src)
                d, a = make_procedural(TexKind.PEXPR, (0, 0, 0), (1, 1, 1))
                d = d._replace(fn=fn)
            else:
                warnings.append(f"Texture '{name}': type '{t}' TODO, using white")
                d, a = make_procedural(TexKind.CONSTANT, (1, 1, 1), (1, 1, 1))
        except Exception as e:  # missing file etc.
            warnings.append(f"Texture '{name}': {e}; using magenta")
            d, a = make_procedural(TexKind.CONSTANT, (1, 0, 1), (1, 0, 1))
        texreg.add(name, d, a)

    # --- materials ---------------------------------------------------------
    mat_rows: List[dict] = []
    mat_index: Dict[str, int] = {}
    for name, obj in scene.bsdfs.items():
        mat_index[name] = len(mat_rows)
        mat_rows.append(_bsdf_row(obj, texreg, warnings))
    if not mat_rows:  # fallback material
        mat_rows.append(_bsdf_row(SceneObject("diffuse", "_default"), texreg, warnings))
    default_mat = 0

    # Fixup pass: resolve blend children / aliases now that all rows exist.
    def _passthrough_row():
        for i, r in enumerate(mat_rows):
            if r["kind"] == int(BsdfKind.PASSTHROUGH):
                return i
        r = _bsdf_row(SceneObject("passthrough", "__passthrough__"), texreg,
                      warnings)
        mat_rows.append(r)
        return len(mat_rows) - 1

    has_blend = False
    for i, r in enumerate(list(mat_rows)):
        if "_alias" in r:
            inner = mat_index.get(r.pop("_alias"))
            if inner is not None:
                keep_kind_alias = dict(mat_rows[inner])
                keep_kind_alias.pop("_children", None)
                keep_kind_alias.pop("_alias", None)
                # the wrapper's own normal perturbation survives the alias
                for k in ("bump_kind", "bump_tex", "bump_strength"):
                    keep_kind_alias.pop(k, None)
                mat_rows[i].update(keep_kind_alias)
            else:
                warnings.append("twosided/map: unknown inner bsdf")
        if "_children" in r:
            has_blend = True
            a_name, b_name = r.pop("_children")
            a = (_passthrough_row() if a_name == "__passthrough__"
                 else mat_index.get(a_name, default_mat))
            b = mat_index.get(b_name, default_mat)
            # nested blends resolve recursively up to
            # models/bsdf.py BLEND_MAX_DEPTH levels (mix.art composes
            # arbitrarily nested closures); warn past that depth only
            def _depth_of(idx, seen=()):
                if idx in seen or mat_rows[idx]["kind"] != int(BsdfKind.BLEND):
                    return 0
                kids = [int(mat_rows[idx].get("q0", 0)),
                        int(mat_rows[idx].get("q1", 0))]
                return 1 + max(_depth_of(k, seen + (idx,)) for k in kids)
            from ..models.bsdf import BLEND_MAX_DEPTH
            if max(_depth_of(a), _depth_of(b)) >= BLEND_MAX_DEPTH:
                warnings.append(
                    f"blend '{a_name}'/'{b_name}' nesting exceeds "
                    f"BLEND_MAX_DEPTH={BLEND_MAX_DEPTH}; deepest children "
                    "degrade to their first leaf")
            mat_rows[i]["q0"] = float(a)
            mat_rows[i]["q1"] = float(b)

    # --- media -------------------------------------------------------------
    med_rows = []
    med_exprs: List = []
    med_index: Dict[str, int] = {}
    for name, obj in scene.media.items():
        med_index[name] = len(med_rows)
        sa = _as_color_const(obj.get("sigma_a"), (0, 0, 0))
        ss = _as_color_const(obj.get("sigma_s"), (0, 0, 0))
        fn_a = fn_s = None
        if sa is None:
            try:
                fn_a = texreg._compiler().compile_color(obj.get_string("sigma_a"))
            except Exception as e:
                warnings.append(f"Medium '{name}' sigma_a: {e}")
            sa = np.zeros(3)
        if ss is None:
            try:
                fn_s = texreg._compiler().compile_color(obj.get_string("sigma_s"))
            except Exception as e:
                warnings.append(f"Medium '{name}' sigma_s: {e}")
            ss = np.zeros(3)
        med_exprs.append((fn_a, fn_s) if (fn_a or fn_s) else None)
        med_rows.append((sa, ss, _prop_number(obj, "g", 0.0, texreg)))

    # --- entities: flatten transforms into a global soup -------------------
    tri_v0, tri_e1, tri_e2 = [], [], []
    tri_n = ([], [], [])
    tri_uv = ([], [], [])
    tri_ent, tri_area, tri_shadow = [], [], []
    sph_center, sph_radius, sph_ent, sph_shadow = [], [], [], []
    ent_names: List[str] = []
    ent_mat, ent_light, ent_med_in, ent_med_out = [], [], [], []
    ent_tri_range: Dict[str, tuple] = {}
    ent_sphere: Dict[str, tuple] = {}

    all_points = []

    # --- two-level acceleration (opt-in, reference LoaderEntity two-level
    # scene BVH): the most-reused mesh shape keeps ONE local-space copy +
    # per-instance world->local transforms instead of flattened duplicates.
    # Generalized two-level accel (LoaderEntity.cpp:18-32): EVERY mesh
    # shape reused by >= 2 entities becomes an instance group sharing one
    # local-space soup; records per group keyed by shape name
    inst_shapes: set = set()
    inst_records: Dict[str, list] = {}
    if overrides.get("instancing"):
        use_count: Dict[str, int] = {}
        for _, obj in scene.entities.items():
            sn = obj.get_string("shape")
            if sn in meshes:
                use_count[sn] = use_count.get(sn, 0) + 1
        inst_shapes = {sn for sn, c in use_count.items() if c >= 2}

    for name, obj in scene.entities.items():
        shape_name = obj.get_string("shape")
        bsdf_name = obj.get_string("bsdf")
        eid = len(ent_names)
        ent_names.append(name)
        ent_mat.append(mat_index.get(bsdf_name, default_mat))
        ent_light.append(-1)
        ent_med_in.append(med_index.get(obj.get_string("inner_medium"), -1))
        ent_med_out.append(med_index.get(obj.get_string("outer_medium"), -1))
        shadow_visible = obj.get_bool("shadow_visible", True)
        tr = obj.get_transform()

        if shape_name in analytic_spheres:
            c, r = analytic_spheres[shape_name]
            lin = tr[:3, :3]
            scale = np.abs(np.linalg.det(lin)) ** (1.0 / 3.0)
            if not np.allclose(lin, np.eye(3) * lin[0, 0], atol=1e-5):
                warnings.append(f"Entity '{name}': non-uniform sphere scale, "
                                "tessellating")
                m = meshlib.make_ico_sphere(c, r, 5)
                m.transform(tr)
                _append_mesh(m, eid, shadow_visible, tri_v0, tri_e1, tri_e2,
                             tri_n, tri_uv, tri_ent, tri_area, tri_shadow,
                             ent_tri_range, name)
                all_points.append(m.vertices)
            else:
                wc = tr[:3, :3] @ np.asarray(c, np.float64) + tr[:3, 3]
                wr = r * scale
                sph_center.append(wc)
                sph_radius.append(wr)
                sph_ent.append(eid)
                sph_shadow.append(shadow_visible)
                ent_sphere[name] = (wc, wr)
                all_points.append(wc[None] + np.array([[-wr, -wr, -wr], [wr, wr, wr]]))
        elif shape_name in inst_shapes:
            w2l = np.linalg.inv(tr)
            src = meshes[shape_name]
            lo = src.vertices.min(axis=0)
            hi = src.vertices.max(axis=0)
            corners = np.array([[x, y, z, 1.0] for x in (lo[0], hi[0])
                                for y in (lo[1], hi[1])
                                for z in (lo[2], hi[2])])
            wc = (tr @ corners.T).T[:, :3]
            inst_records.setdefault(shape_name, []).append(
                (w2l[:3, :4].astype(np.float32),
                 w2l[:3, :3].T.astype(np.float32),
                 eid, shadow_visible,
                 wc.min(axis=0).astype(np.float32),
                 wc.max(axis=0).astype(np.float32)))
            all_points.append(wc)
        elif shape_name in meshes:
            src = meshes[shape_name]
            m = meshlib.TriMesh(src.vertices.copy(), src.indices.copy(),
                                None if src.normals is None else src.normals.copy(),
                                None if src.texcoords is None else src.texcoords.copy())
            m.ensure_attributes()
            if not np.allclose(tr, np.eye(4)):
                m.transform(tr)
            _append_mesh(m, eid, shadow_visible, tri_v0, tri_e1, tri_e2,
                         tri_n, tri_uv, tri_ent, tri_area, tri_shadow,
                         ent_tri_range, name)
            all_points.append(m.vertices)
        else:
            warnings.append(f"Entity '{name}': unknown shape '{shape_name}'")

    # materialize the instance groups (one shared local soup each,
    # chunk-padded); scene.instances is a tuple of InstancedGeo
    instanced_geo = None
    if inst_records:
        from ..ops.instanced import InstancedGeo
        from ..ops.intersect import TriSoup as _TriSoup
        groups = []
        for sname in sorted(inst_records):
            recs = inst_records[sname]
            src = meshes[sname]
            lm = meshlib.TriMesh(src.vertices.copy(), src.indices.copy(),
                                 None if src.normals is None
                                 else src.normals.copy(),
                                 None if src.texcoords is None
                                 else src.texcoords.copy())
            lm.ensure_attributes()
            lv0, le1, le2 = [], [], []
            ln = ([], [], [])
            luv = ([], [], [])
            _append_mesh(lm, 0, True, lv0, le1, le2, ln, luv, [], [], [],
                         {}, "__inst__")
            ntl = len(lv0)
            # pad to whole TRI_CHUNK chunks for the dense sweep
            padl = (-ntl) % TRI_CHUNK

            def pad3l(lst):
                a = np.asarray(lst, np.float32).reshape(-1, 3)
                return np.vstack([a, np.zeros((padl, 3), np.float32)])

            def pad2l(lst):
                a = np.asarray(lst, np.float32).reshape(-1, 2)
                return np.vstack([a, np.zeros((padl, 2), np.float32)])

            s3 = lambda a: Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]),
                                jnp.asarray(a[:, 2]))
            s2 = lambda a: Vec2(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]))
            groups.append(InstancedGeo(
                soup=_TriSoup(s3(pad3l(lv0)), s3(pad3l(le1)),
                              s3(pad3l(le2))),
                n0=s3(pad3l(ln[0])), n1=s3(pad3l(ln[1])),
                n2=s3(pad3l(ln[2])),
                uv0=s2(pad2l(luv[0])), uv1=s2(pad2l(luv[1])),
                uv2=s2(pad2l(luv[2])),
                w2l=jnp.asarray(np.stack([r[0] for r in recs])),
                nrm_mat=jnp.asarray(np.stack([r[1] for r in recs])),
                ent=jnp.asarray([r[2] for r in recs], jnp.int32),
                shadow_visible=jnp.asarray([r[3] for r in recs], bool),
                aabb_min=jnp.asarray(np.stack([r[4] for r in recs])),
                aabb_max=jnp.asarray(np.stack([r[5] for r in recs]))))
        instanced_geo = tuple(groups)

    # --- lights ------------------------------------------------------------
    l_rows = []
    area_tris: List[int] = []
    area_cdf: List[float] = []
    envmap = EnvMap(jnp.asarray(False), jnp.zeros((1,), jnp.float32),
                    jnp.zeros((1, 1), jnp.float32))
    env_cdf_method = "conditional"
    ent_name_to_id = {n: i for i, n in enumerate(ent_names)}

    def light_row(**kw):
        row = dict(kind=int(LightKind.POINT), pos=np.zeros(3), dir=np.array([0, 0, 1.0]),
                   intensity=np.ones(3), p0=0.0, p1=0.0, p2=0.0, entity=-1,
                   tri_start=0, tri_count=0, tex=-1, delta=False, infinite=False)
        row.update(kw)
        return row

    for name, obj in scene.lights.items():
        t = obj.plugin_type
        if t == "point":
            if "power" in obj.props:
                inten = _as_color_const(obj.get("power"), (4 * np.pi,) * 3) / (4 * np.pi)
            else:
                inten = _as_color_const(obj.get("intensity"), (1, 1, 1))
            l_rows.append(light_row(kind=int(LightKind.POINT),
                                    pos=obj.get_vec3("position"),
                                    intensity=inten, delta=True))
        elif t == "spot":
            cutoff = math.radians(obj.get_number("cutoff", 30.0))
            falloff = math.radians(obj.get_number("falloff", 20.0))
            if "power" in obj.props:
                factor = 2 * np.pi * (1 - 0.5 * (math.cos(cutoff) + math.cos(falloff)))
                inten = _as_color_const(obj.get("power"), (1, 1, 1)) / factor
            else:
                inten = _as_color_const(obj.get("intensity"), (1, 1, 1))
            d = _light_direction(obj)
            l_rows.append(light_row(kind=int(LightKind.SPOT),
                                    pos=obj.get_vec3("position"),
                                    dir=d, intensity=inten,
                                    p0=math.cos(cutoff), p1=math.cos(falloff),
                                    delta=True))
        elif t == "directional":
            d = _light_direction(obj)
            inten = _as_color_const(obj.get("irradiance"), (1, 1, 1))
            l_rows.append(light_row(kind=int(LightKind.DIRECTIONAL), dir=d,
                                    intensity=inten, delta=True, infinite=True))
        elif t == "area":
            ent_name = obj.get_string("entity")
            eid = ent_name_to_id.get(ent_name, -1)
            if eid < 0:
                warnings.append(f"Area light '{name}': unknown entity")
                continue
            rad = _as_color_const(obj.get("radiance"), (1, 1, 1))
            if rad is None:
                warnings.append(f"Area light '{name}': textured radiance TODO")
                rad = np.ones(3)
            if "power" in obj.props:
                # radiance = power / (pi * area) (reference AreaLight power)
                pass  # handled below once area known
            row_id = len(l_rows)
            if ent_name in ent_sphere:
                wc, wr = ent_sphere[ent_name]
                total = float(4.0 * np.pi * wr * wr)
                l_rows.append(light_row(kind=int(LightKind.AREA),
                                        intensity=rad, pos=np.asarray(wc),
                                        p0=total, p1=float(row_id), p2=wr,
                                        entity=eid))
            else:
                start, count = ent_tri_range.get(ent_name, (0, 0))
                areas = np.asarray(tri_area[start:start + count], np.float64)
                total = float(np.sum(areas))
                cdf_local = np.cumsum(areas) / max(total, 1e-30)
                a_start = len(area_tris)
                area_tris.extend(range(start, start + count))
                area_cdf.extend((row_id + cdf_local).tolist())
                l_rows.append(light_row(kind=int(LightKind.AREA), intensity=rad,
                                        p0=total, p1=float(row_id), entity=eid,
                                        tri_start=a_start, tri_count=count))
            if "power" in obj.props:
                pw = _as_color_const(obj.get("power"), (1, 1, 1))
                l_rows[row_id]["intensity"] = pw / (np.pi * max(total, 1e-30))
            ent_light[eid] = row_id
        elif t in ("env", "envmap", "environment", "uniform", "constant"):
            rad = obj.get_color("radiance", (1, 1, 1))
            scale = _as_color_const(obj.get("scale"), (1, 1, 1))
            if isinstance(rad, str):
                tid = texreg.resolve_color(rad, f"Env light '{name}'")
                if tid < 0:
                    warnings.append(f"Env light '{name}': unresolved "
                                    f"'{rad}', using white")
                    l_rows.append(light_row(kind=int(LightKind.ENV),
                                            intensity=scale, infinite=True))
                else:
                    if rad in tex_images:
                        # "cdf" method selection (EnvironmentLight.cpp:22-27)
                        m = (obj.get_string("cdf", "conditional")
                             or "conditional").lower()
                        if m not in ("none", "conditional", "sat",
                                     "hierachical", "hierarchical"):
                            warnings.append(f"Env light '{name}': unknown "
                                            f"cdf method '{m}', using "
                                            "conditional")
                            m = "conditional"
                        if m != "none":
                            env_cdf_method = m
                            envmap = _build_env_cdf(
                                tex_images[rad],
                                compensate=obj.get_bool("compensate", True),
                                method=m)
                    l_rows.append(light_row(kind=int(LightKind.ENV),
                                            intensity=scale, tex=tid,
                                            infinite=True))
            else:
                l_rows.append(light_row(kind=int(LightKind.ENV),
                                        intensity=np.asarray(rad) * scale,
                                        infinite=True))
        elif t == "sun":
            # reference SunLight.cpp: direction points scene->sun; radiance
            # given directly or via irradiance / sun disk area
            d = _light_direction(obj)
            angle = obj.get_number("angle", 0.533)
            from ..models.skysun import sun_area_from_angle
            cos_angle = math.cos(math.radians(angle / 2.0))
            if "radiance" in obj.props:
                rad = _as_color_const(obj.get("radiance"), (1, 1, 1))
            else:
                irr = _as_color_const(obj.get("irradiance"), (1, 1, 1))
                if irr is None:
                    irr = np.ones(3)
                rad = irr / sun_area_from_angle(angle)
            l_rows.append(light_row(kind=int(LightKind.SUN), dir=-d,
                                    intensity=rad, p0=cos_angle,
                                    delta=False, infinite=True))
        elif t in ("cie_uniform", "cieuniform", "cie_cloudy", "ciecloudy",
                   "cie_clear", "cieclear", "cie_intermediate",
                   "cieintermediate"):
            from ..models.daylight import bake_cie
            from ..models.texture import make_image_texture
            kind = (t.replace("cie_", "").replace("cie", ""))
            d = _light_direction(obj)
            img = bake_cie(
                kind, d,
                _as_color_const(obj.get("zenith"), (1, 1, 1)),
                _as_color_const(obj.get("ground"), (1, 1, 1)),
                _prop_number(obj, "ground_brightness", 0.2, texreg),
                _prop_number(obj, "turbidity", 2.45, texreg),
                obj.get_bool("has_ground", True),
                _as_color_const(obj.get("scale"), (1, 1, 1)))
            td, ta = make_image_texture(img, filt=1)
            tid = texreg.add(f"__cie_{name}", td, ta)
            envmap = _build_env_cdf(img, compensate=False)
            l_rows.append(light_row(kind=int(LightKind.ENV),
                                    intensity=np.ones(3), tex=tid,
                                    infinite=True))
        elif t in ("perez",):
            from ..models.daylight import bake_perez, perez_model
            from ..models.texture import make_image_texture
            d = _light_direction(obj)
            sz = math.pi / 2 - math.asin(max(-1.0, min(1.0, d[1])))
            import datetime
            try:
                day = datetime.date(obj.get_int("year", 2020),
                                    obj.get_int("month", 5),
                                    obj.get_int("day", 6)).timetuple().tm_yday
            except ValueError:
                day = 127
            day = _prop_number(obj, "day_of_the_year", day, texreg)
            if "diffuse_irradiance" in obj.props or "direct_irradiance" in obj.props                or "direct_horizontal_irradiance" in obj.props:
                direct = _prop_number(obj, "direct_irradiance", -1.0, texreg)
                if direct < 0:
                    dh = _prop_number(obj, "direct_horizontal_irradiance", 1.0, texreg)
                    direct = dh / max(math.cos(sz), 1e-6)
                model = perez_model(
                    sz, day,
                    diffuse_irrad=_prop_number(obj, "diffuse_irradiance", 1.0, texreg),
                    direct_irrad=direct)
            else:
                model = perez_model(
                    sz, day,
                    brightness=_prop_number(obj, "brightness", 0.2, texreg),
                    clearness=_prop_number(obj, "clearness", 1.0, texreg))
            has_sun = obj.get_bool("has_sun", True)
            img, sun_rad, cos_angle = bake_perez(
                d, model,
                tint=_as_color_const(obj.get("color"), (1, 1, 1)),
                ground=_as_color_const(obj.get("ground"), (0.2, 0.2, 0.2)),
                has_ground=obj.get_bool("has_ground", True),
                has_sun=has_sun,
                output=obj.get_string("output", "visibleradiance").lower())
            td, ta = make_image_texture(img, filt=1)
            tid = texreg.add(f"__perez_{name}", td, ta)
            envmap = _build_env_cdf(img, compensate=False)
            l_rows.append(light_row(kind=int(LightKind.ENV),
                                    intensity=np.ones(3), tex=tid,
                                    infinite=True))
            if sun_rad is not None:
                l_rows.append(light_row(kind=int(LightKind.SUN), dir=-d,
                                        intensity=np.asarray(sun_rad),
                                        p0=cos_angle, delta=False,
                                        infinite=True))
        elif t in ("sky",):
            # Hosek-Wilkie sky baked to an equirect env texture + CDF
            from ..models.skysun import bake_sky
            from ..models.texture import make_image_texture
            d = _light_direction(obj)
            turb = obj.get_number("turbidity", 3.0)
            ground = obj.get_vec3("ground", (0.8, 0.8, 0.8))
            scale = _as_color_const(obj.get("scale"), (1, 1, 1))
            sky_img = bake_sky(d, turb, ground)
            td, ta = make_image_texture(sky_img, filt=1)
            tid = texreg.add(f"__sky_{name}", td, ta)
            envmap = _build_env_cdf(sky_img, compensate=False)
            l_rows.append(light_row(kind=int(LightKind.ENV),
                                    intensity=scale, tex=tid, infinite=True))
        else:
            warnings.append(f"Unsupported light type '{t}', skipped")

    # --- pack tables -------------------------------------------------------
    n_tris = len(tri_v0)

    def _reorder_soup(perm):
        # Reorders every per-triangle column into BVH leaf order and
        # remaps area-light tri ids; `perm` maps new position -> original
        # index.
        nonlocal tri_v0, tri_e1, tri_e2, tri_ent, tri_area, tri_shadow, \
            area_tris
        inv_perm = np.empty(len(tri_v0), dtype=perm.dtype)
        inv_perm[perm] = np.arange(len(perm), dtype=perm.dtype)
        take3 = lambda lst: list(np.asarray(lst, np.float32)
                                 .reshape(-1, 3)[perm])
        tri_v0 = take3(tri_v0)
        tri_e1 = take3(tri_e1)
        tri_e2 = take3(tri_e2)
        for k in range(3):
            tri_n[k][:] = take3(tri_n[k])
            tri_uv[k][:] = list(np.asarray(tri_uv[k], np.float32)
                                .reshape(-1, 2)[perm])
        tri_ent = list(np.asarray(tri_ent, np.int32)[perm])
        tri_area = list(np.asarray(tri_area, np.float32)[perm])
        tri_shadow = list(np.asarray(tri_shadow, bool)[perm])
        area_tris = [int(inv_perm[i]) for i in area_tris]

    # BVH for non-tiny scenes: one binned-SAH tri-leaf BVH8 (C++ builder
    # when available) over the soup in its leaf order. Below the
    # threshold the soup is swept densely (ops/intersect.py).
    bvh_arrays = None
    if n_tris >= BVH_THRESHOLD:
        from ..bvh.builder import build_bvh8
        from ..native import build_bvh8_native
        from ..ops.bvh import BVHArrays
        _v0 = np.asarray(tri_v0, np.float32).reshape(-1, 3)
        _e1 = np.asarray(tri_e1, np.float32).reshape(-1, 3)
        _e2 = np.asarray(tri_e2, np.float32).reshape(-1, 3)

        def _build_all():
            bvh_np = build_bvh8_native(_v0, _e1, _e2)
            if bvh_np is None:
                bvh_np = build_bvh8(_v0, _e1, _e2)
            return {f: np.asarray(getattr(bvh_np, f))
                    for f in BVHArrays._fields + ("prim_order",)}

        # Built-BVH cache (CacheManager analog): keyed on the exact soup
        from ..utils.cache import cached_arrays
        z = cached_arrays("bvh8_tri", (_v0, _e1, _e2), _build_all)
        _reorder_soup(np.asarray(z["prim_order"], np.int64))
        bvh_arrays = BVHArrays(*[jnp.asarray(z[f])
                                 for f in BVHArrays._fields])

    pad = (-n_tris) % TRI_CHUNK
    if n_tris == 0:
        pad = TRI_CHUNK

    def pad3(lst, fill=0.0):
        a = np.asarray(lst, np.float32).reshape(-1, 3) if lst else np.zeros((0, 3), np.float32)
        return np.vstack([a, np.full((pad, 3), fill, np.float32)])

    def soa3(a):
        return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))

    def soa2(a):
        return Vec2(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]))

    v0 = pad3(tri_v0)
    e1 = pad3(tri_e1)
    e2 = pad3(tri_e2)
    tris = TriSoup(soa3(v0), soa3(e1), soa3(e2))

    def pad2(lst):
        a = np.asarray(lst, np.float32).reshape(-1, 2) if lst else np.zeros((0, 2), np.float32)
        return np.vstack([a, np.zeros((pad, 2), np.float32)])

    attr = TriAttributes(
        n0=soa3(pad3(tri_n[0])), n1=soa3(pad3(tri_n[1])), n2=soa3(pad3(tri_n[2])),
        uv0=soa2(pad2(tri_uv[0])), uv1=soa2(pad2(tri_uv[1])), uv2=soa2(pad2(tri_uv[2])),
        ent=jnp.asarray(np.concatenate([np.asarray(tri_ent, np.int32),
                                        np.full(pad, -1, np.int32)])),
        area=jnp.asarray(np.concatenate([np.asarray(tri_area, np.float32),
                                         np.zeros(pad, np.float32)])),
        shadow_visible=jnp.asarray(np.concatenate([
            np.asarray(tri_shadow, bool), np.zeros(pad, bool)])),
    )

    spheres = SphereSoup(
        center=soa3(np.asarray(sph_center, np.float32).reshape(-1, 3)),
        radius=jnp.asarray(np.asarray(sph_radius, np.float32)))
    sph_attr = SphereAttributes(
        ent=jnp.asarray(np.asarray(sph_ent, np.int32)),
        shadow_visible=jnp.asarray(np.asarray(sph_shadow, bool)))

    n_ent = max(len(ent_names), 1)
    entities = Entities(
        mat=jnp.asarray(np.asarray(ent_mat or [0], np.int32)),
        light=jnp.asarray(np.asarray(ent_light or [-1], np.int32)),
        med_inner=jnp.asarray(np.asarray(ent_med_in or [-1], np.int32)),
        med_outer=jnp.asarray(np.asarray(ent_med_out or [-1], np.int32)))

    def col_arr(key):
        return Color(*[jnp.asarray(np.asarray([r[key][i] for r in mat_rows],
                                              np.float32)) for i in range(3)])

    materials = Materials(
        kind=jnp.asarray(np.asarray([r["kind"] for r in mat_rows], np.int32)),
        base=col_arr("base"), extra=col_arr("extra"), extra2=col_arr("extra2"),
        p0=jnp.asarray(np.asarray([r["p0"] for r in mat_rows], np.float32)),
        p1=jnp.asarray(np.asarray([r["p1"] for r in mat_rows], np.float32)),
        p2=jnp.asarray(np.asarray([r["p2"] for r in mat_rows], np.float32)),
        p3=jnp.asarray(np.asarray([r["p3"] for r in mat_rows], np.float32)),
        **{k: jnp.asarray(np.asarray([r[k] for r in mat_rows], np.float32))
           for k in ("q0", "q1", "q2", "q3", "q4", "q5", "q6", "q7", "q8")},
        base_tex=jnp.asarray(np.asarray([r["base_tex"] for r in mat_rows], np.int32)),
        extra_tex=jnp.asarray(np.asarray([r["extra_tex"] for r in mat_rows], np.int32)),
        p0_tex=jnp.asarray(np.asarray([r["p0_tex"] for r in mat_rows], np.int32)),
        p1_tex=jnp.asarray(np.asarray([r["p1_tex"] for r in mat_rows], np.int32)),
        bump_kind=jnp.asarray(np.asarray([r["bump_kind"] for r in mat_rows], np.int32)),
        bump_tex=jnp.asarray(np.asarray([r["bump_tex"] for r in mat_rows], np.int32)),
        bump_strength=jnp.asarray(np.asarray([r["bump_strength"] for r in mat_rows], np.float32)),
    )

    if not l_rows:
        l_rows.append(light_row(intensity=np.zeros(3)))
        n_lights = 0
    else:
        n_lights = len(l_rows)

    def lcol(key):
        a = np.asarray([r[key] for r in l_rows], np.float32)
        return a

    # Flux-weighted selection CDF (LoaderLight::generateLightSelectionCDF)
    if all_points:
        _pts = np.vstack(all_points)
        _scene_r = float(np.linalg.norm(_pts.max(0) - _pts.min(0)) * 0.5) or 1.0
    else:
        _scene_r = 1.0

    def light_flux(r):
        kind = r["kind"]
        mi = float(np.mean(r["intensity"]))
        if kind == int(LightKind.POINT):
            return 4 * np.pi * mi
        if kind == int(LightKind.SPOT):
            return 2 * np.pi * (1 - r["p0"]) * mi
        if kind == int(LightKind.AREA):
            return np.pi * r["p0"] * mi
        return np.pi * _scene_r * _scene_r * max(mi, 1e-3)

    fluxes = np.asarray([max(light_flux(r), 1e-8) for r in l_rows], np.float64)
    select_cdf = np.cumsum(fluxes) / fluxes.sum()

    # Light hierarchy over finite lights (LightHierarchy.cpp): balanced
    # median-split tree, sibling-adjacent layout (right = left + 1),
    # per-light path codes for the pdf backtrack.
    def _light_centroid(r):
        if r["kind"] == int(LightKind.AREA) and int(r["tri_count"]) > 0:
            s, c = int(r["tri_start"]), int(r["tri_count"])
            ids = [int(area_tris[s + k]) for k in range(c)]
            cen = [np.asarray(tri_v0[t], np.float64)
                   + (np.asarray(tri_e1[t], np.float64)
                      + np.asarray(tri_e2[t], np.float64)) / 3.0
                   for t in ids]
            return np.mean(cen, axis=0)
        return np.asarray(r["pos"], np.float64).reshape(3)

    h_entries: List = []  # (pos, dir, flux, has_dir, child)
    h_codes = np.zeros(len(l_rows), np.int32)
    finite_rows = [i for i, r in enumerate(l_rows)
                   if not r["infinite"] and n_lights > 0]
    if finite_rows:
        h_pos = {i: _light_centroid(l_rows[i]) for i in finite_rows}

        def _emit_into(rows, slot, code, depth):
            if len(rows) == 1:
                i = rows[0]
                r = l_rows[i]
                has_dir = r["kind"] == int(LightKind.SPOT)
                h_codes[i] = code
                h_entries[slot] = (h_pos[i],
                                   np.asarray(r["dir"], np.float64).reshape(3),
                                   float(fluxes[i]), has_dir, i)
                return h_entries[slot]
            ps = np.asarray([h_pos[i] for i in rows])
            axis = int(np.argmax(ps.max(0) - ps.min(0)))
            order = np.argsort(ps[:, axis], kind="stable")
            mid = len(rows) // 2
            left_rows = [rows[k] for k in order[:mid]]
            right_rows = [rows[k] for k in order[mid:]]
            li = len(h_entries)
            h_entries.extend([None, None])
            le = _emit_into(left_rows, li, code, depth + 1)
            re = _emit_into(right_rows, li + 1, code | (1 << depth),
                            depth + 1)
            d = le[1] + re[1]
            dn = np.linalg.norm(d)
            agg = ((le[0] + re[0]) * 0.5,
                   d / dn if dn > 1e-9 else np.array([0.0, 0.0, 1.0]),
                   le[2] + re[2], le[3] and re[3], -(li + 1))
            h_entries[slot] = agg
            return agg

        h_entries.append(None)
        _emit_into(finite_rows, 0, 0, 0)

    def _hcol(j, dtype=np.float32):
        return np.asarray([e[j] for e in h_entries] or [0], dtype)

    lights = Lights(
        select_cdf=jnp.asarray(select_cdf.astype(np.float32)),
        hier_pos=soa3(np.asarray([e[0] for e in h_entries]
                                 or [[0, 0, 0]], np.float32)),
        hier_dir=soa3(np.asarray([e[1] for e in h_entries]
                                 or [[0, 0, 1]], np.float32)),
        hier_flux=jnp.asarray(_hcol(2)),
        hier_has_dir=jnp.asarray(_hcol(3, bool)),
        hier_child=jnp.asarray(_hcol(4, np.int32)),
        hier_code=jnp.asarray(h_codes),
        kind=jnp.asarray(lcol("kind").astype(np.int32)),
        pos=soa3(lcol("pos")), dir=soa3(lcol("dir")),
        intensity=Color(*[jnp.asarray(lcol("intensity")[:, i]) for i in range(3)]),
        p0=jnp.asarray(lcol("p0")), p1=jnp.asarray(lcol("p1")),
        p2=jnp.asarray(lcol("p2")),
        entity=jnp.asarray(lcol("entity").astype(np.int32)),
        tri_start=jnp.asarray(lcol("tri_start").astype(np.int32)),
        tri_count=jnp.asarray(lcol("tri_count").astype(np.int32)),
        tex=jnp.asarray(lcol("tex").astype(np.int32)),
        delta=jnp.asarray(lcol("delta").astype(bool)),
        infinite=jnp.asarray(lcol("infinite").astype(bool)),
        area_tris=jnp.asarray(np.asarray(area_tris or [0], np.int32)),
        area_cdf=jnp.asarray(np.asarray(area_cdf or [0.0], np.float32)),
    )

    media = Media(
        sigma_a=Color(*[jnp.asarray(np.asarray([r[0][i] for r in med_rows] or [0.0],
                                               np.float32)) for i in range(3)]),
        sigma_s=Color(*[jnp.asarray(np.asarray([r[1][i] for r in med_rows] or [0.0],
                                               np.float32)) for i in range(3)]),
        g=jnp.asarray(np.asarray([r[2] for r in med_rows] or [0.0], np.float32)))

    # --- scene bounds ------------------------------------------------------
    if all_points:
        pts = np.vstack(all_points)
        bmin, bmax = pts.min(0), pts.max(0)
    else:
        bmin, bmax = np.zeros(3), np.zeros(3)
    center = 0.5 * (bmin + bmax)
    radius = float(np.linalg.norm(bmax - bmin) * 0.5)
    if radius <= 0:
        radius = 1.0

    # --- camera ------------------------------------------------------------
    if cam_transform is not None:
        eye = cam_transform[:3, 3]
        cdir = cam_transform[:3, 2]
        cup = cam_transform[:3, 1]
    else:
        eye = np.array([0.0, 0.0, 0.0])
        cdir = np.array([0.0, 0.0, -1.0])
        cup = np.array([0.0, 1.0, 0.0])
    camera = CameraData(
        eye=Vec3(*[jnp.float32(v) for v in eye]),
        dir=Vec3(*[jnp.float32(v) for v in cdir / np.linalg.norm(cdir)]),
        up=Vec3(*[jnp.float32(v) for v in cup / np.linalg.norm(cup)]),
        scale=Vec2(jnp.float32(sw), jnp.float32(sh)),
        tmin=jnp.float32(near), tmax=jnp.float32(far),
        aperture=jnp.float32(cam.get_number("aperture_radius", 0.0) if cam else 0.0),
        focal=jnp.float32(cam.get_number("focal_length", 1.0) if cam else 1.0))

    infinite_rows = tuple(int(i) for i, r in enumerate(l_rows)
                          if r["infinite"] and n_lights > 0)

    # dynamic registry: numeric/vector scene parameters become traced
    # pytree leaves (reference ParameterSet / registry.art) so setParameter
    # re-renders without rebuild or recompile
    registry = {}
    for pname, p in (scene.parameters or {}).items():
        if isinstance(p, dict):
            ptype, val = p.get("type", "number"), p.get("value", 0)
        else:
            ptype, val = "number", p
        try:
            if ptype in ("number", "num", "int") and isinstance(
                    val, (int, float)):
                registry[pname] = jnp.float32(val)
            elif ptype in ("vector", "color") and hasattr(val, "__len__"):
                registry[pname] = jnp.asarray(
                    [float(x) for x in val], jnp.float32)
        except Exception:
            pass  # strings and malformed values stay baked-only

    data = SceneData(tris=tris, tri_attr=attr, spheres=spheres,
                     sph_attr=sph_attr, entities=entities, materials=materials,
                     lights=lights, envmap=envmap, camera=camera, media=media,
                     textures=tuple(texreg.datas),
                     bvh=bvh_arrays,
                     scene_radius=jnp.float32(radius),
                     scene_center=Vec3(*[jnp.float32(v) for v in center]),
                     measured=tuple(texreg.measured),
                     registry=registry,
                     instances=instanced_geo)

    settings = RenderSettings(
        width=width, height=height, technique=tech_type,
        max_depth=max_depth, min_depth=min_depth, clamp=clamp,
        enable_nee=enable_nee,
        spi=int(overrides.get("spi", 1)), seed=int(overrides.get("seed", 0)),
        pixel_sampler=str(overrides.get("pixel_sampler", "uniform")),
        camera_type=cam_type, fish_mode=fish_mode,
        # "simple" is the reference's name for the flux-CDF selector
        # (LoaderLight.cpp:440)
        light_selector={"simple": "cdf"}.get(
            (tech.get_string("light_selector", "uniform") or "uniform")
            if tech else "uniform",
            (tech.get_string("light_selector", "uniform") or "uniform")
            if tech else "uniform"),
        infinite_light_rows=infinite_rows, n_lights=n_lights,
        texture_descs=tuple(texreg.descs),
        medium_exprs=tuple(med_exprs),
        has_blend=has_blend,
        has_bump=any(r["bump_kind"] != 0 and r["bump_tex"] >= 0
                     for r in mat_rows),
        transparent_shadows=(
            os.environ.get("IGNIS_TRANSPARENT_SHADOWS", "1") == "1"
            and any(
                r["kind"] in (int(BsdfKind.PASSTHROUGH),
                              int(BsdfKind.RAD_BRTDF),
                              int(BsdfKind.RAD_ROOS))
                or (r["kind"] == int(BsdfKind.DIELECTRIC) and r["p3"] > 0.5)
                for r in mat_rows)),
        bsdf_kinds=tuple(sorted(
            {int(r["kind"]) for r in mat_rows}
            # ROUGH_FLAG pseudo-kinds: emitted only when a kind has at
            # least one rough row, so all-smooth scenes statically drop
            # the microfacet code from their shaders (models/bsdf.py)
            | {ROUGH_FLAG + int(r["kind"]) for r in mat_rows
               if r["kind"] in (int(BsdfKind.CONDUCTOR),
                                int(BsdfKind.DIELECTRIC))
               and max(float(r.get("p2", 0.0)),
                       float(r.get("p3", 0.0))
                       if r["kind"] == int(BsdfKind.CONDUCTOR) else 0.0)
               > 1e-4}
            | {THIN_FLAG + int(BsdfKind.DIELECTRIC) for r in mat_rows
               if r["kind"] == int(BsdfKind.DIELECTRIC)
               and float(r.get("p3", 0.0)) > 0.5})),
        light_kinds=tuple(sorted({int(r["kind"]) for r in l_rows})),
        env_cdf_method=env_cdf_method,
        debug_mode=_debug_mode_of(tech) if tech else 0,
        # photon mapping (PhotonMappingTechnique.cpp:14-20); the reference
        # default of 1e6 photons is kept, overridable for tests
        photon_count=max(100, int(overrides.get(
            "photons", tech.get_int("photons", 1000000) if tech else 1000000))),
        max_light_depth=tech.get_int("max_light_depth", 8) if tech else 8,
        merge_radius=tech.get_number("radius", 0.01) if tech else 0.01,
        learning_iterations=max(
            1, tech.get_int("learning_iterations", 1)) if tech else 1)

    return BuiltScene(data=data, settings=settings, warnings=warnings)


def _append_mesh(m: meshlib.TriMesh, eid: int, shadow_visible: bool,
                 tri_v0, tri_e1, tri_e2, tri_n, tri_uv, tri_ent, tri_area,
                 tri_shadow, ent_tri_range, ent_name):
    start = len(tri_v0)
    v = m.vertices
    i = m.indices
    p0 = v[i[:, 0]]
    p1 = v[i[:, 1]]
    p2 = v[i[:, 2]]
    e1 = p1 - p0
    e2 = p2 - p0
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)
    tri_v0.extend(p0)
    tri_e1.extend(e1)
    tri_e2.extend(e2)
    for k in range(3):
        tri_n[k].extend(m.normals[i[:, k]])
        tri_uv[k].extend(m.texcoords[i[:, k]])
    tri_ent.extend([eid] * len(i))
    tri_area.extend(areas)
    tri_shadow.extend([shadow_visible] * len(i))
    ent_tri_range[ent_name] = (start, len(i))


def _build_env_cdf(img: np.ndarray, compensate: bool,
                   method: str = "conditional") -> EnvMap:
    """Build the env importance tables (reference CDF::computeForImage /
    LoaderUtils setup_cdf2d{,_sat,_hierachical}): row-luminance weights
    premultiplied by sin(theta), optional MIS compensation, under the
    selected "cdf" method. Rows are flipped so row 0 = v=0 = bottom,
    matching the uv space of models/light.py env sampling."""
    w = np.maximum(img, 0.0).mean(axis=-1)  # colorResponse
    defect = 0.0
    if compensate:
        d = float(w.mean())
        if abs(float(w.min()) - d) >= 1e-4:
            defect = d
    w = np.maximum(w - defect, 0.0)
    w = w[::-1]  # flip: row 0 becomes bottom (v=0)
    h = w.shape[0]
    sin_theta = np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None]
    weights = (w * sin_theta).astype(np.float32)
    zero1 = jnp.zeros((1,), jnp.float32)
    zero2 = jnp.zeros((1, 1), jnp.float32)
    if method == "sat":
        from ..core.cdf import build_sat_2d
        sat = build_sat_2d(weights)
        return EnvMap(jnp.asarray(True), zero1, zero2,
                      sat_table=sat.table, sat_grid=sat.grid)
    if method in ("hierachical", "hierarchical"):
        from ..core.cdf import build_hier_2d
        hz = build_hier_2d(weights)
        return EnvMap(jnp.asarray(True), zero1, zero2,
                      hier_levels=hz.levels)
    from ..core.cdf import build_cdf_2d
    cdf = build_cdf_2d(jnp.asarray(weights))
    return EnvMap(jnp.asarray(True), cdf.marginal, cdf.conditional)


def _prop_number(obj: SceneObject, key, default, texreg=None):
    """Number property that may be a constant PExpr string."""
    v = obj.get(key, default)
    if isinstance(v, str):
        if texreg is not None:
            c = texreg.eval_constant_number(v)
            if c is not None:
                return c
        return default
    return float(v)


def _roughness_uv(obj: SceneObject, texreg=None):
    """Reference BSDF::setupRoughness semantics: 'roughness'/'alpha' (+_u/_v
    variants) + 'anisotropic'; alpha == roughness (no remap); no property at
    all means a delta distribution."""
    name = "alpha" if ("alpha" in obj.props or "alpha_u" in obj.props
                       or "alpha_v" in obj.props) else "roughness"
    if name + "_u" in obj.props or name + "_v" in obj.props:
        ru = _prop_number(obj, name + "_u", 0.1, texreg)
        rv = _prop_number(obj, name + "_v", ru, texreg)
        return ru, rv
    if name not in obj.props:
        return 0.0, 0.0
    r = _prop_number(obj, name, 0.1, texreg)
    aniso = _prop_number(obj, "anisotropic", 0.0, texreg)
    aspect = math.sqrt(1.0 - min(max(aniso, 0.0), 1.0) * 0.99)
    return r / aspect, r * aspect


def _light_direction(obj: SceneObject) -> np.ndarray:
    """LoaderUtils::getDirection: direction | sun_direction |
    elevation/azimuth | sun position from date/time/location (Y-up)."""
    from ..models.skysun import compute_sun_ea, ea_to_direction_yup
    if "direction" in obj.props:
        d = obj.get_vec3("direction", (0, 0, 1))
    elif "sun_direction" in obj.props:
        d = obj.get_vec3("sun_direction", (0, 0, 1))
    elif "elevation" in obj.props or "azimuth" in obj.props:
        # NOTE: reference takes elevation/azimuth in radians, west of south
        d = ea_to_direction_yup(obj.get_number("elevation", 0.0),
                                obj.get_number("azimuth", 0.0))
    else:
        el, az = compute_sun_ea(
            obj.get_int("year", 2020), obj.get_int("month", 5),
            obj.get_int("day", 6), obj.get_int("hour", 12),
            obj.get_int("minute", 0), obj.get_number("seconds", 0.0),
            obj.get_number("latitude", 49.235422),
            obj.get_number("longitude", -6.9965744),
            obj.get_number("timezone", -2.0))
        d = ea_to_direction_yup(el, az)
    n = np.linalg.norm(d)
    return d / n if n > 0 else np.array([0, 0, 1.0])
