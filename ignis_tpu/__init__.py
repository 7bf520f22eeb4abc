"""ignis_tpu — a differentiable wavefront path tracer in JAX.

A from-scratch JAX/XLA/Pallas re-design with the capabilities of
PearCoding/Ignis (the reference renderer): JSON scene format, wavefront path
tracing with NEE/MIS, the BSDF/light/camera/texture zoo, tonemapping and
image tooling — built around SoA wavefronts, masked dispatch instead of
kernel specialization, lax.scan bounce loops, a per-ray BVH walk kernel on
NVIDIA GPUs, shard_map multi-card scaling, and end-to-end
differentiability.
"""
from .render.session import Runtime, render_iteration
from .scene.parser import load_from_file, load_from_string
from .scene.build import build_scene

__version__ = "0.1.0"


def loadFromFile(path, **overrides) -> Runtime:
    """Reference-API-compatible alias (Python API runtime.cpp:115)."""
    return Runtime.load_from_file(path, **overrides)


def loadFromString(text, base_dir=".", **overrides) -> Runtime:
    return Runtime.load_from_string(text, base_dir, **overrides)
