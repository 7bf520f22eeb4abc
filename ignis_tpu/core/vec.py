"""SoA 3-vector / color math.

Vectors are stored as structs-of-arrays: three (or four) equally-shaped float32
arrays. This keeps the vectorized dimension on the ray axis instead of a
trailing size-3 dimension, so every component is one contiguous array.

Mirrors the semantics of the reference's vector library
(/root/reference/src/artic/core/vector.art, color.art) with an idiomatic
JAX SoA design.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import jax.numpy as jnp

Array = jnp.ndarray
Scalar = Union[float, Array]


class Vec2(NamedTuple):
    x: Array
    y: Array

    def __add__(self, o: "Vec2") -> "Vec2":
        return Vec2(self.x + o.x, self.y + o.y)

    def __sub__(self, o: "Vec2") -> "Vec2":
        return Vec2(self.x - o.x, self.y - o.y)

    def __mul__(self, s: Scalar) -> "Vec2":
        return Vec2(self.x * s, self.y * s)


class Vec3(NamedTuple):
    x: Array
    y: Array
    z: Array

    # -- arithmetic -------------------------------------------------------
    def __add__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    def __sub__(self, o: "Vec3") -> "Vec3":
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __mul__(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    def __rmul__(self, s: Scalar) -> "Vec3":
        return Vec3(self.x * s, self.y * s, self.z * s)

    def __neg__(self) -> "Vec3":
        return Vec3(-self.x, -self.y, -self.z)

    def cmul(self, o: "Vec3") -> "Vec3":
        """Component-wise product."""
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)


def vec3(x, y, z) -> Vec3:
    return Vec3(jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
                jnp.asarray(z, jnp.float32))


def vec3_full(v, shape=()) -> Vec3:
    a = jnp.full(shape, v, jnp.float32)
    return Vec3(a, a, a)


def vec3_from_array(a: Array) -> Vec3:
    """Convert a trailing-dim-3 array to SoA (host/setup use only)."""
    return Vec3(a[..., 0], a[..., 1], a[..., 2])


def to_array(v: Vec3) -> Array:
    return jnp.stack([v.x, v.y, v.z], axis=-1)


def dot(a: Vec3, b: Vec3) -> Array:
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(a.y * b.z - a.z * b.y,
                a.z * b.x - a.x * b.z,
                a.x * b.y - a.y * b.x)


def length_squared(a: Vec3) -> Array:
    return dot(a, a)


def length(a: Vec3) -> Array:
    # max() keeps reverse-mode finite at zero vectors (sqrt'(0) = inf)
    return jnp.sqrt(jnp.maximum(dot(a, a), 1e-24))


def safe_div(a, b):
    """a/b with 0 where b == 0 (matches reference safe_div semantics)."""
    return jnp.where(b == 0, 0.0, a / jnp.where(b == 0, 1.0, b))


def normalize(a: Vec3) -> Vec3:
    # 1e-12 floor: rsqrt' stays finite in float32 reverse-mode
    l2 = dot(a, a)
    il = jnp.where(l2 > 0, 1.0 / jnp.sqrt(jnp.maximum(l2, 1e-12)), 0.0)
    return a * il


def reflect(i: Vec3, n: Vec3) -> Vec3:
    """Reflect direction `i` (pointing away from surface) about normal n."""
    return n * (2.0 * dot(i, n)) - i


def lerp(a, b, t):
    return a + (b - a) * t


def vlerp(a: Vec3, b: Vec3, t) -> Vec3:
    return Vec3(lerp(a.x, b.x, t), lerp(a.y, b.y, t), lerp(a.z, b.z, t))


def vselect(m: Array, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.where(m, a.x, b.x), jnp.where(m, a.y, b.y), jnp.where(m, a.z, b.z))


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y), jnp.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y), jnp.maximum(a.z, b.z))


def max_component(a: Vec3) -> Array:
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))


def min_component(a: Vec3) -> Array:
    return jnp.minimum(a.x, jnp.minimum(a.y, a.z))


def abs3(a: Vec3) -> Vec3:
    return Vec3(jnp.abs(a.x), jnp.abs(a.y), jnp.abs(a.z))


# ---------------------------------------------------------------------------
# Colors (RGB, SoA). The reference carries an alpha channel in its Color; we
# track RGB only and handle AOV alpha separately.
# ---------------------------------------------------------------------------

class Color(NamedTuple):
    r: Array
    g: Array
    b: Array

    def __add__(self, o: "Color") -> "Color":
        return Color(self.r + o.r, self.g + o.g, self.b + o.b)

    def __sub__(self, o: "Color") -> "Color":
        return Color(self.r - o.r, self.g - o.g, self.b - o.b)

    def __mul__(self, s: Scalar) -> "Color":
        return Color(self.r * s, self.g * s, self.b * s)

    def __rmul__(self, s: Scalar) -> "Color":
        return Color(self.r * s, self.g * s, self.b * s)

    def cmul(self, o: "Color") -> "Color":
        return Color(self.r * o.r, self.g * o.g, self.b * o.b)


def color(r, g, b) -> Color:
    return Color(jnp.asarray(r, jnp.float32), jnp.asarray(g, jnp.float32),
                 jnp.asarray(b, jnp.float32))


def gray(v, shape=()) -> Color:
    a = jnp.broadcast_to(jnp.asarray(v, jnp.float32), shape)
    return Color(a, a, a)


def black(shape=()) -> Color:
    z = jnp.zeros(shape, jnp.float32)
    return Color(z, z, z)


def white(shape=()) -> Color:
    o = jnp.ones(shape, jnp.float32)
    return Color(o, o, o)


def luminance(c: Color) -> Array:
    # Reference: color_luminance (color.art) uses Rec. 709 weights.
    return 0.2126 * c.r + 0.7152 * c.g + 0.0722 * c.b


def color_average(c: Color) -> Array:
    return (c.r + c.g + c.b) * (1.0 / 3.0)


def color_max_component(c: Color) -> Array:
    return jnp.maximum(c.r, jnp.maximum(c.g, c.b))


def cselect(m: Array, a: Color, b: Color) -> Color:
    return Color(jnp.where(m, a.r, b.r), jnp.where(m, a.g, b.g), jnp.where(m, a.b, b.b))


def clerp(a: Color, b: Color, t) -> Color:
    return Color(lerp(a.r, b.r, t), lerp(a.g, b.g, t), lerp(a.b, b.b, t))


def saturate(c: Color, mx) -> Color:
    """Clamp each channel to [0, mx] (reference color_saturate)."""
    return Color(jnp.clip(c.r, 0.0, mx), jnp.clip(c.g, 0.0, mx), jnp.clip(c.b, 0.0, mx))
