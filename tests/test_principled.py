"""Principled BSDF consistency tests."""
import numpy as np
import jax.numpy as jnp
import pytest

from ignis_tpu.core.vec import color
from ignis_tpu.models import bsdf as B
from test_bsdf import N, check_consistency, frame_z, make_mat, rand_dirs, \
    uniforms


def make_principled(n, **kw):
    o = jnp.ones(n)
    z = jnp.zeros(n)
    defaults = dict(p0=1.5, p1=1.5, p2=0.5, p3=0.5, q0=0.0, q1=0.0, q2=0.0,
                    q3=0.0, q4=0.0, q5=0.0, q6=0.0, q7=0.1, q8=0.0)
    defaults.update(kw)
    mat = make_mat(B.BsdfKind.PRINCIPLED, n,
                   base=color(o * 0.8, o * 0.6, o * 0.4), **defaults)
    return mat._replace(extra2=color(z, z, z))


def test_diffuse_rough_consistency():
    check_consistency(make_principled(N), atol=5e-2)


def test_metallic_consistency():
    check_consistency(make_principled(N, q0=1.0, p2=0.3, p3=0.3), atol=5e-2)


def test_specular_transmission_consistency():
    check_consistency(make_principled(N, q1=1.0, p2=0.4, p3=0.4), atol=8e-2)


def test_clearcoat_consistency():
    check_consistency(make_principled(N, q5=1.0, q6=0.5), atol=5e-2)


def test_energy_sanity():
    """White-ish furnace: rough diffuse principled reflects < 1."""
    n = 4096
    mat = make_principled(n)
    f = frame_z(n)
    wo = rand_dirs(n, 21)
    u0, u1, u2 = uniforms(n, 22)
    s = B.sample_bsdf(mat, f, jnp.full(n, True), wo, u0, u1, u2)
    w = np.asarray(s.weight.r)[np.asarray(s.valid)]
    assert np.isfinite(w).all()
    assert w.mean() < 1.5  # no energy explosion
