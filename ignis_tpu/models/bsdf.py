"""BSDF evaluation / sampling / pdf with masked type dispatch.

The reference JIT-compiles one specialized hit-shader per material
(/root/reference/src/runtime/shader/HitShader.cpp:16) and sorts rays by
material. Here every BSDF *kind* present in the scene is evaluated for
every lane with masks and select — uniform control flow, no sorting, no
divergence; XLA fuses the whole dispatch into one kernel.

Semantics mirror /root/reference/src/artic/bsdf/*.art:
  - eval(in_dir, out_dir) includes the cosine term; delta lobes eval to 0
  - sample() returns weight = eval/pdf (cosine included), eta ratio, delta flag
  - rough lobes: GGX with visible-normal sampling (core/microfacet.py)
  - alpha <= 1e-4 degenerates to the delta (perfect) variant

Material parameter slots (scenedata.Materials):
  DIFFUSE:    base=reflectance, p1=roughness (Oren-Nayar alpha)
  DIELECTRIC: base=spec_refl, extra=spec_trans, p0=ext_ior, p1=int_ior,
              p2=alpha, p3=thin flag
  CONDUCTOR:  base=spec_refl, extra=eta, extra2=k, p2=alpha_u, p3=alpha_v
  PHONG:      base=spec_refl, p0=exponent
  PLASTIC:    base=diffuse_refl, extra=spec_refl, p0=ext_ior, p1=int_ior,
              p2=alpha
"""
from __future__ import annotations

from enum import IntEnum
from typing import NamedTuple

import jax.numpy as jnp

from ..core import fresnel as fr
from ..core import microfacet as mf
from ..core.frame import Frame, make_frame
from ..core.vec import (Color, Vec3, black, cselect, dot, normalize, reflect,
                        safe_div, vselect)
from ..core.warp import (INV_PI, cosine_hemisphere_pdf,
                         cosine_power_hemisphere_pdf, sample_cosine_hemisphere,
                         sample_cosine_power_hemisphere)

EPS = 1e-6
DELTA_ALPHA = mf.DELTA_ALPHA


class BsdfKind(IntEnum):
    DIFFUSE = 0
    DIELECTRIC = 1
    CONDUCTOR = 2
    PASSTHROUGH = 3
    PHONG = 4
    PLASTIC = 5
    PRINCIPLED = 6
    NULL_ERROR = 7
    BLEND = 8      # p0 = weight (q-slot child indices resolved in build)
    # Radiance compliance models (reference bsdf/rad.art):
    # RAD_BRTDF: base=refl_spec extra=trns_spec extra2=trns_diff
    #            q0-2=refl_front_diffuse(+direct) q3-5=refl_back_diffuse(+dir)
    # RAD_ROOS:  base=(trns_w,p,q) extra=(refl_w,p,q), diffuse as above
    RAD_BRTDF = 9
    RAD_ROOS = 10
    # Measured (Klems / TensorTree XML): base=base_color extra2=up
    # q6=measured-table index
    KLEMS = 11
    TENSORTREE = 12
    # Measured (Dupuy-Jakob .bsdf): base=tint q6=measured index
    DJMEASURED = 13


class MatParams(NamedTuple):
    kind: jnp.ndarray
    base: Color
    extra: Color
    extra2: Color
    p0: jnp.ndarray
    p1: jnp.ndarray
    p2: jnp.ndarray
    p3: jnp.ndarray
    # extended slots (principled: q0=spec_trans q1=spec_tint q2=sheen
    # q3=sheen_tint q4=clearcoat q5=clearcoat_gloss q6=diffuse_transmission
    # q7=flatness+thin flag (thin if > 1) q8=clearcoat_roughness)
    q0: jnp.ndarray = None
    q1: jnp.ndarray = None
    q2: jnp.ndarray = None
    q3: jnp.ndarray = None
    q4: jnp.ndarray = None
    q5: jnp.ndarray = None
    q6: jnp.ndarray = None
    q7: jnp.ndarray = None
    q8: jnp.ndarray = None


class BsdfSample(NamedTuple):
    in_dir: Vec3
    pdf: jnp.ndarray
    weight: Color
    eta: jnp.ndarray
    is_delta: jnp.ndarray
    valid: jnp.ndarray


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def _conductor_fresnel(eta: Color, k: Color, cos_i) -> Color:
    """reference conductor_factor (fresnel.art): per channel."""
    def chan(n, kk):
        f = n * n + kk * kk
        c2 = cos_i * cos_i
        d1 = f * c2
        d2 = 2.0 * n * cos_i
        rs = safe_div(d1 - d2, d1 + d2)
        rp = safe_div(f - d2 + c2, f + d2 + c2)
        return jnp.clip((rs * rs + rp * rp) * 0.5, 0.0, 1.0)
    return Color(chan(eta.r, k.r), chan(eta.g, k.g), chan(eta.b, k.b))


def _fresnel_diffuse_factor(eta):
    """fresnel.art:42 (Egan/Hilgeman + d'Eon/Irving fits)."""
    lo = -1.4399 * eta * eta + 0.7099 * eta + 0.6681 + 0.0636 / jnp.maximum(eta, 1e-6)
    ie = 1.0 / jnp.maximum(eta, 1e-6)
    hi = (0.919317 - 3.4793 * ie + 6.75335 * ie ** 2 - 7.80989 * ie ** 3
          + 4.98554 * ie ** 4 - 1.36881 * ie ** 5)
    return jnp.where(eta < 1.0, lo, hi)


def _eta_ratio(mat: MatParams, is_entering):
    """n1/n2 along the propagation direction (dielectric/plastic)."""
    return jnp.where(is_entering, mat.p0 / jnp.maximum(mat.p1, 1e-6),
                     mat.p1 / jnp.maximum(mat.p0, 1e-6))


# ---------------------------------------------------------------------------
# Diffuse family
# ---------------------------------------------------------------------------

def _oren_nayar_eval(kd: Color, alpha, wi: Vec3, wo: Vec3):
    a2 = alpha * alpha
    p1 = jnp.maximum(wi.z, 0.0)
    p2 = jnp.maximum(wo.z, 0.0)
    s = -p1 * p2 + jnp.maximum(dot(wo, wi), 0.0)
    t = jnp.where(s <= EPS, 1.0, jnp.maximum(EPS, jnp.maximum(p1, p2)))
    A = 1.0 - 0.5 * a2 / (a2 + 0.33)
    B = 0.45 * a2 / (a2 + 0.09)
    C = 0.17 * a2 / (a2 + 0.13)
    fac = (A + B * s / t) * INV_PI
    return Color(kd.r * fac + kd.r * kd.r * C * INV_PI,
                 kd.g * fac + kd.g * kd.g * C * INV_PI,
                 kd.b * fac + kd.b * kd.b * C * INV_PI) * p1


def _diffuse_eval(mat: MatParams, wi: Vec3, wo: Vec3) -> Color:
    cos_i = jnp.maximum(wi.z, 0.0)
    lam = mat.base * (cos_i * INV_PI)
    on = _oren_nayar_eval(mat.base, mat.p1, wi, wo)
    return cselect(mat.p1 > EPS, on, lam)


def _phong_eval(mat: MatParams, wi: Vec3, wo: Vec3) -> Color:
    cos_i = jnp.maximum(wi.z, 0.0)
    r = Vec3(-wo.x, -wo.y, wo.z)  # reflect about +z
    # eps floor: keeps pow off 0**0 and the infinite grads of pow(0, k)
    c = jnp.maximum(dot(r, wi), 1e-6)
    k = mat.p0
    return mat.base * (jnp.power(c, k) * (k + 2.0) * (0.5 * INV_PI) * cos_i)


# ---------------------------------------------------------------------------
# Rough conductor (conductor.art make_rough_conductor_bsdf)
# ---------------------------------------------------------------------------

def _conductor_rough_eval(mat: MatParams, wi: Vec3, wo: Vec3) -> Color:
    au, av = mat.p2, mat.p3
    h = normalize(wi + wo)
    cos_i = wi.z
    cos_o = wo.z
    D = mf.ndf_ggx(h, jnp.maximum(au, 1e-5), jnp.maximum(av, 1e-5))
    G = mf.g_separable(wi, wo, au, av)
    F = _conductor_fresnel(mat.extra, mat.extra2, jnp.abs(dot(h, wo)))
    f = safe_div(D * G, 4.0 * jnp.abs(cos_o))
    ok = (cos_i > EPS) & (cos_o > EPS) & (au > DELTA_ALPHA)
    out = mat.base.cmul(F) * f
    return cselect(ok, out, black(cos_i.shape))


def _conductor_rough_pdf(mat: MatParams, wi: Vec3, wo: Vec3):
    au, av = jnp.maximum(mat.p2, 1e-5), jnp.maximum(mat.p3, 1e-5)
    h = normalize(wi + wo)
    pdf_h = mf.pdf_vndf_ggx(wo, h, au, av)
    pdf = pdf_h * jnp.abs(mf.reflective_jacobian(dot(h, wo)))
    ok = (wi.z > EPS) & (wo.z > EPS) & (mat.p2 > DELTA_ALPHA)
    return jnp.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Rough dielectric (dielectric.art make_rough_dielectric_bsdf)
# ---------------------------------------------------------------------------

def _diel_halfway(wi: Vec3, wo: Vec3, eta, is_transmission):
    h_refl = normalize(wi + wo)
    h_refr = normalize(wi + wo * eta)
    return vselect(is_transmission, h_refr, h_refl)


def _dielectric_rough_eval(mat: MatParams, is_entering, wi: Vec3,
                           wo: Vec3) -> Color:
    eta = _eta_ratio(mat, is_entering)
    alpha = jnp.maximum(mat.p2, 1e-5)
    cos_i = wi.z
    cos_o = wo.z
    is_trans = (cos_i * cos_o) < 0.0
    h = _diel_halfway(wi, wo, eta, is_trans)
    cos_h_i = dot(h, wi)
    cos_h_o = dot(h, wo)
    F = fr.fresnel_dielectric(eta, jnp.abs(cos_h_o)).factor
    D = mf.ndf_ggx(h, alpha, alpha)
    G = mf.g_separable(wi, wo, alpha, alpha)
    refl = mat.base * (F * D * G * jnp.abs(mf.reflective_jacobian(cos_o)))
    jac = mf.refractive_jacobian(eta, cos_h_i, cos_h_o)
    norm = jnp.abs(safe_div(cos_h_o * jac, cos_o))
    # radiance-mode (eta_i/eta_t)^2 compression on transmission (PBRT
    # convention; see the smooth-dielectric sample for rationale)
    trans = mat.extra * ((1.0 - F) * D * G * norm * (eta * eta))
    ok = (jnp.abs(cos_i * cos_o) > EPS) & (jnp.abs(cos_h_i * cos_h_o) > EPS) \
        & (mat.p2 > DELTA_ALPHA)
    return cselect(ok, cselect(is_trans, trans, refl), black(cos_i.shape))


def _dielectric_rough_pdf(mat: MatParams, is_entering, wi: Vec3, wo: Vec3):
    eta = _eta_ratio(mat, is_entering)
    alpha = jnp.maximum(mat.p2, 1e-5)
    cos_i = wi.z
    cos_o = wo.z
    is_trans = (cos_i * cos_o) < 0.0
    h = _diel_halfway(wi, wo, eta, is_trans)
    cos_h_i = dot(h, wi)
    cos_h_o = dot(h, wo)
    F = fr.fresnel_dielectric(eta, jnp.abs(cos_h_o)).factor
    mpdf = mf.pdf_vndf_ggx(wo, h, alpha, alpha)
    p_refl = F * mpdf * jnp.abs(mf.reflective_jacobian(cos_h_o))
    p_trans = (1.0 - F) * mpdf * jnp.abs(
        mf.refractive_jacobian(eta, cos_h_i, cos_h_o))
    pdf = jnp.where(is_trans, p_trans, p_refl)
    ok = (jnp.abs(cos_i * cos_o) > EPS) & (jnp.abs(cos_h_i * cos_h_o) > EPS) \
        & (mat.p2 > DELTA_ALPHA) & (mpdf > 1e-5)
    return jnp.where(ok, pdf, 0.0)


# ---------------------------------------------------------------------------
# Plastic (plastic.art make_plastic_bsdf: fresnel mix of diffuse-with-inner-
# scattering and a (rough) mirror coat)
# ---------------------------------------------------------------------------

def _plastic_parts(mat: MatParams, wi: Vec3, wo: Vec3):
    eta = mat.p0 / jnp.maximum(mat.p1, 1e-6)
    fdr = _fresnel_diffuse_factor(eta)
    cos_i = jnp.abs(wi.z)
    cos_o = jnp.abs(wo.z)
    fi = fr.fresnel_dielectric(eta, cos_i).factor
    fo = fr.fresnel_dielectric(eta, cos_o).factor
    scatter = (1.0 - fi) * eta * eta / jnp.maximum(1.0 - fdr, 1e-4)
    return fo, scatter


def _plastic_eval(mat: MatParams, wi: Vec3, wo: Vec3) -> Color:
    fo, scatter = _plastic_parts(mat, wi, wo)
    cos_i = jnp.maximum(wi.z, 0.0)
    diff = mat.base * (cos_i * INV_PI * scatter)
    out = diff * (1.0 - fo)
    # Rough coat contribution
    rough = mat.p2 > DELTA_ALPHA
    coat_mat = MatParams(mat.kind, mat.extra, Color(mat.p0 * 0, mat.p0 * 0, mat.p0 * 0),
                         Color(mat.p0 * 0 + 1, mat.p0 * 0 + 1, mat.p0 * 0 + 1),
                         mat.p0, mat.p1, mat.p2, mat.p2)
    coat = _conductor_rough_eval(coat_mat, wi, wo)
    return cselect(rough, cselect(fo > 0, out + coat * fo, out), out)


def _plastic_pdf(mat: MatParams, wi: Vec3, wo: Vec3):
    fo, _ = _plastic_parts(mat, wi, wo)
    cos_i = jnp.maximum(wi.z, 0.0)
    p = (1.0 - fo) * cosine_hemisphere_pdf(cos_i)
    rough = mat.p2 > DELTA_ALPHA
    coat_mat = mat._replace(p3=mat.p2)
    p_coat = _conductor_rough_pdf(coat_mat, wi, wo)
    return jnp.where(rough, p + fo * p_coat, p)


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

ALL_KINDS = tuple(int(k) for k in BsdfKind)


def _want(present, kind):
    return present is None or int(kind) in present


# pseudo-kind offset: `present` also carries (ROUGH_FLAG + kind) entries
# for kinds that have at least one rough (alpha > DELTA_ALPHA) row in the
# scene, so purely-smooth scenes statically prune the microfacet math
# (vndf sampling, jacobians, GGX evals) from their shaders — e.g. the
# diamond benchmark scene's shade stage carries no GGX code at all.
ROUGH_FLAG = 100

# pseudo-kind: scene has a THIN smooth dielectric row (straight-through
# glass). Distinguishes "glassy" transparent-shadow scenes (worth the
# crossing walk in volpath too) from passthrough-only media scenes.
THIN_FLAG = 200


def _want_rough(present, kind):
    return present is None or (ROUGH_FLAG + int(kind)) in present


# ---------------------------------------------------------------------------
# Radiance models (rad.art): mirror + straight transmission + lambert
# reflection/transmission, combined with nested one-sample lobe selection
# ---------------------------------------------------------------------------

def _rad_lobes(mat: MatParams, is_entering, wo: Vec3):
    """Per-lane (refl_spec, trns_spec, refl_diff, trns_diff)."""
    kinds = mat.kind
    shape = mat.p0.shape
    # Roos angular model (rad.art:37): specular terms from the view angle
    z = jnp.arccos(jnp.clip(jnp.abs(wo.z), 0.0, 1.0 - 1e-7)) * 0.636619772368
    tq = jnp.maximum(mat.base.b, 1e-4)
    rq = jnp.maximum(mat.extra.b, 1e-4)
    tp, rp = mat.base.g, mat.extra.g
    tw, rw = mat.base.r, mat.extra.r
    a = 8.0
    alpha_t = 5.2 + 0.7 * tq
    gamma = lambda p, q: (5.26 + 0.06 * p) + (0.73 + 0.04 * p) * q
    b_t = 0.25 / tq
    c_t = 1.0 - a - b_t
    tau = tw * (1.0 - a * jnp.power(z, alpha_t) - b_t * z * z
                - c_t * jnp.power(z, gamma(tp, tq)))
    rf = rw + (1.0 - rw) * jnp.power(z, gamma(rp, rq))
    tau = jnp.clip(tau, 0.0, 1.0)
    rf = jnp.clip(rf, 0.0, 1.0)

    is_roos = kinds == BsdfKind.RAD_ROOS
    refl_spec = cselect(is_roos, Color(rf, rf, rf), mat.base)
    trns_spec = cselect(is_roos, Color(tau, tau, tau), mat.extra)
    front = Color(mat.q0, mat.q1, mat.q2)
    back = Color(mat.q3, mat.q4, mat.q5)
    refl_diff = cselect(jnp.broadcast_to(is_entering, shape), front, back)
    trns_diff = mat.extra2
    return refl_spec, trns_spec, refl_diff, trns_diff


def _avg(c: Color):
    return (c.r + c.g + c.b) * (1.0 / 3.0)


def _rad_probs(refl_spec, trns_spec, refl_diff, trns_diff):
    """Nested lobe-selection probabilities (rad.art:16-28)."""
    p_refr = safe_div(_avg(trns_spec), _avg(refl_spec) + _avg(trns_spec))
    p_td = safe_div(_avg(trns_diff), _avg(refl_diff) + _avg(trns_diff))
    sum_spec = _avg(refl_spec) + _avg(trns_spec)
    sum_diff = _avg(refl_diff) + _avg(trns_diff)
    p_spec = safe_div(sum_spec, sum_spec + sum_diff)
    return p_refr, p_td, p_spec


def _rad_eval(mat: MatParams, is_entering, wi: Vec3, wo: Vec3) -> Color:
    _, _, refl_diff, trns_diff = _rad_lobes(mat, is_entering, wo)
    cr = jnp.maximum(wi.z, 0.0) * INV_PI
    ct = jnp.maximum(-wi.z, 0.0) * INV_PI
    return Color(refl_diff.r * cr + trns_diff.r * ct,
                 refl_diff.g * cr + trns_diff.g * ct,
                 refl_diff.b * cr + trns_diff.b * ct)


def _rad_pdf(mat: MatParams, is_entering, wi: Vec3, wo: Vec3):
    lobes = _rad_lobes(mat, is_entering, wo)
    _, p_td, p_spec = _rad_probs(*lobes)
    pr = cosine_hemisphere_pdf(jnp.maximum(wi.z, 0.0)) * (1.0 - p_td)
    pt = cosine_hemisphere_pdf(jnp.maximum(-wi.z, 0.0)) * p_td
    return (1.0 - p_spec) * (pr + pt)


def _rad_sample(mat: MatParams, is_entering, wo: Vec3, u0, cdir: Vec3,
                cpdf) -> BsdfSample:
    refl_spec, trns_spec, refl_diff, trns_diff = _rad_lobes(mat, is_entering,
                                                            wo)
    p_refr, p_td, p_spec = _rad_probs(refl_spec, trns_spec, refl_diff,
                                      trns_diff)
    shape = u0.shape
    one = jnp.ones(shape)

    pick_spec = u0 < p_spec
    # re-stretch u0 within the chosen group for the inner lobe choice
    u_in = jnp.where(pick_spec, safe_div(u0, p_spec),
                     safe_div(u0 - p_spec, 1.0 - p_spec))
    pick_refr = u_in < p_refr
    pick_td = u_in < p_td

    refl_smooth = Vec3(-wo.x, -wo.y, wo.z)
    spec_dir = vselect(pick_refr, -wo, refl_smooth)
    spec_w = cselect(pick_refr,
                     trns_spec * safe_div(1.0, p_spec * p_refr),
                     refl_spec * safe_div(1.0, p_spec * (1.0 - p_refr)))

    tdir = Vec3(cdir.x, cdir.y, -cdir.z)
    diff_dir = vselect(pick_td, tdir, cdir)
    diff_w = cselect(pick_td,
                     trns_diff * safe_div(1.0, (1.0 - p_spec) * p_td),
                     refl_diff * safe_div(1.0, (1.0 - p_spec) * (1.0 - p_td)))
    diff_pdf = cpdf * (1.0 - p_spec) * jnp.where(pick_td, p_td, 1.0 - p_td)

    in_dir = vselect(pick_spec, spec_dir, diff_dir)
    weight = cselect(pick_spec, spec_w, diff_w)
    pdf = jnp.where(pick_spec, one, diff_pdf)
    valid = jnp.where(pick_spec, jnp.ones(shape, bool), cpdf > 0)
    return BsdfSample(in_dir, pdf, weight, one, pick_spec, valid)


def _measured_dispatch(op, mat, frame, is_entering, measured, zero,
                       want_type=None, *args):
    """Unrolled masked select over the scene's measured BSDF tables.
    `want_type` filters entries by python type (Klems vs TensorTree share
    the tuple; the material kind keeps the q6 index unambiguous)."""
    from . import klems as klemslib
    kid = mat.q6.astype(jnp.int32)
    up = Vec3(mat.extra2.r, mat.extra2.g, mat.extra2.b)
    kframe = klemslib.make_klems_frame(frame.n, is_entering, up)
    out = zero
    for i, kd in enumerate(measured):
        if want_type is not None and not isinstance(kd, want_type):
            continue
        v = op(kd, kframe, *args)
        if isinstance(out, Color):
            out = cselect(kid == i, v, out)
        elif isinstance(out, tuple):
            out = tuple(
                cselect(kid == i, a, b) if isinstance(b, Color) else
                (vselect(kid == i, a, b) if isinstance(b, Vec3)
                 else jnp.where(kid == i, a, b))
                for a, b in zip(v, out))
        else:
            out = jnp.where(kid == i, v, out)
    return out


def eval_bsdf(mat: MatParams, frame: Frame, is_entering, in_dir: Vec3,
              out_dir: Vec3, present=None, measured=None) -> Color:
    """Masked dispatch; `present` (static tuple of BsdfKind ints) prunes
    kinds absent from the scene — the XLA analog of the reference's
    per-material shader specialization."""
    wi = frame.to_local(in_dir)
    wo = frame.to_local(out_dir)
    kinds = mat.kind
    res = black(mat.p0.shape)
    if _want(present, BsdfKind.DIFFUSE):
        res = cselect(kinds == BsdfKind.DIFFUSE, _diffuse_eval(mat, wi, wo), res)
    if _want(present, BsdfKind.PHONG):
        res = cselect(kinds == BsdfKind.PHONG, _phong_eval(mat, wi, wo), res)
    if _want(present, BsdfKind.PLASTIC):
        res = cselect(kinds == BsdfKind.PLASTIC, _plastic_eval(mat, wi, wo), res)
    if _want_rough(present, BsdfKind.CONDUCTOR):
        # smooth conductors are delta (eval black): only rough rows eval
        res = cselect(kinds == BsdfKind.CONDUCTOR,
                      _conductor_rough_eval(mat, wi, wo), res)
    if _want_rough(present, BsdfKind.DIELECTRIC):
        res = cselect(kinds == BsdfKind.DIELECTRIC,
                      _dielectric_rough_eval(mat, is_entering, wi, wo), res)
    if mat.q0 is not None and _want(present, BsdfKind.PRINCIPLED):
        from . import principled as principled_mod
        res = cselect(kinds == BsdfKind.PRINCIPLED,
                      principled_mod.eval_principled(mat, is_entering, wi, wo),
                      res)
    if mat.q0 is not None and (_want(present, BsdfKind.RAD_BRTDF)
                               or _want(present, BsdfKind.RAD_ROOS)):
        is_rad = (kinds == BsdfKind.RAD_BRTDF) | (kinds == BsdfKind.RAD_ROOS)
        res = cselect(is_rad, _rad_eval(mat, is_entering, wi, wo), res)
    if measured and _want(present, BsdfKind.KLEMS):
        from . import klems as klemslib
        v = _measured_dispatch(
            lambda kd, kf: klemslib.klems_eval(kd, mat.base, kf, in_dir,
                                               out_dir),
            mat, frame, is_entering, measured, black(mat.p0.shape),
            klemslib.KlemsData)
        res = cselect(kinds == BsdfKind.KLEMS, v, res)
    if measured and _want(present, BsdfKind.TENSORTREE):
        from . import tensortree as ttlib
        v = _measured_dispatch(
            lambda kd, kf: ttlib.tt_eval(kd, mat.base, kf, in_dir, out_dir),
            mat, frame, is_entering, measured, black(mat.p0.shape),
            ttlib.TensorTreeData)
        res = cselect(kinds == BsdfKind.TENSORTREE, v, res)
    if measured and _want(present, BsdfKind.DJMEASURED):
        from . import djmeasured as djlib
        kid = mat.q6.astype(jnp.int32)
        v = black(mat.p0.shape)
        for i, kd in enumerate(measured):
            if not isinstance(kd, djlib.DJData):
                continue
            c = djlib.dj_eval(kd, mat.base, wi, wo)
            v = cselect(kid == i, c, v)
        res = cselect(kinds == BsdfKind.DJMEASURED, v, res)
    if _want(present, BsdfKind.NULL_ERROR):
        err = jnp.maximum(wi.z, 0.0) * INV_PI
        res = cselect(kinds == BsdfKind.NULL_ERROR,
                      Color(err, jnp.zeros_like(err), err), res)
    return res


def pdf_bsdf(mat: MatParams, frame: Frame, is_entering, in_dir: Vec3,
             out_dir: Vec3, present=None, measured=None) -> jnp.ndarray:
    wi = frame.to_local(in_dir)
    wo = frame.to_local(out_dir)
    kinds = mat.kind
    cos_i = jnp.maximum(wi.z, 0.0)
    cos_pdf = cosine_hemisphere_pdf(cos_i)
    pdf = jnp.zeros(mat.p0.shape, jnp.float32)
    if _want(present, BsdfKind.DIFFUSE):
        pdf = jnp.where(kinds == BsdfKind.DIFFUSE, cos_pdf, pdf)
    if _want(present, BsdfKind.NULL_ERROR):
        pdf = jnp.where(kinds == BsdfKind.NULL_ERROR, cos_pdf, pdf)
    if _want(present, BsdfKind.PLASTIC):
        pdf = jnp.where(kinds == BsdfKind.PLASTIC, _plastic_pdf(mat, wi, wo), pdf)
    if _want(present, BsdfKind.PHONG):
        r = Vec3(-wo.x, -wo.y, wo.z)
        c = jnp.maximum(dot(r, wi), 0.0)
        pdf = jnp.where(kinds == BsdfKind.PHONG,
                        cosine_power_hemisphere_pdf(c, mat.p0), pdf)
    if _want_rough(present, BsdfKind.CONDUCTOR):
        # smooth conductors/dielectrics are delta (pdf 0): only rough rows
        pdf = jnp.where(kinds == BsdfKind.CONDUCTOR,
                        _conductor_rough_pdf(mat, wi, wo), pdf)
    if _want_rough(present, BsdfKind.DIELECTRIC):
        pdf = jnp.where(kinds == BsdfKind.DIELECTRIC,
                        _dielectric_rough_pdf(mat, is_entering, wi, wo), pdf)
    if mat.q0 is not None and _want(present, BsdfKind.PRINCIPLED):
        from . import principled as principled_mod
        pdf = jnp.where(kinds == BsdfKind.PRINCIPLED,
                        principled_mod.pdf_principled(mat, is_entering, wi, wo),
                        pdf)
    if mat.q0 is not None and (_want(present, BsdfKind.RAD_BRTDF)
                               or _want(present, BsdfKind.RAD_ROOS)):
        is_rad = (kinds == BsdfKind.RAD_BRTDF) | (kinds == BsdfKind.RAD_ROOS)
        pdf = jnp.where(is_rad, _rad_pdf(mat, is_entering, wi, wo), pdf)
    if measured and _want(present, BsdfKind.KLEMS):
        from . import klems as klemslib
        v = _measured_dispatch(
            lambda kd, kf: klemslib.klems_pdf(kd, kf, in_dir, out_dir),
            mat, frame, is_entering, measured, jnp.zeros(mat.p0.shape),
            klemslib.KlemsData)
        pdf = jnp.where(kinds == BsdfKind.KLEMS, v, pdf)
    if measured and _want(present, BsdfKind.TENSORTREE):
        from . import tensortree as ttlib
        v = _measured_dispatch(
            lambda kd, kf: ttlib.tt_pdf(kd, kf, in_dir, out_dir),
            mat, frame, is_entering, measured, jnp.zeros(mat.p0.shape),
            ttlib.TensorTreeData)
        pdf = jnp.where(kinds == BsdfKind.TENSORTREE, v, pdf)
    if measured and _want(present, BsdfKind.DJMEASURED):
        from . import djmeasured as djlib
        kid = mat.q6.astype(jnp.int32)
        v = jnp.zeros(mat.p0.shape)
        for i, kd in enumerate(measured):
            if not isinstance(kd, djlib.DJData):
                continue
            v = jnp.where(kid == i, djlib.dj_pdf(kd, wi, wo), v)
        pdf = jnp.where(kinds == BsdfKind.DJMEASURED, v, pdf)
    return pdf


def is_all_delta(mat: MatParams) -> jnp.ndarray:
    k = mat.kind
    delta = (k == BsdfKind.PASSTHROUGH)
    smooth_diel = (k == BsdfKind.DIELECTRIC) & (mat.p2 <= DELTA_ALPHA)
    smooth_cond = (k == BsdfKind.CONDUCTOR) & (mat.p2 <= DELTA_ALPHA)
    return delta | smooth_diel | smooth_cond


def sample_bsdf(mat: MatParams, frame: Frame, is_entering, out_dir: Vec3,
                u0, u1, u2, present=None, adjoint=False,
                measured=None) -> BsdfSample:
    """Masked-dispatch sample. u0: lobe select; u1, u2: direction.
    `present` statically prunes kinds absent from the scene."""
    shape = mat.p0.shape
    kinds = mat.kind
    zero = jnp.zeros(shape, jnp.float32)
    one = jnp.ones(shape, jnp.float32)
    false = zero > 1
    true = zero < 1
    wo = frame.to_local(out_dir)
    cos_o = wo.z
    refl_smooth = Vec3(-wo.x, -wo.y, wo.z)

    need_cos = any(_want(present, k) for k in
                   (BsdfKind.DIFFUSE, BsdfKind.PLASTIC, BsdfKind.NULL_ERROR))
    need_vndf = any(_want(present, k) for k in
                    (BsdfKind.CONDUCTOR, BsdfKind.DIELECTRIC, BsdfKind.PLASTIC))

    if need_cos:
        cdir, cpdf = sample_cosine_hemisphere(u1, u2)
    if need_vndf:
        h_l = mf.sample_vndf_ggx(wo, jnp.maximum(mat.p2, 1e-5),
                                 jnp.maximum(jnp.where(kinds == BsdfKind.CONDUCTOR,
                                                       mat.p3, mat.p2), 1e-5),
                                 u1, u2)
        refl_r = reflect(wo, h_l)

    out = BsdfSample(refl_smooth, one, Color(one, one, one), one, true,
                     false)  # inert default (invalid)

    def sel(kind_val, s_, cur):
        return _sel_sample(kinds == kind_val, s_, cur)

    # --- diffuse (lambert: weight = kd; oren-nayar: weight = eval/pdf) -----
    if _want(present, BsdfKind.DIFFUSE):
        on_w = _oren_nayar_eval(mat.base, mat.p1, cdir, wo) * safe_div(1.0, cpdf)
        diff_w = cselect(mat.p1 > EPS, on_w, mat.base)
        diff_s = BsdfSample(cdir, cpdf, diff_w, one, false, cpdf > 0)
        out = sel(BsdfKind.DIFFUSE, diff_s, out)

    # --- phong -------------------------------------------------------------
    if _want(present, BsdfKind.PHONG):
        pdir_l, ppdf = sample_cosine_power_hemisphere(mat.p0, u1, u2)
        r_wo = Vec3(-wo.x, -wo.y, wo.z)
        rfr = make_frame(r_wo)
        pdir = rfr.to_world(pdir_l)
        p_eval = _phong_eval(mat, pdir, wo)
        p_w = cselect(ppdf > EPS, p_eval * safe_div(1.0, ppdf), black(shape))
        phong_s = BsdfSample(pdir, ppdf, p_w, one, false,
                             (ppdf > EPS) & (pdir.z > 0))
        out = sel(BsdfKind.PHONG, phong_s, out)

    # --- conductor (smooth + rough) ----------------------------------------
    if _want(present, BsdfKind.CONDUCTOR):
        f_smooth = _conductor_fresnel(mat.extra, mat.extra2,
                                      jnp.maximum(cos_o, 0.0))
        cond_sm = BsdfSample(refl_smooth, one, mat.base.cmul(f_smooth), one,
                             true, cos_o > 0)
        if _want_rough(present, BsdfKind.CONDUCTOR):
            au = jnp.maximum(mat.p2, 1e-5)
            av = jnp.maximum(mat.p3, 1e-5)
            pdf_h = mf.pdf_vndf_ggx(wo, h_l, au, av)
            pdf_r = pdf_h * jnp.abs(mf.reflective_jacobian(dot(h_l, wo)))
            ev_r = _conductor_rough_eval(mat, refl_r, wo)
            w_r = ev_r * safe_div(1.0, pdf_r)
            cond_ro = BsdfSample(refl_r, pdf_r, w_r, one, false,
                                 (pdf_r > 1e-7) & (refl_r.z > 0)
                                 & (cos_o > 0))
            cond_s = _sel_sample(mat.p2 > DELTA_ALPHA, cond_ro, cond_sm)
        else:
            cond_s = cond_sm
        out = sel(BsdfKind.CONDUCTOR, cond_s, out)

    # --- dielectric (smooth + rough + thin) --------------------------------
    if _want(present, BsdfKind.DIELECTRIC):
        k_ratio = _eta_ratio(mat, is_entering)
        fsm = fr.fresnel_dielectric(k_ratio, jnp.maximum(cos_o, 0.0))
        refr_sm = Vec3(-wo.x * k_ratio, -wo.y * k_ratio,
                       k_ratio * cos_o - fsm.cos_t - k_ratio * wo.z)
        choose_refl = u0 <= fsm.factor
        d_dir = vselect(choose_refl, refl_smooth, refr_sm)
        d_w = cselect(choose_refl, mat.base, mat.extra)
        d_eta = jnp.where(choose_refl, one, k_ratio)
        thin = mat.p3 > 0.5
        kt_ratio = mat.p0 / jnp.maximum(mat.p1, 1e-6)
        ft = fr.fresnel_dielectric(kt_ratio, jnp.abs(cos_o)).factor
        ft = ft + (1.0 - ft) * ft / (ft + 1.0)
        thin_refl = u0 <= ft
        d_dir = vselect(thin, vselect(thin_refl, refl_smooth, -wo), d_dir)
        d_w = cselect(thin, cselect(thin_refl, mat.base, mat.extra), d_w)
        d_eta = jnp.where(thin, one, d_eta)
        if not adjoint:
            # Radiance-mode refraction carries the (eta_i/eta_t)^2 radiance
            # compression (PBRT convention; matches the Mitsuba/Radiance
            # golden images — e.g. three-planes-dielectric: a single open
            # interface). Closed glass cancels the factor on exit. The
            # adjoint/importance mode carries no factor (Veach's asymmetry;
            # the reference applies it on the adjoint side instead, which is
            # self-consistent but diverges from the physical references).
            adj = jnp.where(~choose_refl & ~thin, k_ratio * k_ratio, 1.0)
            d_w = d_w * adj
        diel_sm = BsdfSample(d_dir, one, d_w, d_eta, true, true)

        if _want_rough(present, BsdfKind.DIELECTRIC):
            cos_h_o = dot(h_l, wo)
            frough = fr.fresnel_dielectric(k_ratio, jnp.abs(cos_h_o))
            refl_h = reflect(wo, h_l)
            refr_h = normalize(Vec3(
                h_l.x * (k_ratio * cos_h_o - frough.cos_t) - wo.x * k_ratio,
                h_l.y * (k_ratio * cos_h_o - frough.cos_t) - wo.y * k_ratio,
                h_l.z * (k_ratio * cos_h_o - frough.cos_t) - wo.z * k_ratio))
            dr_refl = u0 <= frough.factor
            dr_dir = vselect(dr_refl, refl_h, refr_h)
            alpha = jnp.maximum(mat.p2, 1e-5)
            mpdf = mf.pdf_vndf_ggx(wo, h_l, alpha, alpha)
            jac_refl = jnp.abs(mf.reflective_jacobian(cos_h_o))
            jac_refr = jnp.abs(mf.refractive_jacobian(
                k_ratio, dot(h_l, dr_dir), cos_h_o))
            sel_pdf = jnp.where(dr_refl, frough.factor * jac_refl,
                                (1.0 - frough.factor) * jac_refr)
            f_pdf = mpdf * sel_pdf
            dr_eval = _dielectric_rough_eval(mat, is_entering, dr_dir, wo)
            dr_w = dr_eval * safe_div(1.0, f_pdf)
            if adjoint:
                # eval carries the radiance-mode eta^2; divide it back out
                # for importance transport
                dr_w = dr_w * jnp.where((dr_dir.z * cos_o) < 0.0,
                                        safe_div(1.0, k_ratio * k_ratio),
                                        1.0)
            dr_is_trans = (dr_dir.z * cos_o) < 0.0
            dr_eta = jnp.where(dr_is_trans, k_ratio, one)
            # Reject side-switching samples (reflection below horizon /
            # transmission above): pdf/eval classification would disagree.
            dr_consistent = dr_refl != dr_is_trans
            diel_ro = BsdfSample(dr_dir, f_pdf, dr_w, dr_eta, false,
                                 (f_pdf > 1e-7) & (jnp.abs(cos_h_o) > EPS)
                                 & dr_consistent)
            diel_s = _sel_sample((mat.p2 > DELTA_ALPHA) & ~thin, diel_ro,
                                 diel_sm)
        else:
            diel_s = diel_sm
        out = sel(BsdfKind.DIELECTRIC, diel_s, out)

    # --- passthrough -------------------------------------------------------
    if _want(present, BsdfKind.PASSTHROUGH):
        # base tints the delta transmission: the "transparent" plugin is
        # make_perfect_refraction_bsdf(surf, color)
        # (TransparentBSDF.cpp:19); plain passthrough keeps base = 1
        pass_s = BsdfSample(-wo, one, mat.base, one, true, true)
        out = sel(BsdfKind.PASSTHROUGH, pass_s, out)

    # --- plastic -----------------------------------------------------------
    if _want(present, BsdfKind.PLASTIC):
        fo, scatter = _plastic_parts(mat, cdir, wo)
        pl_refl = u0 <= fo
        pl_rough = mat.p2 > DELTA_ALPHA
        pl_spec_dir = vselect(pl_rough, refl_r, refl_smooth)
        pl_dir = vselect(pl_refl, pl_spec_dir, cdir)
        pl_pdf_d = (1.0 - fo) * cosine_hemisphere_pdf(jnp.maximum(pl_dir.z, 0.0))
        coat_mat = mat._replace(p3=mat.p2)
        pl_pdf_s = jnp.where(pl_rough,
                             fo * _conductor_rough_pdf(coat_mat, pl_dir, wo), fo)
        pl_eval = _plastic_eval(mat, pl_dir, wo)
        pl_pdf = jnp.where(pl_rough, pl_pdf_d + pl_pdf_s,
                           jnp.where(pl_refl, fo, pl_pdf_d))
        w_diff = mat.base * (scatter * jnp.ones_like(fo))
        pl_w = cselect(pl_rough, pl_eval * safe_div(1.0, pl_pdf),
                       cselect(pl_refl, mat.extra, w_diff))
        plastic_s = BsdfSample(pl_dir, pl_pdf, pl_w, one,
                               pl_refl & ~pl_rough,
                               (pl_pdf > 1e-7) | (pl_refl & ~pl_rough))
        out = sel(BsdfKind.PLASTIC, plastic_s, out)

    # --- principled --------------------------------------------------------
    if mat.q0 is not None and _want(present, BsdfKind.PRINCIPLED):
        from . import principled as principled_mod
        pr_wi, pr_pdf, pr_eta, pr_valid = principled_mod.sample_principled(
            mat, is_entering, wo, u0, u1, u2)
        pr_eval = principled_mod.eval_principled(mat, is_entering, pr_wi, wo)
        pr_w = pr_eval * safe_div(1.0, pr_pdf)
        principled_s = BsdfSample(pr_wi, pr_pdf, pr_w, pr_eta, false, pr_valid)
        out = sel(BsdfKind.PRINCIPLED, principled_s, out)

    # --- Radiance models ----------------------------------------------------
    if mat.q0 is not None and (_want(present, BsdfKind.RAD_BRTDF)
                               or _want(present, BsdfKind.RAD_ROOS)):
        if not need_cos:
            cdir, cpdf = sample_cosine_hemisphere(u1, u2)
        rad_s = _rad_sample(mat, is_entering, wo, u0, cdir, cpdf)
        is_rad = (kinds == BsdfKind.RAD_BRTDF) | (kinds == BsdfKind.RAD_ROOS)
        out = _sel_sample(is_rad, rad_s, out)

    if _want(present, BsdfKind.NULL_ERROR):
        err_s = BsdfSample(cdir, cpdf, Color(one, zero, one), one, false,
                           cpdf > 0) if need_cos else None
        if err_s is not None:
            out = sel(BsdfKind.NULL_ERROR, err_s, out)

    # --- measured (Klems) ---------------------------------------------------
    if measured:
        zero_t = (Vec3(zero, zero, one), zero,
                  Color(zero, zero, zero), zero > 1)
        if _want(present, BsdfKind.KLEMS):
            from . import klems as klemslib
            wdir, kpdf, kw, kvalid = _measured_dispatch(
                lambda kd, kf: klemslib.klems_sample(kd, mat.base, kf,
                                                     out_dir, u0, u1, u2),
                mat, frame, is_entering, measured, zero_t,
                klemslib.KlemsData)
            # klems returns a WORLD direction; store it in local so the
            # common to_world conversion below round-trips
            klems_s = BsdfSample(frame.to_local(wdir), kpdf, kw, one, false,
                                 kvalid)
            out = sel(BsdfKind.KLEMS, klems_s, out)
        if _want(present, BsdfKind.TENSORTREE):
            from . import tensortree as ttlib
            zero_t5 = zero_t + (zero > 1,)
            wdir, tpdf, tw, tvalid, tpeak = _measured_dispatch(
                lambda kd, kf: ttlib.tt_sample(kd, mat.base, kf, out_dir,
                                               u0, u1, u2),
                mat, frame, is_entering, measured, zero_t5,
                ttlib.TensorTreeData)
            # tpeak: peak-extraction delta transmission (tensortree.art:320)
            tt_s = BsdfSample(frame.to_local(wdir), tpdf, tw, one, tpeak,
                              tvalid)
            out = sel(BsdfKind.TENSORTREE, tt_s, out)
        if _want(present, BsdfKind.DJMEASURED):
            from . import djmeasured as djlib
            kid = mat.q6.astype(jnp.int32)
            dj_dir = Vec3(zero, zero, one)
            dj_pdf_v = zero
            dj_w = Color(zero, zero, zero)
            dj_valid = zero > 1
            for i, kd in enumerate(measured):
                if not isinstance(kd, djlib.DJData):
                    continue
                wi_s, p_s, w_s, v_s = djlib.dj_sample(kd, mat.base, wo,
                                                      u0, u1, u2)
                m = kid == i
                dj_dir = vselect(m, wi_s, dj_dir)
                dj_pdf_v = jnp.where(m, p_s, dj_pdf_v)
                dj_w = cselect(m, w_s, dj_w)
                dj_valid = jnp.where(m, v_s, dj_valid)
            dj_s = BsdfSample(dj_dir, dj_pdf_v, dj_w, one, false, dj_valid)
            out = sel(BsdfKind.DJMEASURED, dj_s, out)

    # Convert local direction to world
    return out._replace(in_dir=frame.to_world(out.in_dir))


def _sel_sample(m, a: BsdfSample, b: BsdfSample) -> BsdfSample:
    return BsdfSample(vselect(m, a.in_dir, b.in_dir),
                      jnp.where(m, a.pdf, b.pdf),
                      cselect(m, a.weight, b.weight),
                      jnp.where(m, a.eta, b.eta),
                      jnp.where(m, a.is_delta, b.is_delta),
                      jnp.where(m, a.valid, b.valid))


# ---------------------------------------------------------------------------
# Blend (mix/mask) wrapper: one-sample MIS mix of two material rows
# (reference bsdf/mix.art make_join_bsdf)
# ---------------------------------------------------------------------------

def gather_row(materials, mid):
    """Gather a MatParams row-set for per-lane material ids."""
    from ..ops.gather import take_rows
    g = lambda a: take_rows(a, mid)
    gc = lambda c: Color(take_rows(c.r, mid), take_rows(c.g, mid), take_rows(c.b, mid))
    return MatParams(kind=g(materials.kind), base=gc(materials.base),
                     extra=gc(materials.extra), extra2=gc(materials.extra2),
                     p0=g(materials.p0), p1=g(materials.p1),
                     p2=g(materials.p2), p3=g(materials.p3),
                     q0=g(materials.q0), q1=g(materials.q1),
                     q2=g(materials.q2), q3=g(materials.q3),
                     q4=g(materials.q4), q5=g(materials.q5),
                     q6=g(materials.q6), q7=g(materials.q7),
                     q8=g(materials.q8))


class LaneShader:
    """Per-lane BSDF interface over (possibly blended) material rows."""

    def __init__(self, matA: MatParams, matB: MatParams, w, frame, entering,
                 present=None, measured=None):
        self.matA = matA
        self.matB = matB
        self.w = w            # lerp weight towards B; None = no blending
        self.frame = frame
        self.entering = entering
        self.present = present
        self.measured = measured

    def _c_eval(self, child, in_dir, out_dir):
        if isinstance(child, LaneShader):
            return child.eval(in_dir, out_dir)
        return eval_bsdf(child, self.frame, self.entering, in_dir, out_dir,
                         self.present, self.measured)

    def _c_pdf(self, child, in_dir, out_dir):
        if isinstance(child, LaneShader):
            return child.pdf(in_dir, out_dir)
        return pdf_bsdf(child, self.frame, self.entering, in_dir, out_dir,
                        self.present, self.measured)

    def _c_sample(self, child, out_dir, u_pick, u0, u1, u2, adjoint):
        if isinstance(child, LaneShader):
            return child.sample(out_dir, u_pick, u0, u1, u2, adjoint)
        return sample_bsdf(child, self.frame, self.entering, out_dir,
                           u0, u1, u2, self.present, adjoint, self.measured)

    def _c_delta(self, child):
        if isinstance(child, LaneShader):
            return child.is_all_delta()
        return is_all_delta(child)

    def eval(self, in_dir: Vec3, out_dir: Vec3) -> Color:
        a = self._c_eval(self.matA, in_dir, out_dir)
        if self.w is None:
            return a
        b = self._c_eval(self.matB, in_dir, out_dir)
        from ..core.vec import clerp
        return clerp(a, b, self.w)

    def pdf(self, in_dir: Vec3, out_dir: Vec3):
        a = self._c_pdf(self.matA, in_dir, out_dir)
        if self.w is None:
            return a
        b = self._c_pdf(self.matB, in_dir, out_dir)
        return a + (b - a) * self.w

    def is_all_delta(self):
        a = self._c_delta(self.matA)
        if self.w is None:
            return a
        b = self._c_delta(self.matB)
        return jnp.where(self.w >= 1.0, b, jnp.where(self.w <= 0.0, a, a & b))

    def sample(self, out_dir: Vec3, u_pick, u0, u1, u2,
               adjoint=False) -> BsdfSample:
        if self.w is None:
            return self._c_sample(self.matA, out_dir, u_pick, u0, u1, u2,
                                  adjoint)
        from ..core.vec import clerp
        # stick-breaking: rescale the pick within the chosen branch so a
        # nested blend child gets a fresh uniform for ITS selection
        pick_b = u_pick < self.w
        u_next = jnp.where(pick_b, safe_div(u_pick, self.w),
                           safe_div(u_pick - self.w, 1.0 - self.w))
        sA = self._c_sample(self.matA, out_dir, u_next, u0, u1, u2, adjoint)
        sB = self._c_sample(self.matB, out_dir, u_next, u0, u1, u2, adjoint)
        s = _sel_sample(pick_b, sB, sA)
        # pdf/eval of the *other* child at the sampled direction
        pdfA = self._c_pdf(self.matA, s.in_dir, out_dir)
        pdfB = self._c_pdf(self.matB, s.in_dir, out_dir)
        evalA = self._c_eval(self.matA, s.in_dir, out_dir)
        evalB = self._c_eval(self.matB, s.in_dir, out_dir)
        # mix.art sample_mat: chosen child contributes s.color * s.pdf
        c_first = s.weight * s.pdf
        w = self.w
        p = jnp.where(pick_b, pdfA + (s.pdf - pdfA) * w,
                      s.pdf + (pdfB - s.pdf) * w)
        c = cselect(pick_b, clerp(evalA, c_first, w), clerp(c_first, evalB, w))
        new_w = c * safe_div(1.0, p)
        return BsdfSample(s.in_dir, p, new_w, s.eta, s.is_delta,
                          s.valid & (p > 1e-9))


# maximum nesting depth of blend/mask BSDFs resolved per lane (the
# reference composes arbitrarily nested make_mix_bsdf closures at JIT
# specialization time, mix.art; scenes deeper than this fall back to the
# deepest level's FIRST child)
BLEND_MAX_DEPTH = 2


def make_lane_shader(materials, mid, base_mat: MatParams, frame, entering,
                     has_blend: bool, weight_override=None,
                     present=None, measured=None) -> LaneShader:
    """Build the lane shader, resolving up to BLEND_MAX_DEPTH levels of
    blend children (nested mixes). The texture-driven weight override
    applies to the TOP level only; nested weights read the table
    constants (exports virtually always put the textured mask at the
    root)."""
    if not has_blend:
        return LaneShader(base_mat, base_mat, None, frame, entering, present,
                          measured)

    def blend_weight(mat, override=None):
        w = mat.p0 if override is None else override
        # cutoff flag (p2): binarize the weight at threshold p1
        w = jnp.where(mat.p2 > 0.5, jnp.where(w >= mat.p1, 1.0, 0.0), w)
        return jnp.where(mat.kind == BsdfKind.BLEND, jnp.clip(w, 0.0, 1.0),
                         0.0)

    def build(ids, mat, depth, override=None):
        is_blend = mat.kind == BsdfKind.BLEND
        aid = jnp.where(is_blend, mat.q0.astype(jnp.int32), ids)
        bid = jnp.where(is_blend, mat.q1.astype(jnp.int32), ids)
        matA = gather_row(materials, jnp.clip(aid, 0, None))
        matB = gather_row(materials, jnp.clip(bid, 0, None))
        if depth > 1:
            childA = build(aid, matA, depth - 1)
            childB = build(bid, matB, depth - 1)
        else:
            # deepest level: a still-nested blend child degrades to its
            # first leaf (kind BLEND evals to zero otherwise)
            childA, childB = matA, matB
        return LaneShader(childA, childB, blend_weight(mat, override),
                          frame, entering, present, measured)

    return build(mid, base_mat, BLEND_MAX_DEPTH, weight_override)
