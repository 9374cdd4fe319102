"""Three-lobe BSDF: Lambert diffuse + GGX specular + rough dielectric
transmission with Beer's-law attenuation.

This is the *intended* physics of the reference shader
(eval_scattering / pdf_brdf / sample_brdf, ray.cpp:824-1161) — a
Walter-et-al-2007 microfacet model with lobe mixture weights
||Kd|| : ||Ks|| : ||Kt|| — with the reference's catalogued defects fixed
(SURVEY.md quirk list):

- Schlick Fresnel with the correct exponent orientation (the reference's
  ``Ks + (1-(1-|d|)^5)(1-Ks)`` is inverted — white at normal incidence,
  ray.cpp:826-831);
- microfacet refraction uses Walter's half vector / Jacobian consistently
  (the reference mixes up eta assignments, ray.cpp:970, 1054);
- everything is batched and branch-free, and differentiable w.r.t.
  (Kd, Ks, Kt, ior, roughness).

Conventions: N is the geometric unit normal (not flipped toward the ray);
wo points back toward the previous vertex; wi is the sampled continuation.
Sidedness is resolved through signed dots exactly like get_beer_n
(ray.cpp:913-933): wo·N >= 0 means wo is outside the surface.
"""

from __future__ import annotations

import jax.numpy as jnp

from offline_raytracer_tpu.utils import pytree
from offline_raytracer_tpu.utils.math import frame_to_world, normalize, vdot

PI = jnp.pi


@pytree.dataclass
class MatParams:
    """Per-ray gathered material parameters (SoA)."""

    kd: jnp.ndarray         # (R, 3)
    ks: jnp.ndarray         # (R, 3)
    kt: jnp.ndarray         # (R, 3)
    ior: jnp.ndarray        # (R,)
    roughness: jnp.ndarray  # (R,)


def lobe_weights(mat: MatParams):
    """Mixture probabilities pd, ps, pt ∝ ||Kd||, ||Ks||, ||Kt||
    (ray.cpp:1104-1113)."""
    ld = jnp.linalg.norm(mat.kd, axis=-1)
    ls = jnp.linalg.norm(mat.ks, axis=-1)
    lt = jnp.linalg.norm(mat.kt, axis=-1)
    s = jnp.maximum(ld + ls + lt, 1e-12)
    return ld / s, ls / s, lt / s


def schlick_fresnel(ks, cos_d):
    """F = Ks + (1-Ks)(1-|cos|)^5. ks: (R,3), cos_d: (R,)."""
    m = jnp.clip(1.0 - jnp.abs(cos_d), 0.0, 1.0)
    return ks + (1.0 - ks) * (m**5)[..., None]


def ggx_d(n_dot_h, roughness):
    """GGX normal distribution, tan^2 form (ray.cpp:833-865)."""
    a2 = roughness**2
    c = jnp.clip(n_dot_h, 1e-6, 1.0)
    c2 = c * c
    tan2 = (1.0 - c2) / c2
    denom = PI * c2 * c2 * (a2 + tan2) ** 2
    d = a2 / jnp.maximum(denom, 1e-20)
    return jnp.where(n_dot_h > 0.0, d, 0.0)


def smith_g1(w, n, m, roughness):
    """Smith masking term for one direction (ray.cpp:867-897)."""
    w_dot_n = jnp.sum(w * n, -1)
    w_dot_m = jnp.sum(w * m, -1)
    same_side = (w_dot_n * w_dot_m) > 0.0
    c2 = jnp.clip(w_dot_n * w_dot_n, 1e-9, 1.0)
    tan2 = (1.0 - c2) / c2
    g = 2.0 / (1.0 + jnp.sqrt(1.0 + roughness**2 * tan2))
    return jnp.where(same_side, g, 0.0)


def _etas(n_dot_wo, ior):
    """(eta_o_side_of_wo, eta_other_side). get_beer_n (ray.cpp:913-933)."""
    outside = n_dot_wo >= 0.0
    eta_wo = jnp.where(outside, 1.0, ior)
    eta_wi = jnp.where(outside, ior, 1.0)
    return eta_wo, eta_wi


def eval_bsdf(n, wi, wo, mat: MatParams, distance):
    """f(wi, wo) * |wi·N| — the full scattering value including the cosine,
    as the reference returns it (eval_scattering, ray.cpp:936-1005).

    `distance` is the length of the segment arriving at this vertex, used
    for Beer's-law attenuation when that segment was inside the medium
    (wo·N < 0), matching ray.cpp:958-967.
    """
    n_dot_wi = jnp.sum(wi * n, -1)
    n_dot_wo = jnp.sum(wo * n, -1)
    # reflection lobes live on wo's side, transmission on the other (the
    # reference evaluates Kd/pi on both sides, ray.cpp:939 — a light leak)
    same_side = (n_dot_wi * n_dot_wo) > 0.0

    # --- diffuse: Kd/pi (ray.cpp:939)
    ed = jnp.where(same_side[..., None], mat.kd / PI, 0.0)

    # --- specular: Cook-Torrance with half vector oriented to wi's side
    h = jnp.sign(n_dot_wi)[..., None] * normalize(wi + wo)
    wi_dot_h = jnp.sum(wi * h, -1)
    f_spec = schlick_fresnel(mat.ks, wi_dot_h)
    d_spec = ggx_d(jnp.sum(n * h, -1), mat.roughness)
    g_spec = smith_g1(wi, n, h, mat.roughness) * smith_g1(wo, n, h, mat.roughness)
    denom_s = 4.0 * jnp.maximum(jnp.abs(n_dot_wi) * jnp.abs(n_dot_wo), 1e-6)
    es = f_spec * (d_spec * g_spec / denom_s)[..., None]
    # side-consistent facing gate: h is flipped to wi's side, so a valid
    # reflection pair has wi·h > 0 OUTSIDE but wi·h < 0 INSIDE the medium
    # (the reference's bare wi_dot_h > 0, ray.cpp:949, silently zeroes
    # backface/internal reflections)
    h_faces_wi = wi_dot_h * jnp.sign(n_dot_wi) > 0.0
    has_spec = (jnp.sum(mat.ks * mat.ks, -1) > 0.0) & h_faces_wi & same_side
    es = jnp.where(has_spec[..., None], es, 0.0)

    # --- transmission: Walter et al. 2007 eq. 21 + Beer attenuation
    eta_wo, eta_wi = _etas(n_dot_wo, mat.ior)
    ht = -(eta_wo[..., None] * wo + eta_wi[..., None] * wi)
    m = normalize(ht)
    m = m * jnp.sign(jnp.sum(m * n, -1))[..., None]   # macroscopic side
    wo_dot_m = jnp.sum(wo * m, -1)
    wi_dot_m = jnp.sum(wi * m, -1)
    eta = eta_wo / eta_wi

    # Beer's law: attenuate when the arriving segment was inside (wo·N<0)
    att = jnp.where(
        (n_dot_wo < 0.0)[..., None],
        jnp.exp(distance[..., None] * jnp.log(jnp.clip(mat.kt, 1e-6, 1.0))),
        1.0,
    )

    d_t = ggx_d(jnp.sum(n * m, -1), mat.roughness)
    g_t = smith_g1(wi, n, m, mat.roughness) * smith_g1(wo, n, m, mat.roughness)
    f_t = 1.0 - schlick_fresnel(mat.ks, wi_dot_m)
    jac_denom = (eta_wo * wo_dot_m + eta_wi * wi_dot_m) ** 2
    denom_t = jnp.maximum(
        jnp.abs(n_dot_wi) * jnp.abs(n_dot_wo) * jnp.maximum(jac_denom, 1e-9), 1e-9
    )
    num_t = d_t * g_t * jnp.abs(wi_dot_m) * jnp.abs(wo_dot_m) * eta_wi**2
    et_refract = jnp.where(
        (~same_side)[..., None], f_t * (num_t / denom_t)[..., None], 0.0)
    # total internal reflection falls back to the specular lobe
    # (ray.cpp:973-980). A SAME-side pair can only have come from the
    # transmission lobe via TIR, and its microfacet is the REFLECTION half
    # vector h — classify with the radicand at h, not at the
    # refraction-reconstructed m (meaningless for reflection pairs; using
    # it zeroed every internal reflection).
    radicand_h = 1.0 - eta**2 * (1.0 - jnp.sum(wo * h, -1) ** 2)
    es_tir = f_spec * (d_spec * g_spec / denom_s)[..., None]
    tir_ok = same_side & (radicand_h < 0.0) & h_faces_wi
    es_tir = jnp.where(tir_ok[..., None], es_tir, 0.0)
    et = jnp.where(same_side[..., None], es_tir, et_refract)
    has_trans = jnp.sum(mat.kt * mat.kt, -1) > 0.0
    et = jnp.where(has_trans[..., None], att * et, 0.0)

    return jnp.abs(n_dot_wi)[..., None] * (ed + es + et)


def pdf_bsdf(n, wi, wo, mat: MatParams):
    """Mixture pdf of sample_bsdf in wi-space (pdf_brdf, ray.cpp:1007-1063,
    with Walter's correct refraction Jacobian)."""
    pd_c, ps_c, pt_c = lobe_weights(mat)
    n_dot_wi = jnp.sum(wi * n, -1)
    n_dot_wo = jnp.sum(wo * n, -1)

    # diffuse: cosine-hemisphere around the wo-facing normal; zero density
    # on the unsampled side (the reference's |wi·N|/pi, ray.cpp:1021,
    # double-counts the back hemisphere)
    pd = jnp.maximum(n_dot_wi * jnp.sign(n_dot_wo), 0.0) / PI

    same_side = (n_dot_wi * n_dot_wo) > 0.0

    # specular: D(h)|n·h| / (4|wi·h|), reflection side only
    h = jnp.sign(n_dot_wi)[..., None] * normalize(wi + wo)
    wi_dot_h = jnp.sum(wi * h, -1)
    d_spec = ggx_d(jnp.sum(n * h, -1), mat.roughness)
    ps = d_spec * jnp.abs(jnp.sum(n * h, -1)) / jnp.maximum(4.0 * jnp.abs(wi_dot_h), 1e-9)
    ps = jnp.where(same_side, ps, 0.0)

    # transmission: D(m)|n·m| * eta_wi^2 |wi·m| / (eta_wo(wo·m)+eta_wi(wi·m))^2
    eta_wo, eta_wi = _etas(n_dot_wo, mat.ior)
    m = normalize(-(eta_wo[..., None] * wo + eta_wi[..., None] * wi))
    m = m * jnp.sign(jnp.sum(m * n, -1))[..., None]
    wo_dot_m = jnp.sum(wo * m, -1)
    wi_dot_m = jnp.sum(wi * m, -1)
    eta = eta_wo / eta_wi
    d_t = ggx_d(jnp.sum(n * m, -1), mat.roughness)
    jac_denom = jnp.maximum((eta_wo * wo_dot_m + eta_wi * wi_dot_m) ** 2, 1e-9)
    pt_refract = d_t * jnp.abs(jnp.sum(n * m, -1)) * eta_wi**2 * jnp.abs(wi_dot_m) / jac_denom
    pt_refract = jnp.where(same_side, 0.0, pt_refract)
    # TIR paths were generated by reflection off the half vector h -> the
    # specular-shaped pdf, classified by the radicand AT h (same-side
    # pairs never satisfy the refraction relation, so the reconstructed
    # m's radicand said "refraction" and returned density 0 — which killed
    # every TIR continuation: VERDICT r3 black-sphere adjacent fix)
    radicand_h = 1.0 - eta**2 * (1.0 - jnp.sum(wo * h, -1) ** 2)
    pt = jnp.where(same_side, jnp.where(radicand_h < 0.0, ps, 0.0), pt_refract)

    return pd_c * pd + ps_c * ps + pt_c * pt


@pytree.dataclass
class BsdfSample:
    wi: jnp.ndarray               # (R, 3)
    is_transmission: jnp.ndarray  # (R,) bool — ray passes through the surface


def sample_bsdf(u, n, wo, mat: MatParams) -> BsdfSample:
    """Importance-sample wi from the 3-lobe mixture (sample_brdf,
    ray.cpp:1100-1161).

    ``u``: (..., 3) uniforms in [0,1) — [e0, e1, lobe choice]. Taking
    uniforms instead of a key keeps this fully batched (one call for the
    whole wavefront) while the caller keeps draws counter-based per ray.
    """
    pd_c, ps_c, _ = lobe_weights(mat)
    e0, e1, choice = u[..., 0], u[..., 1], u[..., 2]
    phi = 2.0 * PI * e1

    n_dot_wo = jnp.sum(wo * n, -1)
    # sample around the normal oriented toward wo's side, so lobes face the
    # correct hemisphere even when shading the backface
    n_face = n * jnp.sign(n_dot_wo)[..., None]

    # diffuse: cosine-weighted (cos_theta = sqrt(e0), ray.cpp:1123)
    cos_d = jnp.sqrt(e0)
    sin_d = jnp.sqrt(jnp.clip(1.0 - e0, 0.0, 1.0))
    wi_diffuse = frame_to_world(
        jnp.stack([sin_d * jnp.cos(phi), sin_d * jnp.sin(phi), cos_d], -1), n_face)

    # GGX half-vector: cos_theta_m = 1/sqrt(1 + a^2 e0/(1-e0)) (ray.cpp:1128)
    a2e = mat.roughness**2 * e0 / jnp.maximum(1.0 - e0, 1e-9)
    cos_m = 1.0 / jnp.sqrt(1.0 + a2e)
    sin_m = jnp.sqrt(jnp.clip(1.0 - cos_m**2, 0.0, 1.0))
    m = frame_to_world(
        jnp.stack([sin_m * jnp.cos(phi), sin_m * jnp.sin(phi), cos_m], -1), n_face)

    wo_dot_m = jnp.sum(wo * m, -1)
    wi_spec = 2.0 * jnp.abs(wo_dot_m)[..., None] * m - wo

    # refraction of wo about m (ray.cpp:1153 / Walter eq. 40). m is sampled
    # around the wo-FACING normal (m.wo > 0 by construction), so the
    # transmitted direction always lies on the far side of m: wi.m = -sq.
    # (The reference's `- sign(wo.N) * sq` term, ray.cpp:1153, belongs to
    # its UNFLIPPED-m convention; combined with a flipped m it sent
    # inside->out refractions back into the medium with pdf 0 — every path
    # through a glass body died on exit, rendering it black. VERDICT r3
    # "black sphere" root cause.)
    eta_wo, eta_wi = _etas(n_dot_wo, mat.ior)
    eta = eta_wo / eta_wi
    radicand = 1.0 - eta**2 * (1.0 - wo_dot_m**2)
    tir = radicand < 0.0
    sq = jnp.sqrt(jnp.clip(radicand, 0.0, 1.0))
    wi_refract = (eta * wo_dot_m - sq)[..., None] * m - eta[..., None] * wo
    wi_trans = jnp.where(tir[..., None], wi_spec, wi_refract)

    pick_d = choice < pd_c
    pick_s = (~pick_d) & (choice < pd_c + ps_c)
    wi = jnp.where(pick_d[..., None], wi_diffuse,
                   jnp.where(pick_s[..., None], wi_spec, wi_trans))
    is_trans = (~pick_d) & (~pick_s) & (~tir)
    return BsdfSample(wi=normalize(wi), is_transmission=is_trans)


def gather_mat_params(materials, mat_idx, default_roughness, roughness_from_material=False) -> MatParams:
    """Gather per-ray material parameters from the material table.

    The reference hardcodes roughness=0.01 ignoring the .scn exponent
    (ray.cpp:1194); with roughness_from_material=True we map the Phong
    exponent to a GGX alpha instead (alpha = sqrt(2/(exp+2))).
    """
    kd = materials.diffuse[mat_idx]
    ks = materials.specular[mat_idx]
    kt = materials.transmission[mat_idx]
    ior = jnp.maximum(materials.ior[mat_idx], 1.0)
    if roughness_from_material:
        rough = jnp.sqrt(2.0 / (materials.spec_exp[mat_idx] + 2.0))
    else:
        rough = jnp.full_like(ior, default_roughness)
    return MatParams(kd=kd, ks=ks, kt=kt, ior=ior, roughness=rough)
