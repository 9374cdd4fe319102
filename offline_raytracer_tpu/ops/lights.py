"""Shaped area lights: next-event estimation with MIS.

The reference has a light table (push_light, parser.cpp:1144-1182) whose
sampler only handles spheres and whose explicit-connection branch is dead
code behind ``#if 0`` (sample_random_lights ray.cpp:528-601, NEE block
ray.cpp:1285-1327) — cylinder and mesh lights silently fall through. Here
every emissive shape is NEE-sampleable:

- sphere: uniform over the surface, pdf 1/(4 pi r^2) — the pdf the
  reference *claimed* (ray.cpp:568) while its angle-uniform sampler
  (random.h:100-117) didn't match; ours does;
- cylinder: uniform over lateral surface + both caps;
- triangle mesh: area-proportional triangle pick (per-light CDF +
  searchsorted) then uniform barycentric point;

with the uniform 1/L light pick of the reference. Combined with BSDF
sampling by the balance heuristic. All sampling is per-ray keyed
(counter-based determinism).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from offline_raytracer_tpu.utils import pytree
from offline_raytracer_tpu.utils.math import normalize

PI = jnp.pi

KIND_SPHERE, KIND_CYLINDER, KIND_MESH = 0, 1, 2


@pytree.dataclass
class AreaLights:
    """SoA table of NEE-sampleable emissive shapes (L lights)."""

    kind: jnp.ndarray    # (L,) int32
    mat: jnp.ndarray     # (L,) int32 material (emission lives there)
    area: jnp.ndarray    # (L,) total surface area
    p0: jnp.ndarray      # (L, 3) sphere center / cylinder base
    axis: jnp.ndarray    # (L, 3) cylinder axis (|axis| = height); 0 else
    radius: jnp.ndarray  # (L,) sphere/cylinder radius
    rot: jnp.ndarray     # (L, 3, 3) world<-local for cylinders (identity else)
    tri_lo: jnp.ndarray  # (L,) first row in the emissive-triangle arrays
    tri_hi: jnp.ndarray  # (L,) one-past-last row
    cdf_base: jnp.ndarray  # (L,) mesh ordinal offset into em_cdf's value range
    # shared emissive-triangle pool (T rows; empty if no mesh lights)
    em_v0: jnp.ndarray   # (T, 3)
    em_v1: jnp.ndarray
    em_v2: jnp.ndarray
    em_cdf: jnp.ndarray  # (T,) globally monotone CDF: mesh light k's slice
    #                      spans (k, k+1] (per-light normalized cumsum + k)

    @property
    def count(self) -> int:
        return self.kind.shape[0]


def empty_area_lights() -> AreaLights:
    z3 = jnp.zeros((0, 3))
    zi = jnp.zeros((0,), jnp.int32)
    zf = jnp.zeros((0,))
    return AreaLights(
        kind=zi, mat=zi, area=zf, p0=z3, axis=z3, radius=zf,
        rot=jnp.zeros((0, 3, 3)), tri_lo=zi, tri_hi=zi, cdf_base=zf,
        em_v0=z3, em_v1=z3, em_v2=z3, em_cdf=zf)


@pytree.dataclass
class LightSample:
    p: jnp.ndarray         # (R, 3) point on the light surface
    normal: jnp.ndarray    # (R, 3) light surface normal (outward)
    emit: jnp.ndarray      # (R, 3) emitted radiance
    pdf_area: jnp.ndarray  # (R,) area-measure pdf incl. the 1/L pick
    mat: jnp.ndarray       # (R,) light material index


def sample_lights(u, lights: AreaLights, emit_table) -> LightSample:
    """Batched (light, point) sampling from uniforms ``u`` (R, 4).

    Fully tensorized — no vmap, no per-ray control flow: every lane
    evaluates all three shape samplers as dense VPU math and selects by
    kind. u columns: [pick, a, b, c]; all draws counter-based (the caller
    derives u from per-(pixel,sample,bounce) keys so the result is
    sharding-invariant).
    """
    L = lights.count
    u_pick, u_a, u_b, u_c = u[..., 0], u[..., 1], u[..., 2], u[..., 3]
    idx = jnp.minimum((u_pick * L).astype(jnp.int32), L - 1)

    kind = lights.kind[idx]          # (R,)
    r = lights.radius[idx]
    p0 = lights.p0[idx]              # (R, 3)
    axis = lights.axis[idx]
    rot = lights.rot[idx]            # (R, 3, 3)

    # --- sphere: uniform on surface
    z = 1.0 - 2.0 * u_a
    phi = 2.0 * PI * u_b
    s = jnp.sqrt(jnp.clip(1.0 - z * z, 0.0, 1.0))
    n_sph = jnp.stack([s * jnp.cos(phi), s * jnp.sin(phi), z], -1)
    p_sph = p0 + r[..., None] * n_sph

    # --- cylinder: lateral surface vs caps by area fraction (local frame:
    # base at origin, axis = +z, height h; world = rot^T local + base)
    h = jnp.linalg.norm(axis, axis=-1)
    a_lat = 2.0 * PI * r * h
    a_cap = PI * r * r
    a_tot = jnp.maximum(a_lat + 2.0 * a_cap, 1e-12)
    pick_lat = u_c < a_lat / a_tot
    pick_top = (~pick_lat) & (u_c < (a_lat + a_cap) / a_tot)
    cphi, sphi = jnp.cos(phi), jnp.sin(phi)
    rr = r * jnp.sqrt(u_a)
    rad_l = jnp.where(pick_lat, r, rr)
    z_l = jnp.where(pick_lat, u_a * h, jnp.where(pick_top, h, 0.0))
    p_local = jnp.stack([rad_l * cphi, rad_l * sphi, z_l], -1)
    n_local = jnp.where(
        pick_lat[..., None],
        jnp.stack([cphi, sphi, jnp.zeros_like(cphi)], -1),
        jnp.stack([jnp.zeros_like(cphi), jnp.zeros_like(cphi),
                   jnp.where(pick_top, 1.0, -1.0)], -1))
    # world = rot^T @ local + p0, batched: (R,3,3)^T (R,3). Written as an
    # elementwise product + sum, not an einsum: a 3x3 contraction lowered
    # as a dot may run in TF32 on tensor-core GPUs, which would move the
    # sample point by ~1e-3 relative. This keeps full f32 on every backend.
    p_cyl = jnp.sum(rot * p_local[..., :, None], -2) + p0
    n_cyl = jnp.sum(rot * n_local[..., :, None], -2)

    # --- mesh: two-level pick — light idx is already chosen, then the
    # triangle comes from the globally monotone CDF (light k's slice spans
    # (k, k+1]) so one searchsorted lands inside the right slice even with
    # many mesh lights.
    if lights.em_cdf.shape[0] > 0:
        lo = lights.tri_lo[idx]
        hi = lights.tri_hi[idx]
        key = lights.cdf_base[idx] + jnp.clip(u_a, 1e-7, 1.0 - 1e-7)
        t_idx = jnp.searchsorted(lights.em_cdf, key, side="left").astype(jnp.int32)
        t_idx = jnp.clip(t_idx, lo, jnp.maximum(hi - 1, lo))
        tv0 = lights.em_v0[t_idx]
        tv1 = lights.em_v1[t_idx]
        tv2 = lights.em_v2[t_idx]
        su = jnp.sqrt(jnp.clip(u_b, 1e-12, 1.0))
        b0 = 1.0 - su
        b1 = su * (1.0 - u_c)
        p_mesh = b0[..., None] * tv0 + b1[..., None] * tv1 \
            + (1.0 - b0 - b1)[..., None] * tv2
        n_mesh = jnp.cross(tv1 - tv0, tv2 - tv0)
        n_mesh = n_mesh / jnp.maximum(
            jnp.linalg.norm(n_mesh, axis=-1, keepdims=True), 1e-12)
    else:
        p_mesh = jnp.zeros_like(p_sph)
        n_mesh = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), p_sph.shape)

    is_sph = (kind == KIND_SPHERE)[..., None]
    is_cyl = (kind == KIND_CYLINDER)[..., None]
    p = jnp.where(is_sph, p_sph, jnp.where(is_cyl, p_cyl, p_mesh))
    n = jnp.where(is_sph, n_sph, jnp.where(is_cyl, n_cyl, n_mesh))
    pdf_area = 1.0 / (jnp.maximum(lights.area[idx], 1e-12) * L)
    mat = lights.mat[idx]
    return LightSample(p=p, normal=n, emit=emit_table[mat],
                       pdf_area=pdf_area, mat=mat)


def light_pdf_area(lights: AreaLights, light_idx):
    """Area pdf of sample_lights for a given light index (clipped)."""
    L = lights.count
    i = jnp.clip(light_idx, 0, max(L - 1, 0))
    return 1.0 / (jnp.maximum(lights.area[i], 1e-12) * max(L, 1))


def solid_angle_pdf(pdf_area, dist, cos_light):
    """Convert area pdf to solid-angle pdf at the shading point."""
    return pdf_area * dist**2 / jnp.maximum(jnp.abs(cos_light), 1e-6)


def mis_balance(p_a, p_b):
    """Balance heuristic weight for strategy a vs b."""
    return p_a / jnp.maximum(p_a + p_b, 1e-12)


# ---------------------------------------------------------------------------
# Host-side construction (numpy)
# ---------------------------------------------------------------------------


def build_area_lights(entries, rot_for_axis=None) -> AreaLights:
    """entries: list of dicts with keys
    {kind, mat, p0?, axis?, radius?, rot?, tris? (F,3,3)}. numpy in, pytree out."""
    if not entries:
        return empty_area_lights()
    L = len(entries)
    kind = np.zeros(L, np.int32)
    mat = np.zeros(L, np.int32)
    area = np.zeros(L, np.float32)
    p0 = np.zeros((L, 3), np.float32)
    axis = np.zeros((L, 3), np.float32)
    radius = np.zeros(L, np.float32)
    rot = np.tile(np.eye(3, dtype=np.float32), (L, 1, 1))
    tri_lo = np.zeros(L, np.int32)
    tri_hi = np.zeros(L, np.int32)
    cdf_base = np.zeros(L, np.float32)
    em = []
    cdf_parts = []
    mesh_ord = 0

    for i, e in enumerate(entries):
        kind[i] = e["kind"]
        mat[i] = e["mat"]
        if e["kind"] == KIND_SPHERE:
            p0[i] = e["p0"]
            radius[i] = e["radius"]
            area[i] = 4.0 * np.pi * e["radius"] ** 2
        elif e["kind"] == KIND_CYLINDER:
            p0[i] = e["p0"]
            axis[i] = e["axis"]
            radius[i] = e["radius"]
            rot[i] = e["rot"]
            h = np.linalg.norm(e["axis"])
            area[i] = 2 * np.pi * e["radius"] * h + 2 * np.pi * e["radius"] ** 2
        else:
            tris = np.asarray(e["tris"], np.float32)  # (F, 3, 3)
            a = 0.5 * np.linalg.norm(
                np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0]), axis=-1)
            area[i] = a.sum()
            tri_lo[i] = sum(x.shape[0] for x in em)
            tri_hi[i] = tri_lo[i] + tris.shape[0]
            em.append(tris)
            # globally monotone: mesh light k's slice spans (k, k+1], so a
            # single searchsorted(cdf_base[light] + u) lands in the right
            # slice — per-light normalized CDFs concatenated raw would NOT
            # be monotone with >1 mesh light (the round-1 bug).
            cdf_parts.append(mesh_ord + np.cumsum(a) / max(a.sum(), 1e-12))
            cdf_base[i] = mesh_ord
            mesh_ord += 1

    if em:
        em_all = np.concatenate(em, 0)
        cdf_all = np.concatenate(cdf_parts).astype(np.float32)
        ev0, ev1, ev2 = em_all[:, 0], em_all[:, 1], em_all[:, 2]
    else:
        ev0 = ev1 = ev2 = np.zeros((0, 3), np.float32)
        cdf_all = np.zeros((0,), np.float32)

    return AreaLights(
        kind=jnp.asarray(kind), mat=jnp.asarray(mat), area=jnp.asarray(area),
        p0=jnp.asarray(p0), axis=jnp.asarray(axis), radius=jnp.asarray(radius),
        rot=jnp.asarray(rot), tri_lo=jnp.asarray(tri_lo),
        tri_hi=jnp.asarray(tri_hi), cdf_base=jnp.asarray(cdf_base),
        em_v0=jnp.asarray(ev0), em_v1=jnp.asarray(ev1), em_v2=jnp.asarray(ev2),
        em_cdf=jnp.asarray(cdf_all))
