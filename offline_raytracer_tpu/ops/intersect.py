"""Batched ray-primitive intersection kernels.

A batched re-design of the reference's scalar kernels
(ray_intersect_with_{triangle,sphere,aab,cylinder}, ray.cpp:63-352):
every function is branch-free (jnp.where masks instead of early-outs) and
broadcasts over an arbitrary leading ray axis, so the same code runs as an
all-pairs sweep (rays x prims), inside the BVH traversal loop, and as the
differentiable per-winner recompute.

Conventions:
- miss is encoded as t = +inf
- normals are *geometric* and unnormalized until the final hit record
  (matches raycast_bvh, which normalizes once at the end, ray.cpp:817)
- `inner` marks hits that started inside the primitive (sphere tn<0 case,
  ray.cpp:156-162; box/cylinder exit hits which the reference misses)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from offline_raytracer_tpu.scene.types import Boxes, Cylinders, Scene, Spheres, Triangles
from offline_raytracer_tpu.utils import pytree

INF = jnp.inf


@pytree.dataclass
class Hit:
    """Per-ray hit record (SoA). The ray-state analog of RaycastBVHResult
    (ray.cpp:613-622) minus the stats counter."""

    t: jnp.ndarray        # (R,) distance, +inf on miss
    normal: jnp.ndarray   # (R, 3) unit geometric normal
    mat: jnp.ndarray      # (R,) int32 material index (0 on miss)
    inner: jnp.ndarray    # (R,) bool: ray origin was inside the primitive
    valid: jnp.ndarray    # (R,) bool


# ---------------------------------------------------------------------------
# Sphere (reference: ray.cpp:132-190)
# ---------------------------------------------------------------------------


def sphere_ts(sph: Spheres, ro, rd, t_min):
    """All-pairs sphere hit distances. ro, rd: (R, 3) -> t: (R, N)."""
    rel = ro[:, None, :] - sph.center[None, :, :]            # (R, N, 3)
    b = jnp.sum(rd[:, None, :] * rel, -1)                    # (R, N)
    c = jnp.sum(rel * rel, -1) - sph.radius[None, :] ** 2    # rd assumed unit
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    tn, tp = -b - sq, -b + sq
    t = jnp.where(tn >= t_min, tn, tp)
    ok = (disc > 0.0) & (t >= t_min)
    return jnp.where(ok, t, INF)


def sphere_hit_one(center, radius, ro, rd, t_min):
    """Differentiable single-sphere hit: center (R,3), radius (R,)."""
    rel = ro - center
    b = jnp.sum(rd * rel, -1)
    c = jnp.sum(rel * rel, -1) - radius**2
    disc = b * b - c
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    tn, tp = -b - sq, -b + sq
    inner = tn < t_min
    t = jnp.where(inner, tp, tn)
    normal = rel + t[..., None] * rd   # p - center; outward even on inner hit
    return t, normal, inner


# ---------------------------------------------------------------------------
# Axis-aligned box (reference: ray.cpp:206-283)
#
# The reference returns hit_t = max(t_entry) with no positivity check (its
# traversal filters t < threshold, so origin-inside-box hits are lost,
# SURVEY.md quirk list). Here: entry hit if t_entry >= t_min, else exit hit
# (inner) if t_exit >= t_min — boxes are watertight from inside too.
# ---------------------------------------------------------------------------


def box_ts(box: Boxes, ro, rd, t_min):
    """All-pairs box hit distances. -> (R, N)."""
    inv = 1.0 / rd                                            # (R, 3), inf ok
    t0 = (box.bmin[None] - ro[:, None, :]) * inv[:, None, :]  # (R, N, 3)
    t1 = (box.bmax[None] - ro[:, None, :]) * inv[:, None, :]
    tmin = jnp.minimum(t0, t1).max(-1)
    tmax = jnp.maximum(t0, t1).min(-1)
    t = jnp.where(tmin >= t_min, tmin, tmax)
    ok = (tmax >= jnp.maximum(tmin, t_min))
    return jnp.where(ok, t, INF)


def box_hit_one(bmin, bmax, ro, rd, t_min):
    """Differentiable single-box hit: bmin, bmax (R,3)."""
    inv = 1.0 / rd
    t0 = (bmin - ro) * inv
    t1 = (bmax - ro) * inv
    tn = jnp.minimum(t0, t1)
    tf = jnp.maximum(t0, t1)
    t_entry = tn.max(-1)
    t_exit = tf.min(-1)
    inner = t_entry < t_min
    t = jnp.where(inner, t_exit, t_entry)
    # slab axis of the winning plane: argmax of tn (entry) / argmin of tf (exit)
    axis_entry = jnp.argmax(tn, -1)
    axis_exit = jnp.argmin(tf, -1)
    axis = jnp.where(inner, axis_exit, axis_entry)
    # one-hot via compares: no gather from an identity table
    n_axis = jnp.stack(
        [axis == 0, axis == 1, axis == 2], -1).astype(ro.dtype)  # (R, 3)
    # outward normal: against ray on entry, along ray on exit; then flip to
    # the face's outward orientation via sign of rd on that axis
    sgn = jnp.sign(jnp.take_along_axis(rd, axis[..., None], -1))[..., 0]
    normal = n_axis * jnp.where(inner, sgn, -sgn)[..., None]
    return t, normal, inner


# ---------------------------------------------------------------------------
# Cylinder (reference: ray.cpp:286-352)
#
# Finite cylinder = slab (two caps) ∩ infinite cylinder, evaluated in a
# local frame where the axis is +Z (precomputed rot, world->local). The
# reference gives caps the bogus normal (0,1,0) (ray.cpp:330) — fixed here:
# caps get (0,0,±1), sides the radial normal.
#
# The 3x3 frame changes are elementwise products + sums, not einsums: a
# contraction lowered as a dot may run in TF32 on tensor-core GPUs, which
# would perturb t and the normal by ~1e-3 relative. This keeps full f32 on
# every backend.
# ---------------------------------------------------------------------------


def cylinder_ts(cyl: Cylinders, ro, rd, t_min):
    """All-pairs cylinder hit distances. -> (R, N)."""
    # local-frame ray per (ray, cyl): o = R (ro - base), d = R rd
    rel = ro[:, None, :] - cyl.base[None]                     # (R, N, 3)
    o = jnp.sum(cyl.rot[None] * rel[:, :, None, :], -1)       # (R, N, 3)
    d = jnp.sum(cyl.rot[None] * rd[:, None, None, :], -1)
    height = jnp.linalg.norm(cyl.axis, axis=-1)[None]         # (1, N)

    t_bot = -o[..., 2] / d[..., 2]
    t_top = (height - o[..., 2]) / d[..., 2]
    t_slab_min = jnp.minimum(t_bot, t_top)
    t_slab_max = jnp.maximum(t_bot, t_top)

    a = jnp.sum(d[..., :2] ** 2, -1)
    b = jnp.sum(d[..., :2] * o[..., :2], -1)
    c = jnp.sum(o[..., :2] ** 2, -1) - cyl.radius[None] ** 2
    disc = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    safe_a = jnp.where(a > 1e-12, a, 1.0)
    t_cyl_min = jnp.where(a > 1e-12, (-b - sq) / safe_a, -INF)
    t_cyl_max = jnp.where(a > 1e-12, (-b + sq) / safe_a, INF)

    t_entry = jnp.maximum(t_slab_min, t_cyl_min)
    t_exit = jnp.minimum(t_slab_max, t_cyl_max)
    t = jnp.where(t_entry >= t_min, t_entry, t_exit)
    ok = (disc >= 0.0) & (t_exit >= jnp.maximum(t_entry, t_min))
    return jnp.where(ok, t, INF)


def cylinder_hit_one(base, axis, radius, rot, ro, rd, t_min):
    """Differentiable single-cylinder hit. rot: (R,3,3) world->local."""
    o = jnp.sum(rot * (ro - base)[..., None, :], -1)
    d = jnp.sum(rot * rd[..., None, :], -1)
    height = jnp.linalg.norm(axis, axis=-1)

    dz = jnp.where(jnp.abs(d[..., 2]) > 1e-12, d[..., 2], 1e-12)
    t_bot = -o[..., 2] / dz
    t_top = (height - o[..., 2]) / dz
    t_slab_min = jnp.minimum(t_bot, t_top)
    t_slab_max = jnp.maximum(t_bot, t_top)

    a = jnp.sum(d[..., :2] ** 2, -1)
    b = jnp.sum(d[..., :2] * o[..., :2], -1)
    c = jnp.sum(o[..., :2] ** 2, -1) - radius**2
    disc = b * b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 1e-12))
    safe_a = jnp.where(a > 1e-12, a, 1.0)
    t_cyl_min = jnp.where(a > 1e-12, (-b - sq) / safe_a, -INF)
    t_cyl_max = jnp.where(a > 1e-12, (-b + sq) / safe_a, INF)

    t_entry = jnp.maximum(t_slab_min, t_cyl_min)
    t_exit = jnp.minimum(t_slab_max, t_cyl_max)
    inner = t_entry < t_min
    t = jnp.where(inner, t_exit, t_entry)

    # cap hit if the slab bound wins at the chosen t, else side hit
    cap_win = jnp.where(inner, t_slab_max < t_cyl_max, t_slab_min > t_cyl_min)
    p_local = o + t[..., None] * d
    n_side = jnp.concatenate([p_local[..., :2], jnp.zeros_like(t)[..., None]], -1)
    # bottom cap normal (0,0,-1), top (0,0,+1), by which cap plane is nearer
    z_at_hit = p_local[..., 2]
    n_cap_z = jnp.where(z_at_hit > 0.5 * height, 1.0, -1.0)
    n_cap = jnp.stack([jnp.zeros_like(t), jnp.zeros_like(t), n_cap_z], -1)
    n_local = jnp.where(cap_win[..., None], n_cap, n_side)
    # back to world: rot is orthonormal, inverse = transpose (ray.cpp:341)
    normal = jnp.sum(rot * n_local[..., :, None], -2)
    return t, normal, inner


# ---------------------------------------------------------------------------
# Triangle — Möller-Trumbore (reference: ray.cpp:63-115)
# ---------------------------------------------------------------------------


def triangle_ts(tri: Triangles, ro, rd, t_min):
    """All-pairs triangle hit distances. -> (R, N)."""
    e1 = tri.v1 - tri.v0                                      # (N, 3)
    e2 = tri.v2 - tri.v0
    pvec = jnp.cross(rd[:, None, :], e2[None])                # (R, N, 3)
    det = jnp.sum(pvec * e1[None], -1)                        # (R, N)
    tvec = ro[:, None, :] - tri.v0[None]
    qvec = jnp.cross(tvec, e1[None])
    inv_det = jnp.where(jnp.abs(det) > 1e-9, 1.0 / det, 0.0)
    u = jnp.sum(pvec * tvec, -1) * inv_det
    v = jnp.sum(qvec * rd[:, None, :], -1) * inv_det
    t = jnp.sum(qvec * e2[None], -1) * inv_det
    ok = (jnp.abs(det) > 1e-9) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
    return jnp.where(ok, t, INF)


def triangle_hit_one(v0, v1, v2, ro, rd, t_min):
    """Differentiable single-triangle hit: v0/v1/v2 (R,3)."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = jnp.cross(rd, e2)
    det = jnp.sum(pvec * e1, -1)
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    tvec = ro - v0
    qvec = jnp.cross(tvec, e1)
    t = jnp.sum(qvec * e2, -1) * inv_det
    normal = jnp.cross(e1, e2)           # geometric, unflipped (ray.cpp:110)
    inner = jnp.zeros_like(t, bool)
    return t, normal, inner


# ---------------------------------------------------------------------------
# Closest hit over the whole scene (brute force, no BVH)
#
# This is the batched analog of the reference's pre-BVH dense loop (dead code
# ray.cpp:354-488): a masked min-reduction over every primitive, which for
# the analytic prim counts in testscene.scn (~31) beats tree traversal on a
# vector machine. Triangle sets use the BVH path (ops/traverse.py) instead.
# ---------------------------------------------------------------------------

# stable type ids for combining winners
SPHERE, BOX, CYLINDER, TRIANGLE = 0, 1, 2, 3


def closest_hit_bruteforce(scene: Scene, ro, rd, t_min, include_triangles: bool = True) -> Hit:
    """Find the closest hit across all primitive tables. ro, rd: (R, 3)."""
    R = ro.shape[0]
    best_t = jnp.full((R,), INF)
    best_type = jnp.zeros((R,), jnp.int32)
    best_idx = jnp.zeros((R,), jnp.int32)

    def consider(t_all, type_id):
        nonlocal best_t, best_type, best_idx
        t_prim = t_all.min(-1)
        i_prim = jnp.argmin(t_all, -1).astype(jnp.int32)
        better = t_prim < best_t
        best_t = jnp.where(better, t_prim, best_t)
        best_type = jnp.where(better, type_id, best_type)
        best_idx = jnp.where(better, i_prim, best_idx)

    # The search is detached, like the BVH walk (ops/traverse.py): only its
    # integer winners are used, so autodiff keeps no (rays x prims)
    # residuals; gradients flow through refine_hit's recompute.
    sc, ro_s, rd_s = jax.lax.stop_gradient((scene, ro, rd))
    # Python-level branches on static prim counts — resolved at trace time.
    if sc.spheres.radius.shape[0]:
        consider(sphere_ts(sc.spheres, ro_s, rd_s, t_min), SPHERE)
    if sc.boxes.mat.shape[0]:
        consider(box_ts(sc.boxes, ro_s, rd_s, t_min), BOX)
    if sc.cylinders.radius.shape[0]:
        consider(cylinder_ts(sc.cylinders, ro_s, rd_s, t_min), CYLINDER)
    if include_triangles and sc.triangles.mat.shape[0]:
        consider(triangle_ts(sc.triangles, ro_s, rd_s, t_min), TRIANGLE)

    return refine_hit(scene, ro, rd, t_min, best_type, best_idx, best_t < INF)


def refine_hit(scene: Scene, ro, rd, t_min, prim_type, prim_idx, valid) -> Hit:
    """Differentiable recompute of (t, normal, mat) for known winners.

    The search phase (all-pairs mins or BVH traversal) only needs integer
    winners; gradients flow through this recompute — the standard
    detached-search / attached-geometry split for differentiable tracing.
    """
    R = ro.shape[0]
    t = jnp.full((R,), INF)
    normal = jnp.zeros((R, 3))
    mat = jnp.zeros((R,), jnp.int32)
    inner = jnp.zeros((R,), bool)

    def blend(type_id, t_i, n_i, inner_i, mat_i):
        nonlocal t, normal, mat, inner
        sel = valid & (prim_type == type_id)
        t = jnp.where(sel, t_i, t)
        normal = jnp.where(sel[..., None], n_i, normal)
        mat = jnp.where(sel, mat_i, mat)
        inner = jnp.where(sel, inner_i, inner)

    idx = prim_idx
    if scene.spheres.radius.shape[0]:
        i = jnp.clip(idx, 0, scene.spheres.radius.shape[0] - 1)
        t_i, n_i, in_i = sphere_hit_one(
            scene.spheres.center[i], scene.spheres.radius[i], ro, rd, t_min)
        blend(SPHERE, t_i, n_i, in_i, scene.spheres.mat[i])
    if scene.boxes.mat.shape[0]:
        i = jnp.clip(idx, 0, scene.boxes.mat.shape[0] - 1)
        t_i, n_i, in_i = box_hit_one(scene.boxes.bmin[i], scene.boxes.bmax[i], ro, rd, t_min)
        blend(BOX, t_i, n_i, in_i, scene.boxes.mat[i])
    if scene.cylinders.radius.shape[0]:
        i = jnp.clip(idx, 0, scene.cylinders.radius.shape[0] - 1)
        t_i, n_i, in_i = cylinder_hit_one(
            scene.cylinders.base[i], scene.cylinders.axis[i],
            scene.cylinders.radius[i], scene.cylinders.rot[i], ro, rd, t_min)
        blend(CYLINDER, t_i, n_i, in_i, scene.cylinders.mat[i])
    if scene.triangles.mat.shape[0]:
        i = jnp.clip(idx, 0, scene.triangles.mat.shape[0] - 1)
        t_i, n_i, in_i = triangle_hit_one(
            scene.triangles.v0[i], scene.triangles.v1[i], scene.triangles.v2[i],
            ro, rd, t_min)
        blend(TRIANGLE, t_i, n_i, in_i, scene.triangles.mat[i])

    nlen = jnp.linalg.norm(normal, axis=-1, keepdims=True)
    normal = normal / jnp.maximum(nlen, 1e-12)
    return Hit(t=t, normal=normal, mat=jnp.where(valid, mat, 0),
               inner=inner & valid, valid=valid)
