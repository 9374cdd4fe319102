"""BVH traversal: packet descent over the packed LBVH.

The reference walks one ray at a time through a pointer queue
(raycast_bvh, ray.cpp:624-822). Here the strategy is **packet traversal**
over the packed LBVH (ops/bvh.py), written in plain jnp/lax and compiled
by XLA:

- ONE scalar node stack is shared by the whole ray packet (the wavefront
  analog of the reference's per-tile queue);
- the node id is scalar, so node data loads are `dynamic_slice` rows
  (scalar addressing — no per-lane gathers anywhere);
- an internal step loads the node's packed child row (both children's
  AABBs in 12 lanes) and slab-tests the whole packet against each child
  as dense vector ops;
- a leaf step loads the leaf's 12 coefficient rows and evaluates the
  affine-barycentric hit test for (rays x 128 triangles) as broadcast
  FMAs — the all-pairs form of Möller-Trumbore (see ops/bvh.py);
- leaf-vs-internal is a *scalar* `lax.cond`, i.e. genuine branching even
  under jit (impossible per-ray, where vmap turns cond into select-both).

A node is descended if ANY ray in the packet wants it, so packets want
coherent rays (camera tiles, low bounce depth). The packet is the whole
ray batch it is handed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.ops import intersect as I
from offline_raytracer_tpu.ops.bvh import LEAF, TriBVH
from offline_raytracer_tpu.scene.types import Scene

INF = jnp.inf


def bvh_hit_ts(bvh: TriBVH, ro, rd, t_min, t_far=None, max_stack: int = 64,
               any_hit: bool = False):
    """Packet traversal: closest triangle hit for a ray packet.

    ro, rd: (R, 3). Returns (t (R,), slot (R,) int32 into the
    leaf-ordered arrays, -1 = miss). Search-only (no gradients needed).

    ``t_far``: optional (R,) per-ray t bound seed (shadow rays pass the
    light distance; ``t_far <= t_min`` marks a lane dead on launch).
    ``any_hit``: occlusion mode — a found hit collapses the lane's bound
    and the walk stops once every live lane is resolved.
    """
    R = ro.shape[0]
    first_leaf = bvh.first_leaf
    m_occ = bvh.m_occ
    inv_d = 1.0 / rd
    ox, oy, oz = ro[:, 0], ro[:, 1], ro[:, 2]
    dx, dy, dz = rd[:, 0], rd[:, 1], rd[:, 2]

    def slab_near(row, off, best_t):
        """Packet entry distance vs the AABB at lanes [off, off+6)."""
        t0x = (row[off + 0] - ox) * inv_d[:, 0]
        t1x = (row[off + 3] - ox) * inv_d[:, 0]
        t0y = (row[off + 1] - oy) * inv_d[:, 1]
        t1y = (row[off + 4] - oy) * inv_d[:, 1]
        t0z = (row[off + 2] - oz) * inv_d[:, 2]
        t1z = (row[off + 5] - oz) * inv_d[:, 2]
        tn = jnp.maximum(
            jnp.maximum(jnp.minimum(t0x, t1x), jnp.minimum(t0y, t1y)),
            jnp.minimum(t0z, t1z))
        tf = jnp.minimum(
            jnp.minimum(jnp.maximum(t0x, t1x), jnp.maximum(t0y, t1y)),
            jnp.maximum(t0z, t1z))
        near = jnp.maximum(tn, t_min)
        return jnp.where((tf >= near) & (near < best_t), near, INF)

    def leaf_fn(carry, node):
        stack, sp, best_t, best_i = carry
        leaf = jnp.clip(node - first_leaf, 0, m_occ - 1)
        c = jax.lax.dynamic_slice(bvh.planes, (0, leaf, 0), (12, 1, LEAF))
        c = c[:, 0, :]                                 # (12, 128)
        s1x, s1y, s1z, c1, s2x, s2y, s2z, c2, nx, ny, nz, cw = c
        # all-pairs affine hit test: (R, 128)
        o_u = ox[:, None] * s1x + oy[:, None] * s1y + oz[:, None] * s1z + c1
        o_v = ox[:, None] * s2x + oy[:, None] * s2y + oz[:, None] * s2z + c2
        o_w = ox[:, None] * nx + oy[:, None] * ny + oz[:, None] * nz + cw
        d_u = dx[:, None] * s1x + dy[:, None] * s1y + dz[:, None] * s1z
        d_v = dx[:, None] * s2x + dy[:, None] * s2y + dz[:, None] * s2z
        d_w = dx[:, None] * nx + dy[:, None] * ny + dz[:, None] * nz
        ok_w = jnp.abs(d_w) > 1e-12
        t = -o_w / jnp.where(ok_w, d_w, 1.0)
        u = o_u + t * d_u
        v = o_v + t * d_v
        ok = (
            ok_w & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
            & (t >= t_min) & (t < best_t[:, None])
        )
        t = jnp.where(ok, t, INF)
        tmin = t.min(-1)
        lane = jnp.argmin(t, -1).astype(jnp.int32)
        better = tmin < best_t
        best_t = jnp.where(better, tmin, best_t)
        best_i = jnp.where(better, leaf * LEAF + lane, best_i)
        if any_hit:
            best_t = jnp.where(best_i >= 0, t_min, best_t)
        return stack, sp, best_t, best_i

    def internal_fn(carry, node):
        stack, sp, best_t, best_i = carry
        row = jax.lax.dynamic_slice(bvh.child_rows, (node, 0), (1, LEAF))[0]
        near1 = slab_near(row, 0, best_t)
        near2 = slab_near(row, 6, best_t)
        any1 = jnp.any(near1 < INF)
        any2 = jnp.any(near2 < INF)
        m1 = near1.min()
        m2 = near2.min()
        c1 = 2 * node + 1
        first_is_1 = m1 <= m2
        near_c = jnp.where(first_is_1, c1, c1 + 1)
        far_c = jnp.where(first_is_1, c1 + 1, c1)
        push_far = jnp.where(first_is_1, any2, any1)
        push_near = jnp.where(first_is_1, any1, any2)
        stack = stack.at[sp].set(jnp.where(push_far, far_c, stack[sp]))
        sp = sp + push_far.astype(jnp.int32)
        stack = stack.at[sp].set(jnp.where(push_near, near_c, stack[sp]))
        sp = sp + push_near.astype(jnp.int32)
        return stack, sp, best_t, best_i

    def body(carry):
        stack, sp, best_t, best_i = carry
        node = stack[sp - 1]
        sp = sp - 1
        return jax.lax.cond(
            node >= first_leaf, leaf_fn, internal_fn,
            (stack, sp, best_t, best_i), node)

    tf = jnp.full((R,), INF) if t_far is None else t_far

    if any_hit:
        def cond(carry):
            _, sp, best_t, best_i = carry
            undone = (best_i < 0) & (tf > t_min)
            return (sp > 0) & jnp.any(undone)
    else:
        def cond(carry):
            return carry[1] > 0

    init = (
        jnp.zeros((max_stack,), jnp.int32), jnp.int32(1),
        tf, jnp.full((R,), -1, jnp.int32),
    )
    _, _, best_t, best_i = jax.lax.while_loop(cond, body, init)
    return best_t, best_i


def coherence_order(bvh: TriBVH, ro, rd):
    """Sort permutation grouping rays by direction octant then position.

    Packet traversal descends a node if ANY ray in the packet wants it,
    so incoherent packets degenerate to brute force over the leaves.
    Sorting bounce/shadow rays by (direction octant, 3-bit-per-axis Morton
    cell of the origin within the scene AABB) makes blocks spatially tight
    again — the wavefront analog of the tile coherence the reference gets
    for free from its per-pixel loop. Parked rays (origin outside the
    scene AABB) clip to one corner cell and cluster together.
    """
    row = bvh.child_rows[0]
    wmin = jnp.minimum(row[0:3], row[6:9])
    wmax = jnp.maximum(row[3:6], row[9:12])
    ext = jnp.maximum(wmax - wmin, 1e-6)
    q = jnp.clip((ro - wmin) / ext * 8.0, 0.0, 7.0).astype(jnp.int32)  # (R,3)

    def spread3(x):  # 3 bits -> every 3rd bit
        return ((x & 1) | ((x & 2) << 2) | ((x & 4) << 4))

    morton = (spread3(q[:, 0]) << 2) | (spread3(q[:, 1]) << 1) | spread3(q[:, 2])
    octant = (
        ((rd[:, 0] > 0).astype(jnp.int32) << 2)
        | ((rd[:, 1] > 0).astype(jnp.int32) << 1)
        | (rd[:, 2] > 0).astype(jnp.int32)
    )
    return jnp.argsort((octant << 9) | morton)


def _sorted_tri_hit(bvh, cfg, ro, rd, t_far=None, any_hit=False):
    # traversal is SEARCH-ONLY: integer winners and detached bounds; the
    # differentiable hit comes from refine_hit's recompute
    ro = jax.lax.stop_gradient(ro)
    rd = jax.lax.stop_gradient(rd)
    t_far = None if t_far is None else jax.lax.stop_gradient(t_far)
    if not cfg.sort_rays:
        t, slot = bvh_hit_ts(bvh, ro, rd, cfg.t_min, t_far,
                             cfg.max_stack_depth, any_hit)
        return jax.lax.stop_gradient(t), slot
    order = coherence_order(bvh, ro, rd)
    inv = jnp.argsort(order)
    tf = None if t_far is None else t_far[order]
    t, slot = bvh_hit_ts(bvh, ro[order], rd[order], cfg.t_min, tf,
                         cfg.max_stack_depth, any_hit)
    return jax.lax.stop_gradient(t[inv]), slot[inv]


def make_bvh_trace_fn(scene: Scene, cfg: RenderConfig):
    """Closest-hit function: LBVH packet traversal for triangles + dense
    sweep for analytic primitives, merged into one Hit record with a
    differentiable refine. The BVH rides in the Scene pytree (built once
    host-side, scene/build.py)."""
    bvh = scene.tri_bvh
    assert bvh is not None, "scene has no tri_bvh; build(with_bvh=True)"

    def trace(ro, rd):
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

        if scene.spheres.radius.shape[0]:
            consider(I.sphere_ts(scene.spheres, ro, rd, cfg.t_min), I.SPHERE)
        if scene.boxes.mat.shape[0]:
            consider(I.box_ts(scene.boxes, ro, rd, cfg.t_min), I.BOX)
        if scene.cylinders.radius.shape[0]:
            consider(I.cylinder_ts(scene.cylinders, ro, rd, cfg.t_min), I.CYLINDER)

        tt, slot = _sorted_tri_hit(bvh, cfg, ro, rd)
        tri_id = jnp.where(slot >= 0, bvh.tri_index[jnp.maximum(slot, 0)], -1)
        better = (tt < best_t) & (tri_id >= 0)
        best_t = jnp.where(better, tt, best_t)
        best_type = jnp.where(better, I.TRIANGLE, best_type)
        best_idx = jnp.where(better, tri_id, best_idx)

        return I.refine_hit(
            scene, ro, rd, cfg.t_min, best_type, best_idx, best_t < INF)

    return trace


def make_bvh_occlusion_fn(scene: Scene, cfg: RenderConfig):
    """occluded(ro, rd, t_far) -> (R,) bool: anything in (t_min, t_far)?

    The shadow-ray fast path: triangles use the seeded any-hit traversal
    (lanes with ``t_far <= t_min`` are dead on launch and cost nothing);
    analytic primitives use the dense sweeps with a t_far compare.
    """
    bvh = scene.tri_bvh
    assert bvh is not None, "scene has no tri_bvh; build(with_bvh=True)"

    def occluded(ro, rd, t_far):
        hit = jnp.zeros(ro.shape[:1], bool)
        if scene.spheres.radius.shape[0]:
            ts = I.sphere_ts(scene.spheres, ro, rd, cfg.t_min)
            hit |= jnp.any(ts < t_far[:, None], -1)
        if scene.boxes.mat.shape[0]:
            ts = I.box_ts(scene.boxes, ro, rd, cfg.t_min)
            hit |= jnp.any(ts < t_far[:, None], -1)
        if scene.cylinders.radius.shape[0]:
            ts = I.cylinder_ts(scene.cylinders, ro, rd, cfg.t_min)
            hit |= jnp.any(ts < t_far[:, None], -1)

        # lanes already occluded by an analytic prim are dead for the
        # (expensive) triangle pass
        tf = jnp.where(hit, 0.0, t_far)
        _, slot = _sorted_tri_hit(bvh, cfg, ro, rd, tf, any_hit=True)
        valid_tri = (slot >= 0) & (bvh.tri_index[jnp.maximum(slot, 0)] >= 0)
        return hit | valid_tri

    return occluded
