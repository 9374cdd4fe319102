"""Host-side BVH construction into flat arrays.

Replaces the reference's pointer-chasing centroid octree
(push_shape_inside_node / validate_nodes_and_reallocate_shapes,
ray.cpp:1469-2045, built at macos_main.mm:416-545) with a Morton-ordered
LBVH whose layout serves the packet walk of ops/traverse.py: dynamic-ROW
loads and static-LANE extracts, no per-ray gathers:

- **128-triangle leaves.** Leaves take 128 consecutive Morton-sorted
  triangles, so one leaf = one row of each coefficient plane and a leaf
  test is a dense (rays x 128) broadcast sweep.
- **Affine-barycentric triangle encoding.** Each triangle is stored as
  12 coefficients (s1, c1, s2, c2, n, cw) such that for a ray (o, d):
      t = -(n·o + cw) / (n·d),  u = (s1·o + c1) + t (s1·d),
      v = (s2·o + c2) + t (s2·d),  hit iff u>=0, v>=0, u+v<=1.
  This turns Möller-Trumbore's per-triangle cross products into pure
  broadcast-FMA work against per-leaf coefficient rows — no per-lane
  gathers anywhere. Coefficients live in a (12, M, 128) plane stack.
- **Packed internal nodes.** The tree is an implicit binary heap
  (children of i at 2i+1/2i+2 — no pointers, unlike the reference's
  BVHOctreeNode ray.h:115-133). Node i's row holds BOTH children's
  AABBs in lanes 0..11, so a traversal step is one dynamic-row load
  plus twelve static-lane extracts.

Empty padded leaves get inverted AABBs (never descended) and degenerate
coefficient rows (n = 0 => rejected by the |n·d| guard).

Everything here is one-time numpy work on the host; the device sees only
flat float32/int32 arrays riding in the Scene pytree.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from offline_raytracer_tpu.utils import pytree

LEAF = 128  # triangles per leaf == vector lane width

# plane indices in the (12, M, 128) coefficient stack
S1X, S1Y, S1Z, C1, S2X, S2Y, S2Z, C2, NX, NY, NZ, CW = range(12)


@pytree.dataclass
class TriBVH:
    child_rows: jnp.ndarray  # (max(P-1,1), 128): lanes 0-5 = child1 AABB
    #                          (minx,miny,minz,maxx,maxy,maxz), 6-11 = child2
    planes: jnp.ndarray      # (12, M_pad, 128) triangle coefficient planes
    tri_index: jnp.ndarray   # (M_pad*128,) int32 original tri id, -1 = pad
    mat: jnp.ndarray         # (M_pad*128,) int32 material per slot
    n_leaves: int = pytree.field(static=True, default=1)   # P, pow2
    m_occ: int = pytree.field(static=True, default=1)      # occupied

    @property
    def first_leaf(self) -> int:
        return self.n_leaves - 1


def morton_codes(centroids: np.ndarray) -> np.ndarray:
    """30-bit Morton codes from centroid positions (vectorized)."""
    lo = centroids.min(0)
    hi = centroids.max(0)
    ext = np.maximum(hi - lo, 1e-12)
    q = np.clip(((centroids - lo) / ext) * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x):
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    return (spread(q[:, 0]) << np.uint64(2)) | (spread(q[:, 1]) << np.uint64(1)) | spread(q[:, 2])


def triangle_coefficients(v0, v1, v2):
    """(N,3)x3 -> (N, 12) affine-barycentric coefficient rows."""
    e1 = v1 - v0
    e2 = v2 - v0
    n = np.cross(e1, e2)
    e2xn = np.cross(e2, n)
    e1xn = np.cross(e1, n)
    d1 = np.sum(e1 * e2xn, -1)
    d2 = np.sum(e2 * e1xn, -1)
    ok = (np.abs(d1) > 1e-30) & (np.abs(d2) > 1e-30)
    safe1 = np.where(ok, d1, 1.0)[:, None]
    safe2 = np.where(ok, d2, 1.0)[:, None]
    s1 = np.where(ok[:, None], e2xn / safe1, 0.0)
    s2 = np.where(ok[:, None], e1xn / safe2, 0.0)
    n = np.where(ok[:, None], n, 0.0)
    c1 = -np.sum(s1 * v0, -1)
    c2 = -np.sum(s2 * v0, -1)
    cw = -np.sum(n * v0, -1)
    out = np.concatenate(
        [s1, c1[:, None], s2, c2[:, None], n, cw[:, None]], axis=1)
    return out.astype(np.float32)


def build_tri_bvh(v0, v1, v2, mat, leaf_size: int = LEAF) -> TriBVH:
    """Build the packed LBVH. Inputs are (N,3)/(N,) numpy or jax arrays.

    leaf_size is fixed at 128 (the lane width); the parameter is kept for
    API compatibility and asserted.
    """
    assert leaf_size in (LEAF,), "packed BVH uses 128-triangle leaves"
    v0 = np.asarray(v0, np.float32)
    v1 = np.asarray(v1, np.float32)
    v2 = np.asarray(v2, np.float32)
    mat = np.asarray(mat, np.int32)
    n = v0.shape[0]
    assert n > 0, "empty triangle set"

    # native builder fast path (native/raytracer_native.cpp)
    from offline_raytracer_tpu.native import bvh_build_native
    native = bvh_build_native(v0, v1, v2, mat)
    if native is not None:
        child_rows, planes, tri_index, mat_out, p, m_occ = native
        return TriBVH(
            child_rows=jnp.asarray(child_rows), planes=jnp.asarray(planes),
            tri_index=jnp.asarray(tri_index), mat=jnp.asarray(mat_out),
            n_leaves=int(p), m_occ=int(m_occ))

    centroids = (v0 + v1 + v2) / 3.0
    order = np.argsort(morton_codes(centroids), kind="stable").astype(np.int32)

    m_occ = -(-n // LEAF)                       # occupied leaves
    p = 1 << max(0, (m_occ - 1).bit_length())   # heap leaf count (pow2)
    m_pad = -(-m_occ // 8) * 8                  # sublane-align the planes
    slots = m_occ * LEAF
    pad = slots - n

    def padv(a, fill):
        return np.concatenate([a[order], np.full((pad,) + a.shape[1:], fill, a.dtype)])

    pv0 = padv(v0, 0.0)
    pv1 = padv(v1, 0.0)
    pv2 = padv(v2, 0.0)
    pmat = np.concatenate([mat[order], np.zeros(pad, np.int32)])
    ptri = np.concatenate([order, np.full(pad, -1, np.int32)])

    coeff = triangle_coefficients(pv0, pv1, pv2)   # (slots, 12)
    # degenerate the padding rows so they can never hit (n = 0)
    coeff[n:] = 0.0
    planes = np.zeros((12, m_pad, LEAF), np.float32)
    planes[:, :m_occ, :] = coeff.reshape(m_occ, LEAF, 12).transpose(2, 0, 1)

    # per-leaf AABBs over real triangles only
    tmin = np.minimum(np.minimum(pv0, pv1), pv2).reshape(m_occ, LEAF, 3)
    tmax = np.maximum(np.maximum(pv0, pv1), pv2).reshape(m_occ, LEAF, 3)
    valid = (ptri >= 0).reshape(m_occ, LEAF, 1)
    leaf_min = np.where(valid, tmin, np.float32(np.inf)).min(1)
    leaf_max = np.where(valid, tmax, np.float32(-np.inf)).max(1)

    # heap AABBs: leaves at [p-1, 2p-2], empties inverted
    node_min = np.full((2 * p - 1, 3), np.inf, np.float32)
    node_max = np.full((2 * p - 1, 3), -np.inf, np.float32)
    node_min[p - 1 : p - 1 + m_occ] = leaf_min
    node_max[p - 1 : p - 1 + m_occ] = leaf_max
    level_start = p - 1
    while level_start > 0:
        parent_start = (level_start - 1) // 2
        n_parents = level_start - parent_start
        c = np.arange(2 * n_parents) + level_start
        node_min[parent_start:level_start] = node_min[c].reshape(n_parents, 2, 3).min(1)
        node_max[parent_start:level_start] = node_max[c].reshape(n_parents, 2, 3).max(1)
        level_start = parent_start

    # pack both children AABBs into the parent's row
    n_internal = max(p - 1, 1)
    child_rows = np.zeros((n_internal, LEAF), np.float32)
    if p > 1:
        i = np.arange(p - 1)
        child_rows[i, 0:3] = node_min[2 * i + 1]
        child_rows[i, 3:6] = node_max[2 * i + 1]
        child_rows[i, 6:9] = node_min[2 * i + 2]
        child_rows[i, 9:12] = node_max[2 * i + 2]
    else:
        # single-leaf tree: fabricate a root row whose child1 is the leaf
        child_rows[0, 0:3] = leaf_min[0]
        child_rows[0, 3:6] = leaf_max[0]
        child_rows[0, 6:9] = np.inf
        child_rows[0, 9:12] = -np.inf

    tri_index_full = np.concatenate(
        [ptri, np.full((m_pad - m_occ) * LEAF, -1, np.int32)])
    return TriBVH(
        child_rows=jnp.asarray(child_rows),
        planes=jnp.asarray(planes),
        tri_index=jnp.asarray(tri_index_full),
        mat=jnp.asarray(np.concatenate(
            [pmat, np.zeros((m_pad - m_occ) * LEAF, np.int32)])),
        n_leaves=int(p), m_occ=int(m_occ),
    )
