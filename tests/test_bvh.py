import jax
import jax.numpy as jnp
import numpy as np
import pytest

from offline_raytracer_tpu.ops.bvh import LEAF, build_tri_bvh, morton_codes, triangle_coefficients
from offline_raytracer_tpu.ops.intersect import triangle_ts
from offline_raytracer_tpu.ops.traverse import bvh_hit_ts
from offline_raytracer_tpu.scene.types import Triangles


def _random_tris(n, seed=0, spread=4.0):
    rs = np.random.RandomState(seed)
    c = rs.uniform(-spread, spread, (n, 3)).astype(np.float32)
    a = rs.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    b = rs.uniform(-0.3, 0.3, (n, 3)).astype(np.float32)
    return c, c + a, c + b


def test_morton_order_locality():
    pts = np.array([[0, 0, 0], [0.01, 0, 0], [10, 10, 10]], np.float32)
    m = morton_codes(pts)
    assert m[0] <= m[1] <= m[2] or m[1] <= m[0] <= m[2]


def test_triangle_coefficients_roundtrip():
    """The affine encoding must reproduce Möller-Trumbore's (t, u, v)."""
    v0, v1, v2 = _random_tris(64, seed=3)
    co = triangle_coefficients(v0, v1, v2)
    rs = np.random.RandomState(4)
    o = rs.uniform(-6, 6, (64, 3)).astype(np.float32)
    d = rs.randn(64, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    s1, c1 = co[:, 0:3], co[:, 3]
    s2, c2 = co[:, 4:7], co[:, 7]
    nn, cw = co[:, 8:11], co[:, 11]
    d_w = np.sum(nn * d, -1)
    t = -(np.sum(nn * o, -1) + cw) / np.where(np.abs(d_w) > 1e-12, d_w, 1.0)
    p = o + t[:, None] * d
    u = np.sum(s1 * p, -1) + c1
    v = np.sum(s2 * p, -1) + c2
    # cross-check against barycentric solve
    for i in range(0, 64, 7):
        A = np.stack([v1[i] - v0[i], v2[i] - v0[i]], 1)
        uv, *_ = np.linalg.lstsq(A, p[i] - v0[i], rcond=None)
        np.testing.assert_allclose([u[i], v[i]], uv, atol=2e-2)


def test_bvh_build_shapes():
    v0, v1, v2 = _random_tris(300)
    bvh = build_tri_bvh(v0, v1, v2, np.ones(300, np.int32))
    P = bvh.n_leaves
    assert bvh.m_occ == 3 and P == 4
    assert bvh.child_rows.shape == (3, 128)
    assert bvh.planes.shape[0] == 12 and bvh.planes.shape[2] == LEAF
    # root row children cover everything
    allv = np.concatenate([v0, v1, v2])
    row = np.asarray(bvh.child_rows[0])
    lo = np.minimum(row[0:3], row[6:9])
    hi = np.maximum(row[3:6], row[9:12])
    assert (lo <= allv.min(0) + 1e-5).all()
    assert (hi >= allv.max(0) - 1e-5).all()
    # every real triangle appears exactly once
    idx = np.asarray(bvh.tri_index)
    assert sorted(idx[idx >= 0].tolist()) == list(range(300))


@pytest.mark.parametrize("n_tris", [37, 700])
def test_bvh_matches_bruteforce(n_tris):
    v0, v1, v2 = _random_tris(n_tris, seed=n_tris)
    mat = np.arange(n_tris, dtype=np.int32) % 5
    bvh = build_tri_bvh(v0, v1, v2, mat)

    rs = np.random.RandomState(1)
    R = 256
    ro = rs.uniform(-6, 6, (R, 3)).astype(np.float32)
    rd = rs.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    tris = Triangles(v0=jnp.asarray(v0), v1=jnp.asarray(v1), v2=jnp.asarray(v2),
                     mat=jnp.asarray(mat))

    @jax.jit
    def both(ro, rd):
        t_bf = triangle_ts(tris, ro, rd, 1e-6).min(-1)
        t_bvh, slot = bvh_hit_ts(bvh, ro, rd, 1e-6)
        return t_bf, t_bvh, slot

    t_bf, t_bvh, slot = both(jnp.asarray(ro), jnp.asarray(rd))
    t_bf, t_bvh = np.asarray(t_bf), np.asarray(t_bvh)
    hit_bf = np.isfinite(t_bf)
    hit_bvh = np.isfinite(t_bvh) & (np.asarray(slot) >= 0)
    np.testing.assert_array_equal(hit_bf, hit_bvh)
    np.testing.assert_allclose(t_bvh[hit_bvh], t_bf[hit_bf], rtol=2e-3, atol=1e-4)
    # winning slot maps to a real triangle
    tri_ids = np.asarray(bvh.tri_index)[np.asarray(slot)[hit_bvh]]
    assert (tri_ids >= 0).all()


def test_bvh_bunny_sanity():
    """A closed mesh at the bunny's scale (the generated blob, 20,480
    faces): rays from inside toward a ring of surface points all hit."""
    from offline_raytracer_tpu.models.scenes import icosphere

    u, f = icosphere(5)
    v = (u * 0.6).astype(np.float32)
    v0, v1, v2 = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    bvh = build_tri_bvh(v0, v1, v2, np.zeros(len(f), np.int32))
    assert bvh.m_occ == -(-len(f) // LEAF)

    # rays from a ring around the center, outward: all hit at ~0.6 - 0.1
    center = v.mean(0)
    R = 64
    ang = np.linspace(0, 2 * np.pi, R, endpoint=False)
    ro = np.stack([center[0] + 0.1 * np.cos(ang),
                   center[1] + 0.1 * np.sin(ang),
                   np.full(R, center[2])], 1).astype(np.float32)
    rd = (ro - center[None]).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)

    t, slot = jax.jit(lambda a, b: bvh_hit_ts(bvh, a, b, 1e-6))(
        jnp.asarray(ro), jnp.asarray(rd))
    t = np.asarray(t)
    assert np.isfinite(t).all(), f"{np.isfinite(t).sum()}/{R} rays hit"
    np.testing.assert_allclose(t, 0.5, atol=2e-3)


def test_any_hit_occlusion_matches_closest():
    """Seeded any-hit traversal agrees with closest-hit occlusion, and
    dead lanes (t_far <= t_min) never report a hit."""
    v0, v1, v2 = _random_tris(300, seed=4)
    bvh = build_tri_bvh(v0, v1, v2, np.zeros(300, np.int32))
    rs = np.random.RandomState(5)
    R = 256
    ro = rs.uniform(-6, 6, (R, 3)).astype(np.float32)
    rd = rs.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    t_far = rs.uniform(0.5, 12.0, (R,)).astype(np.float32)
    t_far[::7] = 0.0  # parked lanes
    ro, rd, t_far = jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(t_far)

    t_ref, s_ref = jax.jit(lambda a, b: bvh_hit_ts(bvh, a, b, 1e-6))(ro, rd)
    occ_ref = np.isfinite(np.asarray(t_ref)) & (np.asarray(t_ref) < np.asarray(t_far))

    _, s_any = jax.jit(
        lambda a, b, tf: bvh_hit_ts(bvh, a, b, 1e-6, tf, any_hit=True)
    )(ro, rd, t_far)
    occ_any = np.asarray(s_any) >= 0

    np.testing.assert_array_equal(occ_any, occ_ref)
    assert not occ_any[::7].any()


def test_sorted_trace_matches_unsorted(blob_small):
    """Coherence sorting is a pure permutation: identical hits."""
    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.ops.traverse import make_bvh_trace_fn

    scene = blob_small
    rs = np.random.RandomState(7)
    R = 512
    ro = rs.uniform(-2, 2, (R, 3)).astype(np.float32)
    rd = rs.randn(R, 3).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    ro, rd = jnp.asarray(ro), jnp.asarray(rd)

    base = dict(width=32, height=32)
    h_sorted = jax.jit(make_bvh_trace_fn(scene, RenderConfig(**base, sort_rays=True)))(ro, rd)
    h_plain = jax.jit(make_bvh_trace_fn(scene, RenderConfig(**base, sort_rays=False)))(ro, rd)
    np.testing.assert_array_equal(np.asarray(h_sorted.valid), np.asarray(h_plain.valid))
    np.testing.assert_allclose(np.asarray(h_sorted.t)[np.asarray(h_sorted.valid)],
                               np.asarray(h_plain.t)[np.asarray(h_plain.valid)],
                               rtol=1e-5)

    assert np.asarray(h_plain.valid).mean() > 0.2     # the mesh is in view


def _agree(a, b, n_flip_max):
    """Two renders of the same paths: a winner flip at a triangle edge
    (BVH coefficient test vs Moller-Trumbore) moves one pixel a lot, so
    bound the number of diverging pixels and the mean."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-2)
    assert (rel > 1e-2).any(-1).sum() <= n_flip_max
    assert abs(a.mean() - b.mean()) <= 2e-3 * max(b.mean(), 1e-3)


@pytest.mark.parametrize("scene_name,n_rays", [
    ("shaped", 1280), ("blob", 1280), ("blob", 200)])
def test_bvh_render_matches_bruteforce(scene_name, n_rays):
    """The BVH route (packet walk + any-hit shadow rays) renders the same
    paths as the brute-force sweep on the same threefry draws: the analytic
    scene with every light kind and glass, the mesh, and a small ray batch
    (fewer rays than one traversal tile of the coherence sort)."""
    from offline_raytracer_tpu.config import RenderConfig
    from offline_raytracer_tpu.models import scenes
    from offline_raytracer_tpu.render import render_block_stats_jit

    kw = {"subdiv": 3} if scene_name == "blob" else {}
    scene = scenes.BY_NAME[scene_name](48, 48, **kw)
    cfg = RenderConfig(width=48, height=48, spp=1, max_bounces=4,
                       enable_dof=False)
    ids = jnp.arange(n_rays, dtype=jnp.int32) % (48 * 48)
    out = {}
    for use_bvh in (True, False):
        out[use_bvh] = render_block_stats_jit(
            scene, cfg.replace(use_bvh=use_bvh), ids, 0, 2)
    (img_b, alive_b), (img_f, alive_f) = out[True], out[False]
    assert np.isfinite(np.asarray(img_b)).all()
    assert float(np.asarray(img_b).mean()) > 0
    _agree(img_b, img_f, n_flip_max=max(1, n_rays // 200))
    # per-bounce alive counts are integers: equal up to the flipped paths
    np.testing.assert_allclose(np.asarray(alive_b), np.asarray(alive_f),
                               atol=max(1, n_rays // 200))

