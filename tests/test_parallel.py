"""Multi-device tests on the virtual 8-device CPU mesh (SURVEY.md §4d):
shard-invariance (1 device vs 8 devices bitwise) and sharded gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.parallel.shard import (
    grad_step_sharded, make_mesh, render_block_sharded)
from offline_raytracer_tpu.render import render_block_jit


@pytest.fixture(autouse=True)
def eight_devices():
    """Decided per test, not at import: every xdist worker must collect
    the same tests (conftest.py asks for 8 virtual CPU devices)."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


CFG = RenderConfig(width=16, height=16, spp=2, max_bounces=3,
                   enable_dof=False)


def test_shard_invariance(analytic_scene):
    """Same image regardless of device count — the determinism contract
    of the counter-based RNG (utils/rng.py)."""
    scene = analytic_scene
    ids = jnp.arange(256, dtype=jnp.int32)

    single = render_block_jit(scene, CFG, ids, 0, CFG.spp)
    mesh8 = make_mesh(jax.devices()[:8])
    sharded = render_block_sharded(scene, CFG, mesh8, ids, 0, CFG.spp)
    np.testing.assert_allclose(
        np.asarray(single), np.asarray(sharded), rtol=1e-5, atol=1e-6)

    mesh2 = make_mesh(jax.devices()[:2])
    sharded2 = render_block_sharded(scene, CFG, mesh2, ids, 0, CFG.spp)
    np.testing.assert_allclose(
        np.asarray(sharded2), np.asarray(sharded), rtol=1e-5, atol=1e-6)


def test_sharded_grad_step(analytic_scene):
    scene = analytic_scene
    ids = jnp.arange(256, dtype=jnp.int32)
    mesh = make_mesh(jax.devices()[:8])
    target = jnp.zeros((256, 3))

    def getter(sc):
        return {"diffuse": sc.materials.diffuse}

    def setter(sc, p):
        return sc.replace(materials=sc.materials.replace(diffuse=p["diffuse"]))

    loss, grads = grad_step_sharded(scene, CFG, mesh, ids, target, getter, setter)
    assert np.isfinite(float(loss)) and float(loss) > 0
    g = np.asarray(grads["diffuse"])
    assert np.isfinite(g).all()
    assert np.abs(g).sum() > 0

    # gradients must match the unsharded computation
    def loss_unsharded(diffuse):
        sc = setter(scene, {"diffuse": diffuse})
        img = render_block_jit(sc, CFG, ids, 0, CFG.spp)
        return jnp.sum((img - target) ** 2) / (ids.shape[0] * 3)

    g_ref = np.asarray(jax.grad(loss_unsharded)(scene.materials.diffuse))
    np.testing.assert_allclose(g, g_ref, rtol=1e-4, atol=1e-7)


def test_dryrun_multichip_entrypoint():
    import os
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_ring_geometry_matches_replicated():
    """Geometry-sharded ring rendering == replicated rendering.

    The blob mesh's BVH is split over 8 shards (1/8 of the planes per
    device); ray blocks ppermute around the ring accumulating min-t. The
    image must match the replicated-BVH render.
    """
    from offline_raytracer_tpu.models.scenes import blob
    from offline_raytracer_tpu.parallel.ring import render_block_ring

    scene = blob(16, 16, subdiv=4)
    cfg = RenderConfig(width=16, height=16, spp=2, max_bounces=3,
                       enable_dof=False)
    ids = jnp.arange(256, dtype=jnp.int32)

    mesh = make_mesh(jax.devices()[:8])
    ring = render_block_ring(scene, cfg, mesh, ids, 0, cfg.spp)
    rep = render_block_jit(scene, cfg, ids, 0, cfg.spp)
    assert np.isfinite(np.asarray(ring)).all()
    np.testing.assert_allclose(
        np.asarray(ring), np.asarray(rep), rtol=1e-4, atol=1e-5)


def test_ring_occlusion_matches_replicated():
    """Any-hit occlusion ring == replicated occlusion on blob shadow rays.

    The ring NEE path must resolve visibility with n_dev early-exit any-hit
    steps (make_ring_occlusion_fn), not n_dev closest-hit rotations."""
    from jax.sharding import PartitionSpec as P

    from offline_raytracer_tpu.models.scenes import blob
    from offline_raytracer_tpu.ops.traverse import make_bvh_occlusion_fn
    from offline_raytracer_tpu.parallel.ring import (
        _local_bvh, build_bvh_shards, make_ring_occlusion_fn)
    from offline_raytracer_tpu.parallel.shard import RAY_AXIS, shard_map

    scene = blob(16, 16, subdiv=4)
    cfg = RenderConfig(width=16, height=16, spp=1, max_bounces=2,
                       enable_dof=False)
    n_dev = 8
    mesh = make_mesh(jax.devices()[:n_dev])
    child_rows, planes, tri_index, p, m = build_bvh_shards(
        np.asarray(scene.triangles.v0), np.asarray(scene.triangles.v1),
        np.asarray(scene.triangles.v2), n_dev)

    # shadow-ray-shaped queries: from points near the floor toward the light
    rs = np.random.RandomState(0)
    R = 256
    ro = jnp.asarray(rs.uniform(-1, 1, (R, 3)).astype(np.float32)
                     * np.array([2, 2, 0.5], np.float32))
    to_light = np.array([0.0, -3.0, 6.0], np.float32) - np.asarray(ro)
    dist = np.linalg.norm(to_light, axis=-1)
    rd = jnp.asarray(to_light / dist[:, None])
    t_far = jnp.asarray(dist.astype(np.float32))

    ref_occ = make_bvh_occlusion_fn(scene, cfg)(ro, rd, t_far)

    scene_rep = scene.replace(tri_bvh=None)

    def local(scene_rep, cr, pl, ti, ro_s, rd_s, tf_s):
        bvh_local = _local_bvh(cr[0], pl[0], ti[0], p, m)
        occl = make_ring_occlusion_fn(scene_rep, cfg, bvh_local, n_dev)
        return occl(ro_s, rd_s, tf_s)

    fn = shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS),
                  P(RAY_AXIS), P(RAY_AXIS), P(RAY_AXIS)),
        out_specs=P(RAY_AXIS), check_vma=False)
    ring_occ = jax.jit(fn)(scene_rep, child_rows, planes, tri_index,
                           ro, rd, t_far)

    np.testing.assert_array_equal(np.asarray(ring_occ), np.asarray(ref_occ))
    assert 0 < int(np.asarray(ref_occ).sum()) < R   # nondegenerate query set


def test_bvh_shards_cover_all_triangles():
    from offline_raytracer_tpu.models.scenes import blob
    from offline_raytracer_tpu.parallel.ring import build_bvh_shards

    scene = blob(16, 16, subdiv=4)
    v0 = np.asarray(scene.triangles.v0)
    cr, pl, ti, p, m = build_bvh_shards(
        v0, np.asarray(scene.triangles.v1), np.asarray(scene.triangles.v2), 8)
    assert cr.shape[0] == 8 and pl.shape[0] == 8
    ids = np.asarray(ti)
    covered = np.unique(ids[ids >= 0])
    assert covered.size == v0.shape[0]          # every triangle in some shard
