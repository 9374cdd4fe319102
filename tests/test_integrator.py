"""Integrator-level physics and determinism tests.

Covers what the reference never could (SURVEY.md §4): estimator
consistency (NEE+MIS vs BSDF-only must agree in expectation), bitwise
determinism under re-batching, golden images, mesh-light sampling, and
gradient descent through the renderer.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.render import render_block_jit, render_image, render_image_jnp

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

BASE = dict(width=24, height=24, max_bounces=5, enable_dof=False)


def test_nee_matches_bsdf_only(analytic_scene):
    """The two estimators integrate the same light transport."""
    img_nee = render_image(analytic_scene, RenderConfig(spp=192, **BASE))
    img_bsdf = render_image(
        analytic_scene, RenderConfig(spp=3072, enable_nee=False, **BASE))
    m1, m2 = img_nee.mean(), img_bsdf.mean()
    assert abs(m1 / m2 - 1.0) < 0.06, f"NEE {m1} vs BSDF-only {m2}"


def test_render_deterministic_and_batch_invariant(analytic_scene):
    cfg = RenderConfig(spp=4, **BASE)
    ids = jnp.arange(24 * 24, dtype=jnp.int32)
    a = np.asarray(render_block_jit(analytic_scene, cfg, ids, 0, 4))
    b = np.asarray(render_block_jit(analytic_scene, cfg, ids, 0, 4))
    np.testing.assert_array_equal(a, b)
    # per-ray keys: any partition of the pixel set gives identical values
    half1 = np.asarray(render_block_jit(analytic_scene, cfg, ids[: 288], 0, 4))
    half2 = np.asarray(render_block_jit(analytic_scene, cfg, ids[288:], 0, 4))
    np.testing.assert_allclose(np.concatenate([half1, half2]), a, rtol=1e-6)


def test_golden_analytic(analytic_scene):
    """Render vs stored golden (regenerate by deleting the .npy)."""
    cfg = RenderConfig(spp=16, seed=7, **BASE)
    img = render_image(analytic_scene, cfg)
    path = os.path.join(GOLDEN_DIR, "analytic_24x24_16spp.npy")
    if not os.path.exists(path):
        os.makedirs(GOLDEN_DIR, exist_ok=True)
        np.save(path, img)
        pytest.skip("golden regenerated")
    golden = np.load(path)
    np.testing.assert_allclose(img, golden, rtol=1e-4, atol=1e-6)


def test_emissive_mesh_nee():
    """A quad (2-triangle) area light must be NEE-sampleable and agree
    with BSDF-only sampling — the capability the reference lacks entirely
    (mesh lights fall through sample_random_lights, ray.cpp:581-588)."""
    from offline_raytracer_tpu.scene.build import SceneBuilder

    b = SceneBuilder()
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_light_material((6.0, 6.0, 6.0))
    quad = np.array([[-1, -1, 3.0], [1, -1, 3.0], [1, 1, 3.0], [-1, 1, 3.0]], np.float32)
    b.add_triangles(quad, np.array([[0, 2, 1], [0, 3, 2]]))  # faces down
    h = np.pi / 4
    b.set_camera((4.0, 0.0, 1.5), 0.4, [0.0, np.sin(h), 0.0, np.cos(h)])
    scene = b.build(16, 16)
    assert scene.n_lights == 1

    img_nee = render_image(scene, RenderConfig(
        spp=96, width=16, height=16, max_bounces=4,
        enable_dof=False))
    img_bsdf = render_image(scene, RenderConfig(
        spp=3072, width=16, height=16, max_bounces=4,
        enable_dof=False, enable_nee=False))
    assert img_nee.mean() > 0.005
    assert abs(img_nee.mean() / img_bsdf.mean() - 1.0) < 0.12


def test_two_mesh_lights_nee():
    """NEE with >1 mesh light exercises the globally monotone CDF (a
    concatenation of per-light-normalized CDFs is non-monotone — the
    round-1 bug VERDICT weak #3): two differently-sized quad lights,
    NEE vs BSDF-only must agree in expectation."""
    from offline_raytracer_tpu.scene.build import SceneBuilder

    b = SceneBuilder()
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_light_material((6.0, 6.0, 6.0))
    quad = np.array([[-1.5, -1, 3.0], [-0.2, -1, 3.0], [-0.2, 1, 3.0],
                     [-1.5, 1, 3.0]], np.float32)
    b.add_triangles(quad, np.array([[0, 2, 1], [0, 3, 2]]))  # faces down
    b.add_light_material((3.0, 9.0, 3.0))
    quad2 = np.array([[0.6, -0.4, 2.2], [1.4, -0.4, 2.2], [1.4, 0.4, 2.2],
                      [0.6, 0.4, 2.2]], np.float32)
    b.add_triangles(quad2, np.array([[0, 2, 1], [0, 3, 2]]))
    h = np.pi / 4
    b.set_camera((4.0, 0.0, 1.5), 0.4, [0.0, np.sin(h), 0.0, np.cos(h)])
    scene = b.build(16, 16)
    assert scene.n_lights == 2
    assert np.all(np.diff(np.asarray(scene.lights.em_cdf)) > 0), \
        "em_cdf must be globally monotone"

    kw = dict(width=16, height=16, max_bounces=4, enable_dof=False)
    img_nee = render_image(scene, RenderConfig(spp=128, **kw))
    img_bsdf = render_image(scene, RenderConfig(spp=4096, enable_nee=False, **kw))
    assert img_nee.mean() > 0.005
    # per-channel agreement catches a biased pick between the two colors
    for c in range(3):
        m1, m2 = img_nee[..., c].mean(), img_bsdf[..., c].mean()
        assert abs(m1 / m2 - 1.0) < 0.15, f"channel {c}: NEE {m1} vs BSDF {m2}"


def test_emissive_box_is_nee_sampled():
    """Emissive boxes register as mesh lights (12 sampling triangles) —
    round 1 silently dropped them from NEE (VERDICT weak #6)."""
    from offline_raytracer_tpu.scene.build import SceneBuilder

    b = SceneBuilder()
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_light_material((5.0, 5.0, 5.0))
    b.add_box((-0.5, -0.5, 2.5), (1.0, 1.0, 0.4))
    h = np.pi / 4
    b.set_camera((4.0, 0.0, 1.5), 0.4, [0.0, np.sin(h), 0.0, np.cos(h)])
    scene = b.build(16, 16)
    assert scene.n_lights == 1
    assert float(scene.lights.area[0]) == pytest.approx(2 * 1 + 4 * 0.4, rel=1e-5)

    kw = dict(width=16, height=16, max_bounces=4, enable_dof=False)
    img_nee = render_image(scene, RenderConfig(spp=96, **kw))
    img_bsdf = render_image(scene, RenderConfig(spp=3072, enable_nee=False, **kw))
    assert img_nee.mean() > 0.005
    assert abs(img_nee.mean() / img_bsdf.mean() - 1.0) < 0.12


def test_gradients_match_finite_difference(analytic_scene):
    """d(mean image)/d(albedo) vs central finite differences —
    BASELINE.json gradient-correctness criterion on configs[0]."""
    cfg = RenderConfig(spp=24, width=12, height=12, max_bounces=3,
                       enable_dof=False)

    def mean_img(kd_scale):
        sc = analytic_scene.replace(
            materials=analytic_scene.materials.replace(
                diffuse=analytic_scene.materials.diffuse * kd_scale))
        return jnp.mean(render_image_jnp(sc, cfg))

    g = float(jax.grad(mean_img)(jnp.float32(1.0)))
    eps = 0.05
    fd = (float(mean_img(jnp.float32(1 + eps)))
          - float(mean_img(jnp.float32(1 - eps)))) / (2 * eps)
    assert np.isfinite(g)
    # detached-sampling grads are exact for albedo scaling (same paths)
    np.testing.assert_allclose(g, fd, rtol=0.08)


def test_inverse_rendering_converges(analytic_scene):
    """A few Adam steps on the albedo must reduce the image loss
    (BASELINE configs[4] capability, miniature)."""
    from offline_raytracer_tpu.diff import (
        apply_material_params, material_params, optimize)

    cfg = RenderConfig(spp=8, width=12, height=12, max_bounces=3,
                       enable_dof=False)
    ids = jnp.arange(12 * 12, dtype=jnp.int32)
    target = render_block_jit(analytic_scene, cfg, ids, 0, 8)

    # corrupt the sphere albedo, then recover
    wrong = analytic_scene.materials.diffuse.at[1].set(
        jnp.array([0.1, 0.8, 0.8]))
    scene0 = analytic_scene.replace(
        materials=analytic_scene.materials.replace(diffuse=wrong))
    params = material_params(scene0)
    params, losses = optimize(
        scene0, cfg, target, ids, params, steps=12, lr=0.1)
    assert losses[-1] < losses[0] * 0.55, losses
    # recovered albedo moved toward the truth
    rec = np.asarray(params["diffuse"][1])
    truth = np.asarray(analytic_scene.materials.diffuse[1])
    assert np.abs(rec - truth).mean() < np.abs(
        np.array([0.1, 0.8, 0.8]) - truth).mean()
