"""Pixel-wise gradient correctness vs central finite differences.

BASELINE.md gradient-correctness row: per-pixel ``jax.grad``/``jvp``
agreement with finite differences (not just means) for three parameter
classes — geometry (sphere center & radius), light emission, and mesh
vertex positions — on configs[0] (analytic) and configs[1] (letter).

Silhouette-bias caveat (SURVEY.md §7 hard part 2, documented in diff.py):
the detached-sampling estimator has no visibility/silhouette derivative,
and finite differences themselves are invalid at discontinuities (a hit
flipping between primitives between the two eps renders). Each test
therefore validates FD self-consistency first — pixels where FD at eps
and eps/2 disagree are discontinuity pixels, excluded from the
comparison and required to be a small minority. On the smooth majority,
per-pixel agreement is asserted tightly. Everything runs the brute-force
trace (use_bvh=False): the host-built BVH is not a traced function of
the vertex arrays, so FD through geometry must not consult it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from offline_raytracer_tpu.config import RenderConfig
from offline_raytracer_tpu.render import render_image_jnp

CFG = RenderConfig(width=12, height=12, spp=16, max_bounces=3,
                   enable_dof=False, use_bvh=False,
                   russian_roulette=1.0)

# Geometry parameters get the direct-lighting config: per-sample FD equals
# the detached-sampling gradient only when no contribution flows through a
# sampled continuation direction (wi is detached; FD sees it move with the
# surface normal — a term that vanishes in expectation, not per sample).
# Multi-bounce geometry gradients are validated at the mean level below.
# enable_mis=False selects the NEE-only estimator: the detached MIS weight
# is the one remaining stop_gradient a per-pixel FD would see move.
CFG1 = CFG.replace(max_bounces=1, enable_mis=False)


def pixelwise_check(f, p0, eps, smooth_min=0.7, rtol=0.02, atol=None):
    """Assert per-pixel agreement of jvp(f) with central FD on the pixels
    where FD is self-consistent (Richardson check between eps and eps/2).

    Returns (n_smooth, n_total) for reporting. f: scalar -> (H, W, 3)."""
    f = jax.jit(f)
    _, g = jax.jvp(f, (jnp.float32(p0),), (jnp.float32(1.0),))
    g = np.asarray(g)

    def fd(e):
        return (np.asarray(f(jnp.float32(p0 + e)))
                - np.asarray(f(jnp.float32(p0 - e)))) / (2 * e)

    fd1, fd2 = fd(eps), fd(eps / 2)
    scale = np.abs(fd2).max() + 1e-12
    if atol is None:
        atol = 2e-3 * scale
    smooth = np.abs(fd1 - fd2) <= atol + 0.05 * np.abs(fd2)
    frac = smooth.mean()
    assert frac >= smooth_min, f"only {frac:.0%} of pixels FD-consistent"
    np.testing.assert_allclose(g[smooth], fd2[smooth], rtol=rtol, atol=atol)
    assert np.abs(g[smooth]).max() > 0, "gradient identically zero"
    return int(smooth.sum()), g.size


def test_pixel_grad_sphere_center(analytic_scene):
    """configs[0]: d(image)/d(sphere center x) per pixel."""
    sc = analytic_scene

    def render(dx):
        center = sc.spheres.center.at[0, 0].add(dx)
        s = sc.replace(spheres=sc.spheres.replace(center=center))
        return render_image_jnp(s, CFG1)

    pixelwise_check(render, 0.0, eps=2e-3)


def test_pixel_grad_sphere_radius(analytic_scene):
    """configs[0]: d(image)/d(sphere radius) per pixel."""
    sc = analytic_scene

    def render(dr):
        radius = sc.spheres.radius.at[0].add(dr)
        s = sc.replace(spheres=sc.spheres.replace(radius=radius))
        return render_image_jnp(s, CFG1)

    pixelwise_check(render, 0.0, eps=2e-3)


def test_pixel_grad_light_emit(analytic_scene):
    """configs[0]: d(image)/d(emission scale) per pixel. The estimator is
    linear in emission along identical paths, so FD is near-exact and
    every pixel must be smooth."""
    sc = analytic_scene

    def render(s_emit):
        emit = sc.materials.emit * s_emit
        s = sc.replace(materials=sc.materials.replace(emit=emit))
        return render_image_jnp(s, CFG)

    n_smooth, n_total = pixelwise_check(
        render, 1.0, eps=0.05, smooth_min=0.999, rtol=5e-3)
    assert n_smooth == n_total


def test_pixel_grad_light_radius(analytic_scene):
    """configs[0]: d(image)/d(light sphere radius) — moves both the NEE
    sample pdf (1/area) and the emitter geometry."""
    sc = analytic_scene

    def render(dr):
        radius = sc.spheres.radius.at[1].add(dr)          # light sphere
        area = sc.lights.area.at[0].set(
            4.0 * jnp.pi * radius[1] ** 2)
        p0 = sc.lights.p0
        s = sc.replace(
            spheres=sc.spheres.replace(radius=radius),
            lights=sc.lights.replace(radius=sc.lights.radius.at[0].set(radius[1]),
                                     area=area, p0=p0))
        return render_image_jnp(s, CFG1)

    pixelwise_check(render, 0.0, eps=2e-3, smooth_min=0.6, rtol=0.05)


def test_mean_grad_sphere_center_multibounce(analytic_scene):
    """Multi-bounce geometry gradient at the MEAN level: the per-sample
    detached-sampling gradient and FD differ by a zero-expectation term
    (sampled-direction motion), so the image-mean comparison at moderate
    spp carries a loose tolerance — this documents the bias structure
    rather than hiding it."""
    sc = analytic_scene
    cfg = CFG.replace(spp=64, enable_mis=False)
    f = jax.jit(lambda dx: render_image_jnp(
        sc.replace(spheres=sc.spheres.replace(
            center=sc.spheres.center.at[0, 0].add(dx))), cfg))

    _, g = jax.jvp(f, (jnp.float32(0.0),), (jnp.float32(1.0),))
    g = np.asarray(g)
    eps = 2e-3

    def fd(e):
        return (np.asarray(f(jnp.float32(e)))
                - np.asarray(f(jnp.float32(-e)))) / (2 * e)

    fd1, fd2 = fd(eps), fd(eps / 2)
    # exclude silhouette pixels: the detached estimator has no visibility
    # derivative (documented bias) and FD is invalid at discontinuities
    smooth = np.abs(fd1 - fd2) <= 2e-3 * np.abs(fd2).max() + 0.05 * np.abs(fd2)
    assert smooth.mean() > 0.6
    scale = np.abs(fd2).max()
    assert np.abs(g[smooth]).max() > 0.05 * scale    # gradient is live
    # per-pixel residual = zero-mean sampled-direction-motion noise
    # (shrinks ~1/sqrt(spp)); bound its p95 at a small fraction of the
    # gradient scale rather than demanding per-pixel allclose
    p95 = np.percentile(np.abs(g - fd2)[smooth], 95)
    assert p95 < 0.015 * scale, (p95, scale)


def test_pixel_grad_mesh_vertices():
    """d(image)/d(mesh vertex translation) per pixel — gradients flow into
    raw triangle vertex positions through the differentiable hit refine.
    The generated blob mesh (1,280 faces) stands in front of the camera and
    moves along the view axis, so interior pixels change smoothly."""
    from offline_raytracer_tpu.models.scenes import blob
    from offline_raytracer_tpu.scene.build import SceneBuilder

    m = blob(12, 12, subdiv=3).triangles
    tris = np.stack([np.asarray(m.v0), np.asarray(m.v1), np.asarray(m.v2)], 1)
    v_up = tris.reshape(-1, 3) + np.array([0, 0, 0.9], np.float32)
    b = SceneBuilder()
    b.add_material(diffuse=(0.8, 0.2, 0.2))
    b.add_triangles(v_up, np.arange(v_up.shape[0]).reshape(-1, 3))
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-20, -20, -0.4), (20, 20, -0.2))
    b.add_light_material((10.0, 10.0, 10.0))
    b.add_sphere((0.0, -3.0, 5.0), 0.6)
    h = np.pi / 4
    b.set_camera((0.0, -6.0, 1.5), 0.4,
                 np.array([np.sin(h), 0, 0, np.cos(h)], np.float32))
    sc = b.build(12, 12)

    def render(dy):
        shift = jnp.array([0.0, dy, 0.0])
        tris = sc.triangles.replace(
            v0=sc.triangles.v0 + shift,
            v1=sc.triangles.v1 + shift,
            v2=sc.triangles.v2 + shift)
        s = sc.replace(triangles=tris, tri_bvh=None)
        return render_image_jnp(s, CFG1)

    pixelwise_check(render, 0.0, eps=2e-3, smooth_min=0.6, rtol=0.05)
