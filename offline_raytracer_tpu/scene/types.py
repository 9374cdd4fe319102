"""Scene representation: structure-of-arrays pytrees.

Replaces the reference's array-of-structs World (ray.h:51-88: Material[],
Sphere[], AAB[], Cylinder[], Mesh[] with per-shape mat_index) with flat SoA
device arrays so every op is batched over the primitive axis. All pytrees
are frozen dataclasses registered as pytrees (utils/pytree.py):
jit/vmap/grad-transparent.

Material semantics follow parser.cpp:1270-1309 (brdf token: diffuse rgb,
specular rgb + int exponent, optional transmission rgb + ior) and
parser.cpp:1236-1248 (light token: emissive material).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from offline_raytracer_tpu.utils import pytree


@pytree.dataclass
class Materials:
    diffuse: jnp.ndarray       # (M, 3) Kd
    specular: jnp.ndarray      # (M, 3) Ks
    spec_exp: jnp.ndarray      # (M,)   Phong-style exponent from .scn (unused
    #                            by the reference shader, kept for parity)
    transmission: jnp.ndarray  # (M, 3) Kt
    ior: jnp.ndarray           # (M,)
    emit: jnp.ndarray          # (M, 3) emission (lights)
    is_light: jnp.ndarray      # (M,)   bool


@pytree.dataclass
class Spheres:
    center: jnp.ndarray  # (N, 3)
    radius: jnp.ndarray  # (N,)
    mat: jnp.ndarray     # (N,) int32


@pytree.dataclass
class Boxes:
    bmin: jnp.ndarray  # (N, 3)
    bmax: jnp.ndarray  # (N, 3)
    mat: jnp.ndarray   # (N,) int32


@pytree.dataclass
class Cylinders:
    base: jnp.ndarray    # (N, 3)
    axis: jnp.ndarray    # (N, 3) non-unit: |axis| = height
    radius: jnp.ndarray  # (N,)
    rot: jnp.ndarray     # (N, 3, 3) world->cylinder-local rotation (axis -> +Z)
    mat: jnp.ndarray     # (N,) int32


@pytree.dataclass
class Triangles:
    v0: jnp.ndarray   # (N, 3)
    v1: jnp.ndarray   # (N, 3)
    v2: jnp.ndarray   # (N, 3)
    mat: jnp.ndarray  # (N,) int32


# NEE light table: every emissive shape (sphere / cylinder / mesh) is
# sampleable — see ops/lights.py AreaLights. (The reference's table only
# ever samples spheres, ray.cpp:554-595.)


@pytree.dataclass
class Camera:
    """Pinhole/thin-lens camera (ray.h:42-49, macos_main.mm:550-556).

    Axes are pre-scaled: x_axis includes height_ratio*aspect, y_axis includes
    height_ratio; z_axis is the unit backward vector. Pixel (px, py) in
    [-1, 1] NDC maps to direction px*x_axis + py*y_axis - z_axis.
    """

    p: jnp.ndarray       # (3,)
    x_axis: jnp.ndarray  # (3,)
    y_axis: jnp.ndarray  # (3,)
    z_axis: jnp.ndarray  # (3,)


@pytree.dataclass
class Scene:
    materials: Materials
    spheres: Spheres
    boxes: Boxes
    cylinders: Cylinders
    triangles: Triangles
    lights: object            # ops.lights.AreaLights
    camera: Camera
    ambient: jnp.ndarray       # (3,)
    mat_to_light: jnp.ndarray  # (M,) int32: sphere-light index or -1 —
    #                            lookup for the MIS pdf on BSDF light hits
    tri_bvh: object = None     # TriBVH (ops/bvh.py) or None; built host-side
    #                            once at scene construction. Search-only —
    #                            gradients flow through scene.triangles.

    @property
    def n_lights(self) -> int:
        return self.lights.kind.shape[0]


def _f32(x):
    return jnp.asarray(np.asarray(x, np.float32))


def _i32(x):
    return jnp.asarray(np.asarray(x, np.int32))


def make_materials(diffuse, specular, spec_exp, transmission, ior, emit, is_light) -> Materials:
    return Materials(
        diffuse=_f32(diffuse).reshape(-1, 3),
        specular=_f32(specular).reshape(-1, 3),
        spec_exp=_f32(spec_exp).reshape(-1),
        transmission=_f32(transmission).reshape(-1, 3),
        ior=_f32(ior).reshape(-1),
        emit=_f32(emit).reshape(-1, 3),
        is_light=jnp.asarray(np.asarray(is_light, bool)).reshape(-1),
    )


def empty_spheres() -> Spheres:
    return Spheres(center=jnp.zeros((0, 3)), radius=jnp.zeros((0,)), mat=jnp.zeros((0,), jnp.int32))


def empty_boxes() -> Boxes:
    return Boxes(bmin=jnp.zeros((0, 3)), bmax=jnp.zeros((0, 3)), mat=jnp.zeros((0,), jnp.int32))


def empty_cylinders() -> Cylinders:
    return Cylinders(
        base=jnp.zeros((0, 3)), axis=jnp.zeros((0, 3)), radius=jnp.zeros((0,)),
        rot=jnp.zeros((0, 3, 3)), mat=jnp.zeros((0,), jnp.int32),
    )


def empty_triangles() -> Triangles:
    return Triangles(
        v0=jnp.zeros((0, 3)), v1=jnp.zeros((0, 3)), v2=jnp.zeros((0, 3)),
        mat=jnp.zeros((0,), jnp.int32),
    )


def empty_lights():
    from offline_raytracer_tpu.ops.lights import empty_area_lights
    return empty_area_lights()
