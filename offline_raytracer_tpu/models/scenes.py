"""Canonical scene presets — the benchmark "model zoo".

One constructor per BASELINE.json config so tests, benchmarks and the CLI
share identical scenes:

  configs[0] analytic()    sphere + plane + sphere light (grad reference)
  configs[1] letter()      letterX/letterY.ply meshes, diffuse, BVH
  configs[2] bunny()       bunny.ply + floor + area light + NEE
  configs[3] dwarf()       dwarf.obj with DOF + shaped lights
  configs[4] testscene()   full .scn multi-object scene

letter/bunny/dwarf/testscene read the reference's data files from
``data_dir`` or the ``RAYTRACER_REF_DATA`` directory. Two generated presets
stand in for them where those files are absent, and need nothing on disk:

  blob()      seeded displaced icosphere at the bunny's scale (81,920
              faces at subdiv=6) in the bunny's floor/light/camera setup
  shaped()    cylinders, a box light, a cylinder light and a glass sphere
              (the testscene's feature mix) at analytic-primitive cost
"""

from __future__ import annotations

import os

import numpy as np

from offline_raytracer_tpu.scene.build import SceneBuilder
from offline_raytracer_tpu.scene.obj import load_obj
from offline_raytracer_tpu.scene.ply import load_ply
from offline_raytracer_tpu.scene.scn import load_scene


def _data(data_dir, name: str) -> str:
    """Path of a reference data file; raises if no directory is known."""
    d = data_dir or os.environ.get("RAYTRACER_REF_DATA")
    if not d:
        raise FileNotFoundError(
            f"{name}: pass data_dir or set RAYTRACER_REF_DATA to the "
            f"reference data directory")
    return os.path.join(d, name)


def _lookat_quat_y(angle=np.pi / 2):
    """Quaternion (xyzw) rotating the default camera frame about +Y."""
    h = angle / 2
    return np.array([0.0, np.sin(h), 0.0, np.cos(h)], np.float32)


def analytic(width=256, height=256):
    """BASELINE configs[0]: single sphere + plane, one sphere light."""
    b = SceneBuilder()
    b.add_material(diffuse=(0.7, 0.3, 0.2))
    b.add_sphere((0.0, 0.0, 1.0), 0.8)
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_box_minmax((-20, -20, -0.2), (20, 20, 0.0))
    b.add_light_material((8.0, 8.0, 8.0))
    b.add_sphere((2.0, -2.0, 4.0), 0.5)
    b.set_camera((4.0, 0.0, 1.5), 0.4, _lookat_quat_y())
    return b.build(width, height)


def letter(width=256, height=256, data_dir=None):
    """BASELINE configs[1]: letterX + letterY plies, diffuse."""
    b = SceneBuilder()
    vx, fx = load_ply(_data(data_dir, "letterX.ply"))
    vy, fy = load_ply(_data(data_dir, "letterY.ply"))
    b.add_material(diffuse=(0.8, 0.2, 0.2))
    b.add_triangles(vx + np.array([-1.2, 0, 1.5], np.float32), fx)
    b.add_material(diffuse=(0.2, 0.2, 0.8))
    b.add_triangles(vy + np.array([1.2, 0, 1.5], np.float32), fy)
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-20, -20, -0.4), (20, 20, -0.2))
    b.add_light_material((10.0, 10.0, 10.0))
    b.add_sphere((0.0, -3.0, 5.0), 0.6)
    b.set_camera((0.0, -6.0, 1.5), 0.4,
                 np.array([np.sin(np.pi / 4), 0, 0, np.cos(np.pi / 4)], np.float32))
    return b.build(width, height)


def bunny(width=512, height=512, data_dir=None, leaf_size=128):
    """BASELINE configs[2]: bunny + floor + area light (NEE exercised)."""
    v, f = load_ply(_data(data_dir, "bunny.ply"))
    v = (v - v.mean(0)) * 8.0
    v[:, 2] -= v[:, 2].min()
    b = SceneBuilder()
    b.add_material(diffuse=(0.6, 0.5, 0.4), specular=(0.3, 0.3, 0.3), spec_exp=50)
    b.add_triangles(v, f)
    b.add_material(diffuse=(0.4, 0.4, 0.45))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_light_material((10.0, 10.0, 10.0))
    b.add_sphere((1.5, -1.5, 3.0), 0.4)
    b.set_camera((2.5, 0.0, 0.8), 0.4, _lookat_quat_y())
    return b.build(width, height, bvh_leaf_size=leaf_size)


def dwarf(width=512, height=512, data_dir=None):
    """BASELINE configs[3]: dwarf.obj, depth of field, shaped lights."""
    o = load_obj(_data(data_dir, "dwarf.obj"))
    v = o["positions"].copy()
    v = (v - v.mean(0)) * 0.02
    # obj is y-up; scene is z-up: proper rotation (x, -z, y) keeps the
    # model upright AND right-handed (the old axis swap mirrored it onto
    # its back — the r4 dwarf golden caught it)
    y = v[:, 1].copy()
    v[:, 1] = -v[:, 2]
    v[:, 2] = y
    v[:, 2] -= v[:, 2].min()
    b = SceneBuilder()
    b.add_material(diffuse=(0.7, 0.55, 0.35), specular=(0.2, 0.2, 0.2), spec_exp=30)
    b.add_triangles(v, o["indices"])
    b.add_material(diffuse=(0.45, 0.45, 0.5))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_light_material((12.0, 11.0, 9.0))
    b.add_sphere((1.5, -1.5, 2.5), 0.35)
    b.add_light_material((3.0, 3.5, 5.0))
    b.add_sphere((-1.5, 1.5, 3.0), 0.5)
    # camera on +X looking at the origin with IMAGE-up = world +Z: the
    # cyclic axis permutation x->y->z->x, i.e. 120 deg about (1,1,1)
    b.set_camera((2.6, 0.0, 0.9), 0.4,
                 np.array([0.5, 0.5, 0.5, 0.5], np.float32))
    return b.build(width, height)


def testscene(width=None, height=None, data_dir=None):
    """BASELINE configs[4]: the reference's full testscene.scn."""
    scene, (w, h) = load_scene(_data(data_dir, "testscene.scn"), width, height)
    return scene


def icosphere(subdiv: int):
    """Unit icosphere: (V, 3) float64 vertices, (20 * 4**subdiv, 3) int32
    faces, counter-clockwise seen from outside."""
    t = (1.0 + 5.0 ** 0.5) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
                  [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
                  [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    f = np.array([[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
                  [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
                  [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
                  [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]],
                 np.int64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    for _ in range(subdiv):
        # one midpoint per undirected edge, shared by both faces
        e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
        key = np.minimum(e[:, 0], e[:, 1]) * len(v) + np.maximum(e[:, 0], e[:, 1])
        uniq, inv = np.unique(key, return_inverse=True)
        mid = v[uniq // len(v)] + v[uniq % len(v)]
        mid /= np.linalg.norm(mid, axis=1, keepdims=True)
        ab, bc, ca = inv.reshape(3, -1) + len(v)
        a, b, c = f.T
        v = np.concatenate([v, mid])
        f = np.concatenate([np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
                            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1)])
    return v, f.astype(np.int32)


def blob(width=512, height=512, subdiv=6, seed=0):
    """Seeded displaced icosphere in bunny()'s scene setup.

    Stands in for bunny.ply where the reference data is absent: the same
    floor, sphere light, camera and material, and a closed mesh of
    20 * 4**subdiv faces (81,920 at the default subdiv=6, the bunny has
    69,451). The radial displacement is a sum of seeded plane waves, so the
    surface has concavities and self-shadowing; it is a pure function of
    (subdiv, seed).
    """
    rs = np.random.default_rng(seed)
    u, f = icosphere(subdiv)
    k = 8
    dirs = rs.normal(size=(k, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    freq = rs.uniform(2.0, 6.0, k)
    phase = rs.uniform(0.0, 2.0 * np.pi, k)
    amp = rs.uniform(0.5, 1.0, k) / k
    disp = (amp * np.sin(freq * (u @ dirs.T) + phase)).sum(1)
    v = (0.6 * (1.0 + 0.5 * disp))[:, None] * u
    v[:, 2] -= v[:, 2].min()
    b = SceneBuilder()
    b.add_material(diffuse=(0.6, 0.5, 0.4), specular=(0.3, 0.3, 0.3), spec_exp=50)
    b.add_triangles(v.astype(np.float32), f)
    b.add_material(diffuse=(0.4, 0.4, 0.45))
    b.add_box_minmax((-10, -10, -0.2), (10, 10, 0.0))
    b.add_light_material((10.0, 10.0, 10.0))
    b.add_sphere((1.5, -1.5, 3.0), 0.4)
    b.set_camera((2.5, 0.0, 0.8), 0.4, _lookat_quat_y())
    return b.build(width, height)


def shaped(width=256, height=256):
    """Cylinders, a box light, a cylinder light and a glass sphere.

    The testscene.scn feature set (parser.cpp:1144-1182) without its
    meshes: every analytic primitive kind, all three NEE light kinds
    (sphere via none, mesh via the emissive box, cylinder) and the
    transmission lobe. The camera looks along +Y, tilted 15 degrees down.
    """
    b = SceneBuilder()
    tilt = np.deg2rad(75.0) / 2
    b.set_camera((0.0, -3.0, 1.2), 0.5,
                 np.array([np.sin(tilt), 0.0, 0.0, np.cos(tilt)], np.float32))
    b.add_material(diffuse=(0.6, 0.6, 0.6))
    b.add_box_minmax((-4, -4, -0.2), (4, 4, 0.0))           # floor
    b.add_material(diffuse=(0.5, 0.3, 0.2), specular=(0.4, 0.4, 0.4),
                   spec_exp=40)
    b.add_cylinder((-0.8, 0.0, 0.0), (0.0, 0.0, 1.2), 0.3)  # upright
    b.add_cylinder((0.2, -0.5, 0.4), (1.0, 0.5, 0.0), 0.2)  # leaning
    b.add_material(diffuse=(0.2, 0.4, 0.7))
    b.add_sphere((0.9, 0.6, 0.35), 0.35)
    b.add_material(specular=(0.04, 0.04, 0.04), transmission=(0.95, 0.95, 0.95),
                   ior=1.5)
    b.add_sphere((-0.1, -1.3, 0.35), 0.35)                  # glass
    b.add_light_material((6.0, 5.0, 4.0))
    b.add_box_minmax((-0.5, -0.5, 2.4), (0.5, 0.5, 2.6))    # box light
    b.add_light_material((2.0, 3.0, 4.0))
    b.add_cylinder((2.0, 2.0, 0.0), (0.0, 0.0, 2.0), 0.15)  # cylinder light
    return b.build(width, height)


BY_NAME = {
    "analytic": analytic,
    "blob": blob,
    "shaped": shaped,
    "letter": letter,
    "bunny": bunny,
    "dwarf": dwarf,
    "testscene": testscene,
}
