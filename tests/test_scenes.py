"""Generated presets (models/scenes.py): the stand-ins for the reference
data files must be what they claim — a closed mesh of the asked face count
that is a pure function of its seed, and an analytic scene with every
primitive kind, every light kind and glass."""

import numpy as np
import pytest

from offline_raytracer_tpu.models import scenes
from offline_raytracer_tpu.ops.lights import KIND_CYLINDER, KIND_MESH, KIND_SPHERE


@pytest.mark.parametrize("subdiv", [0, 1, 2, 3])
def test_icosphere_is_closed_with_asked_face_count(subdiv):
    v, f = scenes.icosphere(subdiv)
    assert f.shape == (20 * 4 ** subdiv, 3)
    assert len(v) == 10 * 4 ** subdiv + 2             # Euler: V - E + F = 2
    np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0, rtol=1e-12)
    # closed and consistently oriented: every directed edge appears once,
    # and its reverse belongs to exactly one other face
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]])
    fwd = {tuple(x) for x in e}
    assert len(fwd) == len(e)
    assert all((b, a) in fwd for a, b in fwd)
    # counter-clockwise seen from outside: normals point away from center
    n = np.cross(v[f[:, 1]] - v[f[:, 0]], v[f[:, 2]] - v[f[:, 0]])
    assert (np.sum(n * v[f].mean(1), -1) > 0).all()


def test_blob_default_is_bunny_scale():
    v, f = scenes.icosphere(6)
    assert f.shape[0] == 81920


def test_blob_deterministic_in_seed():
    a = scenes.blob(16, 16, subdiv=3, seed=0)
    b = scenes.blob(16, 16, subdiv=3, seed=0)
    c = scenes.blob(16, 16, subdiv=3, seed=1)
    assert a.triangles.v0.shape == (1280, 3)
    for k in ("v0", "v1", "v2"):
        np.testing.assert_array_equal(np.asarray(getattr(a.triangles, k)),
                                      np.asarray(getattr(b.triangles, k)))
    assert not np.array_equal(np.asarray(a.triangles.v0),
                              np.asarray(c.triangles.v0))
    v0 = np.asarray(a.triangles.v0)
    assert v0[:, 2].min() >= -1e-6                    # rests on the floor
    r = np.linalg.norm(v0[:, :2], axis=1)
    assert r.max() / np.median(r) > 1.1                # actually displaced
    assert a.tri_bvh is not None and a.n_lights == 1


def test_shaped_has_every_primitive_and_light_kind():
    s = scenes.shaped(32, 32)
    assert s.cylinders.radius.shape[0] == 3
    assert s.boxes.mat.shape[0] == 2 and s.spheres.radius.shape[0] == 2
    assert s.triangles.mat.shape[0] == 0 and s.tri_bvh is None
    kinds = set(np.asarray(s.lights.kind).tolist())
    assert {KIND_MESH, KIND_CYLINDER} <= kinds and KIND_SPHERE not in kinds
    kt = np.asarray(s.materials.transmission).max(-1)
    glass = np.flatnonzero(kt > 0.5)
    assert glass.size == 1 and float(s.materials.ior[glass[0]]) == 1.5
    assert int(glass[0]) in np.asarray(s.spheres.mat).tolist()


def test_presets_needing_reference_data_say_so(monkeypatch):
    monkeypatch.delenv("RAYTRACER_REF_DATA", raising=False)
    with pytest.raises(FileNotFoundError, match="RAYTRACER_REF_DATA"):
        scenes.bunny(16, 16)
