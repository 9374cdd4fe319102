"""Test harness setup: run everything on a virtual 8-device CPU mesh.

This is the "fake backend" the reference lacks (SURVEY.md §4): an 8-device
host-platform mesh lets multi-device sharding tests run anywhere, and CPU
keeps unit-test latency low. Must run before the first jax import.

Checks that need a GPU are not run here: chip_smoke.py runs them on the
card (the ``gpu`` marker, registered in pyproject.toml, is for any test
that needs one; such a test decides inside a fixture, never at import).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def ref_data_dir():
    """The reference's data files (bunny.ply, testscene.scn, ...), from the
    RAYTRACER_REF_DATA directory; tests that need them skip without it."""
    d = os.environ.get("RAYTRACER_REF_DATA")
    if not d or not os.path.isdir(d):
        pytest.skip("reference data not available (set RAYTRACER_REF_DATA)")
    return d


@pytest.fixture(scope="session")
def blob_small():
    """Generated stand-in mesh (models/scenes.blob): 1,280 faces + BVH."""
    from offline_raytracer_tpu.models.scenes import blob
    return blob(32, 32, subdiv=3)


@pytest.fixture
def rtol32():
    return dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="session")
def analytic_scene():
    """BASELINE.json configs[0]: single sphere + plane + one sphere light."""
    from offline_raytracer_tpu.scene.build import SceneBuilder

    b = SceneBuilder()
    b.add_material(diffuse=(0.7, 0.3, 0.2))
    b.add_sphere((0.0, 0.0, 1.0), 0.8)
    b.add_material(diffuse=(0.5, 0.5, 0.5))
    b.add_box_minmax((-20, -20, -0.2), (20, 20, 0.0))
    b.add_light_material((8.0, 8.0, 8.0))
    b.add_sphere((2.0, -2.0, 4.0), 0.5)
    b.set_camera((4.0, 0.0, 1.5), 0.4, quat_for_lookat())
    return b.build(64, 64)


def quat_for_lookat():
    """Quaternion (xyzw) orienting the camera at +X looking toward -X.

    Camera convention: -z_axis is the view direction (ray.cpp:1220), so we
    need R mapping (0,0,1) -> (1,0,0) i.e. a 90° rotation about Y, composed
    with a roll so +y stays up-ish.
    """
    half = np.pi / 4
    return np.array([0.0, np.sin(half), 0.0, np.cos(half)], np.float32)
