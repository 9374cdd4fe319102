"""chip_smoke.py's CPU-side contract: it refuses to run without a GPU, its
agreement checks catch what they are there to catch, and the committed CPU
reference it compares the card against still matches a fresh CPU render
(so the reference cannot go stale behind a change to the integrator)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import chip_smoke  # noqa: E402


def test_device_check_raises_without_gpu():
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        chip_smoke.check_device()


def test_image_agreement_bounds():
    rs = np.random.RandomState(0)
    a = rs.uniform(0.1, 1.0, (4096, 3)).astype(np.float32)
    assert chip_smoke.assert_images_agree("same", a, a.copy())["bitwise"]
    b = a.copy()
    b[:10] *= 1.5                           # 10 flipped paths: 0.24% of pixels
    chip_smoke.assert_images_agree("few flips", b, a)
    with pytest.raises(AssertionError):     # 1% of pixels: over the share
        b[:41] *= 1.5
        chip_smoke.assert_images_agree("many flips", b, a)
    with pytest.raises(AssertionError):     # uniform 0.5% bias: mean moves
        chip_smoke.assert_images_agree("bias", a * 1.005, a)


def test_grad_agreement_catches_tf32_sized_error():
    rs = np.random.RandomState(1)
    g = rs.normal(size=(1280, 3))
    chip_smoke.assert_grads_agree("same", g, g.copy())
    noisy = g * (1.0 + 2.0 ** -10 * rs.choice([-1.0, 1.0], g.shape))
    with pytest.raises(AssertionError):     # every term off by TF32's ulp
        chip_smoke.assert_grads_agree("tf32", noisy * 1.002, g)
    with pytest.raises(AssertionError):
        chip_smoke.assert_grads_agree("zero", g, np.zeros_like(g))
    # vertex gradients: looser norm, same cosine
    chip_smoke.assert_grads_agree("grazing", g * 1.005, g, vertex=True)
    with pytest.raises(AssertionError):
        chip_smoke.assert_grads_agree("rotated", g[::-1].copy(), g, vertex=True)


@pytest.mark.parametrize("name", chip_smoke.REF_SCENES)
def test_cpu_reference_is_current(name):
    got = chip_smoke.reference_outputs((name,))
    with np.load(chip_smoke.GOLDEN) as ref:
        assert {k for k in ref.files if k.startswith(name + "_")} == set(got)
        results = chip_smoke.compare_to_reference(got, ref)
    assert all(ok for _, _, ok in results), results
    img = got[f"{name}_radiance"]
    assert np.isfinite(img).all() and img.mean() > 0
