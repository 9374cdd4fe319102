import numpy as np

from offline_raytracer_tpu.utils import hdr


def test_rgbe_roundtrip_accuracy():
    rs = np.random.RandomState(0)
    img = (rs.rand(32, 32, 3).astype(np.float32)) * rs.choice(
        [0.01, 1.0, 100.0], size=(32, 32, 1)).astype(np.float32)
    dec = hdr.rgbe_to_float(hdr.float_to_rgbe(img))
    # 8-bit shared-exponent mantissa: ~1% relative error worst case
    maxc = img.max(-1, keepdims=True)
    assert np.all(np.abs(dec - img) <= maxc * 0.01 + 1e-7)


def test_rgbe_zero_and_tiny():
    img = np.zeros((2, 2, 3), np.float32)
    img[0, 0] = [1e-38, 1e-38, 1e-38]
    rgbe = hdr.float_to_rgbe(img)
    assert (rgbe == 0).all()


def test_rgbe_known_value():
    # 1.0 -> mantissa 0.5, exponent 1 -> byte 128, e byte 129
    rgbe = hdr.float_to_rgbe(np.array([[[1.0, 1.0, 1.0]]], np.float32))
    assert rgbe[0, 0].tolist() == [128, 128, 128, 129]


def test_write_read_roundtrip(tmp_path):
    rs = np.random.RandomState(1)
    img = rs.rand(16, 24, 3).astype(np.float32) * 4.0
    p = str(tmp_path / "t.hdr")
    hdr.write_hdr(p, img)
    back = hdr.read_hdr(p)
    assert back.shape == img.shape
    assert np.all(np.abs(back - img) <= img.max(-1, keepdims=True) * 0.01 + 1e-7)


def test_reads_reference_showcase(ref_data_dir):
    # reference showcase HDRs were written by the flat writer we mirror;
    # the reference keeps showcase/ beside data/
    import os

    img = hdr.read_hdr(os.path.join(os.path.dirname(os.path.abspath(ref_data_dir)),
                                    "showcase", "1.hdr"))
    assert img.shape == (720, 1280, 3)
    assert np.isfinite(img).all() and img.max() > 0.1


def test_png_writer(tmp_path):
    img = hdr.tonemap(np.ones((8, 8, 3), np.float32))
    p = str(tmp_path / "t.png")
    hdr.write_png(p, img)
    with open(p, "rb") as f:
        assert f.read(8) == b"\x89PNG\r\n\x1a\n"
