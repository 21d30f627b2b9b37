"""The numpy + zlib PNG codec (``dataset.png``) and the TUM IO built on it.

Each decode is checked against the array that was encoded and, where the
native libpng loader builds, against what libpng decodes from the same
bytes: an independent decoder, so encoder and decoder cannot share a bug.
"""

import sys

import numpy as np
import pytest

from visual_odometry_rs_tpu import native
from visual_odometry_rs_tpu.dataset import png, synthetic, tum_rgbd

_RNG = np.random.default_rng(0)
IMAGES = {
    "gray8": _RNG.integers(0, 256, (19, 23), dtype=np.uint8),
    "depth16": _RNG.integers(0, 65536, (19, 23), dtype=np.uint16),
    "rgb8": _RNG.integers(0, 256, (19, 23, 3), dtype=np.uint8),
    "rgba8": _RNG.integers(0, 256, (19, 23, 4), dtype=np.uint8),
}


def _luma(rgb):
    c = rgb[..., :3].astype(np.uint32)
    return ((299 * c[..., 0] + 587 * c[..., 1] + 114 * c[..., 2]) // 1000).astype(np.uint8)


@pytest.mark.parametrize("filter_type", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("kind", sorted(IMAGES))
def test_png_round_trip(kind, filter_type, tmp_path):
    img = IMAGES[kind]
    path = str(tmp_path / f"{kind}.png")
    png.write(path, img, filter_type=filter_type)
    got = png.read(path)
    assert got.dtype == img.dtype and got.shape == img.shape
    np.testing.assert_array_equal(got, img)
    if native.available():
        if kind == "depth16":
            np.testing.assert_array_equal(native.read_png_16bits(path), img)
        elif kind == "gray8":
            np.testing.assert_array_equal(native.read_gray(path), img)
        else:
            np.testing.assert_array_equal(native.read_gray(path), _luma(img))


@pytest.mark.parametrize("kind", ["gray8", "depth16", "rgb8"])
def test_tum_readers_without_native(kind, tmp_path, monkeypatch):
    """The numpy fallback of ``read_gray``/``read_png_16bits``: RGB goes to
    BT.601 integer luma, 16-bit depth comes back unchanged."""
    img = IMAGES[kind]
    path = str(tmp_path / f"{kind}.png")
    png.write(path, img, filter_type=4)
    monkeypatch.setattr(native, "available", lambda: False)
    if kind == "depth16":
        np.testing.assert_array_equal(tum_rgbd.read_png_16bits(path), img)
        eight_bit = str(tmp_path / "gray.png")
        png.write(eight_bit, IMAGES["gray8"])
        with pytest.raises(ValueError):
            tum_rgbd.read_png_16bits(eight_bit)
    else:
        want = img if kind == "gray8" else _luma(img)
        np.testing.assert_array_equal(tum_rgbd.read_gray(path), want)


def test_png_refuses_unsupported(tmp_path):
    data = bytearray(png.encode(IMAGES["gray8"]))
    data[8 + 8 + 12] = 1  # IHDR interlace byte -> Adam7
    with pytest.raises(ValueError):
        png.decode(bytes(data))
    with pytest.raises(ValueError):
        png.decode(b"not a png")
    with pytest.raises(ValueError):
        png.encode(np.zeros((4, 4), np.float32))


@pytest.mark.parametrize("use_native", [True, False])
def test_tum_sequence_without_pil(use_native, tmp_path, monkeypatch):
    """Write a TUM sequence and track it with ``vors_track`` while PIL
    cannot be imported: the main path needs numpy, zlib and JAX only."""
    import io
    from contextlib import redirect_stdout

    from visual_odometry_rs_tpu.cli import vors_track
    from visual_odometry_rs_tpu.eval import ate
    from visual_odometry_rs_tpu.math import pose as pose_mod

    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    if not use_native:
        monkeypatch.setattr(native, "available", lambda: False)
    seq = synthetic.generate_sequence(nb_frames=4, height=48, width=64, seed=5)
    assoc = tum_rgbd.write_sequence(str(tmp_path), seq.grays, seq.depths, seq.timestamps)
    for a, depth, gray in zip(tum_rgbd.load_associations(assoc), seq.depths, seq.grays):
        d, g = tum_rgbd.read_images(a)
        np.testing.assert_array_equal(d, depth)
        np.testing.assert_array_equal(g, gray)
    out = io.StringIO()
    with redirect_stdout(out):
        rc = vors_track.main(
            ["fr1", assoc, "--cpu", "--nb-levels", "3", "--candidate-cap", "256"]
        )
    assert rc == 0
    frames = tum_rgbd.parse_trajectory(out.getvalue())
    assert len(frames) == 3
    err = ate.ate_rmse([pose_mod.identity()] + [f.pose for f in frames], seq.poses)
    assert np.isfinite(err) and err < 0.01, err
