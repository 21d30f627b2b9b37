"""TUM RGB-D dataset: constants, parsers, trajectory serialization, image IO.

Capability parity with reference ``src/dataset/tum_rgbd.rs`` and the image
helpers in ``src/misc/helper.rs`` / ``src/misc/interop.rs``:

- depth scale 5000 (u16 per meter) and default inverse-depth variance 1e-4
  (tum_rgbd.rs:15-20)
- intrinsics presets for fr1 / fr2 / fr3 / ICL-NUIM (tum_rgbd.rs:23-51)
- association and trajectory file parsing with ``#`` comments
  (tum_rgbd.rs:89-196; plain string splitting replaces the nom parsers)
- TUM trajectory line serialization ``timestamp tx ty tz qx qy qz qw``
  (tum_rgbd.rs:76-86)
- 16-bit PNG depth reading and gray conversion (helper.rs:13-36), through
  the native loader or the numpy codec in ``dataset.png``
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from ..core.camera import Intrinsics
from ..math.pose import Pose
from . import png

DEPTH_SCALE = 5000.0
VARIANCE_TUM = 1e-4
VARIANCE_ICL_NUIM = 1e-4


def intrinsics_icl_nuim() -> Intrinsics:
    return Intrinsics.make(319.5, 239.5, 481.20, -480.00)


def intrinsics_fr1() -> Intrinsics:
    return Intrinsics.make(318.643040, 255.313989, 517.306408, 516.469215)


def intrinsics_fr2() -> Intrinsics:
    return Intrinsics.make(325.141442, 249.701764, 520.908620, 521.007327)


def intrinsics_fr3() -> Intrinsics:
    return Intrinsics.make(320.106653, 247.632132, 535.433105, 539.212524)


INTRINSICS = {
    "fr1": intrinsics_fr1,
    "fr2": intrinsics_fr2,
    "fr3": intrinsics_fr3,
    "icl": intrinsics_icl_nuim,
}

# native resolution of every preset (the reference hardcodes 640x480 images)
NATIVE_WIDTH, NATIVE_HEIGHT = 640, 480


def scaled_intrinsics(camera_id: str, height: int, width: int) -> Intrinsics:
    """Preset intrinsics rescaled to a non-native image size.

    The reference assumes 640x480 inputs (its presets are only valid there).
    When images come at another resolution, focal lengths scale linearly and
    the principal point scales in the pixel-CENTER convention
    ``c' = (c + 0.5) * s - 0.5`` — the same convention as the pyramid's
    half-resolution intrinsics (ref camera.rs:115-123, s = 1/2).  At native
    size this is the identity.
    """
    k = INTRINSICS[camera_id]()
    sx = width / NATIVE_WIDTH
    sy = height / NATIVE_HEIGHT
    return Intrinsics.make(
        (float(k.cx) + 0.5) * sx - 0.5,
        (float(k.cy) + 0.5) * sy - 0.5,
        float(k.fx) * sx,
        float(k.fy) * sy,
        float(k.skew),
    )


@dataclass
class Association:
    """Paired depth/color timestamps and file paths (tum_rgbd.rs:62-73)."""

    depth_timestamp: float
    depth_file_path: str
    color_timestamp: float
    color_file_path: str


@dataclass
class Frame:
    """Timestamp + camera pose (tum_rgbd.rs:53-60)."""

    timestamp: float
    pose: Pose

    def to_string(self) -> str:
        """TUM trajectory line ``timestamp tx ty tz qx qy qz qw``
        (tum_rgbd.rs:76-86; note qw LAST, quaternion stored wxyz here)."""
        t = np.asarray(self.pose.t, np.float64)
        q = np.asarray(self.pose.q, np.float64)  # [w, x, y, z]
        vals = [self.timestamp, t[0], t[1], t[2], q[1], q[2], q[3], q[0]]
        return " ".join(_fmt(v) for v in vals)


def _fmt(v: float) -> str:
    """Compact float formatting (Rust's {} prints shortest roundtrip)."""
    return np.format_float_positional(v, trim="-")


def parse_associations(content: str) -> List[Association]:
    """Parse an associations file; ``#`` lines are comments (tum_rgbd.rs:97-99)."""
    out = []
    for line in content.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 4:
            raise ValueError(f"Parsing error: {line!r}")
        out.append(
            Association(
                depth_timestamp=float(parts[0]),
                depth_file_path=parts[1],
                color_timestamp=float(parts[2]),
                color_file_path=parts[3],
            )
        )
    return out


def parse_trajectory(content: str) -> List[Frame]:
    """Parse a TUM trajectory/groundtruth file (tum_rgbd.rs:102-104).

    Line format: ``timestamp tx ty tz qx qy qz qw``.
    """
    import jax.numpy as jnp

    out = []
    for line in content.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = line.split()
        if len(parts) != 8:
            raise ValueError(f"Parsing error: {line!r}")
        ts, tx, ty, tz, qx, qy, qz, qw = (float(p) for p in parts)
        out.append(
            Frame(
                timestamp=ts,
                pose=Pose(
                    q=jnp.array([qw, qx, qy, qz], jnp.float32),
                    t=jnp.array([tx, ty, tz], jnp.float32),
                ),
            )
        )
    return out


def load_associations(path: str) -> List[Association]:
    """Read + parse + make image paths absolute (vors_track.rs:113-137)."""
    with open(path) as f:
        assocs = parse_associations(f.read())
    parent = os.path.dirname(os.path.abspath(path))
    for a in assocs:
        a.depth_file_path = os.path.join(parent, a.depth_file_path)
        a.color_file_path = os.path.join(parent, a.color_file_path)
    return assocs


def read_png_16bits(path: str) -> np.ndarray:
    """u16 depth PNG → (H, W) uint16 array (helper.rs:13-36).

    Decodes through the native C++ loader (``native/vors_io.cpp``) when it
    builds; the numpy codec (``dataset.png``) gives identical output.
    """
    from .. import native

    if native.available():
        return native.read_png_16bits(path)
    arr = png.read(path)
    if arr.dtype != np.uint16 or arr.ndim != 2:
        raise ValueError(f"expected a 16-bit gray depth PNG, got {arr.dtype} {arr.shape}: {path}")
    return arr


def read_gray(path: str) -> np.ndarray:
    """Color/gray PNG → (H, W) uint8 luma (interop.rs + image::to_luma).

    Uses the same integer luma weights as the Rust ``image`` crate
    (ITU-R BT.601: (299 R + 587 G + 114 B) / 1000); 16-bit gray keeps its
    high byte.  Native C++ decode when it builds, the numpy codec otherwise
    (identical numerics).
    """
    from .. import native

    if native.available():
        return native.read_gray(path)
    arr = png.read(path)
    if arr.ndim == 2:
        return (arr >> 8).astype(np.uint8) if arr.dtype == np.uint16 else arr
    if arr.dtype != np.uint8:
        raise ValueError(f"unsupported 16-bit colour PNG: {path}")
    if arr.shape[2] == 2:  # gray + alpha: alpha is dropped
        return arr[..., 0].copy()
    rgb = arr[..., :3].astype(np.uint32)
    luma = (299 * rgb[..., 0] + 587 * rgb[..., 1] + 114 * rgb[..., 2]) // 1000
    return luma.astype(np.uint8)


def read_images(assoc: Association) -> Tuple[np.ndarray, np.ndarray]:
    """(depth u16, gray u8) for one association (vors_track.rs:140-145)."""
    return read_png_16bits(assoc.depth_file_path), read_gray(assoc.color_file_path)


def frame_loader(
    assocs: List[Association],
    *,
    num_threads: int = 4,
    max_ahead: int = 8,
):
    """In-order iterator of (depth u16, gray u8) frames for a sequence.

    Uses the native multi-threaded prefetch loader (``native/vors_io.cpp``)
    when available so PNG decode overlaps tracking compute — the reference
    decodes on the tracking thread (vors_track.rs:49-64).  Falls back to
    sequential per-frame reads with identical output.
    """
    if not assocs:
        return
    from .. import native

    use_native = native.available()
    if use_native:
        try:
            h, w = native.png_dims(assocs[0].depth_file_path)
            loader = native.PrefetchLoader(
                [a.depth_file_path for a in assocs],
                [a.color_file_path for a in assocs],
                h,
                w,
                num_threads=num_threads,
                max_ahead=max_ahead,
            )
        except (RuntimeError, IOError):
            use_native = False
    if use_native:
        with loader:
            yield from loader
        return
    for a in assocs:
        yield read_images(a)


def write_sequence(
    directory: str,
    grays: np.ndarray,
    depths: np.ndarray,
    timestamps: np.ndarray,
) -> str:
    """Write a synthetic sequence in TUM on-disk layout; returns the
    associations-file path.  Used by tests and the CLI demo mode."""
    os.makedirs(os.path.join(directory, "depth"), exist_ok=True)
    os.makedirs(os.path.join(directory, "rgb"), exist_ok=True)
    lines = []
    for i, ts in enumerate(timestamps):
        dpath = f"depth/{ts:.6f}.png"
        cpath = f"rgb/{ts:.6f}.png"
        png.write(os.path.join(directory, dpath), depths[i].astype(np.uint16))
        png.write(os.path.join(directory, cpath), grays[i].astype(np.uint8))
        lines.append(f"{ts:.6f} {dpath} {ts:.6f} {cpath}")
    assoc_path = os.path.join(directory, "associations.txt")
    with open(assoc_path, "w") as f:
        f.write("# depth_ts depth_file color_ts color_file\n")
        f.write("\n".join(lines) + "\n")
    return assoc_path
