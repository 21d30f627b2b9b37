"""Sparse 3D map export: keyframe candidates → world-frame point cloud.

The reference renders per-keyframe inverse-depth maps as 2D images
(``misc/view.rs``, ``examples/candidates_*.rs``); its stated long-term goal
is a "functional SLAM system" (reference README.md:7), whose natural product
artifact is the sparse 3D map itself.  This module back-projects every
keyframe's level-0 candidate points through its (loop-closure-optimized)
camera-to-world pose into one world-frame cloud and serializes it as ASCII
PLY — readable by MeshLab/CloudCompare/Open3D.

Formulation: all keyframes are processed in ONE jitted vmapped
dispatch (pyramid + candidate selection + inverse-depth fusion + back-
projection + rigid transform); the fixed candidate capacity gives static
shapes, and the ``valid`` mask (selection ∧ known depth) is applied on the
host only at serialization time.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core import camera as camera_mod
from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math.pose import Pose
from ..ops import pyramid as pyramid_ops
from ..utils.types import Float


def keyframe_clouds(
    config,
    intrinsics: Intrinsics,
    depths: Sequence[np.ndarray],
    grays: Sequence[np.ndarray],
    poses: Sequence[Pose],
) -> Tuple[np.ndarray, np.ndarray]:
    """Back-project the level-0 candidates of ``K`` keyframes to world space.

    ``depths``/``grays``: raw u16 depth and u8 gray keyframe images;
    ``poses``: camera-to-world pose per keyframe (use the *optimized* poses
    after pose-graph refinement).  Returns ``(points, intensities)`` as
    numpy arrays of shape (M, 3) f32 world coordinates (meters) and (M,) u8
    template intensities, with padding, unknown-depth and non-positive-depth
    candidates filtered out.
    """
    from ..models import tracker as tracker_mod

    K = len(depths)
    assert K == len(grays) == len(poses)

    def one(depth, gray, c2w):
        pyr = pyramid_ops.mean_pyramid(config.nb_levels, gray)
        kf = tracker_mod.precompute_keyframe(config, intrinsics, depth, pyr)
        obs = kf.levels[0]
        ok = obs.valid & (obs.idepth > 0.0)
        # idepth = depth_scale / raw_u16 and raw/depth_scale is meters, so
        # 1/idepth is metric depth directly (inverse_depth.rs:24-29)
        z = 1.0 / jnp.where(ok, obs.idepth, 1.0)
        pix = jnp.stack([obs.xs, obs.ys], axis=-1)
        cam = camera_mod.back_project(obs.intrinsics, pix, z)
        world = pose_mod.apply(c2w, cam)
        return world, obs.tmpl_vals, ok

    batched = jax.jit(jax.vmap(one))

    # chunk the keyframe axis: one vmapped dispatch per CHUNK keyframes
    # bounds device memory (the vmapped pyramid + candidate precompute
    # materializes every lane's intermediates; hundreds of keyframes at
    # full resolution would be GBs in one dispatch)
    CHUNK = 16
    pts_parts, int_parts = [], []
    for s in range(0, K, CHUNK):
        e = min(s + CHUNK, K)
        depth_b = jnp.stack([jnp.asarray(d) for d in depths[s:e]])
        gray_b = jnp.stack([jnp.asarray(g) for g in grays[s:e]])
        pose_b = Pose(
            jnp.stack([p.q for p in poses[s:e]]),
            jnp.stack([p.t for p in poses[s:e]]),
        )
        world, vals, ok = batched(depth_b, gray_b, pose_b)
        mask = np.asarray(ok).reshape(-1)
        pts_parts.append(np.asarray(world, np.float32).reshape(-1, 3)[mask])
        int_parts.append(
            np.clip(np.asarray(vals).reshape(-1)[mask], 0, 255).astype(np.uint8)
        )
    return np.concatenate(pts_parts), np.concatenate(int_parts)


def voxel_downsample(
    points: np.ndarray, intensities: np.ndarray, voxel_size: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Keep one representative point per ``voxel_size``-meter cube.

    Long trajectories revisit the same structure from many keyframes;
    without deduplication the exported map grows linearly with keyframes,
    not with scene size.  The representative is the centroid of each
    voxel's points (mean intensity, rounded) — standard voxel-grid
    downsampling, vectorized with a single lexsort + reduceat.
    """
    if voxel_size <= 0.0 or len(points) == 0:
        return points, intensities
    cells = np.floor(points / voxel_size).astype(np.int64)
    order = np.lexsort((cells[:, 2], cells[:, 1], cells[:, 0]))
    cells = cells[order]
    new_cell = np.ones(len(cells), bool)
    new_cell[1:] = (cells[1:] != cells[:-1]).any(axis=1)
    starts = np.flatnonzero(new_cell)
    counts = np.diff(np.append(starts, len(cells)))[:, None].astype(np.float64)
    pts_sorted = points[order].astype(np.float64)
    int_sorted = intensities[order].astype(np.float64)
    pts_out = np.add.reduceat(pts_sorted, starts, axis=0) / counts
    int_out = np.add.reduceat(int_sorted, starts) / counts[:, 0]
    return (
        pts_out.astype(np.float32),
        np.clip(np.rint(int_out), 0, 255).astype(np.uint8),
    )


def write_ply(path: str, points: np.ndarray, intensities: np.ndarray) -> None:
    """Serialize a gray-colored point cloud as ASCII PLY."""
    points = np.asarray(points, np.float32)
    intensities = np.asarray(intensities, np.uint8)
    assert points.ndim == 2 and points.shape[1] == 3
    assert intensities.shape == (points.shape[0],)
    header = (
        "ply\nformat ascii 1.0\n"
        f"element vertex {len(points)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "end_header\n"
    )
    # vectorized row formatting: a Python per-point loop costs seconds at
    # typical map sizes (hundreds of keyframes x thousands of points)
    cols = np.concatenate(
        [points, np.repeat(intensities[:, None], 3, axis=1)], axis=1
    )
    with open(path, "w") as f:
        f.write(header)
        np.savetxt(f, cols, fmt=("%.6f", "%.6f", "%.6f", "%d", "%d", "%d"))


def read_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read back an ASCII PLY written by ``write_ply`` (for tests/tools)."""
    with open(path) as f:
        lines = f.read().splitlines()
    assert lines[0] == "ply"
    n = next(int(l.split()[-1]) for l in lines if l.startswith("element vertex"))
    start = lines.index("end_header") + 1
    rows = [l.split() for l in lines[start : start + n]]
    pts = np.array([[float(v) for v in r[:3]] for r in rows], np.float32)
    inten = np.array([int(r[3]) for r in rows], np.uint8)
    return pts, inten
