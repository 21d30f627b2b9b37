"""Sliding-window bundle adjustment with Schur-complement reduction.

Green-field scaling extension (SURVEY §5 "long-context"): the reference
processes video strictly frame-by-frame with one keyframe of state and defers
windowed optimization to future work (reference README.md:54-55).  This
module provides it, designed for fixed-shape accelerator programs:

- A window of K keyframe poses and P landmark points, with M fixed-shape
  masked observations ``(kf_idx, pt_idx, uv)``.
- Gauss-Newton/LM over the (6K + 3P)-dim normal equations, reduced by the
  Schur complement: point blocks ``C_p`` are embarrassingly parallel 3x3
  solves; the reduced 6K x 6K camera system ``S = B - F C^-1 F^T`` is
  assembled with einsums.
- **Point-sharded SPMD**: the landmark dimension shards over a mesh axis;
  each chip reduces its own points' contributions to ``S`` and the reduced
  rhs, one ``psum`` assembles the camera system, every chip solves the
  (small) camera system redundantly and back-substitutes its own points
  locally.  This is the VO analog of data-parallel attention blocks: all
  heavy per-point work local, one small collective per iteration.

Parameterization: pose updates are right-multiplied twists,
``T_k <- T_k * exp(delta_k)`` with residuals in pixels; the first camera is
gauge-fixed.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core import camera as camera_mod
from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math import se3
from ..math.pose import Pose
from ..utils.types import Float


class BAProblem(NamedTuple):
    """Fixed-shape BA problem.

    poses: Pose with leading (K,) — camera-to-world.
    points: (P, 3) world landmarks.
    obs_kf: (M,) int32 — keyframe index per observation.
    obs_pt: (M,) int32 — point index per observation.
    obs_uv: (M, 2) f32 — measured pixels.
    obs_mask: (M,) bool — padding mask.
    intrinsics: shared pinhole intrinsics.
    """

    poses: Pose
    points: jnp.ndarray
    obs_kf: jnp.ndarray
    obs_pt: jnp.ndarray
    obs_uv: jnp.ndarray
    obs_mask: jnp.ndarray
    intrinsics: Intrinsics


def _project(pose: Pose, point: jnp.ndarray, k: Intrinsics) -> jnp.ndarray:
    """World point → pixel through a camera-to-world pose."""
    pc = camera_mod.world_to_camera(pose, point)
    uvz = camera_mod.project(k, pc)
    return uvz[..., :2] / uvz[..., 2:3]


def residuals(problem: BAProblem, poses: Pose, points: jnp.ndarray) -> jnp.ndarray:
    """(M, 2) masked reprojection residuals."""
    cam = jax.tree_util.tree_map(lambda x: x[problem.obs_kf], poses)
    pts = points[problem.obs_pt]
    uv = _project(cam, pts, problem.intrinsics)
    r = uv - problem.obs_uv
    return jnp.where(problem.obs_mask[:, None], r, 0.0)


def _obs_jacobians(problem: BAProblem, poses: Pose, points: jnp.ndarray):
    """Per-observation Jacobians wrt camera twist (2,6) and point (2,3).

    Computed by forward-mode autodiff of the masked residual of a single
    observation — exact, and vmapped over the fixed observation array.
    """

    def r_one(xi, dx, q, t, x, uv_obs):
        cam = pose_mod.compose(Pose(q, t), se3.exp(xi))
        uv = _project(cam, x + dx, problem.intrinsics)
        return uv - uv_obs

    zeros6 = jnp.zeros(6, Float)
    zeros3 = jnp.zeros(3, Float)

    def jac_one(q, t, x, uv_obs):
        j_cam = jax.jacfwd(lambda xi: r_one(xi, zeros3, q, t, x, uv_obs))(zeros6)
        j_pt = jax.jacfwd(lambda dx: r_one(zeros6, dx, q, t, x, uv_obs))(zeros3)
        r = r_one(zeros6, zeros3, q, t, x, uv_obs)
        return j_cam, j_pt, r

    cam = jax.tree_util.tree_map(lambda v: v[problem.obs_kf], poses)
    pts = points[problem.obs_pt]
    j_cam, j_pt, r = jax.vmap(jac_one)(cam.q, cam.t, pts, problem.obs_uv)
    maskf = problem.obs_mask.astype(Float)[:, None, None]
    return j_cam * maskf, j_pt * maskf, r * maskf[..., 0]


class _Normal(NamedTuple):
    """Per-shard pieces of the normal equations."""

    B: jnp.ndarray  # (K, 6, 6) camera diagonal blocks
    v: jnp.ndarray  # (K, 6) camera rhs
    C: jnp.ndarray  # (P, 3, 3) point diagonal blocks
    w: jnp.ndarray  # (P, 3) point rhs
    F: jnp.ndarray  # (P, K, 6, 3) camera-point coupling blocks
    energy: jnp.ndarray


def _build_normal(problem: BAProblem, poses: Pose, points: jnp.ndarray, K: int, P: int) -> _Normal:
    j_cam, j_pt, r = _obs_jacobians(problem, poses, points)
    energy = jnp.sum(r * r)

    BtB = jnp.einsum("mia,mib->mab", j_cam, j_cam)  # (M, 6, 6)
    B = jax.ops.segment_sum(BtB, problem.obs_kf, num_segments=K)
    v = jax.ops.segment_sum(
        -jnp.einsum("mia,mi->ma", j_cam, r), problem.obs_kf, num_segments=K
    )
    CtC = jnp.einsum("mia,mib->mab", j_pt, j_pt)
    C = jax.ops.segment_sum(CtC, problem.obs_pt, num_segments=P)
    w = jax.ops.segment_sum(
        -jnp.einsum("mia,mi->ma", j_pt, r), problem.obs_pt, num_segments=P
    )
    Ef = jnp.einsum("mia,mib->mab", j_cam, j_pt)  # (M, 6, 3)
    flat_idx = problem.obs_pt * K + problem.obs_kf
    F = jax.ops.segment_sum(Ef, flat_idx, num_segments=P * K).reshape(P, K, 6, 3)
    return _Normal(B=B, v=v, C=C, w=w, F=F, energy=energy)


def _point_inverse(n: _Normal, lm: jnp.ndarray) -> jnp.ndarray:
    """Damped inverse of the 3x3 point blocks (embarrassingly parallel)."""
    eye3 = jnp.eye(3, dtype=Float)
    C_damped = n.C * (1.0 + lm * eye3) + 1e-8 * eye3
    return jnp.linalg.inv(C_damped)


def _schur_fill(n: _Normal, C_inv: jnp.ndarray):
    """Point-elimination fill-in: (FC F^T, FC w) — the per-point-shard part."""
    FC = jnp.einsum("pkab,pbc->pkac", n.F, C_inv)  # (P, K, 6, 3)
    S_fill = jnp.einsum("pkac,pldc->kald", FC, n.F)  # (K, 6, K, 6)
    rhs_fill = jnp.einsum("pkac,pc->ka", FC, n.w)  # (K, 6)
    return S_fill, rhs_fill


def _assemble_camera_system(B, v, S_fill, rhs_fill, lm, K):
    """S = damped blockdiag(B) - fill, rhs = v - fill."""
    eye6 = jnp.eye(6, dtype=Float)
    B_damped = B * (1.0 + lm * eye6)
    S = jnp.zeros((K, 6, K, 6), Float)
    S = S.at[jnp.arange(K), :, jnp.arange(K), :].add(B_damped)
    S = S - S_fill
    rhs = v - rhs_fill
    return S.reshape(6 * K, 6 * K), rhs.reshape(6 * K)


def _schur_reduce(n: _Normal, lm: jnp.ndarray, K: int):
    """Eliminate points: S = B - F C^-1 F^T, rhs = v - F C^-1 w."""
    C_inv = _point_inverse(n, lm)
    S_fill, rhs_fill = _schur_fill(n, C_inv)
    S, rhs = _assemble_camera_system(n.B, n.v, S_fill, rhs_fill, lm, K)
    return S, rhs, C_inv


def _solve_cameras(S: jnp.ndarray, rhs: jnp.ndarray, K: int) -> jnp.ndarray:
    """Gauge-fixed camera solve: camera 0 is pinned (delta = 0)."""
    n = 6 * K
    idx = jnp.arange(n)
    free = idx >= 6
    mask2d = free[:, None] & free[None, :]
    eye = jnp.eye(n, dtype=Float)
    S_fixed = jnp.where(mask2d, S, eye)
    rhs_fixed = jnp.where(free, rhs, 0.0)
    chol = jnp.linalg.cholesky(S_fixed)
    delta = jax.scipy.linalg.cho_solve((chol, True), rhs_fixed)
    return delta.reshape(K, 6)


def _apply_deltas(poses: Pose, points: jnp.ndarray, d_cam: jnp.ndarray, d_pt: jnp.ndarray):
    new_poses = jax.vmap(lambda p_q, p_t, xi: pose_mod.compose(Pose(p_q, p_t), se3.exp(xi)))(
        poses.q, poses.t, d_cam
    )
    new_poses = pose_mod.renormalize_first_order(Pose(new_poses.q, new_poses.t))
    return new_poses, points + d_pt


class BAResult(NamedTuple):
    poses: Pose
    points: jnp.ndarray
    energy: jnp.ndarray
    nb_iter: jnp.ndarray


@partial(jax.jit, static_argnames=("max_iterations",))
def solve(problem: BAProblem, *, max_iterations: int = 15) -> BAResult:
    """LM bundle adjustment of the window (single device)."""
    K = problem.poses.q.shape[0]
    P = problem.points.shape[0]

    def energy_of(poses, points):
        r = residuals(problem, poses, points)
        return jnp.sum(r * r)

    def body(carry):
        poses, points, energy, lm, it, done = carry
        n = _build_normal(problem, poses, points, K, P)
        S, rhs, C_inv = _schur_reduce(n, lm, K)
        d_cam = _solve_cameras(S, rhs, K)
        # back-substitute points: delta_p = C^-1 (w - F^T delta_c)
        Ft_dc = jnp.einsum("pkab,ka->pb", n.F, d_cam)
        d_pt = jnp.einsum("pab,pb->pa", C_inv, n.w - Ft_dc)
        new_poses, new_points = _apply_deltas(poses, points, d_cam, d_pt)
        new_energy = energy_of(new_poses, new_points)
        ok = (
            jnp.isfinite(new_energy)
            & (new_energy <= energy)
            & jnp.all(jnp.isfinite(new_poses.q))
            & jnp.all(jnp.isfinite(new_poses.t))
        )
        poses = jax.tree_util.tree_map(
            lambda new, old: jnp.where(ok, new, old), new_poses, poses
        )
        points = jnp.where(ok, new_points, points)
        lm = jnp.where(ok, lm * 0.3, lm * 10.0)
        d_energy = energy - new_energy
        done = jnp.logical_or(
            it + 1 >= max_iterations, jnp.logical_and(ok, d_energy < 1e-6 * (energy + 1.0))
        )
        energy = jnp.where(ok, new_energy, energy)
        return poses, points, energy, lm, it + 1, done

    def cond(carry):
        return ~carry[-1]

    energy0 = energy_of(problem.poses, problem.points)
    poses, points, energy, _, it, _ = jax.lax.while_loop(
        cond,
        body,
        (
            problem.poses, problem.points, energy0,
            jnp.asarray(1e-4, Float), jnp.asarray(0, jnp.int32), jnp.asarray(False),
        ),
    )
    return BAResult(poses=poses, points=points, energy=energy, nb_iter=it)


def solve_point_sharded(
    problem: BAProblem,
    mesh,
    axis: str = "points",
    *,
    max_iterations: int = 15,
    assembly: str = "psum",
) -> BAResult:
    """BA with the landmark dimension sharded over ``mesh[axis]``.

    Each shard owns P/n points and the observations that reference them
    (observations must be pre-partitioned by point: ``obs_pt`` local indices).
    The reduced camera system is assembled once per iteration; point
    back-substitution is fully local.  Output poses are replicated, points
    are returned sharded.

    ``assembly`` selects the collective for the camera-system reduction:

    - ``"psum"``: XLA all-reduce of the full (K,6,K,6) fill-in — right for
      short windows.
    - ``"ring"``: ring reduce-scatter over keyframe block-rows followed by a
      ring all-gather (``parallel.collectives``) — the ring-attention-style
      pass over keyframe shards (SURVEY §5).  This is a *bandwidth-shaped*
      all-reduce: partial sums travel the device ring in K/n
      block-row chunks, but the trailing all-gather still materializes the
      complete (K,6,K,6) fill-in on every chip before the (replicated)
      camera solve — peak memory matches ``"psum"``; only the communication
      pattern differs.  (A reduce-scattered distributed camera solve that
      never materializes full fill-in is future work.)  Requires K divisible
      by the mesh axis size.
    """
    from jax.sharding import PartitionSpec as P_

    K = problem.poses.q.shape[0]
    n_dev = mesh.shape[axis]
    if assembly == "ring" and K % n_dev != 0:
        raise ValueError(f"ring assembly needs K ({K}) divisible by mesh axis ({n_dev})")
    if assembly not in ("psum", "ring"):
        raise ValueError(f"unknown assembly: {assembly}")

    def sharded(problem_local: BAProblem) -> BAResult:
        P_local = problem_local.points.shape[0]

        def energy_of(poses, points):
            r = residuals(problem_local, poses, points)
            return jax.lax.psum(jnp.sum(r * r), axis)

        def body(carry):
            poses, points, energy, lm, it, done = carry
            n = _build_normal(problem_local, poses, points, K, P_local)
            # local point-block inverses + fill-in, one psum per iteration to
            # assemble the replicated camera system
            C_inv = _point_inverse(n, lm)
            S_fill, rhs_fill = _schur_fill(n, C_inv)
            if assembly == "ring":
                from . import collectives

                B, v, S_fill, rhs_fill = (
                    collectives.ring_all_reduce(t, axis, n_dev)
                    for t in (n.B, n.v, S_fill, rhs_fill)
                )
            else:
                B, v, S_fill, rhs_fill = jax.lax.psum(
                    (n.B, n.v, S_fill, rhs_fill), axis
                )
            S_full, rhs_full = _assemble_camera_system(B, v, S_fill, rhs_fill, lm, K)
            d_cam = _solve_cameras(S_full, rhs_full, K)  # replicated solve
            Ft_dc = jnp.einsum("pkab,ka->pb", n.F, d_cam)
            d_pt = jnp.einsum("pab,pb->pa", C_inv, n.w - Ft_dc)  # local
            new_poses, new_points = _apply_deltas(poses, points, d_cam, d_pt)
            new_energy = energy_of(new_poses, new_points)
            ok = (
            jnp.isfinite(new_energy)
            & (new_energy <= energy)
            & jnp.all(jnp.isfinite(new_poses.q))
            & jnp.all(jnp.isfinite(new_poses.t))
        )
            poses = jax.tree_util.tree_map(
                lambda new, old: jnp.where(ok, new, old), new_poses, poses
            )
            points = jnp.where(ok, new_points, points)
            lm = jnp.where(ok, lm * 0.3, lm * 10.0)
            d_energy = energy - new_energy
            done = jnp.logical_or(
                it + 1 >= max_iterations,
                jnp.logical_and(ok, d_energy < 1e-6 * (energy + 1.0)),
            )
            energy = jnp.where(ok, new_energy, energy)
            return poses, points, energy, lm, it + 1, done

        energy0 = energy_of(problem_local.poses, problem_local.points)
        carry0 = (
            problem_local.poses, problem_local.points, energy0,
            jnp.asarray(1e-4, Float), jnp.asarray(0, jnp.int32), jnp.asarray(False),
        )
        if assembly == "ring":
            # ring results are axis-varying under shard_map's manual-axes
            # tracking (ppermute chains can't be proven replicated); the
            # replicated carry leaves must start varying too (points, the
            # sharded leaf, already is)
            poses0, points0, energy0_, lm0, it0, done0 = carry0
            vary = lambda x: jax.lax.pcast(x, (axis,), to="varying")
            carry0 = (
                jax.tree_util.tree_map(vary, poses0),
                points0,
                vary(energy0_),
                vary(lm0),
                vary(it0),
                vary(done0),
            )
        poses, points, energy, _, it, _ = jax.lax.while_loop(
            lambda c: ~c[-1], body, carry0
        )
        return BAResult(poses=poses, points=points, energy=energy, nb_iter=it)

    spec = BAProblem(
        poses=Pose(q=P_(), t=P_()),
        points=P_(axis, None),
        obs_kf=P_(axis),
        obs_pt=P_(axis),
        obs_uv=P_(axis, None),
        obs_mask=P_(axis),
        intrinsics=jax.tree_util.tree_map(lambda _: P_(), problem.intrinsics),
    )
    out_spec = BAResult(
        poses=Pose(q=P_(), t=P_()), points=P_(axis, None), energy=P_(), nb_iter=P_()
    )
    # ring mode: outputs are mathematically replicated (every chip runs the
    # same camera solve on the same all-gathered system) but shard_map's
    # static varying-axes analysis can't prove it through ppermute chains
    fn = jax.shard_map(
        sharded,
        mesh=mesh,
        in_specs=(spec,),
        out_specs=out_spec,
        check_vma=(assembly != "ring"),
    )
    return fn(problem)
