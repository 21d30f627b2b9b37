"""Windowed photometric bundle adjustment (DSO-style keyframe window).

The capability the reference explicitly defers to future work
("sliding window of keyframes optimization as in DSO",
reference README.md:54-55): joint refinement of a window of F frame poses
AND the keyframe candidates' inverse depths by minimizing photometric
residuals

    r_{f,i} = I_f( warp(p_i, d_i, T_f) ) - I_0(p_i)

over every (frame, candidate) pair, with Gauss-Newton/LM on the
(6F + N)-dimensional normal equations reduced by the Schur complement over
the inverse-depth diagonal (each depth is a scalar block — the
embarrassingly parallel analog of ``parallel.ba``'s 3x3 point blocks).

Design:

- residuals and Jacobians evaluate for ALL F x N pairs at once (vmap over
  frames of the masked candidate arrays; bilinear sampling through the same
  ``ops.interp`` kernels as the tracker);
- Jacobians come from forward-mode autodiff of the warp+sample chain w.r.t.
  a right-multiplied twist at each pose and the inverse depth — 7 tangents
  per pair, exact, convention-safe;
- the depth Schur elimination is a masked elementwise pass; the reduced
  6F x 6F camera system solves with one Cholesky (frame 0 gauge-fixed);
- the LM loop is a ``lax.while_loop`` with the tracker's accept/reject
  semantics.

Out-of-view or invalid pairs get weight 0; depths whose total coupling is
degenerate keep their value (damped 1x1 inverse).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import camera as camera_mod
from ..core.camera import Intrinsics
from ..math import pose as pose_mod
from ..math import se3
from ..math.pose import Pose
from ..ops import interp
from ..utils.types import Float


class Window(NamedTuple):
    """Fixed-shape photometric window problem.

    tmpl_xs/tmpl_ys/tmpl_vals/valid: (N,) keyframe candidates (image-0 frame).
    idepth: (N,) initial inverse depths.
    poses: Pose with leading (F,) — keyframe->frame motions (frame 0 should
      be identity; it is gauge-fixed).
    images: (F, H, W) the window frames (u8 or f32).
    intrinsics: shared pinhole intrinsics.
    """

    tmpl_xs: jnp.ndarray
    tmpl_ys: jnp.ndarray
    tmpl_vals: jnp.ndarray
    valid: jnp.ndarray
    idepth: jnp.ndarray
    poses: Pose
    images: jnp.ndarray
    intrinsics: Intrinsics


class WindowResult(NamedTuple):
    poses: Pose
    idepth: jnp.ndarray
    energy: jnp.ndarray
    nb_iter: jnp.ndarray
    # per-frame affine brightness (F, 2) = (gain, bias); identity rows
    # (1, 0) when the solve ran without ``brightness=True``
    ab: jnp.ndarray


def _pair_residual(win: Window, pose_f: Pose, image_f, xi, d_i, x, y, method: str):
    """Residual of one (frame, candidate) pair at twist perturbation ``xi``
    (right-multiplied) and inverse depth ``d_i``.  Differentiable in (xi, d)."""
    pose = pose_mod.compose(pose_f, se3.exp(xi))
    u, v = camera_mod.warp(pose, x, y, d_i, win.intrinsics)
    vals, inside = interp.bilinear(image_f, u[None], v[None], method)
    return vals[0], inside[0]


def _frame_residuals(
    win: Window, pose_f: Pose, image_f, idepth, ab_f, method: str,
    brightness: bool,
):
    """All candidates against one frame: residuals + per-frame Jacobians.

    Camera-block Jacobian columns: 6 twist (right-multiplied at pose_f), and
    with ``brightness`` two more for the frame's (gain, bias) — the residual
    ``I_f - (a T + b)`` is exactly linear in (a, b), so those columns are
    the analytic ``(-T, -1)``.  The depth Jacobian stays separate (it is the
    Schur-eliminated block).
    """
    zero_xi = jnp.zeros((6,), Float)
    a_f, b_f = ab_f[0], ab_f[1]

    def val_fn(x, y, d, xi, dd):
        val, _ = _pair_residual(win, pose_f, image_f, xi, d + dd, x, y, method)
        return val

    def full(x, y, d, tmpl):
        val, inside = _pair_residual(win, pose_f, image_f, zero_xi, d, x, y, method)
        jac_xi = jax.jacfwd(lambda xi: val_fn(x, y, d, xi, 0.0))(zero_xi)  # (6,)
        jac_d = jax.jacfwd(lambda dd: val_fn(x, y, d, zero_xi, dd))(jnp.asarray(0.0, Float))
        r = val - (a_f * tmpl + b_f)
        if brightness:
            jac_cam = jnp.concatenate([jac_xi, jnp.stack([-tmpl, -jnp.ones_like(tmpl)])])
        else:
            jac_cam = jac_xi
        return r, inside, jac_cam, jac_d

    return jax.vmap(full)(win.tmpl_xs, win.tmpl_ys, idepth, win.tmpl_vals)


def _build(
    win: Window, poses: Pose, idepth, method: str, robust_delta: float = 0.0,
    ab=None, brightness: bool = False,
):
    """(F, N) residuals/Jacobians/masks for the whole window.

    ``robust_delta > 0``: Huber IRLS — the weight multiplies the mask, so
    residuals, Jacobians, and the energy are all consistently downweighted
    (same device as the tracker's ``robust_delta``)."""
    if ab is None:
        ab = jnp.tile(jnp.array([1.0, 0.0], Float), (poses.q.shape[0], 1))

    def per_frame(q, t, image_f, ab_f):
        return _frame_residuals(
            win, Pose(q, t), image_f, idepth, ab_f, method, brightness
        )

    r, inside, j_xi, j_d = jax.vmap(per_frame)(poses.q, poses.t, win.images, ab)
    mask = inside & win.valid[None, :]
    maskf = mask.astype(Float)
    if robust_delta > 0.0:
        absr = jnp.abs(r)
        w = jnp.where(
            absr <= robust_delta, 1.0, robust_delta / jnp.maximum(absr, 1e-12)
        )
        # sqrt(w) on residuals AND Jacobians puts exactly one power of w in
        # every normal-equation product (JᵀWJ, JᵀWr, Σw r²)
        maskf = maskf * jnp.sqrt(w)
    r = r * maskf
    j_xi = j_xi * maskf[..., None]
    j_d = j_d * maskf
    return r, maskf, j_xi, j_d


def _prior_residual(poses: Pose, anchors: Pose) -> jnp.ndarray:
    """Per-frame prior residual ρ_f = log(anchor_f⁻¹ ∘ pose_f), (F, 6).

    The solver's update is right-multiplicative (``pose ∘ exp(δ)``), so a
    step δ maps ρ → ρ + δ to first order — a Gaussian pose prior with
    energy ``(ρ+δ)ᵀ H (ρ+δ)`` (un-halved, matching the sum-r² photometric
    convention) contributes H to the camera system and -Hρ to the
    right-hand side.
    """
    return jax.vmap(
        lambda qa, ta, q, t: se3.log(
            pose_mod.compose(pose_mod.inverse(Pose(qa, ta)), Pose(q, t))
        )
    )(anchors.q, anchors.t, poses.q, poses.t)


def _pad_prior(Hp: jnp.ndarray, rho: jnp.ndarray, F: int, P: int):
    """Zero-pad a 6-dof pose prior to the P-parameter camera blocks."""
    if P == 6:
        return Hp, rho
    Hp_p = jnp.zeros((F, P, F, P), Float).at[:, :6, :, :6].set(Hp)
    rho_p = jnp.zeros((F, P), Float).at[:, :6].set(rho)
    return Hp_p, rho_p


def _camera_system(win: Window, poses: Pose, idepth, lm, prior_weight,
                   method: str, robust_delta: float = 0.0, ab=None,
                   brightness: bool = False, pose_prior=None):
    """Schur-reduced (depths eliminated) damped camera system.

    Returns ``(S (F,P,F,P), rhs (F,P), D_inv (N,), E (F,N,P), b_d (N,))``
    — the reduced normal equations BEFORE gauge fixing.  The camera block
    has P = 6 parameters per frame (twist), or 8 with ``brightness``
    (+ per-frame gain/bias, exactly linear).  ``pose_prior=(H, anchors)``
    adds a Gaussian pose prior (e.g. from marginalized frames).
    """
    F = poses.q.shape[0]
    r, maskf, j_xi, j_d = _build(
        win, poses, idepth, method, robust_delta, ab=ab, brightness=brightness
    )
    P = j_xi.shape[-1]

    # camera diagonal blocks A_f = sum_i J_xi^T J_xi  (F, P, P)
    A = jnp.einsum("fna,fnb->fab", j_xi, j_xi)
    b_cam = -jnp.einsum("fna,fn->fa", j_xi, r)  # (F, P)
    # depth diagonal D_i = sum_f j_d^2 + prior  (N,); the prior anchors each
    # inverse depth to its RGB-D measurement (win.idepth) with weight
    # sigma_I^2 / sigma_d^2 — photometric signal alone sits below the u8
    # quantization floor for small depth errors, the sensor term keeps the
    # depth column of the system observable (DSO uses the same device)
    validf = win.valid.astype(Float)
    D = jnp.sum(j_d * j_d, axis=0) + prior_weight * validf
    b_d = -jnp.sum(j_d * r, axis=0) + prior_weight * validf * (win.idepth - idepth)
    # coupling E[f, i, a] = j_xi[f,i,a] * j_d[f,i]
    E = j_xi * j_d[..., None]  # (F, N, P)

    eyeP = jnp.eye(P, dtype=Float)
    # Marquardt scaling + small additive floor: a frame whose candidates all
    # fall out of view has exactly-zero diagonal entries (notably the
    # brightness gain/bias columns), which multiplicative damping alone
    # cannot regularize — the Cholesky would go NaN and every step would be
    # rejected.  The floor (like D's 1e-10) keeps degenerate columns
    # solvable so the rest of the window still refines.
    A_damped = A * (1.0 + lm * eyeP) + (lm * 1e-6 + 1e-8) * eyeP
    D_damped = D * (1.0 + lm) + 1e-10

    D_inv = 1.0 / D_damped  # (N,)
    # Schur: S[f,a,g,b] = A_damped diag - sum_i E[f,i,a] D_inv[i] E[g,i,b]
    S_fill = jnp.einsum("fia,i,gib->fagb", E, D_inv, E)
    S = jnp.zeros((F, P, F, P), Float)
    S = S.at[jnp.arange(F), :, jnp.arange(F), :].add(A_damped)
    S = S - S_fill
    rhs = b_cam - jnp.einsum("fia,i,i->fa", E, D_inv, b_d)

    if pose_prior is not None:
        Hp, anchors = pose_prior
        rho = _prior_residual(poses, anchors)
        Hp_p, rho_p = _pad_prior(Hp, rho, F, P)
        S = S + Hp_p
        rhs = rhs - jnp.einsum("fagb,gb->fa", Hp_p, rho_p)
    return S, rhs, D_inv, E, b_d


def _zero_prior(F: int) -> tuple:
    """A no-op pose prior (H = 0, identity anchors): adding it is exact
    (contributes literal zeros to S/rhs/energy), which lets the shared
    solver body run ONE code path whether a prior exists or not."""
    return (
        jnp.zeros((F, 6, F, 6), Float),
        pose_mod.identity((F,)),
    )


def _energy(win: Window, poses: Pose, idepth, prior_weight, method: str,
            robust_delta: float = 0.0, ab=None, pose_prior=None):
    """(total energy, number of contributing pairs)."""
    r, maskf, _, _ = _build(win, poses, idepth, method, robust_delta, ab=ab)
    validf = win.valid.astype(Float)
    prior = prior_weight * jnp.sum(validf * (idepth - win.idepth) ** 2)
    if pose_prior is not None:
        # energy convention here is UN-halved (photometric part is sum r^2
        # with system J^T J / -J^T r), so the prior's energy is rho^T H rho
        # — a 0.5 factor would make LM accept/reject monitor a different
        # objective than the one the normal equations minimize
        Hp, anchors = pose_prior
        rho = _prior_residual(poses, anchors)
        prior = prior + jnp.einsum("fa,fagb,gb->", rho, Hp, rho)
    # count CONTRIBUTING pairs (mask > 0), not the sqrt(w)-scaled weights —
    # energy_tol is calibrated per pair
    return jnp.sum(r * r) + prior, jnp.sum((maskf > 0.0).astype(Float))


def _solve_window_impl(
    win: Window,
    *,
    allreduce,
    max_iterations: int,
    lm_init: float,
    idepth_prior_weight: float,
    energy_tol: float,
    interp_method: str,
    robust_delta: float,
    brightness: bool,
    pose_prior,
    min_pair_ratio: float,
    max_step: float,
    max_depth_step: float,
    pose_only_iterations: int,
    refine_depth: bool,
    idepth_init=None,
) -> WindowResult:
    """Shared LM body of the window solve — the single source of truth for
    ``solve_window`` AND ``solve_window_sharded`` (they previously maintained
    ~150 duplicated lines of staged solve / trust region / visibility guard /
    accept-reject logic each, and divergence fixes had to land twice).

    ``allreduce`` is the cross-shard reduction hook: ``None`` on a single
    device, ``lambda x: lax.psum(x, axis)`` inside shard_map.  Every
    candidate-summed quantity (camera-system partials, energy, pair count,
    the depth-finiteness vote) passes through it exactly once; replicated
    terms (pose prior, additive damping floor, the camera solve itself) are
    applied after it — so both paths compute identical numbers by
    construction.

    ``idepth_init`` separates the optimization STARTING POINT from the
    sensor anchor: ``win.idepth`` stays the RGB-D measurement the depth
    prior pulls toward, while the solve initializes at ``idepth_init``
    (default: the anchor itself).  Without the separation, re-feeding
    refined depths as ``win.idepth`` re-centers the 1e4-weight sensor prior
    at the last estimate — a random-walk prior that re-enables pose/depth
    co-drift over long keyframe epochs (round-2 advisor finding).
    """
    red = allreduce if allreduce is not None else (lambda x: x)
    F = win.poses.q.shape[0]
    w_prior = jnp.asarray(idepth_prior_weight, Float)
    Hp, anchors = pose_prior if pose_prior is not None else _zero_prior(F)
    idepth_start = win.idepth if idepth_init is None else idepth_init

    def energy_of(poses, ab, idepth):
        e, n = _energy(
            win, poses, idepth, w_prior, interp_method, robust_delta, ab=ab
        )
        e, n = red((e, n))
        # pose-prior term is replicated: add ONCE after the reduction
        # (un-halved, matching the sum-r^2 photometric energy convention —
        # a 0.5 factor would make LM accept/reject monitor a different
        # objective than the one the normal equations minimize)
        rho = _prior_residual(poses, anchors)
        e = e + jnp.einsum("fa,fagb,gb->", rho, Hp, rho)
        return e, n

    def gn(poses, ab, idepth, lm):
        r, maskf, j_xi, j_d = _build(
            win, poses, idepth, interp_method, robust_delta,
            ab=ab, brightness=brightness,
        )
        P = j_xi.shape[-1]
        A = jnp.einsum("fna,fnb->fab", j_xi, j_xi)
        b_cam = -jnp.einsum("fna,fn->fa", j_xi, r)
        # depth diagonal D_i = sum_f j_d^2 + prior; the prior anchors each
        # inverse depth to its RGB-D measurement (win.idepth) with weight
        # sigma_I^2 / sigma_d^2 — photometric signal alone sits below the u8
        # quantization floor for small depth errors, the sensor term keeps
        # the depth column of the system observable (DSO's device)
        validf = win.valid.astype(Float)
        D = jnp.sum(j_d * j_d, axis=0) + w_prior * validf
        b_d = -jnp.sum(j_d * r, axis=0) + w_prior * validf * (win.idepth - idepth)
        E = j_xi * j_d[..., None]  # coupling (F, N, P)
        eyeP = jnp.eye(P, dtype=Float)
        A_damped = A * (1.0 + lm * eyeP)
        D_damped = D * (1.0 + lm) + 1e-10
        D_inv = 1.0 / D_damped
        S_fill = jnp.einsum("fia,i,gib->fagb", E, D_inv, E)
        rhs_fill = jnp.einsum("fia,i,i->fa", E, D_inv, b_d)
        # ONE collective: local partials of the Schur-reduced camera system
        A_damped, b_cam, S_fill, rhs_fill = red(
            (A_damped, b_cam, S_fill, rhs_fill)
        )
        # additive floor AFTER the reduction (applied once, not per shard):
        # a frame whose candidates all fall out of view has exactly-zero
        # diagonal entries (notably the brightness gain/bias columns), which
        # multiplicative damping alone cannot regularize — the Cholesky
        # would go NaN and every step would be rejected
        A_damped = A_damped + (lm * 1e-6 + 1e-8) * eyeP
        S = jnp.zeros((F, P, F, P), Float)
        S = S.at[jnp.arange(F), :, jnp.arange(F), :].add(A_damped)
        S = S - S_fill
        rhs = b_cam - rhs_fill
        rho = _prior_residual(poses, anchors)
        Hp_p, rho_p = _pad_prior(Hp, rho, F, P)
        S = S + Hp_p
        rhs = rhs - jnp.einsum("fagb,gb->fa", Hp_p, rho_p)

        # gauge-fix frame 0 (keyframe): delta_0 = 0 (pose AND brightness)
        n = P * F
        S2 = S.reshape(n, n)
        rhs2 = rhs.reshape(n)
        idx = jnp.arange(n)
        free = idx >= P
        mask2d = free[:, None] & free[None, :]
        S2 = jnp.where(mask2d, S2, jnp.eye(n, dtype=Float))
        rhs2 = jnp.where(free, rhs2, 0.0)
        chol = jnp.linalg.cholesky(S2)
        d_cam = jax.scipy.linalg.cho_solve((chol, True), rhs2).reshape(F, P)
        # back-substitute depths (local to each shard)
        Et_dc = jnp.einsum("fia,fa->i", E, d_cam)
        d_depth = D_inv * (b_d - Et_dc)
        return d_cam, d_depth

    def apply(poses, ab, idepth, d_cam, d_depth, freeze_depth):
        # trust region: cap per-frame TWIST norm, keep direction.  Only the
        # 6 twist columns are scaled — the brightness gain/bias columns are
        # exactly linear in the residual and need no cap.  d_cam is
        # replicated under sharding, so the scaling is identical per shard.
        norms = jnp.linalg.norm(d_cam[:, :6], axis=1, keepdims=True)
        scale = jnp.minimum(1.0, max_step / jnp.maximum(norms, 1e-12))
        d_xi = d_cam[:, :6] * scale
        d_depth = jnp.clip(
            d_depth, -max_depth_step * idepth, max_depth_step * idepth
        )
        if freeze_depth:
            d_depth = jnp.zeros_like(d_depth)
        new_poses = jax.vmap(
            lambda q, t, xi: pose_mod.compose(Pose(q, t), se3.exp(xi))
        )(poses.q, poses.t, d_xi)
        new_poses = pose_mod.renormalize_first_order(
            Pose(new_poses.q, new_poses.t)
        )
        new_ab = ab + d_cam[:, 6:8] if brightness else ab
        new_idepth = jnp.maximum(idepth + d_depth, 1e-6)  # idepth stays +
        return new_poses, new_ab, new_idepth

    def make_body(freeze_depth, stage_max_iter):
        def body(carry):
            poses, ab, idepth, energy, lm, it, done = carry
            d_cam, d_depth = gn(poses, ab, idepth, lm)
            new_poses, new_ab, new_idepth = apply(
                poses, ab, idepth, d_cam, d_depth, freeze_depth
            )
            new_energy, n_pairs = energy_of(new_poses, new_ab, new_idepth)
            # the depth-finiteness vote must be GLOBAL under sharding: a
            # shard-local `ok` would let shards accept/reject independently
            # and silently diverge the replicated poses
            bad_depth = red(jnp.sum(~jnp.isfinite(new_idepth)))
            ok = (
                jnp.isfinite(new_energy)
                & (new_energy <= energy)
                & (n_pairs >= min_pair_ratio * n_pairs0)  # visibility guard
                & jnp.all(jnp.isfinite(new_poses.q))
                & jnp.all(jnp.isfinite(new_poses.t))
                & jnp.all(jnp.isfinite(new_ab))
                & (bad_depth == 0)
            )
            poses = jax.tree_util.tree_map(
                lambda new, old: jnp.where(ok, new, old), new_poses, poses
            )
            ab = jnp.where(ok, new_ab, ab)
            idepth = jnp.where(ok, new_idepth, idepth)
            lm = jnp.where(ok, lm * 0.3, lm * 10.0)
            d_energy = energy - new_energy
            done = jnp.logical_or(
                it + 1 >= stage_max_iter,
                jnp.logical_and(
                    ok, d_energy <= energy_tol * jnp.maximum(n_pairs, 1.0)
                ),
            )
            energy = jnp.where(ok, new_energy, energy)
            return poses, ab, idepth, energy, lm, it + 1, done
        return body

    ab0 = jnp.tile(jnp.array([1.0, 0.0], Float), (F, 1))
    energy0, n_pairs0 = energy_of(win.poses, ab0, idepth_start)
    carry = (
        win.poses, ab0, idepth_start, energy0,
        jnp.asarray(lm_init, Float), jnp.asarray(0, jnp.int32),
        jnp.asarray(False),
    )
    if refine_depth:
        # stage 1 never consumes the whole budget: depth refinement must not
        # silently vanish for small max_iterations
        stage1 = min(pose_only_iterations, max_iterations - 1)
    else:
        stage1 = max_iterations  # explicit pose-only solve
    if stage1 > 0:
        carry = jax.lax.while_loop(
            lambda c: ~c[-1], make_body(True, stage1), carry
        )
    if stage1 < max_iterations:
        # reset the done flag (keep lambda/energy) for the joint stage
        carry = (*carry[:6], jnp.asarray(False))
        carry = jax.lax.while_loop(
            lambda c: ~c[-1], make_body(False, max_iterations), carry
        )
    poses, ab, idepth, energy, _, it, _ = carry
    return WindowResult(poses=poses, idepth=idepth, energy=energy, nb_iter=it, ab=ab)


def solve_window(
    win: Window,
    *,
    max_iterations: int = 15,
    lm_init: float = 1e-4,
    idepth_prior_weight: float = 1e4,
    energy_tol: float = 0.01,
    interp_method: str = "auto",
    robust_delta: float = 0.0,
    brightness: bool = False,
    pose_prior=None,
    min_pair_ratio: float = 0.7,
    max_step: float = 0.02,
    max_depth_step: float = 0.2,
    pose_only_iterations: int = 5,
    refine_depth: bool = True,
    idepth_init=None,
) -> WindowResult:
    """LM-damped windowed photometric BA.  Jittable; fixed shapes.

    ``brightness=True`` adds a per-frame affine brightness pair (gain, bias)
    to each camera block (8 parameters/frame) — the DSO device for
    auto-exposure cameras; frame 0's pair is gauge-fixed at (1, 0).

    Accept/reject semantics follow the tracker's LM (lm_optimizer.rs:
    144-174): a step is kept only when the energy does not increase and all
    values stay finite; LM coefficient x0.3 on accept, x10 on reject.

    ``idepth_prior_weight`` = sigma_I^2 / sigma_d^2 of the sensor: with the
    reference's idepth variance 1e-4 (tum_rgbd.rs:20) and ~1 intensity unit
    of photometric noise, the default is 1/1e-4 = 1e4.

    ``energy_tol`` is PER CONTRIBUTING PAIR (intensity² units), the analog
    of the reference's absolute d_energy stop on the per-point mean
    (lm_optimizer.rs:179): the quantized bilinear energy is riddled with
    micro-minima at the <0.1-intensity scale, and iterating into them chases
    resampling noise rather than signal.

    ``pose_prior=(H (F,6,F,6), anchors Pose(F))`` adds a Gaussian pose prior
    with energy ``ρᵀHρ``, ``ρ_f = log(anchor_f⁻¹ ∘ pose_f)`` — the carrier for
    marginalized-frame information in the sliding window
    (``models.sliding_window``).  Frame 0's blocks should be zero (gauge).

    ``min_pair_ratio``: visibility guard.  The energy sums over IN-VIEW
    pairs, so moving a frame out of view deletes its residuals and "lowers"
    the energy — a degenerate escape direction LM can find (observed: a
    window solve flinging its newest frame half a meter, verified by the
    CLI drive).  A step is therefore rejected if it keeps fewer than
    ``min_pair_ratio`` of the pairs contributing at initialization; honest
    refinement keeps nearly all pairs in view.

    ``max_step`` / ``max_depth_step``: trust region.  The window solves at
    FULL resolution only (its inits come from coarse-to-fine tracking), and
    periodic texture gives the photometric energy aliasing valleys a few
    pixels apart; a near-Gauss-Newton first step can jump the ridge into a
    false valley while still lowering the energy (observed on a synthetic
    sinusoid texture: a window descended from a sub-pixel-correct init to a
    half-meter-wrong "minimum").  Per accepted iteration the pose twist is
    capped at ``max_step`` (norm, per frame; direction kept) and the
    inverse-depth change at ``max_depth_step`` relative — crossing a ridge
    then requires going uphill, which LM rejects.  Gross-error correction
    is still reachable gradually (max_iterations * max_step).

    ``pose_only_iterations``: staged optimization.  The joint pose+depth
    objective has co-drift valleys (a z-translation compensated by a depth
    rescale keeps points registered while both walk away from truth — the
    monocular scale ambiguity, only weakly pinned by the sensor prior);
    measured: from a 1 px drifted init the joint solve can descend
    monotonically into a valley 0.2 m off while a depth-frozen solve lands
    within ~1 mm in 5 iterations.  Stage 1 therefore freezes depths for up
    to ``pose_only_iterations`` LM iterations (always leaving at least one
    joint iteration of the ``max_iterations`` budget, so small budgets
    cannot silently disable depth refinement); stage 2 refines jointly from
    inside the correct basin.  Set 0 to disable (pure joint solve), or
    ``refine_depth=False`` for an explicitly pose-only solve (all
    iterations frozen; used by the sliding window's coarse pre-stage).

    ``idepth_init``: optional starting depths for the solve, SEPARATE from
    the sensor anchor ``win.idepth`` the depth prior pulls toward — pass
    the previous solve's refined depths here (not as ``win.idepth``) to
    warm-start without re-centering the sensor prior.
    """
    return _solve_window_impl(
        win, allreduce=None,
        max_iterations=max_iterations, lm_init=lm_init,
        idepth_prior_weight=idepth_prior_weight, energy_tol=energy_tol,
        interp_method=interp_method, robust_delta=robust_delta,
        brightness=brightness, pose_prior=pose_prior,
        min_pair_ratio=min_pair_ratio, max_step=max_step,
        max_depth_step=max_depth_step,
        pose_only_iterations=pose_only_iterations, refine_depth=refine_depth,
        idepth_init=idepth_init,
    )


def solve_window_sharded(
    win: Window,
    mesh,
    axis: str = "points",
    *,
    max_iterations: int = 15,
    lm_init: float = 1e-4,
    idepth_prior_weight: float = 1e4,
    energy_tol: float = 0.01,
    interp_method: str = "auto",
    robust_delta: float = 0.0,
    brightness: bool = False,
    pose_prior=None,
    min_pair_ratio: float = 0.7,
    max_step: float = 0.02,
    max_depth_step: float = 0.2,
    pose_only_iterations: int = 5,
    refine_depth: bool = True,
    idepth_init=None,
) -> WindowResult:
    """``solve_window`` with the candidate axis sharded over ``mesh[axis]``.

    Same SPMD shape as ``parallel.ba.solve_point_sharded``: every chip
    evaluates residuals/Jacobians and eliminates the scalar depth blocks for
    its own N/n candidates against the replicated window images; one
    ``psum`` of the (6F, 6F+1) camera system per iteration crosses the devices;
    the small camera solve is replicated; depth back-substitution is local.
    Returns replicated poses and the candidate-sharded refined depths.

    Delegates to the same ``_solve_window_impl`` body as ``solve_window``
    with ``allreduce = psum`` — the two paths cannot drift apart.
    """
    from jax.sharding import PartitionSpec as P_

    F = win.poses.q.shape[0]
    prior = pose_prior if pose_prior is not None else _zero_prior(F)
    init = win.idepth if idepth_init is None else idepth_init

    def run(win_local: Window, prior_local, init_local) -> WindowResult:
        return _solve_window_impl(
            win_local,
            allreduce=lambda x: jax.lax.psum(x, axis),
            max_iterations=max_iterations, lm_init=lm_init,
            idepth_prior_weight=idepth_prior_weight, energy_tol=energy_tol,
            interp_method=interp_method, robust_delta=robust_delta,
            brightness=brightness, pose_prior=prior_local,
            min_pair_ratio=min_pair_ratio, max_step=max_step,
            max_depth_step=max_depth_step,
            pose_only_iterations=pose_only_iterations,
            refine_depth=refine_depth, idepth_init=init_local,
        )

    spec = Window(
        tmpl_xs=P_(axis),
        tmpl_ys=P_(axis),
        tmpl_vals=P_(axis),
        valid=P_(axis),
        idepth=P_(axis),
        poses=Pose(q=P_(), t=P_()),
        images=P_(),
        intrinsics=jax.tree_util.tree_map(lambda _: P_(), win.intrinsics),
    )
    out_spec = WindowResult(
        poses=Pose(q=P_(), t=P_()), idepth=P_(axis), energy=P_(), nb_iter=P_(),
        ab=P_(),
    )
    prior_spec = (P_(), Pose(q=P_(), t=P_()))  # replicated
    fn = jax.shard_map(
        run, mesh=mesh, in_specs=(spec, prior_spec, P_(axis)),
        out_specs=out_spec,
    )
    return fn(win, prior, init)


def stack_windows(wins) -> Window:
    """Stack same-shape ``Window`` problems along a new leading batch axis
    (input to ``solve_window_batched``)."""
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *wins)


_BATCHED_SOLVE_CACHE: dict = {}


def solve_window_batched(
    wins: Window, mesh=None, axis: str = "data", *,
    pose_prior=None, idepth_init=None, **opts
) -> WindowResult:
    """Data-parallel windowed BA: ``vmap`` of ``solve_window`` over a
    leading batch of INDEPENDENT windows (different sequences) — the
    refinement analog of ``parallel.batch``'s multi-sequence tracking.

    ``wins``: a ``Window`` whose every leaf carries a leading batch axis
    (see ``stack_windows``).  With ``mesh``, the batch axis is sharded over
    ``mesh[axis]`` (communication-free DP: each device solves its lanes).
    Per-lane accept/reject state is independent, so no lane's LM schedule
    affects another's numbers; lanes agree with per-window ``solve_window``
    calls up to f32 LOWERING noise (vmap changes how XLA lowers the
    reductions), ~1e-5 in pose after a handful of iterations.

    ``pose_prior``/``idepth_init`` are PER WINDOW (unlike ``solve_window``
    where they are per call): ``pose_prior = (H (B,F,6,F,6), anchors
    Pose with leading (B,F))`` and ``idepth_init (B,N)`` carry one prior /
    warm start per lane — the carrier that lets the marginalized sliding
    window (``models.sliding_window``) refine B sequences in ONE vmapped
    solve per step instead of a per-sequence host loop.  ``None`` lanes are
    expressed as zero-H priors (exact no-ops, see ``_zero_prior``).
    """
    B, F = wins.poses.q.shape[0], wins.poses.q.shape[1]
    if pose_prior is None:
        Hp = jnp.zeros((B, F, 6, F, 6), Float)
        anchors = pose_mod.identity((B, F))
    else:
        Hp, anchors = pose_prior
        Hp = jnp.asarray(Hp, Float)
        if Hp.shape != (B, F, 6, F, 6) or anchors.q.shape[:2] != (B, F):
            raise ValueError(
                "batched pose_prior must carry a leading batch axis: "
                f"H (B,F,6,F,6)={(B, F, 6, F, 6)}, anchors Pose (B,F); got "
                f"H {Hp.shape}, anchors {anchors.q.shape}"
            )
    if idepth_init is None:
        idepth_init = wins.idepth
    elif idepth_init.shape != wins.idepth.shape:
        raise ValueError(
            "batched idepth_init must match wins.idepth shape "
            f"{wins.idepth.shape}; got {idepth_init.shape}"
        )

    # cache the jitted vmapped solver by opts: a fresh jax.jit wrapper per
    # call would discard its trace cache and recompile the full batched
    # solve every invocation (per-step callers — the batched sliding
    # window — would pay seconds per step).  Shape specialization is
    # handled by jit's own cache inside each wrapper.
    key = tuple(sorted(opts.items()))
    fn = _BATCHED_SOLVE_CACHE.get(key)
    if fn is None:
        fn = jax.jit(
            jax.vmap(
                lambda w, hp, aq, at, ii: solve_window(
                    w, pose_prior=(hp, Pose(aq, at)), idepth_init=ii, **opts
                )
            )
        )
        _BATCHED_SOLVE_CACHE[key] = fn
    if mesh is not None:
        from ..parallel import mesh as mesh_mod

        wins, Hp, anchors, idepth_init = mesh_mod.shard_batch(
            (wins, Hp, anchors, idepth_init), mesh, axis
        )
    return fn(wins, Hp, anchors.q, anchors.t, idepth_init)


def window_from_tracking(
    config,
    intrinsics: Intrinsics,
    kf_levels,
    images,
    tracked_poses: Pose,
    level: int = 0,
) -> Window:
    """Assemble a ``Window`` from tracker outputs.

    ``kf_levels`` is ``KeyframeData.levels`` of the window's keyframe,
    ``images`` the (F, H, W) frame stack at the chosen pyramid level, and
    ``tracked_poses`` the tracker's keyframe->frame motion estimates (the
    initialization BA refines).
    """
    obs = kf_levels[level]
    return Window(
        tmpl_xs=obs.xs,
        tmpl_ys=obs.ys,
        tmpl_vals=obs.tmpl_vals,
        valid=obs.valid,
        idepth=obs.idepth,
        poses=tracked_poses,
        images=images,
        intrinsics=obs.intrinsics,
    )
